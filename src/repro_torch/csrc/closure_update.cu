// B2 — rank-B closure fold for Hopper (sm_90a).
//
//   out[w] = closure[w] | OR over {j : mask[w, j]} rows[j]
//   closure uint32 (C, C/32), mask uint32 (C, B/32), rows uint32 (B, C/32)
//   -> out uint32 (C, C/32); B is the padded batch, a multiple of 32.
//
// Replaces the TPU kernel `closure_update` of
// src/repro/kernels/closure_update.py:56 (pl.pallas_call at :74), which
// multiplies the unpacked mask and rows panels on the MXU and ORs the old
// closure block in the epilogue.  Here the same warp routine as bitmm
// (bitrow.cuh) starts its accumulator at closure[w][n], so the old closure
// is read once and ORed in the epilogue, not in a second pass.
//
// What bounds it on an H100 at C = 16384, B = 1024, counting each byte
// once: closure in + out 32 MiB each, mask and rows 2 MiB each, ~68 MiB
// -> ~21 us of HBM traffic; as a dense binary GEMM 2*C*B*C = 5.5e11 int8
// ops -> ~0.28 ms.  The work this data needs is 2 * popcount(mask) * C.
// What the design does about it: it walks only the set mask bits (the
// vertices that reach an accepted edge's source), so a fold whose mask is
// sparse costs little more than the copy of the closure; a dense mask
// makes it slow, and the wgmma design of bitmm.cu is the cure there too.
#include "bitrow.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kThreads)
closure_update_kernel(const uint32_t* __restrict__ closure,
                      const uint32_t* __restrict__ mask,
                      const uint32_t* __restrict__ rows,
                      uint32_t* __restrict__ out, int c, int wb, int w) {
  int row, n;
  if (!repro_torch::warp_tile(c, w, &row, &n)) return;
  const size_t at = static_cast<size_t>(row) * w + n;
  const uint32_t old = n < w ? closure[at] : 0u;
  const uint32_t acc = repro_torch::or_selected_rows(
      mask + static_cast<size_t>(row) * wb, wb, rows, w, n, old);
  if (n < w) out[at] = acc;
}

}  // namespace

extern "C" int repro_closure_update(const void* closure, const void* mask,
                                    const void* rows, void* out, int c, int wb,
                                    int w, void* stream) {
  if (c <= 0 || w <= 0) return 0;
  closure_update_kernel<<<repro_torch::blocks_for(c, w), repro_torch::kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(closure), static_cast<const uint32_t*>(mask),
      static_cast<const uint32_t*>(rows), static_cast<uint32_t*>(out), c, wb,
      w);
  return static_cast<int>(cudaGetLastError());
}
