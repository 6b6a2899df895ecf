// B3 — one hop of the delete-repair masked scan for Hopper (sm_90a).
//
//   out[w] = affected[w] ? r[w] | OR over {x : r[w, x]} s[x] : r[w]
//   r, s uint32 (C, C/32), affected uint32 (C/32,) row mask
//   -> out uint32 (C, C/32)
//
// Replaces the TPU kernel `closure_delete` of
// src/repro/kernels/closure_delete.py:67 (pl.pallas_call at :86), which
// skips row blocks with no affected row and otherwise multiplies the
// unpacked r row panel by the s column panel on the MXU.  Here each warp
// reads its row's affected bit first (uniform across the warp): an
// unaffected row is copied through, an affected row starts its
// accumulator at r[w][n] and runs the bitmm warp routine (bitrow.cuh)
// over r[w] as the lhs row.
//
// The output is a separate buffer: other warps read r[w] as their lhs row
// while this warp writes row w, so writing in place would race.
//
// What bounds it on an H100 at C = 16384, counting each byte once: r, s
// and out are 32 MiB each, ~96 MiB -> ~30 us of HBM traffic; the ops,
// 2 * popcount(affected rows of r) * C, scale with the affected region.
// What the design does about it: unaffected rows cost one coalesced copy,
// and affected rows cost popcount(r[w]) x C/32 word-ORs, which is small
// while the affected ancestors' reach sets are sparse.
#include "bitrow.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kThreads)
closure_delete_kernel(const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ s,
                      const uint32_t* __restrict__ affected,
                      uint32_t* __restrict__ out, int c, int w) {
  int row, n;
  if (!repro_torch::warp_tile(c, w, &row, &n)) return;
  const size_t at = static_cast<size_t>(row) * w + n;
  const uint32_t old = n < w ? r[at] : 0u;
  uint32_t acc = old;
  if ((affected[row >> 5] >> (row & 31)) & 1u) {
    acc = repro_torch::or_selected_rows(r + static_cast<size_t>(row) * w, w, s,
                                        w, n, old);
  }
  if (n < w) out[at] = acc;
}

}  // namespace

extern "C" int repro_closure_delete(const void* r, const void* s,
                                    const void* affected, void* out, int c,
                                    int w, void* stream) {
  if (c <= 0 || w <= 0) return 0;
  closure_delete_kernel<<<repro_torch::blocks_for(c, w), repro_torch::kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(r), static_cast<const uint32_t*>(s),
      static_cast<const uint32_t*>(affected), static_cast<uint32_t*>(out), c,
      w);
  return static_cast<int>(cudaGetLastError());
}
