// B2 — rank-B closure fold for Hopper (sm_90a).
//
//   out[w] = closure[w] | OR over {j : mask[w, j]} rows[j]
//   closure uint32 (C, C/32), mask uint32 (C, B/32), rows uint32 (B, C/32)
//   -> out uint32 (C, C/32); B is the padded batch, a multiple of 32.
//
// Replaces the TPU kernel `closure_update` of
// src/repro/kernels/closure_update.py:56 (pl.pallas_call at :74), which
// multiplies the unpacked mask and rows panels on the MXU and ORs the old
// closure block in the epilogue.  Here it is B1's product with the mask
// as lhs (K = B) and rows as rhs, each output row starting from its old
// closure words (bitgemm.cuh, Mode::kFold), each block of 128 rows on one
// of two paths chosen on the device from the block's set mask bits:
//   * sparse blocks: every row starts at closure[w] (read once into shared
//     memory) and gathers one rows[j] segment per set mask bit, from a
//     list of the block's set bits, 16 loads in flight a warp.  Bound by
//     the closure's copy (64 MiB in and out at C = 16384) and the
//     gathers, popcount(mask) x C/8 bytes, mostly from L2 (rows is 2 MiB).
//   * dense blocks multiply on the int8 tensor cores (wgmma m64n256k32,
//     K = B in stages of 128) and write closure | bits.  Bound by
//     2 x 128 x B x C operations a block.
//
// The output is a separate buffer, as B1's and B3's.
//
// What bounds a call on an H100 SXM at C = 16384, B = 1024, counting each
// byte once: closure in and out 32 MiB each, mask and rows 2 MiB each,
// ~68 MiB -> ~21 us of HBM traffic; the operations the data needs,
// 2 * popcount(mask) * C; the dense path does up to 2 * C * B * C = 5.5e11
// (0.28 ms at the int8 peak).  The threshold between the paths is
// bitgemm::kDensePerMille, as B1's.
#include "bitgemm.cuh"

namespace {

namespace bg = repro_torch::bitgemm;

__global__ void __launch_bounds__(bg::kWorkThreads)
closure_update_work_kernel(const uint32_t* __restrict__ mask, int c, int wb,
                           int* __restrict__ work) {
  bg::block_work(mask, nullptr, c, wb, work);
}

__global__ void __launch_bounds__(bg::kThreads, 1)
closure_update_kernel(const uint32_t* __restrict__ closure,
                      const uint32_t* __restrict__ mask,
                      const uint32_t* __restrict__ rows,
                      uint32_t* __restrict__ out,
                      const int* __restrict__ work, int c, int wb, int w) {
  bg::product_block<bg::Mode::kFold>(mask, rows, closure, nullptr, out, work,
                                     c, wb, w);
}

int launch_update(const void* closure, const void* mask, const void* rows,
                  void* out, const void* work, int c, int wb, int w,
                  cudaStream_t stream) {
  static bool attr_set = false;   // once per process
  return bg::launch_main(closure_update_kernel, &attr_set, c, wb, w, stream,
                         static_cast<const uint32_t*>(closure),
                         static_cast<const uint32_t*>(mask),
                         static_cast<const uint32_t*>(rows),
                         static_cast<uint32_t*>(out),
                         static_cast<const int*>(work), c, wb, w);
}

}  // namespace

// work: int32 scratch of ceil(c / 128) entries, written by the first launch.
extern "C" int repro_closure_update(const void* closure, const void* mask,
                                    const void* rows, void* out, void* work,
                                    int c, int wb, int w, void* stream) {
  if (c <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  closure_update_work_kernel<<<bg::work_blocks(c), bg::kWorkThreads, 0, s>>>(
      static_cast<const uint32_t*>(mask), c, wb, static_cast<int*>(work));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_update(closure, mask, rows, out, work, c, wb, w, s);
}

// The main launch alone, on a work array the caller fills (see
// repro_bitmm_paths).
extern "C" int repro_closure_update_paths(const void* closure,
                                          const void* mask, const void* rows,
                                          void* out, const void* work, int c,
                                          int wb, int w, void* stream) {
  if (c <= 0 || w <= 0) return 0;
  return launch_update(closure, mask, rows, out, work, c, wb, w,
                       static_cast<cudaStream_t>(stream));
}
