// B3 — one hop of the delete-repair masked scan for Hopper (sm_90a).
//
//   out[w] = affected[w] ? r[w] | OR over {x : r[w, x]} s[x] : r[w]
//   r uint32 (M, C/32), s uint32 (C, C/32), affected uint32 (ceil(M/32),)
//   row mask -> out uint32 (M, C/32); M = C, or M rows of one shard's
//   block of the closure (the argument c below is M)
//
// Replaces the TPU kernel `closure_delete` of
// src/repro/kernels/closure_delete.py:67 (pl.pallas_call at :86), which
// skips row blocks with no affected row and otherwise multiplies the
// unpacked r row panel by the s column panel on the MXU.  Here it is B1's
// product with r as lhs and s as rhs (bitgemm.cuh), each block of 128
// rows on one of two paths chosen on the device from the set bits of its
// affected rows:
//   * sparse blocks (every block with no affected row among them): an
//     unaffected row is one coalesced copy, an affected row starts at
//     r[w] and gathers one s row segment per set bit of r[w], from a list
//     of the block's set bits in affected rows, 16 loads in flight a
//     warp.  Bound by the copy (64 MiB) and the gathers, popcount(affected
//     rows of r) x C/8 bytes.
//   * dense blocks multiply all 128 rows on the int8 tensor cores (wgmma
//     m64n256k32) and write old | bits on affected rows, old on the others
//     (the TPU kernel's jnp.where).  Bound by 2 x 128 x C x C operations
//     a block.
//
// The output is a separate buffer: other warps read r[w] as their lhs row
// while this warp writes row w, so writing in place would race.
//
// What bounds a call on an H100 SXM at C = 16384, counting each byte
// once: r, s and out are 32 MiB each, ~96 MiB -> ~30 us of HBM traffic;
// the operations the data needs, 2 * popcount(affected rows of r) * C,
// scale with the affected region.  The threshold between the paths is
// bitgemm::kDensePerMille, as B1's.
#include "bitgemm.cuh"

namespace {

namespace bg = repro_torch::bitgemm;

__global__ void __launch_bounds__(bg::kWorkThreads)
closure_delete_work_kernel(const uint32_t* __restrict__ r,
                           const uint32_t* __restrict__ affected, int c,
                           int w, int* __restrict__ work) {
  bg::block_work(r, affected, c, w, work);
}

__global__ void __launch_bounds__(bg::kThreads, 1)
closure_delete_kernel(const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ s,
                      const uint32_t* __restrict__ affected,
                      uint32_t* __restrict__ out,
                      const int* __restrict__ work, int c, int w) {
  bg::product_block<bg::Mode::kDelete>(r, s, r, affected, out, work, c, w, w);
}

int launch_delete(const void* r, const void* s, const void* affected,
                  void* out, const void* work, int c, int w,
                  cudaStream_t stream) {
  static bool attr_set = false;   // once per process
  return bg::launch_main(closure_delete_kernel, &attr_set, c, w, w, stream,
                         static_cast<const uint32_t*>(r),
                         static_cast<const uint32_t*>(s),
                         static_cast<const uint32_t*>(affected),
                         static_cast<uint32_t*>(out),
                         static_cast<const int*>(work), c, w);
}

}  // namespace

// work: int32 scratch of ceil(c / 128) entries, written by the first launch.
extern "C" int repro_closure_delete(const void* r, const void* s,
                                    const void* affected, void* out,
                                    void* work, int c, int w, void* stream) {
  if (c <= 0 || w <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  closure_delete_work_kernel<<<bg::work_blocks(c), bg::kWorkThreads, 0, st>>>(
      static_cast<const uint32_t*>(r), static_cast<const uint32_t*>(affected),
      c, w, static_cast<int*>(work));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_delete(r, s, affected, out, work, c, w, st);
}

// The main launch alone, on a work array the caller fills (see
// repro_bitmm_paths).
extern "C" int repro_closure_delete_paths(const void* r, const void* s,
                                          const void* affected, void* out,
                                          const void* work, int c, int w,
                                          void* stream) {
  if (c <= 0 || w <= 0) return 0;
  return launch_delete(r, s, affected, out, work, c, w,
                       static_cast<cudaStream_t>(stream));
}
