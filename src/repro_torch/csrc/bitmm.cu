// B1 — packed boolean matrix product for Hopper (sm_90a).
//
//   out[m] = OR over {j : lhs bit j of row m set} of rhs[j]
//   lhs uint32 (M, K/32), rhs uint32 (K, N/32) -> out uint32 (M, N/32)
//
// Replaces the TPU kernel `bitmm` of src/repro/kernels/bitmm.py:50
// (pl.pallas_call at :61), which unpacks full-K panels to f32, multiplies
// on the MXU, thresholds and packs: work that does not follow the data.
// Here each block of 128 lhs rows takes one of two paths (bitgemm.cuh),
// chosen on the device from the block's set bits:
//   * sparse blocks gather: per set lhs bit one rhs row segment, found
//     from a list of the block's set bits, 16 loads in flight a warp.
//     Bound by those bytes, popcount(lhs) x N/8 (5.5 GB at the 1%
//     squaring below), and by the instructions a set bit costs.
//   * dense blocks multiply tiles unpacked in shared memory on the int8
//     tensor cores (wgmma m64n256k32).  Bound by 2 x 128 x K x N
//     operations a block, less the 128 x 128 lhs chunks that are all 0.
//
// What bounds a call on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8),
// counting each byte once:
//   * closure squaring at C = 16384: lhs, rhs and out are 32 MiB each,
//     ~96 MiB -> ~30 us of HBM traffic; the operations the data needs,
//     2 * popcount(lhs) * N: 8.8e9 at 1% (4.4 us), 4.4e12 on a closure
//     that is a full triangle (2.2 ms); the dense path does up to 2 * C^3
//     = 8.8e12 (4.4 ms).
//   * frontier hop, B = 1024 rows: ~36 MiB -> ~11 us.
// The threshold between the paths is bitgemm::kDensePerMille (the block's
// set bits per mille of its cells), where the two paths' times cross on
// the C = 16384 squaring; bitgemm.cuh gives the measurement.
#include "bitgemm.cuh"

namespace {

namespace bg = repro_torch::bitgemm;

__global__ void __launch_bounds__(bg::kWorkThreads)
bitmm_work_kernel(const uint32_t* __restrict__ lhs, int m, int wk,
                  int* __restrict__ work) {
  bg::block_work(lhs, nullptr, m, wk, work);
}

__global__ void __launch_bounds__(bg::kThreads, 1)
bitmm_kernel(const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ rhs,
             uint32_t* __restrict__ out, const int* __restrict__ work, int m,
             int wk, int wn) {
  bg::product_block<false>(lhs, rhs, nullptr, out, work, m, wk, wn);
}

int launch_bitmm(const void* lhs, const void* rhs, void* out, const void* work,
                 int m, int wk, int wn, cudaStream_t stream) {
  static bool attr_set = false;   // once per process
  return bg::launch_main(bitmm_kernel, &attr_set, m, wk, wn, stream,
                         static_cast<const uint32_t*>(lhs),
                         static_cast<const uint32_t*>(rhs),
                         static_cast<uint32_t*>(out),
                         static_cast<const int*>(work), m, wk, wn);
}

}  // namespace

// work: int32 scratch of ceil(m / 128) entries, written by the first launch.
extern "C" int repro_bitmm(const void* lhs, const void* rhs, void* out,
                           void* work, int m, int wk, int wn, void* stream) {
  if (m <= 0 || wn <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bitmm_work_kernel<<<bg::work_blocks(m), bg::kWorkThreads, 0, s>>>(
      static_cast<const uint32_t*>(lhs), m, wk, static_cast<int*>(work));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_bitmm(lhs, rhs, out, work, m, wk, wn, s);
}

// The main launch alone, on a work array the caller fills: a block takes
// the dense path when its entry is above the threshold.  chip_smoke.py
// times each path at one shape this way.
extern "C" int repro_bitmm_paths(const void* lhs, const void* rhs, void* out,
                                 const void* work, int m, int wk, int wn,
                                 void* stream) {
  if (m <= 0 || wn <= 0) return 0;
  return launch_bitmm(lhs, rhs, out, work, m, wk, wn,
                      static_cast<cudaStream_t>(stream));
}

// The threshold the main launch compares each block's work with, per mille
// of its 128 x K cells.
extern "C" int repro_bitgemm_dense_per_mille() { return bg::kDensePerMille; }
