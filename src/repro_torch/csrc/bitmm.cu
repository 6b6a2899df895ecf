// B1 — packed boolean matrix product for Hopper (sm_90a).
//
//   out[m] = OR over {j : lhs bit j of row m set} of rhs[j]
//   lhs uint32 (M, K/32), rhs uint32 (K, N/32) -> out uint32 (M, N/32)
//
// Replaces the TPU kernel `bitmm` of src/repro/kernels/bitmm.py:50
// (pl.pallas_call at :61), which unpacks full-K panels to f32, multiplies
// on the MXU, thresholds and packs.  This kernel computes the same
// function without unpacking: one warp per (row, 32 output words), see
// bitrow.cuh.
//
// What bounds it on an H100 (3.35 TB/s HBM, 1979 TOP/s int8 tensor cores),
// counting each byte once:
//   * closure squaring at C = 16384: lhs, rhs and out are 32 MiB each,
//     ~96 MiB -> ~30 us of HBM traffic; as a dense binary GEMM 2*C^3 =
//     8.8e12 int8 ops -> ~4.4 ms.  The work this data needs is
//     2 * popcount(lhs) * N ops, far less on a sparse closure.
//   * frontier hop, B = 1024 rows: ~36 MiB -> ~11 us.
// What the design does about it: its work is popcount(lhs) x N/32 coalesced
// word loads and ORs, so it is fast while the operands are sparse (the SGT
// conflict graphs and their closures) and slow on a dense closure, where
// an int8 wgmma product on unpacked tiles with a threshold+ballot epilogue
// fed by TMA would be bound by the tensor cores instead.  That is later
// work; this kernel is the simple one that is right.
#include "bitrow.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kThreads)
bitmm_kernel(const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ rhs,
             uint32_t* __restrict__ out, int m, int wk, int wn) {
  int row, n;
  if (!repro_torch::warp_tile(m, wn, &row, &n)) return;
  const uint32_t acc = repro_torch::or_selected_rows(
      lhs + static_cast<size_t>(row) * wk, wk, rhs, wn, n, 0u);
  if (n < wn) out[static_cast<size_t>(row) * wn + n] = acc;
}

}  // namespace

extern "C" int repro_bitmm(const void* lhs, const void* rhs, void* out, int m,
                           int wk, int wn, void* stream) {
  if (m <= 0 || wn <= 0) return 0;
  bitmm_kernel<<<repro_torch::blocks_for(m, wn), repro_torch::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lhs), static_cast<const uint32_t*>(rhs),
      static_cast<uint32_t*>(out), m, wk, wn);
  return static_cast<int>(cudaGetLastError());
}
