// B4 — rank-B closure fold on the tiled region window for Hopper (sm_90a),
// with the per-32x32-tile occupancy of the output from the same pass.
//
//   out[w] = tiles[w] | OR over {j : mask[w, j]} rows[j]
//   occ[i][n] = 1 iff out rows 32i..32i+31 hold a non-zero word n
//   tiles uint32 (R, R/32), mask uint32 (R, B/32), rows uint32 (B, R/32)
//   -> out uint32 (R, R/32), occ uint32 (R/32, R/32) of 0/1
//   R is a multiple of 32 (not necessarily of 256); B a multiple of 32.
//
// Replaces the TPU kernel `closure_update_tiled` of
// src/repro/kernels/closure_update.py:120 (pl.pallas_call at :155), which
// runs a (128-row, 256-column) block on the MXU only when the block's
// mask rows and rows columns both carry bits, and writes the block's
// occupancy in its epilogue.  Here a thread block owns one 32-row band
// and 32 output words: each warp folds one row with the bitmm warp
// routine (bitrow.cuh) starting from the old tiles word, so a row whose
// mask is empty costs one ballot per 32 mask words and a copy (the
// row-band skip, at row grain), and a rows word is loaded only for a set
// mask bit (the column-band skip needs no test).  Then one OR across the
// band's 32 rows in shared memory gives its 32 occupancy entries: no
// second pass over the output.
//
// What bounds it on an H100 at the main path's shape (R = 1024, B = 128):
// tiles in and out 128 KiB each, mask and rows 16 KiB each, occ 4 KiB,
// ~0.3 MiB -> under 0.1 us of HBM traffic; the ops, 2 * popcount(mask) *
// R, are fewer still.  So the launch latency (a few us) sets the time, and
// the design keeps to one launch with no scratch.
#include "bitrow.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kBandThreads)
closure_update_tiled_kernel(const uint32_t* __restrict__ tiles,
                            const uint32_t* __restrict__ mask,
                            const uint32_t* __restrict__ rows,
                            uint32_t* __restrict__ out,
                            uint32_t* __restrict__ occ, int wb, int w) {
  const int band = blockIdx.y;
  const int row = band * 32 + (threadIdx.x >> 5);
  const int n = blockIdx.x * 32 + (threadIdx.x & 31);
  const size_t at = static_cast<size_t>(row) * w + n;
  const uint32_t old = n < w ? tiles[at] : 0u;
  const uint32_t acc = repro_torch::or_selected_rows(
      mask + static_cast<size_t>(row) * wb, wb, rows, w, n, old);
  if (n < w) out[at] = acc;
  repro_torch::store_band_occupancy(acc, n, w,
                                    occ + static_cast<size_t>(band) * w);
}

}  // namespace

extern "C" int repro_closure_update_tiled(const void* tiles, const void* mask,
                                          const void* rows, void* out,
                                          void* occ, int r, int wb, int w,
                                          void* stream) {
  if (r <= 0 || w <= 0) return 0;
  const dim3 grid((w + 31) / 32, r / 32);
  closure_update_tiled_kernel<<<grid, repro_torch::kBandThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const uint32_t*>(mask),
      static_cast<const uint32_t*>(rows), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(occ), wb, w);
  return static_cast<int>(cudaGetLastError());
}
