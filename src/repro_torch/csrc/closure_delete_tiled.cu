// B5 — one delete-repair hop on the tiled region window for Hopper
// (sm_90a), with the per-32x32-tile occupancy of the output from the same
// pass.
//
//   out[w] = affected[w] ? r[w] | OR over {x : r[w, x]} s[x] : r[w]
//   occ[i][n] = 1 iff out rows 32i..32i+31 hold a non-zero word n
//   r, s uint32 (R, R/32), affected uint32 (R/32,) row mask
//   -> out uint32 (R, R/32), occ uint32 (R/32, R/32) of 0/1
//   R is a multiple of 32 (not necessarily of 256).
//
// Replaces the TPU kernel `closure_delete_tiled` of
// src/repro/kernels/closure_delete.py:134 (pl.pallas_call at :169), which
// runs a block on the MXU only when its row band holds an affected,
// non-empty row and the hop matrix has bits in its column band, and
// writes the block's occupancy in its epilogue.
//
// What bounds it on an H100: not bytes.  At the main path's shape (R =
// 1024) r, s and out are 128 KiB each, occ 4 KiB: ~0.4 MiB, about 0.12 us
// of HBM traffic; the ops, 2 * popcount(affected rows of r) * R, are
// fewer still.  A call's time is the host's: the wrapper's checks, its two
// allocations, the ctypes call and the launch take several times the
// 2-3 us of device work (PERF.md section 6).  The device time is the
// launch plus the dependent gathers of an affected row: at 1% density its
// ~10 set bits cost ~10 serial L2/HBM round trips when gathered one at a
// time (5.3-6.3 us of device time; NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6).
//
// What the design does about it.  Host: one launch, no scratch, no
// memset; the wrapper checks its operands in one pass and allocates its
// two outputs, and the shared launch path (kernels/_build.py) calls this
// entry point through a cached ctypes function on the raw current
// stream.  Device: a thread block owns one 32-row band and 32 output
// words, one warp per row: an unaffected row is copied through, and an
// affected row runs or_selected_rows_batched (bitrow.cuh) over r[w] as
// the lhs row, up to 8 s[x] loads in flight a warp, so ~10 set bits cost
// two round trips; an empty row costs one ballot per 32 words and an s
// word is loaded only for a set bit of r[w] — the Pallas kernel's skips,
// at row and bit grain.  One OR across the band's 32 rows in shared
// memory then gives its 32 occupancy entries.  The band stays one
// 1024-thread block: with 10 set bits an affected row, one row affected
// takes ~2.2 us on the device, one band ~3.1 us and all 32 bands ~3.2 us
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), so neither the 32
// SMs at work nor the band's barriers set the time at the main path's 1%
// of rows affected (about one row a band).
//
// The output is a separate buffer: other warps read r[w] as their lhs row
// while this warp writes row w, so writing in place would race.
#include "bitrow.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kBandThreads)
closure_delete_tiled_kernel(const uint32_t* __restrict__ r,
                            const uint32_t* __restrict__ s,
                            const uint32_t* __restrict__ affected,
                            uint32_t* __restrict__ out,
                            uint32_t* __restrict__ occ, int w) {
  const int band = blockIdx.y;
  const int row = band * 32 + (threadIdx.x >> 5);
  const int n = blockIdx.x * 32 + (threadIdx.x & 31);
  const size_t at = static_cast<size_t>(row) * w + n;
  const uint32_t old = n < w ? r[at] : 0u;
  uint32_t acc = old;
  if ((affected[row >> 5] >> (row & 31)) & 1u) {  // uniform across the warp
    acc = repro_torch::or_selected_rows_batched(
        r + static_cast<size_t>(row) * w, w, s, w, n, old);
  }
  if (n < w) out[at] = acc;
  repro_torch::store_band_occupancy(acc, n, w,
                                    occ + static_cast<size_t>(band) * w);
}

}  // namespace

extern "C" int repro_closure_delete_tiled(const void* r, const void* s,
                                          const void* affected, void* out,
                                          void* occ, int rows, int w,
                                          void* stream) {
  if (rows <= 0 || w <= 0) return 0;
  const dim3 grid((w + 31) / 32, rows / 32);
  closure_delete_tiled_kernel<<<grid, repro_torch::kBandThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(r), static_cast<const uint32_t*>(s),
      static_cast<const uint32_t*>(affected), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(occ), w);
  return static_cast<int>(cudaGetLastError());
}
