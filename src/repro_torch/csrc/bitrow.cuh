// Shared warp routines of the packed boolean-product kernels:
// closure_update uses or_selected_rows; the tiled kernels use
// or_selected_rows_batched (below), which computes the same.  bitmm and
// closure_delete have their own two paths (bitgemm.cuh).
//
// Layout: LSB-first 32-bit words; column j of a row lives in word j >> 5,
// bit j & 31.  One warp owns one output row m and 32 consecutive output
// words of it, lane = word n.  The warp walks the lhs row 32 words at a
// time (one coalesced load), skips zero words with a ballot, broadcasts
// each non-zero word with __shfl_sync, and for every set bit j ORs
// rhs[j][n] into the lane's register.  All lanes hold the same lhs word,
// so the bit loops never diverge, and each rhs load is one coalesced
// 128-byte row segment across the warp.
//
// The work is popcount(lhs row) x (N/32) word-ORs: it follows the data,
// which is fast on the sparse SGT graphs and slow on a dense closure.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps per block

// acc | OR_{j set in lhs_row} rhs[j][n]; lanes with n >= wn load nothing.
__device__ __forceinline__ uint32_t or_selected_rows(
    const uint32_t* __restrict__ lhs_row, int wk,
    const uint32_t* __restrict__ rhs, int wn, int n, uint32_t acc) {
  const int lane = threadIdx.x & 31;
  const bool live = n < wn;
  for (int kb = 0; kb < wk; kb += 32) {
    const int kw = kb + lane;
    const uint32_t word = kw < wk ? lhs_row[kw] : 0u;
    uint32_t nonzero = __ballot_sync(kFullMask, word != 0u);
    while (nonzero) {
      const int i = __ffs(nonzero) - 1;
      nonzero &= nonzero - 1;
      uint32_t bits = __shfl_sync(kFullMask, word, i);
      const size_t base = static_cast<size_t>(kb + i) * 32;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        if (live) acc |= rhs[(base + b) * static_cast<size_t>(wn) + n];
      }
    }
  }
  return acc;
}

// The tiled kernels' variant (B4, B5): the same result as
// or_selected_rows, with up to kGatherBatch rhs loads in flight instead of
// one.  or_selected_rows waits for each rhs[j][n] before it looks for the
// next set bit, so a row costs popcount x (L2 or HBM latency); at 1%
// density a set word mostly holds one bit, so batching inside a word
// would not help.  Here the warp numbers the set bits of each 32-word lhs
// chunk in order (a prefix count of the lanes' popcounts), each lane
// finds the bit of its own number (a binary search over the prefix counts
// by shuffle, then a select inside the word), and the warp walks those
// warp-uniform indices kGatherBatch at a time: all of a batch's loads
// (independent coalesced 128-byte row segments) issue before any OR.
constexpr int kGatherBatch = 8;

// Position of set bit number ``r`` (from 0) of ``w``; needs r < popc(w).
__device__ __forceinline__ int select_set_bit(uint32_t w, int r) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const int low = __popc(w & ((1u << half) - 1u));
    if (r >= low) {
      r -= low;
      pos += half;
      w >>= half;
    }
  }
  return pos;
}

// acc | OR_{j set in lhs_row} rhs[j][n]; lanes with n >= wn load nothing.
// All 32 lanes of the warp must call it (full-mask shuffles).
__device__ __forceinline__ uint32_t or_selected_rows_batched(
    const uint32_t* __restrict__ lhs_row, int wk,
    const uint32_t* __restrict__ rhs, int wn, int n, uint32_t acc) {
  const int lane = threadIdx.x & 31;
  const bool live = n < wn;
  const uint32_t* __restrict__ col = rhs + (live ? n : 0);
  for (int kb = 0; kb < wk; kb += 32) {
    const int kw = kb + lane;
    const uint32_t word = kw < wk ? lhs_row[kw] : 0u;
    if (__ballot_sync(kFullMask, word != 0u) == 0u) continue;
    // incl = set bits in the words of lanes 0..lane (inclusive scan)
    int incl = __popc(word);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += up;
    }
    const int total = __shfl_sync(kFullMask, incl, 31);
    for (int t0 = 0; t0 < total; t0 += 32) {
      // lane finds set bit number t = t0 + lane of the chunk: its word is
      // the first lane whose inclusive count exceeds t (for t >= total the
      // index is never read)
      const int t = t0 + lane;
      int owner = 0;
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        if (__shfl_sync(kFullMask, incl, owner + s - 1) <= t) owner += s;
      }
      const uint32_t owned = __shfl_sync(kFullMask, word, owner);
      const int before = __shfl_sync(kFullMask, incl, owner) - __popc(owned);
      const int j = (kb + owner) * 32 +
                    select_set_bit(owned, t < total ? t - before : 0);
      const int count = min(32, total - t0);
      for (int q0 = 0; q0 < count; q0 += kGatherBatch) {
        uint32_t got[kGatherBatch];
#pragma unroll
        for (int q = 0; q < kGatherBatch; ++q) {
          const int jq = __shfl_sync(kFullMask, j, q0 + q);
          got[q] = (live && q0 + q < count)
                       ? col[static_cast<size_t>(jq) * wn]
                       : 0u;
        }
#pragma unroll
        for (int q = 0; q < kGatherBatch; ++q) acc |= got[q];
      }
    }
  }
  return acc;
}

// Which (row, word) this thread's warp owns; false past the last row.
// The test is uniform across a warp (blockDim is a multiple of 32), so a
// warp either returns whole or runs the full-mask shuffles whole.
__device__ __forceinline__ bool warp_tile(int m, int wn, int* row, int* n) {
  const int chunks = (wn + 31) / 32;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= static_cast<long long>(m) * chunks) return false;
  *row = static_cast<int>(warp / chunks);
  *n = static_cast<int>(warp % chunks) * 32 + (threadIdx.x & 31);
  return true;
}

// The tiled kernels' block: one 32-row band x 32 output words, one warp
// per row (warp w owns row band * 32 + w, lane = word).
constexpr int kBandThreads = 32 * 32;

// Per-tile occupancy of one band, in the same pass as the output: every
// thread of the block holds its output word ``acc`` (row = warp, word =
// n); after the call occ_row[n] = 1 iff any of the band's 32 rows has a
// non-zero word n, for every n < wn of this block.  All threads of the
// block must call it (it holds two barriers).
__device__ __forceinline__ void store_band_occupancy(uint32_t acc, int n,
                                                     int wn,
                                                     uint32_t* occ_row) {
  __shared__ uint32_t any_set[32];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) any_set[lane] = 0u;
  __syncthreads();
  if (acc != 0u) atomicOr(&any_set[lane], 1u);
  __syncthreads();
  if (threadIdx.x < 32 && n < wn) occ_row[n] = any_set[lane];
}

inline unsigned blocks_for(int m, int wn) {
  const long long warps = static_cast<long long>(m) * ((wn + 31) / 32);
  return static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
}

}  // namespace repro_torch
