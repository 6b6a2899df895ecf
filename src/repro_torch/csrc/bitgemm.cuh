// The two paths of the packed boolean products B1 (bitmm.cu), B2
// (closure_update.cu) and B3 (closure_delete.cu) on Hopper (sm_90a),
// chosen on the device for each block of 128 lhs rows.
//
//   out[m] = OR over {j : lhs bit j of row m set} of rhs[j]
//   lhs uint32 (M, K/32), rhs uint32 (K, N/32) -> out uint32 (M, N/32)
//   B2: lhs = mask (C, B/32), rhs = rows (B, C/32), out[w] = closure[w] |
//       product
//   B3: lhs = r, rhs = s, out[w] = affected[w] ? r[w] | product : r[w]
// The three differ only in the old words an output row starts from (Mode):
// none (B1), a separate operand of wn words a row (B2's closure), or the
// lhs row itself on affected rows (B3).
//
// Words are LSB first: column j of a row is bit j & 31 of word j >> 5.
//
// Two launches a call.  The first (block_work) writes each block's work,
// the set bits of its lhs rows (B3: of its affected rows only), into an
// int32 array of ceil(M / 128) entries.  The second has four CTAs per
// (row block, 128 output words); each reads its block's entry and takes
// one of two paths, so blocks on both sides meet in one launch.
//
// * Sparse (work <= kDensePerMille / 1000 of the block's 128 x K cells):
//   each CTA takes 32 of the block's rows and 128 output words, a lane 4
//   words.  Bound by the gathers: per set lhs bit one 512-byte rhs row
//   segment (popcount(lhs) x N/8 bytes, 5.5 GB at the 1% squaring of
//   C = 16384) and the instructions that find the bits.  This kernel
//   has 12 warps a SM (the dense path's CTA sizes it), and with so few,
//   B4/B5's or_selected_rows_batched (bitrow.cuh: one row a warp, 8
//   loads in flight) was slower there than B1's earlier kernel, one
//   load in flight a warp at 64 warps a SM.
//   Here each warp scans a twelfth of the CTA's gathering rows' words in
//   order, appends one (row, j) entry a set bit to its own list in shared
//   memory, and gathers the list 16 entries at a time, every load issued
//   before any is used; the list is in row order, so loaded words are
//   ORed in registers and into the row's words in shared memory only when
//   the row changes.  No block-wide barrier inside; an affected row of B3
//   spreads over all twelve warps; unaffected rows are one copy.  B2's
//   and B3's rows start from their old words, read once into shared
//   memory.
// * Dense: int8 tensor cores on tiles unpacked in shared memory, bound by
//   the 2 x 128 x K x N operations of the block (1979 TOP/s int8 on an
//   H100 SXM: 4.4 ms for a whole C = 16384 squaring).  The CTA walks its
//   128 words as tiles of 128 rows x 256 columns, each over K in stages
//   of 128 (a ring of kStages stages in shared memory with a full and an
//   empty mbarrier each, as B7).
//   - Warpgroup 0 produces.  Its threads copy each stage's packed words
//     (128 k rows x 8 words of rhs, 128 rows x 4 words of lhs) into a ring
//     of kPackStages pack stages by cp.async, 16 bytes a copy where rows
//     allow, three stages ahead (TMA needs 16-byte row strides, and a row
//     of N/32 words is only 4-byte aligned when N/32 is not a multiple of
//     4; 4-byte plain loads left the producer waiting on them).  Then
//     thread (e, u) turns k rows 8e .. 8e+7 of word u into the tile's
//     bytes of those k and its 32 columns: four byte transposes by prmt
//     gather byte b of the 8 rows, and column 8b + c is that gather masked
//     to bit c of each byte (value 2^c, not 1: one AND a 4 bytes).  The
//     bytes go K-major with a 128-byte swizzle (row n of the tile = 128
//     bytes of k; 16-byte chunk index XOR n % 8), the layout wgmma reads,
//     by 8-byte stores that meet no bank conflict beyond the two
//     wavefronts 256 bytes need.  A stage whose 128 x 128 lhs bits are
//     all 0 is flagged and neither unpacked nor multiplied: the work then
//     follows the lhs at that grain (half the stages of a triangular
//     closure's squaring).
//   - Warpgroups 1 and 2 consume 64 rows each.  A lane unpacks its two
//     rows' lhs words into the m16n8k32 A fragment in registers (a nibble
//     times 0x00204081, masked: bytes 0/1) and issues wgmma
//     m64n256k32.s32.u8.u8 with B from shared memory, 4 a stage in one
//     commit group.  A is rebuilt only after the last group is done:
//     ptxas serializes every product when a register a product reads is
//     written while a group is in flight, and the other warpgroup's group
//     runs meanwhile.
//   - Epilogue: acc > 0 is a bit (no sum overflows: bytes <= 1 x 128,
//     K < 2^24); the 4 lanes that hold a row's 32 columns of a word OR
//     their 8 bits by __shfl_xor_sync and each writes a quarter of the
//     words.  B2 writes closure | bits; B3 writes old | bits on affected
//     rows and old on the others, as the TPU kernel's jnp.where.
//   Nothing leaves shared memory unpacked; no scratch but the work array.
//
// The threshold (kDensePerMille): the sparse path's time grows with the
// block's set bits and the dense path's does not, so the two cross at one
// density.  chip_smoke.py phase 3 times both, every block forced, on the
// C = 16384 squaring at densities 1% .. 50% (its "crossover" line).
// Measured on an H100 80GB HBM3 at 700 W: sparse 1.17 ms at 1%, 2.23 at
// 2%, 5.72 at 5%, 10.92 at 10%; dense 8.80-8.94 at every density.  They
// cross at ~8.1%, so a block goes dense above 80 per mille.  B2's fold
// (K = 1024: 8 stages a dense tile, and the old closure in its epilogue)
// crosses at ~10.5% (sparse 0.11 / 0.31 / 0.56 / 1.05 ms at 1 / 5 / 10 /
// 20% mask density, dense 0.58-0.59 at every density; same card), within
// 2x of B1's, so the three share the one threshold.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "bitrow.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace bitgemm {

constexpr int kRows = 128;          // lhs rows a block (the unit of choice)
constexpr int kLaneWords = 4;       // output words a sparse lane owns
constexpr int kBlockWords = 32 * kLaneWords;   // output words a CTA
constexpr int kSubRows = 32;        // rows a sparse CTA takes of its block
constexpr int kSubBlocks = kRows / kSubRows;   // CTAs a row block has
constexpr int kTileWords = 8;       // output words a dense tile
constexpr int kTileCols = 32 * kTileWords;
constexpr int kStageWords = 4;      // lhs words (128 k) a ring stage
constexpr int kStages = 4;
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
constexpr int kWorkThreads = 1024;  // the first launch: a block per row block
// dense when the block's set lhs bits exceed this share (per mille) of its
// 128 x K cells
constexpr int kDensePerMille = 80;

// shared memory from a 1024-aligned base: kStages B tiles (256 rows of
// 128 k bytes), kStages A stages (128 rows x 4 lhs words), then the full
// and the empty barrier and a flag (any lhs bit set) of each stage
constexpr uint32_t kBTileBytes = kTileCols * 128;
constexpr uint32_t kATileBytes = kRows * kStageWords * 4;
constexpr uint32_t kAOffset = kStages * kBTileBytes;
constexpr uint32_t kBarOffset = kAOffset + kStages * kATileBytes;
// then kPackStages stages of packed words as copied (cp.async): 128 rhs
// rows x 8 words, padded by kPad words every 8 rows, and 128 lhs rows x 4
constexpr int kPackStages = 4;
constexpr int kPad = 4;   // words after every 8 rhs rows of a pack stage
constexpr uint32_t kPackRhsBytes = (128 * 8 + kPad * 16) * 4;
constexpr uint32_t kPackBytes = kPackRhsBytes + kATileBytes;
constexpr uint32_t kPackOffset = kBarOffset + 32 * kStages;
constexpr size_t kSmemBytes = kPackOffset + kPackStages * kPackBytes + 1024;

// What a row's output starts from, and which rows gather:
//   kProduct (B1): 0; every row gathers.
//   kFold (B2): old, a separate (M, wn) operand; every row gathers.
//   kDelete (B3): old is the lhs (wk == wn); affected rows gather onto it,
//     the others are old.
enum class Mode { kProduct, kFold, kDelete };

__device__ __forceinline__ bool is_dense(int work, int wk) {
  return static_cast<long long>(work) * 1000 >
         static_cast<long long>(kDensePerMille) * kRows * 32 * wk;
}

__device__ __forceinline__ bool row_affected(const uint32_t* affected,
                                             int row) {
  return (affected[row >> 5] >> (row & 31)) & 1u;
}

// ---------------------------------------------------------- first launch

// work[blockIdx.x] = set bits of the block's lhs rows (of its affected
// rows when affected is not null).  kWorkThreads threads; warp w reads
// rows w, w + 32, ... of the block, 16-byte loads when rows allow.
__device__ __forceinline__ void block_work(
    const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ affected,
    int m, int wk, int* __restrict__ work) {
  __shared__ int total;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec =
      (wk & 3) == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int sum = 0;
  for (int r = warp; r < rows; r += kWorkThreads / 32) {
    const int row = r0 + r;
    if (affected != nullptr && !row_affected(affected, row)) continue;
    const uint32_t* p = lhs + static_cast<size_t>(row) * wk;
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
      for (int i = lane; i < wk / 4; i += 32) {
        const uint4 x = __ldg(p4 + i);
        sum += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < wk; i += 32) sum += __popc(__ldg(p + i));
    }
  }
  sum = __reduce_add_sync(kFullMask, sum);
  if (lane == 0 && sum != 0) atomicAdd(&total, sum);
  __syncthreads();
  if (threadIdx.x == 0) work[blockIdx.x] = total;
}

// ---------------------------------------------------------- sparse path

// The sparse path's shared memory (inside the dense path's allocation):
// the CTA's 32 rows x 128 output words, each warp's list of (local row,
// lhs bit j) entries, and the CTA's rows whose bits gather.
constexpr int kScanWords = 2;            // lhs words a lane a round
constexpr int kScanAhead = 2;            // rounds whose words load at once
constexpr int kSparseRun = 16;           // rhs loads in flight a warp
constexpr int kWarpList = 2048;          // entries a warp's list holds
constexpr uint32_t kSList = kSubRows * kBlockWords * 4;
constexpr uint32_t kSRows = kSList + kWarps * kWarpList * 4;
constexpr uint32_t kSparseBytes = kSRows + kSubRows * 4;
static_assert(kSparseBytes + 1024 <= kSmemBytes,
              "the sparse path lives in the dense path's shared memory");
static_assert(kWarpList >= 32 * kScanWords * 32,
              "a warp's list holds at least one round's bits");

// The kLaneWords words of row `row` from column n (lanes own consecutive
// words); 16-byte loads when rows allow, zeros past wn.
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ p,
                                            size_t row, int n, int wn,
                                            bool vec) {
  const uint32_t* q = p + row * wn + n;
  if (vec) return n < wn ? __ldg(reinterpret_cast<const uint4*>(q)) : uint4{};
  uint4 v;
  v.x = n < wn ? __ldg(q) : 0u;
  v.y = n + 1 < wn ? __ldg(q + 1) : 0u;
  v.z = n + 2 < wn ? __ldg(q + 2) : 0u;
  v.w = n + 3 < wn ? __ldg(q + 3) : 0u;
  return v;
}

__device__ __forceinline__ void or_words(uint32_t* s, uint4 v) {
  if (v.x != 0u) atomicOr(s, v.x);
  if (v.y != 0u) atomicOr(s + 1, v.y);
  if (v.z != 0u) atomicOr(s + 2, v.z);
  if (v.w != 0u) atomicOr(s + 3, v.w);
}

// One warp gathers its list: kSparseRun entries at a time, one coalesced
// 512-byte load of an rhs row segment each (16 bytes a lane), all issued
// before any is used.  The list is in row order, so the loaded words are
// ORed in registers while the row stays the same and into the row's words
// in shared memory (atomic ORs: a row's bits may sit in two warps' lists)
// when it changes.
__device__ __forceinline__ void gather_list(const uint32_t* __restrict__ list,
                                            int count,
                                            const uint32_t* __restrict__ rhs,
                                            int wn, int n, bool vec,
                                            uint32_t* sacc) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int p = 0; p < count; p += kSparseRun) {
    uint32_t ent[kSparseRun];
    uint4 got[kSparseRun];
#pragma unroll
    for (int q = 0; q < kSparseRun; ++q)
      ent[q] = list[min(p + q, count - 1)];
#pragma unroll
    for (int q = 0; q < kSparseRun; ++q)
      got[q] = p + q < count ? load_words(rhs, ent[q] & 0xFFFFFFu, n, wn, vec)
                             : uint4{};
    uint32_t row = ent[0] >> 24;
    uint4 acc{};
#pragma unroll
    for (int q = 0; q < kSparseRun; ++q) {
      if ((ent[q] >> 24) != row) {   // the same in every lane
        or_words(&sacc[row * kBlockWords + kLaneWords * lane], acc);
        row = ent[q] >> 24;
        acc = uint4{};
      }
      acc.x |= got[q].x;
      acc.y |= got[q].y;
      acc.z |= got[q].z;
      acc.w |= got[q].w;
    }
    or_words(&sacc[row * kBlockWords + kLaneWords * lane], acc);
  }
  __syncwarp();
}

// 32 rows (the sub-th quarter of the row block) x 128 output words (lane =
// 4 words): a quarter block a CTA, so that a small M still fills the
// card.  Its output words start at 0 (B2, B3: the old words) in shared
// memory.  Its gathering rows (B3: the affected ones) hold n_rows x wk
// lhs words; each warp scans a twelfth of them, in order, 64 words a round
// (kScanAhead rounds loaded at once, the next while these are scanned),
// numbers each round's set bits by a warp scan and appends one entry a
// bit to its own list; when the round would not fit, it gathers its list
// (gather_list) first.  No block-wide barrier between the first and the
// last; no warp walks a row alone, so one affected row spreads over all
// twelve warps.  A lane owns 4 words, so each entry's instructions serve
// 512 bytes.
template <Mode kMode>
__device__ __forceinline__ void sparse_block(
    const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ rhs,
    const uint32_t* __restrict__ old, const uint32_t* __restrict__ affected,
    uint32_t* __restrict__ out, int m, int wk, int wn, int sub) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sacc = reinterpret_cast<uint32_t*>(smem_raw);
  int* rows_of = reinterpret_cast<int*>(smem_raw + kSRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t* list =
      reinterpret_cast<uint32_t*>(smem_raw + kSList) + warp * kWarpList;
  const int r0 = (blockIdx.x / kSubBlocks) * kRows + sub * kSubRows;
  const int rows = min(kSubRows, m - r0);   // may be <= 0 past the end
  const int n = blockIdx.y * kBlockWords + kLaneWords * lane;
  // 16-byte loads and stores of a lane's words when rows allow
  const bool vec = (wn & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(lhs) |
                     reinterpret_cast<uintptr_t>(rhs) |
                     reinterpret_cast<uintptr_t>(old) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  constexpr int kPer = (kSubRows + kWarps - 1) / kWarps;
  uint4 v[kPer];   // the old words, every load issued before the first store
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int r = warp + x * kWarps;
    v[x] = kMode != Mode::kProduct && r < rows
               ? load_words(old, r0 + r, n, wn, vec)
               : uint4{};
  }
  auto store_old = [&]() {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int r = warp + x * kWarps;
      if (r < kSubRows)
        *reinterpret_cast<uint4*>(&sacc[r * kBlockWords + kLaneWords * lane]) =
            v[x];
    }
  };
  // B3 numbers its affected rows in shared memory before it scans.  In B1
  // and B2 every row below `rows` gathers (gathering row i is local row
  // i), so their first scan batch is issued below, beside the old words'
  // loads, and the barrier comes after it: a near-empty fold waits on one
  // round of loads, not two.
  if constexpr (kMode == Mode::kDelete) store_old();
  static_assert(kSubRows == 32, "one warp's ballot numbers the rows");
  const bool g = lane < rows &&
                 (kMode != Mode::kDelete || row_affected(affected, r0 + lane));
  const uint32_t gathering = __ballot_sync(kFullMask, g);   // every warp
  const int n_rows = __popc(gathering);
  if constexpr (kMode == Mode::kDelete) {
    if (warp == 0 && g)
      rows_of[__popc(gathering & ((1u << lane) - 1u))] = lane;
    __syncthreads();
  }

  // Words are numbered f = (gathering row i) * wk + kw; this warp scans
  // [lo, hi), lane words lo + 64 round + 2 lane + x.
  constexpr int kStep = 32 * kScanWords;
  constexpr int kBatchWords = kScanAhead * kScanWords;
  const int total = n_rows * wk;
  const int lo = static_cast<int>(static_cast<long long>(total) * warp /
                                  kWarps);
  const int hi = static_cast<int>(static_cast<long long>(total) *
                                  (warp + 1) / kWarps);
  const int wk1 = max(wk, 1);
  int f = lo + kScanWords * lane;     // the next word to load: row i, kw
  int i = f / wk1;
  int kw = f - i * wk;
  const int step_rows = kStep / wk1, step_kw = kStep - step_rows * wk;
  // w[y]: a word; we[y]: its entries' common part, (row << 24) | 32 kw
  uint32_t w[kBatchWords], we[kBatchWords];
  auto load_batch = [&]() {
#pragma unroll
    for (int d = 0; d < kScanAhead; ++d) {
      int i0 = i, kw0 = kw;
#pragma unroll
      for (int x = 0; x < kScanWords; ++x) {
        const int y = d * kScanWords + x;
        const bool ok = f + x < hi;
        const int row =
            !ok ? 0 : kMode == Mode::kDelete ? rows_of[i0] : i0;
        we[y] = (static_cast<uint32_t>(row) << 24) |
                static_cast<uint32_t>(kw0 * 32);
        w[y] = ok ? __ldg(lhs + static_cast<size_t>(r0 + row) * wk + kw0)
                  : 0u;
        if (++kw0 == wk) {
          kw0 = 0;
          ++i0;
        }
      }
      f += kStep;
      i += step_rows;
      kw += step_kw;
      if (kw >= wk) {
        kw -= wk;
        ++i;
      }
    }
  };
  if (lo < hi) load_batch();
  if constexpr (kMode != Mode::kDelete) {
    store_old();
    __syncthreads();   // every row's old words are in before a gather
  }
  int count = 0;   // entries in this warp's list
  for (int base = lo; base < hi; base += kScanAhead * kStep) {
    uint32_t cw[kBatchWords], ce[kBatchWords];
#pragma unroll
    for (int y = 0; y < kBatchWords; ++y) {
      cw[y] = w[y];
      ce[y] = we[y];
    }
    if (base + kScanAhead * kStep < hi) load_batch();   // the next batch
#pragma unroll
    for (int d = 0; d < kScanAhead; ++d) {
      if (base + d * kStep >= hi) break;   // the same in every lane
      int bits = 0;
#pragma unroll
      for (int x = 0; x < kScanWords; ++x)
        bits += __popc(cw[d * kScanWords + x]);
      int incl = bits;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += up;
      }
      const int round_bits = __shfl_sync(kFullMask, incl, 31);
      if (count + round_bits > kWarpList) {
        gather_list(list, count, rhs, wn, n, vec, sacc);
        count = 0;
      }
      int pos = count + incl - bits;
#pragma unroll
      for (int x = 0; x < kScanWords; ++x) {
        const int y = d * kScanWords + x;
        uint32_t v = cw[y];
        while (v != 0u) {
          const int b = __ffs(v) - 1;
          v &= v - 1u;
          list[pos++] = ce[y] + b;
        }
      }
      count += round_bits;
    }
  }
  gather_list(list, count, rhs, wn, n, vec, sacc);
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        &sacc[r * kBlockWords + kLaneWords * lane]);
    uint32_t* o = out + static_cast<size_t>(r0 + r) * wn + n;
    if (vec) {
      if (n < wn) *reinterpret_cast<uint4*>(o) = v;
    } else {
      if (n < wn) o[0] = v.x;
      if (n + 1 < wn) o[1] = v.y;
      if (n + 2 < wn) o[2] = v.z;
      if (n + 3 < wn) o[3] = v.w;
    }
  }
}

// ----------------------------------------------------------- dense path

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t x,
                                             uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(x), "r"(y) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t x,
                                             uint32_t y, uint32_t z,
                                             uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// 4 bytes from global to shared memory, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// OR of pred over the producer warpgroup (named barrier 1, 128 threads).
__device__ __forceinline__ bool any_in_producers(bool pred) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r) : "r"(pred ? 1u : 0u) : "memory");
  return r != 0u;
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// Bytes 0/1 of bits 0..3 of x: byte i = bit i.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The producer's part of one stage: w[i] is word u of rhs row 8e + i of
// the stage (0 past K or N); the tile's bytes for those k and the 32
// columns of word u go to dst (the tile + u * 32 rows), K-major, 128-byte
// swizzled.
__device__ __forceinline__ void unpack_rhs(const uint32_t (&w)[8],
                                           uint32_t dst, int e) {
  // y[b][h]: byte b of rows 8e + 4h .. 8e + 4h + 3, one a byte
  uint32_t y[4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo01 = __byte_perm(w[4 * h], w[4 * h + 1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[4 * h], w[4 * h + 1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[4 * h + 2], w[4 * h + 3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[4 * h + 2], w[4 * h + 3], 0x7362);
    y[0][h] = __byte_perm(lo01, lo23, 0x5410);
    y[1][h] = __byte_perm(lo01, lo23, 0x7632);
    y[2][h] = __byte_perm(hi01, hi23, 0x5410);
    y[3][h] = __byte_perm(hi01, hi23, 0x7632);
  }
  const uint32_t half = (e & 1) << 3, chunk = e >> 1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // column n = 8b + c: its row's 16-byte chunk e/2 lands at chunk
    // (e/2) ^ (n % 8) = (e/2) ^ c
    const uint32_t at = dst + (((chunk ^ c) << 4) | half);
    const uint32_t mask = 0x01010101u << c;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      st_shared_v2(at + (8 * b + c) * 128, y[b][0] & mask, y[b][1] & mask);
  }
}

// The 8 words of this thread's two rows (i = 0: row lr, 1: lr + 8) and
// word v of the tile, from the accumulator: d[4j + 2i + cc] is column
// 8j + 2q + cc.  After the quad's OR every lane of the quad holds them.
__device__ __forceinline__ void acc_to_words(const uint32_t (&acc)[128],
                                             int q, uint32_t (&word)[2][8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      uint32_t bits = 0u;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          bits |= (acc[4 * (4 * v + jj) + 2 * i + cc] != 0u ? 1u : 0u)
                  << (8 * jj + cc);
      }
      bits <<= 2 * q;
      bits |= __shfl_xor_sync(kFullMask, bits, 1);
      bits |= __shfl_xor_sync(kFullMask, bits, 2);
      word[i][v] = bits;
    }
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[8], int q,
                                          int hi) {
  const uint32_t a = q & 1 ? w[4 * hi + 1] : w[4 * hi];
  const uint32_t b = q & 1 ? w[4 * hi + 3] : w[4 * hi + 2];
  return q & 2 ? b : a;
}

template <Mode kMode>
__device__ __forceinline__ void dense_block(
    const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ rhs,
    const uint32_t* __restrict__ old, const uint32_t* __restrict__ affected,
    uint32_t* __restrict__ out, int m, int wk, int wn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_b = base;
  const uint32_t s_a = base + kAOffset;
  const uint32_t bar_full = base + kBarOffset;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t s_flag = bar_empty + 8 * kStages;   // a stage has lhs bits
  const uint32_t s_pack = base + kPackOffset;
  // the warpgroup, warp-uniform by a shuffle so each role's branch (and
  // its setmaxnreg) is seen to be taken by whole warps
  const int wg = __shfl_sync(kFullMask, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 128);   // producer threads
      hopper::mbar_init(bar_empty + 8 * s, 8);    // consumer warps
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int r0 = (blockIdx.x / kSubBlocks) * kRows;
  const int w0 = blockIdx.y * kBlockWords;
  const int n_tiles = (min(kBlockWords, wn - w0) + kTileWords - 1) /
                      kTileWords;
  const int n_stages = (wk + kStageWords - 1) / kStageWords;
  const int steps = n_tiles * n_stages;   // (tile, stage) pairs in order

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::reg_dealloc<kProducerRegs>();
    const int t = threadIdx.x;
    const int pw = t >> 5, lane = t & 31;
    const int e = t & 15, u = t >> 4;        // this thread's unpack unit
    const int k_rows = 32 * wk;
    // Copies of step x into pack stage x % kPackStages: rhs row k of the
    // stage at word 8k + 4(k / 8), so that 16-byte copies stay aligned
    // and the unpack's loads (16 k groups x 2 words a warp) meet at most
    // two to a bank.
    // rows of 16-byte multiples on 16-byte aligned bases copy by 16 bytes
    const bool vec = (wn & 3) == 0 && (wk & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(lhs) |
                       reinterpret_cast<uintptr_t>(rhs)) & 15) == 0;
    auto issue = [&](int x) {
      const int tile = x / n_stages, st = x - tile * n_stages;
      const uint32_t dst = s_pack + (x % kPackStages) * kPackBytes;
      const int col0 = w0 + tile * kTileWords;
      if (vec) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {   // rhs: 16 rows x 2 chunks a warp
          const int k = c * 64 + pw * 16 + (lane >> 1);
          const int kg = st * 128 + k, col = col0 + 4 * (lane & 1);
          const bool ok = kg < k_rows && col < wn;
          cp_async16(dst + (k * 8 + kPad * (k >> 3) + 4 * (lane & 1)) * 4,
                     ok ? rhs + static_cast<size_t>(kg) * wn + col : rhs, ok);
        }
        const int kw = st * kStageWords;   // lhs: one row a thread
        const bool ok = r0 + t < m && kw < wk;
        cp_async16(dst + kPackRhsBytes + t * 16,
                   ok ? lhs + static_cast<size_t>(r0 + t) * wk + kw : lhs, ok);
      } else {
        const int col = col0 + (lane & 7);
#pragma unroll
        for (int c = 0; c < 8; ++c) {   // rhs: 4 rows x 8 words a warp
          const int k = c * 16 + pw * 4 + (lane >> 3);
          const int kg = st * 128 + k;
          const bool ok = kg < k_rows && col < wn;
          cp_async4(dst + (k * 8 + kPad * (k >> 3) + (lane & 7)) * 4,
                    ok ? rhs + static_cast<size_t>(kg) * wn + col : rhs, ok);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // lhs: 8 rows x 4 words a warp
          const int r = c * 32 + pw * 8 + (lane >> 2);
          const int kw = st * kStageWords + (lane & 3);
          const bool ok = r0 + r < m && kw < wk;
          cp_async4(dst + kPackRhsBytes + (r * 4 + (lane & 3)) * 4,
                    ok ? lhs + static_cast<size_t>(r0 + r) * wk + kw : lhs,
                    ok);
        }
      }
    };
#pragma unroll
    for (int x = 0; x < kPackStages - 1; ++x) {
      if (x < steps) issue(x);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kPackStages - 2>();   // this thread's copies of step
      const uint32_t pk = s_pack + (step % kPackStages) * kPackBytes;
      uint32_t mine = 0u;                 // the lhs words it copied
      if (vec) {
        const uint4 a = ld_shared_v4(pk + kPackRhsBytes + t * 16);
        mine = a.x | a.y | a.z | a.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c * 32 + pw * 8 + (lane >> 2);
          mine |= ld_shared_u32(pk + kPackRhsBytes + (r * 4 + (lane & 3)) * 4);
        }
      }
      // a barrier too: every producer's copies of step are in, and every
      // producer is done with step - 1's pack stage, which the next
      // copies refill.  A stage whose 128 x 128 lhs bits are all 0 adds
      // nothing: its B tile is not unpacked, its products not issued.
      const bool any = any_in_producers(mine != 0u);
      if (step + kPackStages - 1 < steps) issue(step + kPackStages - 1);
      cp_async_commit();
      const int s = step % kStages;
      hopper::mbar_wait(bar_empty + 8 * s, ((step / kStages) & 1) ^ 1);
      if (any) {
        const uint4 a = ld_shared_v4(pk + kPackRhsBytes + t * 16);
        st_shared_v4(s_a + s * kATileBytes + t * 16, a.x, a.y, a.z, a.w);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = 8 * e + i;
          w[i] = ld_shared_u32(pk + (k * 8 + kPad * e + u) * 4);
        }
        unpack_rhs(w, s_b + s * kBTileBytes + u * 32 * 128, e);
      }
      if (t == 0) st_shared_u32(s_flag + 4 * s, any ? 1u : 0u);
      hopper::fence_async_smem();
      hopper::mbar_arrive(bar_full + 8 * s);
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int half = tid >> 7;                  // rows 64 half ..
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int lr = half * 64 + warp * 16 + g;   // local rows lr, lr + 8
    uint32_t acc[128];
    uint32_t afr[4][4];   // A of a stage: [k32 step][register]
    int step = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0u;
      int held = -1;   // the stage whose products may still be running
      for (int st = 0; st < n_stages; ++st, ++step) {
        const int s = step % kStages;
        hopper::mbar_wait(bar_full + 8 * s, (step / kStages) & 1);
        if (ld_shared_u32(s_flag + 4 * s) == 0u) {   // nothing to multiply
          if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * s);
          continue;
        }
        const uint4 x0 = ld_shared_v4(s_a + s * kATileBytes + lr * 16);
        const uint4 x1 = ld_shared_v4(s_a + s * kATileBytes + (lr + 8) * 16);
        // A is rebuilt only once no product reads it: ptxas serializes
        // the products when a register they read is written while a
        // group is in flight; the other warpgroup's group fills the gap
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (held >= 0 && lane == 0) hopper::mbar_arrive(bar_empty + 8 * held);
        const uint32_t r0w[4] = {x0.x, x0.y, x0.z, x0.w};
        const uint32_t r1w[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          afr[j][0] = nibble_bytes(r0w[j] >> (4 * q));
          afr[j][1] = nibble_bytes(r1w[j] >> (4 * q));
          afr[j][2] = nibble_bytes(r0w[j] >> (16 + 4 * q));
          afr[j][3] = nibble_bytes(r1w[j] >> (16 + 4 * q));
        }
        hopper::fence_regs(acc);
        hopper::fence_regs(afr);
        hopper::wgmma_fence();
        const uint64_t db =
            hopper::make_desc(s_b + s * kBTileBytes, 16, 1024, 1);
        hopper::wgmma_rs_u8_n256<0>(acc, afr[0], db, 1);
        hopper::wgmma_rs_u8_n256<32>(acc, afr[1], db, 1);
        hopper::wgmma_rs_u8_n256<64>(acc, afr[2], db, 1);
        hopper::wgmma_rs_u8_n256<96>(acc, afr[3], db, 1);
        hopper::wgmma_commit();
        held = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (held >= 0 && lane == 0) hopper::mbar_arrive(bar_empty + 8 * held);

      uint32_t word[2][8];
      acc_to_words(acc, q, word);
      const int col0 = w0 + tile * kTileWords;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + lr + 8 * i;
        if (row >= m) continue;
        const bool aff =
            kMode == Mode::kDelete ? row_affected(affected, row) : true;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = col0 + q + 4 * hi;
          if (col >= wn) continue;
          const size_t at = static_cast<size_t>(row) * wn + col;
          uint32_t v = pick4(word[i], q, hi);
          if constexpr (kMode != Mode::kProduct) {
            const uint32_t o = old[at];
            v = aff ? o | v : o;
          }
          out[at] = v;
        }
      }
    }
  }
}

// One CTA of the main launch: the block's path by its work entry.  old:
// null (kProduct), B2's closure (kFold) or the lhs (kDelete); affected:
// kDelete's row mask, else null.
template <Mode kMode>
__device__ __forceinline__ void product_block(
    const uint32_t* __restrict__ lhs, const uint32_t* __restrict__ rhs,
    const uint32_t* __restrict__ old, const uint32_t* __restrict__ affected,
    uint32_t* __restrict__ out, const int* __restrict__ work, int m, int wk,
    int wn) {
  // kSubBlocks CTAs a row block: a dense block is the first one's alone
  const int sub = blockIdx.x % kSubBlocks;
  if (is_dense(work[blockIdx.x / kSubBlocks], wk)) {
    if (sub == 0)
      dense_block<kMode>(lhs, rhs, old, affected, out, m, wk, wn);
  } else {
    sparse_block<kMode>(lhs, rhs, old, affected, out, m, wk, wn, sub);
  }
}

// Launches the main kernel on (ceil(m / 128), ceil(wn / 32)) CTAs; sets
// its shared-memory limit at the first launch of each instantiation.
template <typename Kernel, typename... Args>
inline int launch_main(Kernel kernel, bool* attr_set, int m, int wk, int wn,
                       cudaStream_t stream, Args... args) {
  if (!*attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    *attr_set = true;
  }
  const long long row_blocks = (m + kRows - 1) / kRows;
  // a list entry holds j < 2^24 (K = 32 * wk); the grid's y is < 2^16
  if (row_blocks * kSubBlocks > 0x7fffffff || wk > (1 << 19) ||
      (wn + kBlockWords - 1) / kBlockWords > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // row blocks fastest: the CTAs in flight share one column block, so the
  // rhs rows they read (or gather) stay in L2
  const dim3 grid(static_cast<unsigned>(row_blocks * kSubBlocks),
                  (wn + kBlockWords - 1) / kBlockWords);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned work_blocks(int m) {
  return static_cast<unsigned>((m + kRows - 1) / kRows);
}

}  // namespace bitgemm
}  // namespace repro_torch
