// B7 — GQA causal flash attention, forward, for Hopper (sm_90a).
//
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//   q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), g = Hq / Hkv; o like q.
//   Causal: query i sits at key position i + Tk - Tq (aligned to the END of
//   the key sequence) and sees keys j <= i + Tk - Tq.  Any Tq and Tk; d in
//   {16, 32, 64, 128}; bf16, f16 or f32, output in the input's type.
//
// Replaces the TPU kernel `flash_attention` of src/repro/kernels/flashattn.py:66
// (pl.pallas_call at :87).  That kernel walks a sequential grid
// (B*Hq, Tq/bq, Tk/bk), carries the running max, sum and accumulator in
// VMEM scratch from one key block to the next, computes every key block
// and masks, and needs Tq % bq == 0.  Here a work item is 128 query rows
// of one (b, hq) pair, and a loop walks its key tiles up to the causal
// limit: tiles wholly above the diagonal are never loaded.
//
// What bounds it on an H100 at the LM main path's shape (B=4, Hq=12,
// Hkv=2, T=2048, d=128, bf16, causal): the products need
// 2 * 2 * B * Hq * d * (causal pairs) = 2*2*4*12*128*2098176 = 5.2e10 flop,
// 0.052 ms at 989 TFLOP/s dense bf16; the bytes (q, k, v read once, o
// written once) are 59 MB, 0.018 ms at 3.35 TB/s.  So it is bound by
// operations, and only `wgmma` reaches the tensor cores' full rate.
//
// The bf16 / f16 design (flash_attention_kernel):
// - The grid is persistent, one block per SM (its shared memory leaves
//   room for no second), each walking its items.  Items are numbered
//   heaviest causal tile first and dealt in snake order (block i takes
//   the i-th item of even rounds and the (G-1-i)-th of odd ones), which
//   balances the SMs as well as a dynamic queue would; the next item's
//   loads start while the last one's rows are finished.
// - A block has three warpgroups: two consumers of 64 query rows each and
//   one producer.  The producer gives up registers (setmaxnreg 24) to the
//   consumers (240); one of its threads issues every copy.
// - Loads are TMA copies over rank-4 tensor maps of the strided
//   (B, H, T, d) views, built by the entry point from the 12 strides, so
//   transposed activations need no copy.  Q (128 x d) is loaded once an
//   item; K and V tiles of 128 keys go into a ring of two stages.  Q and
//   each stage of K and of V have a "full" and an "empty" mbarrier: the
//   copy's bytes complete the first, each consumer warp arrives on the
//   second when it is done with the tile, so a K stage (or the next
//   item's Q) refills while V of the same tile is still read.  A row of a
//   box spans one swizzle width (128 bytes; 64 or 32 at d = 32 or 16), so
//   d = 128 loads as two 64-column boxes.  TMA fills rows past Tq or Tk
//   with zeros.
// - S = Q K^T is `wgmma` m64n128k16 with both operands in shared memory
//   (K-major descriptors), float32 sums in registers.  The online softmax
//   runs in registers in base 2 (m, l, acc in float32).  P is rounded to
//   the input type in registers, where the accumulator layout of S is the
//   A-operand layout of O += P V, `wgmma` m64n{d}k16 with V read from
//   shared memory as an MN-major (transposed) B operand.  Each consumer
//   issues S of tile j+1 and then P.V of tile j, and runs the softmax of
//   tile j+1 while P.V is on the tensor cores (two commit groups in
//   flight); the two consumers' products interleave on the SM.
// - Only the diagonal tiles and the ragged last key tile are masked.
// - The output goes to each consumer's 64 rows of an O buffer in the
//   swizzled layout, then out by one TMA store per column block, which
//   skips rows past Tq and writes in q's strides; the store of one item
//   overlaps the next item's products.
//
// Masking: a masked score contributes exactly 0.  A query row that sees
// no key at all (only when causal and Tq > Tk) gets 0 — the l == 0 guard.
// (The Pallas kernel gives such a row the mean of v, because its finite
// NEG_INF makes exp(s - m) = 1 there; the reference's jnp version gives
// NaN.  Rows that see at least one key agree in all three.)
//
// float32 inputs (flash_attention_f32_kernel) serve the tests and the
// float32 parity run, not the main path: 64 query rows and 64-key tiles a
// block, four warps, products in plain float32 FMA (no TF32), tiles staged
// by cp.async.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------ bf16 / f16 kernel

constexpr int kBM = 128;           // query rows per work item
constexpr int kBN = 128;           // keys per K / V tile
constexpr int kStages = 2;         // K / V ring
constexpr int kConsumers = 2;      // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

struct Params {
  int hq, group, tq, tk, causal;
  int bh, n_qt, n_items;           // B * Hq, query tiles, work items
  float scale_log2;                // scale * log2(e): scores in base 2
};

template <int D>
struct Tile {
  // a box row spans one swizzle width: d = 128 is two column blocks
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kCols = kRowBytes / 2;
  static constexpr int kBlocks = D / kCols;
  static constexpr int kStepsPerBlock = kRowBytes / 32;  // k16 steps
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kKVBytes = kBN * D * 2;
  // shared memory from a 1024-aligned base: Q, O, K per stage, V per
  // stage, then the barriers (full and empty Q; full K, full V, empty K,
  // empty V per stage)
  static constexpr uint32_t kO = kQBytes;
  static constexpr uint32_t kK = kO + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  static constexpr size_t kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
};

// The byte address of a 16-bit element in a swizzled tile: the bits of
// the 16-byte chunk within a swizzle row ([4, 7) at 128 bytes, [4, 6) at
// 64, bit 4 at 32) are XORed with the row bits above bit 7, as TMA writes
// and wgmma reads them.
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t addr) {
  return addr ^ ((addr >> 3) & (Tile<D>::kSwizzleMask << 4));
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// What the softmax of one thread needs to know of its two rows.
struct Rows {
  int row0;        // this thread's rows: row0 and row0 + 8
  int w0;          // the warpgroup's first row
  int c4;          // this thread's column pair within each 8-key group
  int q_offset, tk, causal;
  float scale_log2;
};

// f(std::integral_constant<int, 0>()) .. f(<N - 1>): an unrolled loop
// whose index is a constant expression.
template <typename F, int... I>
__device__ __forceinline__ void static_for(F&& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>()), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>());
}

// sc = q . k^T for the warpgroup's 64 rows and 128 keys of the tile at
// s_k_tile (one commit group); s_qw is the warpgroup's rows of Q.  The
// steps move one descriptor each by immediates.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t s_qw,
                                         uint32_t s_k_tile) {
  using L = Tile<D>;
  const uint64_t da =
      hopper::make_desc(s_qw, 16, 8 * L::kRowBytes, L::kLayout);
  const uint64_t db =
      hopper::make_desc(s_k_tile, 16, 8 * L::kRowBytes, L::kLayout);
  static_for<D / 16>([&](auto step) {
    constexpr int kk = decltype(step)::value;
    constexpr int kBlk = kk / L::kStepsPerBlock;          // column block
    constexpr int kCol = (kk % L::kStepsPerBlock) * 32;   // bytes in it
    hopper::wgmma_ss_n128<T, kBlk * kBM * L::kRowBytes + kCol,
                          kBlk * kBN * L::kRowBytes + kCol>(sc, da, db,
                                                            kk > 0);
  });
  hopper::wgmma_commit();
}

// acc += p . v for the tile at s_v_tile (one commit group).
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t s_v_tile) {
  using L = Tile<D>;
  const uint64_t dv = hopper::make_desc(s_v_tile, kBN * L::kRowBytes,
                                        8 * L::kRowBytes, L::kLayout);
  static_for<kBN / 16>([&](auto step) {
    constexpr int kk = decltype(step)::value;
    hopper::wgmma_rs<T, kk * 16 * L::kRowBytes>(acc, pa[kk], dv, 1);
  });
  hopper::wgmma_commit();
}

// The online softmax of one tile of scores (keys k0 ..): base-2 scores,
// masked to -inf where a key is past Tk or, causal, past the row's limit
// (a tile wholly inside both needs no mask); the row max over the quad
// of threads sharing a row; sc becomes exp2(score - max), l this
// thread's part of the row sum, alpha the factor for the old acc.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Rows& r, int k0) {
  const bool need_mask =
      k0 + kBN > r.tk || (r.causal && k0 + kBN - 1 > r.w0 + r.q_offset);
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e] * r.scale_log2;
      if (need_mask) {
        const int key = k0 + 8 * n + 2 * r.c4 + (e & 1);
        const int row = r.row0 + 8 * (e >> 1);
        if (key >= r.tk || (r.causal && key > row + r.q_offset))
          x = -INFINITY;
      }
      sc[4 * n + e] = x;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * hh], sc[4 * n + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen no key yet keeps m = -inf: shift by 0 so the
    // masked exp2(-inf) is 0, not NaN
    const float shift = mx == -INFINITY ? 0.f : mx;
    alpha[hh] = fast_exp2(m[hh] - shift);
    m[hh] = mx;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      sc[4 * n + 2 * hh] = fast_exp2(sc[4 * n + 2 * hh] - shift);
      sc[4 * n + 2 * hh + 1] = fast_exp2(sc[4 * n + 2 * hh + 1] - shift);
      sum += sc[4 * n + 2 * hh] + sc[4 * n + 2 * hh + 1];
    }
    l[hh] = alpha[hh] * l[hh] + sum;
  }
}

// The accumulator layout of two neighbouring 8-key column groups is the
// A layout of one 16-key step: p never leaves registers.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One work item of the persistent grid: 128 query rows of one (b, hq)
// pair.  Items are numbered heaviest first (the last query tile of every
// pair, then the one before, ...).  Round r of the G blocks takes items
// rG .. rG + G - 1, block i the i-th of them in even rounds and the
// (G-1-i)-th in odd ones: the snake order balances decreasing weights as
// well as handing out each next item to the first block free would.
__device__ __forceinline__ int item_index(int round) {
  const int k = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return round * gridDim.x + k;
}

struct Item {
  int q0, b, h, n_tiles;
};

__device__ __forceinline__ Item item_of(const Params& p, int w) {
  Item it;
  const int bh = w % p.bh;
  it.q0 = (p.n_qt - 1 - w / p.bh) * kBM;
  it.b = bh / p.hq;
  it.h = bh % p.hq;
  const int q_rows = min(kBM, p.tq - it.q0);
  // keys these rows can see: [0, kend)
  const int kend =
      p.causal ? min(p.tk, it.q0 + q_rows + p.tk - p.tq) : p.tk;
  it.n_tiles = kend > 0 ? (kend + kBN - 1) / kBN : 0;
  return it;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const Params p) {
  using L = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_o = base + L::kO;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t bar_q = base + L::kBar;            // q loaded
  const uint32_t bar_eq = bar_q + 8;                // q free
  const uint32_t bar_k = bar_eq + 8;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_ek = bar_v + 8 * kStages;      // k stage free
  const uint32_t bar_ev = bar_ek + 8 * kStages;     // v stage free

  // the warpgroup, made warp-uniform by a shuffle so the compiler can see
  // that each role's branch (and its setmaxnreg) is taken by whole warps
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    hopper::mbar_init(bar_eq, kConsumers * 4);      // consumer warps
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_k + 8 * s, 1);
      hopper::mbar_init(bar_v + 8 * s, 1);
      hopper::mbar_init(bar_ek + 8 * s, kConsumers * 4);
      hopper::mbar_init(bar_ev + 8 * s, kConsumers * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Both roles walk the same items and count the same loads: nq items
  // with a key tile so far (the Q phase), nt key tiles so far (the ring
  // position).  The producer runs ahead into the next item as soon as
  // the consumers free Q and the ring's stages.
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      int nq = 0, nt = 0;
      for (int r = 0, w = item_index(0); w < p.n_items; w = item_index(++r)) {
        const Item it = item_of(p, w);
        if (it.n_tiles == 0) continue;
        const int hk = it.h / p.group;
        hopper::mbar_wait(bar_eq, (nq & 1) ^ 1);     // the last item's S done
        hopper::mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
        for (int c = 0; c < L::kBlocks; ++c)
          hopper::tma_load_4d(s_q + c * kBM * L::kRowBytes, &map_q, bar_q,
                              c * L::kCols, it.q0, it.h, it.b);
        ++nq;
        for (int j = 0; j < it.n_tiles; ++j, ++nt) {
          const int s = nt % kStages;
          const uint32_t phase = (nt / kStages) & 1;
          hopper::mbar_wait(bar_ek + 8 * s, phase ^ 1);  // the stage is free
          hopper::mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
          for (int c = 0; c < L::kBlocks; ++c)
            hopper::tma_load_4d(
                s_k + s * L::kKVBytes + c * kBN * L::kRowBytes, &map_k,
                bar_k + 8 * s, c * L::kCols, j * kBN, hk, it.b);
          hopper::mbar_wait(bar_ev + 8 * s, phase ^ 1);
          hopper::mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
          for (int c = 0; c < L::kBlocks; ++c)
            hopper::tma_load_4d(
                s_v + s * L::kKVBytes + c * kBN * L::kRowBytes, &map_v,
                bar_v + 8 * s, c * L::kCols, j * kBN, hk, it.b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int c4 = lane % 4;
    const uint32_t s_qw = s_q + wg * 64 * L::kRowBytes;   // this warpgroup's
    const uint32_t s_ow = s_o + wg * 64 * L::kRowBytes;   // rows of Q and O
    int nq = 0, nt = 0;
    for (int r = 0, w = item_index(0); w < p.n_items; w = item_index(++r)) {
      const Item it = item_of(p, w);
      const int w0 = it.q0 + wg * 64;               // this warpgroup's rows
      const int row0 = w0 + warp * 16 + g;          // this thread's: row0, +8
      const Rows rows{row0, w0, c4, p.tk - p.tq, p.tk, p.causal,
                      p.scale_log2};
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      // S of tile j+1 runs on the tensor cores while P.V of tile j is
      // issued behind it, and the softmax of tile j+1 runs while that P.V
      // does.  sc holds nothing before a product's first step (scale_d 0
      // overwrites it).
      if (it.n_tiles > 0) {
        uint32_t pa[kBN / 16][4];   // p of the tile whose P.V is next
        float sc[kBN / 2];
        float alpha[2];
        const int last = it.n_tiles - 1;
        hopper::mbar_wait(bar_q, nq & 1);
        hopper::mbar_wait(bar_k + 8 * (nt % kStages), (nt / kStages) & 1);
        hopper::wgmma_fence();
        issue_qk<T, D>(sc, s_qw, s_k + (nt % kStages) * L::kKVBytes);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (lane == 0) {
          hopper::mbar_arrive(bar_ek + 8 * (nt % kStages));
          if (last == 0) hopper::mbar_arrive(bar_eq);
        }
        softmax_tile(sc, m, l, alpha, rows, 0);      // acc is still 0
        pack_p<T>(sc, pa);
        for (int j = 1; j <= last; ++j) {
          const int cur = nt + j, prev = cur - 1;
          const int s = cur % kStages, sp = prev % kStages;
          hopper::mbar_wait(bar_k + 8 * s, (cur / kStages) & 1);
          hopper::fence_regs(acc);   // the rescale and the packing of p
          hopper::fence_regs(pa);    // land before the fence
          hopper::wgmma_fence();
          issue_qk<T, D>(sc, s_qw, s_k + s * L::kKVBytes);
          hopper::mbar_wait(bar_v + 8 * sp, (prev / kStages) & 1);
          issue_pv<T, D>(acc, pa, s_v + sp * L::kKVBytes);
          hopper::wgmma_wait<1>();                       // S of tile j
          hopper::fence_regs(sc);
          if (lane == 0) {
            hopper::mbar_arrive(bar_ek + 8 * s);
            if (j == last) hopper::mbar_arrive(bar_eq);   // Q is free
          }
          softmax_tile(sc, m, l, alpha, rows, j * kBN);
          hopper::wgmma_wait<0>();                       // P.V of tile j-1
          hopper::fence_regs(acc);
          if (lane == 0) hopper::mbar_arrive(bar_ev + 8 * sp);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            acc[4 * n] *= alpha[0];
            acc[4 * n + 1] *= alpha[0];
            acc[4 * n + 2] *= alpha[1];
            acc[4 * n + 3] *= alpha[1];
          }
          pack_p<T>(sc, pa);
        }
        const int lt = nt + last, sl = lt % kStages;
        hopper::mbar_wait(bar_v + 8 * sl, (lt / kStages) & 1);
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        hopper::wgmma_fence();
        issue_pv<T, D>(acc, pa, s_v + sl * L::kKVBytes);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (lane == 0) hopper::mbar_arrive(bar_ev + 8 * sl);
        ++nq;
        nt += it.n_tiles;
      }

      // o = acc / l, with the row sum gathered over the quad; l == 0 (a
      // row that saw no key) writes 0.  This warpgroup's rows of the O
      // buffer take o in the swizzled layout the output map reads, once
      // the store of the last item has read them.
      if (tid == 0) hopper::tma_store_wait();
      hopper::named_barrier(1 + wg, 128);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sum = l[hh];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = sum == 0.f ? 0.f : 1.f / sum;
        const int r = warp * 16 + g + 8 * hh;        // row within the 64
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int col = 8 * n + 2 * c4;
          const uint32_t addr = s_ow + (col / L::kCols) * kBM * L::kRowBytes +
                                r * L::kRowBytes + (col % L::kCols) * 2;
          const uint32_t val = pack2<T>(acc[4 * n + 2 * hh] * inv,
                                        acc[4 * n + 2 * hh + 1] * inv);
          asm volatile("st.shared.u32 [%0], %1;\n"
                       :: "r"(swizzle<D>(addr)), "r"(val) : "memory");
        }
      }
      hopper::fence_async_smem();
      hopper::named_barrier(1 + wg, 128);
      if (tid == 0 && w0 < p.tq) {
#pragma unroll
        for (int c = 0; c < L::kBlocks; ++c)
          hopper::tma_store_4d(&map_o, s_ow + c * kBM * L::kRowBytes,
                               c * L::kCols, w0, it.h, it.b);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------- float32 kernel

constexpr int kF32BQ = 64;         // query rows per block, 16 per warp
constexpr int kF32BK = 64;         // keys per tile
constexpr int kF32Threads = 128;

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  // strides in elements; the last (d) dimension is contiguous
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  int hq, group, tq, tk, causal;
  float scale_log2;
};

template <int D>
struct F32Smem {
  // row-major tiles, row strides padded so one warp's reads hit distinct
  // banks
  static constexpr int kLd = D + 4;
  static constexpr int kLdP = kF32BK + 4;
  static constexpr int kQ = kF32BQ * kLd;
  static constexpr int kKV = kF32BK * kLd;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)kQ + 2 * kKV + (size_t)4 * 16 * kLdP);
};

// Start copying a tile of kRows rows of D floats (row r at src + r *
// stride) into shared memory at dst with row stride ld: asynchronous
// 16-byte copies (cp.async), one commit group per call.  Rows at or past
// `valid` are zero-filled (a source size of 0 reads nothing); with valid
// <= 0 nothing is copied and the group is empty.
template <int D, int kRows>
__device__ __forceinline__ void stage_async(float* dst, int ld,
                                            const float* src,
                                            long long stride, int valid) {
  constexpr int kPerRow = D / 4;
  const int n = valid > 0 ? kRows * kPerRow : 0;
  for (int i = threadIdx.x; i < n; i += kF32Threads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    const float* from = r < valid ? src + r * stride + c : src;
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(r < valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `n` of this thread's cp.async groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const F32Params p) {
  using S = F32Smem<D>;
  constexpr int kNT = kF32BK / 8;    // score column groups of 8 keys
  constexpr int kDT = D / 8;         // output column groups of 8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + S::kQ;
  float* sV = sK + S::kKV;
  float* sP = sV + S::kKV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int w16 = warp * 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kF32BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int q_offset = p.tk - p.tq;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_st;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;
  float* og = p.o + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_st;

  const int q_rows = min(kF32BQ, p.tq - q0);
  // keys this tile of rows can see: [0, kend)
  const int kend = p.causal ? min(p.tk, q0 + q_rows + q_offset) : p.tk;
  const int n_tiles = kend > 0 ? (kend + kF32BK - 1) / kF32BK : 0;

  // three copies in flight: q, then the first tile's k and v (empty
  // groups when there is no tile, so the group count stays uniform)
  const int first_rows = n_tiles ? min(kF32BK, p.tk) : 0;
  stage_async<D, kF32BQ>(sQ, S::kLd, qg, p.q_st, q_rows);
  stage_async<D, kF32BK>(sK, S::kLd, kg, p.k_st, first_rows);
  stage_async<D, kF32BK>(sV, S::kLd, vg, p.v_st, first_rows);
  cp_async_wait<2>();
  __syncthreads();

  // this thread's two rows, global query index
  const int row[2] = {q0 + w16 + g, q0 + w16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // The k tile of step it+1 loads while step it multiplies p by v, and
  // the v tile of step it+1 while step it+1 computes its scores.
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kF32BK;
    const int next = k0 + kF32BK;
    const int next_rows = it + 1 < n_tiles ? min(kF32BK, p.tk - next) : 0;
    cp_async_wait<1>();   // this tile's k (its v may still be in flight)
    __syncthreads();

    // scores s = q . k for this warp's 16 rows and the tile's 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const float* qa = sQ + (w16 + g) * S::kLd;
    const float* qb = qa + 8 * S::kLd;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float x0 = qa[d], x1 = qb[d];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kv = sK[(j * 8 + 2 * c4 + e) * S::kLd + d];
          s[j][e] = fmaf(x0, kv, s[j][e]);
          s[j][2 + e] = fmaf(x1, kv, s[j][2 + e]);
        }
      }
    }

    __syncthreads();   // every warp is done with this k tile
    stage_async<D, kF32BK>(sK, S::kLd, kg + (long long)next * p.k_st, p.k_st,
                           next_rows);

    // base-2 scores, masked to -inf where a key is past Tk or, causal,
    // past the row's limit; a tile wholly inside both needs no mask
    const bool need_mask = k0 + kF32BK > p.tk ||
                           (p.causal && k0 + kF32BK - 1 > q0 + q_offset);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (need_mask) {
          const int key = k0 + j * 8 + 2 * c4 + (e & 1);
          const int r = row[e >> 1];
          if (key >= p.tk || (p.causal && key > r + q_offset)) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax: the row max over the quad of threads sharing a row
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[hh] - base);
      m[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][2 * hh] = exp2f(s[j][2 * hh] - base);
        s[j][2 * hh + 1] = exp2f(s[j][2 * hh + 1] - base);
        sum += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l[hh] = alpha * l[hh] + sum;   // this thread's part of the row sum
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // acc += p . v, once this tile's v has landed
    cp_async_wait<1>();
    __syncthreads();
    float* pw = sP + warp * 16 * S::kLdP;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pw[g * S::kLdP + j * 8 + 2 * c4 + e] = s[j][e];
        pw[(g + 8) * S::kLdP + j * 8 + 2 * c4 + e] = s[j][2 + e];
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < kF32BK; ++key) {
      const float p0 = pw[g * S::kLdP + key];
      const float p1 = pw[(g + 8) * S::kLdP + key];
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vv = sV[key * S::kLd + n * 8 + 2 * c4 + e];
          acc[n][e] = fmaf(p0, vv, acc[n][e]);
          acc[n][2 + e] = fmaf(p1, vv, acc[n][2 + e]);
        }
      }
    }
    __syncwarp();
    __syncthreads();   // every warp is done with this v tile
    stage_async<D, kF32BK>(sV, S::kLd, vg + (long long)next * p.v_st, p.v_st,
                           next_rows);
  }
  cp_async_wait<0>();   // the last (empty) groups: nothing left in flight

  // o = acc / l, with the row sum gathered over the quad; l == 0 (a row
  // that saw no key) writes 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    const int r = w16 + g + 8 * hh;       // row within the tile
    if (r >= q_rows) continue;
    float* orow = og + (long long)r * p.o_st;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + 2 * c4;
      *reinterpret_cast<float2*>(orow + c) =
          make_float2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ host

constexpr int kEncodeError = 10000;   // + the driver's CUresult

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the
// library does not link libcuda); null if the driver does not have it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-4 map over the strided (B, H, T, d) view at `ptr` (element
// strides sbht of batch, head, position; d contiguous) with a box of
// `cols` elements of d by `rows` positions of one head.  Returns 0 or
// kEncodeError + the driver's error.
int encode_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
               const void* ptr, int b, int h, int t, int d,
               const long long* sbht, int cols, int rows,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h,
                              (cuuint64_t)b};
  // bytes; the stride of a dimension of size 1 is never used, so one the
  // copy engine takes (nonzero, 16-byte aligned) stands in for it
  cuuint64_t strides[3];
  const long long sizes[3] = {t, h, b};
  const long long elem[3] = {sbht[2], sbht[1], sbht[0]};
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] == 1 ? (cuuint64_t)d * 2 : (cuuint64_t)elem[i] * 2;
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <typename T, int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  int b, int hq, int hkv, int tq, int tk,
                  const long long* strides, const Params& p,
                  cudaStream_t stream) {
  using L = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError;
  const CUtensorMapDataType type =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mq, mk, mv, mo;
  int e = encode_map(&mq, encode, type, q, b, hq, tq, D, strides, L::kCols,
                     kBM, swizzle);
  if (e == 0) e = encode_map(&mo, encode, type, o, b, hq, tq, D, strides + 9,
                             L::kCols, 64, swizzle);
  if (e == 0 && tk > 0) {
    e = encode_map(&mk, encode, type, k, b, hkv, tk, D, strides + 3,
                   L::kCols, kBN, swizzle);
    if (e == 0) e = encode_map(&mv, encode, type, v, b, hkv, tk, D,
                               strides + 6, L::kCols, kBN, swizzle);
  } else {
    mk = mv = mq;   // no key: no tile is ever loaded
  }
  if (e != 0) return e;
  auto kernel = flash_attention_kernel<T, D>;
  static bool attr_set = false;   // once per instantiation and process
  if (!attr_set) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (a != cudaSuccess) return static_cast<int>(a);
    attr_set = true;
  }
  // a persistent grid: one block per SM (its shared memory allows no
  // second), each walking its share of the items
  int dev = 0, sms = 0;
  cudaError_t a = cudaGetDevice(&dev);
  if (a == cudaSuccess)
    a = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (a != cudaSuccess) return static_cast<int>(a);
  Params run = p;
  run.bh = b * hq;
  run.n_qt = (tq + kBM - 1) / kBM;
  run.n_items = run.bh * run.n_qt;
  const int grid = run.n_items < sms ? run.n_items : sms;
  kernel<<<grid, kThreads, L::kBytes, stream>>>(mq, mk, mv, mo, run);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const F32Params& p, int b, int tq, cudaStream_t stream) {
  using S = F32Smem<D>;
  auto kernel = flash_attention_f32_kernel<D>;
  static bool attr_set = false;   // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((tq + kF32BQ - 1) / kF32BQ, b * p.hq);
  kernel<<<grid, kF32Threads, S::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int tq, int tk, int d,
             const long long* strides, const Params& p, cudaStream_t s) {
  switch (d) {
    case 16: return launch_hopper<T, 16>(q, k, v, o, b, hq, hkv, tq, tk,
                                         strides, p, s);
    case 32: return launch_hopper<T, 32>(q, k, v, o, b, hq, hkv, tq, tk,
                                         strides, p, s);
    case 64: return launch_hopper<T, 64>(q, k, v, o, b, hq, hkv, tq, tk,
                                         strides, p, s);
    case 128: return launch_hopper<T, 128>(q, k, v, o, b, hq, hkv, tq, tk,
                                           strides, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_f32_d(const F32Params& p, int b, int tq, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_f32<16>(p, b, tq, s);
    case 32: return launch_f32<32>(p, b, tq, s);
    case 64: return launch_f32<64>(p, b, tq, s);
    case 128: return launch_f32<128>(p, b, tq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  strides: 12 element strides,
// (batch, head, position) of q, k, v, o in that order.  Returns the CUDA
// error of the launch (0 on success), or 10000 + the driver's CUresult
// when a tensor map cannot be encoded.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int hq,
                                     int hkv, int tq, int tk, int d, int dtype,
                                     int causal, float scale,
                                     const long long* strides, void* stream) {
  if (b <= 0 || hq <= 0 || tq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    F32Params p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.o = static_cast<float*>(o);
    p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
    p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
    p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
    p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
    p.hq = hq;
    p.group = hq / hkv;
    p.tq = tq;
    p.tk = tk;
    p.causal = causal;
    p.scale_log2 = scale * kLog2e;
    return launch_f32_d(p, b, tq, d, s);
  }
  Params p;
  p.hq = hq;
  p.group = hq / hkv;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  switch (dtype) {
    case 1: return launch_d<__half>(q, k, v, o, b, hq, hkv, tq, tk, d,
                                    strides, p, s);
    case 2: return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, tq, tk, d,
                                           strides, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
