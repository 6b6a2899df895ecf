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
// and masks, and needs Tq % bq == 0.  Here one block owns one (b, hq) pair
// and 64 query rows, and a loop inside the block walks the 64-key tiles up
// to the causal limit: tiles wholly above the diagonal are never loaded.
// The running max, sum and the output accumulator live in registers, in
// float32.  The ragged last query and key tiles are masked in the kernel
// (zero-filled in shared memory, masked in the scores), so no length has
// to be a multiple of a tile.
//
// Masking: a masked score contributes exactly 0.  A query row that sees
// no key at all (only when causal and Tq > Tk) gets 0 — the l == 0 guard.
// (The Pallas kernel gives such a row the mean of v, because its finite
// NEG_INF makes exp(s - m) = 1 there; the reference's jnp version gives
// NaN.  Rows that see at least one key agree in all three.)
//
// What bounds it on an H100 at the LM main path's shape (B=4, Hq=12,
// Hkv=2, T=2048, d=128, bf16, causal): the products need
// 2 * 2 * B * Hq * d * (causal pairs) = 2*2*4*12*128*2098176 = 5.2e10 flop,
// 0.052 ms at 989 TFLOP/s dense bf16; the bytes (q, k, v read once, o
// written once) are 59 MB, 0.018 ms at 3.35 TB/s.  So it is bound by
// operations.  What the design does about that: the products run on the
// tensor cores with `mma.sync` m16n8k16 (bf16 or f16 in, f32 out); the
// scores stay in registers and become the A operand of the P.V product
// without a trip through shared memory; K and V tiles are staged in
// shared memory once per block and read by all four warps, V's B
// fragments by `ldmatrix.trans` from its row-major tile; the copies are
// asynchronous (`cp.async`), so the next K tile loads while P.V runs and
// the next V tile while the scores run; causal blocks skip the tiles
// above the diagonal (half the work at Tq = Tk), and the grid starts
// with the heaviest query tiles.  Not done here, and later work: `wgmma`
// on 64-row warpgroup tiles, TMA loads into a ring of stages with
// mbarriers, and warp specialisation.  float32 inputs run the same
// tiling with the products in plain float32 FMA (no TF32), for the tests
// and the float32 parity run; they are not on the bf16 main path.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;              // query rows per block, 16 per warp
constexpr int kBK = 64;              // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements; the last (d) dimension is contiguous
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  int hq, group, tq, tk, causal;
  float scale_log2;                  // scale * log2(e): scores in base 2
};

template <typename T>
struct Layout {
  // q, k and v tiles are row-major in shared memory, in T.  Row strides
  // are padded so the fragment reads of one warp (and the 8 row
  // addresses of one ldmatrix) hit distinct banks.
  static constexpr bool kMma = !std::is_same<T, float>::value;
};

template <typename T, int D>
struct Smem {
  static constexpr int kLd = Layout<T>::kMma ? D + 8 : D + 4;  // elements
  static constexpr int kLdP = kBK + 4;                         // f32 path
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKV = kBK * kLd;
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kQ + 2 * kKV) +
      (Layout<T>::kMma ? 0 : sizeof(float) * (size_t)kWarps * 16 * kLdP);
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
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

// c (16x8, f32) += a (16x16, row) * b (16x8, col): the m16n8k16 tile.
// Thread t of the warp, with g = t / 4 and c4 = t % 4, holds
//   a: {(g, 2c4..+1), (g+8, 2c4..+1), (g, 2c4+8..+9), (g+8, 2c4+8..+9)}
//   b: {(k 2c4..+1, n g), (k 2c4+8..+9, n g)}
//   c: {(g, 2c4), (g, 2c4+1), (g+8, 2c4), (g+8, 2c4+1)}
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Start copying a tile of kRows rows of D elements (row r at
// src + r * stride) into shared memory at dst with row stride ld:
// asynchronous 16-byte copies (cp.async), one commit group per call.
// Rows at or past `valid` are zero-filled (a source size of 0 reads
// nothing); with valid <= 0 nothing is copied and the group is empty.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage_async(T* dst, int ld, const T* src,
                                            long long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  const int n = valid > 0 ? kRows * kPerRow : 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const T* from = r < valid ? src + r * stride + c : src;
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

// Four transposed 8x8 b16 matrices from shared memory; lane t gives the
// address of row t % 8 of matrix t / 8 and receives, of matrix i, the
// elements (rows 2 (t % 4), 2 (t % 4) + 1; column t / 4) in r[i]: the B
// fragment of an m16n8k16 product whose B is stored k-major.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  using S = Smem<T, D>;
  constexpr bool kMma = Layout<T>::kMma;
  constexpr int kNT = kBK / 8;       // score n-tiles of 8 keys per tile
  constexpr int kDT = D / 8;         // output n-tiles of 8 columns

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + S::kQ;
  T* sV = sK + S::kKV;
  float* sP = reinterpret_cast<float*>(sV + S::kKV);  // float32 path only

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int w16 = warp * 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int q_offset = p.tk - p.tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                (long long)q0 * p.q_st;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
          (long long)q0 * p.o_st;

  const int q_rows = min(kBQ, p.tq - q0);
  // keys this tile of rows can see: [0, kend)
  const int kend = p.causal ? min(p.tk, q0 + q_rows + q_offset) : p.tk;
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  // three copies in flight: q, then the first tile's k and v (empty
  // groups when there is no tile, so the group count stays uniform)
  const int first_rows = n_tiles ? min(kBK, p.tk) : 0;
  stage_async<T, D, kBQ>(sQ, S::kLd, qg, p.q_st, q_rows);
  stage_async<T, D, kBK>(sK, S::kLd, kg, p.k_st, first_rows);
  stage_async<T, D, kBK>(sV, S::kLd, vg, p.v_st, first_rows);
  cp_async_wait<2>();
  __syncthreads();

  // the query A fragments stay in registers for the whole key loop
  uint32_t qf[kMma ? D / 16 : 1][4];
  if constexpr (kMma) {
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const T* r0 = sQ + (w16 + g) * S::kLd + kt * 16 + 2 * c4;
      const T* r1 = r0 + 8 * S::kLd;
      qf[kt][0] = ld32(r0);
      qf[kt][1] = ld32(r1);
      qf[kt][2] = ld32(r0 + 8);
      qf[kt][3] = ld32(r1 + 8);
    }
  }

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
    const int k0 = it * kBK;
    const int next = k0 + kBK;
    const int next_rows = it + 1 < n_tiles ? min(kBK, p.tk - next) : 0;
    cp_async_wait<1>();   // this tile's k (its v may still be in flight)
    __syncthreads();

    // scores s = q . k for this warp's 16 rows and the tile's 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int kt = 0; kt < D / 16; ++kt) {
          const T* kr = sK + (j * 8 + g) * S::kLd + kt * 16 + 2 * c4;
          mma16816<T>(s[j], qf[kt], ld32(kr), ld32(kr + 8));
        }
      }
    } else {
      const float* qa = reinterpret_cast<const float*>(sQ) +
                        (w16 + g) * S::kLd;
      const float* qb = qa + 8 * S::kLd;
      const float* kb = reinterpret_cast<const float*>(sK);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float x0 = qa[d], x1 = qb[d];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kv = kb[(j * 8 + 2 * c4 + e) * S::kLd + d];
            s[j][e] = fmaf(x0, kv, s[j][e]);
            s[j][2 + e] = fmaf(x1, kv, s[j][2 + e]);
          }
        }
      }
    }

    __syncthreads();   // every warp is done with this k tile
    stage_async<T, D, kBK>(sK, S::kLd, kg + (long long)next * p.k_st, p.k_st,
                           next_rows);

    // base-2 scores, masked to -inf where a key is past Tk or, causal,
    // past the row's limit; a tile wholly inside both needs no mask
    const bool need_mask = k0 + kBK > p.tk ||
                           (p.causal && k0 + kBK - 1 > q0 + q_offset);
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
      // a row that has seen no key yet keeps m = -inf: shift by 0 so the
      // masked exp2(-inf) is 0, not NaN
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
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // the C layout of two neighbouring score tiles is the A layout of
        // one 16-key step: the probabilities never leave registers
        const uint32_t a[4] = {
            pack2<T>(s[2 * kk][0], s[2 * kk][1]),
            pack2<T>(s[2 * kk][2], s[2 * kk][3]),
            pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // lane t points at key kk*16 + 8 (t/8 % 2) + t%8, columns
        // (n + t/16) * 8: the B fragments of output tiles n and n+1
        const T* vrow = sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 S::kLd + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < kDT; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + n * 8);
          mma16816<T>(acc[n], a, b[0], b[1]);
          mma16816<T>(acc[n + 1], a, b[2], b[3]);
        }
      }
    } else {
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
      const float* vb = reinterpret_cast<const float*>(sV);
#pragma unroll 4
      for (int key = 0; key < kBK; ++key) {
        const float p0 = pw[g * S::kLdP + key];
        const float p1 = pw[(g + 8) * S::kLdP + key];
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vv = vb[key * S::kLd + n * 8 + 2 * c4 + e];
            acc[n][e] = fmaf(p0, vv, acc[n][e]);
            acc[n][2 + e] = fmaf(p1, vv, acc[n][2 + e]);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();   // every warp is done with this v tile
    stage_async<T, D, kBK>(sV, S::kLd, vg + (long long)next * p.v_st, p.v_st,
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
    T* orow = og + (long long)r * p.o_st;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const float lo = acc[n][2 * hh] * inv, hi = acc[n][2 * hh + 1] * inv;
      const int c = n * 8 + 2 * c4;
      if constexpr (kMma) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack2<T>(lo, hi);
      } else {
        *reinterpret_cast<float2*>(orow + c) = make_float2(lo, hi);
      }
    }
  }
}

template <typename T, int D>
int launch_typed(const Params& p, int b, int tq, cudaStream_t stream) {
  using S = Smem<T, D>;
  auto kernel = flash_attention_kernel<T, D>;
  static bool attr_set = false;   // once per instantiation and process
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((tq + kBQ - 1) / kBQ, b * p.hq);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int b, int tq, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_typed<T, 16>(p, b, tq, stream);
    case 32: return launch_typed<T, 32>(p, b, tq, stream);
    case 64: return launch_typed<T, 64>(p, b, tq, stream);
    case 128: return launch_typed<T, 128>(p, b, tq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  strides: 12 element strides,
// (batch, head, position) of q, k, v, o in that order.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int hq,
                                     int hkv, int tq, int tk, int d, int dtype,
                                     int causal, float scale,
                                     const long long* strides, void* stream) {
  if (b <= 0 || hq <= 0 || tq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(p, b, tq, d, s);
    case 1: return launch_d<__half>(p, b, tq, d, s);
    case 2: return launch_d<__nv_bfloat16>(p, b, tq, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
