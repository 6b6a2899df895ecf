// B6 — weighted embedding bag for Hopper (sm_90a).
//
//   out[b, :] = sum_k w[b, k] * table[idx[b, k], :]
//   table (R, D) float32 or bfloat16; idx (B, K) int32; w (B, K) float32,
//   0 for padding; out (B, D) in the table's type.  Each product w * t is
//   rounded to float32 and added to a float32 sum; the sum is rounded to
//   the table's type (bfloat16: to nearest even).  Any B >= 0, K >= 1,
//   D >= 1; indices in [0, R) are the caller's contract.
//
// Replaces the TPU kernel `embbag` of src/repro/kernels/embbag.py:48
// (pl.pallas_call at :69).  That kernel scalar-prefetches idx into SMEM,
// keeps the table in HBM and, for each (bag, k), DMAs one table row into
// a VMEM line, waits, and adds it to the bag's on-chip sum: one row in
// flight at a time.  Here no row is staged, nothing of shape (B, K, D) is
// written, and row offsets are 64-bit (R * D passes 2^31 at other
// widths: 33M rows x 64).  Two paths, by the width of a table row:
//
// * A row of one chunk (D * element size <= 16 bytes: D <= 4 in float32,
//   <= 8 in bfloat16; the xDeepFM linear term has D = 1, K = 39, B = 512):
//   the k loop splits across a group of G lanes a bag, G the smallest
//   power of two >= min(K, 32).  Lane l reads idx and w at k = l, l + G,
//   ... straight from device memory (coalesced along k), issues all of
//   its row gathers (one 16-byte load, or D scalar loads) before it uses
//   the first, and sums its own products in ascending k; the group then
//   adds across lanes by a fixed xor-shuffle tree, so a result is the
//   same from run to run, and its first lane rounds and stores the row.
//   No shared memory, no barrier; B * G threads, 256 a block, so 512 bags
//   are 512 warps on 64 SMs.  Bound by two dependent rounds of loads, idx
//   and w then the rows, about one HBM latency each: the bytes (~0.24 MB
//   at xDeepFM's shape, ~0.07 us at 3.35 TB/s) are not the limit.
// * Wider rows (kernel_bench's D = 64, K = 4, B = 4096): each thread owns
//   one bag and one chunk of VEC consecutive columns and reads its K rows
//   straight from device memory into float32 registers, in ascending k:
//   16-byte loads (4 floats or 8 bfloat16) when D is a multiple of VEC
//   and the table and output are 16-byte aligned, scalar loads otherwise;
//   the unrolled k loop keeps several rows in flight.  The block's bags'
//   idx and w are staged in shared memory, kTileK entries of each bag at a
//   time, read from device memory once per block (when D needs more than
//   kThreads chunks, the block walks the chunks in rounds and reads them
//   once per round).  Bound by bytes: ~4.2 MB of rows, ~5.4 MB with idx,
//   w and out at kernel_bench's shape, ~1.6 us; every gathered byte is
//   read once, in 16-byte loads where the row allows, and small batches
//   get smaller blocks, so the grid spreads over the SMs.
//
// Either path sums a bag's K float32 products in float32, in its own
// order; two orders differ by at most K 2^-23 sum_k |w_k t_k| (and one
// bfloat16 ulp of the output), the bound the tests hold it to.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;        // most threads of a block
constexpr int kMinThreads = 32;      // fewest: one warp
constexpr int kTileK = 16;           // idx and w entries of a bag staged at once
constexpr int kPitch = kTileK + 1;   // odd: one bag per thread reads distinct banks
constexpr int kSMs = 132;            // H100 SXM
constexpr int kRowBytes = 16;        // the split path's widest row: one chunk
constexpr int kSplitRun = 8;         // row gathers a lane issues at once

// The float32 value of bfloat16 bits (exact).
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// float32 -> bfloat16 bits, rounded to nearest even (NaN stays a NaN), as
// torch's float32 -> bfloat16 conversion.
__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// VEC consecutive values at p as float32.  VEC * element size is 16 bytes
// (p 16-byte aligned) or VEC is 1.
template <bool BF16, int VEC>
__device__ __forceinline__ void load_chunk(const void* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = BF16 ? bf16_bits_to_f32(*static_cast<const uint16_t*>(p))
                : *static_cast<const float*>(p);
  } else {
    const uint4 raw = __ldg(static_cast<const uint4*>(p));
    const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (BF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // little-endian: element 2j is low
        v[2 * j] = bf16_bits_to_f32(word[j] & 0xffffu);
        v[2 * j + 1] = __uint_as_float(word[j] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(word[j]);
    }
  }
}

template <bool BF16, int VEC>
__device__ __forceinline__ void store_chunk(void* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (BF16) {
      *static_cast<uint16_t*>(p) = static_cast<uint16_t>(f32_to_bf16_bits(v[0]));
    } else {
      *static_cast<float*>(p) = v[0];
    }
  } else {
    uint32_t word[4];
    if constexpr (BF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word[j] = f32_to_bf16_bits(v[2 * j]) |
                  (f32_to_bf16_bits(v[2 * j + 1]) << 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) word[j] = __float_as_uint(v[j]);
    }
    *static_cast<uint4*>(p) = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// Block: bpb = blockDim.x / tpb bags, tpb threads a bag (a power of two);
// thread t owns bag t / tpb and chunks t % tpb, t % tpb + tpb, ... of it.
// Dynamic shared memory: idx then w, each [bpb][kPitch].
template <bool BF16, int VEC>
__global__ void __launch_bounds__(kThreads)
embbag_kernel(const void* __restrict__ table, const int32_t* __restrict__ idx,
              const float* __restrict__ w, void* __restrict__ out, int b,
              int k, int d, int tpb) {
  using E = typename std::conditional<BF16, uint16_t, float>::type;
  extern __shared__ int smem[];
  const int bpb = blockDim.x / tpb;
  int* sidx = smem;
  float* sw = reinterpret_cast<float*>(smem + bpb * kPitch);
  const int lb = threadIdx.x / tpb;
  const int lane = threadIdx.x % tpb;
  const long long bag0 = static_cast<long long>(blockIdx.x) * bpb;
  const long long bag = bag0 + lb;
  const int chunks = d / VEC;   // d % VEC == 0 (the entry point's choice)
  const E* tab = static_cast<const E*>(table);
  for (int c0 = 0; c0 < chunks; c0 += tpb) {   // the same rounds in every thread
    const int c = c0 + lane;
    const bool active = bag < b && c < chunks;
    const E* col = tab + static_cast<size_t>(c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kTileK) {
      __syncthreads();   // the previous tile's readers are done with it
      for (int i = threadIdx.x; i < bpb * kTileK; i += blockDim.x) {
        const int ib = i / kTileK;
        const int ik = i % kTileK;
        const bool in = bag0 + ib < b && k0 + ik < k;
        const size_t at = static_cast<size_t>(bag0 + ib) * k + (k0 + ik);
        sidx[ib * kPitch + ik] = in ? idx[at] : 0;
        sw[ib * kPitch + ik] = in ? w[at] : 0.0f;
      }
      __syncthreads();
      if (active) {
        const int nk = min(kTileK, k - k0);
        const int* ri = sidx + lb * kPitch;
        const float* rw = sw + lb * kPitch;
#pragma unroll 4
        for (int kk = 0; kk < nk; ++kk) {
          float v[VEC];
          load_chunk<BF16, VEC>(col + static_cast<size_t>(ri[kk]) * d, v);
          const float wk = rw[kk];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wk));
        }
      }
    }
    if (active)
      store_chunk<BF16, VEC>(static_cast<E*>(out) + static_cast<size_t>(bag) * d
                                 + static_cast<size_t>(c) * VEC, acc);
  }
}

// The split path: bag t / G of the grid, its k loop on the G lanes of
// its group (G = 1 << g_log2 <= 32, groups aligned inside a warp).  VEC is
// the row's width in elements when one 16-byte load reads it, else 1
// (d scalar loads, d <= kRow).  Every thread runs the shuffles, bags past
// b with zeros.
template <bool BF16, int VEC>
__global__ void __launch_bounds__(kThreads)
embbag_kernel_ksplit(const void* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, void* __restrict__ out,
                     int b, int k, int d, int g_log2) {
  using E = typename std::conditional<BF16, uint16_t, float>::type;
  constexpr int kRow = kRowBytes / sizeof(E);   // widest row, elements
  const int g = 1 << g_log2;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long bag = t >> g_log2;
  const int lane = static_cast<int>(t) & (g - 1);
  const bool live = bag < b;
  const E* tab = static_cast<const E*>(table);
  const int32_t* bag_idx = idx + (live ? bag : 0) * static_cast<size_t>(k);
  const float* bag_w = w + (live ? bag : 0) * static_cast<size_t>(k);
  float acc[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) acc[j] = 0.0f;
  for (int k0 = lane; k0 < k; k0 += g * kSplitRun) {   // ascending k
    int at[kSplitRun];
    float wk[kSplitRun];
#pragma unroll
    for (int q = 0; q < kSplitRun; ++q) {
      const int kk = k0 + q * g;
      const bool in = live && kk < k;
      at[q] = in ? __ldg(bag_idx + kk) : -1;
      wk[q] = in ? __ldg(bag_w + kk) : 0.0f;
    }
    float v[kSplitRun][kRow];   // every gather issued before any is used
#pragma unroll
    for (int q = 0; q < kSplitRun; ++q) {
      const E* row = tab + static_cast<size_t>(at[q] < 0 ? 0 : at[q]) * d;
      if constexpr (VEC > 1) {
        static_assert(VEC == kRow, "a 16-byte load reads the whole row");
        if (at[q] >= 0) {
          load_chunk<BF16, VEC>(row, v[q]);
        } else {
#pragma unroll
          for (int j = 0; j < kRow; ++j) v[q][j] = 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRow; ++j) {
          float x = 0.0f;
          if (at[q] >= 0 && j < d) {
            if constexpr (BF16) {
              x = bf16_bits_to_f32(__ldg(row + j));
            } else {
              x = __ldg(row + j);
            }
          }
          v[q][j] = x;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSplitRun; ++q) {
#pragma unroll
      for (int j = 0; j < kRow; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(v[q][j], wk[q]));
    }
  }
  // the group's sum: a fixed xor tree, the same in every lane of it
#pragma unroll
  for (int j = 0; j < kRow; ++j) {
    if (j < d) {
      for (int o = g >> 1; o > 0; o >>= 1)
        acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], o));
    }
  }
  if (!live || lane != 0) return;
  E* dst = static_cast<E*>(out) + static_cast<size_t>(bag) * d;
  if constexpr (VEC > 1) {
    store_chunk<BF16, VEC>(dst, acc);
  } else {
#pragma unroll
    for (int j = 0; j < kRow; ++j) {
      if (j < d) {
        const float x[1] = {acc[j]};
        store_chunk<BF16, 1>(dst + j, x);
      }
    }
  }
}

template <bool BF16, int VEC>
int launch(const void* table, const int32_t* idx, const float* w, void* out,
           int b, int k, int d, cudaStream_t stream) {
  const int chunks = d / VEC;   // VEC-wide column chunks of a row
  int tpb = 1;
  while (tpb < chunks && tpb < kThreads) tpb <<= 1;
  int bpb = kThreads / tpb;
  // smaller blocks, down to one warp, while the grid would leave SMs idle
  while (bpb > 1 && bpb * tpb > kMinThreads && (b + bpb - 1) / bpb < 2 * kSMs)
    bpb >>= 1;
  const long long blocks = (static_cast<long long>(b) + bpb - 1) / bpb;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(bpb) * kPitch *
                      (sizeof(int32_t) + sizeof(float));
  embbag_kernel<BF16, VEC><<<static_cast<unsigned>(blocks), bpb * tpb, smem,
                             stream>>>(table, idx, w, out, b, k, d, tpb);
  return static_cast<int>(cudaGetLastError());
}

// The split path's launch: B * G threads, G = 1 << g_log2 lanes a bag.
template <bool BF16, int VEC>
int launch_split(const void* table, const int32_t* idx, const float* w,
                 void* out, int b, int k, int d, cudaStream_t stream) {
  int g_log2 = 0;
  while ((1 << g_log2) < k && g_log2 < 5) ++g_log2;
  const long long threads = static_cast<long long>(b) << g_log2;
  // whole warps: the groups' shuffles take every lane
  const int block = static_cast<int>(
      threads < kThreads ? (threads + 31) / 32 * 32 : kThreads);
  const long long blocks = (threads + block - 1) / block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  embbag_kernel_ksplit<BF16, VEC><<<static_cast<unsigned>(blocks), block, 0,
                                    stream>>>(table, idx, w, out, b, k, d,
                                              g_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 2 bfloat16 (the codes of flash_attention.cu).  Returns
// the CUDA error of the launch (0 on success; nothing is launched for
// b == 0).
extern "C" int repro_embbag(const void* table, const void* idx, const void* w,
                            void* out, int b, int k, int d, int dtype,
                            void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* wt = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (d * 4 <= kRowBytes)   // a row of one chunk: the split path
        return aligned && d * 4 == kRowBytes
                   ? launch_split<false, 4>(table, i, wt, out, b, k, d, s)
                   : launch_split<false, 1>(table, i, wt, out, b, k, d, s);
      return aligned && d % 4 == 0 ? launch<false, 4>(table, i, wt, out, b, k, d, s)
                                   : launch<false, 1>(table, i, wt, out, b, k, d, s);
    case 2:
      if (d * 2 <= kRowBytes)
        return aligned && d * 2 == kRowBytes
                   ? launch_split<true, 8>(table, i, wt, out, b, k, d, s)
                   : launch_split<true, 1>(table, i, wt, out, b, k, d, s);
      return aligned && d % 8 == 0 ? launch<true, 8>(table, i, wt, out, b, k, d, s)
                                   : launch<true, 1>(table, i, wt, out, b, k, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
