// B6 — weighted embedding bag for Hopper (sm_90a).
//
//   out[b, :] = sum_k w[b, k] * table[idx[b, k], :]
//   table (R, D) float32 or bfloat16; idx (B, K) int32; w (B, K) float32,
//   0 for padding; out (B, D) in the table's type.  Each product w * t is
//   rounded to float32 and added to a float32 sum in ascending k, as the
//   Pallas kernel does; the sum is rounded to the table's type (bfloat16:
//   to nearest even).  Any B >= 0, K >= 1, D >= 1; indices in [0, R) are
//   the caller's contract.
//
// Replaces the TPU kernel `embbag` of src/repro/kernels/embbag.py:48
// (pl.pallas_call at :69).  That kernel scalar-prefetches idx into SMEM,
// keeps the table in HBM and, for each (bag, k), DMAs one table row into
// a VMEM line, waits, and adds it to the bag's on-chip sum: one row in
// flight at a time.  Here no row is staged: each thread owns one bag and
// one chunk of VEC consecutive columns, and reads its K rows straight from
// device memory into float32 registers — 16-byte loads (4 floats or 8
// bfloat16) when D is a multiple of VEC and the table and output are
// 16-byte aligned, scalar loads otherwise.  The loop over k is unrolled,
// so several rows are in flight per thread.  The block's bags' idx and w
// are staged in shared memory, kTileK entries of each bag at a time, read
// from device memory once per block and by every thread of a bag from
// there (when D needs more than kThreads chunks, the block walks the
// chunks in rounds and reads them once per round).  Nothing of shape
// (B, K, D) is ever written.  Row offsets are 64-bit: R * D passes 2^31
// at other widths (33M rows x 64).
//
// What bounds it on an H100: bytes.  It does 2 * B * K * D flops on
// B * K * D gathered values; at the xDeepFM linear term (B = 512, K = 39,
// D = 1, float32) the gathered rows, idx, w and out are ~0.24 MB, ~0.07 us
// at 3.35 TB/s, so a call costs its launch; at kernel_bench's shape
// (B = 4096, K = 4, D = 64, float32) ~4.2 MB of rows, ~5.4 MB with idx, w
// and out, ~1.6 us.
// What the design does about that: every gathered byte is read once, in
// 16-byte loads where the row allows, with no intermediate in device
// memory; small D packs many bags into one block (a thread per bag at
// D = 1) and small batches get smaller blocks, so the grid spreads over
// the SMs.  Not done here, and later work: a warp per bag with the k loop
// split across lanes for small D and large K, and prefetching the next
// tile's rows.
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
      return aligned && d % 4 == 0 ? launch<false, 4>(table, i, wt, out, b, k, d, s)
                                   : launch<false, 1>(table, i, wt, out, b, k, d, s);
    case 2:
      return aligned && d % 8 == 0 ? launch<true, 8>(table, i, wt, out, b, k, d, s)
                                   : launch<true, 1>(table, i, wt, out, b, k, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
