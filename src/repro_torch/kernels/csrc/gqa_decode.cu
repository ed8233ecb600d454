// gqa_decode — flash-decode attention with grouped KV heads, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/gqa_decode.py::gqa_decode (body
// _kernel).  One new query token per sequence attends over a KV cache:
// q (B, Hq, D), k/v (B, S, Hkv, D), lengths (B,) int32 -> out (B, Hq, D) in
// q's type.  The G = Hq / Hkv query heads of KV head h share every K/V row
// they read; positions >= lengths[b] take no part; scores are scaled by
// 1/sqrt(D); the softmax is an online one, (m, l, acc) in f32.
//
// What bounds it on an H100: bytes.  Each valid K/V row is read once and
// used for G dot products and G rank-1 updates of D values, so at the
// llama3.2-3b decode shape (G = 3, D = 128, bf16) the kernel does about
// 3 FLOP per byte it reads, two orders of magnitude below the ~295 at which
// the tensor cores would become the limit.  The floor is the valid K/V
// bytes over 3.35 TB/s.
//
// What the design does about it:
// - Split S.  The TPU grid walks S in order inside one program per
//   (b, h); B * Hkv = 64 such programs would fill less than half of the
//   132 SMs.  Here each CTA takes one (split of kSplit positions, h, b), so
//   a batch of 8 at S = 1024 launches 512 CTAs.  The split length is a
//   constant, so which splits a row has depends on its length only, never
//   on B or on the other rows: a row's result is the same whether it is
//   decoded alone or in a batch.
// - No work past the length.  A CTA whose split starts at or past
//   min(lengths[b], S) returns at once, and the merge reads only the splits
//   that hold a valid position; the last tile of the last split is masked
//   to -1e30 (as the TPU kernel masks) and those rows are never loaded.
//   Skipping whole splits is exact: a fully masked split would add
//   exp(-1e30 - m) = 0 to the sum, where its own partial would be garbage.
// - K/V tiles of kTile rows go through shared memory as f32 (16-byte
//   loads, bf16 converted on the way in); the dot products over D are warp
//   reductions (one warp per row, lanes across D), the tile's softmax is
//   one lane per position, and each thread then owns (g, d) entries of acc.
// - A second, deterministic kernel merges the splits of each query row in
//   split order: m* = max m_s, out = sum exp(m_s - m*) acc_s /
//   max(sum exp(m_s - m*) l_s, 1e-30), the clamp of the TPU kernel.
// No cp.async/TMA pipelining and no tensor cores: later work, measured
// against this version.
//
// A row whose length is <= 0 has no valid position: its output is 0 (the
// TPU kernel gives the mean of V, the plain versions NaN); decode always
// passes length + 1 >= 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgqa_decode.so gqa_decode.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/gqa_decode.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // K/V rows per tile: one a lane
constexpr int kSplit = 128;                // positions per CTA
constexpr int kMinD = 16;
constexpr int kMaxD = 256;
constexpr size_t kMaxSmem = 232448;        // what a block may opt in to
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes at src (16-byte aligned) as f32 into dst: 4 floats, or 8 bf16
// (a bf16 is the high half of the f32 with the same bits, so the
// conversion is exact; element 2j is the low half of word j).
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dst[2 * j] = __uint_as_float(w[j] << 16);
    dst[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  // q, acc: G x D; K, V tiles: kTile x D; scores: G x kTile; m, l, alpha: G
  return 2 * (size_t)G * D + 2 * (size_t)kTile * D + (size_t)G * kTile +
         3 * (size_t)G;
}

// grid: (n_split, Hkv, B); block: kThreads; dynamic shared: smem_floats.
// Writes the split's unnormalised partial (m, l) to part_ml and acc to
// part_acc, indexed [b][h][split][g].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int Hq, int Hkv, int S, int D, int n_split, float scale) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(lengths[b], S);
  const int s_begin = split * kSplit;
  if (s_begin >= len) return;            // nothing valid: never merged
  const int s_end = min(s_begin + kSplit, len);
  const int G = Hq / Hkv;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [G][D]
  float* acc_s = q_s + G * D;            // [G][D]
  float* k_s = acc_s + G * D;            // [kTile][D]
  float* v_s = k_s + kTile * D;          // [kTile][D]
  float* sc = v_s + kTile * D;           // [G][kTile]: scores, then p
  float* m_s = sc + G * kTile;           // [G]
  float* l_s = m_s + G;                  // [G]
  float* a_s = l_s + G;                  // [G]: this tile's alpha

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // the G query rows of KV head h are rows h*G .. h*G+G-1 of q[b]
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }

  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  const int vecs_per_row = D / kVec;
  const size_t row_stride = (size_t)Hkv * D;   // between positions
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    // K/V rows t0 .. t0+kTile-1 into shared memory; rows past s_end are
    // never read from device memory (zeros here, masked below)
    for (int i = tid; i < kTile * vecs_per_row; i += kThreads) {
      const int p = i / vecs_per_row;
      const int c = (i - p * vecs_per_row) * kVec;
      float* kd = k_s + p * D + c;
      float* vd = v_s + p * D + c;
      if (t0 + p < s_end) {
        const size_t off = (size_t)(t0 + p) * row_stride + c;
        load16(kb + off, kd);
        load16(vb + off, vd);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kd[j] = vd[j] = 0.0f;
      }
    }
    __syncthreads();

    // scores: one warp per position, lanes across D
    for (int p = warp; p < kTile; p += kWarps) {
      const float* kr = k_s + p * D;
      const bool valid = t0 + p < s_end;
      for (int g = 0; g < G; ++g) {
        const float* qr = q_s + g * D;
        float part = 0.0f;
        for (int d = lane; d < D; d += 32) part = fmaf(qr[d], kr[d], part);
        part = warp_sum(part);
        if (lane == 0) sc[g * kTile + p] = valid ? part * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the tile: one warp per query row, a lane per
    // position.  The tile holds a valid position before any masked one, so
    // m is finite after the first tile and masked positions get p = 0.
    for (int g = warp; g < G; g += kWarps) {
      const float s = sc[g * kTile + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      sc[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha[g] + sum_p p[g][p] * V[p][d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = sc + g * kTile;
      float a = acc_s[i] * a_s[g];
#pragma unroll 8
      for (int p = 0; p < kTile; ++p) a = fmaf(pr[p], v_s[p * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  const size_t row0 = (((size_t)b * Hkv + h) * n_split + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    part_ml[2 * (row0 + g)] = m_s[g];
    part_ml[2 * (row0 + g) + 1] = l_s[g];
  }
  for (int i = tid; i < G * D; i += kThreads) part_acc[row0 * D + i] = acc_s[i];
}

// grid: B * Hq (one query row each); block: kThreads.  Merges the row's
// valid splits in split order, so the sum's order is fixed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_merge_kernel(const int* __restrict__ lengths,
                 const float* __restrict__ part_ml,
                 const float* __restrict__ part_acc, T* __restrict__ out,
                 int Hq, int Hkv, int S, int D, int n_split) {
  const int row = blockIdx.x;            // b * Hq + hq
  const int b = row / Hq;
  const int hq = row - b * Hq;
  const int G = Hq / Hkv;
  const int h = hq / G;
  const int g = hq - h * G;
  const int len = min(lengths[b], S);
  const int n_valid = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  const size_t base = ((size_t)b * Hkv + h) * n_split;

  float m_star = kNegInf;
  for (int s = 0; s < n_valid; ++s)
    m_star = fmaxf(m_star, part_ml[2 * ((base + s) * G + g)]);
  float l_sum = 0.0f;
  for (int s = 0; s < n_valid; ++s) {
    const size_t r = (base + s) * G + g;
    l_sum += expf(part_ml[2 * r] - m_star) * part_ml[2 * r + 1];
  }
  const float inv = 1.0f / fmaxf(l_sum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
      const size_t r = (base + s) * G + g;
      o += expf(part_ml[2 * r] - m_star) * part_acc[r * D + d];
    }
    out[(size_t)row * D + d] = from_f32<T>(o * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* part_ml, void* part_acc, void* out, int B, int Hq, int Hkv,
           int S, int D, int n_split, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || S <= 0 || D < kMinD || D > kMaxD || D % 16 != 0 ||
      n_split != (S + kSplit - 1) / kSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = Hq / Hkv;
  const size_t smem = smem_floats(G, D) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        gqa_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_split, Hkv, B);
  gqa_split_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), Hq, Hkv, S,
      D, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_merge_kernel<T><<<B * Hq, kThreads, 0, st>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<T*>(out), Hq, Hkv, S, D,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D): row-major,
// contiguous, 16-byte aligned, all of one type.  lengths is int32[B] on the
// device.  part_ml (B, Hkv, n_split, G, 2) and part_acc (B, Hkv, n_split, G,
// D) are f32 scratch, n_split = ceil(S / 128).  Returns the cudaError_t of
// the launches (0 on success).
extern "C" int gqa_decode_f32(const void* q, const void* k, const void* v,
                              const void* lengths, void* part_ml,
                              void* part_acc, void* out, int B, int Hq,
                              int Hkv, int S, int D, int n_split, float scale,
                              void* stream) {
  return launch<float>(q, k, v, lengths, part_ml, part_acc, out, B, Hq, Hkv,
                       S, D, n_split, scale, stream);
}

extern "C" int gqa_decode_bf16(const void* q, const void* k, const void* v,
                               const void* lengths, void* part_ml,
                               void* part_acc, void* out, int B, int Hq,
                               int Hkv, int S, int D, int n_split, float scale,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, part_ml, part_acc, out, B,
                               Hq, Hkv, S, D, n_split, scale, stream);
}
