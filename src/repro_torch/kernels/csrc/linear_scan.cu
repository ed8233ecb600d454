// linear_scan — chunked gated linear attention (the rwkv6 / mamba2 scan),
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan.py::linear_scan
// (body _kernel).  Per (b, h), with an f32 state h of (dk, dv):
//     h_t = exp(logw_t)[:, None] * h_{t-1} + k_t^T v_t,    y_t = q_t h_t
// q, k (B, H, T, dk), v (B, H, T, dv) in f32 or bf16, log decay (B, H, T,
// dk) f32 and <= 0 -> y (B, H, T, dv) in v's type.  Chunks of kChunk = 64
// steps, each computed as in the TPU kernel and the plain
// ref.linear_scan_chunked, with cum the inclusive prefix of logw inside
// the chunk:
//     y     = (q * e^cum) h  +  S v,     S[t][s] = sum_d q[t,d] k[s,d]
//                                                  e^(cum[t,d] - cum[s,d])
//     h_new = e^cum_T * h  +  (k * e^(cum_T - cum))^T v
// S (s <= t) goes through the sub-chunk factorisation of ref.py: for rows
// in sub-chunk j (kSub = 16 rows from lo), base b = cum[lo], the columns
// before lo take (q e^(cum_t - b)) . (k e^(b - cum_s)), the diagonal
// 16 x 16 block the direct form; every exponent is <= 0, so nothing
// overflows and nothing is clamped (the TPU kernel's _CLAMP is unused there
// too).  A decay that underflows e^cum to 0 inside a chunk gives 0, not NaN.
//
// What bounds it on an H100: f32 operations.  At the rwkv6-1.6b training
// shape (B 8, H 32, T 1024, dk = dv = 64, bf16 q/k/v) a chunk is three
// 64x64x64 products plus the masked intra-chunk part, about 7 GFLOP over
// 0.2 GB of operands: ~0.10 ms at 67 TFLOP/s against ~0.06 ms of bytes at
// 3.35 TB/s.  The products stay in f32 FMA (no TF32), as the port's fp32
// parity rule asks.
//
// What the design does about it:
// - The TPU grid walks the chunks of one (b, h) in order and carries the
//   state in VMEM scratch.  Here one CTA of 256 threads takes one (b, h)
//   (256 CTAs at the training shape, about two waves on 132 SMs) and walks
//   its chunks in a loop, the state h in shared memory in f32.
// - Each chunk's q, k, v and log decay are staged in shared memory as f32
//   (bf16 converted exactly, by a shift of its bits); the prefix sum of the
//   log decay runs down each dk column as a warp scan.
// - The three products are register-tiled: each thread owns a 4 x 4 tile
//   of y (64 x dv) or of the new h (dk x dv) and reads one float4 of the
//   right operand and four broadcast scalars of the left one per step of
//   the inner dimension.  The score tiles (L x L) are dot products over dk
//   with rows padded to dk + 1 floats, so a warp's lanes hit distinct banks.
// - Ragged T: the last chunk's rows past T count as q = k = v = 0 and log
//   decay 0 and are never stored, so any T runs the kernel.
// No cp.async/TMA pipelining and no tensor cores: later work, measured
// against this version.  There is no backward kernel (the TPU package has
// none either): autograd recomputes through the plain chunked version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblinear_scan.so linear_scan.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/linear_scan.py).
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kChunk = 64;                 // steps a chunk (L)
constexpr int kSub = 16;                   // rows a sub-chunk
constexpr size_t kMaxSmem = 232448;        // what a block may opt in to
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
// a bf16 is the high half of the f32 with the same bits: exact
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                // round to nearest even
}

// h (DK x DV), v (L x DV), scores (L x L), then q, k, cum, x, e (L x DK+1)
template <int DK, int DV>
__host__ __device__ constexpr int smem_floats() {
  return DK * DV + kChunk * DV + kChunk * kChunk + 5 * kChunk * (DK + 1);
}

// grid: B * H (one (b, h) each); block: kThreads; dynamic shared:
// smem_floats<DK, DV>() floats.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   T* __restrict__ out, int T_len) {
  constexpr int L = kChunk;
  constexpr int P = DK + 1;                // padded row of the dk operands
  static_assert(DK % 4 == 0 && DV % 4 == 0 && (L / 4) * (DV / 4) <= kThreads,
                "tile mapping");
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                       // [DK][DV]  the carried state
  float* v_s = h_s + DK * DV;              // [L][DV]
  float* s_s = v_s + L * DV;               // [L][L]    intra-chunk scores
  float* q_s = s_s + L * L;                // [L][P]
  float* k_s = q_s + L * P;                // [L][P]
  float* c_s = k_s + L * P;                // [L][P]    log decay, then cum
  float* x_s = c_s + L * P;                // [L][P]    q e^cum / k pre / k_in
  float* e_s = x_s + L * P;                // [L][P]    q e^(cum - base)

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * T_len * DK;
  const T* kb = k + bh * T_len * DK;
  const T* vb = v + bh * T_len * DV;
  const float* wb = w + bh * T_len * DK;
  T* ob = out + bh * T_len * DV;

  // 4 x 4 register tiles: of y (rows y_r..y_r+3 of the chunk) and of the
  // new state (rows h_r..h_r+3 of dk); both at columns col..col+3 of dv
  constexpr int kColGroups = DV / 4;
  const bool y_owner = tid < (L / 4) * kColGroups;
  const bool h_owner = tid < (DK / 4) * kColGroups;
  const int y_r = (tid / kColGroups) * 4;
  const int h_r = y_r;
  const int col = (tid % kColGroups) * 4;

  for (int i = tid; i < DK * DV; i += kThreads) h_s[i] = 0.0f;

  const int n_chunks = (T_len + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int rows = min(L, T_len - t0);   // valid rows of this chunk

    // 1. stage the chunk as f32; rows past T are zeros (log decay 0)
    for (int i = tid; i < L * DK; i += kThreads) {
      const int t = i / DK;
      const int d = i - t * DK;
      float qv = 0.0f, kv = 0.0f, wv = 0.0f;
      if (t < rows) {
        const size_t g = (size_t)(t0 + t) * DK + d;
        qv = load_f32(qb + g);
        kv = load_f32(kb + g);
        wv = __ldg(wb + g);
      }
      q_s[t * P + d] = qv;
      k_s[t * P + d] = kv;
      c_s[t * P + d] = wv;
    }
    for (int i = tid; i < L * DV; i += kThreads) {
      v_s[i] = i / DV < rows ? load_f32(vb + (size_t)t0 * DV + i) : 0.0f;
    }
    __syncthreads();

    // 2. inclusive prefix sum down each dk column: a warp a column, lanes
    //    holding rows lane and lane + 32
    {
      const int lane = tid & 31;
      for (int d = tid >> 5; d < DK; d += kThreads / 32) {
        float a = c_s[lane * P + d];
        float b = c_s[(lane + 32) * P + d];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float ua = __shfl_up_sync(0xffffffffu, a, o);
          const float ub = __shfl_up_sync(0xffffffffu, b, o);
          if (lane >= o) {
            a += ua;
            b += ub;
          }
        }
        b += __shfl_sync(0xffffffffu, a, 31);
        c_s[lane * P + d] = a;
        c_s[(lane + 32) * P + d] = b;
      }
    }
    __syncthreads();

    // 3. q e^cum (the state read) and q e^(cum - base) (earlier columns)
    for (int i = tid; i < L * DK; i += kThreads) {
      const int t = i / DK;
      const int d = i - t * DK;
      const float cv = c_s[t * P + d];
      const float base = c_s[(t & ~(kSub - 1)) * P + d];
      const float qv = q_s[t * P + d];
      x_s[t * P + d] = qv * expf(cv);
      e_s[t * P + d] = qv * expf(cv - base);
    }
    __syncthreads();

    // 4. y = (q e^cum) h, and the diagonal blocks of the scores (zero above
    //    the diagonal, which the tiles of step 6 read)
    float y[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[i][j] = 0.0f;
    if (y_owner) {
      for (int d = 0; d < DK; ++d) {
        const float4 hv = *reinterpret_cast<const float4*>(h_s + d * DV + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = x_s[(y_r + i) * P + d];
          y[i][0] = fmaf(a, hv.x, y[i][0]);
          y[i][1] = fmaf(a, hv.y, y[i][1]);
          y[i][2] = fmaf(a, hv.z, y[i][2]);
          y[i][3] = fmaf(a, hv.w, y[i][3]);
        }
      }
    }
    for (int i = tid; i < L * kSub; i += kThreads) {
      const int t = i / kSub;                          // row of the chunk
      const int s = (t & ~(kSub - 1)) + (i - t * kSub);  // column, same block
      float acc = 0.0f;
      if (s <= t) {
        for (int d = 0; d < DK; ++d) {
          acc = fmaf(q_s[t * P + d] * k_s[s * P + d],
                     expf(fminf(c_s[t * P + d] - c_s[s * P + d], 0.0f)), acc);
        }
      }
      s_s[t * L + s] = acc;
    }

    // 5. columns before each sub-chunk: (q e^(cum_t - b)) . (k e^(b - cum_s))
    for (int lo = kSub; lo < L; lo += kSub) {
      __syncthreads();                     // x_s is free again
      for (int i = tid; i < lo * DK; i += kThreads) {
        const int s = i / DK;
        const int d = i - s * DK;
        x_s[s * P + d] =
            k_s[s * P + d] * expf(fminf(c_s[lo * P + d] - c_s[s * P + d], 0.0f));
      }
      __syncthreads();
      for (int i = tid; i < kSub * lo; i += kThreads) {
        const int t = lo + i / lo;
        const int s = i % lo;
        float acc = 0.0f;
        for (int d = 0; d < DK; ++d) acc = fmaf(e_s[t * P + d], x_s[s * P + d], acc);
        s_s[t * L + s] = acc;
      }
    }
    __syncthreads();

    // 6. y += S v over the columns up to the tile's last row; store
    if (y_owner) {
      for (int s = 0; s < y_r + 4; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + s * DV + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = s_s[(y_r + i) * L + s];
          y[i][0] = fmaf(a, vv.x, y[i][0]);
          y[i][1] = fmaf(a, vv.y, y[i][1]);
          y[i][2] = fmaf(a, vv.z, y[i][2]);
          y[i][3] = fmaf(a, vv.w, y[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (y_r + i < rows) {
          T* o = ob + (size_t)(t0 + y_r + i) * DV + col;
#pragma unroll
          for (int j = 0; j < 4; ++j) store_f32(o + j, y[i][j]);
        }
      }
    }

    // 7. k e^(cum_T - cum) (step 5's readers of x_s passed the barrier)
    for (int i = tid; i < L * DK; i += kThreads) {
      const int s = i / DK;
      const int d = i - s * DK;
      x_s[s * P + d] = k_s[s * P + d] * expf(c_s[(L - 1) * P + d] - c_s[s * P + d]);
    }
    __syncthreads();

    // 8. h = e^cum_T h + (k e^(cum_T - cum))^T v
    if (h_owner) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int s = 0; s < L; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + s * DV + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = x_s[s * P + h_r + i];
          acc[i][0] = fmaf(a, vv.x, acc[i][0]);
          acc[i][1] = fmaf(a, vv.y, acc[i][1]);
          acc[i][2] = fmaf(a, vv.z, acc[i][2]);
          acc[i][3] = fmaf(a, vv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float decay = expf(c_s[(L - 1) * P + h_r + i]);
        float* hr = h_s + (h_r + i) * DV + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) hr[j] = fmaf(decay, hr[j], acc[i][j]);
      }
    }
    __syncthreads();                       // before the next chunk's stage
  }
}

template <typename T, int DK, int DV>
int launch_dims(const void* q, const void* k, const void* v, const void* w,
                void* out, int BH, int T_len, cudaStream_t st) {
  constexpr size_t smem = smem_floats<DK, DV>() * sizeof(float);
  static_assert(smem <= kMaxSmem, "shared memory");
  if (smem > kDefaultSmem) {
    // the opt-in is set once per instantiation and device, not per launch
    static std::atomic<unsigned long long> opted{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(opted.load(std::memory_order_acquire) & bit)) {
      e = cudaFuncSetAttribute(linear_scan_kernel<T, DK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      opted.fetch_or(bit, std::memory_order_release);
    }
  }
  linear_scan_kernel<T, DK, DV><<<BH, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<T*>(out), T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DK>
int launch_dv(const void* q, const void* k, const void* v, const void* w,
              void* out, int BH, int T_len, int dv, cudaStream_t st) {
  switch (dv) {
    case 16: return launch_dims<T, DK, 16>(q, k, v, w, out, BH, T_len, st);
    case 32: return launch_dims<T, DK, 32>(q, k, v, w, out, BH, T_len, st);
    case 64: return launch_dims<T, DK, 64>(q, k, v, w, out, BH, T_len, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* w,
           void* out, int BH, int T_len, int dk, int dv, void* stream) {
  if (BH <= 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16: return launch_dv<T, 16>(q, k, v, w, out, BH, T_len, dv, st);
    case 32: return launch_dv<T, 32>(q, k, v, w, out, BH, T_len, dv, st);
    case 64: return launch_dv<T, 64>(q, k, v, w, out, BH, T_len, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k (BH, T, dk) and v, out (BH, T, dv) of one type, w (BH, T, dk) f32:
// row-major and contiguous; dk and dv each 16, 32 or 64.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int linear_scan_f32(const void* q, const void* k, const void* v,
                               const void* w, void* out, int BH, int T,
                               int dk, int dv, void* stream) {
  return launch<float>(q, k, v, w, out, BH, T, dk, dv, stream);
}

extern "C" int linear_scan_bf16(const void* q, const void* k, const void* v,
                                const void* w, void* out, int BH, int T,
                                int dk, int dv, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, w, out, BH, T, dk, dv, stream);
}
