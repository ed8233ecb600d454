// birrd_apply — push aw wires through a BIRRD switch program, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/birrd_reduce.py::birrd_apply_p
// (body _kernel).  x (aw, d) in f32 or bf16 goes through the S stages of an
// aw-input BIRRD in f32 and is stored in x's type: out (aw, d).  With a
// port mask (aw flags) the rows whose flag is 0 are stored as 0, as
// FEATHER's output-buffer write-enable drops junk ports; birrd_reduce
// (grouped reduction with an arbitrary output reorder) is then one launch.
// Two kernels:
//
// - birrd_switch_kernel<T, AW>, for routed programs (ops.birrd_reduce and
//   ops.birrd_apply): the program is its Egg codes, one byte a switch and
//   stage (S x aw/2, at most 384 bytes at aw 64: PASS, SWAP, ADD_LEFT,
//   ADD_RIGHT).  The wiring between stages is fixed for each width, so it
//   is compiled in.
// - birrd_apply_kernel<T, AW>, for arbitrary dense stage matrices M_s
//   (S, aw, aw) f32 (ops.birrd_apply_p, as the JAX API takes them):
//   vals = M_s @ vals stage after stage.
//
// What bounds them on an H100: bytes.  The function reads x and writes out
// once (2 aw d elements), and its own work is at most one addition a wire
// and stage.  At the full-size case (aw 16, d 401,408 columns, f32) that is
// 51.4 MB, 15.3 us at 3.35 TB/s.  The dense kernel does S aw^2 FMAs a
// column (1.64 GFLOP there, ~24.5 us at 67 TFLOP/s), so from aw = 16 on it
// sits above the byte bound; the switch kernel does 2 aw selects and at most
// aw/2 additions a column and stage.
//
// What the switch kernel does about it:
// - A thread owns 4 neighbouring columns (aw <= 16), 2 (aw 32) or 1 (aw
//   64) and keeps their aw values in f32 registers across all stages, so x
//   is read once and out written once, by 16-byte loads and stores at aw
//   <= 16 in f32 (8 in bf16) where d and the pointers allow it.
// - A CTA stages the codes in shared memory once; every thread reads the
//   same code, a broadcast.
// - Every stage and switch is unrolled at compile time (static_for), and the
//   wiring Alg. 1 gives (output j of stage s feeds input
//   reverse_bits(j, bit_range(s)) of stage s + 1, aw 4's three stages the
//   special case) is a constexpr port of BirrdTopology.connection: it
//   renames registers and costs no instruction.  Every array index is a
//   constant, so the values stay in registers (ptxas: 0 bytes stack frame).
// - A switch is out_l = a_l l + b_l r, out_r = a_r r + b_r l with a, b in
//   {0, 1} picked by the code, written as selects and one addition.
//
// Why the switch form is exact: each output of a switch is an exact copy or
// one rounded f32 sum of two values.  The dense loop computes the same: a
// routed stage matrix has at most two entries of 1.0 in a row, its other
// terms are exact zeros, and the f32 sum of two values does not depend on
// their order.  So both kernels, the plain stage loop (ref.birrd_apply), the
// plain switch walk (ref.birrd_switch) and the Pallas kernel in interpret
// mode agree bit for bit on routed programs.
//
// The dense kernel: one thread a column, its aw values in f32 registers
// through every stage, the current stage matrix in shared memory (aw^2
// f32, 16 KB at aw 64, a broadcast), new[i] = sum_j M[i][j] vals[j] by fmaf
// in order j = 0 .. aw-1.
//
// Any d: the ragged last columns are masked (the TPU kernel asserts d % 128
// == 0).  bf16 is widened exactly on load and rounded once, to nearest
// even, on store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbirrd_apply.so birrd_apply.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/birrd_reduce.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// Egg configs, as repro_torch/core/birrd.py numbers them
constexpr unsigned kSwap = 1, kAddLeft = 2, kAddRight = 3;

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

template <typename T, int AW>
__global__ void __launch_bounds__(kThreads)
birrd_apply_kernel(const T* __restrict__ x, const float* __restrict__ mats,
                   const unsigned char* __restrict__ port_mask,
                   T* __restrict__ out, long long d, int S) {
  __shared__ __align__(16) float m[AW * AW];
  const long long col = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const bool live = col < d;

  float vals[AW];
#pragma unroll
  for (int i = 0; i < AW; ++i)
    vals[i] = live ? load_f32(x + i * d + col) : 0.0f;

  for (int s = 0; s < S; ++s) {
    __syncthreads();                       // the last stage's reads are done
    const float* ms = mats + static_cast<long long>(s) * AW * AW;
    for (int e = threadIdx.x; e < AW * AW; e += kThreads) m[e] = __ldg(ms + e);
    __syncthreads();
    float next[AW];
#pragma unroll
    for (int i = 0; i < AW; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < AW; ++j) acc = fmaf(m[i * AW + j], vals[j], acc);
      next[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < AW; ++i) vals[i] = next[i];
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < AW; ++i) {
    const bool keep = port_mask == nullptr || port_mask[i] != 0;
    store_f32(out + i * d + col, keep ? vals[i] : 0.0f);
  }
}

template <typename T, int AW>
int launch_aw(const void* x, const void* mats, const void* mask, void* out,
              long long d, int S, cudaStream_t st) {
  const long long blocks = (d + kThreads - 1) / kThreads;
  birrd_apply_kernel<T, AW><<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(
      static_cast<const T*>(x), static_cast<const float*>(mats),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), d, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* mats, const void* mask, void* out,
           int aw, long long d, int S, void* stream) {
  if (d <= 0 || S <= 0 || (d + kThreads - 1) / kThreads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (aw) {
    case 2: return launch_aw<T, 2>(x, mats, mask, out, d, S, st);
    case 4: return launch_aw<T, 4>(x, mats, mask, out, d, S, st);
    case 8: return launch_aw<T, 8>(x, mats, mask, out, d, S, st);
    case 16: return launch_aw<T, 16>(x, mats, mask, out, d, S, st);
    case 32: return launch_aw<T, 32>(x, mats, mask, out, d, S, st);
    case 64: return launch_aw<T, 64>(x, mats, mask, out, d, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------ switch program
// BirrdTopology, at compile time
__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}
__host__ __device__ constexpr int num_stages(int aw) {
  return aw == 4 ? 3 : 2 * log2i(aw);
}
__host__ __device__ constexpr int reverse_bits(int data,
                                                int bit_range) {
  int rev = 0;
  for (int i = 0; i < bit_range; ++i)
    if (data & (1 << i)) rev |= 1 << (bit_range - 1 - i);
  return (data & ~((1 << bit_range) - 1)) | rev;
}
// the input of stage + 1 that output `port` of `stage` feeds (Alg. 1)
__host__ __device__ constexpr int connection(int aw, int stage,
                                              int port) {
  const int n = log2i(aw);
  int bit_range = n;
  if (aw == 4) {
    bit_range = stage < num_stages(aw) - 1 ? 2 : 1;
  } else {
    if (2 + stage < bit_range) bit_range = 2 + stage;
    if (2 * n - stage < bit_range) bit_range = 2 * n - stage;
  }
  return reverse_bits(port, bit_range > 1 ? bit_range : 1);
}
static_assert(connection(8, 0, 1) == 2 && connection(8, 2, 1) == 4 &&
              connection(4, 2, 1) == 1 && connection(16, 7, 3) == 3,
              "the wiring of Alg. 1");

// f(integral_constant<int, I>) for I = B .. E-1, each I a constant
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// columns a thread owns: as many as leave room in registers for aw values
template <int AW> __host__ __device__ constexpr int cols_per_thread() {
  return AW <= 16 ? 4 : (AW == 32 ? 2 : 1);
}

// C neighbouring elements, widened to f32; masked one by one past `left`
// columns, or where `vec` (d and the pointers aligned) is false
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C],
                                          long long left, bool vec) {
  if (vec && left >= C) {
    if constexpr (C == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else if constexpr (C == 2) {
      const float2 u = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = u.x; v[1] = u.y;
    } else {
      v[0] = __ldg(p);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = c < left ? __ldg(p + c) : 0.0f;
}
template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&v)[C], long long left,
                                          bool vec) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned short h[C];
  if (vec && left >= C) {
    if constexpr (C == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      h[0] = u.x & 0xffffu; h[1] = u.x >> 16;
      h[2] = u.y & 0xffffu; h[3] = u.y >> 16;
    } else if constexpr (C == 2) {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(q));
      h[0] = u & 0xffffu; h[1] = u >> 16;
    } else {
      h[0] = __ldg(q);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) h[c] = c < left ? __ldg(q + c) : 0;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)       // a bf16 is the high half of its f32
    v[c] = __uint_as_float(static_cast<unsigned>(h[c]) << 16);
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C],
                                           long long left, bool vec) {
  if (vec && left >= C) {
    if constexpr (C == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (C == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < left) p[c] = v[c];
}
template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&v)[C],
                                           long long left, bool vec) {
  unsigned short h[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const __nv_bfloat16 r = __float2bfloat16(v[c]);   // nearest even
    h[c] = *reinterpret_cast<const unsigned short*>(&r);
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  if (vec && left >= C) {
    if constexpr (C == 4) {
      *reinterpret_cast<uint2*>(q) = make_uint2(
          h[0] | (static_cast<unsigned>(h[1]) << 16),
          h[2] | (static_cast<unsigned>(h[3]) << 16));
    } else if constexpr (C == 2) {
      *reinterpret_cast<unsigned*>(q) =
          h[0] | (static_cast<unsigned>(h[1]) << 16);
    } else {
      *q = h[0];
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < left) q[c] = h[c];
}

// grid: ceil(d / (C * kThreads)); block: kThreads.  codes: S x AW/2 bytes,
// stage-major.  A code above 3 passes.
template <typename T, int AW>
__global__ void __launch_bounds__(kThreads)
birrd_switch_kernel(const T* __restrict__ x,
                    const unsigned char* __restrict__ codes,
                    const unsigned char* __restrict__ port_mask,
                    T* __restrict__ out, long long d, bool vec) {
  constexpr int S = num_stages(AW);
  constexpr int SW = AW / 2;
  constexpr int C = cols_per_thread<AW>();
  __shared__ unsigned char prog[S * SW];
  for (int e = threadIdx.x; e < S * SW; e += kThreads) prog[e] = codes[e];
  __syncthreads();
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * C;
  if (c0 >= d) return;
  const long long left = d - c0;

  float v[AW][C];
  static_for<0, AW>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    load_cols<C>(x + i * d + c0, v[i], left, vec);
  });
  static_for<0, S>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    float nv[AW][C];
    static_for<0, SW>([&](auto w_) {
      constexpr int w = decltype(w_)::value;
      constexpr int to_l = connection(AW, s, 2 * w);
      constexpr int to_r = connection(AW, s, 2 * w + 1);
      const unsigned code = prog[s * SW + w];
      const bool swap = code == kSwap;
      const bool l_sum = code == kAddLeft;
      const bool r_sum = code == kAddRight;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float l = v[2 * w][c];
        const float r = v[2 * w + 1][c];
        const float sum = l + r;
        nv[to_l][c] = l_sum ? sum : (swap ? r : l);
        nv[to_r][c] = r_sum ? sum : (swap ? l : r);
      }
    });
    static_for<0, AW>([&](auto i_) {
      constexpr int i = decltype(i_)::value;
#pragma unroll
      for (int c = 0; c < C; ++c) v[i][c] = nv[i][c];
    });
  });
  static_for<0, AW>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    if (port_mask != nullptr && port_mask[i] == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[i][c] = 0.0f;
    }
    store_cols<C>(out + i * d + c0, v[i], left, vec);
  });
}

template <typename T, int AW>
int launch_switch_aw(const void* x, const void* codes, const void* mask,
                     void* out, long long d, int S, cudaStream_t st) {
  constexpr int C = cols_per_thread<AW>();
  if (S != num_stages(AW)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (d + C * kThreads - 1) / (C * kThreads);
  const uintptr_t align = C * sizeof(T);
  const bool vec = d % C == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  birrd_switch_kernel<T, AW><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(codes),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), d, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_switch(const void* x, const void* codes, const void* mask,
                  void* out, int aw, long long d, int S, void* stream) {
  if (d <= 0 || (d + kThreads - 1) / kThreads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (aw) {
    case 2: return launch_switch_aw<T, 2>(x, codes, mask, out, d, S, st);
    case 4: return launch_switch_aw<T, 4>(x, codes, mask, out, d, S, st);
    case 8: return launch_switch_aw<T, 8>(x, codes, mask, out, d, S, st);
    case 16: return launch_switch_aw<T, 16>(x, codes, mask, out, d, S, st);
    case 32: return launch_switch_aw<T, 32>(x, codes, mask, out, d, S, st);
    case 64: return launch_switch_aw<T, 64>(x, codes, mask, out, d, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x and out (aw, d) of one type, mats (S, aw, aw) f32, mask (aw) bytes or
// null: row-major and contiguous; aw 2, 4, 8, 16, 32 or 64.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int birrd_apply_f32(const void* x, const void* mats,
                               const void* mask, void* out, int aw,
                               long long d, int S, void* stream) {
  return launch<float>(x, mats, mask, out, aw, d, S, stream);
}

extern "C" int birrd_apply_bf16(const void* x, const void* mats,
                                const void* mask, void* out, int aw,
                                long long d, int S, void* stream) {
  return launch<__nv_bfloat16>(x, mats, mask, out, aw, d, S, stream);
}

// x and out (aw, d) of one type, codes (S, aw / 2) bytes (S the width's
// stage count), mask (aw) bytes or null: row-major and contiguous; aw 2, 4,
// 8, 16, 32 or 64.  Returns the cudaError_t of the launch (0 on success).
extern "C" int birrd_switch_f32(const void* x, const void* codes,
                                const void* mask, void* out, int aw,
                                long long d, int S, void* stream) {
  return launch_switch<float>(x, codes, mask, out, aw, d, S, stream);
}

extern "C" int birrd_switch_bf16(const void* x, const void* codes,
                                 const void* mask, void* out, int aw,
                                 long long d, int S, void* stream) {
  return launch_switch<__nv_bfloat16>(x, codes, mask, out, aw, d, S, stream);
}
