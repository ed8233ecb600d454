// birrd_apply — push aw wires through a compiled BIRRD switch program, for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/birrd_reduce.py::birrd_apply_p
// (body _kernel).  x (aw, d) in f32 or bf16 goes through S stacked stage
// matrices M_s (S, aw, aw) f32, vals = M_s @ vals in f32 stage after stage,
// and is stored in x's type: out (aw, d).  With a port mask (aw flags) the
// rows whose flag is 0 are stored as 0, as FEATHER's output-buffer
// write-enable drops junk ports; birrd_reduce (grouped reduction with an
// arbitrary output reorder) is then one launch.
//
// What bounds it on an H100: bytes.  The function reads x and writes out
// once (2 aw d elements), and its own work is at most one addition per wire
// and stage: a compiled stage matrix (a permutation times an Egg switch
// matrix) has at most two entries of 1.0 in a row.  At the full-size case
// (aw 16, d 401,408 columns, f32) that is 51.4 MB, 15.3 us at 3.35 TB/s.
// This first version does the dense product, S aw^2 FMAs a column (1.64
// GFLOP there, ~24.5 us at 67 TFLOP/s), so from aw = 16 on it sits above
// the byte bound.  Lowering each stage to two taps a wire (2 S aw FMAs a
// column) is later work.
//
// What the design does about it:
// - One thread owns one column and keeps its aw values in f32 registers
//   across all stages, so x is read once and out written once; a CTA of
//   kThreads threads covers as many neighbouring columns, so every row
//   load and store of a warp is one coalesced segment.
// - AW is a template parameter (2 ... 64): the stage loop is unrolled, the
//   values stay in registers, and the shared-memory offsets are constants.
// - The current stage matrix sits in shared memory (aw^2 f32, 16 KB at aw
//   64), loaded once a CTA a stage with __syncthreads between stages.
//   Every thread reads the same M[i][j]: a broadcast, no bank conflicts.
// - new[i] = sum_j M[i][j] vals[j] by fmaf in order j = 0 .. aw-1.  For a
//   routed program every term but at most two is an exact zero, so each
//   stage output is an exact copy or one rounded f32 sum of two values, and
//   the result equals the plain version and the TPU kernel bit for bit.
// - Any d: the ragged last CTA masks its columns past d (the TPU kernel
//   asserts d % 128 == 0).  bf16 is widened exactly on load and rounded
//   once, to nearest even, on store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbirrd_apply.so birrd_apply.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/birrd_reduce.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
