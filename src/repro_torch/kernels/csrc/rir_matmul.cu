// rir_matmul — GEMM with the Reorder-In-Reduction (RIR) epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rir_matmul.py::rir_matmul_p
// (bodies _kernel / _kernel_res).  It computes out = a @ b with an fp32
// accumulator, and writes output column block j (block_n wide) at block slot
// perm[j]; the optional residual is read through the same permuted map and
// added in fp32 before the cast.  So the layout the next layer wants is
// produced by the GEMM's own stores: no relayout pass ever runs.
//
// What bounds it on an H100: the twelve ResNet-50 batch-8 plan steps, as the
// executor shapes them (im2col rows x taps*input width x output width), total
// 13.2 GFLOP over 0.31 GB of unpadded fp32 operands, about 43 FLOP per byte.
// fp32 on the CUDA cores (67 TFLOP/s) against 3.35 TB/s turns over at about
// 20 FLOP per byte, so the network is compute-bound at the fp32 CUDA-core
// rate; only the 64-to-64 1x1 layer at 56x56 (16 FLOP/byte) is memory-bound,
// and the 7x7 stem (22 FLOP/byte) sits at the turn.  The path is fp32 end
// to end, and TF32 tensor cores would keep about 3 digits where the
// executor's tolerances need fp32, so no tensor-core instruction is used.
//
// What this simple design does about it: little, on purpose.  A classic
// shared-memory tiled SIMT GEMM: 64x64 output tiles, 16-deep K slices staged
// in shared memory, 256 threads each accumulating a 4x4 register tile with
// fmaf.  No cp.async pipelining, no wgmma/TMA, no warp specialisation: those
// are later work, measured against this version.
//
// Determinism: every output element is one fmaf chain over k = 0..K-1 in
// order, whatever M is or which rows share the launch (no split-K, no
// M-dependent tiling), so a request's output is bit-identical whether it is
// served alone or batched.
//
// Ragged M and K are masked in the loads (zeros) and M in the stores; N must
// be a multiple of block_n, and block_n a multiple of the 64-wide tile.  The
// executor pads a single-block output (nothing to permute) only to the tile,
// so the 64-wide ResNet-50 layers compute no padded columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librir_matmul.so rir_matmul.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/rir_matmul.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRegM = 4;
constexpr int kRegN = 4;

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

// grid: (N / kTileN, ceil(M / kTileM)); block: kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rir_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ perm, const T* __restrict__ residual,
                  T* __restrict__ out, int M, int K, int N, int block_n) {
  // A is staged transposed (k-major) so a thread's 4 rows are contiguous.
  __shared__ __align__(16) float As[kTileK][kTileM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // output column group
  const int ty = tid / 16;          // output row group
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;

  float acc[kRegM][kRegN];
#pragma unroll
  for (int i = 0; i < kRegM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) acc[i][j] = 0.0f;

  // load roles: A tile 64 x 16 (16 threads per row, 16 rows per pass),
  //             B tile 16 x 64 (64 threads per row, 4 rows per pass)
  const int a_col = tid % kTileK;
  const int a_row = tid / kTileK;
  const int b_col = tid % kTileN;
  const int b_row = tid / kTileN;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int p = 0; p < kTileM; p += kThreads / kTileK) {
      const int m = m0 + a_row + p;
      const int k = k0 + a_col;
      As[a_col][a_row + p] =
          (m < M && k < K) ? to_f32(a[(size_t)m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < kTileK; p += kThreads / kTileN) {
      const int k = k0 + b_row + p;
      Bs[b_row + p][b_col] =
          (k < K) ? to_f32(b[(size_t)k * N + n0 + b_col]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * kRegM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * kRegN]);
      const float ar[kRegM] = {av.x, av.y, av.z, av.w};
      const float br[kRegN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kRegM; ++i)
#pragma unroll
        for (int j = 0; j < kRegN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // RIR epilogue: this thread's 4 columns sit inside one block_n-wide block
  // (block_n is a multiple of kTileN), which is stored at slot perm[block].
  // The wrapper launches only perms whose values it checked; a slot outside
  // the output would be a store out of bounds, so it traps instead.
  const int n = n0 + tx * kRegN;
  const int blk = n / block_n;
  const int slot = perm[blk];
  if (slot < 0 || slot >= N / block_n) __trap();
  const int col = slot * block_n + (n - blk * block_n);
#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    const int m = m0 + ty * kRegM + i;
    if (m >= M) break;
    const size_t row = (size_t)m * N + col;
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      float v = acc[i][j];
      if (residual != nullptr) v += to_f32(residual[row + j]);
      out[row + j] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* perm,
           const void* residual, void* out, int M, int K, int N, int block_n,
           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || block_n <= 0 || block_n % kTileN != 0 ||
      N % block_n != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(N / kTileN, (M + kTileM - 1) / kTileM);
  rir_matmul_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(perm), static_cast<const T*>(residual),
      static_cast<T*>(out), M, K, N, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (K, N), out (M, N) and residual (M, N, may be null) are
// row-major and contiguous; perm is int32[N / block_n] on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rir_matmul_f32(const void* a, const void* b, const void* perm,
                              const void* residual, void* out, int M, int K,
                              int N, int block_n, void* stream) {
  return launch<float>(a, b, perm, residual, out, M, K, N, block_n, stream);
}

extern "C" int rir_matmul_bf16(const void* a, const void* b, const void* perm,
                               const void* residual, void* out, int M, int K,
                               int N, int block_n, void* stream) {
  return launch<__nv_bfloat16>(a, b, perm, residual, out, M, K, N, block_n,
                               stream);
}
