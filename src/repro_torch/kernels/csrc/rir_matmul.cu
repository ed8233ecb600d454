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
// 20 FLOP per byte, so the network is bound by the fp32 FMA rate; only the
// 64-to-64 1x1 layer at 56x56 (16 FLOP/byte) is bound by bytes.  Inside an
// SM an 8x8 register tile asks for 16 floats of shared memory a K step for
// 64 FMAs, which is about the 128 bytes a clock shared memory delivers at
// the SM's 128 FMAs a clock; an SM was measured near two thirds of its FMA
// rate.  Past that, what the card does with the steps is a matter of
// filling its 132 SMs: the deep steps have few rows and long K walks.
//
// What this design does about it:
// - A thread accumulates an 8x8 register tile, two 4-row by two 4-column
//   halves: a K step is 64 FMAs for four 8-byte loads of A (each two K
//   steps of one row) and two 16-byte loads of B.
// - CTA tiles are 128 x 64 (128 threads, two or three CTAs an SM, so one
//   CTA's loads and stores overlap another's FMAs), or 128 x 128 (256
//   threads, one CTA an SM) on the long-K steps.  Larger register tiles
//   (16x8, 8x16) hit the 255-register cap and ran slower.
// - A 4-stage ring of 16-deep K slices in dynamic shared memory, filled by
//   cp.async while the FMAs run on an earlier slice (one __syncthreads a
//   slice).  B (K x N, row-major) goes in by 16-byte cp.async.cg.  A stays
//   m-major, as it lies in memory (no transpose), each row padded so that
//   rows 4 apart fall 16 banks apart; it goes in by 16-byte cp.async where
//   its rows are 16-byte aligned, else by 4-byte cp.async of single f32
//   elements (the 7x7 stem has K = 147) or, in bf16, plain loads.  A
//   thread's load addresses are computed once and advance a slice a load.
// - Split-K for the deep layers' short grids: split z walks its own K range
//   and stores its partial sums to an f32 workspace (splits x M x N, from
//   the wrapper); rir_splitk_reduce_kernel adds them in split order 0, 1,
//   ..., splits-1 and runs the epilogue.  Not a cluster summing through
//   distributed shared memory: a cluster of 8 is placed on at most 120 SMs,
//   15 clusters at a time, and packs two CTAs an SM where two fit, so the
//   deepest step would run as two waves.
// - The epilogue reads a thread's two perm slots once and stores 16 bytes
//   (8 in bf16) at a time.
//
// Split-K invariant: a request's output is bit-identical served alone or in
// a batch.  Every output element is a sum over splits, in split order, of
// one fmaf chain a split over its K range in order; the tile, the splits
// and their K ranges are chosen from K and N alone
// (repro_torch/kernels/rir_matmul.py launch_plan, which the wrapper passes
// in), never from M, and nothing else a row computes depends on which rows
// share the launch.
//
// No tensor cores, on purpose: TF32 keeps about 3 decimal digits, and the
// path's tolerances are fp32 ones (2e-4 for the kernel, rtol 1e-4 / atol
// 1e-3 for whole networks).  A 3xTF32 wgmma design could pass the card's
// fp32 CUDA-core rate at near-fp32 accuracy; it departs from the fp32-FMA
// ground rule and waits for a change that measures its error.
//
// Ragged M and K are masked in the loads (zero-filled) and M in the stores;
// N must be a multiple of block_n and block_n of 64, so a 4-column group
// never crosses a block.  b, the residual and out must be 16-byte aligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librir_matmul.so rir_matmul.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/rir_matmul.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 128;         // a CTA tile: 128 x TN (TN 128 or 64)
constexpr int kTileK = 16;
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;

// How A reaches shared memory: 16-byte cp.async (rows 16-byte aligned),
// 4-byte cp.async of single f32 elements, or plain loads and stores (bf16
// rows that are not 16-byte aligned: no cp.async moves 2 bytes)
constexpr int kA16 = 0, kA4 = 1, kAPlain = 2;

// elements in one 16-byte chunk, and an A row's stride in shared memory:
// 16 bytes of padding puts rows 4 apart 16 banks apart
template <typename T> constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
template <typename T> constexpr int kAStride = kTileK + kChunk<T>;

// threads a CTA: 8 x 8 outputs each
template <int TN> constexpr int kThreads = kTileM * TN / 64;   // 2 TN

template <typename T, int TN>
__host__ __device__ constexpr int stage_elems() {
  return kTileM * kAStride<T> + kTileK * TN;
}
template <typename T, int TN>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * stage_elems<T, TN>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive elements from shared or global memory, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// two consecutive K steps of an A row from shared memory, widened to f32
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  v[0] = u.x; v[1] = u.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&v)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The RIR epilogue: column n's block_n-wide block is stored at slot
// perm[n / block_n], so its column there is rir_col(n).  The wrapper
// launches only perms whose values it checked; a slot outside the output
// would be a store out of bounds, so it traps instead.
__device__ __forceinline__ int rir_col(const int* __restrict__ perm, int n,
                                       int N, int block_n) {
  const int blk = n / block_n;
  const int slot = __ldg(perm + blk);
  if (slot < 0 || slot >= N / block_n) __trap();
  return slot * block_n + (n - blk * block_n);
}
// four sums stored at out[at], the residual at the same place added in f32
// before the one cast
template <typename T>
__device__ __forceinline__ void store_rir(T* __restrict__ out,
                                          const T* __restrict__ residual,
                                          size_t at, float4 v) {
  if (residual != nullptr) {
    const float4 r = load4(residual + at);
    v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
  }
  store4(out + at, v);
}

// grid: (ceil(M / 128), N / TN, splits); block: kThreads<TN>; dynamic
// shared memory: the ring.  A thread owns rows ty*4 + g*64 + i and columns
// tx*4 + h*TN/2 + c (g, h < 2; i, c < 4): 8 x 8 outputs.  One CTA of 256
// threads an SM (168 registers each) with 128-wide tiles, two or three of
// 128 threads with 64-wide ones.  With one split the epilogue stores the
// output; with several, split z stores its partial sums at ws[z] (M x N
// f32) for rir_splitk_reduce_kernel.
template <typename T, int TN, int AMODE>
__global__ void __launch_bounds__(2 * TN, 128 / TN)  // kThreads<TN>
rir_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ perm, const T* __restrict__ residual,
                  T* __restrict__ out, float* __restrict__ ws, int M, int K,
                  int N, int block_n) {
  constexpr int TM = kTileM;
  constexpr int NT = kThreads<TN>;
  constexpr int TX = TN / 8;               // column groups
  constexpr int CH = kChunk<T>;
  constexpr int AST = kAStride<T>;
  constexpr int STAGE = stage_elems<T, TN>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int splits = gridDim.z;
  const int k_tiles = (K - 1) / kTileK + 1;
  const int per = (k_tiles + splits - 1) / splits;
  const int kt0 = blockIdx.z * per;        // this split's K slices
  const int nkt = min(kt0 + per, k_tiles) - kt0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Each thread's share of a slice's loads, fixed for the whole K walk: a
  // base pointer that advances one slice a load, rows a constant stride
  // apart, and which of them lie inside M.
  constexpr int B_ROW = TN / CH;                   // 16-byte chunks a B row
  constexpr int B_CHUNKS = kTileK * B_ROW;
  constexpr int B_ITERS = (B_CHUNKS + NT - 1) / NT;
  const int b_kr = tid / B_ROW;                    // + i * NT / B_ROW
  const int b_nc = (tid % B_ROW) * CH;
  const T* b_src = b + static_cast<size_t>(kt0 * kTileK + b_kr) * N + n0 +
                   b_nc;
  auto load_b = [&](int stage, int k0) {
    T* Bs = smem + stage * STAGE + TM * AST;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      if (B_CHUNKS < NT && tid >= B_CHUNKS) break;
      const int kr = b_kr + i * (NT / B_ROW);
      const bool ok = k0 + kr < K;
      const T* src = ok ? b_src + static_cast<size_t>(i) *
                              (NT / B_ROW) * N : b;
      cp_async16(Bs + kr * TN + b_nc, src, ok ? 16 : 0);
    }
    b_src += static_cast<size_t>(kTileK) * N;
  };
  // 16-byte chunks (kA16: K % CH == 0, so a chunk lies wholly inside or
  // wholly past K), else single elements
  constexpr int A_ROW = AMODE == kA16 ? kTileK / CH : kTileK;
  constexpr int A_ITERS = TM * A_ROW / NT;   // <= 32
  constexpr int A_STEP = NT / A_ROW;         // rows between them
  const int a_row = tid / A_ROW;
  const int a_k = (tid % A_ROW) * (AMODE == kA16 ? CH : 1);
  unsigned a_live = 0;                             // bit i: row i in M
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i)
    if (m0 + a_row + i * A_STEP < M) a_live |= 1u << i;
  const T* a_src = a + static_cast<size_t>(min(m0 + a_row, M - 1)) * K +
                   kt0 * kTileK + a_k;
  auto load_a = [&](int stage, int k0) {
    T* As = smem + stage * STAGE;
    const bool k_in = k0 + a_k < K;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool ok = (a_live >> i & 1u) && k_in;
      const T* src = a_src + static_cast<size_t>(i) * A_STEP * K;
      T* dst = As + (a_row + i * A_STEP) * AST + a_k;
      if constexpr (AMODE == kA16) {
        cp_async16(dst, ok ? src : a, ok ? 16 : 0);
      } else if constexpr (AMODE == kA4) {
        cp_async4(dst, ok ? src : a, ok ? 4 : 0);
      } else {
        *dst = ok ? *src : static_cast<T>(0.0f);
      }
    }
    a_src += kTileK;
  };

  // the ring's first kStages - 1 slices
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) {
      load_b(s, (kt0 + s) * kTileK);
      load_a(s, (kt0 + s) * kTileK);
    }
    cp_async_commit();
  }

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();          // slice t has landed
    __syncthreads();                       // ... for every thread, and slice
                                           // t - 1's stage is free
    const int tn = t + kStages - 1;
    if (tn < nkt) {
      load_b(tn % kStages, (kt0 + tn) * kTileK);
      load_a(tn % kStages, (kt0 + tn) * kTileK);
    }
    cp_async_commit();

    const T* As = smem + (t % kStages) * STAGE + ty * 4 * AST;
    const T* Bs = smem + (t % kStages) * STAGE + TM * AST + tx * 4;
#pragma unroll
    for (int kq = 0; kq < kTileK; kq += 2) {
      float av[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        load2(As + ((r / 4) * (TM / 2) + r % 4) * AST + kq, av[r]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float bv[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = load4(Bs + (kq + kk) * TN + h * (TN / 2));
          bv[h * 4 + 0] = v.x; bv[h * 4 + 1] = v.y;
          bv[h * 4 + 2] = v.z; bv[h * 4 + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(av[r][kk], bv[c], acc[r][c]);
      }
    }
  }

  if (splits > 1) {                        // this split's partial sums
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = m0 + (r / 4) * (TM / 2) + ty * 4 + r % 4;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n0 +
                   h * (TN / 2) + tx * 4,
               make_float4(acc[r][h * 4], acc[r][h * 4 + 1],
                           acc[r][h * 4 + 2], acc[r][h * 4 + 3]));
    }
    return;
  }
  // a thread's two 4-column groups each lie in one block_n-wide block: their
  // columns are looked up once, before the stores (a lookup a store would
  // put a dependent load in front of each)
  const int col[2] = {rir_col(perm, n0 + tx * 4, N, block_n),
                      rir_col(perm, n0 + TN / 2 + tx * 4, N, block_n)};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + (r / 4) * (TM / 2) + ty * 4 + r % 4;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_rir(out, residual, static_cast<size_t>(m) * N + col[h],
                make_float4(acc[r][h * 4], acc[r][h * 4 + 1],
                            acc[r][h * 4 + 2], acc[r][h * 4 + 3]));
  }
}

// grid-stride over the M x N / 4 column groups: the splits' partial sums
// added in split order 0, 1, ..., splits - 1, then the RIR epilogue
constexpr int kReduceThreads = 256;
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
rir_splitk_reduce_kernel(const float* __restrict__ ws,
                         const int* __restrict__ perm,
                         const T* __restrict__ residual, T* __restrict__ out,
                         int M, int N, int block_n, int splits) {
  const size_t groups = static_cast<size_t>(M) * (N / 4);
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t stride = static_cast<size_t>(gridDim.x) * kReduceThreads;
  for (size_t g = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                  threadIdx.x;
       g < groups; g += stride) {
    const int m = static_cast<int>(g / (N / 4));
    const int n = static_cast<int>(g % (N / 4)) * 4;
    const float* p = ws + static_cast<size_t>(m) * N + n;
    float4 v = load4(p);
    for (int j = 1; j < splits; ++j) {
      const float4 q = load4(p + j * plane);
      v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
    }
    store_rir(out, residual,
              static_cast<size_t>(m) * N + rir_col(perm, n, N, block_n), v);
  }
}

template <typename T, int TN, int AMODE>
cudaError_t launch_tile(const T* a, const T* b, const int* perm,
                        const T* residual, T* out, float* ws, int M, int K,
                        int N, int block_n, int splits, cudaStream_t st) {
  auto kern = rir_matmul_kernel<T, TN, AMODE>;
  constexpr int smem = ring_bytes<T, TN>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M - 1) / kTileM + 1, N / TN, splits);
  kern<<<grid, kThreads<TN>, smem, st>>>(a, b, perm, residual, out, ws, M, K,
                                         N, block_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long groups = static_cast<long long>(M) * (N / 4);
  const long long blocks = (groups + kReduceThreads - 1) / kReduceThreads;
  rir_splitk_reduce_kernel<T><<<static_cast<unsigned>(
      blocks < 65536 ? blocks : 65536), kReduceThreads, 0, st>>>(
      ws, perm, residual, out, M, N, block_n, splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int TN>
cudaError_t launch_width(const T* a, const T* b, const int* perm,
                         const T* residual, T* out, float* ws, int M, int K,
                         int N, int block_n, int splits, cudaStream_t st) {
  if (K % kChunk<T> == 0 && aligned16(a))
    return launch_tile<T, TN, kA16>(a, b, perm, residual, out, ws, M, K, N,
                                    block_n, splits, st);
  constexpr int narrow = sizeof(T) == 4 ? kA4 : kAPlain;
  return launch_tile<T, TN, narrow>(a, b, perm, residual, out, ws, M, K, N,
                                    block_n, splits, st);
}

template <typename T>
int launch(const void* a_, const void* b_, const void* perm_,
           const void* residual_, void* out_, void* ws_, int M, int K, int N,
           int block_n, int tile_n, int splits, void* stream) {
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  const int* perm = static_cast<const int*>(perm_);
  const T* residual = static_cast<const T*>(residual_);
  T* out = static_cast<T*>(out_);
  float* ws = static_cast<float*>(ws_);
  const int k_tiles = K > 0 ? (K - 1) / kTileK + 1 : 0;
  const int per = splits > 0 ? (k_tiles + splits - 1) / splits : 0;
  if (M <= 0 || K <= 0 || N <= 0 || block_n <= 0 || block_n % 64 != 0 ||
      N % block_n != 0 || (tile_n != 64 && tile_n != 128) ||
      N % tile_n != 0 || N / tile_n > 65535 ||
      splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) != 0 ||
      (splits - 1) * per >= k_tiles ||
      !aligned16(b) || !aligned16(out) ||
      (residual != nullptr && !aligned16(residual)) ||
      (splits > 1 && (ws == nullptr || !aligned16(ws)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tile_n == 128
          ? launch_width<T, 128>(a, b, perm, residual, out, ws, M, K, N,
                                 block_n, splits, st)
          : launch_width<T, 64>(a, b, perm, residual, out, ws, M, K, N,
                                block_n, splits, st);
  return static_cast<int>(err);
}

}  // namespace

// a (M, K), b (K, N), out (M, N) and residual (M, N, may be null) are
// row-major and contiguous, b, out and residual 16-byte aligned; perm is
// int32[N / block_n] on the device; ws (splits, M, N) f32, 16-byte aligned,
// is the partial sums' workspace (unused, may be null, with one split).
// tile_n (128 or 64: the CTA tile 128 x tile_n) and splits (1, 2, 4 or 8
// K-splits) come from rir_matmul.launch_plan.  Returns the cudaError_t of
// the launches (0 on success).
extern "C" int rir_matmul_f32(const void* a, const void* b, const void* perm,
                              const void* residual, void* out, void* ws,
                              int M, int K, int N, int block_n, int tile_n,
                              int splits, void* stream) {
  return launch<float>(a, b, perm, residual, out, ws, M, K, N, block_n,
                       tile_n, splits, stream);
}

extern "C" int rir_matmul_bf16(const void* a, const void* b, const void* perm,
                               const void* residual, void* out, void* ws,
                               int M, int K, int N, int block_n, int tile_n,
                               int splits, void* stream) {
  return launch<__nv_bfloat16>(a, b, perm, residual, out, ws, M, K, N,
                               block_n, tile_n, splits, stream);
}
