// rir_matmul — GEMM with the Reorder-In-Reduction (RIR) epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rir_matmul.py::rir_matmul_p
// (bodies _kernel / _kernel_res).  It computes out = a @ b with an fp32
// accumulator, and writes output column block j (block_n wide) at block slot
// perm[j]; the optional residual is read through the same permuted map and
// added in fp32 before the cast.  So the layout the next layer wants is
// produced by the GEMM's own stores: no relayout pass ever runs.
//
// Two designs, one launch a call, chosen by the wrapper from the dtype, K
// and N alone (repro_torch/kernels/rir_matmul.py launch_plan, never M):
//
// 3xTF32 on the tensor cores (rir_matmul_kernel_tf32x3, fp32, K % 4 == 0,
// N a multiple of 128, K and N at least 1024: BERT-Large's four encoder
// GEMMs).  Each fp32 product is three TF32 wgmma products, so its ceiling
// is 495 / 3 = 165 TFLOP/s, 2.5x the CUDA cores' 67.  BERT-Large at 64
// sequences (24576 rows) is bound by operations: 170-370 FLOP a byte
// against a ridge of 49 at 165 TFLOP/s and 3.35 TB/s.  It ran at 91-116
// TFLOP/s of device time at BERT-Large's four shapes, 55-70% of its
// ceiling (H100 80GB HBM3, 700 W; PERF.md).  Where the rest goes is not
// measured (no ncu on that machine); the likely limits are shared memory,
// which the wgmma B reads (64 bytes a clock at the tensor rate), the TMA
// fills (32) and the A fragments (11) share at 128 bytes a clock, and each
// warpgroup's serial split, wait and add between its products, which the
// other warpgroup's products cover only in part.  Its error against a
// float64 product at K 1024 and 4096, max |err| / max |ref|: 2.9e-7 to
// 5.9e-7, the SIMT design's 4.9e-7 to 1.2e-6, a single-pass TF32
// product's 2.6e-4 to 3.4e-4.  But the tensor cores' truncated sums leave
// a shrink: every output about 1.84e-7 of its value toward zero at each of
// BERT-Large's shapes (the SIMT design's and the split's alone below
// 1e-9), one sign everywhere, so a chain of GEMMs adds it up where
// round-to-nearest errors only random-walk: 9.0e-6 over BERT-Large's 96
// layers, against the SIMT design's 3.4e-6 rms error there (PERF.md).  Its
// own comment, below, gives the design.
//
// SIMT on the CUDA cores (rir_matmul_kernel<T, TN, AMODE>: bf16, and fp32
// where the 3xTF32 design does not run: ResNet-50's and MobileNet-V3's
// layers, whose short grids it fills by split-K).  What bounds it: the
// twelve ResNet-50 batch-8 plan steps, as the executor shapes them (im2col
// rows x taps*input width x output width), total 13.2 GFLOP over 0.31 GB
// of unpadded fp32 operands, about 43 FLOP per byte; fp32 on the CUDA
// cores (67 TFLOP/s) against 3.35 TB/s turns over at about 20 FLOP per
// byte, so the network is bound by the fp32 FMA rate; only the 64-to-64
// 1x1 layer at 56x56 (16 FLOP/byte) is bound by bytes.  Inside an SM an
// 8x8 register tile asks for 16 floats of shared memory a K step for 64
// FMAs, which is about the 128 bytes a clock shared memory delivers at the
// SM's 128 FMAs a clock; an SM was measured near two thirds of its FMA
// rate.  Past that, what the card does with the steps is a matter of
// filling its 132 SMs: the deep steps have few rows and long K walks.
// What the SIMT design does about it:
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
// Batch invariance, both designs: a request's output is bit-identical
// served alone or in a batch.  Every output element is a sum taken in an
// order fixed by K and N (SIMT: over splits, in split order, of one fmaf
// chain a split over its K range in order; 3xTF32: one accumulator over K
// slices in order), and nothing else a row computes depends on which rows
// share the launch.
//
// Single-pass TF32 and bf16 products stay out of the fp32 path: TF32 keeps
// about 3 decimal digits, and the path's tolerances are fp32 ones (2e-4 for
// the kernel, rtol 1e-4 / atol 1e-3 for whole networks).
//
// SIMT: ragged M and K are masked in the loads (zero-filled) and M in the
// stores; N must be a multiple of block_n and block_n of 64, so a 4-column
// group never crosses a block.  b, the residual and out must be 16-byte
// aligned.  3xTF32: the same, with a 16-byte aligned too (TMA).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librir_matmul.so rir_matmul.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/rir_matmul.py).
#include <cuda.h>           // CUtensorMap; the CUDA driver call that
#include <cudaTypedefs.h>   // encodes one is looked up at run time
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

// ------------------------------------------------------------ 3xTF32 design
// An fp32 GEMM on the tensor cores at fp32's accuracy.  Each operand x is
// split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna: to nearest, ties away
// from zero), and a k-step sums a_lo b_hi + a_hi b_lo + a_hi b_hi, small
// terms first: only a_lo b_lo (about 2^-22 of the product) and lo's own
// rounding are dropped.  The tensor cores truncate their fp32 sums, which
// over a K walk adds up (with one wgmma accumulator through K, the error
// grew with K: 8e-6 of max |ref| at K 1024, 3e-5 at 4096, 10-60x the SIMT
// design's); so they sum one 32-deep K slice from zero, and each slice's
// partial is added into the tile's accumulators by FADD, rounded to
// nearest.
//
// B, the weight, comes split once, when the network is prepared: two planes
// of N x K (K-major: tf32 wgmma reads only K-major operands from shared
// memory), hi above lo, one (2N, K) fp32 tensor.  A, the activations, is
// split inside the kernel, in registers, from the tile TMA brought in.
//
// A CTA is persistent (one an SM) and walks 128 x 128 output tiles, N
// fastest.  Its producer warpgroup's one thread keeps a 4-stage ring of
// 32-deep K slices in flight by TMA (A 128 x 32, B hi and B lo 128 x 32,
// each 16 KB, 128-byte swizzle), one full and one empty mbarrier a stage.
// Two consumer warpgroups take 64 rows each: a thread reads its 16 A
// values of the slice out of the swizzled tile as wgmma's register
// fragment (4 k-steps of 8), splits them, and issues 12
// wgmma.m64n128k8.f32.tf32.tf32 with B hi / B lo from shared memory, then
// waits for them, frees the stage and adds the slice's partial in.  The
// consumers hold 232 registers each (setmaxnreg), the producer 40.  While
// one warpgroup loads and splits, the other's products run; while the
// consumers store a tile, the producer loads the next one.  The RIR
// epilogue is the SIMT design's: a lane pair trades halves so each thread
// stores 4 consecutive columns (16 bytes) of one row at rir_col, the
// residual read at the same place and added in fp32; rows past M are not
// stored.
//
// Every output element is one accumulator over k-steps in order, three
// products a k-step in a fixed order; the tile and the K order depend on K
// and N alone, never on M or on which CTA takes the tile, so a row's bits
// do not depend on the rows it is launched with.
namespace tc {

constexpr int kBM = 128;                  // CTA tile rows: two warpgroups
constexpr int kBN = 128;                  // CTA tile columns (wgmma N)
constexpr int kBK = 32;                   // a K slice: one 128-byte row
constexpr int kRingStages = 4;
constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kBlockThreads = 128 * (kConsumers + 1);
constexpr int kTileBytes = kBM * kBK * 4;             // A, B hi, B lo alike
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kSmemBytes =
    kRingStages * kStageBytes + 2 * kRingStages * 8 + 1024;
static_assert(kBM == kBN, "A and the B planes share one TMA box");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// spins until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// a 2-D box of the tensor map at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// round to the nearest tf32, ties away from zero, as an fp32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// a K-major operand tile of 128-byte rows, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the tile starts on a 1024-byte boundary)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |         // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) | // stride: 8 rows
         (static_cast<uint64_t>(1) << 62);          // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 128, fp32) = a (64 x 8 tf32, registers) * b (8 x 128 tf32, the
// K-major tile at desc) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (kRingStages + s);
}

}  // namespace tc

// grid: min(tiles, SMs) persistent CTAs; block: tc::kBlockThreads (two
// consumer warpgroups, then the producer's); dynamic shared memory:
// tc::kSmemBytes.
// a_map: A (M x K) in boxes of 128 rows x 32; b_map: the planes (2N x K),
// B hi rows [0, N), B lo rows [N, 2N).  Ragged M and K come in zero-filled
// from TMA.
__global__ void __launch_bounds__(tc::kBlockThreads, 1)
rir_matmul_kernel_tf32x3(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const int* __restrict__ perm,
                         const float* __restrict__ residual,
                         float* __restrict__ out, int M, int K, int N,
                         int block_n) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1 KB
  const unsigned char* ring = tc_smem + (base - raw);
  const uint32_t bars = base + kRingStages * kStageBytes;
  const int n_tiles = N / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {                  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty_bar(bars, stage), phase ^ 1);
          const uint32_t full = full_bar(bars, stage);
          const uint32_t st = base + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load(st, &a_map, kt * kBK, m0, full);
          tma_load(st + kTileBytes, &b_map, kt * kBK, n0, full);
          tma_load(st + 2 * kTileBytes, &b_map, kt * kBK, N + n0, full);
          if (++stage == kRingStages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // a consumer: rows wg * 64 + warp * 16 + g (+ 8) of the tile, wgmma's
  // register layout (g = lane / 4, t = lane % 4; a k-step's values
  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = wg * 64 + (threadIdx.x % 128) / 32 * 16 + g;
  // byte offsets of the 16 values inside a swizzled A tile: 16-byte chunk
  // c of row r lies at chunk c ^ (r % 8)
  uint32_t a_off[16];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = row + 8 * (v & 1);
      const int c = 8 * j + t + 4 * (v >> 1);
      a_off[4 * j + v] =
          r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
    }
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * kBM;
    const int n0 = (tile % n_tiles) * kBN;
    // the tile's sums, each slice's partial added in rounded to nearest:
    // the tensor cores truncate their own fp32 sums, so they carry one
    // slice (12 products) at a time, from zero
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(full_bar(bars, stage), phase);
      const uint32_t st = base + stage * kStageBytes;
      const unsigned char* at = ring + stage * kStageBytes;
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = *reinterpret_cast<const float*>(at + a_off[i]);
        hi[i] = tf32_rna(x);
        lo[i] = tf32_rna(x - __uint_as_float(hi[i]));
      }
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {        // k-steps of 8: 32 bytes each
        const uint64_t b_hi = smem_desc(st + kTileBytes + 32 * j);
        const uint64_t b_lo = smem_desc(st + 2 * kTileBytes + 32 * j);
        wgmma_tf32(part, lo + 4 * j, b_hi, j > 0);
        wgmma_tf32(part, hi + 4 * j, b_lo, 1);
        wgmma_tf32(part, hi + 4 * j, b_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(part);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty_bar(bars, stage));
      if (++stage == kRingStages) { stage = 0; phase ^= 1; }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    // the epilogue: acc[4j + e] holds (row g + 8 (e / 2), column 8j + 2t +
    // e % 2).  Lanes t and t ^ 1 trade halves: an even t stores row g,
    // columns 8j + 2t .. + 3; an odd t row g + 8, columns 8j + 2t - 2 .. + 1
    const bool odd = t & 1;
    const int m = m0 + row + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
      const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2],
                                         acc[4 * j + 3])
                           : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
      if (m < M)
        store_rir(out, residual,
                  static_cast<size_t>(m) * N +
                      rir_col(perm, n0 + 8 * j + 2 * (t & ~1), N, block_n),
                  v);
    }
  }
}

namespace tc {

// cuTensorMapEncodeTiled, from the CUDA driver the runtime has loaded
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// a row-major fp32 (rows x K) tensor in boxes of 128 rows x 32, 128-byte
// swizzle, out-of-bounds elements read as zero
bool tile_map(CUtensorMap* map, const float* p, int rows, int K) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace tc

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

cudaError_t launch_tf32x3(const float* a, const float* planes,
                          const int* perm, const float* residual, float* out,
                          int M, int K, int N, int block_n, cudaStream_t st) {
  using namespace tc;
  if (M <= 0 || K <= 0 || K % 4 != 0 || N <= 0 || N % kBN != 0 ||
      block_n <= 0 || block_n % 64 != 0 || N % block_n != 0 ||
      !aligned16(a) || !aligned16(planes) || !aligned16(out) ||
      (residual != nullptr && !aligned16(residual)))
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!tile_map(&a_map, a, M, K) || !tile_map(&b_map, planes, 2 * N, K))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(
      rir_matmul_kernel_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M - 1) / kBM + 1) *
                          (N / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  rir_matmul_kernel_tf32x3<<<grid, kBlockThreads, kSmemBytes, st>>>(
      a_map, b_map, perm, residual, out, M, K, N, block_n);
  return cudaGetLastError();
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

// The 3xTF32 design: a (M, K) and out (M, N) as above, K % 4 == 0 (TMA's
// 16-byte row stride), N % 128 == 0; planes (2N, K) fp32, row-major: B's hi
// plane (tf32(b), transposed) above its lo plane (tf32(b - hi), transposed),
// from rir_matmul.weight_planes.  a, planes, out and residual 16-byte
// aligned.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rir_matmul_tf32x3(const void* a, const void* planes,
                                 const void* perm, const void* residual,
                                 void* out, int M, int K, int N, int block_n,
                                 void* stream) {
  return static_cast<int>(launch_tf32x3(
      static_cast<const float*>(a), static_cast<const float*>(planes),
      static_cast<const int*>(perm), static_cast<const float*>(residual),
      static_cast<float*>(out), M, K, N, block_n,
      static_cast<cudaStream_t>(stream)));
}
