// linear_scan — chunked gated linear attention (the rwkv6 / mamba2 scan),
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan.py::linear_scan
// (body _kernel).  Per (b, h), with an f32 state h of (dk, dv):
//     h_t = exp(logw_t)[:, None] * h_{t-1} + k_t^T v_t,    y_t = q_t h_t
// q, k (B, H, T, dk), v (B, H, T, dv) in f32 or bf16, log decay (B, H, T,
// dk) f32 and <= 0 -> y (B, H, T, dv) in v's type.  Chunks of kChunk = 64
// steps, each computed as in the TPU kernel and the plain
// ref.linear_scan_chunked, with c the inclusive prefix of logw inside the
// chunk (kept in log2 units, so every exponential is one ex2):
//     y     = (q e^c) h  +  S v,     S[t][s] = sum_d q[t,d] k[s,d]
//                                              e^(c[t,d] - c[s,d]),  s <= t
//     h_new = e^c_T h  +  (k e^(c_T - c))^T v
// The chunk is four blocks of kSub = 16 rows with bases b_j = c[16 j]
// (b_4 = c_T, the chunk's last row).  Every exponent is <= 0, so nothing
// overflows and nothing is clamped (the TPU kernel's _CLAMP is unused there
// too); a decay that underflows inside a chunk gives 0, not NaN:
// - q factors E[t] = q e^(c_t - b_j(t)); k factors K[s] = k e^(b_i(s)+1 -
//   c_s).
// - S between blocks (s in block i < j, t in block j):
//   E[t] . (e^(b_j - b_(i+1)) K[s]), the ref's sub-chunk factorisation with
//   the k side kept once per s and the base moved by a table of 3 x dk
//   factors.  Inside a block: the direct form, one ex2 a (t, s, d).
// - (q e^c) = E e^(b_j); (k e^(c_T - c)) = K e^(c_T - b_(i+1)).
//
// What bounds it on an H100: f32 operations.  At the rwkv6-1.6b training
// shape (B 8, H 32, T 1024, dk = dv = 64, bf16 q/k/v) a chunk is three
// 64x64x64 products plus the masked intra-chunk part, about 7 GFLOP over
// 0.2 GB of operands: ~0.10 ms at 67 TFLOP/s against ~0.06 ms of bytes at
// 3.35 TB/s.  The products stay in f32 FMA (no TF32, no tensor cores), as
// the port's fp32 parity rule asks.
//
// What the design does about it:
// - Two CTAs an SM.  One CTA of 256 threads takes one (b, h) and walks its
//   chunks in a loop with the state in shared memory (the TPU grid's
//   sequential axis).  q, k and v stay in their own type in shared memory
//   and the buffers are reused within a chunk (the scores go where the raw
//   q, k and log decay were; v widened to f32 where E was), so bf16 at
//   64/64 takes 99 KB and two CTAs share an SM: 256 CTAs at the training
//   shape are one wave of 16 warps an SM, and one CTA's loads and barriers
//   overlap the other's products.  There is no cross-chunk prefetch: it
//   would need a second 45 KB of buffers, and so one CTA an SM.
// - Staging by 16-byte cp.async, all of a chunk issued at once; rows past
//   T are zero-filled by the copy (q = k = v = 0, log decay 0) and never
//   stored, so any T runs the kernel.
// - Products in 4 x 4 register tiles with 4 x 4 x 4 steps: every operand is
//   read as float4 along whichever axis is contiguous, so no array is
//   transposed, and rows are padded to an odd number of 16-byte pieces, so
//   four-row reads fall in distinct bank groups.
// - ex2.approx on log2-unit exponents: about 45K a chunk, ~35K of them in
//   the diagonal blocks; 7 barriers a chunk.
// - Work split: warps 0-2 take the 6 blocks of S between blocks (16 tiles
//   each), warps 3-7 the 4 diagonal blocks (10 tiles each, 4 lanes a tile
//   over dk, summed by shuffles); every thread owns one 4 x 4 tile of y and
//   one of the new state.
// There is no backward kernel (the TPU package has none either): autograd
// recomputes through the plain chunked version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblinear_scan.so linear_scan.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/linear_scan.py).
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kMinBlocks = 2;              // CTAs an SM at bf16 64/64
constexpr int kChunk = 64;                 // steps a chunk (L)
constexpr int kSub = 16;                   // rows a block of the chunk
constexpr int kPreThreads = 96;            // S between blocks: 6 x 16 tiles
constexpr int kDiagThreads = 160;          // S inside blocks: 4 x 10 x 4
constexpr size_t kMaxSmem = 232448;        // what a block may opt in to
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kPreThreads + kDiagThreads == kThreads, "work split");

// 2^x for x <= 0; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// four consecutive elements of shared memory as f32 (a bf16 is the high
// half of the f32 with the same bits: exact; element 2j is the low half of
// word j)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* y) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(y[2], y[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// the 6 pairs (j, i), i < j, of S between blocks: warp 0 takes (1,0) and
// (2,1), warp 1 (3,2) and (2,0), warp 2 (3,0) and (3,1)
__device__ __forceinline__ int pair_j(int p) {
  return p < 3 ? p + 1 : (p == 3 ? 2 : 3);
}
__device__ __forceinline__ int pair_i(int p) {
  return p < 3 ? p : (p == 3 ? 0 : p - 4);
}

// Row strides, in elements: raw rows of the chunk padded by 16 bytes,
// f32 arrays by 4 floats (an odd number of 16-byte pieces a row).
template <typename T, int DK, int DV>
struct Layout {
  static constexpr int L = kChunk;
  static constexpr int QS = DK + 16 / (int)sizeof(T);   // raw q, k
  static constexpr int VS = DV + 16 / (int)sizeof(T);   // raw v
  static constexpr int WS = DK + 4;        // log decay, then c (log2 units)
  static constexpr int FS = DK + 4;        // E and K
  static constexpr int SS = L + 4;         // S
  static constexpr int VF = DV + 4;        // v as f32
  static constexpr size_t h_bytes = (size_t)DK * DV * 4;
  static constexpr size_t raw_in = 2 * (size_t)L * QS * sizeof(T) +
                                   (size_t)L * WS * 4;
  static constexpr size_t s_bytes = (size_t)L * SS * 4;
  static constexpr size_t raw_bytes = raw_in > s_bytes ? raw_in : s_bytes;
  static constexpr size_t v_bytes = (size_t)L * VS * sizeof(T);
  static constexpr size_t e_in = (size_t)L * FS * 4;
  static constexpr size_t vf_bytes = sizeof(T) == 4 ? 0 : (size_t)L * VF * 4;
  static constexpr size_t e_bytes = e_in > vf_bytes ? e_in : vf_bytes;
  static constexpr size_t k_bytes = (size_t)L * FS * 4;
  // e^b_j [4][DK], pair factors [6][DK], e^(c_T - b_(i+1)) [4][DK],
  // e^c_T [DK], the scan's segment totals [256]
  static constexpr size_t t_bytes = (15 * (size_t)DK + kThreads) * 4;
  static constexpr size_t bytes =
      h_bytes + raw_bytes + v_bytes + e_bytes + k_bytes + t_bytes;
};

// grid: B * H (one (b, h) each); block: kThreads; dynamic shared:
// Layout<T, DK, DV>::bytes.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
linear_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   T* __restrict__ out, int T_len) {
  using Lo = Layout<T, DK, DV>;
  constexpr int L = kChunk;
  constexpr int QS = Lo::QS, VS = Lo::VS, WS = Lo::WS, FS = Lo::FS;
  constexpr int SS = Lo::SS, VF = Lo::VF;
  constexpr int U = DK / 4;                // float4 pieces of a dk row
  constexpr int NSEG = kThreads / DK;      // the scan's segments a column
  constexpr int SEG = L / NSEG;
  constexpr int YC = DV / 4;               // column tiles of y and h
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 64 && DV <= 64 &&
                    L % NSEG == 0, "tile mapping");

  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);                // [DK][DV]
  unsigned char* raw = smem + Lo::h_bytes;
  T* q_s = reinterpret_cast<T*>(raw);                         // [L][QS]
  T* k_s = q_s + L * QS;                                      // [L][QS]
  float* c_s = reinterpret_cast<float*>(k_s + L * QS);        // [L][WS]
  float* s_s = reinterpret_cast<float*>(raw);                 // [L][SS]
  T* v_s = reinterpret_cast<T*>(raw + Lo::raw_bytes);         // [L][VS]
  float* e_s = reinterpret_cast<float*>(raw + Lo::raw_bytes + Lo::v_bytes);
  float* kf_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(e_s) + Lo::e_bytes);   // [L][FS]
  float* eb_s = kf_s + L * FS;             // [4][DK]  e^b_j
  float* mb_s = eb_s + 4 * DK;             // [6][DK]  e^(b_j - b_(i+1))
  float* mt_s = mb_s + 6 * DK;             // [4][DK]  e^(c_T - b_(i+1))
  float* et_s = mt_s + 4 * DK;             // [DK]     e^c_T
  float* seg_s = et_s + DK;                // [NSEG][DK]
  // v as f32 in the last phase: the raw rows for f32, else widened into
  // E's space
  const float* vf = sizeof(T) == 4 ? reinterpret_cast<const float*>(v_s)
                                   : e_s;
  constexpr int VFS = sizeof(T) == 4 ? VS : VF;

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * T_len * DK;
  const T* kb = k + bh * T_len * DK;
  const T* vb = v + bh * T_len * DV;
  const float* wb = w + bh * T_len * DK;
  T* ob = out + bh * T_len * DV;

  // every thread owns the 4 x 4 tile (rows 4 ty.., cols 4 tc..) of y and,
  // where ty < DK / 4, the same tile of the state
  const int ty = tid / YC;
  const int tc = tid % YC;
  const bool y_owner = ty < L / 4;
  const bool h_owner = ty < DK / 4;

  for (int i = tid; i < DK * DV; i += kThreads) h_s[i] = 0.0f;

  const int n_chunks = (T_len + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int rows = min(L, T_len - t0);   // valid rows of this chunk

    // 1. stage the chunk by 16-byte cp.async; rows past T are zero-filled
    {
      constexpr int QP = DK * (int)sizeof(T) / 16;   // pieces a q/k row
      constexpr int QE = 16 / (int)sizeof(T);
      for (int i = tid; i < L * QP; i += kThreads) {
        const int r = i / QP;
        const int p = i - r * QP;
        const int ok = r < rows ? 16 : 0;
        const size_t g = (size_t)(t0 + (r < rows ? r : 0)) * DK + p * QE;
        cp_async16(q_s + r * QS + p * QE, qb + g, ok);
        cp_async16(k_s + r * QS + p * QE, kb + g, ok);
      }
      for (int i = tid; i < L * U; i += kThreads) {
        const int r = i / U;
        const int p = i - r * U;
        const int ok = r < rows ? 16 : 0;
        cp_async16(c_s + r * WS + p * 4,
                   wb + (size_t)(t0 + (r < rows ? r : 0)) * DK + p * 4, ok);
      }
      constexpr int VP = DV * (int)sizeof(T) / 16;
      for (int i = tid; i < L * VP; i += kThreads) {
        const int r = i / VP;
        const int p = i - r * VP;
        const int ok = r < rows ? 16 : 0;
        cp_async16(v_s + r * VS + p * QE,
                   vb + (size_t)(t0 + (r < rows ? r : 0)) * DV + p * QE, ok);
      }
      cp_async_wait_all();
    }
    __syncthreads();

    // 2. c = inclusive prefix of the log decay down each column, in log2
    //    units: NSEG segments of SEG rows a column, then their offsets
    {
      const int d = tid % DK;
      const int seg = tid / DK;
      float run = 0.0f;
#pragma unroll
      for (int r = seg * SEG; r < (seg + 1) * SEG; ++r) {
        run += c_s[r * WS + d];
        c_s[r * WS + d] = run;
      }
      seg_s[seg * DK + d] = run;
      __syncthreads();
      float off = 0.0f;
      for (int s = 0; s < seg; ++s) off += seg_s[s * DK + d];
#pragma unroll
      for (int r = seg * SEG; r < (seg + 1) * SEG; ++r)
        c_s[r * WS + d] = (c_s[r * WS + d] + off) * kLog2e;
    }
    __syncthreads();

    // 3. factors: E, K and the tables (exponents clamped at 0 against
    //    rounding; c does not increase down a column)
    for (int i = tid; i < L * U; i += kThreads) {
      const int t = i / U;
      const int u4 = (i - t * U) * 4;
      const int j = t / kSub;
      const float4 ct = ld4(c_s + t * WS + u4);
      const float4 bj = ld4(c_s + j * kSub * WS + u4);
      const float4 bn = ld4(c_s + (j == 3 ? L - 1 : (j + 1) * kSub) * WS + u4);
      const float4 qv = ld4(q_s + t * QS + u4);
      const float4 kv = ld4(k_s + t * QS + u4);
      st4(e_s + t * FS + u4,
          make_float4(qv.x * ex2(fminf(ct.x - bj.x, 0.f)),
                      qv.y * ex2(fminf(ct.y - bj.y, 0.f)),
                      qv.z * ex2(fminf(ct.z - bj.z, 0.f)),
                      qv.w * ex2(fminf(ct.w - bj.w, 0.f))));
      st4(kf_s + t * FS + u4,
          make_float4(kv.x * ex2(fminf(bn.x - ct.x, 0.f)),
                      kv.y * ex2(fminf(bn.y - ct.y, 0.f)),
                      kv.z * ex2(fminf(bn.z - ct.z, 0.f)),
                      kv.w * ex2(fminf(bn.w - ct.w, 0.f))));
    }
    for (int d = tid; d < DK; d += kThreads) {
      float b[5];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = c_s[j * kSub * WS + d];
      b[4] = c_s[(L - 1) * WS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) eb_s[j * DK + d] = ex2(fminf(b[j], 0.f));
#pragma unroll
      for (int p = 0; p < 6; ++p)
        mb_s[p * DK + d] = ex2(fminf(b[pair_j(p)] - b[pair_i(p) + 1], 0.f));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mt_s[i * DK + d] = ex2(fminf(b[4] - b[i + 1], 0.f));
      et_s[d] = ex2(fminf(b[4], 0.f));
    }
    __syncthreads();

    // 4. y = (E e^b_j) h, the state's contribution, into registers; then
    //    S between blocks (warps 0-2) or inside blocks (warps 3-7), also
    //    into registers: the raw rows they read are where S goes
    float y[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) y[r][cc] = 0.0f;
    if (y_owner) {
      const float* ebj = eb_s + (4 * ty / kSub) * DK;
      for (int u = 0; u < U; ++u) {
        const float4 eb = ld4(ebj + 4 * u);
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 e = ld4(e_s + (4 * ty + r) * FS + 4 * u);
          a[r][0] = e.x * eb.x;
          a[r][1] = e.y * eb.y;
          a[r][2] = e.z * eb.z;
          a[r][3] = e.w * eb.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 hv = ld4(h_s + (4 * u + kk) * DV + 4 * tc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            y[r][0] = fmaf(a[r][kk], hv.x, y[r][0]);
            y[r][1] = fmaf(a[r][kk], hv.y, y[r][1]);
            y[r][2] = fmaf(a[r][kk], hv.z, y[r][2]);
            y[r][3] = fmaf(a[r][kk], hv.w, y[r][3]);
          }
        }
      }
    }
    float sa[4][4];                        // a 4 x 4 tile of S
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) sa[r][cc] = 0.0f;
    int st0, ss0;                          // its first row and column
    if (tid < kPreThreads) {
      // S[t][s] = sum_d E[t][d] (e^(b_j - b_(i+1)) K[s][d])
      const int p = tid >> 4;
      st0 = pair_j(p) * kSub + ((tid >> 2) & 3) * 4;
      ss0 = pair_i(p) * kSub + (tid & 3) * 4;
      for (int u = 0; u < U; ++u) {
        const float4 mb = ld4(mb_s + p * DK + 4 * u);
        float a[4][4], bk[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 e = ld4(e_s + (st0 + r) * FS + 4 * u);
          a[r][0] = e.x; a[r][1] = e.y; a[r][2] = e.z; a[r][3] = e.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 kv = ld4(kf_s + (ss0 + cc) * FS + 4 * u);
          bk[cc][0] = kv.x * mb.x;
          bk[cc][1] = kv.y * mb.y;
          bk[cc][2] = kv.z * mb.z;
          bk[cc][3] = kv.w * mb.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              sa[r][cc] = fmaf(a[r][kk], bk[cc][kk], sa[r][cc]);
      }
    } else {
      // S[t][s] = sum_d q[t][d] k[s][d] e^(c[t][d] - c[s][d]) inside a
      // block: tile (ta, tb), tb <= ta, of block blk; lane dq of the tile's
      // four sums the float4 pieces dq, dq + 4, ... of dk
      const int x = tid - kPreThreads;
      const int dq = x & 3;
      const int ti = x >> 2;
      const int blk = ti / 10;
      const int tt = ti - blk * 10;
      const int ta = (tt >= 1) + (tt >= 3) + (tt >= 6);
      const int tb = tt - ta * (ta + 1) / 2;
      st0 = blk * kSub + 4 * ta;
      ss0 = blk * kSub + 4 * tb;
      for (int u = dq; u < U; u += 4) {
        float4 qa[4], ca[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = ld4(q_s + (st0 + r) * QS + 4 * u);
          ca[r] = ld4(c_s + (st0 + r) * WS + 4 * u);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 kv = ld4(k_s + (ss0 + cc) * QS + 4 * u);
          const float4 cv = ld4(c_s + (ss0 + cc) * WS + 4 * u);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // past the diagonal (s > t) the exponent is clamped and the
            // term dropped below
            float acc = sa[r][cc];
            acc = fmaf(qa[r].x * kv.x, ex2(fminf(ca[r].x - cv.x, 0.f)), acc);
            acc = fmaf(qa[r].y * kv.y, ex2(fminf(ca[r].y - cv.y, 0.f)), acc);
            acc = fmaf(qa[r].z * kv.z, ex2(fminf(ca[r].z - cv.z, 0.f)), acc);
            acc = fmaf(qa[r].w * kv.w, ex2(fminf(ca[r].w - cv.w, 0.f)), acc);
            sa[r][cc] = acc;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float s = sa[r][cc];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          sa[r][cc] = st0 + r >= ss0 + cc ? s : 0.0f;
        }
    }
    __syncthreads();                       // raw q, k, c and E are read

    // 5. S into the raw rows' space; v widened to f32 into E's
    if (tid < kPreThreads) {
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(s_s + (st0 + r) * SS + ss0, sa[r]);
    } else {
      // the four lanes of a tile hold the same sums: lane dq stores row dq
      const int dq = (tid - kPreThreads) & 3;
      float row[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        row[cc] = dq == 0 ? sa[0][cc] : dq == 1 ? sa[1][cc]
                : dq == 2 ? sa[2][cc] : sa[3][cc];
      store4(s_s + (st0 + dq) * SS + ss0, row);
    }
    if (sizeof(T) != 4) {
      constexpr int VU = DV / 4;
      for (int i = tid; i < L * VU; i += kThreads) {
        const int t = i / VU;
        const int u4 = (i - t * VU) * 4;
        st4(e_s + t * VF + u4, ld4(v_s + t * VS + u4));
      }
    }
    __syncthreads();

    // 6. y += S v over the columns up to the tile's last row; store.  The
    //    new state: h = e^c_T h + sum_i e^(c_T - b_(i+1)) (K_i^T v_i) over
    //    the four blocks i of rows
    if (y_owner) {
      for (int sq = 0; sq <= ty; ++sq) {
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 sv = ld4(s_s + (4 * ty + r) * SS + 4 * sq);
          a[r][0] = sv.x; a[r][1] = sv.y; a[r][2] = sv.z; a[r][3] = sv.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 vv = ld4(vf + (4 * sq + kk) * VFS + 4 * tc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            y[r][0] = fmaf(a[r][kk], vv.x, y[r][0]);
            y[r][1] = fmaf(a[r][kk], vv.y, y[r][1]);
            y[r][2] = fmaf(a[r][kk], vv.z, y[r][2]);
            y[r][3] = fmaf(a[r][kk], vv.w, y[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * ty + r < rows) store4(ob + (size_t)(t0 + 4 * ty + r) * DV +
                                          4 * tc, y[r]);
      }
    }
    if (h_owner) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float blk[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) blk[r][cc] = 0.0f;
#pragma unroll 4
        for (int s = i * kSub; s < (i + 1) * kSub; ++s) {
          const float4 kv = ld4(kf_s + s * FS + 4 * ty);
          const float4 vv = ld4(vf + s * VFS + 4 * tc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = comp(kv, r);
            blk[r][0] = fmaf(a, vv.x, blk[r][0]);
            blk[r][1] = fmaf(a, vv.y, blk[r][1]);
            blk[r][2] = fmaf(a, vv.z, blk[r][2]);
            blk[r][3] = fmaf(a, vv.w, blk[r][3]);
          }
        }
        const float4 mt = ld4(mt_s + i * DK + 4 * ty);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(comp(mt, r), blk[r][cc], acc[r][cc]);
      }
      const float4 et = ld4(et_s + 4 * ty);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* hr = h_s + (4 * ty + r) * DV + 4 * tc;
        const float4 hv = ld4(hr);
        st4(hr, make_float4(fmaf(comp(et, r), hv.x, acc[r][0]),
                            fmaf(comp(et, r), hv.y, acc[r][1]),
                            fmaf(comp(et, r), hv.z, acc[r][2]),
                            fmaf(comp(et, r), hv.w, acc[r][3])));
      }
    }
    __syncthreads();                       // before the next chunk's stage
  }
}

// two CTAs share an SM (228 KB, 1 KB reserved a CTA) at the paths' shape
static_assert(2 * (Layout<__nv_bfloat16, 64, 64>::bytes + 1024) <= 233472,
              "two bf16 64/64 CTAs an SM");

template <typename T, int DK, int DV>
int launch_dims(const void* q, const void* k, const void* v, const void* w,
                void* out, int BH, int T_len, cudaStream_t st) {
  constexpr size_t smem = Layout<T, DK, DV>::bytes;
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
      e = cudaFuncSetAttribute(linear_scan_kernel<T, DK, DV>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
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
// row-major, contiguous and 16-byte aligned; dk and dv each 16, 32 or 64.
// Returns the cudaError_t of the launch (0 on success).
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
