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
// bytes over 3.35 TB/s.  So: no tensor cores, and every byte in flight as
// early as possible.
//
// What the design does about it:
// - Split S, one wave.  Each CTA takes one (split, KV head h and a group of
//   at most kMaxGroup of its query heads, b).  A split is kWarpTiles tiles
//   of kWarpRows positions for each of 4 warps: 256 positions (2 warps,
//   128, where four warps' rings would not fit shared memory: f32 with
//   D > 128).  The split length depends on D and the type only, so which
//   splits a row has depends on its length, never on B or on the other
//   rows: a row's result is the same whether it is decoded alone or in a
//   batch.  At the llama shape: 256 CTAs of 128 threads, 107 KB of shared
//   memory each, two an SM, all resident at once.
// - A ring in each warp.  A warp takes the split's tiles warp and warp + 4.
//   It puts K0, V0 and K1 in flight at once by 16-byte cp.async into the
//   three slots of its ring (keeping bf16 as bf16), computes the scores of
//   tile 0 while V0 and K1 are on their way, and sends V1 into K0's slot
//   once tile 0 is done (sending it as soon as K0 is read measured 4%
//   slower): three quarters of the CTA's bytes are requested before it
//   computes anything, and the rest while it computes.  Rows are
//   padded by 16 bytes, so eight lanes reading eight rows hit eight
//   distinct bank groups.
// - Scores: a lane a position.  Lane p computes the full dot product of K
//   row p with each query head (two partial sums a head), reading K as
//   16-byte packed pieces and q as f32 from shared memory (every lane reads
//   the same q address: one broadcast), so no score needs a reduction
//   across lanes.  The online softmax of a tile's 32 positions is then two
//   warp reductions a head.
// - P.V: lanes across D.  Each lane owns 8-byte pieces of the V row (four
//   bf16 or two f32) and keeps its part of the G x D accumulator in
//   registers, four rows at a time; p comes from shared memory as a
//   broadcast.
// - One launch, merged in a fixed order.  The CTA merges its warps' (m, l,
//   acc) in warp order.  A row whose length fits one split is then done;
//   otherwise each CTA writes its partial to a workspace, fences, and counts
//   itself in a per-(b, h, group) counter; the CTA that arrives last merges
//   the row's valid splits in split order (m* = max m_s, out = sum
//   exp(m_s - m*) acc_s / max(sum exp(m_s - m*) l_s, 1e-30), the TPU
//   kernel's clamp) and sets the counter back to 0, so no memset runs a
//   call.  The counters and the partials belong to the caller's stream;
//   two streams must never share them.
// - No work past the length.  A tile whose rows all lie at or past
//   min(lengths[b], S) is not loaded; the last tile loads only its valid
//   rows, and its masked lanes score -1e30 (as the TPU kernel masks); P.V
//   never touches a row past the length.
//
// A row whose length is <= 0 has no valid position: its output is 0 (the
// TPU kernel gives the mean of V, the plain versions NaN); decode always
// passes length + 1 >= 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgqa_decode.so gqa_decode.cu
// Plain C interface, bound with ctypes (repro_torch/kernels/gqa_decode.py).
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpRows = 32;              // K/V rows a tile: one a lane
constexpr int kWarpTiles = 2;              // tiles a warp takes in a split
constexpr int kSlots = 3;                  // tile buffers a warp: the ring
constexpr int kMaxWarps = 4;               // warps a CTA (2 for wide f32 rows)
constexpr int kMaxGroup = 8;               // query heads a CTA at most
constexpr int kRowPad = 16;                // bytes after each K/V row
constexpr int kMinD = 16;
constexpr int kMaxD = 256;
constexpr size_t kMaxSmem = 232448;        // what a block may opt in to
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of one 16-byte piece / one 8-byte piece of a row.
template <typename T> constexpr int kPiece16 = 16 / sizeof(T);
template <typename T> constexpr int kPiece8 = 8 / sizeof(T);

// a 16-byte piece of shared memory as f32: 4 floats, or 8 bf16 (a bf16 is
// the high half of the f32 with the same bits, so the widening is exact;
// element 2j is the low half of word j)
__device__ __forceinline__ void widen16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
// an 8-byte piece: 2 floats or 4 bf16
__device__ __forceinline__ void widen8(const float* p, float* f) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  f[0] = x.x; f[1] = x.y;
}
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__host__ __device__ constexpr int row_bytes(int D, int elem) {
  return D * elem + kRowPad;
}

// dynamic shared memory of a CTA of nw warps taking gc heads: each warp's
// ring of kSlots tiles of K or V rows, q (gc x D, f32), p (nw x gc x 32),
// (m, l) (nw x gc) and the arrival flag.  Each warp's partial acc (gc x D,
// f32) goes into its second slot at the end.
__host__ __device__ constexpr size_t smem_bytes(int nw, int gc, int D,
                                                int elem) {
  return (size_t)nw * kSlots * kWarpRows * row_bytes(D, elem) +
         4 * ((size_t)gc * D + (size_t)nw * gc * kWarpRows +
              (size_t)nw * gc * 2) +
         16;
}

// warps a CTA: four where four warps' rings fit with the largest group
__host__ __device__ constexpr int warps_for(int D, int elem) {
  return smem_bytes(kMaxWarps, kMaxGroup, D, elem) <= kMaxSmem
             ? kMaxWarps
             : kMaxWarps / 2;
}

// positions a split (one CTA) holds
__host__ __device__ constexpr int split_for(int D, int elem) {
  return warps_for(D, elem) * kWarpTiles * kWarpRows;
}

// The nv rows (nv <= 32) of one tile, from src (row_stride elements apart)
// into dst (rb bytes apart), by 16-byte cp.async: the warp's lanes take the
// row-major pieces lane, lane + 32, ... (row and piece stepped, not
// divided, in the loop).
template <typename T>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src,
                                          int nv, int pieces,
                                          size_t row_stride, int rb,
                                          int lane) {
  const int step_r = 32 / pieces;
  const int step_c = 32 - step_r * pieces;
  int r = lane / pieces;
  int c = lane - r * pieces;
  for (int i = lane; i < nv * pieces; i += 32) {
    cp_async16(dst + r * rb + c * 16, src + r * row_stride + c * kPiece16<T>);
    r += step_r;
    c += step_c;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

// Lane p's scores against the ng query heads of q_s, over K row p of the
// tile at k_t: two partial sums a head (even and odd pieces; pieces is
// even), for two independent chains.
template <typename T, int GC>
__device__ __forceinline__ void tile_scores(const unsigned char* k_t,
                                            const float* q_s, int ng, int D,
                                            int pieces, int rb, int lane,
                                            float* sc) {
  constexpr int EC = kPiece16<T>;
  float s0[GC], s1[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) s0[g] = s1[g] = 0.0f;
  const T* kr = reinterpret_cast<const T*>(k_t + lane * rb);
  for (int c = 0; c < pieces; c += 2) {
    float k0[EC], k1[EC];
    widen16(kr + c * EC, k0);
    widen16(kr + (c + 1) * EC, k1);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < ng) {
        const float* qr = q_s + g * D + c * EC;
#pragma unroll
        for (int e = 0; e < EC; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + e);
          const float4 b = *reinterpret_cast<const float4*>(qr + EC + e);
          s0[g] = fmaf(a.x, k0[e], s0[g]);
          s1[g] = fmaf(b.x, k1[e], s1[g]);
          s0[g] = fmaf(a.y, k0[e + 1], s0[g]);
          s1[g] = fmaf(b.y, k1[e + 1], s1[g]);
          s0[g] = fmaf(a.z, k0[e + 2], s0[g]);
          s1[g] = fmaf(b.z, k1[e + 2], s1[g]);
          s0[g] = fmaf(a.w, k0[e + 3], s0[g]);
          s1[g] = fmaf(b.w, k1[e + 3], s1[g]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) sc[g] = s0[g] + s1[g];
}

// acc[g][.] += sum_p p[g][p] V[p][.] over the tile's nv rows at v_t; the
// lane owns 8-byte pieces lane + 32 r of each row; p from pw ([GC][32])
template <typename T, int GC, int UR>
__device__ __forceinline__ void tile_pv(const unsigned char* v_t,
                                        const float* pw, int ng, int nv,
                                        int units, int rb, int lane,
                                        float (&acc)[GC][UR * kPiece8<T>]) {
  constexpr int E = kPiece8<T>;
  int p = 0;
  for (; p + 4 <= nv; p += 4) {
    float4 pg[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g)
      pg[g] = *reinterpret_cast<const float4*>(pw + g * kWarpRows + p);
#pragma unroll
    for (int r = 0; r < UR; ++r) {
      const int u = lane + 32 * r;
      if (u < units) {
        float ve[4][E];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          widen8(reinterpret_cast<const T*>(v_t + (p + j) * rb) + u * E,
                 ve[j]);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < ng) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[g][r * E + e] =
                    fmaf(comp(pg[g], j), ve[j][e], acc[g][r * E + e]);
          }
        }
      }
    }
  }
  for (; p < nv; ++p) {
#pragma unroll
    for (int r = 0; r < UR; ++r) {
      const int u = lane + 32 * r;
      if (u < units) {
        float ve[E];
        widen8(reinterpret_cast<const T*>(v_t + p * rb) + u * E, ve);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < ng) {
            const float pv = pw[g * kWarpRows + p];
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[g][r * E + e] = fmaf(pv, ve[e], acc[g][r * E + e]);
          }
        }
      }
    }
  }
}

// The online softmax of one tile: lanes past the tile's nv rows score
// -1e30 and get p = 0 (lane 0 is always valid); m, l and the acc scale
// alpha are the same in every lane.
template <int GC>
__device__ __forceinline__ void tile_softmax(const float* sc, float scale,
                                             int ng, int nv, int lane,
                                             float* m, float* l,
                                             float* alpha, float* pw) {
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      const float s = lane < nv ? sc[g] * scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float p = expf(s - m_new);
      alpha[g] = expf(m[g] - m_new);       // 0 on the first tile
      l[g] = l[g] * alpha[g] + warp_sum(p);
      m[g] = m_new;
      pw[g * kWarpRows + lane] = p;
    }
  }
}

// grid: (n_split, Hkv * n_groups, B); block: 32 * warps_for(D); dynamic
// shared: smem_bytes.  GC: heads a CTA takes (its group, ng <= GC of them
// used); UR: 8-byte pieces of a V row a lane owns at most.
template <typename T, int GC, int UR>
__global__ void __launch_bounds__(kMaxWarps * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  int* __restrict__ counters, float* __restrict__ part_ml,
                  float* __restrict__ part_acc, T* __restrict__ out, int Hq,
                  int Hkv, int S, int D, int n_split, float scale) {
  constexpr int E = kPiece8<T>;            // elements a lane's 8-byte piece
  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int n_groups = (G + GC - 1) / GC;
  const int h = blockIdx.y / n_groups;
  const int g0 = (blockIdx.y - h * n_groups) * GC;
  const int ng = min(GC, G - g0);
  const int nw = blockDim.x / 32;
  const int split_len = nw * kWarpTiles * kWarpRows;
  const int len = min(lengths[b], S);
  const int n_valid = len > 0 ? (len + split_len - 1) / split_len : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this group's query rows h*G + g0 .. + ng - 1 of q[b] and out[b]
  const size_t qrow0 = (size_t)b * Hq + (size_t)h * G + g0;
  T* outb = out + qrow0 * D;
  if (split >= n_valid) {
    if (split == 0) {                      // length <= 0: the output is 0
      for (int i = tid; i < ng * D; i += blockDim.x) outb[i] = from_f32<T>(0.f);
    }
    return;                                // nothing valid: never merged
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = row_bytes(D, sizeof(T));
  const int slot = kWarpRows * rb;
  unsigned char* ring = smem + (size_t)warp * kSlots * slot;
  float* q_s = reinterpret_cast<float*>(smem + (size_t)nw * kSlots * slot);
  float* p_s = q_s + GC * D;               // [nw][GC][32]
  float* ml_s = p_s + nw * GC * kWarpRows; // [nw][GC][2]
  int* flag = reinterpret_cast<int*>(ml_s + nw * GC * 2);

  // 1. the warp's tiles are the split's tiles warp and warp + nw (32 rows
  //    each); K0, V0 and K1 go in flight at once into the ring's three
  //    slots, V1 later into K0's
  const int s0 = split * split_len;
  const int p0 = s0 + warp * kWarpRows;
  const int p1 = p0 + nw * kWarpRows;
  const int nv0 = max(0, min(kWarpRows, len - p0));
  const int nv1 = max(0, min(kWarpRows, len - p1));
  const int pieces = D / kPiece16<T>;      // 16-byte pieces a row
  const size_t row_stride = (size_t)Hkv * D;   // elements between positions
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;
  if (nv0 > 0) {
    copy_tile(ring, kb + (size_t)p0 * row_stride, nv0, pieces, row_stride,
              rb, lane);
    cp_async_commit();
    copy_tile(ring + slot, vb + (size_t)p0 * row_stride, nv0, pieces,
              row_stride, rb, lane);
    cp_async_commit();
  }
  if (nv1 > 0) {
    copy_tile(ring + 2 * slot, kb + (size_t)p1 * row_stride, nv1, pieces,
              row_stride, rb, lane);
    cp_async_commit();
  }
  const T* qb = q + qrow0 * D;
  for (int i = tid; i < ng * D; i += blockDim.x) q_s[i] = to_f32(qb[i]);
  __syncthreads();                         // q_s is complete

  if (nv0 > 0) {
    float* pw = p_s + warp * GC * kWarpRows;
    const int units = D / E;
    float m[GC], l[GC], alpha[GC], sc[GC];
    float acc[GC][UR * E];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = kNegInf;
      l[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < UR * E; ++i) acc[g][i] = 0.0f;
    }
    // 2. tile 0: scores on K0 while V0 (and K1) are on their way; then V1
    //    into K0's slot, once every lane is past its K0 reads
    if (nv1 > 0) cp_async_wait<2>(); else cp_async_wait<1>();
    __syncwarp();                          // every lane's K0 pieces landed
    tile_scores<T, GC>(ring, q_s, ng, D, pieces, rb, lane, sc);
    tile_softmax<GC>(sc, scale, ng, nv0, lane, m, l, alpha, pw);
    if (nv1 > 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();                          // V0 landed; p written
    tile_pv<T, GC, UR>(ring + slot, pw, ng, nv0, units, rb, lane, acc);
    if (nv1 > 0) {
      __syncwarp();
      copy_tile(ring, vb + (size_t)p1 * row_stride, nv1, pieces, row_stride,
                rb, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();                        // K1 landed
      tile_scores<T, GC>(ring + 2 * slot, q_s, ng, D, pieces, rb, lane, sc);
      tile_softmax<GC>(sc, scale, ng, nv1, lane, m, l, alpha, pw);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int i = 0; i < UR * E; ++i) acc[g][i] *= alpha[g];
      cp_async_wait<0>();
      __syncwarp();                        // V1 landed; p written
      tile_pv<T, GC, UR>(ring, pw, ng, nv1, units, rb, lane, acc);
    }
    // the warp's partial: acc into its second slot (V0), once every lane
    // is past its reads of it; (m, l) beside
    __syncwarp();
    float* a_w = reinterpret_cast<float*>(ring + slot);
#pragma unroll
    for (int r = 0; r < UR; ++r) {
      const int u = lane + 32 * r;
      if (u < units) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < ng) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              a_w[g * D + u * E + e] = acc[g][r * E + e];
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < ng) {
          ml_s[(warp * GC + g) * 2] = m[g];
          ml_s[(warp * GC + g) * 2 + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // 4. the CTA's partial: its valid warps merged in warp order
  const int nwv = min(nw, (len - s0 + kWarpRows - 1) / kWarpRows);
  const size_t base = ((size_t)b * Hkv + h) * n_split;   // split 0 of (b, h)
  for (int i = tid; i < ng * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    float mc = kNegInf;
    for (int w = 0; w < nwv; ++w) mc = fmaxf(mc, ml_s[(w * GC + g) * 2]);
    float lc = 0.0f, ac = 0.0f;
    for (int w = 0; w < nwv; ++w) {
      const float e = expf(ml_s[(w * GC + g) * 2] - mc);
      lc += e * ml_s[(w * GC + g) * 2 + 1];
      const float* a_w = reinterpret_cast<const float*>(
          smem + (size_t)(w * kSlots + 1) * slot);
      ac += e * a_w[g * D + d];
    }
    if (n_valid == 1) {
      // the row's only split: the merge below with one split, whose
      // weights are exp(0) = 1, gives exactly this
      outb[i] = from_f32<T>(ac * (1.0f / fmaxf(lc, 1e-30f)));
    } else {
      const size_t r = (base + split) * G + g0 + g;
      part_acc[r * D + d] = ac;
      if (d == 0) {
        part_ml[2 * r] = mc;
        part_ml[2 * r + 1] = lc;
      }
    }
  }
  if (n_valid == 1) return;

  // 5. count this CTA in; the last of the row's valid splits merges them
  __threadfence();                         // the partial is visible first
  __syncthreads();
  int* counter = counters + (size_t)b * gridDim.y + blockIdx.y;
  if (tid == 0) *flag = atomicAdd(counter, 1) == n_valid - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int i = tid; i < ng * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    const size_t r0 = base * G + g0 + g;   // split s at r0 + s * G
    float m_star = kNegInf;
    for (int s = 0; s < n_valid; ++s)
      m_star = fmaxf(m_star, __ldcg(part_ml + 2 * (r0 + (size_t)s * G)));
    float l_sum = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
      const size_t r = r0 + (size_t)s * G;
      l_sum += expf(__ldcg(part_ml + 2 * r) - m_star) *
               __ldcg(part_ml + 2 * r + 1);
    }
    const float inv = 1.0f / fmaxf(l_sum, 1e-30f);
    float o = 0.0f;
    for (int s = 0; s < n_valid; ++s) {
      const size_t r = r0 + (size_t)s * G;
      o += expf(__ldcg(part_ml + 2 * r) - m_star) * __ldcg(part_acc + r * D + d);
    }
    outb[i] = from_f32<T>(o * inv);
  }
  if (tid == 0) *counter = 0;              // every valid split has counted
}

template <typename T, int GC, int UR>
int launch_kernel(const void* q, const void* k, const void* v,
                  const void* lengths, void* counters, void* part_ml,
                  void* part_acc, void* out, int Hq, int Hkv, int S, int D,
                  int n_split, float scale, dim3 grid, int nw, size_t smem,
                  cudaStream_t st) {
  auto* kern = gqa_decode_kernel<T, GC, UR>;
  // the opt-in (and the carveout that lets three CTAs share an SM) is set
  // once per instantiation and device, not per launch
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted.fetch_or(bit, std::memory_order_release);
  }
  kern<<<grid, nw * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<int*>(counters), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), static_cast<T*>(out), Hq, Hkv, S, D,
      n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GC>
int launch_gc(const void* q, const void* k, const void* v, const void* lengths,
              void* counters, void* part_ml, void* part_acc, void* out,
              int Hq, int Hkv, int S, int D, int n_split, float scale,
              dim3 grid, int nw, size_t smem, cudaStream_t st) {
  // 8-byte pieces a V row has, over the 32 lanes
  const int ur = (D / kPiece8<T> + 31) / 32;
#define GQA_LAUNCH(UR)                                                      \
  return launch_kernel<T, GC, UR>(q, k, v, lengths, counters, part_ml,     \
                                  part_acc, out, Hq, Hkv, S, D, n_split,   \
                                  scale, grid, nw, smem, st)
  if (ur <= 1) GQA_LAUNCH(1);
  if (ur <= 2) GQA_LAUNCH(2);
  GQA_LAUNCH(4);
#undef GQA_LAUNCH
}

// the smallest instantiated group width holding min(G, kMaxGroup) heads
__host__ __device__ constexpr int group_width(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : kMaxGroup;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* counters, void* part_ml, void* part_acc, void* out, int B,
           int Hq, int Hkv, int S, int D, int n_split, float scale,
           void* stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      S <= 0 || D < kMinD || D > kMaxD || D % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = Hq / Hkv;
  const int gc = group_width(G);
  const int n_groups = (G + gc - 1) / gc;
  const int nw = warps_for(D, sizeof(T));
  const int split = split_for(D, sizeof(T));
  if ((long long)Hkv * n_groups > 65535 ||
      n_split != (S + split - 1) / split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(nw, gc, D, sizeof(T));
  const dim3 grid(n_split, Hkv * n_groups, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gc) {
    case 1: return launch_gc<T, 1>(q, k, v, lengths, counters, part_ml,
                                   part_acc, out, Hq, Hkv, S, D, n_split,
                                   scale, grid, nw, smem, st);
    case 2: return launch_gc<T, 2>(q, k, v, lengths, counters, part_ml,
                                   part_acc, out, Hq, Hkv, S, D, n_split,
                                   scale, grid, nw, smem, st);
    case 4: return launch_gc<T, 4>(q, k, v, lengths, counters, part_ml,
                                   part_acc, out, Hq, Hkv, S, D, n_split,
                                   scale, grid, nw, smem, st);
    default: return launch_gc<T, kMaxGroup>(q, k, v, lengths, counters,
                                            part_ml, part_acc, out, Hq, Hkv,
                                            S, D, n_split, scale, grid, nw,
                                            smem, st);
  }
}

}  // namespace

// q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D): row-major,
// contiguous, 16-byte aligned, all of one type.  lengths is int32[B] on the
// device.  What the caller keeps for one stream: counters int32[B, Hkv,
// n_groups], all 0 before the first call (the kernel leaves them 0), and
// the partials part_ml f32[B, Hkv, n_split, G, 2] and part_acc f32[B, Hkv,
// n_split, G, D]; n_split = ceil(S / split_for(D, elem)), checked.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gqa_decode_f32(const void* q, const void* k, const void* v,
                              const void* lengths, void* counters,
                              void* part_ml, void* part_acc, void* out,
                              int B, int Hq, int Hkv, int S, int D,
                              int n_split, float scale, void* stream) {
  return launch<float>(q, k, v, lengths, counters, part_ml, part_acc, out, B,
                       Hq, Hkv, S, D, n_split, scale, stream);
}

extern "C" int gqa_decode_bf16(const void* q, const void* k, const void* v,
                               const void* lengths, void* counters,
                               void* part_ml, void* part_acc, void* out,
                               int B, int Hq, int Hkv, int S, int D,
                               int n_split, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, counters, part_ml, part_acc,
                               out, B, Hq, Hkv, S, D, n_split, scale, stream);
}
