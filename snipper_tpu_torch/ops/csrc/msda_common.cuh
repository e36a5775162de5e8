// What the two MSDA kernels (msda_forward.cu, msda_backward.cu) share: the
// level table, the thread-group plan, the tap geometry in grid_sample's steps
// and 16-byte vector loads and stores.
//
// Thread groups. One group of G threads serves one (n, q, h); thread j of
// the group holds the channel vectors j, j + G, ... of the row, a vector
// being 16 bytes (4 f32 or 8 bf16 channels) when D is a multiple of that
// and the rows are aligned, else one channel (the scalar path, chosen from
// the sizes). Groups are packed over the whole block, across warps (G = 12
// at D = 48 in f32: 21 groups on 252 of 256 threads; G = 6 in bf16: 42
// groups). A block owns one (n, h) and a run of consecutive queries, one
// per group, so neighbouring queries, whose taps touch neighbouring
// pixels, share the block's L1.
//
// Taps. A query has L * P taps per head. The block computes each tap's
// coordinates, corner weights and in-map masks once, one tap per thread,
// into a table in shared memory; each group then reads its taps from the
// table (three 16-byte broadcasts per tap) instead of recomputing them on
// every channel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_THREADS 256

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// How one launch lays (n, q, h) groups and taps over threads.
struct Plan {
  int nv;    // vectors per (pixel, head) row: D / channels per vector
  int g;     // threads per group: min(nv, 32)
  int vpl;   // vectors per thread: ceil(nv / g)
  int qb;    // queries (groups) per block: MSDA_THREADS / g
  int tc;    // taps per group in one table chunk: min(L * P, threads / qb)
  int runs;  // blocks per (n, h): ceil(Lq / qb)
};

// One tap: the grid_sample weights along each axis (the corner weights are
// their products), the attention weight, a * W_l and a * H_l (the factors of
// d_loc), and the pixel row of each corner within the frame (nw, ne, sw,
// se), -1 where the corner lies off the map. 48 bytes, read as three
// 16-byte shared loads.
struct __align__(16) Tap {
  float a, dx0, dx1, dy0;
  float dy1, afw, afh, pad;
  int row[4];
};

static inline int fill_levels(int L, const int64_t* shapes,
                              const int64_t* starts, Levels* lv) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return 0;
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    lv->h[l] = l < L ? (int)shapes[2 * l] : 0;
    lv->w[l] = l < L ? (int)shapes[2 * l + 1] : 0;
    lv->start[l] = l < L ? (int)starts[l] : 0;
  }
  return 1;
}

static inline Plan make_plan(int D, int vec, int LP, int64_t Lq) {
  Plan p;
  p.nv = D / vec;
  p.g = p.nv < 32 ? p.nv : 32;
  p.vpl = (p.nv + p.g - 1) / p.g;
  p.qb = MSDA_THREADS / p.g;
  p.tc = LP < MSDA_THREADS / p.qb ? LP : MSDA_THREADS / p.qb;
  p.runs = (int)((Lq + p.qb - 1) / p.qb);
  return p;
}

// The frame n, head h and query run of this block: blocks run (n, h)
// after (n, h), each over its runs of queries in order.
__device__ __forceinline__ void block_coords(const Plan& pl, int H, int& n,
                                             int& h, int& run) {
  const int nh = blockIdx.x / pl.runs;
  run = blockIdx.x - nh * pl.runs;
  n = nh / H;
  h = nh - n * H;
}

static inline bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// Offsets fit in int32 where every tensor of the launch has < 2^31 elements.
static inline bool fits_int32(int64_t N, int64_t S, int64_t H, int64_t D,
                              int64_t Lq, int64_t LP) {
  const int64_t lim = (int64_t)1 << 31;
  return N * S * H * D < lim && N * Lq * H * D < lim &&
         N * Lq * H * LP * 2 < lim;
}

// Tap geometry in grid_sample's steps (align_corners=False, zeros off the
// map): g = 2u - 1, x = ((g + 1) * W - 1) / 2 (tap_xy), floor, and the
// weights x1 - x, x - x0 along each axis. The in-map tests are made on
// floats, so a location far off the map never overflows an integer.
__device__ __forceinline__ float2 tap_xy(float u, float v, const Levels& lv,
                                         int l) {
  const float gx = 2.f * u - 1.f;
  const float gy = 2.f * v - 1.f;
  return make_float2(((gx + 1.f) * (float)lv.w[l] - 1.f) / 2.f,
                     ((gy + 1.f) * (float)lv.h[l] - 1.f) / 2.f);
}

__device__ __forceinline__ Tap make_tap(float u, float v, float a,
                                        const Levels& lv, int l) {
  const int hl = lv.h[l], wl = lv.w[l];
  const float fw = (float)wl, fh = (float)hl;
  const float2 xy = tap_xy(u, v, lv, l);
  const float x = xy.x, y = xy.y;
  const float x0f = floorf(x), y0f = floorf(y);
  const float x1f = x0f + 1.f, y1f = y0f + 1.f;
  Tap t;
  t.a = a;
  t.dx1 = x1f - x;
  t.dx0 = x - x0f;
  t.dy1 = y1f - y;
  t.dy0 = y - y0f;
  t.afw = a * fw;
  t.afh = a * fh;
  const bool in_x0 = x0f >= 0.f && x0f < fw, in_x1 = x1f >= 0.f && x1f < fw;
  const bool in_y0 = y0f >= 0.f && y0f < fh, in_y1 = y1f >= 0.f && y1f < fh;
  // clamped first, so the conversion stays in range; exact wherever a
  // corner is on the map
  const int xi = (int)fminf(fmaxf(x0f, -1.f), fw);
  const int yi = (int)fminf(fmaxf(y0f, -1.f), fh);
  const int nw = lv.start[l] + yi * wl + xi;
  t.row[0] = in_y0 && in_x0 ? nw : -1;
  t.row[1] = in_y0 && in_x1 ? nw + 1 : -1;
  t.row[2] = in_y1 && in_x0 ? nw + wl : -1;
  t.row[3] = in_y1 && in_x1 ? nw + wl + 1 : -1;
  return t;
}

// Fill the block's tap table for the chunk [t0, t0 + tc) of each group's
// taps: thread s computes tap t0 + s % tc of group s / tc (the slot s).
// ``row0`` is the first element of (n, q0, h)'s row of attn, where q0 is
// the block's first query; queries advance by ``q_stride`` elements.
template <typename idx_t>
__device__ __forceinline__ void fill_taps(Tap* table, const Plan& pl,
                                          int t0, int LP, int P, int q0,
                                          int Lq, idx_t row0, idx_t q_stride,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ attn,
                                          const Levels& lv) {
  const int s = threadIdx.x, sg = s / pl.tc, t = t0 + s % pl.tc;
  if (sg < pl.qb && q0 + sg < Lq && t < LP) {
    const idx_t ti = row0 + (idx_t)sg * q_stride + t;
    const float2 uv = __ldg(reinterpret_cast<const float2*>(loc) + ti);
    table[s] = make_tap(uv.x, uv.y, __ldg(attn + ti), lv, t / P);
  }
}

// ---- 16-byte vectors of VEC channels, converted to and from f32
template <typename T, int VEC>
struct VecIO;

template <>
struct VecIO<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct VecIO<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 x;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <>
struct VecIO<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

// The four corner vectors of a tap (zeros for a corner off the map) at
// p, the thread's first channel of the frame's head slice.
template <typename T, int VEC, typename idx_t>
__device__ __forceinline__ void load_corners(const Tap& tp, const T* p,
                                             idx_t row_stride,
                                             float (&v)[4][VEC]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (tp.row[c] >= 0) {
      VecIO<T, VEC>::load(p + (idx_t)tp.row[c] * row_stride, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[c][e] = 0.f;
    }
  }
}
