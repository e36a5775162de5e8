// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the backward of K1's trainable driver: `_pallas_with_vjp`
// (snipper_tpu/ops/pallas_deform.py:391-402), whose custom VJP is the XLA
// `core_backward` (snipper_tpu/ops/deform_attn.py:458-474) on the TPU. It
// is the VJP of the function `msda_forward.cu` computes,
//
//   out[n, q, h*D + d] = sum_{l, p} attn[n, q, h, l, p]
//                        * bilinear(value[n, start_l:, h, d], loc[n, q, h, l, p])
//
// for all levels in one call, with the same grid_sample conventions
// (align_corners=False, zeros off the map; x = ((2u - 1 + 1) * W - 1) / 2,
// so dx/du = W; msda_common.cuh). Given grad_out g [N, Lq, H*D] it writes
//
//   d_attn[t]   = sum_d g[d] * s_t[d],      s_t = the bilinear sample of tap t
//   d_loc[t]    = attn[t] * (W_l * sum_d g[d] * ds_t/dx,
//                            H_l * sum_d g[d] * ds_t/dy)
//   d_value[r]  = sum over the in-map corners c of taps t that fall on
//                 value row r of attn[t] * w_c * g
//
// Layout: value [N, S, H, D] (f32 or bf16), loc [N, Lq, H, L, P, 2] f32,
// attn [N, Lq, H, L, P] f32, grad_out [N, Lq, H*D] in the value's type.
// Outputs: d_value in the value's type, d_loc and d_attn f32. The level
// table rides in the kernels' parameter blocks, as in the forward.
//
// What bounds it: memory. At the train encoder shape (N = B*T = 32,
// Lq = S = 9875, H*D = 384, L*P = 12, bf16 value) one call reads value and
// grad_out 242.7 MB each, loc 242.7 MB and attn 121.3 MB, and writes
// d_value 242.7 MB, d_loc 242.7 MB and d_attn 121.3 MB: about 1.46 GB,
// 0.44 ms at 3.35 TB/s. benchmark/counts/msda.py, which counts d_value in
// f32 and the arithmetic at the f32 rate, gives 0.507 ms (decoder, N = 48,
// Lq = 60: 0.246 ms, nearly all of it d_value written whole). Above that
// sit the gathers: 12 taps x 4 corner rows read per (n, q, h), and as many
// rows summed into d_value, 11.6 GB each way between the SMs and L2.
//
// Design: the owner of a value row computes its sum. Three kernels, all on
// the caller's stream, with sizes that follow from the shapes alone:
// 1. msda_backward_taps_kernel (msda_common.cuh's plan): a group of threads
//    per (n, q, h), threads over 16-byte channel vectors, grad_out in
//    registers, each tap's geometry computed once into a shared table; a
//    thread accumulates its part of the four corner dots p_c = v_c . g, the
//    group's parts are summed through shared memory once per chunk of taps,
//    and one thread per tap forms d_attn = sum_c w_c p_c and d_loc from the
//    corner differences, as grid_sample's backward does.
// 2. msda_backward_index_kernel: one warp per (n, h, level) sorts the
//    level's taps by cell, the nw corner (x0, y0) of their four (only cells
//    with a corner in the map): it counts each cell's taps (integer adds),
//    scans the counts into each cell's segment, then walks the taps in
//    order and writes each one's (query, attn, x, y) into its cell's
//    segment, ranked among the warp's lanes of the same cell by
//    __match_any_sync. So every segment lists its taps in one fixed order.
//    The counters, one per cell, live in shared memory where the largest
//    level has at most MSDA_INDEX_SHARED_CELLS cells (the 48 KB a block
//    gets without opting in; every preset's largest level, jta_forecast's
//    68 x 120, has 8349), else in the cells' own segments in global memory.
// 3. msda_backward_gather_kernel: a group of threads per value row, pixel
//    (X, Y) of its level, which is corner k (nw, ne, sw, se) of the cell
//    (X - k % 2, Y - k / 2): the group walks the four cells' taps in that
//    order, rebuilds each corner weight
//    attn * w_k from the tap's x and y as make_tap does, sums w * g in f32
//    registers and writes the row once, in the value's type; rows that no
//    tap reaches are written as zeros.
// So d_value is the same bit for bit on every run, no buffer is zeroed and
// no f32 copy is cast. The index holds N*H*L*Lq*P entries of 16 bytes (485
// MB at the train encoder), the segments N*H*sum_l (H_l + 1)(W_l + 1) pairs
// of int32 (21 MB).
//
// Kept, and why (bf16, train b8 encoder, device ms, one call of
// kernel_ab-style timing on NVIDIA H100 80GB HBM3, 700.00 W): an index of
// the corner hits instead of the taps, each (query, attn * w_c) of 8 bytes
// in its value row's segment, wrote four times the entries in scattered
// 8-byte stores and took 5.23-5.70 ms for the index alone (taps 1.89-2.06,
// gather 1.28-1.39; 8.45-9.15 in all, against the parent's 8.22: slower);
// ranking by one match per tap or per corner, or by shared atomics, moved
// it by under 10%, so the scattered stores bound it. The index of taps:
// index 2.14 ms with 4 taps a lane in flight, 1.74 with 8 (kept), gather
// 2.27 (it reads 16-byte entries and rebuilds the weights), taps 1.89: 5.91
// in all. The gather over 7 x 6 tiles of rows in place of runs of 42 took
// 2.60 ms.
//
// History: before the index, the taps kernel added a * w_c * g into a
// zeroed f32 d_value with float4 atomics, which the caller then cast. Its
// 1.46e9 float4 atomics per train encoder call bound it: without them the
// same launch took 0.77 of its 2.0 ms at batch 2. A shared-memory box per
// block, summing each level's adds with shared atomics before one global
// add per row and vector, ran 2.0-4.8x slower: on sm_90 an f32 atomicAdd
// in shared memory is a compare-and-swap loop. Reducing three dots per tap
// by warp shuffles ran slower than summing four corner dots once per chunk
// (measured).
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (device time of the whole
// backward as the op runs it, scripts/kernel_ab.py --msda_backward; PERF.md's
// K1 VJP rows): the atomic path as it ran before (zero fill, kernel, cast)
// against this (three kernels). bf16, train b8: encoder 8.24 ms against
// 6.33 (taps 2.11, index 1.94, gather 2.28); decoder 0.744 against 0.806,
// of which the gather, writing 3.8 M mostly empty rows through four segment
// reads each, takes 0.713 (reading the four segments at once left it at
// 0.709 and slowed the encoder's gather to 2.55). Bounds 0.507 and 0.246 ms
// (benchmark/counts/msda.py, d_value counted in f32). f32 at batch 2
// (N = 8 and 12): encoder 2.02 against 2.43 ms, decoder 0.104 against
// 0.38; the index does not pay there. In the train_t4f2_b8 step the three
// take about 21-24 ms a step against the atomic kernel's 44 (the
// benchmark's msda_backward_roofline.train 18.9-21.4% against 10.1-10.2%),
// the gather 16.5 of it; the index's share swings from run to run.

#include "msda_common.cuh"

// (n, q, h) groups sum their threads' corner dots through shared memory, a
// row of g + 1 float4 (padded against bank conflicts) per table slot; the
// chunk of taps is cut so that the rows stay within this many float4.
#define MSDA_DOT_ROWS 1664
// The launch's dynamic shared memory is at most MSDA_DOT_ROWS float4 (a
// slot's row is at most 2 * MSDA_THREADS float4 < MSDA_DOT_ROWS, so a chunk
// holds at least one tap); with the static tap table it stays within the
// 48 KB a launch gets without opting in.
static_assert(MSDA_DOT_ROWS * 16 + sizeof(Tap) * MSDA_THREADS <= 48 * 1024,
              "msda_backward's shared memory exceeds 48 KB");

// The index kernel keeps one int32 counter per cell of a level in shared
// memory where the largest level has at most this many cells (48 KB, no
// opt-in), else in the cells' segments in global memory.
#define MSDA_INDEX_SHARED_CELLS 12288
// taps per lane in one step of the index kernel's sweeps (loads in flight)
#define MSDA_INDEX_U 8

template <typename T, int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
    msda_backward_taps_kernel(const T* __restrict__ value,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn,
                              const T* __restrict__ grad_out,
                              float* __restrict__ d_loc,
                              float* __restrict__ d_attn, int S, int H, int D,
                              int Lq, int L, int P, Levels lv, Plan pl) {
  constexpr int KV = VEC == 1 ? 4 : 1;  // vectors per thread (D <= 128)
  extern __shared__ float4 dots[];  // [slot][thread of the group]
  __shared__ Tap table[MSDA_THREADS];
  int n, h, run;
  block_coords(pl, H, n, h, run);
  const int LP = L * P;
  const int q0 = run * pl.qb;
  const int gi = threadIdx.x / pl.g, j = threadIdx.x - gi * pl.g;
  const int q = q0 + gi;
  const bool active = gi < pl.qb && q < Lq;
  const idx_t row_stride = (idx_t)H * D;
  const idx_t q_stride = (idx_t)H * LP;
  const idx_t row0 = ((idx_t)n * Lq + q0) * q_stride + (idx_t)h * LP;
  const T* vbase = value + (idx_t)n * S * row_stride + (idx_t)h * D;
  const int ds = pl.g + 1;  // float4 per slot

  // this thread's channels of grad_out, kept in registers
  float g[KV][VEC];
  {
    const T* go = grad_out + ((idx_t)n * Lq + q) * row_stride + (idx_t)h * D;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int vi = j + k * pl.g;
      if (active && vi < pl.nv) {
        VecIO<T, VEC>::load(go + (idx_t)vi * VEC, g[k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) g[k][e] = 0.f;
      }
    }
  }

  for (int t0 = 0; t0 < LP; t0 += pl.tc) {
    __syncthreads();
    fill_taps(table, pl, t0, LP, P, q0, Lq, row0, q_stride, loc, attn, lv);
    __syncthreads();
    if (active) {
      const int nt = min(pl.tc, LP - t0);
      for (int s = 0; s < nt; ++s) {
        const Tap tp = table[gi * pl.tc + s];
        float p[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's part of v_c . g
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int vi = j + k * pl.g;
          if (vi >= pl.nv) break;
          float v[4][VEC];
          load_corners<T, VEC, idx_t>(tp, vbase + (idx_t)vi * VEC,
                                      row_stride, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[c] += v[c][e] * g[k][e];
        }
        dots[(gi * pl.tc + s) * ds + j] = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();
    // one tap per thread, as the table was filled: the group's corner dots
    // p_c summed, then d_attn = sum_c w_c p_c and d_loc from the corner
    // differences, as grid_sample's backward forms them; coalesced writes
    const int slot = threadIdx.x, sg = slot / pl.tc, t = t0 + slot % pl.tc;
    if (sg < pl.qb && q0 + sg < Lq && t < LP) {
      float4 pc = dots[slot * ds];
      for (int i = 1; i < pl.g; ++i) {
        const float4 x = dots[slot * ds + i];
        pc.x += x.x;
        pc.y += x.y;
        pc.z += x.z;
        pc.w += x.w;
      }
      const Tap tp = table[slot];
      const idx_t ti = row0 + (idx_t)sg * q_stride + t;
      d_attn[ti] = tp.dx1 * tp.dy1 * pc.x + tp.dx0 * tp.dy1 * pc.y +
                   tp.dx1 * tp.dy0 * pc.z + tp.dx0 * tp.dy0 * pc.w;
      reinterpret_cast<float2*>(d_loc)[ti] = make_float2(
          tp.afw * (tp.dy1 * (pc.y - pc.x) + tp.dy0 * (pc.w - pc.z)),
          tp.afh * (tp.dx1 * (pc.z - pc.x) + tp.dx0 * (pc.w - pc.y)));
    }
  }
}

// loc and attn of the taps i0 + u * 32 + lane (u < MSDA_INDEX_U) of one
// (n, h, level): tap i is point i % P of query i / P. Zeros past the end.
template <typename idx_t>
__device__ __forceinline__ void fetch_taps(const float* __restrict__ loc,
                                           const float* __restrict__ attn,
                                           idx_t tap0, idx_t q_stride, int P,
                                           int taps, int i0, float2* uv,
                                           float* a) {
#pragma unroll
  for (int u = 0; u < MSDA_INDEX_U; ++u) {
    const int i = i0 + u * 32 + (int)threadIdx.x;
    uv[u] = make_float2(0.f, 0.f);
    a[u] = 0.f;
    if (i < taps) {
      const int q = i / P;
      const idx_t ti = tap0 + (idx_t)q * q_stride + (i - q * P);
      uv[u] = __ldg(reinterpret_cast<const float2*>(loc) + ti);
      a[u] = __ldg(attn + ti);
    }
  }
}

// The cell of a tap: the nw corner (x0, y0) of its four, numbered
// (x0 + 1) + (y0 + 1) * (W_l + 1) over x0 in [-1, W_l - 1], y0 in
// [-1, H_l - 1], the cells with a corner in the map; -1 for the others.
__device__ __forceinline__ int tap_cell(float2 xy, const Levels& lv, int l) {
  const float x0f = floorf(xy.x), y0f = floorf(xy.y);
  if (!(x0f >= -1.f && x0f < (float)lv.w[l] && y0f >= -1.f &&
        y0f < (float)lv.h[l]))
    return -1;
  return ((int)x0f + 1) + ((int)y0f + 1) * (lv.w[l] + 1);
}

// cells of the levels before l
__device__ __forceinline__ int cell_base(const Levels& lv, int l) {
  int cb = 0;
  for (int k = 0; k < l; ++k) cb += (lv.w[k] + 1) * (lv.h[k] + 1);
  return cb;
}

// One warp per (n, h, level l): block (n * H + h) * L + l. segs[n, h, cell]
// = (start, end) of the cell's taps in the (n, h) part of the index, whose
// level l part begins at l * Lq * P; entry = (query, attn, x, y). Each cell
// has a counter: first its tap count, then, after the scan, the next free
// position of its segment. SHARED: the counters live in shared memory (one
// int per cell of the level), else in the .y of each cell's segment, which
// ends at the segment's end.
template <typename idx_t, bool SHARED>
__global__ void __launch_bounds__(32)
    msda_backward_index_kernel(const float* __restrict__ loc,
                               const float* __restrict__ attn,
                               float4* __restrict__ index,
                               int2* __restrict__ segs, int C, int H, int Lq,
                               int L, int P, Levels lv) {
  extern __shared__ int smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int l = blockIdx.x % L, nh = blockIdx.x / L;
  const int n = nh / H, h = nh - n * H;
  const int cells = (lv.w[l] + 1) * (lv.h[l] + 1);
  const int taps = Lq * P;      // the level's taps of this (n, h)
  const int region = l * taps;  // where the level's entries begin
  const idx_t q_stride = (idx_t)H * L * P;
  const idx_t tap0 = (idx_t)n * Lq * q_stride + ((idx_t)h * L + l) * P;
  float4* out = index + (int64_t)nh * L * taps;
  int2* seg = segs + (idx_t)nh * C + cell_base(lv, l);
  // cell i's counter: cur[i * cs]
  int* const cur = SHARED ? smem : &seg->y;
  constexpr int cs = SHARED ? 1 : 2;
  constexpr int U = MSDA_INDEX_U;
  float2 uv[U], nuv[U];
  float a[U], na[U];

  for (int i = lane; i < cells; i += 32) cur[i * cs] = 0;
  __syncwarp();
  // sweep 1: taps per cell (integer adds, in any order)
  fetch_taps(loc, attn, tap0, q_stride, P, taps, 0, uv, a);
  for (int i0 = 0; i0 < taps; i0 += 32 * U) {
    fetch_taps(loc, attn, tap0, q_stride, P, taps, i0 + 32 * U, nuv, na);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cell = tap_cell(tap_xy(uv[u].x, uv[u].y, lv, l), lv, l);
      if (i0 + u * 32 + lane < taps && cell >= 0) atomicAdd(&cur[cell * cs], 1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uv[u] = nuv[u];
      a[u] = na[u];
    }
  }
  __syncwarp();
  // exclusive scan of the counts, 32 cells at a time: each cell's segment
  int carry = region;
  for (int i0 = 0; i0 < cells; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < cells ? cur[i * cs] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, x, o);
      if (lane >= o) x += y;
    }
    if (i < cells) {
      const int begin = carry + x - c;
      seg[i] = make_int2(begin, begin + c);
      cur[i * cs] = begin;
    }
    carry += __shfl_sync(full, x, 31);
  }
  __syncwarp();
  // sweep 2: the taps in a fixed order (step, u, lane), each lane ranked
  // among the lanes of its cell
  fetch_taps(loc, attn, tap0, q_stride, P, taps, 0, uv, a);
  for (int i0 = 0; i0 < taps; i0 += 32 * U) {
    fetch_taps(loc, attn, tap0, q_stride, P, taps, i0 + 32 * U, nuv, na);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 32 + lane;
      const float2 xy = tap_xy(uv[u].x, uv[u].y, lv, l);
      const int cell = tap_cell(xy, lv, l);
      // no cell, or past the end: a key no other lane has
      const int key = i < taps && cell >= 0 ? cell : -1 - lane;
      const unsigned peers = __match_any_sync(full, key);
      int pos = 0;
      if (key >= 0) pos = cur[key * cs] + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
      if (key >= 0) {
        if (lane == __ffs(peers) - 1) cur[key * cs] += __popc(peers);
        out[pos] = make_float4(__int_as_float(i / P), a[u], xy.x, xy.y);
      }
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uv[u] = nuv[u];
      a[u] = na[u];
    }
  }
}

// A group of threads per value row (n, r, h). The row, pixel (X, Y) of its
// level, is corner k (nw, ne, sw, se) of the cell (X - k % 2, Y - k / 2);
// the group walks the four cells' taps in that order, each tap's weight
// attn * w_k rebuilt from its coordinates as make_tap forms it, sums
// w * g in f32 and writes the row once in T (zeros where the four
// segments are empty).
template <typename T, int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
    msda_backward_gather_kernel(const T* __restrict__ grad_out,
                                const float4* __restrict__ index,
                                const int2* __restrict__ segs,
                                T* __restrict__ d_value, int S, int H, int D,
                                int Lq, int L, int taps_nh, int C, Levels lv,
                                Plan pl) {
  constexpr int KV = VEC == 1 ? 4 : 1;  // vectors per thread (D <= 128)
  constexpr int U = 4;                  // taps in flight
  int n, h, run;
  block_coords(pl, H, n, h, run);
  const int gi = threadIdx.x / pl.g, j = threadIdx.x - gi * pl.g;
  const int r = run * pl.qb + gi;
  if (gi >= pl.qb || r >= S) return;
  int l = 0;
  while (l + 1 < L && r >= lv.start[l + 1]) ++l;
  const int cw = lv.w[l] + 1, px = r - lv.start[l];
  const int Y = px / lv.w[l], X = px - Y * lv.w[l];
  const idx_t nh = (idx_t)n * H + h;
  const int2* sg = segs + nh * C + cell_base(lv, l);
  const int c0 = (X + 1) + (Y + 1) * cw;
  const float4* taps = index + (int64_t)nh * taps_nh;
  const idx_t row_stride = (idx_t)H * D;
  const T* gbase = grad_out + (idx_t)n * Lq * row_stride + (idx_t)h * D;
  float acc[KV][VEC];
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int2 s = __ldg(sg + c0 - (k & 1) - (k >> 1) * cw);
    for (int i = s.x; i < s.y; i += U) {
      float4 e[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        e[u] = i + u < s.y ? __ldg(taps + i + u)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float gv[U][KV][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int kv = 0; kv < KV; ++kv) {
          const int vi = j + kv * pl.g;
          if (vi < pl.nv && i + u < s.y) {
            VecIO<T, VEC>::load(gbase + (idx_t)__float_as_int(e[u].x) *
                                            row_stride + (idx_t)vi * VEC,
                                gv[u][kv]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) gv[u][kv][q] = 0.f;
          }
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // the corner weight as make_tap forms it: x1 - x or x - x0 along
        // each axis
        const float x0f = floorf(e[u].z), y0f = floorf(e[u].w);
        const float dx = k & 1 ? e[u].z - x0f : (x0f + 1.f) - e[u].z;
        const float dy = k & 2 ? e[u].w - y0f : (y0f + 1.f) - e[u].w;
        const float w = e[u].y * (dx * dy);
#pragma unroll
        for (int kv = 0; kv < KV; ++kv)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[kv][q] += w * gv[u][kv][q];
      }
    }
  }
  T* dv = d_value + ((idx_t)n * S + r) * row_stride + (idx_t)h * D;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int vi = j + k * pl.g;
    if (vi >= pl.nv) break;
    VecIO<T, VEC>::store(dv + (idx_t)vi * VEC, acc[k]);
  }
}

struct Args {
  const void *value, *loc, *attn, *grad_out;
  void *d_value, *d_loc, *d_attn, *index, *segs;
  int64_t N, S, H, D, Lq;
  int L, P;
};

// pl: the taps kernel's plan (groups over queries), rp: the gather's
// (groups over value rows).
template <typename T, int VEC, typename idx_t>
static int run(const Args& a, const Levels& lv, Plan pl, const Plan& rp,
               cudaStream_t st) {
  const int tc_dots = MSDA_DOT_ROWS / (pl.qb * (pl.g + 1));
  if (tc_dots < pl.tc) pl.tc = tc_dots;
  const int dyn = pl.qb * pl.tc * (pl.g + 1) * 16;
  if (a.Lq > 0)
    msda_backward_taps_kernel<T, VEC, idx_t>
        <<<(unsigned)(a.N * a.H * pl.runs), MSDA_THREADS, dyn, st>>>(
            (const T*)a.value, (const float*)a.loc, (const float*)a.attn,
            (const T*)a.grad_out, (float*)a.d_loc, (float*)a.d_attn,
            (int)a.S, (int)a.H, (int)a.D, (int)a.Lq, a.L, a.P, lv, pl);
  if (a.S == 0) return (int)cudaGetLastError();
  int max_cells = 0, C = 0;
  for (int l = 0; l < a.L; ++l) {
    const int cells = (lv.h[l] + 1) * (lv.w[l] + 1);
    C += cells;
    if (cells > max_cells) max_cells = cells;
  }
  const unsigned blocks = (unsigned)(a.N * a.H * a.L);
  if (max_cells <= MSDA_INDEX_SHARED_CELLS)
    msda_backward_index_kernel<idx_t, true>
        <<<blocks, 32, max_cells * sizeof(int), st>>>(
            (const float*)a.loc, (const float*)a.attn, (float4*)a.index,
            (int2*)a.segs, C, (int)a.H, (int)a.Lq, a.L, a.P, lv);
  else
    msda_backward_index_kernel<idx_t, false><<<blocks, 32, 0, st>>>(
        (const float*)a.loc, (const float*)a.attn, (float4*)a.index,
        (int2*)a.segs, C, (int)a.H, (int)a.Lq, a.L, a.P, lv);
  msda_backward_gather_kernel<T, VEC, idx_t>
      <<<(unsigned)(a.N * a.H * rp.runs), MSDA_THREADS, 0, st>>>(
          (const T*)a.grad_out, (const float4*)a.index, (const int2*)a.segs,
          (T*)a.d_value, (int)a.S, (int)a.H, (int)a.D, (int)a.Lq, a.L,
          (int)(a.L * a.Lq * a.P), C, lv, rp);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const Args& a, const int64_t* shapes, const int64_t* starts,
                  void* stream) {
  Levels lv;
  if (!fill_levels(a.L, shapes, starts, &lv) || a.P < 1 || a.D < 1 ||
      a.D > 128 || !aligned(a.loc, 8) || !aligned(a.d_loc, 8) ||
      !aligned(a.index, 16) || !aligned(a.segs, 8) ||
      a.L * a.Lq * a.P >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (a.N * a.H == 0) return (int)cudaSuccess;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = a.D % VEC == 0 && aligned(a.value, 16) &&
                   aligned(a.grad_out, 16) && aligned(a.d_value, 16);
  const Plan pl = make_plan((int)a.D, vec ? VEC : 1, a.L * a.P, a.Lq);
  const Plan rp = make_plan((int)a.D, vec ? VEC : 1, a.L * a.P, a.S);
  if (a.N * a.H * pl.runs > 0x7fffffff || a.N * a.H * rp.runs > 0x7fffffff ||
      a.N * a.H * a.L > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool i32 = fits_int32(a.N, a.S, a.H, a.D, a.Lq, a.L * a.P);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    return i32 ? run<T, VEC, int>(a, lv, pl, rp, st)
               : run<T, VEC, int64_t>(a, lv, pl, rp, st);
  return i32 ? run<T, 1, int>(a, lv, pl, rp, st)
             : run<T, 1, int64_t>(a, lv, pl, rp, st);
}

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success). value,
// grad_out and d_value are of the named type, d_loc and d_attn f32. index
// (N*H*L*Lq*P entries of 16 bytes, 16-byte aligned) and segs
// (N*H*sum_l (H_l + 1)(W_l + 1) pairs of int32) are scratch; every row of
// d_value is written.
int msda_backward_f32(const void* value, const void* loc, const void* attn,
                      const void* grad_out, void* d_value, void* d_loc,
                      void* d_attn, void* index, void* segs, int64_t N,
                      int64_t S, int64_t H, int64_t D, int64_t Lq, int L,
                      int P, const int64_t* shapes, const int64_t* starts,
                      void* stream) {
  const Args a{value,  loc,   attn, grad_out, d_value, d_loc, d_attn,
               index,  segs,  N,    S,        H,       D,     Lq,
               L,      P};
  return launch<float>(a, shapes, starts, stream);
}

int msda_backward_bf16(const void* value, const void* loc, const void* attn,
                       const void* grad_out, void* d_value, void* d_loc,
                       void* d_attn, void* index, void* segs, int64_t N,
                       int64_t S, int64_t H, int64_t D, int64_t Lq, int L,
                       int P, const int64_t* shapes, const int64_t* starts,
                       void* stream) {
  const Args a{value,  loc,   attn, grad_out, d_value, d_loc, d_attn,
               index,  segs,  N,    S,        H,       D,     Lq,
               L,      P};
  return launch<__nv_bfloat16>(a, shapes, starts, stream);
}

}  // extern "C"
