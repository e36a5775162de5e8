// Windowed sampling contractions for Hopper (sm_90a): K2, K5 and K4 of the
// JAX package's TPU kernels.
//
// win2d_sample replaces `_win2d_segment` + `_win2d_kernel_factory`
// (snipper_tpu/ops/pallas_deform.py:186-337), driven per query segment by
// `ms_deform_attn_windowed2d_pallas` (:340). For one 2D query block and one
// (batch, head) the TPU stages, level by level, the (wy, wx) window of the
// level at the block's anchor and contracts the point-merged taps of each
// query against it:
//
//   out[b, q, h*D + d] = sum_l sum_k wgt[l][nb, bh, c, k]
//                                    * win_l[ids[l][nb, bh, c, k], d]
//
// where query q is pixel c of block nb, win_l[r] is value pixel
// (y_lo + r / wx, x_lo + r % wx) of level l and (y_lo, x_lo) is the block's
// anchor. The host side (ops/win2d.py) computes the corner decomposition, the
// weights, the anchors, the window-local ids and the overflow count in torch
// ops, as JAX does outside its kernel; taps outside the window arrive with
// weight 0 and are skipped, so the kernel computes the JAX function, which
// drops them.
//
// win2d_contract replaces `_onehot_reference` (scripts/lanegather_probe.py:
// 217-236), which runs K2's kernel body on windows staged beforehand: the
// same contraction, with win_l read from wins[l] [NB, BH, Wd_l, D] and
// the result written as [NB, BH, C, D].
//
// hier_gather replaces `hier_gather_sample` (lanegather_probe.py:164-190):
// the same contraction on the transposed layout, winsT[l] [NB, BH, D, Wd_l]
// and idsT/wgtsT [NB, BH, K, Cp] -> out [NB, BH, D, Cp].
//
// Design. The TPU has no VMEM gather, so K2 and K5 build a weighted one-hot
// [C, Wd] and contract it on the MXU, and K4 asks whether Mosaic's in-tile
// lane gather beats that. A GPU gathers rows directly:
// - win2d_contract is msda_forward's design (msda_common.cuh) with one
//   window row per tap instead of four corners: a group of threads per
//   (query, b*h) over float4 channel vectors, groups packed over 256-thread
//   blocks that run over consecutive queries of (nb, bh) after (nb, bh).
//   The block reads each tap's id and weight once, level by level, into a
//   table in shared memory that its groups read back as broadcasts; a tap
//   of weight 0 or with an id outside [0, Wd) is marked and skipped. Rows
//   are read through L1/L2, the sum is kept in f32 registers and written
//   once. Nothing is staged, and nothing bounds C or D. A scalar path takes
//   a D that is not a multiple of 4, or an unaligned window or output.
// - hier_gather asks the TPU probe's question of the card: a warp holds a
//   32-column tile of the transposed window in registers, one column per
//   lane and DC channel rows at once, and each lane takes a tap's value with
//   __shfl_sync. Lane j owns query 32 * group + j and reads its taps of the
//   level once, into its own column of the warp's slice of shared memory;
//   per tile it marks which taps fall in the tile, and the warp runs as
//   many shuffle rounds as the most any lane has there (none, and no column
//   load, where no lane has one), each round serving every lane's next tap,
//   looked up by its index, on all DC channels. The warps of a block take
//   the query groups and channel chunks of one (nb, bh) and walk its tiles
//   in the same order, so L1 serves the window's repeats. Registers hold
//   the DC columns and sums, at most 128 a thread, so two blocks share an
//   SM: taps kept in registers instead (165 registers, one block) ran
//   1.5x slower (PERF.md).
// - win2d_sample is win2d_contract's design on the value itself: a group
//   of threads per (query, b*h) over 16-byte vectors (8 bf16 or 4 f32
//   channels), queries flattened over (nb, bh, c) so that neighbouring
//   groups share a window. Per block, one thread per (level, query) works
//   out the value row of the query's window origin from its own anchor (a
//   block may straddle two (nb, bh)); the block then reads each tap's id
//   and weight once, over all levels, into the shared table, where the tap
//   becomes the global row base + ((id / wx) * w + id % wx) * H, or -1 for
//   weight 0 or the pad id wy*wx. Nothing is staged: only the rows the taps
//   name are read, through L1/L2 (the whole bf16 value of the probe, 30
//   MB, fits the 50 MB L2), the f32 weights are kept, the sum is kept in
//   f32 registers and rounded once to the value's dtype as it is written.
//   Nothing bounds C or D; a scalar path takes a D that is no multiple of
//   the vector, or an unaligned value or output.
//
// What bounds them: memory. The least bytes are the ids and weights (8 bytes
// a tap), the window rows the taps touch, and the output; the contraction is
// 2 flops a tap and channel. At the probe's (80, 128) fixture
// win2d_contract and hier_gather must move about 1.37 GB, nearly all of it
// the windows (0.41 ms at 3.35 TB/s); win2d_sample at the encoder fixture
// about 0.19 GB in bf16 (0.057 ms), two thirds of it ids and weights. On top
// of that win2d_contract reads 3.0 GB of rows through L1/L2 at that fixture,
// win2d_sample 1.67 GB (17.4 M taps of 96 bytes in bf16), and hier_gather
// retires one warp shuffle per round and channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_common.cuh"

#define W2D_MAX_LEVELS 8
// win2d_sample's and win2d_contract's per-block tap table: 16 KB
#define W2C_TABLE 2048
#define HG_MAX_TAPS 16
#define HG_THREADS 256

struct WinLevels {
  const void* src[W2D_MAX_LEVELS];    // wins[l] (contract) or unused (sample)
  const int* ids[W2D_MAX_LEVELS];     // [NB, BH, C, K]
  const float* wgts[W2D_MAX_LEVELS];  // [NB, BH, C, K]
  int rows[W2D_MAX_LEVELS];           // window rows: wy * wx, or Wd
  int wx[W2D_MAX_LEVELS];             // window width (sample)
  int w[W2D_MAX_LEVELS];              // level width (sample)
  int start[W2D_MAX_LEVELS];          // level's first pixel (sample)
};

struct Segment {  // win2d_sample: the query segment's pixel grid and blocks
  int hs, ws, bh, bw, nbx;
};

// One tap of a block's table: the row its id names (a window row for K5,
// a row of the value [B*S*H, D] for K2), or -1 for a tap that adds
// nothing, and its weight. One 8-byte shared load.
struct __align__(8) WinTap {
  int row;
  float w;
};

// acc[k] += w * (vector j + (v0 + k) * g of the tap's row) over the
// group's taps tt[0, nt) that name a row of ``rows`` (D elements a row);
// a tap of row -1 adds nothing.
template <typename T, int VEC, int KV, typename idx_t>
__device__ __forceinline__ void add_taps(float (&acc)[KV][VEC],
                                         const WinTap* tt, int nt,
                                         const T* __restrict__ rows, int D,
                                         int j, int v0, const Plan& pl) {
#pragma unroll 4
  for (int s = 0; s < nt; ++s) {
    const WinTap tp = tt[s];
    if (tp.row < 0) continue;
    const T* row = rows + (idx_t)tp.row * D;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int vi = j + (v0 + k) * pl.g;
      if (vi >= pl.nv) break;
      float v[VEC];
      VecIO<T, VEC>::load(row + vi * VEC, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] += tp.w * v[e];
    }
  }
}

// Write one pass's sums, rounded once to T, to the query's row o.
template <typename T, int VEC, int KV>
__device__ __forceinline__ void store_pass(T* o, float (&acc)[KV][VEC],
                                           int j, int v0, const Plan& pl) {
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int vi = j + (v0 + k) * pl.g;
    if (vi >= pl.nv) break;
    VecIO<T, VEC>::store(o + vi * VEC, acc[k]);
  }
}

// ---------------------------------------------------------------- K2
// Fill the block's table for taps [t0, t0 + tc) of each group's query, the
// taps t = l * K + k running over the levels l: slot s holds tap
// t0 + s % tc of the block's query q0 + s / tc. `base[l][g]` is the value
// row of query q0 + g's window origin on level l (-1 past the last query),
// so a tap pays one division, by the window's width.
__device__ __forceinline__ void fill_sample_taps(
    WinTap* table, int (*base)[MSDA_THREADS], const Plan& pl, int t0,
    int LK, int K, int64_t q0, int H, const WinLevels& lv, int rows_total) {
  for (int s = threadIdx.x; s < pl.qb * pl.tc; s += blockDim.x) {
    const int sg = s / pl.tc, t = t0 + s - sg * pl.tc;
    WinTap tp = {-1, 0.f};
    if (t < LK) {
      const int l = t / K, k = t - l * K;
      const int bs = base[l][sg];
      if (bs >= 0) {
        const int64_t i = (q0 + sg) * K + k;  // [NB, BH, C, K] flat
        const int id = __ldg(lv.ids[l] + i);
        const float w = __ldg(lv.wgts[l] + i);
        if (w != 0.f && id >= 0 && id < lv.rows[l]) {
          const int yy = id / lv.wx[l];
          const int row = bs + (yy * lv.w[l] + id - yy * lv.wx[l]) * H;
          if ((unsigned)row < (unsigned)rows_total) tp = WinTap{row, w};
        }
      }
    }
    table[s] = tp;
  }
}

// Queries are flattened over (nb, bh, c), C to a (nb, bh): group gi of
// block x takes query q = x * qb + gi, pixel c of query block nb for
// (b, hh) = bh. A block may straddle two (nb, bh), so each query finds its
// own anchor. value [B, S, H, D], anchors [L, NB, 2] (y_lo, x_lo), out
// [B, hs*ws, H*D], written once per query inside the segment.
template <typename T, int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
win2d_sample_kernel(const T* __restrict__ value,
                    const int* __restrict__ anchors, T* __restrict__ out,
                    WinLevels lv, Segment sg, int L, int K, int S, int H,
                    int D, int C, int NB, int BH, int64_t Q, Plan pl) {
  constexpr int KV = VEC == 1 ? 4 : 1;  // vectors per thread in one pass
  __shared__ WinTap table[W2C_TABLE];
  __shared__ int base[W2D_MAX_LEVELS][MSDA_THREADS];
  const int64_t q0 = (int64_t)blockIdx.x * pl.qb;
  for (int s = threadIdx.x; s < L * pl.qb; s += blockDim.x) {
    const int l = s / pl.qb, g = s - l * pl.qb;
    const int64_t q = q0 + g;
    int bs = -1;
    if (q < Q) {
      const int blk = (int)(q / C), nb = blk / BH, bh = blk - nb * BH;
      const int b = bh / H, hh = bh - b * H;
      const int* an = anchors + ((int64_t)l * NB + nb) * 2;
      bs = ((b * S + lv.start[l] + an[0] * lv.w[l] + an[1]) * H
            + hh);
    }
    base[l][g] = bs;
  }
  const int gi = threadIdx.x / pl.g, j = threadIdx.x - gi * pl.g;
  const int64_t q = q0 + gi;
  bool active = gi < pl.qb && q < Q;
  idx_t o = 0;  // the query's first output element
  if (active) {
    const int blk = (int)(q / C), c = (int)(q - (int64_t)blk * C);
    const int nb = blk / BH, bh = blk - nb * BH;
    const int b = bh / H, hh = bh - b * H;
    const int y = (nb / sg.nbx) * sg.bh + c / sg.bw;
    const int x = (nb % sg.nbx) * sg.bw + c % sg.bw;
    o = (((idx_t)b * sg.hs * sg.ws + y * sg.ws + x) * H + hh) * D;
    active = y < sg.hs && x < sg.ws;  // a padded query writes nothing
  }
  const int LK = L * K, rows_total = BH / H * S * H;  // value rows
  // passes over the thread's vectors; one pass wherever D <= 32 * VEC * KV
  for (int v0 = 0; v0 < pl.vpl; v0 += KV) {
    float acc[KV][VEC];
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    for (int t0 = 0; t0 < LK; t0 += pl.tc) {
      __syncthreads();  // base is written; the previous chunk is consumed
      fill_sample_taps(table, base, pl, t0, LK, K, q0, H, lv, rows_total);
      __syncthreads();
      if (active)
        add_taps<T, VEC, KV, idx_t>(acc, table + gi * pl.tc,
                                    min(pl.tc, LK - t0), value, D, j, v0,
                                    pl);
    }
    if (active) store_pass(out + o, acc, j, v0, pl);
  }
}

template <typename T>
static int launch_win2d(const void* value, const void* anchors, void* out,
                        const void* const* ids, const void* const* wgts,
                        const int64_t* table, int L, int K, int64_t S, int H,
                        int D, int C, int NB, int BH, const int* seg,
                        void* stream) {
  if (L < 1 || L > W2D_MAX_LEVELS || K < 1 || D < 1 || C < 1 || H < 1 ||
      BH % H)
    return (int)cudaErrorInvalidValue;
  constexpr int VEC = 16 / sizeof(T);
  WinLevels lv = {};
  for (int l = 0; l < L; ++l) {
    // table rows: (rows, wx, h, w, start); h is not needed
    lv.ids[l] = static_cast<const int*>(ids[l]);
    lv.wgts[l] = static_cast<const float*>(wgts[l]);
    lv.rows[l] = (int)table[5 * l];
    lv.wx[l] = (int)table[5 * l + 1];
    lv.w[l] = (int)table[5 * l + 3];
    lv.start[l] = (int)table[5 * l + 4];
    if (lv.wx[l] < 1) return (int)cudaErrorInvalidValue;
  }
  const Segment sg = {seg[0], seg[1], seg[2], seg[3],
                      (seg[1] + seg[3] - 1) / seg[3]};
  const int64_t Q = (int64_t)NB * BH * C;
  const int64_t B = BH / H;
  const int64_t lim = (int64_t)1 << 31;
  // value rows and query counts in int32; element offsets in int32 where
  // the value and the output allow
  if (B * S * H >= lim || Q >= lim) return (int)cudaErrorInvalidValue;
  const bool vec = D % VEC == 0 && aligned(value, 16) && aligned(out, 16);
  const bool i32 = B * S * H * D < lim
                   && B * sg.hs * sg.ws * H * D < lim;
  if (Q == 0) return (int)cudaSuccess;
  Plan pl = make_plan(D, vec ? VEC : 1, K, Q);
  pl.tc = L * K < W2C_TABLE / pl.qb ? L * K : W2C_TABLE / pl.qb;
  const int64_t blocks = (Q + pl.qb - 1) / pl.qb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const T* v = static_cast<const T*>(value);
  const int* an = static_cast<const int*>(anchors);
  T* o = static_cast<T*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  const int s32 = (int)S;
  if (vec && i32)
    win2d_sample_kernel<T, VEC, int><<<grid, MSDA_THREADS, 0, st>>>(
        v, an, o, lv, sg, L, K, s32, H, D, C, NB, BH, Q, pl);
  else if (vec)
    win2d_sample_kernel<T, VEC, int64_t><<<grid, MSDA_THREADS, 0, st>>>(
        v, an, o, lv, sg, L, K, s32, H, D, C, NB, BH, Q, pl);
  else if (i32)
    win2d_sample_kernel<T, 1, int><<<grid, MSDA_THREADS, 0, st>>>(
        v, an, o, lv, sg, L, K, s32, H, D, C, NB, BH, Q, pl);
  else
    win2d_sample_kernel<T, 1, int64_t><<<grid, MSDA_THREADS, 0, st>>>(
        v, an, o, lv, sg, L, K, s32, H, D, C, NB, BH, Q, pl);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K5
// Fill the block's table for taps [k0, k0 + tc) of level l of each group's
// query: slot s holds tap k0 + s % tc of the block's query q0 + s / tc.
__device__ __forceinline__ void fill_win_taps(WinTap* table, const Plan& pl,
                                              int k0, int K, int64_t q0,
                                              int64_t Q, int Wd,
                                              const int* __restrict__ ids,
                                              const float* __restrict__ wgts) {
  for (int s = threadIdx.x; s < pl.qb * pl.tc; s += blockDim.x) {
    const int sg = s / pl.tc, k = k0 + s - sg * pl.tc;
    const int64_t q = q0 + sg;
    WinTap tp = {-1, 0.f};
    if (q < Q && k < K) {
      const int64_t i = q * K + k;  // [NB, BH, C, K] flat
      const int id = __ldg(ids + i);
      const float w = __ldg(wgts + i);
      if (w != 0.f && id >= 0 && id < Wd) tp = WinTap{id, w};
    }
    table[s] = tp;
  }
}

// Queries are flattened over (nb, bh, c), C to a (nb, bh): group gi of
// block x takes query q = x * qb + gi, whose output row is out[q].
template <int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
win2d_contract_kernel(float* __restrict__ out, WinLevels lv, int L, int K,
                      int D, int C, int64_t Q, Plan pl) {
  constexpr int KV = VEC == 1 ? 4 : 1;  // vectors per thread in one pass
  __shared__ WinTap table[W2C_TABLE];
  const int64_t q0 = (int64_t)blockIdx.x * pl.qb;
  const int gi = threadIdx.x / pl.g, j = threadIdx.x - gi * pl.g;
  const int64_t q = q0 + gi;
  const bool active = gi < pl.qb && q < Q;
  const idx_t blk = (idx_t)(q / C);
  // passes over the thread's vectors; one pass wherever D <= 32 * VEC * KV
  for (int v0 = 0; v0 < pl.vpl; v0 += KV) {
    float acc[KV][VEC];
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    for (int l = 0; l < L; ++l) {
      const int Wd = lv.rows[l];
      const float* win = static_cast<const float*>(lv.src[l])
                         + blk * Wd * D;
      for (int k0 = 0; k0 < K; k0 += pl.tc) {
        __syncthreads();
        fill_win_taps(table, pl, k0, K, q0, Q, Wd, lv.ids[l], lv.wgts[l]);
        __syncthreads();
        if (active)
          add_taps<float, VEC, KV, idx_t>(acc, table + gi * pl.tc,
                                          min(pl.tc, K - k0), win, D, j, v0,
                                          pl);
      }
    }
    if (active) store_pass(out + (idx_t)q * D, acc, j, v0, pl);
  }
}

static int launch_win2d_contract(void* out, const void* const* wins,
                                 const void* const* ids,
                                 const void* const* wgts,
                                 const int64_t* table, int L, int K, int D,
                                 int C, int NB, int BH, void* stream) {
  if (L < 1 || L > W2D_MAX_LEVELS || K < 1 || D < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  WinLevels lv = {};
  const int64_t Q = (int64_t)NB * BH * C;
  const int64_t lim = (int64_t)1 << 31;
  bool vec = D % 4 == 0 && aligned(out, 16);
  bool i32 = Q * D < lim;
  for (int l = 0; l < L; ++l) {
    lv.src[l] = wins[l];
    lv.ids[l] = static_cast<const int*>(ids[l]);
    lv.wgts[l] = static_cast<const float*>(wgts[l]);
    lv.rows[l] = (int)table[5 * l];
    vec = vec && aligned(wins[l], 16);
    i32 = i32 && (int64_t)NB * BH * lv.rows[l] * D < lim;
  }
  if (Q * K >= lim) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  Plan pl = make_plan(D, vec ? 4 : 1, K, Q);
  pl.tc = K < W2C_TABLE / pl.qb ? K : W2C_TABLE / pl.qb;
  const int64_t blocks = (Q + pl.qb - 1) / pl.qb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  if (vec && i32)
    win2d_contract_kernel<4, int><<<grid, MSDA_THREADS, 0, st>>>(
        o, lv, L, K, D, C, Q, pl);
  else if (vec)
    win2d_contract_kernel<4, int64_t><<<grid, MSDA_THREADS, 0, st>>>(
        o, lv, L, K, D, C, Q, pl);
  else if (i32)
    win2d_contract_kernel<1, int><<<grid, MSDA_THREADS, 0, st>>>(
        o, lv, L, K, D, C, Q, pl);
  else
    win2d_contract_kernel<1, int64_t><<<grid, MSDA_THREADS, 0, st>>>(
        o, lv, L, K, D, C, Q, pl);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4
// One block per (nb, bh); each warp takes (channel chunk, query group)
// tasks, the groups of one chunk on neighbouring warps. Lane j owns query
// c = 32 * group + j; it keeps the ids (-1 for a tap of weight 0, which is
// dropped) and weights of its taps of the level in column j of the warp's
// shared-memory slice, which only lane j reads, so no barrier is needed.
// Per 32-column tile of the window it loads column t0 + j of DC channel
// rows of winT, and the warp runs `rounds` shuffle rounds, the most taps
// any lane has in the tile: in round r each lane takes its r-th tap there
// (weight 0 if it has none) and shuffles in that column from the lane that
// holds it, on each of the DC channels. An id outside [0, Wd) names no
// column, or a column of the last tile past Wd, which holds 0: it adds
// nothing.
template <int DC>
__global__ void __launch_bounds__(HG_THREADS, 2)
hier_gather_kernel(WinLevels lv, float* __restrict__ out, int L, int K,
                   int D, int Cp) {
  const unsigned full = 0xffffffffu;
  __shared__ int s_id[HG_THREADS / 32][HG_MAX_TAPS][32];
  __shared__ float s_wg[HG_THREADS / 32][HG_MAX_TAPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t blk = blockIdx.x;
  const int groups = Cp / 32, chunks = (D + DC - 1) / DC;
  for (int task = warp; task < groups * chunks; task += nwarps) {
    const int ch = task / groups, g = task - ch * groups;
    const int d0 = ch * DC, c = g * 32 + lane;
    float acc[DC];
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) acc[dd] = 0.f;
    for (int l = 0; l < L; ++l) {
      const int Wd = lv.rows[l];
      const float* rows = static_cast<const float*>(lv.src[l])
                          + (blk * D + d0) * Wd;
      const int* id_c = lv.ids[l] + blk * K * Cp + c;
      const float* wg_c = lv.wgts[l] + blk * K * Cp + c;
#pragma unroll
      for (int k = 0; k < HG_MAX_TAPS; ++k) {
        const float w = k < K ? __ldg(wg_c + (int64_t)k * Cp) : 0.f;
        s_id[warp][k][lane] = w != 0.f ? __ldg(id_c + (int64_t)k * Cp) : -1;
        s_wg[warp][k][lane] = w;
      }
      for (int t0 = 0; t0 < Wd; t0 += 32) {
        unsigned mask = 0;  // the lane's taps in this tile
#pragma unroll
        for (int k = 0; k < HG_MAX_TAPS; ++k)
          mask |= ((unsigned)s_id[warp][k][lane] - (unsigned)t0 < 32u)
                  << k;
        const int rounds = __reduce_max_sync(full, __popc(mask));
        if (rounds == 0) continue;
        float col[DC];
        const bool in = t0 + lane < Wd;
#pragma unroll
        for (int dd = 0; dd < DC; ++dd)
          col[dd] = in && d0 + dd < D
                        ? __ldg(rows + (int64_t)dd * Wd + t0 + lane) : 0.f;
        for (int r = 0; r < rounds; ++r) {
          int src = 0;
          float wk = 0.f;
          if (mask) {
            const int k = __ffs(mask) - 1;  // the lane's next tap
            mask &= mask - 1;
            src = s_id[warp][k][lane] - t0;
            wk = s_wg[warp][k][lane];
          }
#pragma unroll
          for (int dd = 0; dd < DC; ++dd)
            acc[dd] += wk * __shfl_sync(full, col[dd], src);
        }
      }
    }
#pragma unroll
    for (int dd = 0; dd < DC; ++dd)
      if (d0 + dd < D) out[(blk * D + d0 + dd) * Cp + c] = acc[dd];
  }
}

extern "C" {

// All return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes the kernels do not take.
//
// table: per level (rows, wx, h, w, start); seg: (hs, ws, bh, bw).
int win2d_sample_f32(const void* value, const void* anchors, void* out,
                     const void* const* ids, const void* const* wgts,
                     const int64_t* table, const int* seg, int L, int K,
                     int64_t S, int H, int D, int C, int NB, int BH,
                     void* stream) {
  return launch_win2d<float>(value, anchors, out, ids, wgts, table, L, K, S,
                             H, D, C, NB, BH, seg, stream);
}

int win2d_sample_bf16(const void* value, const void* anchors, void* out,
                      const void* const* ids, const void* const* wgts,
                      const int64_t* table, const int* seg, int L, int K,
                      int64_t S, int H, int D, int C, int NB, int BH,
                      void* stream) {
  return launch_win2d<__nv_bfloat16>(value, anchors, out, ids, wgts, table,
                                     L, K, S, H, D, C, NB, BH, seg, stream);
}

// wins[l] [NB, BH, Wd_l, D] f32 -> out [NB, BH, C, D] f32; table as above
// with rows = Wd_l (wx, h, w, start unused).
int win2d_contract_f32(void* out, const void* const* wins,
                       const void* const* ids, const void* const* wgts,
                       const int64_t* table, int L, int K, int D, int C,
                       int NB, int BH, void* stream) {
  return launch_win2d_contract(out, wins, ids, wgts, table, L, K, D, C, NB,
                               BH, stream);
}

// winsT[l] [NB, BH, D, Wd_l] f32, idsT/wgtsT [NB, BH, K, Cp] -> out
// [NB, BH, D, Cp] f32; widths[l] = Wd_l. K <= 16, Cp a multiple of 32.
int hier_gather_f32(void* out, const void* const* winsT,
                    const void* const* idsT, const void* const* wgtsT,
                    const int64_t* widths, int L, int K, int D, int Cp,
                    int NB, int BH, void* stream) {
  if (L < 1 || L > W2D_MAX_LEVELS || K < 1 || K > HG_MAX_TAPS || D < 1 ||
      Cp % 32)
    return (int)cudaErrorInvalidValue;
  WinLevels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.src[l] = winsT[l];
    lv.ids[l] = static_cast<const int*>(idsT[l]);
    lv.wgts[l] = static_cast<const float*>(wgtsT[l]);
    lv.rows[l] = (int)widths[l];
  }
  const int64_t blocks = (int64_t)NB * BH;
  if (blocks == 0 || Cp == 0) return (int)cudaSuccess;
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  // 24 channels a task where D divides into them (2 chunks at D = 48),
  // else 8, the last chunk masked
  if (D % 24 == 0)
    hier_gather_kernel<24><<<(unsigned)blocks, HG_THREADS, 0, st>>>(
        lv, o, L, K, D, Cp);
  else
    hier_gather_kernel<8><<<(unsigned)blocks, HG_THREADS, 0, st>>>(
        lv, o, L, K, D, Cp);
  return (int)cudaGetLastError();
}

}  // extern "C"
