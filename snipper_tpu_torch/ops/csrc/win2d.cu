// Windowed sampling contractions for Hopper (sm_90a): K2, K5 and K4 of the
// JAX package's TPU kernels.
//
// win2d_sample replaces `_win2d_segment` + `_win2d_kernel_factory`
// (snipper_tpu/ops/pallas_deform.py:186-337), driven per query segment by
// `ms_deform_attn_windowed2d_pallas` (:340). For one 2D query block and one
// (batch, head) it stages, level by level, the (wy, wx) window of the level
// at the block's anchor and contracts the point-merged taps of each query
// against it:
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
// the result written as [NB, BH, C, D]. The two share `contract_tile`.
//
// hier_gather replaces `hier_gather_sample` (lanegather_probe.py:164-190):
// the same contraction on the transposed layout, winsT[l] [NB, BH, D, Wd_l]
// and idsT/wgtsT [NB, BH, K, Cp] -> out [NB, BH, D, Cp].
//
// Design. The TPU has no VMEM gather, so K2 and K5 build a weighted one-hot
// [C, Wd] and contract it on the MXU, and K4 asks whether Mosaic's in-tile
// lane gather beats that. A GPU gathers from shared memory directly:
// - win2d_sample / win2d_contract: one block per (query block, b*h); the
//   window goes into dynamic shared memory a tile of rows at a time (all of
//   it at once when it fits the budget), and each thread accumulates its
//   (query, channel) outputs over the taps whose id falls in the tile, with
//   f32 weights and an f32 sum held in shared memory across levels and
//   tiles.
// - hier_gather asks the TPU probe's question of the card: a warp holds a
//   32-column tile of one channel row of the transposed window in
//   registers, one column per lane, and each lane takes a tap's value with
//   __shfl_sync when the tap's id falls in that tile, masked otherwise. The
//   two timings side by side are the card's answer (PERF.md).
//
// What bounds them: memory. The least bytes are the ids and weights (8 bytes
// a tap), the window rows the taps touch, and the output; the contraction is
// 2 flops a tap and channel. At the probe's encoder fixture win2d_sample
// must move about 0.2 GB (~0.07 ms at 3.35 TB/s). This first version is
// simple: it stages whole windows whether or not every row is touched, and
// re-reads each query's taps for every tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define W2D_MAX_LEVELS 8
#define W2D_THREADS 256
// dynamic shared memory of one block: the f32 accumulator [C, D] plus one
// tile of window rows; two blocks fit on one SM
#define W2D_SMEM_BUDGET (100 * 1024)
#define HG_MAX_TAPS 16
#define HG_THREADS 256

struct Levels {
  const void* src[W2D_MAX_LEVELS];    // wins[l] (contract) or unused (sample)
  const int* ids[W2D_MAX_LEVELS];     // [NB, BH, C, K]
  const float* wgts[W2D_MAX_LEVELS];  // [NB, BH, C, K]
  int rows[W2D_MAX_LEVELS];           // window rows: wy * wx, or Wd
  int wx[W2D_MAX_LEVELS];             // window width (sample)
  int64_t h[W2D_MAX_LEVELS], w[W2D_MAX_LEVELS], start[W2D_MAX_LEVELS];
};

struct Segment {  // win2d_sample: the query segment's pixel grid and blocks
  int hs, ws, bh, bw, nbx;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[c, d] += sum over taps k of query c whose id lies in [r0, r0 + n):
// wgt[c, k] * tile[id - r0, d]. Each thread owns the same (c, d) entries in
// every call, so acc needs no synchronisation.
template <typename T>
__device__ __forceinline__ void contract_tile(const T* tile, int r0, int n,
                                              const int* __restrict__ ids,
                                              const float* __restrict__ wgts,
                                              int C, int K, int D,
                                              float* acc) {
  for (int i = threadIdx.x; i < C * D; i += blockDim.x) {
    const int c = i / D, d = i - c * D;
    const int* id_c = ids + (int64_t)c * K;
    const float* wg_c = wgts + (int64_t)c * K;
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const int r = id_c[k] - r0;
      const float wk = wg_c[k];
      if (r >= 0 && r < n && wk != 0.f) s += wk * to_float(tile[r * D + d]);
    }
    acc[i] += s;
  }
}

// One block per (nb, bh). kSample: stage windows from value [B, S, H, D] at
// the anchors [L, NB, 2] (y_lo, x_lo) and write out [B, hs*ws, H*D];
// otherwise stage wins[l] [NB, BH, Wd, D] and write out [NB, BH, C, D].
template <typename T, bool kSample>
__global__ void __launch_bounds__(W2D_THREADS)
win2d_kernel(const T* __restrict__ value, const int* __restrict__ anchors,
             void* __restrict__ out, Levels lv, Segment sg, int L, int K,
             int64_t S, int H, int D, int C, int NB, int BH, int tile_rows) {
  extern __shared__ float smem[];
  float* acc = smem;                          // [C, D]
  T* tile = reinterpret_cast<T*>(smem + C * D);  // [tile_rows, D]
  const int nb = blockIdx.x / BH, bh = blockIdx.x - nb * BH;
  const int64_t blk = (int64_t)nb * BH + bh;
  const int b = bh / H, hh = bh - b * H;
  for (int i = threadIdx.x; i < C * D; i += blockDim.x) acc[i] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int rows = lv.rows[l];
    const int* ids = lv.ids[l] + blk * C * K;
    const float* wgts = lv.wgts[l] + blk * C * K;
    for (int r0 = 0; r0 < rows; r0 += tile_rows) {
      const int n = min(tile_rows, rows - r0);
      __syncthreads();  // the previous tile is consumed
      if constexpr (kSample) {
        const int y_lo = anchors[((int64_t)l * NB + nb) * 2];
        const int x_lo = anchors[((int64_t)l * NB + nb) * 2 + 1];
        const int wx = lv.wx[l];
        const int64_t hl = lv.h[l], wl = lv.w[l];
        const T* vb = value + ((int64_t)b * S + lv.start[l]) * H * D
                      + (int64_t)hh * D;
        for (int j = threadIdx.x; j < n * D; j += blockDim.x) {
          const int r = r0 + j / D, d = j - (j / D) * D;
          const int64_t y = y_lo + r / wx, x = x_lo + r % wx;
          tile[j] = (y < hl && x < wl) ? vb[(y * wl + x) * H * D + d]
                                       : static_cast<T>(0.f);
        }
      } else {
        const T* win = static_cast<const T*>(lv.src[l])
                       + (blk * rows + r0) * D;
        for (int j = threadIdx.x; j < n * D; j += blockDim.x) tile[j] = win[j];
      }
      __syncthreads();
      contract_tile(tile, r0, n, ids, wgts, C, K, D, acc);
    }
  }

  for (int i = threadIdx.x; i < C * D; i += blockDim.x) {
    if constexpr (kSample) {
      const int c = i / D, d = i - c * D;
      const int y = (nb / sg.nbx) * sg.bh + c / sg.bw;
      const int x = (nb % sg.nbx) * sg.bw + c % sg.bw;
      if (y < sg.hs && x < sg.ws)
        store(static_cast<T*>(out)
                  + (((int64_t)b * sg.hs * sg.ws + y * sg.ws + x) * H + hh)
                        * D + d,
              acc[i]);
    } else {
      static_cast<float*>(out)[blk * C * D + i] = acc[i];
    }
  }
}

template <typename T, bool kSample>
static int launch_win2d(const void* value, const void* anchors, void* out,
                        const void* const* src, const void* const* ids,
                        const void* const* wgts, const int64_t* table,
                        int L, int K, int64_t S, int H, int D, int C, int NB,
                        int BH, const int* seg, void* stream) {
  if (L < 1 || L > W2D_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int max_rows = 0;
  for (int l = 0; l < L; ++l) {
    // table rows: (rows, wx, h, w, start)
    lv.src[l] = src ? src[l] : nullptr;
    lv.ids[l] = static_cast<const int*>(ids[l]);
    lv.wgts[l] = static_cast<const float*>(wgts[l]);
    lv.rows[l] = (int)table[5 * l];
    lv.wx[l] = (int)table[5 * l + 1];
    lv.h[l] = table[5 * l + 2];
    lv.w[l] = table[5 * l + 3];
    lv.start[l] = table[5 * l + 4];
    if (lv.rows[l] > max_rows) max_rows = lv.rows[l];
  }
  Segment sg = {};
  if (seg)
    sg = Segment{seg[0], seg[1], seg[2], seg[3],
                 (seg[1] + seg[3] - 1) / seg[3]};
  const int64_t acc_bytes = (int64_t)C * D * sizeof(float);
  const int64_t row_bytes = (int64_t)D * sizeof(T);
  int64_t tile_rows = (W2D_SMEM_BUDGET - acc_bytes) / row_bytes;
  if (tile_rows > max_rows) tile_rows = max_rows;
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(acc_bytes + tile_rows * row_bytes);
  auto kernel = win2d_kernel<T, kSample>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)NB * BH;
  if (blocks == 0) return (int)cudaSuccess;
  kernel<<<(unsigned)blocks, W2D_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(anchors), out, lv,
      sg, L, K, S, H, D, C, NB, BH, (int)tile_rows);
  return (int)cudaGetLastError();
}

// One block per (nb, bh); each warp takes (group of 32 queries, channel d)
// tasks. Lane j owns query c = 32 * group + j and holds its K <= 16 taps of
// the level in registers; per 32-column tile of channel row d of winT, lane
// j loads column j, and each lane shuffles in the column its tap names.
__global__ void __launch_bounds__(HG_THREADS)
hier_gather_kernel(Levels lv, float* __restrict__ out, int L, int K, int D,
                   int Cp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t blk = blockIdx.x;
  const int groups = Cp / 32;
  for (int task = warp; task < groups * D; task += nwarps) {
    const int g = task / D, d = task - g * D;
    const int c = g * 32 + lane;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int Wd = lv.rows[l];
      const float* row = static_cast<const float*>(lv.src[l])
                         + (blk * D + d) * Wd;
      const int* id_c = lv.ids[l] + blk * K * Cp + c;
      const float* wg_c = lv.wgts[l] + blk * K * Cp + c;
      int id[HG_MAX_TAPS];
      float wg[HG_MAX_TAPS];
#pragma unroll
      for (int k = 0; k < HG_MAX_TAPS; ++k) {
        id[k] = k < K ? id_c[(int64_t)k * Cp] : -1;
        wg[k] = k < K ? wg_c[(int64_t)k * Cp] : 0.f;
      }
      for (int t0 = 0; t0 < Wd; t0 += 32) {
        const float col = t0 + lane < Wd ? row[t0 + lane] : 0.f;
#pragma unroll
        for (int k = 0; k < HG_MAX_TAPS; ++k) {
          const int local = id[k] - t0;
          const float v = __shfl_sync(0xffffffffu, col, local & 31);
          if (local >= 0 && local < 32) acc += wg[k] * v;
        }
      }
    }
    out[(blk * D + d) * Cp + c] = acc;
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
  return launch_win2d<float, true>(value, anchors, out, nullptr, ids, wgts,
                                   table, L, K, S, H, D, C, NB, BH, seg,
                                   stream);
}

int win2d_sample_bf16(const void* value, const void* anchors, void* out,
                      const void* const* ids, const void* const* wgts,
                      const int64_t* table, const int* seg, int L, int K,
                      int64_t S, int H, int D, int C, int NB, int BH,
                      void* stream) {
  return launch_win2d<__nv_bfloat16, true>(value, anchors, out, nullptr, ids,
                                           wgts, table, L, K, S, H, D, C, NB,
                                           BH, seg, stream);
}

// wins[l] [NB, BH, Wd_l, D] f32 -> out [NB, BH, C, D] f32; table as above
// with rows = Wd_l (wx, h, w, start unused).
int win2d_contract_f32(void* out, const void* const* wins,
                       const void* const* ids, const void* const* wgts,
                       const int64_t* table, int L, int K, int D, int C,
                       int NB, int BH, void* stream) {
  return launch_win2d<float, false>(nullptr, nullptr, out, wins, ids, wgts,
                                    table, L, K, 0, 1, D, C, NB, BH, nullptr,
                                    stream);
}

// winsT[l] [NB, BH, D, Wd_l] f32, idsT/wgtsT [NB, BH, K, Cp] -> out
// [NB, BH, D, Cp] f32; widths[l] = Wd_l. K <= 16, Cp a multiple of 32.
int hier_gather_f32(void* out, const void* const* winsT,
                    const void* const* idsT, const void* const* wgtsT,
                    const int64_t* widths, int L, int K, int D, int Cp,
                    int NB, int BH, void* stream) {
  if (L < 1 || L > W2D_MAX_LEVELS || K < 1 || K > HG_MAX_TAPS || Cp % 32)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.src[l] = winsT[l];
    lv.ids[l] = static_cast<const int*>(idsT[l]);
    lv.wgts[l] = static_cast<const float*>(wgtsT[l]);
    lv.rows[l] = (int)widths[l];
  }
  const int64_t blocks = (int64_t)NB * BH;
  if (blocks == 0) return (int)cudaSuccess;
  hier_gather_kernel<<<(unsigned)blocks, HG_THREADS, 0,
                       (cudaStream_t)stream>>>(lv, static_cast<float*>(out),
                                               L, K, D, Cp);
  return (int)cudaGetLastError();
}

}  // extern "C"
