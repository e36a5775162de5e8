// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the backward of K1's trainable driver: `_pallas_with_vjp`
// (snipper_tpu/ops/pallas_deform.py:390-402), whose custom VJP is the XLA
// `core_backward` (snipper_tpu/ops/deform_attn.py:458-474) on the TPU. It
// is the VJP of the function `msda_forward.cu` computes,
//
//   out[n, q, h*D + d] = sum_{l, p} attn[n, q, h, l, p]
//                        * bilinear(value[n, start_l:, h, d], loc[n, q, h, l, p])
//
// for all levels in one launch, with the same grid_sample conventions
// (align_corners=False, zeros off the map; x = ((2u - 1 + 1) * W - 1) / 2,
// so dx/du = W). Given grad_out g [N, Lq, H*D] it writes
//
//   d_attn[t]   = sum_d g[d] * s_t[d],      s_t = the bilinear sample of tap t
//   d_loc[t]    = attn[t] * (W_l * sum_d g[d] * ds_t/dx,
//                            H_l * sum_d g[d] * ds_t/dy)
//   d_value[c] += attn[t] * w_c * g      for each in-map corner c of tap t
//
// Layout: value [N, S, H, D] (f32 or bf16), loc [N, Lq, H, L, P, 2] f32,
// attn [N, Lq, H, L, P] f32, grad_out [N, Lq, H*D] in the value's type.
// Outputs: d_value, d_loc and d_attn, all f32 (for a bf16 value, autograd
// casts d_value to bf16). The level table rides in the kernel's parameter
// block, as in the forward.
//
// Design (simple and right first): one warp per (n, q, h) tap group, lanes
// over d (up to MSDA_MAX_DCHUNK * 32 channels, grad_out held in registers).
// Per tap, each lane forms its channels' share of the three dot products
// (s.g, ds/dx.g, ds/dy.g); warp shuffles reduce them and lane 0 writes
// d_attn and d_loc. d_value is scattered with f32 atomicAdd into the
// caller's zeroed buffer, so its sums run in another order on every run
// (about one f32 ulp per add; the tolerance in chip_smoke.py states it).
// Offsets are int64.
//
// What bounds it: memory. At the train encoder shape (N = B*T = 8,
// Lq = 9875, H*D = 384, L*P = 12) one launch reads value 121.3 MB,
// grad_out 121.3 MB, loc 60.7 MB and attn 30.3 MB (f32) and writes
// d_value 121.3 MB, d_loc 60.7 MB and d_attn 30.3 MB: about 546 MB,
// 0.163 ms at 3.35 TB/s (bf16 value and grad_out: about 425 MB, 0.127 ms).
// The function needs about 16 flops per tap and channel (the four corner
// dots v_c.g and the four scatter products w_c*a*g; d_attn and d_loc are
// per-tap combinations of the dots), 6.1 GFLOP or 0.09 ms at 67 TFLOP/s.
// (Arithmetic; chip_smoke.py computes the bound of each run from its
// inputs and PERF.md holds the measured time against it.) Encoder queries
// sample near their own pixel, so neighbouring warps contend for the same
// d_value rows; that contention, and value rows read four times per tap,
// are left to a later version. The decoder launch (N = B*(T+Tf) = 12,
// Lq = 60) is bound by launch latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_DCHUNK 4  // D <= 128
#define WARPS_PER_BLOCK 8

struct Levels {
  int64_t h[MSDA_MAX_LEVELS];
  int64_t w[MSDA_MAX_LEVELS];
  int64_t start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename scalar_t>
__global__ void msda_backward_kernel(const scalar_t* __restrict__ value,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ attn,
                                     const scalar_t* __restrict__ grad_out,
                                     float* __restrict__ d_value,
                                     float* __restrict__ d_loc,
                                     float* __restrict__ d_attn, int64_t N,
                                     int64_t S, int64_t H, int64_t D,
                                     int64_t Lq, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = N * Lq * H;
  const int64_t warp0 =
      (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int64_t warp_step = (int64_t)gridDim.x * WARPS_PER_BLOCK;
  const int64_t row_stride = H * D;  // between pixels of one (n, h)
  for (int64_t grp = warp0; grp < groups; grp += warp_step) {
    const int64_t h = grp % H;
    const int64_t nq = grp / H;  // n * Lq + q
    const int64_t n = nq / Lq;
    const int64_t tap0 = grp * L * P;  // row (n, q, h) of loc/attn
    // this lane's channels of grad_out, kept in registers
    float g[MSDA_MAX_DCHUNK];
#pragma unroll
    for (int c = 0; c < MSDA_MAX_DCHUNK; ++c) {
      const int64_t d = lane + 32 * c;
      g[c] = d < D ? to_float(grad_out[grp * D + d]) : 0.f;
    }
    const int64_t vbase = n * S * row_stride + h * D;
    for (int l = 0; l < L; ++l) {
      const int64_t hl = lv.h[l], wl = lv.w[l];
      const int64_t lbase = vbase + lv.start[l] * row_stride;
      const float fw = (float)wl, fh = (float)hl;
      for (int p = 0; p < P; ++p) {
        const int64_t t = tap0 + l * P + p;
        const float a = attn[t];
        const float gx = 2.f * loc[2 * t] - 1.f;
        const float gy = 2.f * loc[2 * t + 1] - 1.f;
        const float x = ((gx + 1.f) * fw - 1.f) / 2.f;
        const float y = ((gy + 1.f) * fh - 1.f) / 2.f;
        const float x0f = floorf(x), y0f = floorf(y);
        const int64_t x0 = (int64_t)x0f, y0 = (int64_t)y0f;
        const int64_t x1 = x0 + 1, y1 = y0 + 1;
        const float x1f = x0f + 1.f, y1f = y0f + 1.f;
        const float dx1 = x1f - x, dx0 = x - x0f;  // weights along x
        const float dy1 = y1f - y, dy0 = y - y0f;  // weights along y
        const float w_nw = dx1 * dy1, w_ne = dx0 * dy1;
        const float w_sw = dx1 * dy0, w_se = dx0 * dy0;
        const bool in_x0 = x0 >= 0 && x0 < wl, in_x1 = x1 >= 0 && x1 < wl;
        const bool in_y0 = y0 >= 0 && y0 < hl, in_y1 = y1 >= 0 && y1 < hl;
        const bool ok_nw = in_y0 && in_x0, ok_ne = in_y0 && in_x1;
        const bool ok_sw = in_y1 && in_x0, ok_se = in_y1 && in_x1;
        const int64_t r_nw = lbase + (y0 * wl + x0) * row_stride;
        const int64_t r_ne = lbase + (y0 * wl + x1) * row_stride;
        const int64_t r_sw = lbase + (y1 * wl + x0) * row_stride;
        const int64_t r_se = lbase + (y1 * wl + x1) * row_stride;
        float dot_s = 0.f, dot_x = 0.f, dot_y = 0.f;
#pragma unroll
        for (int c = 0; c < MSDA_MAX_DCHUNK; ++c) {
          const int64_t d = lane + 32 * c;
          if (d >= D) break;
          const float v_nw = ok_nw ? to_float(value[r_nw + d]) : 0.f;
          const float v_ne = ok_ne ? to_float(value[r_ne + d]) : 0.f;
          const float v_sw = ok_sw ? to_float(value[r_sw + d]) : 0.f;
          const float v_se = ok_se ? to_float(value[r_se + d]) : 0.f;
          const float s = w_nw * v_nw + w_ne * v_ne + w_sw * v_sw + w_se * v_se;
          // ds/dx and ds/dy of the bilinear sample
          const float sx = dy1 * (v_ne - v_nw) + dy0 * (v_se - v_sw);
          const float sy = dx1 * (v_sw - v_nw) + dx0 * (v_se - v_ne);
          dot_s += s * g[c];
          dot_x += sx * g[c];
          dot_y += sy * g[c];
          const float ag = a * g[c];
          if (ok_nw) atomicAdd(d_value + r_nw + d, w_nw * ag);
          if (ok_ne) atomicAdd(d_value + r_ne + d, w_ne * ag);
          if (ok_sw) atomicAdd(d_value + r_sw + d, w_sw * ag);
          if (ok_se) atomicAdd(d_value + r_se + d, w_se * ag);
        }
        dot_s = warp_sum(dot_s);
        dot_x = warp_sum(dot_x);
        dot_y = warp_sum(dot_y);
        if (lane == 0) {
          d_attn[t] = dot_s;
          d_loc[2 * t] = a * fw * dot_x;
          d_loc[2 * t + 1] = a * fh * dot_y;
        }
      }
    }
  }
}

template <typename scalar_t>
static int launch(const void* value, const void* loc, const void* attn,
                  const void* grad_out, void* d_value, void* d_loc,
                  void* d_attn, int64_t N, int64_t S, int64_t H, int64_t D,
                  int64_t Lq, int L, int P, const int64_t* shapes,
                  const int64_t* starts, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D < 1 || D > 32 * MSDA_MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    lv.h[l] = l < L ? shapes[2 * l] : 0;
    lv.w[l] = l < L ? shapes[2 * l + 1] : 0;
    lv.start[l] = l < L ? starts[l] : 0;
  }
  const int64_t groups = N * Lq * H;
  if (groups == 0) return (int)cudaSuccess;
  int64_t blocks = (groups + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  msda_backward_kernel<scalar_t>
      <<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
          (const scalar_t*)value, (const float*)loc, (const float*)attn,
          (const scalar_t*)grad_out, (float*)d_value, (float*)d_loc,
          (float*)d_attn, N, S, H, D, Lq, L, P, lv);
  return (int)cudaGetLastError();
}

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success). value
// and grad_out are of the named type; d_value (f32) must be zeroed by the
// caller.
int msda_backward_f32(const void* value, const void* loc, const void* attn,
                      const void* grad_out, void* d_value, void* d_loc,
                      void* d_attn, int64_t N, int64_t S, int64_t H,
                      int64_t D, int64_t Lq, int L, int P,
                      const int64_t* shapes, const int64_t* starts,
                      void* stream) {
  return launch<float>(value, loc, attn, grad_out, d_value, d_loc, d_attn, N,
                       S, H, D, Lq, L, P, shapes, starts, stream);
}

int msda_backward_bf16(const void* value, const void* loc, const void* attn,
                       const void* grad_out, void* d_value, void* d_loc,
                       void* d_attn, int64_t N, int64_t S, int64_t H,
                       int64_t D, int64_t Lq, int L, int P,
                       const int64_t* shapes, const int64_t* starts,
                       void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc,
                               d_attn, N, S, H, D, Lq, L, P, shapes, starts,
                               stream);
}

}  // extern "C"
