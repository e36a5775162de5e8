// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `weighted_onehot_sample` (kernel `_kernel`,
// snipper_tpu/ops/pallas_deform.py:43-104) together with its per-level
// caller `ms_deform_attn_pallas` (pallas_deform.py:107-170). On the TPU,
// Mosaic has no VMEM gather, so each level is sampled as a weighted one-hot
// matrix contracted on the MXU, one launch per level. A GPU gathers rows
// directly, so this kernel is a plain four-corner gather over all levels in
// one launch:
//
//   out[n, q, h*D + d] = sum_{l, p} attn[n, q, h, l, p]
//                        * bilinear(value[n, start_l : start_l + H_l*W_l, h, d],
//                                   loc[n, q, h, l, p])
//
// with grid_sample(align_corners=False, padding_mode="zeros") semantics:
// a normalized location u maps to the pixel coordinate u * W_l - 0.5 and
// corners outside the map weigh 0. The coordinate and the corner weights
// are computed in the same steps as grid_sample's (g = 2u - 1,
// x = ((g + 1) * W - 1) / 2; nw = (x1 - x)(y1 - y), ...), so the kernel and
// the plain PyTorch version differ only in the order of the f32 sums.
//
// Layout: value [N, S, H, D] (f32 or bf16), loc [N, Lq, H, L, P, 2] f32,
// attn [N, Lq, H, L, P] f32 (already softmaxed and divided by the frame
// count), out [N, Lq, H*D] in the value's type, accumulated in f32. The
// level table (H_l, W_l, start_l) is passed by value in the kernel's
// parameter block, so no host-to-device copy stalls the stream.
//
// Design: one thread per output element (n, q, h, d). Consecutive threads
// take consecutive d, so a warp reads 32 consecutive channels of one value
// row (coalesced; D = 48 rows are 192 bytes in f32), and the loc/attn
// reads of the threads of one (n, q, h) are broadcasts from L1. Offsets
// are int64.
//
// What bounds it: memory. At the canonical encoder shape (N = 4 frames,
// Lq = 9875 queries, H = 8, D = 48, L = 3, P = 4) one launch must move
// about 167 MB in f32 (value 60.7 MB, loc 30.3 MB, attn 15.2 MB, out
// 60.7 MB): about 50 us at 3.35 TB/s, against about 1.5 GFLOP, 23 us at the
// card's 67 TFLOP/s of f32. The decoder launch (Lq = 60) touches a few MB
// and is bound by launch latency. This first version is simple and right;
// making it fast is work for later: value rows staged in shared memory,
// 16-byte vector loads, a bf16 value, loc/attn fused from the projections.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int64_t h[MSDA_MAX_LEVELS];
  int64_t w[MSDA_MAX_LEVELS];
  int64_t start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename scalar_t>
__global__ void msda_forward_kernel(const scalar_t* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ attn,
                                    scalar_t* __restrict__ out,
                                    int64_t N, int64_t S, int64_t H,
                                    int64_t D, int64_t Lq, int L, int P,
                                    Levels lv) {
  const int64_t total = N * Lq * H * D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t d = i % D;
    const int64_t h = (i / D) % H;
    const int64_t nq = i / (D * H);  // n * Lq + q
    const int64_t n = nq / Lq;
    // row (n, q, h) of loc/attn: [L, P] taps
    const int64_t tap0 = (nq * H + h) * L * P;
    const scalar_t* vbase = value + n * S * H * D + h * D + d;
    const int64_t row_stride = H * D;  // between pixels of one (n, h)
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int64_t hl = lv.h[l], wl = lv.w[l];
      const scalar_t* vl = vbase + lv.start[l] * row_stride;
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
        const float w_nw = (x1f - x) * (y1f - y);
        const float w_ne = (x - x0f) * (y1f - y);
        const float w_sw = (x1f - x) * (y - y0f);
        const float w_se = (x - x0f) * (y - y0f);
        const bool in_x0 = x0 >= 0 && x0 < wl, in_x1 = x1 >= 0 && x1 < wl;
        const bool in_y0 = y0 >= 0 && y0 < hl, in_y1 = y1 >= 0 && y1 < hl;
        float s = 0.f;
        if (in_y0 && in_x0) s += w_nw * to_float(vl[(y0 * wl + x0) * row_stride]);
        if (in_y0 && in_x1) s += w_ne * to_float(vl[(y0 * wl + x1) * row_stride]);
        if (in_y1 && in_x0) s += w_sw * to_float(vl[(y1 * wl + x0) * row_stride]);
        if (in_y1 && in_x1) s += w_se * to_float(vl[(y1 * wl + x1) * row_stride]);
        acc += a * s;
      }
    }
    // out [N, Lq, H*D] has the same flat order as (n, q, h, d)
    store(out + i, acc);
  }
}

template <typename scalar_t>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int64_t N, int64_t S, int64_t H, int64_t D,
                  int64_t Lq, int L, int P, const int64_t* shapes,
                  const int64_t* starts, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    lv.h[l] = l < L ? shapes[2 * l] : 0;
    lv.w[l] = l < L ? shapes[2 * l + 1] : 0;
    lv.start[l] = l < L ? starts[l] : 0;
  }
  const int64_t total = N * Lq * H * D;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  msda_forward_kernel<scalar_t><<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      (const scalar_t*)value, (const float*)loc, (const float*)attn,
      (scalar_t*)out, N, S, H, D, Lq, L, P, lv);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int msda_forward_f32(const void* value, const void* loc, const void* attn,
                     void* out, int64_t N, int64_t S, int64_t H, int64_t D,
                     int64_t Lq, int L, int P, const int64_t* shapes,
                     const int64_t* starts, void* stream) {
  return launch<float>(value, loc, attn, out, N, S, H, D, Lq, L, P, shapes,
                       starts, stream);
}

int msda_forward_bf16(const void* value, const void* loc, const void* attn,
                      void* out, int64_t N, int64_t S, int64_t H, int64_t D,
                      int64_t Lq, int L, int P, const int64_t* shapes,
                      const int64_t* starts, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, out, N, S, H, D, Lq, L, P,
                               shapes, starts, stream);
}

}  // extern "C"
