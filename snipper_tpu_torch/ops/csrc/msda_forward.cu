// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `weighted_onehot_sample` (kernel `_kernel`,
// snipper_tpu/ops/pallas_deform.py:43-104) together with its per-level
// caller `ms_deform_attn_pallas` (pallas_deform.py:107-170). On the TPU,
// Mosaic has no VMEM gather, so each level is sampled as a weighted one-hot
// matrix contracted on the MXU, one launch per level. A GPU gathers rows
// directly, so this kernel is a four-corner gather over all levels in one
// launch:
//
//   out[n, q, h*D + d] = sum_{l, p} attn[n, q, h, l, p]
//                        * bilinear(value[n, start_l : start_l + H_l*W_l, h, d],
//                                   loc[n, q, h, l, p])
//
// with grid_sample(align_corners=False, padding_mode="zeros") semantics:
// a normalized location u maps to the pixel coordinate u * W_l - 0.5 and
// corners outside the map weigh 0. The coordinate and the corner weights
// are computed in the same steps as grid_sample's (g = 2u - 1,
// x = ((g + 1) * W - 1) / 2; nw = (x1 - x)(y1 - y), ...; msda_common.cuh),
// so the kernel and the plain PyTorch version differ only in the order of
// the f32 sums.
//
// Layout: value [N, S, H, D] (f32 or bf16), loc [N, Lq, H, L, P, 2] f32,
// attn [N, Lq, H, L, P] f32 (already softmaxed and divided by the frame
// count), out [N, Lq, H*D] in the value's type, accumulated in f32. The
// level table (H_l, W_l, start_l) is passed by value in the kernel's
// parameter block, so no host-to-device copy stalls the stream.
//
// What bounds it: memory. At the inference encoder shape (N = 4 frames,
// Lq = 9875 queries, H = 8, D = 48, L = 3, P = 4) one launch must move
// about 167 MB in f32 (value 60.7 MB, loc 30.3 MB, attn 15.2 MB, out
// 60.7 MB): 0.050 ms at 3.35 TB/s, against about 1.5 GFLOP, 0.023 ms at
// the card's 67 TFLOP/s of f32; at the train encoder shape with a bf16
// value (N = 8) about 212 MB, 0.063 ms. (chip_smoke.py computes the bound
// of each run from its inputs.) Above that sit the gathers themselves:
// each (n, q, h) reads 12 taps x 4 corner rows of D channels, 2.9 GB of
// row reads per inference launch, served from L1 and L2.
//
// Design (msda_common.cuh). A thread per output element would recompute
// an (n, q, h)'s 12 taps on each of its 48 channels, re-read their
// loc/attn, divide 64-bit indices by D, H and Lq per element and load
// scalars; here:
// - a group of threads per (n, q, h), threads over 16-byte channel vectors
//   (12 threads of float4 at D = 48 in f32, 6 of 8 x bf16), groups packed
//   over the block (21 or 42 to its 256 threads); a block owns one (n, h)
//   and a run of neighbouring queries;
// - each tap's geometry computed once, one tap per thread, into a table in
//   shared memory that the groups read back as broadcasts;
// - the four corner rows of a tap read as 16-byte vectors, all four in
//   flight, and the output stored as one 16-byte vector per thread;
// - f32 accumulation, int32 offsets where every tensor has < 2^31
//   elements (int64 otherwise), and a scalar path, chosen from the sizes,
//   where D is not a multiple of the vector or a row is not 16-byte
//   aligned.
// Two taps at a time (eight loads in flight) and 4-channel bf16 vectors
// ran slower; groups packed per warp rather than per block leave 8 of 32
// lanes idle and ran 12-19% slower in f32 (measured in one call). The
// decoder launch (Lq = 60) touches a few MB and is bound by launch
// latency.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, device time
// of the kernel alone; PERF.md's K1 rows): inference encoder 0.291 ms f32,
// 0.202 ms bf16 (PR 3's kernel 0.989 and 1.029 ms on the same card); train
// encoder 0.570 ms f32, 0.397 ms bf16; decoders 0.010-0.022 ms.

#include "msda_common.cuh"

template <typename T, int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
    msda_forward_kernel(const T* __restrict__ value,
                        const float* __restrict__ loc,
                        const float* __restrict__ attn, T* __restrict__ out,
                        int S, int H, int D, int Lq, int L, int P, Levels lv,
                        Plan pl) {
  constexpr int KV = VEC == 1 ? 4 : 1;  // vectors per thread in one pass
  __shared__ Tap table[MSDA_THREADS];
  int n, h, run;
  block_coords(pl, H, n, h, run);
  const int LP = L * P;
  const int q0 = run * pl.qb;
  const int gi = threadIdx.x / pl.g, j = threadIdx.x - gi * pl.g;
  const int q = q0 + gi;
  const bool active = gi < pl.qb && q < Lq;
  const idx_t row_stride = (idx_t)H * D;  // between pixels of one (n, h)
  const idx_t q_stride = (idx_t)H * LP;   // between queries in loc/attn
  const idx_t row0 = ((idx_t)n * Lq + q0) * q_stride + (idx_t)h * LP;
  const T* vbase = value + (idx_t)n * S * row_stride + (idx_t)h * D;
  // passes over the thread's vectors; one pass wherever D <= 32 * VEC * KV
  for (int k0 = 0; k0 < pl.vpl; k0 += KV) {
    float acc[KV][VEC];
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    for (int t0 = 0; t0 < LP; t0 += pl.tc) {
      __syncthreads();
      fill_taps(table, pl, t0, LP, P, q0, Lq, row0, q_stride, loc, attn, lv);
      __syncthreads();
      if (!active) continue;
      const int nt = min(pl.tc, LP - t0);
      for (int s = 0; s < nt; ++s) {
        const Tap tp = table[gi * pl.tc + s];
        const float w[4] = {tp.dx1 * tp.dy1, tp.dx0 * tp.dy1,
                            tp.dx1 * tp.dy0, tp.dx0 * tp.dy0};
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int vi = j + (k0 + k) * pl.g;
          if (vi >= pl.nv) break;
          float v[4][VEC];
          load_corners<T, VEC, idx_t>(tp, vbase + (idx_t)vi * VEC,
                                      row_stride, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float smp = w[0] * v[0][e] + w[1] * v[1][e] +
                              w[2] * v[2][e] + w[3] * v[3][e];
            acc[k][e] += tp.a * smp;
          }
        }
      }
    }
    if (active) {
      // out [N, Lq, H*D]: the (n, q, h) row is D contiguous elements
      T* o = out + ((idx_t)n * Lq + q) * row_stride + (idx_t)h * D;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int vi = j + (k0 + k) * pl.g;
        if (vi >= pl.nv) break;
        VecIO<T, VEC>::store(o + (idx_t)vi * VEC, acc[k]);
      }
    }
  }
}

template <typename T, int VEC, typename idx_t>
static void run(const void* value, const void* loc, const void* attn,
                void* out, int64_t N, int64_t S, int64_t H, int64_t D,
                int64_t Lq, int L, int P, const Levels& lv, const Plan& pl,
                cudaStream_t stream) {
  msda_forward_kernel<T, VEC, idx_t>
      <<<(unsigned)(N * H * pl.runs), MSDA_THREADS, 0, stream>>>(
          (const T*)value, (const float*)loc, (const float*)attn, (T*)out,
          (int)S, (int)H, (int)D, (int)Lq, L, P, lv, pl);
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int64_t N, int64_t S, int64_t H, int64_t D,
                  int64_t Lq, int L, int P, const int64_t* shapes,
                  const int64_t* starts, void* stream) {
  Levels lv;
  if (!fill_levels(L, shapes, starts, &lv) || P < 1 || D < 1 ||
      !aligned(loc, 8))
    return (int)cudaErrorInvalidValue;
  if (N * Lq * H == 0) return (int)cudaSuccess;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = D % VEC == 0 && aligned(value, 16) && aligned(out, 16);
  const Plan pl = make_plan((int)D, vec ? VEC : 1, L * P, Lq);
  if (N * H * pl.runs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool i32 = fits_int32(N, S, H, D, Lq, L * P);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && i32)
    run<T, VEC, int>(value, loc, attn, out, N, S, H, D, Lq, L, P, lv, pl, st);
  else if (vec)
    run<T, VEC, int64_t>(value, loc, attn, out, N, S, H, D, Lq, L, P, lv, pl,
                         st);
  else if (i32)
    run<T, 1, int>(value, loc, attn, out, N, S, H, D, Lq, L, P, lv, pl, st);
  else
    run<T, 1, int64_t>(value, loc, attn, out, N, S, H, D, Lq, L, P, lv, pl,
                       st);
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
