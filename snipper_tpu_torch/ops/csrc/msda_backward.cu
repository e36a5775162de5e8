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
// for all levels in one launch, with the same grid_sample conventions
// (align_corners=False, zeros off the map; x = ((2u - 1 + 1) * W - 1) / 2,
// so dx/du = W; msda_common.cuh). Given grad_out g [N, Lq, H*D] it writes
//
//   d_attn[t]   = sum_d g[d] * s_t[d],      s_t = the bilinear sample of tap t
//   d_loc[t]    = attn[t] * (W_l * sum_d g[d] * ds_t/dx,
//                            H_l * sum_d g[d] * ds_t/dy)
//   d_value[c] += attn[t] * w_c * g      for each in-map corner c of tap t
//
// Layout: value [N, S, H, D] (f32 or bf16), loc [N, Lq, H, L, P, 2] f32,
// attn [N, Lq, H, L, P] f32, grad_out [N, Lq, H*D] in the value's type.
// Outputs: d_value, d_loc and d_attn, all f32 (for a bf16 value, autograd
// casts d_value to bf16); d_value is added into the caller's zeroed buffer
// with atomics, so its sums run in another order on every run (about one
// f32 ulp per add; the tolerance in chip_smoke.py states it). The level
// table rides in the kernel's parameter block, as in the forward.
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
// inputs.) Above that sit the gathers and the scatter: 12 taps x 4 corner
// rows read and added per (n, q, h), 5.2 GB each way between the SMs and
// L2 per launch, the adds as atomics.
//
// Design (msda_common.cuh). Scalar adds would make 1.3e9 f32 atomics per
// launch at the train encoder shape, and reducing three dots per tap by
// warp shuffles ran slower than summing four corner dots once per chunk
// (measured); here:
// - a group of threads per (n, q, h), threads over 4-channel vectors (12
//   threads at D = 48, f32 or bf16), groups packed over the block,
//   grad_out held in registers; a block owns one (n, h) and a run of
//   neighbouring queries;
// - each tap's geometry computed once, one tap per thread, into a table in
//   shared memory;
// - per tap a thread accumulates only its part of the four corner dots
//   p_c = v_c . g; the group's parts are summed through shared memory once
//   per chunk of taps, and one thread per tap forms d_attn = sum_c w_c p_c
//   and d_loc from the corner differences, as grid_sample's backward
//   does, and writes them coalesced;
// - d_value's adds are float4 atomics (compute capability 9.x), a quarter
//   of the scalar atomic operations; bf16 values are read 4 channels (8
//   bytes) a thread, so that a warp's float4 adds cover consecutive 16-byte
//   pieces of a row (8 channels a thread left every 32-byte sector half
//   filled by two atomics and ran about 1.9x slower);
// - int32 offsets where every tensor has < 2^31 elements (int64
//   otherwise), and a scalar path, chosen from the sizes, where D is not a
//   multiple of 4 or a row is not aligned.
// The float4 atomics now bound it: without them the same launch took
// 0.77 of its 2.0 ms. A shared-memory box per block, summing each level's
// adds with shared atomics before one global add per row and vector, ran
// 2.0-4.8x slower: on sm_90 an f32 atomicAdd in shared memory is a
// compare-and-swap loop. The decoder launch (N = B*(T+Tf) = 12, Lq = 60)
// is bound by launch latency and by zeroing d_value.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, device time
// of the kernel alone; PERF.md's K1 VJP rows): train encoder 2.016 ms f32,
// 1.971 ms bf16 (PR 3's kernel 4.701 and 4.690 ms on the same card); train
// decoder 0.049 ms f32, 0.046 ms bf16.

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

template <typename T, int VEC, typename idx_t>
__global__ void __launch_bounds__(MSDA_THREADS)
    msda_backward_kernel(const T* __restrict__ value,
                         const float* __restrict__ loc,
                         const float* __restrict__ attn,
                         const T* __restrict__ grad_out,
                         float* __restrict__ d_value,
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
  const idx_t vofs = (idx_t)n * S * row_stride + (idx_t)h * D;
  const T* vbase = value + vofs;
  float* dvbase = d_value + vofs;
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
        const float w[4] = {tp.dx1 * tp.dy1, tp.dx0 * tp.dy1,
                            tp.dx1 * tp.dy0, tp.dx0 * tp.dy0};
        float p[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's part of v_c . g
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int vi = j + k * pl.g;
          if (vi >= pl.nv) break;
          const idx_t ofs = (idx_t)vi * VEC;
          float v[4][VEC];
          load_corners<T, VEC, idx_t>(tp, vbase + ofs, row_stride, v);
          float add[4][VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float ag = tp.a * g[k][e];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              p[c] += v[c][e] * g[k][e];
              add[c][e] = w[c] * ag;
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (tp.row[c] >= 0)
              atomic_add_vec<VEC>(dvbase + (idx_t)tp.row[c] * row_stride + ofs,
                                  add[c]);
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

// value and grad_out are read as vectors of 4 channels (16 bytes in f32,
// 8 in bf16): then the threads' float4 adds into a row of d_value are
// consecutive, where 8 bf16 channels a thread would leave each 32-byte sector
// of d_value half-filled by two separate atomics (1.9x slower, measured).
constexpr int BWD_VEC = 4;

template <typename T, int VEC, typename idx_t>
static void run(const void* value, const void* loc, const void* attn,
                const void* grad_out, void* d_value, void* d_loc,
                void* d_attn, int64_t N, int64_t S, int64_t H, int64_t D,
                int64_t Lq, int L, int P, const Levels& lv, const Plan& pl,
                cudaStream_t stream) {
  const int dyn = pl.qb * pl.tc * (pl.g + 1) * 16;
  msda_backward_kernel<T, VEC, idx_t>
      <<<(unsigned)(N * H * pl.runs), MSDA_THREADS, dyn, stream>>>(
          (const T*)value, (const float*)loc, (const float*)attn,
          (const T*)grad_out, (float*)d_value, (float*)d_loc, (float*)d_attn,
          (int)S, (int)H, (int)D, (int)Lq, L, P, lv, pl);
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  const void* grad_out, void* d_value, void* d_loc,
                  void* d_attn, int64_t N, int64_t S, int64_t H, int64_t D,
                  int64_t Lq, int L, int P, const int64_t* shapes,
                  const int64_t* starts, void* stream) {
  Levels lv;
  if (!fill_levels(L, shapes, starts, &lv) || P < 1 || D < 1 || D > 128 ||
      !aligned(loc, 8) || !aligned(d_loc, 8))
    return (int)cudaErrorInvalidValue;
  if (N * Lq * H == 0) return (int)cudaSuccess;
  const bool vec = D % BWD_VEC == 0 && aligned(value, BWD_VEC * sizeof(T)) &&
                   aligned(grad_out, BWD_VEC * sizeof(T)) &&
                   aligned(d_value, 16);
  Plan pl = make_plan((int)D, vec ? BWD_VEC : 1, L * P, Lq);
  const int tc_dots = MSDA_DOT_ROWS / (pl.qb * (pl.g + 1));
  if (tc_dots < pl.tc) pl.tc = tc_dots;
  if (N * H * pl.runs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool i32 = fits_int32(N, S, H, D, Lq, L * P);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && i32)
    run<T, BWD_VEC, int>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                         N, S, H, D, Lq, L, P, lv, pl, st);
  else if (vec)
    run<T, BWD_VEC, int64_t>(value, loc, attn, grad_out, d_value, d_loc,
                             d_attn, N, S, H, D, Lq, L, P, lv, pl, st);
  else if (i32)
    run<T, 1, int>(value, loc, attn, grad_out, d_value, d_loc, d_attn, N, S,
                   H, D, Lq, L, P, lv, pl, st);
  else
    run<T, 1, int64_t>(value, loc, attn, grad_out, d_value, d_loc, d_attn, N,
                       S, H, D, Lq, L, P, lv, pl, st);
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
