// Per-tile front-to-back alpha blend, forward (sm_90a, plain C interface).
//
// Replaces the TPU kernel ht3dgs/raster/pallas_blend.py::_blend_fwd_kernel
// (launched by _blend_tiles_pallas_raw, pl.pallas_call at l.264).
//
// Inputs:  ent  [T, K, 16] f32 packed rows (mx, my, ca, cb, cc, r, g, b, op,
//                depth, unused...), meta [T, 4] i32 (count, origin_x,
//                origin_y, 0).
// Outputs: rgb [T, P, 3], t_fin [T, P], depth [T, P], ncon [T, P] (the kept
//          count over entries < count), all f32, P = tile_h * tile_w.
//
// Design (built for 16x16 and 8x16 tiles): one CTA of P/2 threads per tile,
// two vertically adjacent pixels per thread; transmittance and the sticky
// stop state stay in registers. The two pixels share a column, so one set of
// row loads (three 16-byte shared loads per entry), the loop control and the
// column terms ca dx^2 and cb dx serve two evaluations, and the two exp
// chains overlap.
// Entries are staged through shared memory CHUNK rows at a time with
// cp.async into two buffers: chunk c + 1 is in flight while chunk c is
// blended. After each chunk the block votes and leaves once no pixel is live.
//
// Bound on the card: operations. Each entry-pixel evaluation costs ~26 f32
// operations and one exp, against 64 bytes per entry row shared by the tile's
// P pixels, so arithmetic intensity is far above the H100's f32 ridge point.
// The kernel executes one instruction per operation (see Numerics), so its
// ceiling is half the f32 FMA peak.
//
// Numerics and flags: built with -fmad=false. A pixel stops at the first
// entry that takes its transmittance below 1e-4; for the kernel to stop at
// the same entry as blend_fwd_plain (raster/blend.py), power, alpha and the
// transmittance product must round as the plain version's separate
// multiplies and adds do, in the same order, so nothing may be contracted
// into an FMA. The colour and depth sums, which decide nothing, use explicit
// fused multiply-adds (__fmaf_rn): they agree with the plain version to
// rounding, within the card check's tolerances.

#include "blend_common.cuh"

namespace {

// A pixel that has stopped carries trans = 0, so that no later entry can
// keep it (0 * (1 - alpha) < 1e-4); t_fin is the transmittance it stopped at.
struct Pixel {
  float trans = 1.0f, t_fin = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
  int kept = 0;
};

// One entry at one pixel. q0 = (mx, my, ca, cb), q1 = (cc, r, g, b),
// q2 = (op, depth, -, -); ca_dx_dx = (ca * dx) * dx and cb_dx = cb * dx are
// shared with the other pixel of the column.
__device__ __forceinline__ void blend_entry(Pixel& s, float py, float ca_dx_dx,
                                            float cb_dx, const float4& q0,
                                            const float4& q1,
                                            const float4& q2) {
  const float dy = py - q0.y;
  const float power = -0.5f * (ca_dx_dx + q1.x * dy * dy) - cb_dx * dy;
  float alpha = fminf(q2.x * expf(power), alpha_max());
  if (!(power <= 0.0f && alpha >= alpha_min())) alpha = 0.0f;
  const float t_after = s.trans * (1.0f - alpha);
  const bool keep = !(t_after < t_eps());
  if (keep) {
    const float w = alpha * s.trans;
    s.r = __fmaf_rn(w, q1.y, s.r);
    s.g = __fmaf_rn(w, q1.z, s.g);
    s.b = __fmaf_rn(w, q1.w, s.b);
    s.d = __fmaf_rn(w, q2.y, s.d);
    s.t_fin = t_after;
    ++s.kept;
  }
  s.trans = keep ? t_after : 0.0f;
}

__device__ __forceinline__ bool live(const Pixel& a, const Pixel& b) {
  return fmaxf(a.trans, b.trans) > 0.0f;
}

__device__ __forceinline__ void store(const Pixel& s, size_t o, float* rgb,
                                      float* t_fin, float* depth,
                                      float* ncon) {
  rgb[3 * o + 0] = s.r;
  rgb[3 * o + 1] = s.g;
  rgb[3 * o + 2] = s.b;
  t_fin[o] = s.t_fin;
  depth[o] = s.d;
  ncon[o] = (float)s.kept;
}

template <int TH, int TW>
__global__ void __launch_bounds__(TH * TW / 2)
blend_fwd_kernel(const float* __restrict__ ent, const int* __restrict__ meta,
                 float* __restrict__ rgb, float* __restrict__ t_fin,
                 float* __restrict__ depth, float* __restrict__ ncon, int K) {
  constexpr int P = TH * TW;
  constexpr int NT = P / 2;
  static_assert(TH % 2 == 0, "pixel pairs are vertical");
  __shared__ float4 rows[2][CHUNK * 4];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int u = tid % TW;
  const int v = 2 * (tid / TW);          // pixels (u, v) and (u, v + 1)
  const int count = min(meta[4 * t + 0], K);
  const float px = (float)(meta[4 * t + 1] + u);
  const float py0 = (float)(meta[4 * t + 2] + v);
  const float py1 = (float)(meta[4 * t + 2] + v + 1);
  const float4* src = reinterpret_cast<const float4*>(ent) + (size_t)t * K * 4;

  Pixel a, b;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  stage_rows<NT, CHUNK>(rows[0], src, min(CHUNK, count), tid);
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * CHUNK;
    const int n = min(CHUNK, count - base);
    // chunk c + 1 (none past the count) is copied while chunk c is blended
    stage_rows<NT, CHUNK>(rows[(c + 1) & 1], src + (size_t)(base + CHUNK) * 4,
                          count - base - CHUNK, tid);
    cp_async_wait<1>();   // chunk c has landed
    __syncthreads();
    const float4* r = rows[c & 1];
    const float4* const r_end = r + 4 * n;
#pragma unroll 1
    for (; r < r_end && live(a, b); r += 4) {
      const float4 q0 = r[0];
      const float4 q1 = r[1];
      const float4 q2 = r[2];
      const float dx = px - q0.x;
      const float ca_dx_dx = q0.z * dx * dx;
      const float cb_dx = q0.w * dx;
      blend_entry(a, py0, ca_dx_dx, cb_dx, q0, q1, q2);
      blend_entry(b, py1, ca_dx_dx, cb_dx, q0, q1, q2);
    }
    // the vote is also the barrier before chunk c + 2 overwrites rows[c & 1]
    if (!__syncthreads_or(live(a, b))) break;
  }
  cp_async_wait<0>();

  const size_t o = (size_t)t * P + v * TW + u;
  store(a, o, rgb, t_fin, depth, ncon);
  store(b, o + TW, rgb, t_fin, depth, ncon);
}

template <int TH, int TW>
cudaError_t launch(const float* ent, const int* meta, float* rgb,
                   float* t_fin, float* depth, float* ncon, int T, int K,
                   cudaStream_t stream) {
  blend_fwd_kernel<TH, TW><<<T, TH * TW / 2, 0, stream>>>(
      ent, meta, rgb, t_fin, depth, ncon, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t ht3dgs_blend_fwd(const float* ent, const int* meta,
                                        float* rgb, float* t_fin,
                                        float* depth, float* ncon, int T,
                                        int K, int tile_h, int tile_w,
                                        cudaStream_t stream) {
  if (T <= 0) return cudaGetLastError();
  if (tile_h == 16 && tile_w == 16) {
    return launch<16, 16>(ent, meta, rgb, t_fin, depth, ncon, T, K, stream);
  }
  if (tile_h == 8 && tile_w == 16) {
    return launch<8, 16>(ent, meta, rgb, t_fin, depth, ncon, T, K, stream);
  }
  return cudaErrorInvalidValue;
}
