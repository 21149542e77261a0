// Per-tile alpha blend, backward: one back-to-front replay (sm_90a, plain C
// interface).
//
// Replaces the TPU kernel ht3dgs/raster/pallas_blend.py::_bwd_onepass_kernel
// (launched by _blend_bwd_pallas, pl.pallas_call at l.467).
//
// Inputs:  ent [T, K, 16] f32, meta [T, 4] i32, t_fin [T, P] and ncon [T, P]
//          from the forward, cotangents d_rgb [T, P, 3], d_t [T, P],
//          d_depth [T, P], all f32.
// Output:  d_ent [T, K, 16] f32: columns 0-9 are d(mx, my, ca, cb, cc, r, g,
//          b, op, depth); columns 10-15, every row k >= count and every row
//          that no pixel kept are written as exact zeros (pad rows alias the
//          next tile's Gaussians and the binning backward adds them blindly).
//
// Design: one CTA of P threads per tile, one pixel per thread. Each thread
// starts from its final transmittance and walks its entries from
// min(count, max ncon) - 1 down to 0, dividing out each kept (1 - alpha) to
// rebuild T before the entry, and carrying the suffix sum
// S = sum_{j>i} w_j (a_j . dA). Per entry the ten gradient terms are reduced
// over the tile's pixels: a warp shuffle tree, then per-warp partials in
// shared memory for a chunk of entries, then one fixed-order pass that sums
// the warps' partials and writes d_ent. The output is per entry, so no
// atomics are needed and the result is deterministic.
//
// Bound on the card: operations (~50 f32 operations and one exp per kept
// entry-pixel, plus the reduction), against 64 bytes per entry row.
//
// Numerics: built with -fmad=false, in the operation order of
// blend_bwd_plain (raster/blend.py); only the order of the pixel sums
// differs from it.

#include <cuda_runtime.h>

namespace {

constexpr int ATTRS = 16;
constexpr int NGRAD = 10;
constexpr int CHUNK = 32;

__device__ __forceinline__ float alpha_min() { return (float)(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return (float)0.99; }

__global__ void blend_bwd_kernel(const float* __restrict__ ent,
                                 const int* __restrict__ meta,
                                 const float* __restrict__ t_fin,
                                 const float* __restrict__ ncon,
                                 const float* __restrict__ d_rgb,
                                 const float* __restrict__ d_t,
                                 const float* __restrict__ d_depth,
                                 float* __restrict__ d_ent,
                                 int K, int tile_w) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int n_warps = P / 32;
  float* rows = smem;                          // [CHUNK][ATTRS]
  float* partial = smem + CHUNK * ATTRS;       // [CHUNK][n_warps][NGRAD]
  __shared__ int s_last;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int count = min(meta[4 * t + 0], K);
  const float px = (float)(meta[4 * t + 1] + p % tile_w);
  const float py = (float)(meta[4 * t + 2] + p / tile_w);
  const float* tile_ent = ent + (size_t)t * K * ATTRS;
  float* tile_d = d_ent + (size_t)t * K * ATTRS;

  const size_t o = (size_t)t * P + p;
  const int nc = min((int)ncon[o], count);
  float trans = t_fin[o];
  const float tail = trans * d_t[o];
  const float da0 = d_rgb[3 * o + 0];
  const float da1 = d_rgb[3 * o + 1];
  const float da2 = d_rgb[3 * o + 2];
  const float da3 = d_depth[o];
  float suffix = 0.0f;

  if (p == 0) s_last = 0;
  __syncthreads();
  atomicMax(&s_last, nc);
  __syncthreads();
  const int last = s_last;  // rows >= last: nobody kept them

  for (int i = last * ATTRS + p; i < K * ATTRS; i += P) tile_d[i] = 0.0f;

  for (int hi = last; hi > 0; hi -= CHUNK) {
    const int lo = max(hi - CHUNK, 0);
    const int n = hi - lo;
    for (int i = p; i < n * ATTRS; i += P) {
      rows[i] = tile_ent[(size_t)lo * ATTRS + i];
    }
    __syncthreads();
    for (int e = n - 1; e >= 0; --e) {
      const int k = lo + e;
      float g[NGRAD];
#pragma unroll
      for (int c = 0; c < NGRAD; ++c) g[c] = 0.0f;
      if (k < nc) {
        const float* r = rows + e * ATTRS;
        const float dx = px - r[0];
        const float dy = py - r[1];
        const float power =
            -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        const float ex = expf(power);
        const float raw = r[8] * ex;
        const bool gate = power <= 0.0f && fminf(raw, alpha_max()) >= alpha_min();
        const float alpha = gate ? fminf(raw, alpha_max()) : 0.0f;
        const float one_minus = 1.0f - alpha;
        const float t_before = trans / one_minus;
        const float w = alpha * t_before;
        const float adot = r[5] * da0 + r[6] * da1 + r[7] * da2 + r[9] * da3;
        const float d_alpha = t_before * adot - (suffix + tail) / one_minus;
        suffix = suffix + w * adot;
        trans = t_before;
        if (gate && raw < alpha_max()) {
          const float d_power = d_alpha * raw;
          g[0] = d_power * (r[2] * dx + r[3] * dy);
          g[1] = d_power * (r[4] * dy + r[3] * dx);
          g[2] = d_power * (-0.5f * dx * dx);
          g[3] = d_power * (-dx * dy);
          g[4] = d_power * (-0.5f * dy * dy);
          g[8] = d_alpha * ex;
        }
        g[5] = w * da0;
        g[6] = w * da1;
        g[7] = w * da2;
        g[9] = w * da3;
      }
#pragma unroll
      for (int c = 0; c < NGRAD; ++c) {
        float v = g[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) partial[(e * n_warps + warp) * NGRAD + c] = v;
      }
    }
    __syncthreads();
    for (int i = p; i < n * ATTRS; i += P) {
      const int e = i / ATTRS;
      const int c = i % ATTRS;
      float s = 0.0f;
      if (c < NGRAD) {
        for (int w = 0; w < n_warps; ++w) {
          s += partial[(e * n_warps + w) * NGRAD + c];
        }
      }
      tile_d[(size_t)lo * ATTRS + i] = s;
    }
    // `rows` and `partial` are rewritten by the next chunk
    __syncthreads();
  }
}

size_t smem_bytes(int P) {
  return sizeof(float) * (CHUNK * ATTRS + CHUNK * (P / 32) * NGRAD);
}

}  // namespace

extern "C" cudaError_t ht3dgs_blend_bwd(const float* ent, const int* meta,
                                        const float* t_fin, const float* ncon,
                                        const float* d_rgb, const float* d_t,
                                        const float* d_depth, float* d_ent,
                                        int T, int K, int tile_h, int tile_w,
                                        cudaStream_t stream) {
  const int P = tile_h * tile_w;
  if (T > 0) {
    blend_bwd_kernel<<<T, P, smem_bytes(P), stream>>>(
        ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, d_ent, K, tile_w);
  }
  return cudaGetLastError();
}
