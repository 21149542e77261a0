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
// Design: one CTA of P threads per tile, one pixel per thread; transmittance
// and the sticky `done` flag stay in registers. Entries are staged through
// shared memory CHUNK rows at a time (contiguous 64-byte rows, one coalesced
// copy), and the block leaves as soon as no pixel is live after a chunk.
//
// Bound on the card: operations. Each entry-pixel evaluation costs ~25 f32
// operations and one exp, against 64 bytes per entry row shared by the tile's
// P pixels, so arithmetic intensity is far above the H100's f32 ridge point.
//
// Numerics: built with -fmad=false and written in the same operation order as
// blend_fwd_plain (raster/blend.py), so the kernel and its plain version round
// alike and take the same termination decisions.

#include <cuda_runtime.h>

namespace {

constexpr int ATTRS = 16;
constexpr int CHUNK = 64;

// decimal -> double -> float, the rounding the plain torch version sees
__device__ __forceinline__ float alpha_min() { return (float)(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return (float)0.99; }
__device__ __forceinline__ float t_eps() { return (float)1e-4; }

__global__ void blend_fwd_kernel(const float* __restrict__ ent,
                                 const int* __restrict__ meta,
                                 float* __restrict__ rgb,
                                 float* __restrict__ t_fin,
                                 float* __restrict__ depth,
                                 float* __restrict__ ncon,
                                 int K, int tile_w) {
  __shared__ float rows[CHUNK * ATTRS];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int count = min(meta[4 * t + 0], K);
  const float px = (float)(meta[4 * t + 1] + p % tile_w);
  const float py = (float)(meta[4 * t + 2] + p / tile_w);
  const float* tile_ent = ent + (size_t)t * K * ATTRS;

  float trans = 1.0f, cr = 0.0f, cg = 0.0f, cb_ = 0.0f, cd = 0.0f;
  bool done = false;
  int kept = 0;

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    for (int i = p; i < n * ATTRS; i += P) {
      rows[i] = tile_ent[(size_t)base * ATTRS + i];
    }
    __syncthreads();
    for (int e = 0; e < n && !done; ++e) {
      const float* r = rows + e * ATTRS;
      const float dx = px - r[0];
      const float dy = py - r[1];
      const float power =
          -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      float alpha = fminf(r[8] * expf(power), alpha_max());
      if (!(power <= 0.0f && alpha >= alpha_min())) alpha = 0.0f;
      const float t_after = trans * (1.0f - alpha);
      if (t_after < t_eps()) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      cr = cr + w * r[5];
      cg = cg + w * r[6];
      cb_ = cb_ + w * r[7];
      cd = cd + w * r[9];
      trans = t_after;
      ++kept;
    }
    // the vote is also the barrier before the next chunk overwrites `rows`
    if (!__syncthreads_or(!done)) break;
  }

  const size_t o = (size_t)t * P + p;
  rgb[3 * o + 0] = cr;
  rgb[3 * o + 1] = cg;
  rgb[3 * o + 2] = cb_;
  t_fin[o] = trans;
  depth[o] = cd;
  ncon[o] = (float)kept;
}

}  // namespace

extern "C" cudaError_t ht3dgs_blend_fwd(const float* ent, const int* meta,
                                        float* rgb, float* t_fin,
                                        float* depth, float* ncon, int T,
                                        int K, int tile_h, int tile_w,
                                        cudaStream_t stream) {
  if (T > 0) {
    blend_fwd_kernel<<<T, tile_h * tile_w, 0, stream>>>(
        ent, meta, rgb, t_fin, depth, ncon, K, tile_w);
  }
  return cudaGetLastError();
}
