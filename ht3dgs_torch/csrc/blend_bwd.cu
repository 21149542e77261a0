// Per-tile alpha blend, backward: one back-to-front replay, gradient sums as
// pixel moments (sm_90a, plain C interface).
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
// Design (built for 16x16 and 8x16 tiles): one CTA of P threads per tile.
// Entries go in chunks of C = 32, last chunk first. Per chunk:
//  1. replay: each thread walks its pixel back to front from its final
//     transmittance, dividing out each kept (1 - alpha) and carrying the
//     suffix sum S = sum_{j>i} w_j (a_j . dA). It keeps two numbers per
//     entry, d_power (0 where the gate is off) and the blend weight w, in
//     shared memory as [C][P] arrays;
//  2. moments: the ten gradient columns are linear in
//     S_k = sum_p d_power * {1, u, v, u^2, v^2, uv} and d_a = sum_p w * dA,
//     with (u, v) the pixel's offset from the tile origin, as the Pallas
//     kernel's matmul forms them. A group of P/16 threads takes a pair of
//     entries and 16 pixels each (four runs of 4 as float4 loads), sums its
//     pixels, and the group adds its partial sums with a 3-4 level xor
//     shuffle: 20 values per group per chunk, not ten 5-level trees per
//     entry and warp. The group then rebuilds the columns as the Pallas
//     kernel does (sdx = S_u - mxl S_1, ...; d_op = S_1 / op) and writes the
//     two rows coalesced.
// The next chunk's rows are copied in with cp.async during step 2. Every
// row is written by one thread in a fixed order: no atomics, and the result
// is the same bit for bit from call to call.
//
// Bound on the card: operations (~35 f32 operations per kept entry-pixel in
// the replay, ~15 per entry-pixel slot in the moments), against 64 bytes per
// entry row.
//
// Numerics and flags: built WITHOUT -fmad=false. The gate (power, exp,
// op * exp and its two thresholds) uses __fmul_rn / __fadd_rn / __fsub_rn,
// which are never contracted into an FMA, so it rounds as blend_fwd_plain
// and kernel K1 do and switches an entry on or off at the same pixels. Past
// the gate the kernel may contract, divides by (1 - alpha) through one
// hardware reciprocal (within 1 ulp), and sums pixels in another order than
// blend_bwd_plain: the result agrees with it to rounding, not bit for bit.

#include "blend_common.cuh"

namespace {

constexpr int ATTRS = 16;
constexpr int NGRAD = 10;
constexpr int C = CHUNK;       // entries per chunk (blend_common.cuh)
constexpr int PAIRS = C / 2;   // entry pairs per chunk, one per thread group

// 1/x to 1 ulp (x in [0.01, 1] here): one MUFU.RCP
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -0.5 (ca dx^2 + cc dy^2) - cb dx dy in blend_fwd_plain's order, uncontracted
__device__ __forceinline__ float entry_power(float dx, float dy, float ca,
                                             float cb, float cc) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                            __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// dynamic shared memory of a P-pixel tile: two row buffers of C rows, and
// d_power, w [C][P] and dA [4][P]
constexpr size_t smem_bytes(int P) {
  return sizeof(float4) * 2 * C * 4 + sizeof(float) * (2 * C * P + 4 * P);
}

// blocks of P threads that fit an SM by their shared memory (228 KB, of which
// 1 KB is reserved per block; the static s_warp_max adds P / 8 bytes) and by
// its 2048 threads. __launch_bounds__ caps the registers so that this many
// blocks also fit by registers: 3 blocks and 80 registers a thread for
// 16x16 tiles, 5 blocks for 8x16.
constexpr int min_blocks(int P) {
  const int by_smem = (int)(228 * 1024 / (smem_bytes(P) + P / 8 + 1024));
  return by_smem < 2048 / P ? by_smem : 2048 / P;
}

template <int TH, int TW>
__global__ void __launch_bounds__(TH * TW, min_blocks(TH * TW))
blend_bwd_kernel(const float* __restrict__ ent, const int* __restrict__ meta,
                 const float* __restrict__ t_fin,
                 const float* __restrict__ ncon,
                 const float* __restrict__ d_rgb,
                 const float* __restrict__ d_t,
                 const float* __restrict__ d_depth,
                 float* __restrict__ d_ent, int K) {
  constexpr int P = TH * TW;
  constexpr int G = P / PAIRS;         // threads per entry pair
  constexpr int RUNS = P / 4 / G;      // 4-pixel runs per thread
  static_assert(TW % 4 == 0 && G <= ATTRS && (G & (G - 1)) == 0,
                "tile shape");
  extern __shared__ float4 smem[];
  float4* rows = smem;                                        // [2][C][4]
  float* s_dp = reinterpret_cast<float*>(smem + 2 * C * 4);   // [C][P]
  float* s_w = s_dp + C * P;                                  // [C][P]
  float* s_da = s_w + C * P;                                  // [4][P]
  __shared__ int s_warp_max[P / 32];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = min(meta[4 * t + 0], K);
  const int ox = meta[4 * t + 1];
  const int oy = meta[4 * t + 2];
  const float px = (float)(ox + p % TW);
  const float py = (float)(oy + p / TW);
  const float4* tile_ent =
      reinterpret_cast<const float4*>(ent) + (size_t)t * K * 4;
  float* tile_d = d_ent + (size_t)t * K * ATTRS;

  const size_t o = (size_t)t * P + p;
  const int nc = min((int)ncon[o], count);
  float trans = t_fin[o];
  const float tail = trans * d_t[o];
  const float da0 = d_rgb[3 * o + 0];
  const float da1 = d_rgb[3 * o + 1];
  const float da2 = d_rgb[3 * o + 2];
  const float da3 = d_depth[o];
  s_da[0 * P + p] = da0;
  s_da[1 * P + p] = da1;
  s_da[2 * P + p] = da2;
  s_da[3 * P + p] = da3;

  // last = max over the tile's pixels of nc: rows >= last nobody kept
  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if ((p & 31) == 0) s_warp_max[p >> 5] = wmax;
  __syncthreads();
  int last = 0;
#pragma unroll
  for (int i = 0; i < P / 32; ++i) last = max(last, s_warp_max[i]);

  float4* tile_d4 = reinterpret_cast<float4*>(tile_d);
  for (int i = last * 4 + p; i < K * 4; i += P) {
    tile_d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (last == 0) return;  // the same for every thread of the block

  const int g = p / G;    // entry pair of this thread in the moment pass
  const int s = p % G;    // its place in the group
  const float4* dp4 = reinterpret_cast<const float4*>(s_dp);
  const float4* w4 = reinterpret_cast<const float4*>(s_w);
  const float4* da4 = reinterpret_cast<const float4*>(s_da);

  int hi = last;
  int lo = max(last - C, 0);
  stage_rows<P, C>(rows, tile_ent + (size_t)lo * 4, hi - lo, p);
  cp_async_wait<0>();
  __syncthreads();

  float suffix = 0.0f;
  for (int buf = 0;; buf ^= 1) {
    const int n = hi - lo;
    const float4* rb = rows + buf * C * 4;

    // 1. replay, back to front: entries e >= kept of this chunk were not
    //    kept at this pixel and get zeros
    const int kept = min(max(nc - lo, 0), n);
    for (int e = kept; e < n; ++e) {
      s_dp[e * P + p] = 0.0f;
      s_w[e * P + p] = 0.0f;
    }
    {
      const float4* r = rb + 4 * (kept - 1);
      float* dpp = s_dp + (kept - 1) * P + p;
      float* wp = s_w + (kept - 1) * P + p;
#pragma unroll 1
      for (int e = kept; e > 0; --e, r -= 4, dpp -= P, wp -= P) {
        const float4 r0 = r[0];  // mx, my, ca, cb
        const float4 r1 = r[1];  // cc, r, g, b
        const float4 r2 = r[2];  // op, depth, -, -
        const float dx = __fsub_rn(px, r0.x);
        const float dy = __fsub_rn(py, r0.y);
        const float power = entry_power(dx, dy, r0.z, r0.w, r1.x);
        const float raw = __fmul_rn(r2.x, expf(power));
        const float clipped = fminf(raw, alpha_max());
        const bool gate = power <= 0.0f && clipped >= alpha_min();
        const float alpha = gate ? clipped : 0.0f;
        const float inv = rcp_approx(1.0f - alpha);
        const float t_before = trans * inv;
        const float wv = alpha * t_before;
        const float adot = r1.y * da0 + r1.z * da1 + r1.w * da2 + r2.y * da3;
        const float d_alpha = t_before * adot - (suffix + tail) * inv;
        suffix = suffix + wv * adot;
        trans = t_before;
        *dpp = gate && raw < alpha_max() ? d_alpha * raw : 0.0f;
        *wp = wv;
      }
    }
    __syncthreads();

    // the next chunk's rows arrive while this one's moments are taken
    const int next_hi = lo;
    const int next_lo = max(lo - C, 0);
    if (next_hi > 0) {
      stage_rows<P, C>(rows + (buf ^ 1) * C * 4,
                       tile_ent + (size_t)next_lo * 4, next_hi - next_lo, p);
    }

    // 2. moments of entries g and g + PAIRS over this thread's 16 pixels:
    //    S1, Su, Sv, Suu, Svv, Suv, then sum w * dA[0..3]
    float acc[2][10];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 10; ++i) acc[h][i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RUNS; ++j) {
      const int q = s + G * j;           // run of pixels 4q .. 4q + 3
      const float u0 = (float)((4 * q) % TW);
      const float v = (float)((4 * q) / TW);
      const float4 a0 = da4[0 * P / 4 + q];
      const float4 a1 = da4[1 * P / 4 + q];
      const float4 a2 = da4[2 * P / 4 + q];
      const float4 a3 = da4[3 * P / 4 + q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = g + h * PAIRS;
        if (e < n) {
          const float4 d = dp4[e * P / 4 + q];
          const float4 w = w4[e * P / 4 + q];
          // sums over the run of d, d * i and d * i^2 (i = u - u0)
          const float r0 = (d.x + d.y) + (d.z + d.w);
          const float m1 = d.y + 2.0f * d.z + 3.0f * d.w;
          const float m2 = d.y + 4.0f * d.z + 9.0f * d.w;
          const float r1 = u0 * r0 + m1;                         // sum d u
          const float r2 = u0 * u0 * r0 + (2.0f * u0 * m1 + m2);  // sum d u^2
          float* a = acc[h];
          a[0] += r0;
          a[1] += r1;
          a[2] += v * r0;
          a[3] += r2;
          a[4] += v * v * r0;
          a[5] += v * r1;
          a[6] += w.x * a0.x + w.y * a0.y + w.z * a0.z + w.w * a0.w;
          a[7] += w.x * a1.x + w.y * a1.y + w.z * a1.z + w.w * a1.w;
          a[8] += w.x * a2.x + w.y * a2.y + w.z * a2.z + w.w * a2.w;
          a[9] += w.x * a3.x + w.y * a3.y + w.z * a3.z + w.w * a3.w;
        }
      }
    }
    // the group's G lanes are adjacent and G-aligned within one warp
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 10; ++i) {
          acc[h][i] += __shfl_xor_sync(0xffffffffu, acc[h][i], off);
        }
      }
    }

    // 3. the ten columns, as pallas_blend.py:397-418 forms them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = g + h * PAIRS;
      if (e < n) {
        const float4 r0 = rb[4 * e + 0];
        const float4 r1 = rb[4 * e + 1];
        const float4 r2 = rb[4 * e + 2];
        const float* a = acc[h];
        const float mxl = r0.x - (float)ox;   // entry centre, tile-local
        const float myl = r0.y - (float)oy;
        const float s1 = a[0], su = a[1], sv = a[2];
        const float sdx = su - mxl * s1;
        const float sdy = sv - myl * s1;
        const float sdxx = a[3] - mxl * (2.0f * su - mxl * s1);
        const float sdyy = a[4] - myl * (2.0f * sv - myl * s1);
        const float sdxy = a[5] - mxl * sv - myl * su + mxl * myl * s1;
        const float op = r2.x;
        const float cols[NGRAD] = {
            r0.z * sdx + r0.w * sdy,         // d_mx
            r1.x * sdy + r0.w * sdx,         // d_my
            -0.5f * sdxx,                    // d_ca
            -sdxy,                           // d_cb
            -0.5f * sdyy,                    // d_cc
            a[6], a[7], a[8],                // d_r, d_g, d_b
            op > 0.0f ? s1 / op : 0.0f,      // d_op
            a[9]};                           // d_depth
        float* row = tile_d + (size_t)(lo + e) * ATTRS;
#pragma unroll
        for (int k = 0; k < ATTRS / G; ++k) {
          const int c = s + k * G;
          float val = 0.0f;   // columns 10-15
#pragma unroll
          for (int i = 0; i < NGRAD; ++i) val = c == i ? cols[i] : val;
          row[c] = val;
        }
      }
    }
    cp_async_wait<0>();
    // rows[buf], s_dp and s_w are rewritten by the next chunk
    __syncthreads();
    if (next_hi == 0) break;
    hi = next_hi;
    lo = next_lo;
  }
}

template <int TH, int TW>
cudaError_t launch(const float* ent, const int* meta, const float* t_fin,
                   const float* ncon, const float* d_rgb, const float* d_t,
                   const float* d_depth, float* d_ent, int T, int K,
                   cudaStream_t stream) {
  constexpr int P = TH * TW;
  constexpr size_t smem = smem_bytes(P);
  // above 48 KB a launch needs this attribute, which is per device: set it
  // every time (it costs a few microseconds of host time)
  const cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  blend_bwd_kernel<TH, TW><<<T, P, smem, stream>>>(
      ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, d_ent, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t ht3dgs_blend_bwd(const float* ent, const int* meta,
                                        const float* t_fin, const float* ncon,
                                        const float* d_rgb, const float* d_t,
                                        const float* d_depth, float* d_ent,
                                        int T, int K, int tile_h, int tile_w,
                                        cudaStream_t stream) {
  if (T <= 0) return cudaGetLastError();
  if (tile_h == 16 && tile_w == 16) {
    return launch<16, 16>(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, d_ent,
                          T, K, stream);
  }
  if (tile_h == 8 && tile_w == 16) {
    return launch<8, 16>(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, d_ent,
                         T, K, stream);
  }
  return cudaErrorInvalidValue;
}
