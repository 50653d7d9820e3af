// Per-(pixel, splat) arithmetic of the alpha compositor, shared by K1
// (composite_fwd.cu, composite_bwd.cu: the pair-table layout) and K4
// (composite_dense.cu: the dense (T, 16, K) layout).  Every source is built
// with -fmad=false, so each operation below rounds on its own, in the order
// of the plain PyTorch versions (ops/composite_cuda.py `_geometry`); the
// backward then repeats every gate decision of the forward exactly.
#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kTerms = 10;  // gradient rows: mean 2, conic 3, rgb 3, op, depth

// One splat's ten attributes (rows 0 mx, 1 my, 2-4 conic a/b/c, 5-7 rgb,
// 8 opacity, 9 depth).
struct Splat {
  float mx, my, ca, cb, cc, r, g, b, op, dep;
};

// Splat j of a shared-memory batch laid out as s[row][j].
template <int B>
__device__ __forceinline__ Splat splat_at(const float (&s)[10][B], int j) {
  return Splat{s[0][j], s[1][j], s[2][j], s[3][j], s[4][j],
               s[5][j], s[6][j], s[7][j], s[8][j], s[9][j]};
}

__device__ __forceinline__ float splat_power(const Splat& s, float dx,
                                             float dy) {
  return -0.5f * (s.ca * dx * dx + s.cc * dy * dy) - s.cb * dx * dy;
}

// One splat's ten attributes as three 16-byte words, read with three
// broadcast loads: (mx, my, ca, cb), (cc, opacity, r, g), (b, depth,
// pmin).  Below pmin = log((1/255) / opacity) - 0.05 a power is gated out
// for sure: opacity * exp(power) < 0.952 / 255, far below the gate even
// after exp's and log's rounding (and every power is, for an opacity <= 0
// or NaN: pmin = +inf).  K1-fwd and K1-bwd skip such pairs before their
// exp; a pair so skipped neither blends nor stops its pixel.
struct alignas(16) PackedSplat {
  float4 a, b, c;
};

__device__ __forceinline__ float gate_power(float op) {
  return op > 0.f ? logf(kAlphaMin / op) - 0.05f : INFINITY;
}

// Column s of the channel-first attribute table attr (rows >= 10, Vp
// columns), packed.
__device__ __forceinline__ PackedSplat load_packed(
    const float* __restrict__ attr, int Vp, int s) {
  return PackedSplat{
      make_float4(attr[s], attr[Vp + s], attr[2 * Vp + s], attr[3 * Vp + s]),
      make_float4(attr[4 * Vp + s], attr[8 * Vp + s], attr[5 * Vp + s],
                  attr[6 * Vp + s]),
      make_float4(attr[7 * Vp + s], attr[9 * Vp + s],
                  gate_power(attr[8 * Vp + s]), 0.f)};
}

__device__ __forceinline__ Splat unpack(const PackedSplat& s) {
  return Splat{s.a.x, s.a.y, s.a.z, s.a.w, s.b.x,
               s.b.z, s.b.w, s.c.x, s.b.y, s.c.y};
}

// True when no pixel of the rectangle [xlo, xhi] x [ylo, yhi] can reach a
// power of pmin, so that a warp whose pixels lie in it skips the splat.
// For a positive definite conic (a, b; b, c) the power at offset d is
// -0.5 d'Ad <= -0.5 lam |d|^2 with lam = det / (a + c) <= the smaller
// eigenvalue, and |d|^2 >= gx^2 + gy^2, the squared distance from the
// splat's centre to the rectangle.  The condition number is held below
// 1e4, so that the power the kernels compute is within ~1e-2 of
// -0.5 d'Ad relative to lam |d|^2, and the bound is shrunk by 2% and an
// absolute 0.01 (on top of pmin's own margin).  Any other conic (not
// positive definite, ill-conditioned, NaN) culls nothing, unless pmin is
// +inf (opacity <= 0 or NaN: the gate refuses every pixel).
__device__ __forceinline__ bool patch_culled(const PackedSplat& s, float xlo,
                                             float xhi, float ylo,
                                             float yhi) {
  if (!(s.c.z < INFINITY)) return true;
  const float a = s.a.z, b = s.a.w, c = s.b.x;
  if (!(a > 0.f && c > 0.f)) return false;
  const float det = a * c - b * b, tr = a + c;
  if (!(det * 1e4f > tr * tr)) return false;
  const float lam = det / tr;
  const float gx = fmaxf(fmaxf(xlo - s.a.x, s.a.x - xhi), 0.f);
  const float gy = fmaxf(fmaxf(ylo - s.a.y, s.a.y - yhi), 0.f);
  return 0.5f * lam * (gx * gx + gy * gy) * 0.98f > 0.01f - s.c.z;
}

// The pixel of thread tid in a block that covers the side x side corner
// `sub` of a tile (nsx corners across): a warp takes an 8 x 4 patch where
// side allows (pixels of one warp then stop near the same rank and reach
// the same splats), else whole rows.  Tile-local (x, y).
__device__ __forceinline__ int2 corner_pixel(int tid, int side, int sub,
                                             int nsx) {
  const int lane = tid & 31, warp = tid >> 5;
  const int wx = side / 8;  // warps across a row of the corner
  const int lx = side % 8 == 0 ? (lane & 7) + 8 * (warp % wx) : tid % side;
  const int ly = side % 8 == 0 ? (lane >> 3) + 4 * (warp / wx) : tid / side;
  return make_int2((sub % nsx) * side + lx, (sub / nsx) * side + ly);
}

// A pixel of the forward's front-to-back loop.
struct FwdPixel {
  float tr = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f;
  int last = 0;       // n_contrib: one more than the last blended rank
  bool done = false;  // stopped by the done rule
};

// Blend the splat of run rank `rank` into the pixel, unless it is gated
// out (power > 0 or opacity * exp(power) < 1/255).  A splat that would take
// the transmittance below kTEps stops the pixel instead (the CUDA
// rasterizer's `done` rule, the Pallas kernels' exclusion).
__device__ __forceinline__ void fwd_blend(FwdPixel& p, float px, float py,
                                          const Splat& s, int rank) {
  const float dx = px - s.mx;
  const float dy = py - s.my;
  const float power = splat_power(s, dx, dy);
  if (!(power <= 0.f)) return;
  const float araw = s.op * expf(power);
  if (!(araw >= kAlphaMin)) return;
  const float alpha = fminf(araw, kAlphaMax);
  const float t_next = p.tr * (1.f - alpha);
  if (t_next < kTEps) {
    p.done = true;
    return;
  }
  const float w = alpha * p.tr;
  p.cr = p.cr + w * s.r;
  p.cg = p.cg + w * s.g;
  p.cb = p.cb + w * s.b;
  p.cd = p.cd + w * s.dep;
  p.tr = t_next;
  p.last = rank + 1;
}

// A pixel of the backward's reverse walk: tr starts at the final
// transmittance and becomes the transmittance before each blended splat;
// S is the sum of w * dL/dw over the later blended splats.
struct BwdPixel {
  float tr, S, g_r, g_g, g_b, g_d, gtf_tf;
};

// The gradient terms of one (pixel, splat) pair of the reverse walk into
// v[0..9] (the caller zeroes v); returns whether the pair blended.
//   dL/dw     = g_rgb . rgb + g_depth * depth
//   dL/dalpha = T_before * dL/dw - (S + g_tf * t_final) / (1 - alpha)
// with T_before = T_after / (1 - alpha) recovered by division; the chain
// through alpha = opacity * exp(power) is zero where alpha was clamped.
__device__ __forceinline__ bool bwd_pair(BwdPixel& p, float px, float py,
                                         const Splat& s, float* v) {
  const float dx = px - s.mx;
  const float dy = py - s.my;
  const float power = splat_power(s, dx, dy);
  if (!(power <= 0.f)) return false;
  const float gexp = expf(power);
  const float araw = s.op * gexp;
  if (!(araw >= kAlphaMin)) return false;
  const float alpha = fminf(araw, kAlphaMax);
  const float o = 1.f - alpha;
  const float t_before = p.tr / o;
  const float dldw = p.g_r * s.r + p.g_g * s.g + p.g_b * s.b + p.g_d * s.dep;
  const float w = alpha * t_before;
  const float dalpha = t_before * dldw - (p.S + p.gtf_tf) / o;
  v[5] = w * p.g_r;
  v[6] = w * p.g_g;
  v[7] = w * p.g_b;
  v[9] = w * p.g_d;
  if (araw < kAlphaMax) {
    const float dpow = dalpha * araw;
    v[0] = dpow * (s.ca * dx + s.cb * dy);
    v[1] = dpow * (s.cc * dy + s.cb * dx);
    v[2] = dpow * (-0.5f * dx * dx);
    v[3] = dpow * (-dx * dy);
    v[4] = dpow * (-0.5f * dy * dy);
    v[8] = dalpha * gexp;
  }
  p.S = p.S + w * dldw;
  p.tr = t_before;
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace gs
