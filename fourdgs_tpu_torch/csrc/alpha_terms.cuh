// Terms shared by the tile blend kernels: the forward (K1,
// blend_forward.cu), the backward (K2, blend_backward.cu) and the packed
// inference forward (K3, blend_infer.cu). Together they replace
// `_alpha_terms` / `_alpha_terms_infer` of fourdgs_tpu/ops/pallas_blend.py,
// which the TPU kernels share in the same way.
//
// What bounds the blends on this card is instruction issue per (pixel,
// instance) pair, not bytes, so this header holds both the exact terms
// and the cheap tests that keep pairs away from them:
//
// 1. The exact terms. The backward replays exactly the pairs the forward
//    composited, so every kernel must take the same decision on every
//    pair: the power test, the 0.99 clamp and the 1/255 alpha floor are
//    thresholds, and a pair near one of them flips if two kernels round
//    power or alpha differently. Every product and sum of the power is
//    therefore rounded on its own with the _rn intrinsics, which nvcc
//    never contracts into a fused multiply-add whatever -fmad says; the
//    result is the same as the plain PyTorch versions' separate
//    elementwise operations (fourdgs_tpu_torch/ops/blend.py), in the same
//    order. expf is CUDA's accurate one (no --use_fast_math), as PyTorch's
//    exp is. The power is split into the terms that the pixels of one
//    column (the same dx) and of one row (the same dy) share, so that a
//    thread that owns several pixels computes them once; `falloff` is the
//    one-pixel form of the same operations, bit for bit.
//
// 2. Tests that decide nothing. `skip_threshold` is, per instance, the
//    power below which alpha >= 1/255 is impossible, less a margin that
//    covers the rounding of expf, of the product and of the logarithm;
//    `alpha_certainly_low` lets such a pair skip expf. `cull_keep` bounds
//    the largest power over a warp's rectangle of pixels (the maximum of
//    the quadratic over the rectangle lies at the centre if it is inside,
//    else on an edge that faces it, where it has a closed form) and drops
//    an instance for the whole warp when even that bound stays under the
//    threshold. Both only ever skip pairs the exact test would refuse; a
//    pair that survives them still takes the exact path, so the pairs used
//    are the same to the bit. `warp_cull_keep` in ops/blend.py is the
//    same formula in PyTorch, and the CPU tests hold it to the exact test.
//
// 3. The pixel of a thread. A warp covers an 8x4 block of its 16x16 tile
//    (the squarest footprint 32 pixels can have, so the fewest instances
//    reach it and the cull rejects the most); planes stay indexed by the
//    pixel's place in the tile, py * 16 + px.

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

constexpr int kTile = 16;             // tile side in pixels
constexpr int kWarpW = 8;             // a warp's block of lanes: 8 wide,
constexpr int kWarpH = 4;             // 4 tall
constexpr unsigned kFullMask = 0xffffffffu;

// Margin of the expf pre-test, in units of power: alpha is at most
// exp(-1e-3) / 255 when the test skips, and the roundings it must cover
// (expf 2 ulp, one product, logf of a value of magnitude < 90) are under
// 1e-5 together.
constexpr float kSkipMargin = 1e-3f;
// Margin of the warp cull relative to the largest magnitude a term of the
// power can have over the rectangle: the exact power and the bound each
// carry a rounding error of a few 6e-8 of it.
constexpr float kCullRel = 1e-5f;

// Record layout, three float4 per instance:
//   r0 = (x, y, conic a, conic b), r1 = (conic c, opacity, red, green),
//   r2 = (blue, depth, flow x, flow y).

// Terms of the power shared by the pixels of one column (the same px).
struct ColTerms {
    float dx;      // x - px
    float adx2;    // (a dx) dx
    float bdx;     // b dx
};

// Terms shared by the pixels of one row (the same py).
struct RowTerms {
    float dy;      // y - py
    float cdy2;    // (c dy) dy
};

__device__ __forceinline__ ColTerms col_terms(const float4 r0, float px) {
    ColTerms t;
    t.dx = __fsub_rn(r0.x, px);
    t.adx2 = __fmul_rn(__fmul_rn(r0.z, t.dx), t.dx);
    t.bdx = __fmul_rn(r0.w, t.dx);
    return t;
}

__device__ __forceinline__ RowTerms row_terms(const float4 r0, const float4 r1,
                                              float py) {
    RowTerms t;
    t.dy = __fsub_rn(r0.y, py);
    t.cdy2 = __fmul_rn(__fmul_rn(r1.x, t.dy), t.dy);
    return t;
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy: four rounded operations per
// pixel on top of the shared terms.
__device__ __forceinline__ float power_of(const ColTerms c, const RowTerms r) {
    return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(c.adx2, r.cdy2)),
                     __fmul_rn(c.bdx, r.dy));
}

struct Falloff {
    float dx, dy;
    float power;
};

// The one-pixel form: the same operations in the same order.
__device__ __forceinline__ Falloff falloff(const float4 r0, const float4 r1,
                                           float px, float py) {
    const ColTerms c = col_terms(r0, px);
    const RowTerms r = row_terms(r0, r1, py);
    Falloff f;
    f.dx = c.dx;
    f.dy = r.dy;
    f.power = power_of(c, r);
    return f;
}

// opacity * exp(power), before the clamp (the backward's pass-through
// gradient uses it unclamped).
__device__ __forceinline__ float alpha_raw(const float4 r1, float g) {
    return __fmul_rn(r1.y, g);
}

// log(1 / (255 opacity)) - kSkipMargin, staged once per instance of a
// batch. +inf for opacity 0 (never composited); NaN for a negative
// opacity, which makes both tests below keep the pair.
__device__ __forceinline__ float skip_threshold(float opacity) {
    return -logf(255.0f * opacity) - kSkipMargin;
}

// True only where opacity * expf(power) >= 1/255 is impossible.
__device__ __forceinline__ bool alpha_certainly_low(float power, float thr) {
    return power < thr;
}

// Origin, in its tile, of the 8x4 block of pixels that warp `warp` covers,
// and a thread's place in the tile's planes.
__device__ __forceinline__ int warp_x0(int warp) {
    return (warp % (kTile / kWarpW)) * kWarpW;
}
__device__ __forceinline__ int warp_y0(int warp) {
    return (warp / (kTile / kWarpW)) * kWarpH;
}

// A rectangle of pixel centres, bounds inclusive.
struct Rect {
    float x0, x1, y0, y1;
};

// Least value of s e^2 + 2 b e t + f t^2 over t in [lo, hi] (f > 0): the
// quadratic a dx^2 + 2 b dx dy + c dy^2 along an edge of the rectangle
// where one offset is fixed at e.
__device__ __forceinline__ float edge_min(float s, float b, float f, float e,
                                          float lo, float hi) {
    const float be = b * e;
    const float t = fminf(fmaxf(-be / f, lo), hi);
    return s * e * e + 2.0f * be * t + f * t * t;
}

// False only where no pixel of `w` can pass alpha >= 1/255 for this
// instance; `thr` is its skip_threshold. The largest power over the
// rectangle is 0 if the centre lies inside; else the quadratic is least on
// an edge that faces the centre (at most one per axis: the one at the
// offset nearest to 0 where the rectangle's span on that axis excludes
// 0), because a convex function decreases from its least point on the
// rectangle towards its least point overall. Conservative: an instance
// whose conic is not positive definite (as computed: a conic within
// rounding of singular moves the bound by far less than the margin) or
// whose terms are not finite is kept.
__device__ __forceinline__ bool cull_keep(const float4 r0, const float4 r1,
                                          float thr, const Rect w) {
    const float a = r0.z, b = r0.w, c = r1.x;
    const float dx_lo = r0.x - w.x1, dx_hi = r0.x - w.x0;
    const float dy_lo = r0.y - w.y1, dy_hi = r0.y - w.y0;
    const float ex = fminf(fmaxf(0.0f, dx_lo), dx_hi);
    const float ey = fminf(fmaxf(0.0f, dy_lo), dy_hi);
    const float inf = __int_as_float(0x7f800000);
    const float qx = ex != 0.0f ? edge_min(a, b, c, ex, dy_lo, dy_hi) : inf;
    const float qy = ey != 0.0f ? edge_min(c, b, a, ey, dx_lo, dx_hi) : inf;
    const float bound =
        (ex != 0.0f || ey != 0.0f) ? -0.5f * fminf(qx, qy) : 0.0f;
    const float mx = fmaxf(fabsf(dx_lo), fabsf(dx_hi));
    const float my = fmaxf(fabsf(dy_lo), fabsf(dy_hi));
    const float mag = a * mx * mx + c * my * my + 2.0f * fabsf(b) * mx * my;
    const bool reject = a > 0.0f && c > 0.0f && a * c > b * b
                        && bound + kCullRel * mag < thr;
    return !reject;
}

}  // namespace blend
