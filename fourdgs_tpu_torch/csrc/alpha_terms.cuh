// Gaussian falloff terms shared by the forward (K1, blend_forward.cu) and
// backward (K2, blend_backward.cu) tile blends.
//
// The backward replays exactly the (pixel, instance) pairs the forward
// composited, so both kernels must take the same decision on every pair:
// the power test, the 0.99 clamp and the 1/255 alpha floor are
// thresholds, and a pair near one of them flips if the two kernels round
// power or alpha differently. Every product and sum here is therefore
// rounded on its own with the _rn intrinsics, which nvcc never contracts
// into a fused multiply-add whatever -fmad says; the result is the same
// as the plain PyTorch versions' separate elementwise operations
// (fourdgs_tpu_torch/ops/blend.py), in the same order. expf is CUDA's
// accurate one (no --use_fast_math), as PyTorch's exp is.

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

// Record layout, three float4 per instance:
//   r0 = (x, y, conic a, conic b), r1 = (conic c, opacity, red, green),
//   r2 = (blue, depth, flow x, flow y).
struct Falloff {
    float dx, dy;    // x - px, y - py
    float power;     // -0.5 (a dx^2 + c dy^2) - b dx dy
};

__device__ __forceinline__ Falloff falloff(const float4 r0, const float4 r1,
                                           float px, float py) {
    Falloff f;
    f.dx = __fsub_rn(r0.x, px);
    f.dy = __fsub_rn(r0.y, py);
    const float q = __fadd_rn(__fmul_rn(__fmul_rn(r0.z, f.dx), f.dx),
                              __fmul_rn(__fmul_rn(r1.x, f.dy), f.dy));
    f.power = __fsub_rn(__fmul_rn(-0.5f, q),
                        __fmul_rn(__fmul_rn(r0.w, f.dx), f.dy));
    return f;
}

// opacity * exp(power), before the clamp (the backward's pass-through
// gradient uses it unclamped).
__device__ __forceinline__ float alpha_raw(const float4 r1, float g) {
    return __fmul_rn(r1.y, g);
}

}  // namespace blend
