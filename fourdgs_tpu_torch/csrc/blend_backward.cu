// Backward tile blend (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fourdgs_tpu/ops/pallas_blend.py:_backward_kernel`
// / `_backward_tile` (launched by `blend_backward_pallas`) together with
// the sort-based per-gaussian reduce that follows it
// (`fourdgs_tpu/ops/binning.py:aligned_entry_grads_to_gaussian_grads`).
// The plain PyTorch version beside it is
// `fourdgs_tpu_torch/ops/blend.py:blend_backward_plain`.
//
// What it computes. One thread block per 16x16 pixel tile, one thread per
// pixel, as in the forward kernel K1. Each pixel has the cotangents of its
// six features dc (rgb, depth, flow), tf = dT_total * T_final with
// dT_total = dC_rgb . bg - dalpha, its final transmittance T_final and
// n_contrib from K1. The block walks its tile's depth-sorted instances
// back to front, from the largest n_contrib of the tile down to rank 0.
// A pixel takes part for ranks below its own n_contrib where the instance
// passes K1's tests (power <= 0, alpha >= 1/255): exactly the pairs K1
// composited. Starting from T = T_final and sigma = 0, for each such pair
//   T_before = T / (1 - alpha)          (back-to-front reconstruction)
//   w        = alpha T_before
//   gdot     = sum_f dc_f feat_f
//   dalpha   = T_before gdot - (sigma + tf) / (1 - alpha)
//   sigma   += w gdot,  T = T_before
// (the XLA backward's formulas, fourdgs_tpu/ops/blend.py:237-262), then
// the chain through alpha = min(0.99, opa exp(power)) with the clamp as a
// pass-through: dpower = opa exp(power) dalpha, dopa = exp(power) dalpha,
// and through power to x, y and the conic (a, b, c); dfeat_f = w dc_f for
// rgb and depth. The flow columns (10, 11) get no gradient: flow is a
// zeros constant in training, as in the TPU kernel's wrapper.
//
// Design. Per-instance sums over the tile's pixels (10 values) are reduced
// within each warp with __shfl_down_sync and added per GAUSSIAN with one
// atomicAdd per warp per value into the zeroed (P, 12) output; a warp in
// which no pixel used the instance skips both. This replaces the TPU's
// per-instance gradient rows and its sort-based segment sum: the TPU has
// no atomics, Hopper does. The block gathers the 48-byte records of 256
// instances at a time into shared memory (12 KB) through the sorted
// gaussian ids, as K1 does, walking the batches from the back. Float
// atomics sum in a different order on every run, so the result is held
// to its plain version within a tolerance, not bit for bit.
//
// Bound. The per-pair arithmetic (falloff, expf, 42 more operations for
// a used pair) and the adds that sum the used pairs' 10 values per
// gaussian against the f32 peak; the bytes (records, ids, per-pixel
// inputs, the atomics) are far below it at 800x800. chip_smoke.py counts
// both from the plain version's pair counts.
//
// Numerics. The falloff terms come from alpha_terms.cuh, shared with K1,
// so the valid decision is K1's whatever -fmad says. The kernel is built
// with -fmad=false (cuda_build.KERNEL_FLAGS) so that the rest rounds as
// the plain version's separate operations do too.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using blend::kAlphaMin;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels per tile = threads per block
constexpr int kRecVec = 3;            // float4 per 12-float record
constexpr int kRec = 12;              // floats per record / gradient row
constexpr int kFeat = 6;              // rgb, depth, flow x, flow y
constexpr int kCot = kFeat + 1;       // dc(6) + tf rows per tile
constexpr int kGrad = 10;             // x, y, a, b, c, opa, r, g, b, depth
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(kFull, v, off);
    }
    return v;
}

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float4* __restrict__ rec,
                      const int* __restrict__ gauss_id,
                      const int* __restrict__ tile_start,
                      const float* __restrict__ t_final,   // (T, 256)
                      const int* __restrict__ n_contrib,   // (T, 256)
                      const float* __restrict__ dcot,      // (T, 7, 256)
                      int tiles_x,
                      float* __restrict__ d_rec)           // (P, 12), zeroed
{
    __shared__ float4 s_rec[kPix * kRecVec];
    __shared__ int s_gid[kPix];
    __shared__ int s_max_rank;

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
    const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
    const int start = tile_start[tile];
    const size_t pix = static_cast<size_t>(tile) * kPix + tid;
    const int ncon = n_contrib[pix];

    float dc[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
        dc[f] = dcot[(static_cast<size_t>(tile) * kCot + f) * kPix + tid];
    }
    const float tf = dcot[(static_cast<size_t>(tile) * kCot + kFeat) * kPix + tid];
    float t = t_final[pix];
    float sigma = 0.0f;

    // No pixel used an instance ranked at or past the tile's largest
    // n_contrib (<= the tile's count): the walk starts there.
    if (tid == 0) s_max_rank = 0;
    __syncthreads();
    atomicMax(&s_max_rank, ncon);
    __syncthreads();
    const int max_rank = s_max_rank;

    for (int base = (max_rank + kPix - 1) / kPix * kPix - kPix; base >= 0;
         base -= kPix) {
        const int n = min(kPix, max_rank - base);
        if (tid < n) {
            const int g = gauss_id[start + base + tid];
            s_gid[tid] = g;
#pragma unroll
            for (int q = 0; q < kRecVec; ++q) {
                s_rec[tid * kRecVec + q] = rec[g * kRecVec + q];
            }
        }
        __syncthreads();
        for (int j = n - 1; j >= 0; --j) {
            // Every thread runs every j, so the warp votes and shuffles
            // below see all 32 lanes.
            float grad[kGrad];
#pragma unroll
            for (int k = 0; k < kGrad; ++k) grad[k] = 0.0f;
            bool used = false;
            if (base + j < ncon) {
                const float4 r0 = s_rec[j * kRecVec];
                const float4 r1 = s_rec[j * kRecVec + 1];
                const blend::Falloff f = blend::falloff(r0, r1, px, py);
                if (f.power <= 0.0f) {
                    const float g = expf(f.power);
                    const float raw = blend::alpha_raw(r1, g);
                    const float alpha = fminf(raw, blend::kAlphaClamp);
                    if (alpha >= kAlphaMin) {
                        used = true;
                        const float4 r2 = s_rec[j * kRecVec + 2];
                        const float one_m = 1.0f - alpha;
                        const float t_before = t / one_m;
                        const float w = alpha * t_before;
                        const float gdot = dc[0] * r1.z + dc[1] * r1.w
                                           + dc[2] * r2.x + dc[3] * r2.y
                                           + dc[4] * r2.z + dc[5] * r2.w;
                        const float d_alpha =
                            t_before * gdot - (sigma + tf) / one_m;
                        sigma = sigma + w * gdot;
                        t = t_before;
                        const float d_power = raw * d_alpha;
                        const float sx = r0.z * f.dx + r0.w * f.dy;
                        const float sy = r0.w * f.dx + r1.x * f.dy;
                        grad[0] = -sx * d_power;
                        grad[1] = -sy * d_power;
                        grad[2] = -0.5f * f.dx * f.dx * d_power;
                        grad[3] = -f.dx * f.dy * d_power;
                        grad[4] = -0.5f * f.dy * f.dy * d_power;
                        grad[5] = g * d_alpha;
                        grad[6] = w * dc[0];
                        grad[7] = w * dc[1];
                        grad[8] = w * dc[2];
                        grad[9] = w * dc[3];
                    }
                }
            }
            if (__any_sync(kFull, used)) {
#pragma unroll
                for (int k = 0; k < kGrad; ++k) grad[k] = warp_sum(grad[k]);
                if (lane == 0) {
                    float* out = d_rec + static_cast<size_t>(s_gid[j]) * kRec;
#pragma unroll
                    for (int k = 0; k < kGrad; ++k) atomicAdd(out + k, grad[k]);
                }
            }
        }
        // Barrier before the next batch overwrites s_rec and s_gid.
        __syncthreads();
    }
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers; d_rec
// must be zeroed by the caller; the stream is PyTorch's current stream.
// Launches asynchronously and returns cudaGetLastError() (0 = the launch
// was accepted).
extern "C" int blend_backward_launch(const void* rec, const void* gauss_id,
                                     const void* tile_start,
                                     const void* t_final,
                                     const void* n_contrib, const void* dcot,
                                     int num_tiles, int tiles_x, void* d_rec,
                                     void* stream) {
    if (num_tiles > 0) {
        blend_backward_kernel<<<num_tiles, kPix, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rec),
            static_cast<const int*>(gauss_id),
            static_cast<const int*>(tile_start),
            static_cast<const float*>(t_final),
            static_cast<const int*>(n_contrib),
            static_cast<const float*>(dcot), tiles_x,
            static_cast<float*>(d_rec));
    }
    return static_cast<int>(cudaGetLastError());
}
