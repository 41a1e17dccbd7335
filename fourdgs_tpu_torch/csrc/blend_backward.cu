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
// pixel. Each pixel has the cotangents of its six features dc (rgb, depth,
// flow), tf = dT_total * T_final with dT_total = dC_rgb . bg - dalpha, its
// final transmittance T_final and n_contrib from K1. The tile's
// depth-sorted instances are walked back to front. A pixel takes part for
// ranks below its own n_contrib where the instance passes K1's tests
// (power <= 0, alpha >= 1/255): exactly the pairs K1 composited. Starting
// from T = T_final and sigma = 0, for each such pair
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
// What bounds it on this card: instruction issue. The bytes (records, ids,
// per-pixel inputs, the gradient table) are a few percent of its time at
// 800x800; a used pair costs about 50 f32 operations, but only a quarter
// of the pairs below a tile's largest n_contrib are used, and summing ten
// values over the pixels of a tile per instance costs more issue slots
// than the arithmetic if it is done with a shuffle tree and scalar
// atomics. The design spends its issue slots on pairs that can be used:
//
// - A warp covers an 8x4 block of pixels (alpha_terms.cuh) and walks on
//   its own. The block stages 256 records at a time, from the tile's
//   largest n_contrib down, with the per-instance threshold
//   `skip_threshold`; block barriers stand only around the staging. Each
//   warp starts at its own largest n_contrib (__reduce_max_sync) and
//   culls 32 staged instances at a time, one per lane (`cull_keep`:
//   can any pixel of the warp's rectangle reach alpha >= 1/255?);
//   __ballot_sync gives the survivors and the warp visits only those, back
//   to front. The cull decides nothing: a surviving pair takes K1's exact
//   test, so the pairs used are K1's to the bit. A pair whose power is
//   certainly too low skips expf.
// - Where a lane used the instance, the warp sums its ten values with a
//   recursive-halving reduce: at each of four steps a lane hands half of
//   its values to its partner and keeps the sums of the other half, and
//   a fifth step joins the pairs: 16 shuffles where a tree per value
//   takes 50, and the ten sums end on ten different lanes. Those lanes add
//   them into a gradient tile in shared memory (one row per staged
//   instance; at most the 8 warps of the block contend).
// - After the batch, thread j adds row j to gaussian s_gid[j]'s row of the
//   (P, 12) output if any warp touched it: two 16-byte and one 8-byte
//   vector atomicAdd (float4 / float2 atomics are sm_90's own) per (tile,
//   instance), where one scalar atomic per warp and value took up to 80.
//   This replaces the TPU's per-instance gradient rows and its sort-based
//   segment sum: the TPU has no atomics, Hopper does.
//
// What each part costs on the first lego step's inputs at 800x800 (one
// H100, PERF.md): the walk and the terms alone 0.30 ms, the halving sum
// 0.085, the gradient tile and its flush 0.045, together 0.43 against
// the 0.67 of one shuffle tree per value, one scalar atomic per warp and
// value and a tile-wide walk. With the same walk, a shuffle tree per
// value and three vector atomics from lane 0 took 0.48 ms, vector atomics
// straight from the warp's lanes (no gradient tile) 0.46. `halve` is a
// template on purpose: as a loop over the register array nvcc compiled
// its selects into divergent branches around each shuffle, and the
// kernel took 0.83 ms.
//
// Float atomics sum in another order on every run, so the result is held
// to its plain version within a tolerance (scale-normalised 2e-4), not bit
// for bit. chip_smoke.py counts the bound from the plain version's pair
// counts.
//
// Numerics. The falloff terms come from alpha_terms.cuh, shared with K1,
// so the valid decision is K1's whatever -fmad says. The kernel is built
// with -fmad=false (cuda_build.KERNEL_FLAGS) so that the rest rounds as
// the plain version's separate operations do too.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using blend::kAlphaMin;
using blend::kFullMask;
using blend::kTile;

constexpr int kPix = kTile * kTile;   // pixels per tile = threads per block
constexpr int kRecVec = 3;            // float4 per 12-float record
constexpr int kRec = 12;              // floats per record / gradient row
constexpr int kFeat = 6;              // rgb, depth, flow x, flow y
constexpr int kCot = kFeat + 1;       // dc(6) + tf rows per tile
constexpr int kGrad = 10;             // x, y, a, b, c, opa, r, g, b, depth
constexpr int kSum = 16;              // kGrad padded to a power of two

// One step of the recursive-halving sum: of its 2 * kHalf values a lane
// hands one half to the lane kOff away and keeps the sums of the other
// half (the upper one where its kOff bit is set). A template, so that
// every index is a constant and the values stay in registers.
template <int kHalf, int kOff>
__device__ __forceinline__ void halve(float (&v)[kSum], int lane) {
    const bool up = (lane & kOff) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
        const float lo = v[i];
        const float hi = v[i + kHalf];
        v[i] = (up ? hi : lo)
               + __shfl_xor_sync(kFullMask, up ? lo : hi, kOff);
    }
}

// Sums each of 16 values over the warp with 8 + 4 + 2 + 1 + 1 = 16
// shuffles. Every lane returns the warp's total of value number
// (lane >> 1).
__device__ __forceinline__ float warp_sum16(float (&v)[kSum], int lane) {
    halve<8, 16>(v, lane);
    halve<4, 8>(v, lane);
    halve<2, 4>(v, lane);
    halve<1, 2>(v, lane);
    return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
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
    __shared__ __align__(16) float s_grad[kPix * kRec];
    __shared__ float s_thr[kPix];
    __shared__ int s_gid[kPix];
    __shared__ int s_touched[kPix];
    __shared__ int s_max_rank;

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int in_x = blend::warp_x0(warp) + lane % blend::kWarpW;
    const int in_y = blend::warp_y0(warp) + lane / blend::kWarpW;
    const int p = in_y * kTile + in_x;    // place in the tile's planes
    const int tile_x = (tile % tiles_x) * kTile;
    const int tile_y = (tile / tiles_x) * kTile;
    const float px = static_cast<float>(tile_x + in_x);
    const float py = static_cast<float>(tile_y + in_y);
    blend::Rect rect;
    rect.x0 = static_cast<float>(tile_x + blend::warp_x0(warp));
    rect.x1 = rect.x0 + static_cast<float>(blend::kWarpW - 1);
    rect.y0 = static_cast<float>(tile_y + blend::warp_y0(warp));
    rect.y1 = rect.y0 + static_cast<float>(blend::kWarpH - 1);
    const int start = tile_start[tile];
    const size_t pix = static_cast<size_t>(tile) * kPix + p;
    const int ncon = n_contrib[pix];

    float dc[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
        dc[f] = dcot[(static_cast<size_t>(tile) * kCot + f) * kPix + p];
    }
    const float tf = dcot[(static_cast<size_t>(tile) * kCot + kFeat) * kPix + p];
    float t = t_final[pix];
    float sigma = 0.0f;

    // No pixel of the warp used an instance ranked at or past the warp's
    // largest n_contrib: the warp's walk starts there, the staging at the
    // tile's largest.
    const int warp_rank = __reduce_max_sync(kFullMask, ncon);
    float4* s_grad4 = reinterpret_cast<float4*>(s_grad);
#pragma unroll
    for (int q = 0; q < kRecVec; ++q) {
        s_grad4[tid * kRecVec + q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    s_touched[tid] = 0;
    if (tid == 0) s_max_rank = 0;
    __syncthreads();
    if (lane == 0) atomicMax(&s_max_rank, warp_rank);
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
            s_thr[tid] = blend::skip_threshold(s_rec[tid * kRecVec + 1].y);
        }
        __syncthreads();

        // Instances of this batch below the warp's largest n_contrib.
        const int warp_n = min(n, warp_rank - base);
        for (int k = (warp_n + 31) / 32 * 32 - 32; k >= 0; k -= 32) {
            const int mine = k + lane;
            bool keep = false;
            if (mine < warp_n) {
                keep = blend::cull_keep(s_rec[mine * kRecVec],
                                        s_rec[mine * kRecVec + 1],
                                        s_thr[mine], rect);
            }
            unsigned live = __ballot_sync(kFullMask, keep);
            // Every lane runs every surviving instance, so the vote and
            // the shuffles below see all 32 lanes.
            while (live != 0u) {
                const int bit = 31 - __clz(live);
                live &= ~(1u << bit);
                const int j = k + bit;
                float v[kSum];
#pragma unroll
                for (int i = 0; i < kSum; ++i) v[i] = 0.0f;
                bool used = false;
                if (base + j < ncon) {
                    const float4 r0 = s_rec[j * kRecVec];
                    const float4 r1 = s_rec[j * kRecVec + 1];
                    const blend::Falloff f = blend::falloff(r0, r1, px, py);
                    if (f.power <= 0.0f
                        && !blend::alpha_certainly_low(f.power, s_thr[j])) {
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
                            v[0] = -sx * d_power;
                            v[1] = -sy * d_power;
                            v[2] = -0.5f * f.dx * f.dx * d_power;
                            v[3] = -f.dx * f.dy * d_power;
                            v[4] = -0.5f * f.dy * f.dy * d_power;
                            v[5] = g * d_alpha;
                            v[6] = w * dc[0];
                            v[7] = w * dc[1];
                            v[8] = w * dc[2];
                            v[9] = w * dc[3];
                        }
                    }
                }
                if (__any_sync(kFullMask, used)) {
                    const float total = warp_sum16(v, lane);
                    const int col = lane >> 1;
                    if ((lane & 1) == 0 && col < kGrad) {
                        atomicAdd(&s_grad[j * kRec + col], total);
                    }
                    if (lane == 31) s_touched[j] = 1;
                }
            }
        }
        __syncthreads();

        // Row `tid` of the gradient tile goes to its gaussian. The same
        // thread restages row `tid` next, so no barrier is needed before
        // the next batch's staging.
        if (tid < n && s_touched[tid] != 0) {
            float* out = d_rec + static_cast<size_t>(s_gid[tid]) * kRec;
            const float4 g0 = s_grad4[tid * kRecVec];
            const float4 g1 = s_grad4[tid * kRecVec + 1];
            const float4 g2 = s_grad4[tid * kRecVec + 2];
            atomicAdd(reinterpret_cast<float4*>(out), g0);
            atomicAdd(reinterpret_cast<float4*>(out) + 1, g1);
            atomicAdd(reinterpret_cast<float2*>(out + 8),
                      make_float2(g2.x, g2.y));
#pragma unroll
            for (int q = 0; q < kRecVec; ++q) {
                s_grad4[tid * kRecVec + q] =
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            s_touched[tid] = 0;
        }
    }
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers; d_rec
// must be zeroed by the caller and 16-byte aligned; the stream is
// PyTorch's current stream. Launches asynchronously and returns
// cudaGetLastError() (0 = the launch was accepted).
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
