// Forward tile blend (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fourdgs_tpu/ops/pallas_blend.py:_forward_kernel`
// / `_forward_tile` (launched by `blend_forward_pallas`). It computes the
// same function; the plain PyTorch version beside it is
// `fourdgs_tpu_torch/ops/blend.py:blend_forward_plain`.
//
// What it computes. One thread block per 16x16 pixel tile. The block walks
// its tile's depth-sorted instances [start, start + count) front to back.
// For instance j at pixel (px, py), with integer pixel coordinates (no
// +0.5 centre):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = x_j - px, dy = y_j - py
//   alpha = min(0.99, opa_j exp(power))
// skipped when power > 0 or alpha < 1/255. A pixel stops at the first
// instance with T (1 - alpha) < 1e-4, which is not used (forward.cu:592).
// Per pixel it writes the alpha*T-weighted sum of the 6 features (rgb,
// depth, flow2), the final transmittance T, and n_contrib, the 1-based
// rank in the tile of the last instance used. The block leaves as soon
// as every one of its 256 pixels is done. Pixels past the image edge in
// partial tiles are computed like the others and cropped by the caller,
// as the TPU kernel does.
//
// What bounds it on this card: instruction issue. The record gather is
// about 30 MB at 800x800 with 100k gaussians, 9 us at 3.35 TB/s, a
// twentieth of the kernel. A (pixel, instance) pair costs about 30 issue
// slots (two 16-byte shared loads, 11 rounded falloff operations,
// the accurate expf, the tests) and only a quarter of the pairs is used.
// The TPU kernel turns the transmittance recursion into log-space
// triangular-matmul cumsums because its vector unit has no per-pixel
// serial loop; here each thread runs the recursion in f32, and the design
// spends its issue slots on pairs that can be used:
//
// - The block stages 256 records at a time in shared memory (12 KB)
//   through the sorted ids, with the per-instance threshold
//   `skip_threshold`. Block barriers stand only around the staging.
// - A warp walks on its own. It culls 32 staged instances at a time, one
//   per lane (`cull_keep`: can any pixel of the warp's rectangle reach
//   alpha >= 1/255?), takes the survivors from __ballot_sync and visits
//   only those, front to back. A warp whose pixels are all done stops
//   culling; the block leaves at __syncthreads_count(done) == threads.
// - A pair whose power is certainly too low for alpha >= 1/255 skips expf.
//   Neither test decides anything: a pair that survives them takes the
//   exact test, so the result is the plain version's bit for bit.
// - A thread owns kRows = 2 pixels of one column, 4 rows apart (so that
//   the lanes of a warp still store 8-float runs), and computes the terms
//   of the power that the column shares once (alpha_terms.cuh), with one
//   set of shared loads for both pixels; a block is 128 threads and a
//   warp's rectangle 8x8 pixels. Measured against one pixel per thread
//   (8x4) it is 0-4% faster at 800x800 and 7-11% at 1352x1014; two
//   columns per thread (16x4) and 2x2 pixels (16x8) are slower, because a
//   larger rectangle culls less (PERF.md).
//
// Numerics. Built without --use_fast_math and with -fmad=false
// (cuda_build.KERNEL_FLAGS), so expf and every product and sum round as
// the plain PyTorch version's separate elementwise operations do, and the
// alpha and transmittance tests take the same branches. The falloff terms
// come from alpha_terms.cuh, which the backward kernel K2 shares, so K2
// replays exactly the pairs this kernel composited.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using blend::kAlphaMin;
using blend::kFullMask;
using blend::kTEps;
using blend::kTile;
using blend::kWarpH;
using blend::kWarpW;

constexpr int kRows = 2;                   // pixels per thread, down
constexpr int kPix = kTile * kTile;        // pixels per tile
constexpr int kThreads = kPix / kRows;     // threads per block
constexpr int kBatch = 256;                // instances staged at a time
constexpr int kRecVec = 3;                 // float4 per 12-float record
constexpr int kFeat = 6;
constexpr int kFootH = kWarpH * kRows;     // height of a warp's rectangle
constexpr unsigned kAllDone = (1u << kRows) - 1u;

static_assert(kTile % kFootH == 0 && kThreads % 32 == 0,
              "a tile is a whole number of warps");

__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int tiles_x,
                     float* __restrict__ accum,     // (T, 6, 256)
                     float* __restrict__ t_final,   // (T, 256)
                     int* __restrict__ n_contrib)   // (T, 256)
{
    __shared__ float4 s_rec[kBatch * kRecVec];
    __shared__ float s_thr[kBatch];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // The warp's rectangle in the tile, and the thread's first pixel.
    const int foot_x = (warp % (kTile / kWarpW)) * kWarpW;
    const int foot_y = (warp / (kTile / kWarpW)) * kFootH;
    const int in_x = foot_x + lane % kWarpW;
    const int in_y = foot_y + lane / kWarpW;
    const int tile_x = (tile % tiles_x) * kTile;
    const int tile_y = (tile / tiles_x) * kTile;
    const float px = static_cast<float>(tile_x + in_x);
    float py[kRows];
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
        py[o] = static_cast<float>(tile_y + in_y + o * kWarpH);
    }
    blend::Rect rect;
    rect.x0 = static_cast<float>(tile_x + foot_x);
    rect.x1 = rect.x0 + static_cast<float>(kWarpW - 1);
    rect.y0 = static_cast<float>(tile_y + foot_y);
    rect.y1 = rect.y0 + static_cast<float>(kFootH - 1);
    const int start = tile_start[tile];
    const int count = tile_count[tile];

    float t[kRows];
    float acc[kRows][kFeat];
    int ncon[kRows];
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
        t[o] = 1.0f;
        ncon[o] = 0;
#pragma unroll
        for (int f = 0; f < kFeat; ++f) acc[o][f] = 0.0f;
    }
    unsigned done = 0u;     // one bit per pixel of the thread

    for (int base = 0; base < count; base += kBatch) {
        const int n = min(kBatch, count - base);
        for (int s = tid; s < n; s += kThreads) {
            const int g = gauss_id[start + base + s];
            const float4 r1 = rec[g * kRecVec + 1];
            s_rec[s * kRecVec] = rec[g * kRecVec];
            s_rec[s * kRecVec + 1] = r1;
            s_rec[s * kRecVec + 2] = rec[g * kRecVec + 2];
            s_thr[s] = blend::skip_threshold(r1.y);
        }
        __syncthreads();

        for (int k = 0; k < n; k += 32) {
            // A warp whose pixels are all done culls no further.
            if (__all_sync(kFullMask, done == kAllDone)) break;
            const int mine = k + lane;
            const bool keep = mine < n
                && blend::cull_keep(s_rec[mine * kRecVec],
                                    s_rec[mine * kRecVec + 1], s_thr[mine],
                                    rect);
            unsigned live = __ballot_sync(kFullMask, keep);
            if (done == kAllDone) continue;
            while (live != 0u) {
                const int j = k + __ffs(live) - 1;
                live &= live - 1u;
                const float4 r0 = s_rec[j * kRecVec];
                const float4 r1 = s_rec[j * kRecVec + 1];
                const float thr = s_thr[j];
                // The shared terms first, for every pixel of the thread:
                // independent work ahead of the branches below.
                const blend::ColTerms col = blend::col_terms(r0, px);
                blend::RowTerms row[kRows];
#pragma unroll
                for (int o = 0; o < kRows; ++o) {
                    row[o] = blend::row_terms(r0, r1, py[o]);
                }
#pragma unroll
                for (int o = 0; o < kRows; ++o) {
                    if ((done >> o) & 1u) continue;
                    const float power = blend::power_of(col, row[o]);
                    if (power > 0.0f
                        || blend::alpha_certainly_low(power, thr)) {
                        continue;
                    }
                    const float alpha = fminf(
                        blend::alpha_raw(r1, expf(power)),
                        blend::kAlphaClamp);
                    if (alpha < kAlphaMin) continue;
                    const float test_t = t[o] * (1.0f - alpha);
                    if (test_t < kTEps) {
                        done |= 1u << o;
                        continue;
                    }
                    const float4 r2 = s_rec[j * kRecVec + 2];
                    const float w = alpha * t[o];
                    acc[o][0] += r1.z * w;
                    acc[o][1] += r1.w * w;
                    acc[o][2] += r2.x * w;
                    acc[o][3] += r2.y * w;
                    acc[o][4] += r2.z * w;
                    acc[o][5] += r2.w * w;
                    t[o] = test_t;
                    ncon[o] = base + j + 1;
                }
                if (done == kAllDone) break;
            }
        }
        // Barrier before the next batch overwrites s_rec, and the
        // saturation exit: leave once every pixel of the tile is done.
        if (__syncthreads_count(done == kAllDone) == kThreads) break;
    }

#pragma unroll
    for (int o = 0; o < kRows; ++o) {
        const int p = (in_y + o * kWarpH) * kTile + in_x;
        const size_t pix = static_cast<size_t>(tile) * kPix + p;
#pragma unroll
        for (int f = 0; f < kFeat; ++f) {
            accum[(static_cast<size_t>(tile) * kFeat + f) * kPix + p] =
                acc[o][f];
        }
        t_final[pix] = t[o];
        n_contrib[pix] = ncon[o];
    }
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers; the
// stream is PyTorch's current stream. Launches asynchronously and returns
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int blend_forward_launch(const void* rec, const void* gauss_id,
                                    const void* tile_start,
                                    const void* tile_count, int num_tiles,
                                    int tiles_x, void* accum, void* t_final,
                                    void* n_contrib, void* stream) {
    if (num_tiles > 0) {
        blend_forward_kernel<<<num_tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rec),
            static_cast<const int*>(gauss_id),
            static_cast<const int*>(tile_start),
            static_cast<const int*>(tile_count), tiles_x,
            static_cast<float*>(accum), static_cast<float*>(t_final),
            static_cast<int*>(n_contrib));
    }
    return static_cast<int>(cudaGetLastError());
}
