// Forward tile blend (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fourdgs_tpu/ops/pallas_blend.py:_forward_kernel`
// / `_forward_tile` (launched by `blend_forward_pallas`). It computes the
// same function; the plain PyTorch version beside it is
// `fourdgs_tpu_torch/ops/blend.py:blend_forward_plain`.
//
// What it computes. One thread block per 16x16 pixel tile, one thread per
// pixel. The block walks its tile's depth-sorted instances [start,
// start + count) front to back. For instance j at pixel (px, py), with
// integer pixel coordinates (no +0.5 centre):
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
// Design. The TPU kernel turns the sequential transmittance recursion
// into log-space triangular-matmul cumsums over 128-lane chunks streamed
// by manual DMA, because the TPU's vector unit has no per-pixel serial
// loop. On Hopper each thread runs the recursion sequentially in f32.
// The block gathers the 12-float record (xy, conic, opacity, feat6) of
// each of 256 instances at a time into shared memory (12 KB), one
// instance per thread through three 16-byte loads; every thread then
// reads the same record (a shared-memory broadcast).
//
// Bound. The record gather is about 30 MB at 800x800 with 100k gaussians
// (0.58M instances x 48 bytes, plus ids and outputs), 9 us at 3.35 TB/s.
// The f32 ALU and SFU work per evaluated (pixel, instance) pair bounds it:
// every pair pays the falloff and one expf (about 20 operations), and
// the few pairs with alpha >= 1/255 also pay the transmittance test and
// the compositing. Making it fast (warp-level culling of instances
// outside a warp's pixels, several pixels per thread, TMA staging) is
// later work.
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
using blend::kTEps;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels per tile = threads per block
constexpr int kRecVec = 3;            // float4 per 12-float record

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int tiles_x,
                     float* __restrict__ accum,     // (T, 6, 256)
                     float* __restrict__ t_final,   // (T, 256)
                     int* __restrict__ n_contrib)   // (T, 256)
{
    __shared__ float4 s_rec[kPix * kRecVec];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
    const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
    const int start = tile_start[tile];
    const int count = tile_count[tile];

    float t = 1.0f;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int ncon = 0;
    bool done = false;

    for (int base = 0; base < count; base += kPix) {
        const int n = min(kPix, count - base);
        if (tid < n) {
            const int g = gauss_id[start + base + tid];
#pragma unroll
            for (int q = 0; q < kRecVec; ++q) {
                s_rec[tid * kRecVec + q] = rec[g * kRecVec + q];
            }
        }
        __syncthreads();
        if (!done) {
            for (int j = 0; j < n; ++j) {
                const float4 r0 = s_rec[j * kRecVec];
                const float4 r1 = s_rec[j * kRecVec + 1];
                const blend::Falloff f = blend::falloff(r0, r1, px, py);
                if (f.power > 0.0f) continue;
                const float alpha = fminf(
                    blend::alpha_raw(r1, expf(f.power)), blend::kAlphaClamp);
                if (alpha < kAlphaMin) continue;
                const float test_t = t * (1.0f - alpha);
                if (test_t < kTEps) {
                    done = true;
                    break;
                }
                const float4 r2 = s_rec[j * kRecVec + 2];
                const float w = alpha * t;
                acc[0] += r1.z * w;
                acc[1] += r1.w * w;
                acc[2] += r2.x * w;
                acc[3] += r2.y * w;
                acc[4] += r2.z * w;
                acc[5] += r2.w * w;
                t = test_t;
                ncon = base + j + 1;
            }
        }
        // Barrier before the next batch overwrites s_rec, and the
        // saturation exit: leave once every pixel of the tile is done.
        if (__syncthreads_count(done) == kPix) break;
    }

    const size_t pix = static_cast<size_t>(tile) * kPix + tid;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
        accum[(static_cast<size_t>(tile) * 6 + f) * kPix + tid] = acc[f];
    }
    t_final[pix] = t;
    n_contrib[pix] = ncon;
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
        blend_forward_kernel<<<num_tiles, kPix, 0,
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
