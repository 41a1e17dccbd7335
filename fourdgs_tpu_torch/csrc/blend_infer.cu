// Packed inference tile blend (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fourdgs_tpu/ops/pallas_blend.py:_forward_kernel`
// / `_forward_tile` run with `cfg.infer=True` (launched by
// `blend_forward_pallas` from `blend_pallas_infer`; per-chunk math
// `_alpha_terms_infer`, rows from `_build_inst_data_infer` / `_pack2`). It
// computes the same function; the plain PyTorch version beside it is
// `fourdgs_tpu_torch/ops/blend.py:blend_infer_plain`.
//
// What it computes. The compositing of the forward blend K1
// (blend_forward.cu), forward only, from packed 32-byte records: eight
// 32-bit words per gaussian,
//   0..4  the f32 bits of x, y, conic a, b, c (exact)
//   5     opacity | red      6  green | blue      7  depth | 0
// where "p | q" is bf16(p) in the high half and bf16(q) in the low half. A
// bf16 is the high half of an f32, so a mask or a 16-bit shift decodes it
// exactly. Per pixel it writes the alpha*T-weighted sums of 4 features (rgb,
// depth) and the final transmittance T. There is no flow, no n_contrib and
// no backward: the evaluation and viewer renders need none.
//
// Design. One thread block per 16x16 tile, one thread per pixel, as K1. Each
// of 256 instances at a time is gathered through the sorted gaussian ids
// with two 16-byte loads (K1 needs three), decoded once by the loading
// thread and staged in shared memory in K1's float layout (12 KB), so the
// per-pair loop is K1's with two features fewer. The TPU kernel keeps the
// transmittance as a single-pass bf16 prefix sum on its matrix unit; here
// every pixel runs the recursion sequentially in f32, which is exact on the
// rounded inputs.
//
// Bound. At 800x800 with 100k gaussians the bytes are about 11 MB (the
// 32-byte table, the ids, 5 output planes), 3 us at 3.35 TB/s. The f32
// work per evaluated (pixel, instance) pair bounds it, as in K1: the
// falloff and one expf for every pair, the transmittance test and 4
// multiply-adds for the pairs that pass alpha >= 1/255.
//
// Numerics. Built with -fmad=false and without --use_fast_math
// (cuda_build.KERNEL_FLAGS). The falloff and alpha come from
// alpha_terms.cuh, so this kernel takes on the rounded records exactly the
// decisions K1 would, and matches its plain version as tightly as K1 does.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using blend::kAlphaMin;
using blend::kTEps;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels per tile = threads per block
constexpr int kRecVec = 2;            // uint4 per packed 8-word record
constexpr int kFeat = 4;              // rgb + depth

__device__ __forceinline__ float bf16_hi(unsigned w) {
    return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
    return __uint_as_float(w << 16);
}

__global__ void __launch_bounds__(kPix)
blend_infer_kernel(const uint4* __restrict__ rec,
                   const int* __restrict__ gauss_id,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   int tiles_x,
                   float* __restrict__ accum,     // (T, 4, 256)
                   float* __restrict__ t_final)   // (T, 256)
{
    // Decoded records in K1's layout (alpha_terms.cuh): r0 = (x, y, conic
    // a, conic b), r1 = (conic c, opacity, red, green); then (blue, depth).
    __shared__ float4 s_r0[kPix];
    __shared__ float4 s_r1[kPix];
    __shared__ float2 s_r2[kPix];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
    const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
    const int start = tile_start[tile];
    const int count = tile_count[tile];

    float t = 1.0f;
    float acc[kFeat] = {0.f, 0.f, 0.f, 0.f};
    bool done = false;

    for (int base = 0; base < count; base += kPix) {
        const int n = min(kPix, count - base);
        if (tid < n) {
            const int g = gauss_id[start + base + tid];
            const uint4 q0 = rec[g * kRecVec];
            const uint4 q1 = rec[g * kRecVec + 1];
            s_r0[tid] = make_float4(__uint_as_float(q0.x), __uint_as_float(q0.y),
                                    __uint_as_float(q0.z), __uint_as_float(q0.w));
            s_r1[tid] = make_float4(__uint_as_float(q1.x), bf16_hi(q1.y),
                                    bf16_lo(q1.y), bf16_hi(q1.z));
            s_r2[tid] = make_float2(bf16_lo(q1.z), bf16_hi(q1.w));
        }
        __syncthreads();
        if (!done) {
            for (int j = 0; j < n; ++j) {
                const float4 r0 = s_r0[j];
                const float4 r1 = s_r1[j];
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
                const float2 r2 = s_r2[j];
                const float w = alpha * t;
                acc[0] += r1.z * w;
                acc[1] += r1.w * w;
                acc[2] += r2.x * w;
                acc[3] += r2.y * w;
                t = test_t;
            }
        }
        // Barrier before the next batch overwrites the staged records, and
        // the saturation exit: leave once every pixel of the tile is done.
        if (__syncthreads_count(done) == kPix) break;
    }

#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
        accum[(static_cast<size_t>(tile) * kFeat + f) * kPix + tid] = acc[f];
    }
    t_final[static_cast<size_t>(tile) * kPix + tid] = t;
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers; `rec`
// must be 16-byte aligned. The stream is PyTorch's current stream. Launches
// asynchronously and returns cudaGetLastError() (0 = the launch was
// accepted).
extern "C" int blend_infer_launch(const void* rec, const void* gauss_id,
                                  const void* tile_start,
                                  const void* tile_count, int num_tiles,
                                  int tiles_x, void* accum, void* t_final,
                                  void* stream) {
    if (num_tiles > 0) {
        blend_infer_kernel<<<num_tiles, kPix, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint4*>(rec),
            static_cast<const int*>(gauss_id),
            static_cast<const int*>(tile_start),
            static_cast<const int*>(tile_count), tiles_x,
            static_cast<float*>(accum), static_cast<float*>(t_final));
    }
    return static_cast<int>(cudaGetLastError());
}
