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
// no backward: the evaluation and viewer renders need none. The TPU kernel
// keeps the transmittance as a single-pass bf16 prefix sum on its matrix
// unit; here every pixel runs the recursion sequentially in f32, which is
// exact on the rounded inputs.
//
// What bounds it on this card: instruction issue, as in K1. At 800x800
// with 100k gaussians the bytes are about 11 MB (the 32-byte table, the
// ids, 5 output planes), 3 us at 3.35 TB/s; the falloff, expf and the
// tests of the (pixel, instance) pairs cost ten times that. The design is
// K1's walk on the packed records, so that issue slots go to pairs that
// can be used:
//
// - The block stages 256 packed records at a time through the sorted ids,
//   two 16-byte loads each, as they are (8 KB), with the per-instance
//   `skip_threshold` of the decoded opacity (1 KB). Block barriers stand
//   only around staging. A visit decodes what it reads: words 0..4 are f32
//   bits, opacity and red are a mask and a shift of word 5, and blue and
//   depth are decoded only for a pair that is used. Measured against
//   decoding every field once at staging into K1's float layout (44 bytes
//   per instance), this is 5-7% faster; the same walk over the two halves
//   of the records in two separate arrays is not (PERF.md).
// - A warp walks on its own: it culls 32 staged instances at a time, one
//   per lane (`cull_keep` against the warp's 8x8 rectangle), takes the
//   survivors from __ballot_sync and visits only those, front to back. A
//   pair whose power is under the threshold skips expf. A warp whose pixels
//   are all done stops culling; the block leaves at
//   __syncthreads_count(done) == threads.
// - A thread owns kRows = 2 pixels of one column, 4 rows apart, and
//   computes the column terms of the power once for both: 128 threads per
//   tile. One pixel per thread (8x4 rectangles) is 2-13% slower.
//
// Numerics. Built with -fmad=false and without --use_fast_math
// (cuda_build.KERNEL_FLAGS). The falloff and alpha come from
// alpha_terms.cuh, and the cull, the threshold and the exact test all read
// the same decoded (bf16) opacity, so the tests that skip work decide
// nothing: this kernel takes on the rounded records exactly the decisions
// K1 would, and matches its plain version bit for bit.

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
constexpr int kRecVec = 2;                 // uint4 per packed 8-word record
constexpr int kFeat = 4;                   // rgb + depth
constexpr int kFootH = kWarpH * kRows;     // height of a warp's rectangle
constexpr unsigned kAllDone = (1u << kRows) - 1u;

static_assert(kTile % kFootH == 0 && kThreads % 32 == 0,
              "a tile is a whole number of warps");

__device__ __forceinline__ float bf16_hi(unsigned w) {
    return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
    return __uint_as_float(w << 16);
}

// The record's words 0..3 and 4..6 in K1's float layout (alpha_terms.cuh):
// r0 = (x, y, conic a, conic b), r1 = (conic c, opacity, red, green).
__device__ __forceinline__ float4 decode_r0(const uint4 q0) {
    return make_float4(__uint_as_float(q0.x), __uint_as_float(q0.y),
                       __uint_as_float(q0.z), __uint_as_float(q0.w));
}

__device__ __forceinline__ float4 decode_r1(const uint4 q1) {
    return make_float4(__uint_as_float(q1.x), bf16_hi(q1.y), bf16_lo(q1.y),
                       bf16_hi(q1.z));
}

__global__ void __launch_bounds__(kThreads)
blend_infer_kernel(const uint4* __restrict__ rec,
                   const int* __restrict__ gauss_id,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   int tiles_x,
                   float* __restrict__ accum,     // (T, 4, 256)
                   float* __restrict__ t_final)   // (T, 256)
{
    __shared__ uint4 s_rec[kBatch * kRecVec];   // packed, as in `rec`
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
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
        t[o] = 1.0f;
#pragma unroll
        for (int f = 0; f < kFeat; ++f) acc[o][f] = 0.0f;
    }
    unsigned done = 0u;     // one bit per pixel of the thread

    for (int base = 0; base < count; base += kBatch) {
        const int n = min(kBatch, count - base);
        for (int s = tid; s < n; s += kThreads) {
            const int g = gauss_id[start + base + s];
            const uint4 q1 = rec[g * kRecVec + 1];
            s_rec[s * kRecVec] = rec[g * kRecVec];
            s_rec[s * kRecVec + 1] = q1;
            s_thr[s] = blend::skip_threshold(bf16_hi(q1.y));
        }
        __syncthreads();

        for (int k = 0; k < n; k += 32) {
            // A warp whose pixels are all done culls no further.
            if (__all_sync(kFullMask, done == kAllDone)) break;
            const int mine = k + lane;
            const bool keep = mine < n
                && blend::cull_keep(decode_r0(s_rec[mine * kRecVec]),
                                    decode_r1(s_rec[mine * kRecVec + 1]),
                                    s_thr[mine], rect);
            unsigned live = __ballot_sync(kFullMask, keep);
            if (done == kAllDone) continue;
            while (live != 0u) {
                const int j = k + __ffs(live) - 1;
                live &= live - 1u;
                const uint4 q1 = s_rec[j * kRecVec + 1];
                const float4 r0 = decode_r0(s_rec[j * kRecVec]);
                const float4 r1 = decode_r1(q1);
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
                    const float w = alpha * t[o];
                    acc[o][0] += r1.z * w;
                    acc[o][1] += r1.w * w;
                    acc[o][2] += bf16_lo(q1.z) * w;
                    acc[o][3] += bf16_hi(q1.w) * w;
                    t[o] = test_t;
                }
                if (done == kAllDone) break;
            }
        }
        // Barrier before the next batch overwrites the staged records, and
        // the saturation exit: leave once every pixel of the tile is done.
        if (__syncthreads_count(done == kAllDone) == kThreads) break;
    }

#pragma unroll
    for (int o = 0; o < kRows; ++o) {
        const int p = (in_y + o * kWarpH) * kTile + in_x;
#pragma unroll
        for (int f = 0; f < kFeat; ++f) {
            accum[(static_cast<size_t>(tile) * kFeat + f) * kPix + p] =
                acc[o][f];
        }
        t_final[static_cast<size_t>(tile) * kPix + p] = t[o];
    }
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
        blend_infer_kernel<<<num_tiles, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint4*>(rec),
            static_cast<const int*>(gauss_id),
            static_cast<const int*>(tile_start),
            static_cast<const int*>(tile_count), tiles_x,
            static_cast<float*>(accum), static_cast<float*>(t_final));
    }
    return static_cast<int>(cudaGetLastError());
}
