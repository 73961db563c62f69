// K2 — the frame's depth preprocess in one launch, Hopper (sm_90a):
// erode (radius 2) -> bilateral filter (radius 2) -> camera-space xyz map.
//
// Replaces no Pallas kernel: the JAX package computes these stencils with
// XLA (foundationpose_tpu/ops/image.py::erode_depth and
// ::bilateral_filter_depth, foundationpose_tpu/core/geometry.py::
// depth2xyzmap). In this package it replaces ~870 eager tensor ops per frame
// (25 shifted views through each stencil pass, then the xyz map), which
// remain as its plain version: ops/image.py::erode_depth +
// bilateral_filter_depth and core/geometry.py::depth2xyzmap.
//
// One launch per frame; grid (ceil(W / TW), ceil(H / TH)), TW * TH threads.
// A block owns one TW x TH tile of the output:
//   1. it loads the depth over the tile and a 2R-pixel ring into shared
//      memory (0 outside the frame, as the plain version's zero padding);
//   2. erodes the tile and an R-pixel ring from there into shared memory
//      (0 outside the frame);
//   3. runs the bilateral filter's two passes (neighbourhood mean, then the
//      weighted sum) for each pixel of the tile from shared memory;
//   4. writes the filtered depth (H, W) and, unless `xyz` is null, the xyz
//      map (H, W, 3) exactly once.
// "In bounds" is taken against the H x W array the kernel is given, as the
// plain version pads the array it is given: a row block of a frame with its
// halo rows (the row-sharded preprocess) filters as the plain version does.
//
// Rounding: bit for bit the plain version as PyTorch's CUDA kernels evaluate
// it. Every sum runs in the plain version's order (dv outer, du inner, -R..R);
// a comparison with a Python number compares with that number as float32;
// `x / python_float` is x times the float32 reciprocal (PyTorch's division by
// a CPU scalar); the spatial term is computed in double and rounded to
// float32, the range term in float32 (`python_float - tensor`); `x ** 2` is
// x * x; the exponential is expf; tensor / tensor is an IEEE division. This
// file is built with -fmad=false, so a*b+c rounds twice, as two tensor ops
// do (acc + w * nb would otherwise contract into one FMA). Products with the
// 0/1 masks are kept as products, so a NaN propagates as it does there.
//
// What bounds it: bytes. It reads 4 bytes and writes 16 per pixel: 6.1 MB at
// 480x640, 1.8 us at the card's 3.35 TB/s, and 0.3 us at the tracker's
// 224x224 pre-crop. The launch itself is the cost, so the design's point is
// one launch, no intermediate in device memory and no host round trip: the
// intrinsics are read from a device pointer.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define R 2                   // radius of both stencils
#define TW 32                 // tile width, pixels (a warp's row)
#define TH 8                  // tile height
#define NTHREADS (TW * TH)
#define IW (TW + 4 * R)       // loaded depth: tile + 2R ring
#define IH (TH + 4 * R)
#define EW (TW + 2 * R)       // eroded depth: tile + R ring
#define EH (TH + 2 * R)

// The plain functions' defaults (ops/image.py), as float32 where PyTorch
// casts the Python number to the tensor's type.
#define VALID_MIN 0.001f      // below: a hole (both stencils, the xyz map)
#define ZFAR 100.0f           // erode_depth / bilateral_filter_depth zfar
#define DIFF_THRES 0.001f     // erode_depth depth_diff_thres
#define RATIO_THRES 0.8f      // erode_depth ratio_thres
#define NEAR_MEAN 0.01f       // bilateral: neighbours within 1 cm of the mean
#define SIGMA_D 2.0           // bilateral sigma_d (a Python float: double)
#define SIGMA_R 100000.0      // bilateral sigma_r
#define WSUM_MIN 1e-12f       // bilateral clamp_min of the weight sum
#define XYZ_ZFAR INFINITY     // depth2xyzmap zfar

__global__ void __launch_bounds__(NTHREADS)
depth_preprocess_kernel(const float* __restrict__ depth, const float* __restrict__ K,
                        int H, int W, float* __restrict__ out, float* __restrict__ xyz)
{
    __shared__ float in_s[IH][IW];
    __shared__ float er_s[EH][EW];
    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;

    // 1. the depth over the tile and a 2R ring
    for (int i = tid; i < IH * IW; i += NTHREADS) {
        const int r = i / IW, c = i % IW;
        const int gy = y0 - 2 * R + r, gx = x0 - 2 * R + c;
        in_s[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? depth[(size_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();

    // 2. erode the tile and an R ring: zero a pixel when more than
    //    RATIO_THRES of its in-bounds neighbourhood is a hole, beyond ZFAR or
    //    further than DIFF_THRES from it (0/1 counts: exact in any order)
    for (int i = tid; i < EH * EW; i += NTHREADS) {
        const int r = i / EW, c = i % EW;
        const int gy = y0 - R + r, gx = x0 - R + c;
        float e = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const float d = in_s[r + R][c + R];
            int bad = 0, total = 0;
#pragma unroll
            for (int dv = -R; dv <= R; ++dv)
#pragma unroll
                for (int du = -R; du <= R; ++du) {
                    const int ny = gy + dv, nx = gx + du;
                    if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
                        const float nb = in_s[r + R + dv][c + R + du];
                        bad += (nb < VALID_MIN) | (nb >= ZFAR) | (fabsf(nb - d) > DIFF_THRES);
                        total += 1;
                    }
                }
            const bool center_invalid = (d < VALID_MIN) | (d >= ZFAR);
            e = (((float)bad / (float)total > RATIO_THRES) | center_invalid) ? 0.0f : d;
        }
        er_s[r][c] = e;
    }
    __syncthreads();

    // 3. the bilateral filter of one pixel of the tile
    const int tx = tid % TW, ty = tid / TW;
    const int gx = x0 + tx, gy = y0 + ty;
    if (gx >= W || gy >= H)
        return;
    const float d = er_s[ty + R][tx + R];
    float valid[2 * R + 1][2 * R + 1];
    float mean_sum = 0.0f, mean_cnt = 0.0f;
#pragma unroll
    for (int dv = -R; dv <= R; ++dv)
#pragma unroll
        for (int du = -R; du <= R; ++du) {
            const int ny = gy + dv, nx = gx + du;
            const float inb = (ny >= 0 && ny < H && nx >= 0 && nx < W) ? 1.0f : 0.0f;
            const float nb = er_s[ty + R + dv][tx + R + du];
            const float v = inb * (float)((nb >= VALID_MIN) & (nb < ZFAR));
            valid[dv + R][du + R] = v;
            mean_sum = mean_sum + v * nb;
            mean_cnt = mean_cnt + v;
        }
    const float mean_depth = mean_sum / fmaxf(mean_cnt, 1.0f);

    const float range_inv = 1.0f / (float)(2.0 * SIGMA_R * SIGMA_R);
    float wsum = 0.0f, acc = 0.0f;
#pragma unroll
    for (int dv = -R; dv <= R; ++dv)
#pragma unroll
        for (int du = -R; du <= R; ++du) {
            const float nb = er_s[ty + R + dv][tx + R + du];
            const float near_mean = (fabsf(nb - mean_depth) < NEAR_MEAN) ? 1.0f : 0.0f;
            const float spatial = (float)(-(du * du + dv * dv) / (2.0 * SIGMA_D * SIGMA_D));
            const float diff = d - nb;
            float w = expf(spatial - (diff * diff) * range_inv);
            w = w * valid[dv + R][du + R] * near_mean;
            wsum = wsum + w;
            acc = acc + w * nb;
        }
    const float f = (wsum > 0.0f && mean_cnt > 0.0f) ? acc / fmaxf(wsum, WSUM_MIN) : 0.0f;

    // 4. the outputs
    const size_t p = (size_t)gy * W + gx;
    out[p] = f;
    if (xyz != nullptr) {
        const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
        const bool invalid = (f < VALID_MIN) | (f > XYZ_ZFAR);
        xyz[3 * p + 0] = invalid ? 0.0f : (((float)gx - cx) * f) / fx;
        xyz[3 * p + 1] = invalid ? 0.0f : (((float)gy - cy) * f) / fy;
        xyz[3 * p + 2] = invalid ? 0.0f : f;
    }
}

// depth (H, W) f32 -> out (H, W) f32 and, unless xyz is null, xyz (H, W, 3)
// f32 from K (3, 3) f32 row-major (not read when xyz is null); all device
// pointers. Launched on `stream`; returns cudaGetLastError().
extern "C" int fp_depth_preprocess_launch(
    const void* depth, const void* K, int H, int W, void* out, void* xyz, void* stream)
{
    dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH), 1);
    depth_preprocess_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)depth, (const float*)K, H, W, (float*)out, (float*)xyz);
    return (int)cudaGetLastError();
}
