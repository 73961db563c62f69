// K1s — face setup and tile binning for the crop rasterizer, Hopper (sm_90a).
//
// Replaces the XLA prep of the Pallas TPU rasterizer
// (foundationpose_tpu/ops/raster_pallas.py, render_crops_pallas, the block
// that builds the per-pose face tables before pl.pallas_call) and, in this
// package, the ~60 eager tensor ops of ops/raster.py::face_setup +
// ops/raster_cuda.py::make_kernel_inputs, which remain as its plain version.
//
// One launch per render call; grid (ceil(max(V, 32*ceil(F/32)) / 256), B).
// A thread serves vertex i and face i of one pose:
//   vertex i: v_cam = R v + t, n_cam = R n, diffuse = clip(<n_cam, -light>, 0, 1)
//             -> vtab (B, V, 8) f32 [x y z nx | ny nz diffuse 0];
//   face i:   projects its three corners (camera space -> K -> crop
//             transform), then signed area, the nine barycentric
//             coefficients, 1/max(z, ZNEAR), validity (|det| > 1e-12, all
//             corners beyond ZNEAR, front-facing when culling) and the pixel
//             bounding box padded by BBOX_PAD, empty for invalid faces
//             -> rec (B, F, 16) f32 [a0 b0 c0 a1 | b1 c1 a2 b2 |
//                c2 iz0 iz1 iz2 | xmin xmax ymin ymax]; an invalid face
//                writes only its (empty) bounding box;
//   warp:     its 32 consecutive faces against the 16x16 pixel tiles of the
//             crop: one __ballot_sync per tile gives the 32-bit word
//             bins[b, tile, f / 32] (bit k = face 32*(f/32)+k overlaps the
//             tile). Every word is written on every call, so the table needs
//             no memset, no atomics and no sort, is the same from run to run,
//             keeps face order (bit order) and has no per-tile cap.
//
// A face projects its own corners instead of gathering a per-vertex table
// written by other threads, which would need a second launch or a grid-wide
// barrier. The projection is a fixed sequence of IEEE multiplies, adds, fused
// multiply-adds and one division, so the same vertex gives the same bits in
// every face that uses it: shared edges have bit-identical endpoints (no
// cracks, ties on shared edges stay ties).
//
// Rounding: this file is built with -fmad=false, so a*b+c rounds twice, as
// the eager tensor ops of the plain version do; nvcc's default contraction
// into FMA would move the coefficients by an ulp and flip winners on shared
// edges. The matrix products of the plain version (R v, K v_cam, the crop
// transform) run as FMA chains in a GEMM, so those three are written with
// fmaf() in that order.
//
// What bounds it: bytes. It reads a few hundred KB (mesh, poses) and writes
// rec (64 B per valid face and pose) and bins (tiles * F / 8 bytes per pose):
// 33 MB + 13 MB at B=252, F=4096 culled, ~0.014 ms at the card's memory rate;
// ballots are taken only for tiles inside the warp's own bounding rectangle.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define NTHREADS 256
#define ZNEAR 0.001f
#define DET_EPS 1e-12f
#define BBOX_PAD 0.5f
#define FULL 0xffffffffu
#define BIN_TILES 128  // tiles whose bin words a block gathers before it writes them

// Parts of the kernel, for timing them one by one (apps/profile_raster.py
// builds -DK1S_PART=1 into a library of its own; nothing else loads it):
//   1  the face setup alone: vertex table and face records, no bit table;
//   2  + the tile binning: the kernel every path runs. With no switch given,
//      the source is that kernel's, token for token.
#ifndef K1S_PART
#define K1S_PART 2
#endif

struct Cam {      // one pose's constants, in shared memory
    float R[9];   // rotation, row-major
    float t[3];
    float K[9];   // intrinsics, row-major
    float A[6];   // rows 0 and 1 of the crop transform
};

// camera-space point of a mesh vertex: R v + t (GEMM order, then the add)
static __device__ __forceinline__ void to_cam(const Cam& c, const float* v, float* o)
{
#pragma unroll
    for (int j = 0; j < 3; ++j)
        o[j] = fmaf(v[2], c.R[3 * j + 2], fmaf(v[1], c.R[3 * j + 1], v[0] * c.R[3 * j])) + c.t[j];
}

// crop-pixel position of a camera-space point
static __device__ __forceinline__ void to_crop(const Cam& c, const float* p, float* xy)
{
    float q[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
        q[j] = fmaf(p[2], c.K[3 * j + 2], fmaf(p[1], c.K[3 * j + 1], p[0] * c.K[3 * j]));
    const float w = fmaxf(q[2], 1e-12f);
    const float u = q[0] / w, v = q[1] / w;
    xy[0] = fmaf(v, c.A[1], u * c.A[0]) + c.A[2];
    xy[1] = fmaf(v, c.A[4], u * c.A[3]) + c.A[5];
}

// Tiles i of a row of n that the interval [lo, hi] touches: hi >= 16 i and
// lo <= 16 i + 15, the test of the plain version, solved for i exactly (a
// float divided by 16 and small integers are exact). Empty when a > b.
static __device__ __forceinline__ void tile_range(float lo, float hi, int n, int& a, int& b)
{
    b = hi < 0.f ? -1 : (int)fminf(floorf(hi * (1.0f / TILE)), (float)(n - 1));
    const int k = (int)fminf(fmaxf(floorf(lo * (1.0f / TILE)), 0.f), (float)n);
    a = k + ((float)(k * TILE + TILE - 1) < lo ? 1 : 0);
}

__global__ void __launch_bounds__(NTHREADS)
setup_kernel(const float* __restrict__ pos, const float* __restrict__ vnormals,
             const int* __restrict__ faces, const float* __restrict__ poses,
             const float* __restrict__ Kmat, const float* __restrict__ crop_tfs,
             int V, int F, int words, int tiles_x, int tiles_y, int backface_cull,
             float lx, float ly, float lz,
             float4* __restrict__ vtab, float4* __restrict__ rec,
             uint32_t* __restrict__ bins)
{
    __shared__ Cam cam;
    // Per warp, 32 records (or 32 vertex rows) are laid out in shared memory
    // as they lie in device memory and leave as 16-byte stores on
    // neighbouring addresses; a thread storing its own 64-byte record would
    // touch every 32-byte sector with half a store, twice.
    __shared__ float4 s_out[NTHREADS / 32][128];
    __shared__ uint32_t s_bins[BIN_TILES][NTHREADS / 32];
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    if (t < 9) {
        cam.R[t] = poses[b * 16 + (t / 3) * 4 + (t % 3)];
        cam.K[t] = Kmat[t];
    } else if (t < 12) {
        cam.t[t - 9] = poses[b * 16 + (t - 9) * 4 + 3];
    } else if (t < 18) {
        cam.A[t - 12] = crop_tfs[b * 9 + (t - 12)];
    }
    __syncthreads();

    const int i = blockIdx.x * NTHREADS + t;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = i - lane;  // first vertex / face of this warp
    float4* const stage = s_out[warp];

    // ---- vertex i
    if (i0 < V) {
        if (i < V) {
            const float v[3] = {pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2]};
            const float n[3] = {vnormals[i * 3], vnormals[i * 3 + 1], vnormals[i * 3 + 2]};
            float p[3], m[3];
            to_cam(cam, v, p);
#pragma unroll
            for (int j = 0; j < 3; ++j)
                m[j] = fmaf(n[2], cam.R[3 * j + 2], fmaf(n[1], cam.R[3 * j + 1], n[0] * cam.R[3 * j]));
            float d = (m[0] * (-lx) + m[1] * (-ly)) + m[2] * (-lz);
            d = fminf(fmaxf(d, 0.f), 1.f);
            stage[lane * 2] = make_float4(p[0], p[1], p[2], m[0]);
            stage[lane * 2 + 1] = make_float4(m[1], m[2], d, 0.f);
        }
        __syncwarp();
        float4* out = vtab + ((size_t)b * V + i0) * 2;
        const int n4 = min(32, V - i0) * 2;
        if (lane < n4) out[lane] = stage[lane];
        if (lane + 32 < n4) out[lane + 32] = stage[lane + 32];
        __syncwarp();
    }

    // ---- face i (whole warps: every lane takes part in the ballots; a warp
    // beyond the last word of faces only joins the block's barriers below)
    const int word = i >> 5;
    const bool in_words = word < words;   // warp-uniform
    const int f = i;
    bool valid = false;
    float xmin = 1e30f, xmax = -1e30f, ymin = 1e30f, ymax = -1e30f;
    float4 r0, r1, r2;
    if (f < F) {
        float c[3][3], xy[3][2];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int vi = faces[f * 3 + k];
            const float v[3] = {pos[vi * 3], pos[vi * 3 + 1], pos[vi * 3 + 2]};
            to_cam(cam, v, c[k]);
            to_crop(cam, c[k], xy[k]);
        }
        const float x0 = xy[0][0], y0 = xy[0][1];
        const float x1 = xy[1][0], y1 = xy[1][1];
        const float x2 = xy[2][0], y2 = xy[2][1];
        const float det = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
        valid = fabsf(det) > DET_EPS && c[0][2] > ZNEAR && c[1][2] > ZNEAR && c[2][2] > ZNEAR;
        if (valid && backface_cull) {
            // outward-CCW geometric normal against the ray to the centroid
            const float e1[3] = {c[1][0] - c[0][0], c[1][1] - c[0][1], c[1][2] - c[0][2]};
            const float e2[3] = {c[2][0] - c[0][0], c[2][1] - c[0][1], c[2][2] - c[0][2]};
            const float nf[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                                 e1[2] * e2[0] - e1[0] * e2[2],
                                 e1[0] * e2[1] - e1[1] * e2[0]};
            const float g[3] = {((c[0][0] + c[1][0]) + c[2][0]) / 3.f,
                                ((c[0][1] + c[1][1]) + c[2][1]) / 3.f,
                                ((c[0][2] + c[1][2]) + c[2][2]) / 3.f};
            valid = ((nf[0] * g[0] + nf[1] * g[1]) + nf[2] * g[2]) < 0.f;
        }
        if (valid) {
            const float inv = 1.0f / (fabsf(det) < DET_EPS ? 1.0f : det);
            xmin = fminf(fminf(x0, x1), x2) - BBOX_PAD;
            xmax = fmaxf(fmaxf(x0, x1), x2) + BBOX_PAD;
            ymin = fminf(fminf(y0, y1), y2) - BBOX_PAD;
            ymax = fmaxf(fmaxf(y0, y1), y2) + BBOX_PAD;
            const float a0 = (y1 - y2) * inv, b0 = (x2 - x1) * inv, c0 = (x1 * y2 - x2 * y1) * inv;
            const float a1 = (y2 - y0) * inv, b1 = (x0 - x2) * inv, c1 = (x2 * y0 - x0 * y2) * inv;
            const float a2 = (y0 - y1) * inv, b2 = (x1 - x0) * inv, c2 = (x0 * y1 - x1 * y0) * inv;
            r0 = make_float4(a0, b0, c0, a1);
            r1 = make_float4(b1, c1, a2, b2);
            r2 = make_float4(c2, 1.0f / fmaxf(c[0][2], ZNEAR), 1.0f / fmaxf(c[1][2], ZNEAR),
                             1.0f / fmaxf(c[2][2], ZNEAR));
        }
    }
    if (in_words) {
        // the warp's 32 records, 2 KB contiguous; an invalid face's first
        // three quarters are left unwritten
        const uint32_t vmask = __ballot_sync(FULL, valid);
        if (valid) {
            stage[lane * 4] = r0;
            stage[lane * 4 + 1] = r1;
            stage[lane * 4 + 2] = r2;
        }
        stage[lane * 4 + 3] = make_float4(xmin, xmax, ymin, ymax);
        __syncwarp();
        float4* out = rec + ((size_t)b * F + i0) * 4;
        const int n4 = min(32, F - i0) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = q * 32 + lane;  // quarter j % 4 of face i0 + j / 4
            if (j < n4 && ((j & 3) == 3 || ((vmask >> (j >> 2)) & 1u))) out[j] = stage[j];
        }
    }

#if K1S_PART >= 2
    // ---- tile bins of this warp's 32 faces
    // The face's own tile range, in integers, then the warp's bounding
    // rectangle of tiles (empty for a warp without a valid face, or beyond
    // the last word): ballots are taken only inside it, every other word of
    // the warp's column of the table is written as zero.
    int fx0 = 0x7fffffff, fx1 = -1, fy0 = 0x7fffffff, fy1 = -1;
    if (valid) {
        tile_range(xmin, xmax, tiles_x, fx0, fx1);
        tile_range(ymin, ymax, tiles_y, fy0, fy1);
    }
    const int lo_x = __reduce_min_sync(FULL, fx0), hi_x = __reduce_max_sync(FULL, fx1);
    const int lo_y = __reduce_min_sync(FULL, fy0), hi_y = __reduce_max_sync(FULL, fy1);

    // The block's 8 warps hold 8 neighbouring words of every tile: 32 bytes,
    // one sector. They are gathered in shared memory, BIN_TILES tiles at a
    // time: cleared, filled by one ballot per tile of the warp's rectangle,
    // and written sector by sector.
    const int tiles = tiles_x * tiles_y;
    const int word0 = word - warp;  // first word of this block
    const int nw = min(NTHREADS / 32, words - word0);  // words of this block
    for (int t0 = 0; t0 < tiles; t0 += BIN_TILES) {
        const int nt = min(BIN_TILES, tiles - t0);
        for (int j = t; j < nt * (NTHREADS / 32); j += NTHREADS) (&s_bins[0][0])[j] = 0u;
        __syncthreads();
        for (int ty = lo_y; ty <= hi_y; ++ty) {          // warp-uniform bounds
            for (int tx = lo_x; tx <= hi_x; ++tx) {
                const int tl = ty * tiles_x + tx - t0;
                if (tl < 0 || tl >= nt) continue;
                const uint32_t bal = __ballot_sync(
                    FULL, tx >= fx0 && tx <= fx1 && ty >= fy0 && ty <= fy1);
                if (lane == 0) s_bins[tl][warp] = bal;
            }
        }
        __syncthreads();
        for (int j = t; j < nt * (NTHREADS / 32); j += NTHREADS) {
            const int tl = j / (NTHREADS / 32), k = j % (NTHREADS / 32);
            if (k < nw) bins[((size_t)b * tiles + t0 + tl) * words + word0 + k] = s_bins[tl][k];
        }
        __syncthreads();
    }
#endif
}

// Plain C interface for ctypes. Launches on the given stream, does not
// synchronise, allocates nothing. Returns cudaGetLastError() as an int.
extern "C" int fp_raster_setup_launch(
    const void* pos, const void* vnormals, const void* faces, const void* poses,
    const void* K, const void* crop_tfs, int B, int V, int F, int H, int W,
    int backface_cull, float lx, float ly, float lz,
    void* vtab, void* rec, void* bins, void* stream)
{
    const int words = (F + 31) / 32;
    const int n = V > words * 32 ? V : words * 32;
    dim3 grid((unsigned)((n + NTHREADS - 1) / NTHREADS), (unsigned)B, 1);
    setup_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)vnormals, (const int*)faces,
        (const float*)poses, (const float*)K, (const float*)crop_tfs,
        V, F, words, (W + TILE - 1) / TILE, (H + TILE - 1) / TILE, backface_cull,
        lx, ly, lz, (float4*)vtab, (float4*)rec, (uint32_t*)bins);
    return (int)cudaGetLastError();
}
