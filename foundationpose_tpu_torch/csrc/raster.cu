// K1r — crop rasterizer for Hopper (sm_90a): one launch renders B poses of
// one mesh into B crop windows of H x W pixels, each block reading only the
// faces binned to its tile.
//
// Replaces the Pallas TPU kernel
// foundationpose_tpu/ops/raster_pallas.py::_make_raster_kernel (driven by
// render_crops_pallas) together with its epilogue (perspective divide,
// texture sampling, lighting). K1s (raster_setup.cu) writes what it reads.
//
// What bounds it: bytes. A 252 x 160 x 160 call writes ~0.19 GB of float32
// output once (0.056 ms at the card's memory rate); the pixel x face tests
// that survive tile binning are ~0.04 ms of float32 work at 4096 faces and
// far less on small meshes. So the design does few tests and writes each
// output once:
//   grid (pixel tiles of 16x16, poses); a block loads its tile's row of the
//   bit table `bins` (one 32-bit word per 32 faces), turns the set bits into
//   a face-ordered list with a popcount prefix sum, and loads ONLY those
//   faces' records into shared memory (in chunks of 256 survivors). Each
//   thread owns one pixel, reads the records by shared-memory broadcast and
//   keeps the best 1/z and face in registers; faces are visited in increasing
//   index with a strict '>', so ties go to the lowest face index exactly as
//   in the plain version. A tile without faces (most of a crop's corners)
//   writes background after reading its bin row. The thread then gathers the
//   winner's three vertices, interpolates perspective-correct attributes,
//   samples the texture (bilinear, clamp addressing, texel centres at
//   half-integers) for textured meshes, lights, clips and writes its pixel's
//   final values. Everything is float32.
//
// Rounding: the inside test evaluates w_k = (px*a_k (+) py*b_k) + c_k with
// one fused multiply-add, the order of the plain version's GEMM; the
// attribute pass uses explicitly rounded multiplies and adds (MUL / ADD
// below), the order of the plain version's eager tensor ops.
//
// Inputs:
//   rec   (B, F, 16) f32, bins (B, tiles, ceil(F/32)) u32, vtab (B, V, 8) f32:
//         see raster_setup.cu.
//   faces (F, 3) i32; vcol: vertex colour (V, 3) f32, or texture uv (V, 2)
//         with v already flipped to image rows; tex (Ht, Wt, 3) f32 in [0,1].
// Outputs: rgb (B,H,W,3), xyz (B,H,W,3), depth (B,H,W), mask (B,H,W) one byte
//   0/1, normal (B,H,W,3) when with_normal, tri (B,H,W) i32 winning face id
//   (-1 = background) when asked for, bary (B,H,W,3) the winner's normalised
//   perspective-correct barycentrics (0 on background) when asked for.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define NTHREADS (TILE * TILE)
#define CHUNK NTHREADS
#define NWARPS (NTHREADS / 32)
#define ZNEAR 0.001f
#define EDGE_EPS (-1e-6f)
#define FULL 0xffffffffu
#define MUL __fmul_rn
#define ADD __fadd_rn

// sum_k u_k * a_k, products rounded, summed in order
static __device__ __forceinline__ float mix3(float u0, float a0, float u1, float a1,
                                             float u2, float a2)
{
    return ADD(ADD(MUL(u0, a0), MUL(u1, a1)), MUL(u2, a2));
}

static __device__ __forceinline__ float shade(float c, float dif, int use_light,
                                              float w_ambient, float w_diffuse)
{
    if (use_light) c = ADD(MUL(c, w_ambient), MUL(MUL(dif, c), w_diffuse));
    return fminf(fmaxf(c, 0.f), 1.f);
}

// WITH_BARY: the texture bake's variant, which also writes the barycentrics;
// every other call runs the instantiation without them, whose code is that of
// the kernel before the option existed.
template <bool WITH_BARY>
__global__ void __launch_bounds__(NTHREADS)
raster_kernel(const float4* __restrict__ rec, const uint32_t* __restrict__ bins,
              const float4* __restrict__ vtab, const int* __restrict__ faces,
              const float* __restrict__ vcol, const float* __restrict__ tex,
              int F, int V, int H, int W, int tiles_x, int words, int Ht, int Wt,
              int use_light, int with_normal, float w_ambient, float w_diffuse,
              float* __restrict__ rgb, float* __restrict__ xyz,
              float* __restrict__ depth, uint8_t* __restrict__ mask,
              float* __restrict__ normal, int* __restrict__ tri,
              float* __restrict__ bary)
{
    // survivors' records; reused as the staging area of the tile's outputs
    __shared__ float4 s_rec[3 * CHUNK];
    __shared__ float2 s_y[CHUNK];   // survivors' padded row range (ymin, ymax)
    __shared__ int s_idx[CHUNK];
    __shared__ int s_wsum[NWARPS];
    float4* const s_a = s_rec;
    float4* const s_b = s_rec + CHUNK;
    float4* const s_c = s_rec + 2 * CHUNK;

    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int px_i = (tile % tiles_x) * TILE + (t & (TILE - 1));
    const int py_i = (tile / tiles_x) * TILE + (t / TILE);
    const float px = (float)px_i;
    const float py = (float)py_i;
    // rows of this warp's strip of the tile (two rows of 16 pixels)
    const float wy0 = (float)(py_i - (lane >> 4)), wy1 = wy0 + 1.0f;
    const float4* rec_b = rec + (size_t)b * F * 4;
    const uint32_t* row = bins + ((size_t)b * gridDim.x + tile) * words;

    float best = -1.0f;
    int bestf = 0;
    bool any_faces = false;  // block-uniform: some face is binned to this tile

    for (int wbase = 0; wbase < words; wbase += NTHREADS) {
        // one bin word per thread; its survivors rank after those of the
        // threads before it (block-wide exclusive prefix sum of popcounts)
        const int w = wbase + t;
        const uint32_t bits = w < words ? row[w] : 0u;
        const int cnt = __popc(bits);
        int inc = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += up;
        }
        if (lane == 31) s_wsum[warp] = inc;
        __syncthreads();
        int off = inc - cnt, total = 0;
#pragma unroll
        for (int i = 0; i < NWARPS; ++i) {
            const int c = s_wsum[i];
            if (i < warp) off += c;
            total += c;
        }
        any_faces = any_faces || total > 0;
        for (int r0 = 0; r0 < total; r0 += CHUNK) {
            // survivors r0 .. r0+CHUNK-1, in face order
            uint32_t left = bits;
            for (int rank = off - r0; left != 0u && rank < CHUNK; ++rank) {
                const int k = __ffs(left) - 1;
                left &= left - 1u;
                if (rank >= 0) s_idx[rank] = w * 32 + k;
            }
            __syncthreads();
            const int n = min(CHUNK, total - r0);
            if (t < n) {
                const float4* r = rec_b + (size_t)s_idx[t] * 4;
                s_a[t] = r[0];
                s_b[t] = r[1];
                s_c[t] = r[2];
                const float4 bb = r[3];
                s_y[t] = make_float2(bb.z, bb.w);
            }
            __syncthreads();
            for (int i = 0; i < n; ++i) {
                // a face whose padded box misses this warp's two rows cannot
                // hold any of its pixels (warp-uniform branch)
                const float2 yy = s_y[i];
                if (yy.y < wy0 || yy.x > wy1) continue;
                const float4 A = s_a[i];
                const float4 Bq = s_b[i];
                const float4 C = s_c[i];
                const float w0 = ADD(__fmaf_rn(py, A.y, MUL(px, A.x)), A.z);
                const float w1 = ADD(__fmaf_rn(py, Bq.x, MUL(px, A.w)), Bq.y);
                const float w2 = ADD(__fmaf_rn(py, Bq.w, MUL(px, Bq.z)), C.x);
                if (w0 >= EDGE_EPS && w1 >= EDGE_EPS && w2 >= EDGE_EPS) {
                    const float s = w0 * C.y + w1 * C.z + w2 * C.w;
                    if (s > best) {
                        best = s;
                        bestf = s_idx[i];
                    }
                }
            }
            __syncthreads();
        }
        __syncthreads();  // s_wsum is rewritten by the next round of words
    }

    // ---- this pixel's values
    const bool hit = best > 0.0f;
    float o_rgb[3] = {0.f, 0.f, 0.f}, o_xyz[3] = {0.f, 0.f, 0.f}, o_nrm[3] = {0.f, 0.f, 0.f};
    float o_bary[3] = {0.f, 0.f, 0.f};
    if (hit) {
        const float4 A = rec_b[(size_t)bestf * 4 + 0];
        const float4 Bq = rec_b[(size_t)bestf * 4 + 1];
        const float4 C = rec_b[(size_t)bestf * 4 + 2];
        const float w0 = ADD(ADD(MUL(px, A.x), MUL(py, A.y)), A.z);
        const float w1 = ADD(ADD(MUL(px, A.w), MUL(py, Bq.x)), Bq.y);
        const float w2 = ADD(ADD(MUL(px, Bq.z), MUL(py, Bq.w)), C.x);
        const int i0 = faces[bestf * 3 + 0];
        const int i1 = faces[bestf * 3 + 1];
        const int i2 = faces[bestf * 3 + 2];
        const float4* vt = vtab + (size_t)b * V * 2;
        const float4 p0 = vt[i0 * 2], q0 = vt[i0 * 2 + 1];
        const float4 p1 = vt[i1 * 2], q1 = vt[i1 * 2 + 1];
        const float4 p2 = vt[i2 * 2], q2 = vt[i2 * 2 + 1];

        float u0 = w0 / fmaxf(p0.z, ZNEAR);
        float u1 = w1 / fmaxf(p1.z, ZNEAR);
        float u2 = w2 / fmaxf(p2.z, ZNEAR);
        const float usum = fmaxf(ADD(ADD(u0, u1), u2), 1e-12f);
        u0 /= usum; u1 /= usum; u2 /= usum;
        o_bary[0] = u0; o_bary[1] = u1; o_bary[2] = u2;

        o_xyz[0] = mix3(u0, p0.x, u1, p1.x, u2, p2.x);
        o_xyz[1] = mix3(u0, p0.y, u1, p1.y, u2, p2.y);
        o_xyz[2] = mix3(u0, p0.z, u1, p1.z, u2, p2.z);

        if (with_normal) {
            const float nx = mix3(u0, p0.w, u1, p1.w, u2, p2.w);
            const float ny = mix3(u0, q0.x, u1, q1.x, u2, q2.x);
            const float nz = mix3(u0, q0.y, u1, q1.y, u2, q2.y);
            const float nn = fmaxf(sqrtf(ADD(ADD(MUL(nx, nx), MUL(ny, ny)), MUL(nz, nz))), 1e-12f);
            o_nrm[0] = nx / nn; o_nrm[1] = ny / nn; o_nrm[2] = nz / nn;
        }

        const float dif = mix3(u0, q0.z, u1, q1.z, u2, q2.z);
        float cr, cg, cb;
        if (tex != nullptr) {
            // bilinear sample at the interpolated uv; taps summed (0,0) (0,1)
            // (1,0) (1,1) in (dy, dx), as the plain version sums them
            const float2 t0 = ((const float2*)vcol)[i0];
            const float2 t1 = ((const float2*)vcol)[i1];
            const float2 t2 = ((const float2*)vcol)[i2];
            const float x = __fsub_rn(MUL(mix3(u0, t0.x, u1, t1.x, u2, t2.x), (float)Wt), 0.5f);
            const float y = __fsub_rn(MUL(mix3(u0, t0.y, u1, t1.y, u2, t2.y), (float)Ht), 0.5f);
            const float x0 = floorf(x), y0 = floorf(y);
            const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
            cr = 0.f; cg = 0.f; cb = 0.f;
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                    const int xi = (int)fminf(fmaxf(x0 + (float)dx, 0.f), (float)(Wt - 1));
                    const int yi = (int)fminf(fmaxf(y0 + (float)dy, 0.f), (float)(Ht - 1));
                    const float wgt = MUL(dx ? fx : __fsub_rn(1.f, fx), dy ? fy : __fsub_rn(1.f, fy));
                    const float* texel = tex + ((size_t)yi * Wt + xi) * 3;
                    cr = ADD(cr, MUL(__ldg(texel + 0), wgt));
                    cg = ADD(cg, MUL(__ldg(texel + 1), wgt));
                    cb = ADD(cb, MUL(__ldg(texel + 2), wgt));
                }
            }
        } else {
            cr = mix3(u0, vcol[i0 * 3 + 0], u1, vcol[i1 * 3 + 0], u2, vcol[i2 * 3 + 0]);
            cg = mix3(u0, vcol[i0 * 3 + 1], u1, vcol[i1 * 3 + 1], u2, vcol[i2 * 3 + 1]);
            cb = mix3(u0, vcol[i0 * 3 + 2], u1, vcol[i1 * 3 + 2], u2, vcol[i2 * 3 + 2]);
        }
        o_rgb[0] = shade(cr, dif, use_light, w_ambient, w_diffuse);
        o_rgb[1] = shade(cg, dif, use_light, w_ambient, w_diffuse);
        o_rgb[2] = shade(cb, dif, use_light, w_ambient, w_diffuse);
    }

    // ---- write the tile
    if (WITH_BARY && px_i < W && py_i < H) {
        // optional (texture baking): each thread writes its own pixel
        const size_t p = ((size_t)b * H + py_i) * W + px_i;
#pragma unroll
        for (int c = 0; c < 3; ++c) bary[p * 3 + c] = o_bary[c];
    }
    const int tx0 = px_i - (t & (TILE - 1)), ty0 = py_i - (t / TILE);
    if ((W & 3) != 0 || tx0 + TILE > W || ty0 + TILE > H) {
        // ragged tile, or rows that are not 16-byte aligned: pixel by pixel
        if (px_i >= W || py_i >= H) return;
        const size_t p = ((size_t)b * H + py_i) * W + px_i;
        mask[p] = hit ? 1 : 0;
        if (tri != nullptr) tri[p] = hit ? bestf : -1;
        depth[p] = o_xyz[2];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            rgb[p * 3 + c] = o_rgb[c];
            xyz[p * 3 + c] = o_xyz[c];
            if (with_normal) normal[p * 3 + c] = o_nrm[c];
        }
        return;
    }
    // Whole tile: a row of the tile is 16 pixels = 192 contiguous bytes of a
    // 3-channel output, so the values go through shared memory and leave as
    // 16-byte stores, neighbouring threads on neighbouring addresses (a
    // thread writing its own pixel would make 4-byte stores 12 bytes apart).
    // The float outputs are streaming stores (evict-first): nothing in this
    // call reads them again, and they would push the records, bins and vertex
    // table of the poses still to come out of L2.
    float* const so = (float*)s_rec;  // [rgb 768 | xyz 768 | normal 768 | depth 256 | tri 256 | mask 64]
    if (any_faces) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            so[t * 3 + c] = o_rgb[c];
            so[768 + t * 3 + c] = o_xyz[c];
            so[1536 + t * 3 + c] = o_nrm[c];
        }
        so[2304 + t] = o_xyz[2];
        ((int*)so)[2560 + t] = hit ? bestf : -1;
        ((uint8_t*)(so + 2816))[t] = hit ? 1 : 0;
        __syncthreads();
    }
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* const so4 = (const float4*)so;
    const size_t pix0 = ((size_t)b * H + ty0) * W + tx0;  // first pixel of the tile
    if (t < 192) {  // 16 rows x 12 float4 of a 3-channel output
        const size_t o = (pix0 + (size_t)(t / 12) * W) * 3 + (t % 12) * 4;
        __stcs((float4*)(rgb + o), any_faces ? so4[t] : zero4);
        __stcs((float4*)(xyz + o), any_faces ? so4[192 + t] : zero4);
        if (with_normal) __stcs((float4*)(normal + o), any_faces ? so4[384 + t] : zero4);
    }
    if (t < 64) {   // 16 rows x 4 float4 (or 4 x 4 bytes of mask)
        const size_t o = pix0 + (size_t)(t / 4) * W + (t % 4) * 4;
        __stcs((float4*)(depth + o), any_faces ? so4[576 + t] : zero4);
        *(uint32_t*)(mask + o) = any_faces ? ((const uint32_t*)(so + 2816))[t] : 0u;
        if (tri != nullptr)
            *(int4*)(tri + o) = any_faces ? ((const int4*)(so + 2560))[t] : make_int4(-1, -1, -1, -1);
    }
}

// Plain C interface for ctypes. Launches on the given stream, does not
// synchronise, allocates nothing. Returns cudaGetLastError() as an int.
// ``tex`` is null for a mesh with vertex colours; ``normal``, ``tri`` and
// ``bary`` are null when not asked for.
extern "C" int fp_raster_launch(
    const void* rec, const void* bins, const void* vtab, const void* faces,
    const void* vcol, const void* tex,
    int B, int F, int V, int H, int W, int Ht, int Wt,
    int use_light, int with_normal, float w_ambient, float w_diffuse,
    void* rgb, void* xyz, void* depth, void* mask, void* normal, void* tri,
    void* bary, void* stream)
{
    const int tiles_x = (W + TILE - 1) / TILE;
    const int tiles_y = (H + TILE - 1) / TILE;
    dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)B, 1);
    auto kernel = bary != nullptr ? raster_kernel<true> : raster_kernel<false>;
    kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)rec, (const uint32_t*)bins, (const float4*)vtab,
        (const int*)faces, (const float*)vcol, (const float*)tex,
        F, V, H, W, tiles_x, (F + 31) / 32, Ht, Wt, use_light, with_normal,
        w_ambient, w_diffuse, (float*)rgb, (float*)xyz, (float*)depth,
        (uint8_t*)mask, (float*)normal, (int*)tri, (float*)bary);
    return (int)cudaGetLastError();
}
