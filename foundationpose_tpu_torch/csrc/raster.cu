// Crop rasterizer for Hopper (sm_90a): one launch renders B poses of one mesh
// into B crop windows of H x W pixels.
//
// Grid: (pixel tiles of 16x16, poses). A block streams its pose's face
// records through shared memory in chunks of 256: every thread loads one
// record, rejects it against the tile by its (padded) pixel bounding box, and
// the survivors are compacted IN FACE ORDER into shared memory. Each thread
// owns one pixel and keeps the best 1/z and the best face in registers; faces
// are visited in increasing index with a strict '>', so ties go to the lowest
// face index exactly as in the plain version. The thread then gathers the
// winner's three vertices and interpolates perspective-correct attributes.
// Everything is float32.
//
// Inputs (made by ops/raster_cuda.py from the same per-face arithmetic as the
// plain version):
//   rec   (B, F, 16) f32: [a0 b0 c0 a1 | b1 c1 a2 b2 | c2 iz0 iz1 iz2 |
//                          xmin xmax ymin ymax]
//         w_k(px,py) = a_k*px + b_k*py + c_k are the normalised barycentrics,
//         iz_k = 1/max(z_k, ZNEAR); the bbox is padded, and EMPTY
//         (xmin > xmax) for faces that must never win (degenerate, behind
//         the near plane, culled).
//   vtab  (B, V, 8) f32: [x y z nx | ny nz diffuse 0] camera-space vertices,
//         normals and the per-vertex Lambertian term.
//   vcol  (V, 4) f32: vertex colour rgb, or texture uv (u, v, 0).
//   faces (F, 3) i32.
// Outputs: rgb (B,H,W,3), xyz (B,H,W,3), depth (B,H,W), mask (B,H,W) u8,
//   normal (B,H,W,3) when with_normal, diffuse (B,H,W) when textured (then
//   rgb holds the interpolated uv and the texture is sampled afterwards),
//   tri (B,H,W) i32 winning face id (-1 = background) when asked for.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 16
#define NTHREADS (TILE * TILE)
#define CHUNK NTHREADS
#define NWARPS (NTHREADS / 32)
#define ZNEAR 0.001f
#define EDGE_EPS (-1e-6f)

__global__ void __launch_bounds__(NTHREADS)
raster_kernel(const float4* __restrict__ rec, const float4* __restrict__ vtab,
              const float4* __restrict__ vcol, const int* __restrict__ faces,
              int F, int V, int H, int W, int tiles_x,
              int textured, int use_light, int with_normal,
              float w_ambient, float w_diffuse,
              float* __restrict__ rgb, float* __restrict__ xyz,
              float* __restrict__ depth, uint8_t* __restrict__ mask,
              float* __restrict__ normal, float* __restrict__ diffuse,
              int* __restrict__ tri)
{
    __shared__ float4 s_a[CHUNK];
    __shared__ float4 s_b[CHUNK];
    __shared__ float4 s_c[CHUNK];
    __shared__ int s_idx[CHUNK];
    __shared__ int s_wcount[NWARPS];

    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const int tx0 = (tile % tiles_x) * TILE;
    const int ty0 = (tile / tiles_x) * TILE;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int px_i = tx0 + (t & (TILE - 1));
    const int py_i = ty0 + (t / TILE);
    const float px = (float)px_i;
    const float py = (float)py_i;
    const float fx0 = (float)tx0, fx1 = (float)(tx0 + TILE - 1);
    const float fy0 = (float)ty0, fy1 = (float)(ty0 + TILE - 1);
    const float4* rec_b = rec + (size_t)b * F * 4;

    float best = -1.0f;
    int bestf = 0;

    for (int base = 0; base < F; base += CHUNK) {
        const int f = base + t;
        bool keep = false;
        float4 r0, r1, r2;
        if (f < F) {
            const float4 bb = rec_b[(size_t)f * 4 + 3];
            keep = (bb.y >= fx0) && (bb.x <= fx1) && (bb.w >= fy0) && (bb.z <= fy1);
            if (keep) {
                r0 = rec_b[(size_t)f * 4 + 0];
                r1 = rec_b[(size_t)f * 4 + 1];
                r2 = rec_b[(size_t)f * 4 + 2];
            }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) s_wcount[warp] = __popc(bal);
        __syncthreads();
        int off = 0, total = 0;
#pragma unroll
        for (int i = 0; i < NWARPS; ++i) {
            const int c = s_wcount[i];
            if (i < warp) off += c;
            total += c;
        }
        if (keep) {
            const int pos = off + __popc(bal & ((1u << lane) - 1u));
            s_a[pos] = r0;
            s_b[pos] = r1;
            s_c[pos] = r2;
            s_idx[pos] = f;
        }
        __syncthreads();
        for (int i = 0; i < total; ++i) {
            const float4 A = s_a[i];
            const float4 Bq = s_b[i];
            const float4 C = s_c[i];
            const float w0 = A.x * px + A.y * py + A.z;
            const float w1 = A.w * px + Bq.x * py + Bq.y;
            const float w2 = Bq.z * px + Bq.w * py + C.x;
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

    if (px_i >= W || py_i >= H) return;
    const size_t p = ((size_t)b * H + py_i) * W + px_i;
    const bool hit = best > 0.0f;
    mask[p] = hit ? 1 : 0;
    if (tri != nullptr) tri[p] = hit ? bestf : -1;
    if (!hit) {
        rgb[p * 3 + 0] = 0.f; rgb[p * 3 + 1] = 0.f; rgb[p * 3 + 2] = 0.f;
        xyz[p * 3 + 0] = 0.f; xyz[p * 3 + 1] = 0.f; xyz[p * 3 + 2] = 0.f;
        depth[p] = 0.f;
        if (with_normal) {
            normal[p * 3 + 0] = 0.f; normal[p * 3 + 1] = 0.f; normal[p * 3 + 2] = 0.f;
        }
        if (textured) diffuse[p] = 0.f;
        return;
    }

    // ---- attributes of the winning face ----
    const float4 A = rec_b[(size_t)bestf * 4 + 0];
    const float4 Bq = rec_b[(size_t)bestf * 4 + 1];
    const float4 C = rec_b[(size_t)bestf * 4 + 2];
    const float w0 = A.x * px + A.y * py + A.z;
    const float w1 = A.w * px + Bq.x * py + Bq.y;
    const float w2 = Bq.z * px + Bq.w * py + C.x;
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
    const float usum = fmaxf(u0 + u1 + u2, 1e-12f);
    u0 /= usum; u1 /= usum; u2 /= usum;

    const float X = u0 * p0.x + u1 * p1.x + u2 * p2.x;
    const float Y = u0 * p0.y + u1 * p1.y + u2 * p2.y;
    const float Z = u0 * p0.z + u1 * p1.z + u2 * p2.z;
    xyz[p * 3 + 0] = X; xyz[p * 3 + 1] = Y; xyz[p * 3 + 2] = Z;
    depth[p] = Z;

    if (with_normal) {
        float nx = u0 * p0.w + u1 * p1.w + u2 * p2.w;
        float ny = u0 * q0.x + u1 * q1.x + u2 * q2.x;
        float nz = u0 * q0.y + u1 * q1.y + u2 * q2.y;
        const float nn = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-12f);
        normal[p * 3 + 0] = nx / nn;
        normal[p * 3 + 1] = ny / nn;
        normal[p * 3 + 2] = nz / nn;
    }

    const float4 c0 = vcol[i0], c1 = vcol[i1], c2 = vcol[i2];
    float cr = u0 * c0.x + u1 * c1.x + u2 * c2.x;
    float cg = u0 * c0.y + u1 * c1.y + u2 * c2.y;
    float cb = u0 * c0.z + u1 * c1.z + u2 * c2.z;
    const float dif = u0 * q0.z + u1 * q1.z + u2 * q2.z;
    if (textured) {
        // uv out; the texture is sampled and lit after the kernel
        diffuse[p] = dif;
    } else {
        if (use_light) {
            cr = cr * w_ambient + dif * cr * w_diffuse;
            cg = cg * w_ambient + dif * cg * w_diffuse;
            cb = cb * w_ambient + dif * cb * w_diffuse;
        }
        cr = fminf(fmaxf(cr, 0.f), 1.f);
        cg = fminf(fmaxf(cg, 0.f), 1.f);
        cb = fminf(fmaxf(cb, 0.f), 1.f);
    }
    rgb[p * 3 + 0] = cr; rgb[p * 3 + 1] = cg; rgb[p * 3 + 2] = cb;
}

// Plain C interface for ctypes. Launches on the given stream, does not
// synchronise, allocates nothing. Returns cudaGetLastError() as an int.
extern "C" int fp_raster_launch(
    const void* rec, const void* vtab, const void* vcol, const void* faces,
    int B, int F, int V, int H, int W,
    int textured, int use_light, int with_normal,
    float w_ambient, float w_diffuse,
    void* rgb, void* xyz, void* depth, void* mask, void* normal, void* diffuse,
    void* tri, void* stream)
{
    const int tiles_x = (W + TILE - 1) / TILE;
    const int tiles_y = (H + TILE - 1) / TILE;
    dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)B, 1);
    dim3 block(NTHREADS, 1, 1);
    raster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)rec, (const float4*)vtab, (const float4*)vcol,
        (const int*)faces, F, V, H, W, tiles_x, textured, use_light, with_normal,
        w_ambient, w_diffuse, (float*)rgb, (float*)xyz, (float*)depth,
        (uint8_t*)mask, (float*)normal, (float*)diffuse, (int*)tri);
    return (int)cudaGetLastError();
}
