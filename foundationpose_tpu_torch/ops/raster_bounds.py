"""Least times of the port's card kernels on an H100: the crop rasterizer's
(K1s, K1r) and the depth preprocess (K2).

One place reckons what a render call must move and compute, from the inputs
and outputs of a run: ``chip_smoke.py`` prints these bounds beside each
kernel's time, and ``apps/profile_raster.py`` beside each part of a kernel.
A bound is the larger of two times: the bytes the work must move (each input
read once, each output written once) over the card's memory rate, and its
float32 operations over the card's float32 rate. Where the work depends on
the data (tiles a face touches, pixels a face covers), it is counted on
this run's data.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores. The kernels' bounds are stated against
# these whatever the card's power limit, which is printed beside them.
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per pixel x face test that survives tile binning:
# three barycentrics (2 mul + 2 add each) and three compares. The 1/z score
# of the tests that pass and the per-pixel attribute pass are counted apart.
OPS_PER_TEST = 15
OPS_PER_INSIDE = 6     # 3 mul + 2 add + 1 compare for the 1/z score
OPS_PER_HIT_PIXEL = 80  # winner gather + perspective-correct interpolation
OPS_PER_TEXEL_PIXEL = 50  # four taps x three channels, weights, lighting
# K1s: camera transform + normal + diffuse per vertex; three projections,
# area, nine coefficients, three reciprocals, box per face; four compares
# per (face, tile) pair for the bins.
OPS_PER_VERTEX = 40
OPS_PER_FACE = 220
OPS_PER_FACE_TILE = 4
# K2, per output pixel: the erode (25 taps x 5: two range compares, a
# difference, its magnitude, a compare) over the tile and its ring (1.69
# pixels per output pixel at 32 x 8), the neighbourhood mean (25 x 6) and the
# weighted sum (25 x 15, the exponential counted as 2).
OPS_PER_K2_PIXEL = 740
K2_BYTES_PER_PIXEL = 20  # 4 read (depth); 4 + 12 written (depth, xyz map)


def tensor_bytes(*trees):
    n = 0
    for tree in trees:
        vals = tree.values() if isinstance(tree, dict) else [tree]
        n += sum(v.numel() * v.element_size() for v in vals if hasattr(v, "numel"))
    return n


def bound(nbytes, ops, **extra):
    """Least time the card could take: bytes over the memory rate against
    float32 operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "bytes": nbytes, "operations": ops, **extra}


def _counts(mt, poses, scratch, out, hw):
    """What this run's data needs: pixel x face tests after binning, valid
    faces, hit pixels, and the bytes and operations each part reckons with."""
    from foundationpose_tpu_torch.ops import raster_cuda

    B, V, F = poses.shape[0], mt["pos"].shape[0], mt["faces"].shape[0]
    H, W = hw
    rec, bins = scratch["rec"], scratch["bins"]
    tests = raster_cuda.tile_face_tests(rec, H, W)
    n_valid = int((rec[..., 12] <= rec[..., 13]).sum().item())
    hit = int(out["mask"].sum().item())
    px_ops = hit * (OPS_PER_HIT_PIXEL + (OPS_PER_TEXEL_PIXEL if "tex" in mt else 0))
    return {
        "B": B, "V": V, "F": F, "H": H, "W": W, "tests": tests, "n_valid": n_valid,
        "hit": hit,
        "test_ops": tests * OPS_PER_TEST + 2 * hit * OPS_PER_INSIDE,
        "px_ops": px_ops,
        "face_ops": B * (V * OPS_PER_VERTEX + F * OPS_PER_FACE),
        "bin_ops": B * F * bins.shape[1] * OPS_PER_FACE_TILE,
        "colour": tensor_bytes({k: v for k, v in mt.items()
                                if k in ("tex", "uv", "vertex_color")}),
        # a valid face's record is 64 bytes written (48 read), an invalid one's 16
        "rec_written": n_valid * 64 + (B * F - n_valid) * 16,
        "records_read": n_valid * 48,
    }


def k2_bound(H, W):
    """Bound of one K2 call on an (H, W) frame with its xyz map: each pixel
    read once and written once, against its stencils' operations."""
    return bound(K2_BYTES_PER_PIXEL * H * W, OPS_PER_K2_PIXEL * H * W)


def k1_bounds(mt, poses, K, tfs, scratch, out, hw):
    """Bounds of one render call on these inputs, from what this run's data
    needs. ``call``: the arguments read once and the outputs written once
    (``rec``, ``bins`` and ``vtab`` are scratch between the two kernels and do
    not count) against the pixel x face tests left after binning, the 1/z
    scores of the tests that pass (counted as 2 per hit pixel, a pixel lying
    inside few faces) and the attribute pass per hit pixel. ``K1s`` and
    ``K1r``: each kernel alone, its own inputs read once and its own outputs
    written once — so the scratch counts there: a valid face's record is 64
    bytes written (48 read), an invalid one's 16, and every bin word is
    written and read."""
    return _kernel_bounds(_counts(mt, poses, scratch, out, hw), mt, poses, K, tfs, scratch, out)


def _kernel_bounds(c, mt, poses, K, tfs, scratch, out):
    """:func:`k1_bounds` from the counts ``c`` of :func:`_counts`."""
    bins, vtab = scratch["bins"], scratch["vtab"]
    setup_ops = c["face_ops"] + c["bin_ops"]
    raster_ops = c["test_ops"] + c["px_ops"]
    geometry = tensor_bytes(mt["pos"], mt["vnormals"], mt["faces"], poses, K, tfs)
    extra = {"pixel_face_tests": c["tests"], "pixel_face_tests_untiled": c["B"] * c["H"]
             * c["W"] * c["F"], "valid_faces": c["n_valid"], "hit_pixels": c["hit"]}
    return {
        "call": bound(geometry + c["colour"] + tensor_bytes(out), setup_ops + raster_ops,
                      **extra),
        "K1s": bound(geometry + c["rec_written"] + tensor_bytes(bins, vtab), setup_ops),
        "K1r": bound(c["records_read"] + tensor_bytes(bins, vtab, mt["faces"]) + c["colour"]
                     + tensor_bytes(out), raster_ops),
    }


# the parts of each kernel that apps/profile_raster.py builds and times, in
# the order each adds to the one before it
K1S_PARTS = ("setup", "setup+bins")
K1R_PARTS = ("bins+background", "+coverage+depth", "+attributes", "+staged stores")


def k1_part_bounds(mt, poses, K, tfs, scratch, out, hw):
    """Bounds of each part of K1s and K1r (``K1S_PARTS``, ``K1R_PARTS``) on
    these inputs. K1s: the face setup alone reads the mesh, poses and
    intrinsics and writes the vertex table and the face records; the binning
    adds the bit table and its compares. K1r: reading the tile's bin row and
    writing every output as background; + the coverage and depth test, which
    reads the binned faces' records and writes depth only; + the attribute
    pass, which reads the winners' vertices and colours and writes every
    output (pixel by pixel); + the staged 16-byte stores, the full kernel,
    whose work and bytes are those of the part before it. ``call`` is the
    whole render call's bound, as in :func:`k1_bounds`."""
    c = _counts(mt, poses, scratch, out, hw)
    bins, vtab = scratch["bins"], scratch["vtab"]
    geometry = tensor_bytes(mt["pos"], mt["vnormals"], mt["faces"], poses, K, tfs)
    full = _kernel_bounds(c, mt, poses, K, tfs, scratch, out)
    return {
        "call": full["call"],
        "setup": bound(geometry + c["rec_written"] + tensor_bytes(vtab), c["face_ops"]),
        "setup+bins": full["K1s"],
        "bins+background": bound(tensor_bytes(bins, out), 0),
        "+coverage+depth": bound(c["records_read"] + tensor_bytes(bins, out["depth"]),
                                 c["test_ops"]),
        "+attributes": full["K1r"],
        "+staged stores": full["K1r"],
    }
