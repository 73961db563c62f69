#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main path — learned-hybrid ``register`` then ``track_one``
with the shipped object-agnostic checkpoint, 252 hypotheses, 160 px crops,
bf16 nets — through the entry points a user calls, builds every CUDA kernel
of that path (K1s: face setup and tile binning, K1r: the crop rasterizer)
from the sources in this checkout, and holds each kernel against its plain
PyTorch version on the card. A second ``register`` runs on a textured mesh
at the 4096-face cap, the size users' meshes land in. Imports only
``foundationpose_tpu_torch``. Every phase prints one JSON line; any failed
phase exits non-zero. Without a CUDA device it exits 1 and prints no result.

Times are wall times around work that ends in ``torch.cuda.synchronize()``
(or CUDA events for the kernel table) and include the Python overhead of an
eager loop; a kernel's ``ms`` is taken with CUDA events around its wrapper
(allocations and launch included), its ``device_ms`` from the profiler's
kernel records. Every number belongs to the card named in the ``device`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

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

ADDS_GATE = 0.10       # of the mesh diameter
TRACK_FRAMES = 5
S = 160                # crop size of the main path
FAILURES = []          # accuracy gates that failed; reported after the phase lines


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, kernel_names):
    """Device time per launch of the named kernels over ``reps`` calls of
    ``fn``, from the profiler's kernel records (no host time in it). None for
    a kernel the profiler did not see."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(kernel_names)
    for e in prof.key_averages():
        for name in kernel_names:
            if name in e.key and e.count:
                out[name] = e.self_device_time_total / e.count / 1e3
    return out


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


def k1_bounds(raster_cuda, mt, poses, K, tfs, scratch, out):
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
    B, V, F = poses.shape[0], mt["pos"].shape[0], mt["faces"].shape[0]
    rec, bins = scratch["rec"], scratch["bins"]
    tests = raster_cuda.tile_face_tests(rec, S, S)
    n_valid = int((rec[..., 12] <= rec[..., 13]).sum().item())
    hit = int(out["mask"].sum().item())
    px_ops = hit * (OPS_PER_HIT_PIXEL + (OPS_PER_TEXEL_PIXEL if "tex" in mt else 0))
    raster_ops = tests * OPS_PER_TEST + 2 * hit * OPS_PER_INSIDE + px_ops
    setup_ops = B * (V * OPS_PER_VERTEX + F * OPS_PER_FACE
                     + F * bins.shape[1] * OPS_PER_FACE_TILE)
    geometry = tensor_bytes(mt["pos"], mt["vnormals"], mt["faces"], poses, K, tfs)
    colour = tensor_bytes({k: v for k, v in mt.items() if k in ("tex", "uv", "vertex_color")})
    rec_written = n_valid * 64 + (B * F - n_valid) * 16
    scratch_read = n_valid * 48 + tensor_bytes(bins, scratch["vtab"])
    extra = {"pixel_face_tests": tests, "pixel_face_tests_untiled": B * S * S * F,
             "valid_faces": n_valid, "hit_pixels": hit}
    return {
        "call": bound(geometry + colour + tensor_bytes(out), setup_ops + raster_ops, **extra),
        "K1s": bound(geometry + rec_written + tensor_bytes(bins, scratch["vtab"]), setup_ops),
        "K1r": bound(scratch_read + tensor_bytes(mt["faces"]) + colour + tensor_bytes(out),
                     raster_ops),
    }


def kernel_cases(scene_mesh):
    """(name, mesh, max_faces) of the meshes the kernels are checked on."""
    from foundationpose_tpu_torch.core import meshio

    rng = np.random.default_rng(0)
    sph = meshio.make_icosphere_mesh(subdivisions=3, radius=0.06)  # 1280 faces
    sph.vertex_colors = (np.abs(sph.vertices) / 0.06 * 255).astype(np.uint8)
    tex_mesh = meshio.make_icosphere_mesh(subdivisions=5, radius=0.06)  # 20480 faces
    v = tex_mesh.vertices / 0.06
    tex_mesh.uv = np.stack(
        [np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5, np.arccos(np.clip(v[:, 2], -1, 1)) / np.pi],
        axis=-1,
    )
    yy, xx = np.mgrid[0:256, 0:256]
    tex = np.stack(
        [127 + 120 * np.sin(xx / 9.0), 127 + 120 * np.cos(yy / 7.0), 127 + 100 * np.sin((xx + yy) / 13.0)],
        axis=-1,
    )
    tex_mesh.texture = np.clip(tex + rng.normal(0, 4, tex.shape), 0, 255).astype(np.uint8)
    return [
        ("demo_lshape", scene_mesh, None),
        ("icosphere_1280_vcol", sph, None),
        ("textured_cap_4096", tex_mesh, 4096),
    ]


COMPARE_TOL = (("depth", 1e-4), ("xyz", 1e-4), ("rgb", 1e-3), ("normal", 1e-3))
COMPARE_GATE = (
    "mask equal on >=0.999 of pixels; on common pixels depth/xyz <=1e-4 m and rgb/normal "
    "<=1e-3 for >=0.999 of them, and for EVERY common pixel on which both picked the same "
    "face (textured rgb, now final colour out of the kernel: 1e-2 there, because the "
    "texture's gradient — steepest on the atlas seam — multiplies a ~1e-6 difference in the "
    "interpolated uv). Both sides are float32; the camera-space vertices differ in the "
    "summation order of a 3x3 product, which can flip the winner between two faces that "
    "share an edge, where their scores tie to an ulp"
)
SETUP_TOL = {"vtab": 1e-5, "bbox_px": 1e-2, "invz_rel": 1e-5, "coeff_rel": 1e-3}
SETUP_GATE = (
    "vtab (camera-space vertices in metres, unit normals, diffuse) within 1e-5; on faces "
    "valid on both sides the bounding box within 1e-2 px, 1/z within 1e-5 relative and the "
    "nine barycentric coefficients within 1e-3 of the face's largest coefficient (the 3x3 "
    "products R v, K v and the crop transform are summed in another order than the "
    "library's GEMM, which moves a crop coordinate by ~1e-4 px, and a coefficient is a "
    "coordinate difference over the face's area); validity flags equal except where |det|, "
    "z - ZNEAR or the culling dot product is within rounding of its threshold; bins equal "
    "on >=0.9999 of (tile, face) pairs; and every (tile, face) pair that holds a winning "
    "pixel of the plain render is set in the kernel's bins"
)


def near_validity_threshold(torch, raster, mt, s, cull):
    """(B,F) bool: faces whose validity hangs on a comparison that rounding
    can turn — |det| against 1e-12, a corner's z against ZNEAR, the culling
    dot product against 0 — judged on the plain version's quantities."""
    xy = s["tri_xy"]
    e1, e2 = xy[..., 1, :] - xy[..., 0, :], xy[..., 2, :] - xy[..., 0, :]
    p, q = e1[..., 0] * e2[..., 1], e1[..., 1] * e2[..., 0]
    near = ((p - q).abs() - 1e-12).abs() <= 1e-4 * (p.abs() + q.abs()) + 1e-13
    tri_cam = s["v_cam"][:, mt["faces"].long()]
    near |= ((tri_cam[..., 2] - raster.ZNEAR).abs() <= 1e-6).any(dim=-1)
    if cull:
        nf = torch.linalg.cross(tri_cam[:, :, 1] - tri_cam[:, :, 0],
                                tri_cam[:, :, 2] - tri_cam[:, :, 0], dim=-1)
        g = tri_cam.mean(dim=2)
        near |= (nf * g).sum(dim=-1).abs() <= 1e-4 * (nf * g).abs().sum(dim=-1)
    return near


def compare_setup(raster, raster_cuda, torch, mt, poses, K, tfs, cull, tag, hw=(S, S)):
    """K1s against its plain version (face_setup + make_kernel_inputs +
    tile_bins) on the same tensors. Returns the figures and the kernel's
    scratch; exits on a disagreement."""
    scratch = raster_cuda.setup_cuda(mt, poses, K, tfs, hw, backface_cull=cull)
    torch.cuda.synchronize()
    s = raster.face_setup(mt, poses, K, tfs, backface_cull=cull)
    ref = raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=cull)
    ref_bins = raster_cuda.tile_bins(ref["rec"], *hw)
    F = mt["faces"].shape[0]
    rec, rrec = scratch["rec"], ref["rec"]
    valid, rvalid = rec[..., 12] <= rec[..., 13], rrec[..., 12] <= rrec[..., 13]
    differ = valid != rvalid
    unexplained = differ & ~near_validity_threshold(torch, raster, mt, s, cull)
    both = valid & rvalid
    a, r = rec[both], rrec[both]
    scale = r[:, :9].abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    same_bins = (raster_cuda.unpack_bins(scratch["bins"], F)
                 == raster_cuda.unpack_bins(ref_bins, F)).float().mean().item()
    row = {**tag, "faces": F, "valid_faces": int(valid.sum().item()),
           "vtab_max_abs_err": (scratch["vtab"] - ref["vtab"]).abs().max().item(),
           "bbox_px_max_abs_err": (a[:, 12:] - r[:, 12:]).abs().max().item(),
           "invz_max_rel_err": ((a[:, 9:12] - r[:, 9:12]).abs() / r[:, 9:12].abs()).max().item(),
           "coeff_max_rel_err": ((a[:, :9] - r[:, :9]).abs() / scale).max().item(),
           "validity_flags_differ": int(differ.sum().item()),
           "validity_flags_differ_unexplained": int(unexplained.sum().item()),
           "bins_agree": same_bins}
    ok = (bool(both.any()) and torch.isfinite(scratch["vtab"]).all() and torch.isfinite(a).all()
          and row["vtab_max_abs_err"] <= SETUP_TOL["vtab"]
          and row["bbox_px_max_abs_err"] <= SETUP_TOL["bbox_px"]
          and row["invz_max_rel_err"] <= SETUP_TOL["invz_rel"]
          and row["coeff_max_rel_err"] <= SETUP_TOL["coeff_rel"]
          and row["validity_flags_differ_unexplained"] == 0 and same_bins >= 0.9999)
    if not ok:
        say("kernels", failed=row)
        fail(f"K1s disagrees with its plain version: {row}")
    return row, scratch


def compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw, tag, scratch):
    """One render call (K1r on the scratch K1s just made) against the plain
    version on the same tensors. Returns the row of figures; exits on a
    disagreement or on a winner lost to binning."""
    a = raster_cuda.rasterize_cuda(mt, scratch, kw["out_hw"], True, 0.8, 0.5,
                                   kw["with_normal"], with_tri=True)
    torch.cuda.synchronize()
    a["tri"] = a["tri"].long()
    ref = raster.render_crops(mt, poses, K, tfs, **kw)
    torch.cuda.synchronize()
    agree = (a["mask"] == ref["mask"]).float().mean().item()
    both = a["mask"] & ref["mask"]
    same = both & (a["tri"] == ref["tri"])
    # no winner may be lost to binning: the plain render's winning face of a
    # pixel must be in the kernel's bins of that pixel's tile
    B, F = poses.shape[0], mt["faces"].shape[0]
    H, W = kw["out_hw"]
    ys, xs = torch.meshgrid(torch.arange(H, device=poses.device),
                            torch.arange(W, device=poses.device), indexing="ij")
    tile_of_pixel = ((ys // raster_cuda.TILE) * -(-W // raster_cuda.TILE)
                     + xs // raster_cuda.TILE).reshape(-1)
    tri = ref["tri"].reshape(B, -1).clamp_min(0)
    bins = scratch["bins"]
    words = bins.reshape(B, -1).gather(1, tile_of_pixel[None] * bins.shape[2] + tri // 32)
    binned = ((words >> (tri % 32).int()) & 1).bool()
    lost = int((~binned & ref["mask"].reshape(B, -1)).sum().item())
    row = {**tag, "faces": F, "mask_agree": agree,
           "covered": both.float().mean().item(), "winners_lost_to_binning": lost,
           "winner_flips_of_common": 1.0 - same.sum().item() / max(both.sum().item(), 1)}
    ok = (agree >= 0.999 and bool(same.any()) and row["winner_flips_of_common"] <= 1e-3
          and lost == 0)
    for key, tol in COMPARE_TOL:
        if key not in a:
            continue
        if not torch.isfinite(a[key]).all():
            fail(f"K1r {tag}: non-finite {key}")
        d = (a[key] - ref[key]).abs()
        d = d if d.ndim == 3 else d.amax(dim=-1)
        row[f"{key}_max_abs_err"] = d[same].max().item()
        row[f"{key}_max_abs_err_incl_flips"] = d[both].max().item()
        row[f"{key}_within_tol"] = (d[both] <= tol).float().mean().item()
        # same-winner pixels must all be inside the tolerance (COMPARE_GATE
        # says why textured rgb gets 1e-2 there)
        strict = 1e-2 if key == "rgb" and "tex" in mt else tol
        ok = ok and row[f"{key}_within_tol"] >= 0.999 and row[f"{key}_max_abs_err"] <= strict
    if not ok:
        say("kernels", failed=row)
        fail(f"K1r disagrees with its plain version: {row}")
    return row


def check_deterministic(raster_cuda, torch, mt, poses, K, tfs, name):
    """Two calls on the same inputs must give the same bits: outputs, vertex
    table, bins, and the records of valid faces."""
    runs = []
    for _ in range(2):
        sc = raster_cuda.setup_cuda(mt, poses, K, tfs, (S, S), backface_cull=True)
        out = raster_cuda.rasterize_cuda(mt, sc, (S, S), True, 0.8, 0.5, True, with_tri=True)
        valid = sc["rec"][..., 12] <= sc["rec"][..., 13]
        runs.append({**out, "vtab": sc["vtab"], "bins": sc["bins"],
                     "bbox": sc["rec"][..., 12:], "rec_valid": sc["rec"][valid]})
    torch.cuda.synchronize()
    for key in runs[0]:
        if not torch.equal(runs[0][key], runs[1][key]):
            fail(f"{name}: two calls on the same inputs differ in {key}")


def check_kernels(scene, torch):
    """K1s and K1r against their plain versions on the card at the main
    path's shapes, then their times beside their bounds."""
    from foundationpose_tpu_torch.core import geometry as geo, meshio, poses as poses_mod
    from foundationpose_tpu_torch.ops import raster, raster_cuda

    dev = torch.device("cuda")
    K = torch.tensor(scene["K"], dtype=torch.float32, device=dev)
    # crop windows from real hypotheses: the 252-pose register grid at the
    # scene's translation, padded to 256 with copies of hypothesis 0 as
    # register pads it, and 8 tracking-style poses around the true one
    hyp = poses_mod.make_rotation_grid().astype(np.float32)
    hyp[:, :3, 3] = scene["gt"][:3, 3]
    hyp256 = np.concatenate([hyp, np.tile(hyp[:1], (4, 1, 1))])
    hyp8 = np.tile(scene["gt"][None].astype(np.float32), (8, 1, 1))
    hyp8[1:, :3, 3] += np.random.default_rng(1).normal(0, 0.002, (7, 3)).astype(np.float32)
    batches = {"B256": torch.tensor(hyp256, device=dev), "B8": torch.tensor(hyp8, device=dev)}

    meshes = []
    for name, mesh, max_faces in kernel_cases(scene["mesh"]):
        b = mesh.bounds
        mesh = mesh.translated(-(b[0] + b[1]) / 2)
        mt = raster.make_mesh_tensors(mesh, max_faces=max_faces, bucket=True, device=dev)
        meshes.append((name, mt, meshio.compute_mesh_diameter(mesh=mesh)))

    rows, setup_rows = [], []
    for name, mt, diameter in meshes:
        for bname, poses in batches.items():
            tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, (S, S))
            for cull in (False, True):
                tag = {"case": name, "batch": bname, "cull": cull}
                srow, scratch = compare_setup(raster, raster_cuda, torch, mt, poses, K, tfs, cull, tag)
                setup_rows.append(srow)
                for with_normal in (False, True):
                    kw = dict(out_hw=(S, S), backface_cull=cull, with_normal=with_normal)
                    rows.append(compare_with_plain(
                        raster, raster_cuda, torch, mt, poses, K, tfs, kw,
                        {**tag, "with_normal": with_normal}, scratch))
            if bname == "B256":
                check_deterministic(raster_cuda, torch, mt, poses, K, tfs, name)

    # ---- the shapes around the main path: the full 480x640 frame the demo
    # scene is rendered at (1200 tiles, 36 faces, not bucketed), crops whose
    # sides are no multiple of the tile or whose rows are not 16-byte aligned
    # (pixel-by-pixel stores), and the undecimated 20480-face textured mesh
    # (640 bin words: more than one round of words per block)
    gt = torch.tensor(scene["gt"][None], dtype=torch.float32, device=dev)
    eye = torch.eye(3, device=dev)[None]
    big = raster.make_mesh_tensors(kernel_cases(scene["mesh"])[2][1], device=dev)
    sph_mt, sph_diameter = meshes[1][1], meshes[1][2]
    p8 = batches["B8"]
    extra = [("full_frame_480x640", scene["mesh_tensors"], gt, eye, tuple(scene["hw"])),
             ("ragged_90x102", sph_mt, p8,
              geo.compute_crop_window_tf_batch(p8, K, 1.2, sph_diameter, (90, 102)), (90, 102)),
             ("ragged_100x104", sph_mt, p8,
              geo.compute_crop_window_tf_batch(p8, K, 1.2, sph_diameter, (100, 104)), (100, 104)),
             ("textured_20480", big, p8,
              geo.compute_crop_window_tf_batch(p8, K, 1.2, 0.12, (S, S)), (S, S))]
    for name, mt, poses, tfs, hw in extra:
        for cull in (False, True):
            tag = {"case": name, "batch": f"B{poses.shape[0]}", "cull": cull}
            srow, scratch = compare_setup(raster, raster_cuda, torch, mt, poses, K, tfs, cull, tag, hw)
            setup_rows.append(srow)
            kw = dict(out_hw=hw, backface_cull=cull, with_normal=True)
            rows.append(compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw,
                                           {**tag, "with_normal": True}, scratch))
    worst = {key: max(r[f"{key}_max_abs_err"] for r in rows if f"{key}_max_abs_err" in r)
             for key, _ in COMPARE_TOL}
    worst_flips = {key: max(r[f"{key}_max_abs_err_incl_flips"] for r in rows
                            if f"{key}_max_abs_err" in r) for key, _ in COMPARE_TOL}
    setup_keys = ("vtab_max_abs_err", "bbox_px_max_abs_err", "invz_max_rel_err",
                  "coeff_max_rel_err", "validity_flags_differ")
    setup_worst = {k: max(r[k] for r in setup_rows) for k in setup_keys}
    setup_worst["min_bins_agree"] = min(r["bins_agree"] for r in setup_rows)

    # ---- times at B=256, 160 px, culled: the refine path's call (no normals)
    # and the geometric score's (with normals), one entry per face bucket;
    # the first mesh (the demo's) is the main path's
    poses = batches["B256"]
    curve = []
    for name, mt, diameter in meshes:
        tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, (S, S))
        setup_fn = lambda: raster_cuda.setup_cuda(mt, poses, K, tfs, (S, S), backface_cull=True)
        plain_setup_fn = lambda: raster_cuda.tile_bins(
            raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=True)["rec"], S, S)
        scratch = setup_fn()
        for with_normal in (False, True):
            kw = dict(out_hw=(S, S), backface_cull=True, with_normal=with_normal)
            plain_fn = lambda: raster.render_crops(mt, poses, K, tfs, **kw)
            call_fn = lambda: raster_cuda.render_crops(mt, poses, K, tfs, **kw)
            raster_fn = lambda: raster_cuda.rasterize_cuda(
                mt, scratch, (S, S), True, 0.8, 0.5, with_normal)
            # in turns: plain, kernels, kernels, plain
            p1 = event_ms(plain_fn, 1)
            c1 = event_ms(call_fn, 30)
            c2 = event_ms(call_fn, 30)
            p2 = event_ms(plain_fn, 1)
            bounds = k1_bounds(raster_cuda, mt, poses, K, tfs, scratch, call_fn())
            dev_ms = device_ms(call_fn, 20, ("setup_kernel", "raster_kernel"))
            curve.append({
                "case": name, "with_normal": with_normal,
                "shape": f"B256 x {S}x{S} px, {mt['faces'].shape[0]}-face bucket, culled, "
                         + ("with normals" if with_normal else "no normals"),
                "ms": min(c1, c2), "ms_runs": [c1, c2],
                "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
                "K1s_ms": event_ms(setup_fn, 50), "K1r_ms": event_ms(raster_fn, 50),
                "K1s_device_ms": dev_ms["setup_kernel"], "K1r_device_ms": dev_ms["raster_kernel"],
                "K1s_plain_ms": event_ms(plain_setup_fn, 3),
                **bounds["call"],
                "K1s_bound": bounds["K1s"], "K1r_bound": bounds["K1r"],
            })
    say("kernels", n_cases=len(rows), n_setup_cases=len(setup_rows),
        K1r={"worst_abs_err": worst, "worst_abs_err_incl_winner_flips": worst_flips,
             "gate": COMPARE_GATE,
             "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
             "winners_lost_to_binning": sum(r["winners_lost_to_binning"] for r in rows),
             "min_mask_agree": min(r["mask_agree"] for r in rows),
             "min_within_tol": min(v for r in rows for k, v in r.items()
                                   if k.endswith("_within_tol"))},
        K1s={"worst": setup_worst, "gate": SETUP_GATE},
        deterministic="two calls on the same inputs gave the same bits on every mesh",
        times_B256=curve)
    return {"worst_abs_err": worst, "worst_abs_err_incl_winner_flips": worst_flips,
            "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
            "setup_worst": setup_worst, "curve": curve}


def check_pose(name, pose, gt, mesh, diameter, metrics):
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        fail(f"{name}: pose is not a finite (4,4) matrix")
    R = pose[:3, :3]
    if np.abs(R @ R.T - np.eye(3)).max() > 1e-3 or abs(np.linalg.det(R) - 1) > 1e-3:
        fail(f"{name}: rotation block is not a rotation")
    adds = metrics.adds_err(pose, gt, mesh.vertices)
    add = metrics.add_err(pose, gt, mesh.vertices)
    if adds > ADDS_GATE * diameter:
        FAILURES.append(f"{name}: ADD-S {adds * 1000:.2f} mm exceeds {ADDS_GATE:.0%} "
                        f"of the diameter ({diameter * 1000:.1f} mm)")
    return {"adds_mm": adds * 1000, "adds_of_diameter": adds / diameter,
            "add_mm": add * 1000, "add_of_diameter": add / diameter}


def reset_launches(raster_cuda):
    for k in raster_cuda.LAUNCHES:
        raster_cuda.LAUNCHES[k] = 0


def expect_launches(raster_cuda, before, n, what):
    """Both kernels must have been launched ``n`` times since ``before``."""
    got = {k: n_now - before[k] for k, n_now in raster_cuda.LAUNCHES.items()}
    if any(v != n for v in got.values()):
        fail(f"{what} launched {got}, expected {n} of each kernel")
    return got


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(1)
    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")

    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.core import metrics
    from foundationpose_tpu_torch.ops import raster, raster_cuda

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ---- build every kernel of the path from the sources in this checkout
    # (one compiler process per source, side by side)
    t0 = time.perf_counter()
    raster_cuda.build()
    sources = {k: os.path.relpath(src, os.path.dirname(os.path.abspath(__file__)))
               for k, (src, _) in raster_cuda.SOURCES.items()}
    say("build", kernels=sources, seconds=time.perf_counter() - t0,
        nvcc_seconds=raster_cuda.BUILD_SECONDS,
        ptxas={k: [l for l in log.splitlines() if "registers" in l or "spill" in l]
               for k, log in raster_cuda.BUILD_LOG.items()})

    scene = demo.make_scene((480, 640), device="cuda")
    k1 = check_kernels(scene, torch)

    # ---- main path: register, then track, launches counted from zero
    est = demo.build_estimator(scene["mesh"], device="cuda")
    frames_in = list(demo.motion_frames(scene, TRACK_FRAMES))  # rendered up front
    n_hyp = int(est.rot_grid.shape[0])
    if n_hyp != 252 or est.refiner.cfg.input_size != S:
        fail(f"main path is not at full width: {n_hyp} hypotheses, "
             f"{est.refiner.cfg.input_size} px")
    reg_args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    reset_launches(raster_cuda)
    zero = dict(raster_cuda.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    pose, first_ms = timed(torch, lambda: est.register(*reg_args))
    reg_launches = expect_launches(raster_cuda, zero, 11, "register (5 + 2 + 2 + 2 render calls)")
    reg_err = check_pose("register", pose, scene["gt"], scene["mesh"], est.diameter, metrics)

    frames = []
    for f, (gt_f, rgb_f, depth_f) in enumerate(frames_in):
        before = dict(raster_cuda.LAUNCHES)
        pose_f, ms = timed(torch, lambda: est.track_one(rgb_f, depth_f, scene["K"]))
        n = expect_launches(raster_cuda, before, 4, f"track frame {f} (2 + 2 render calls)")
        err = check_pose(f"track frame {f}", pose_f, gt_f, scene["mesh"], est.diameter, metrics)
        frames.append({"frame": f, "ms": ms, "launches": n, **err})
    main_path_launches = dict(raster_cuda.LAUNCHES)  # read just after the main path
    expect_launches(raster_cuda, zero, 11 + 4 * TRACK_FRAMES, "main path")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # warm repeat of register, for timing only (not part of the launch count)
    pose2, warm_ms = timed(torch, lambda: est.register(*reg_args))
    check_pose("register (warm repeat)", pose2, scene["gt"], scene["mesh"], est.diameter, metrics)

    say("register", hypotheses=n_hyp, hypotheses_padded_to=n_hyp + (-n_hyp) % 32, crop_px=S,
        net_dtype=est.refiner.cfg.dtype,
        iterations="5 + 2 polish on top 8", first_call_ms=first_ms, warm_ms=warm_ms,
        hyp_per_s_warm=n_hyp / (warm_ms / 1e3), launches=reg_launches,
        render_faces=int(est.mesh_tensors["faces"].shape[0]),
        diameter_mm=est.diameter * 1000, peak_memory_gib=peak_gb,
        note="wall time incl. Python overhead of the eager loop", card=smi, **reg_err)
    say("track", frames=frames, hypotheses=est.cfg.track_hypotheses,
        iterations=est.cfg.track_iterations, gate_px=est.cfg.track_gate_px,
        precrop_px=est.cfg.track_crop_size,
        median_ms=float(np.median([fr["ms"] for fr in frames])), card=smi)

    # ---- the same register on a mesh of the size users load: the textured
    # 20480-face sphere of the kernel cases, rendered into the demo scene and
    # decimated by the estimator to its 4096-face cap. For time and launch
    # counts only: a sphere's pose is ambiguous up to what its texture tells,
    # so no accuracy gate applies.
    big = kernel_cases(scene["mesh"])[2][1]
    big_rgb, big_depth, big_mask = demo.render_frame(
        raster.make_mesh_tensors(big, device="cuda"), scene["gt"], scene["K"], scene["hw"])
    est_big = demo.build_estimator(big, device="cuda")
    big_args = (scene["K"], big_rgb, big_depth, big_mask)
    before = dict(raster_cuda.LAUNCHES)
    pose_big, big_first_ms = timed(torch, lambda: est_big.register(*big_args))
    big_launches = expect_launches(raster_cuda, before, 11, "register on the 4096-face mesh")
    pose_big2, big_warm_ms = timed(torch, lambda: est_big.register(*big_args))
    for p_ in (pose_big, pose_big2):
        if p_.shape != (4, 4) or not np.isfinite(p_).all():
            fail("register on the 4096-face mesh: pose is not a finite (4,4) matrix")
    say("register_4096_faces", hypotheses=int(est_big.rot_grid.shape[0]), crop_px=S,
        mesh_faces=int(len(big.faces)),
        render_faces=int(est_big.mesh_tensors["faces"].shape[0]),
        textured="tex" in est_big.mesh_tensors, backface_cull=est_big.refiner.cfg.backface_cull,
        first_call_ms=big_first_ms, warm_ms=big_warm_ms, launches=big_launches,
        translation_err_mm=float(np.linalg.norm(pose_big[:3, 3] - scene["gt"][:3, 3]) * 1000),
        note="time and launch counts only; no accuracy gate (a textured sphere's pose "
             "is ambiguous)", card=smi)

    if FAILURES:
        fail("; ".join(FAILURES))
    total_s = time.perf_counter() - t_start
    say("total", seconds=total_s)
    print(smi, flush=True)
    main_row = k1["curve"][0]  # the demo mesh, refine-path call: the main path's
    by_bucket = [{k: c[k] for k in ("case", "shape", "ms", "K1s_ms", "K1r_ms", "K1s_device_ms",
                                    "K1r_device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "pixel_face_tests")}
                 | {"K1s_bound_ms": c["K1s_bound"]["bound_ms"],
                    "K1r_bound_ms": c["K1r_bound"]["bound_ms"]}
                 for c in k1["curve"]]
    common = {"route": "cuda", "library_ms": None, "shape": main_row["shape"], "card": smi,
              "launches_per_register": 11, "launches_per_track_one": 4}
    kernels = [{
        "name": "K1s face setup and tile binning",
        "source": sources["K1s"],
        "replaces": "foundationpose_tpu/ops/raster_pallas.py:337",
        "launches": main_path_launches["K1s"],
        "max_abs_err": k1["setup_worst"]["vtab_max_abs_err"], "worst": k1["setup_worst"],
        "tolerance": SETUP_GATE,
        "ms": main_row["K1s_ms"], "device_ms": main_row["K1s_device_ms"],
        "plain_ms": main_row["K1s_plain_ms"],
        "bound_ms": main_row["K1s_bound"]["bound_ms"],
        "bound_by": main_row["K1s_bound"]["bound_by"], **common,
    }, {
        "name": "K1r crop rasterizer",
        "source": sources["K1r"],
        "replaces": "foundationpose_tpu/ops/raster_pallas.py:71",
        "launches": main_path_launches["K1r"],
        "max_abs_err": max(k1["worst_abs_err"].values()), "worst_abs_err": k1["worst_abs_err"],
        "worst_abs_err_incl_winner_flips": k1["worst_abs_err_incl_winner_flips"],
        "max_winner_flips_of_common": k1["max_winner_flips_of_common"],
        "tolerance": COMPARE_GATE,
        "ms": main_row["K1r_ms"], "device_ms": main_row["K1r_device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["K1r_bound"]["bound_ms"],
        "bound_by": main_row["K1r_bound"]["bound_by"],
        "call_ms": main_row["ms"], "call_bound_ms": main_row["bound_ms"],
        "call_bound_by": main_row["bound_by"], "by_face_bucket": by_bucket, **common,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
