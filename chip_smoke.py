#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's serving paths through the entry points a user calls, each
at full width (252 hypotheses padded to 256, 160 px crops, 480x640 frames,
bf16 nets from the shipped object-agnostic checkpoint where a net runs):

- learned-hybrid ``register`` then ``track_one`` (the first main path), and
  the same ``register`` on a textured mesh at the 4096-face cap;
- ``register`` with the funnel schedule (top 64 after one coarse iteration at
  112 px), once more with a decimated coarse mesh on the 4096-face object;
- geometric mode (projective ICP + geometric score, no weights): ``register``
  with the ``run_pose`` schedule, then ``track_one``;
- ``MultiObjectTracker.track`` on four objects, each in its own stream;
- streaming ``track_one(sync=False)``, held against ``sync=True`` and run
  under ``torch.cuda.set_sync_debug_mode("error")``.

It builds every CUDA kernel of those paths (K1s: face setup and tile binning,
K1r: the crop rasterizer) from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and counts each
kernel's launches on every path from zero. Imports only
``foundationpose_tpu_torch``. Every phase prints one JSON line; any failed
phase exits non-zero. Without a CUDA device it exits 1 and prints no result.

Times are wall times around work that ends in ``torch.cuda.synchronize()``
(or CUDA events for the kernel table) and include the Python overhead of an
eager loop; a kernel's ``ms`` is taken with CUDA events around its wrapper
(allocations and launch included), its ``device_ms`` from the profiler's
kernel records. Every number belongs to the card named in the ``device`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
# Geometric mode lands closer on the demo scene: the JAX package, on the CPU,
# reaches 0.7 % of the diameter at register and at most 1.5 % over the tracked
# frames (tests/test_torch_smoke_scene.py, the geometric case), so its gate is
# twice that.
ADDS_GATE_GEOMETRIC = 0.03
TRACK_FRAMES = 5
S = 160                # crop size of the main path
FAILURES = []          # accuracy gates that failed; reported after the phase lines
PER_CALL = {}          # entry-point call -> launch counts read around one such call in this run


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


def k1_bounds(raster_cuda, mt, poses, K, tfs, scratch, out, size=S):
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
    tests = raster_cuda.tile_face_tests(rec, size, size)
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
    extra = {"pixel_face_tests": tests, "pixel_face_tests_untiled": B * size * size * F,
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
    # ---- the shapes the funnel adds: all 256 hypotheses at the 112 px coarse
    # size (7 x 7 tiles), and the 64 survivors at 160 px — the refine call and the call with
    # normals — on the demo mesh and on the 4096-face textured one
    p256, p64 = batches["B256"], batches["B256"][:64].contiguous()
    for name, mt, diameter in (meshes[0], meshes[2]):
        extra.append((f"{name}_B256_112px", mt, p256,
                      geo.compute_crop_window_tf_batch(p256, K, 1.2, diameter, (112, 112)),
                      (112, 112)))
        extra.append((f"{name}_B64_160px", mt, p64,
                      geo.compute_crop_window_tf_batch(p64, K, 1.2, diameter, (S, S)), (S, S)))
    for name, mt, poses, tfs, hw in extra:
        funnel_shape = name.endswith(("_112px", "_160px"))
        for cull in ((True,) if funnel_shape else (False, True)):
            tag = {"case": name, "batch": f"B{poses.shape[0]}", "cull": cull}
            srow, scratch = compare_setup(raster, raster_cuda, torch, mt, poses, K, tfs, cull, tag, hw)
            setup_rows.append(srow)
            for with_normal in ((False, True) if funnel_shape else (True,)):
                kw = dict(out_hw=hw, backface_cull=cull, with_normal=with_normal)
                rows.append(compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw,
                                               {**tag, "with_normal": with_normal}, scratch))
    worst = {key: max(r[f"{key}_max_abs_err"] for r in rows if f"{key}_max_abs_err" in r)
             for key, _ in COMPARE_TOL}
    worst_flips = {key: max(r[f"{key}_max_abs_err_incl_flips"] for r in rows
                            if f"{key}_max_abs_err" in r) for key, _ in COMPARE_TOL}
    setup_keys = ("vtab_max_abs_err", "bbox_px_max_abs_err", "invz_max_rel_err",
                  "coeff_max_rel_err", "validity_flags_differ")
    setup_worst = {k: max(r[k] for r in setup_rows) for k in setup_keys}
    setup_worst["min_bins_agree"] = min(r["bins_agree"] for r in setup_rows)

    # ---- times, culled: at B=256, 160 px the refine path's call (no normals)
    # and the geometric score's / the ICP's (with normals), one entry per face
    # bucket — the first mesh (the demo's) is the main path's —, then the
    # funnel's shapes on the demo mesh and the 4096-face one
    def time_call(name, mt, diameter, poses, size, with_normal):
        tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, (size, size))
        hw = (size, size)
        kw = dict(out_hw=hw, backface_cull=True, with_normal=with_normal)
        setup_fn = lambda: raster_cuda.setup_cuda(mt, poses, K, tfs, hw, backface_cull=True)
        plain_setup_fn = lambda: raster_cuda.tile_bins(
            raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=True)["rec"], *hw)
        scratch = setup_fn()
        plain_fn = lambda: raster.render_crops(mt, poses, K, tfs, **kw)
        call_fn = lambda: raster_cuda.render_crops(mt, poses, K, tfs, **kw)
        raster_fn = lambda: raster_cuda.rasterize_cuda(mt, scratch, hw, True, 0.8, 0.5, with_normal)
        # in turns: plain, kernels, kernels, plain
        p1 = event_ms(plain_fn, 1)
        c1 = event_ms(call_fn, 30)
        c2 = event_ms(call_fn, 30)
        p2 = event_ms(plain_fn, 1)
        bounds = k1_bounds(raster_cuda, mt, poses, K, tfs, scratch, call_fn(), size)
        dev_ms = device_ms(call_fn, 20, ("setup_kernel", "raster_kernel"))
        return {
            "case": name, "with_normal": with_normal,
            "shape": f"B{poses.shape[0]} x {size}x{size} px, {mt['faces'].shape[0]}-face bucket, "
                     "culled, " + ("with normals" if with_normal else "no normals"),
            "ms": min(c1, c2), "ms_runs": [c1, c2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "K1s_ms": event_ms(setup_fn, 50), "K1r_ms": event_ms(raster_fn, 50),
            "K1s_device_ms": dev_ms["setup_kernel"], "K1r_device_ms": dev_ms["raster_kernel"],
            "K1s_plain_ms": event_ms(plain_setup_fn, 3),
            **bounds["call"],
            "K1s_bound": bounds["K1s"], "K1r_bound": bounds["K1r"],
        }

    curve = [time_call(name, mt, diameter, p256, S, with_normal)
             for name, mt, diameter in meshes for with_normal in (False, True)]
    funnel_curve = [time_call(name, mt, diameter, poses, size, with_normal)
                    for name, mt, diameter in (meshes[0], meshes[2])
                    for poses, size, with_normal in ((p256, 112, False), (p64, S, False),
                                                     (p64, S, True))]
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
        times_B256=curve, times_funnel_shapes=funnel_curve)
    return {"worst_abs_err": worst, "worst_abs_err_incl_winner_flips": worst_flips,
            "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
            "setup_worst": setup_worst, "curve": curve, "funnel_curve": funnel_curve}


def check_pose(name, pose, gt, mesh, diameter, metrics, gate=ADDS_GATE):
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        fail(f"{name}: pose is not a finite (4,4) matrix")
    R = pose[:3, :3]
    if np.abs(R @ R.T - np.eye(3)).max() > 1e-3 or abs(np.linalg.det(R) - 1) > 1e-3:
        fail(f"{name}: rotation block is not a rotation")
    adds = metrics.adds_err(pose, gt, mesh.vertices)
    add = metrics.add_err(pose, gt, mesh.vertices)
    if adds > gate * diameter:
        FAILURES.append(f"{name}: ADD-S {adds * 1000:.2f} mm exceeds {gate:.0%} "
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


def drive_counted(raster_cuda, torch, fn, n, what):
    """Run ``fn`` with both kernels' launch counts set to 0 just before and
    read just after; both must then stand at ``n``. Returns (result, ms, counts)."""
    reset_launches(raster_cuda)
    out, ms = timed(torch, fn)
    counts = expect_launches(raster_cuda, dict.fromkeys(raster_cuda.LAUNCHES, 0), n, what)
    PER_CALL[re.sub(r" frame \d+", "", what)] = counts
    return out, ms, counts


def add_counts(total, counts, times=1):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v * times
    return total


def run_funnel(torch, demo, metrics, raster_cuda, scene, big, big_args, full_warm_ms,
               big_full_warm_ms, smi):
    """``register`` with the documented funnel on the demo scene (gated like
    the full schedule), then with a decimated coarse mesh on the 4096-face
    textured object (time and launches only, as for its full schedule)."""
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig

    funnel = dict(funnel_top_k=64, funnel_coarse_iterations=1, funnel_coarse_size=112)
    reg_args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    est = demo.build_estimator(scene["mesh"], device="cuda", config=EstimatorConfig(**funnel))
    # 1 coarse refine + 2 for the coarse hybrid score, 4 fine + 2, 2 polish + 2
    what = "funnel register (1 + 2 coarse, 4 + 2 fine, 2 + 2 polish render calls)"
    pose, first_ms, counts = drive_counted(
        raster_cuda, torch, lambda: est.register(*reg_args), 13, what)
    err = check_pose("register_funnel", pose, scene["gt"], scene["mesh"], est.diameter, metrics)
    pose2, warm_ms = timed(torch, lambda: est.register(*reg_args))
    check_pose("register_funnel (warm repeat)", pose2, scene["gt"], scene["mesh"],
               est.diameter, metrics)
    total = add_counts({}, counts)

    est_big = demo.build_estimator(
        big, device="cuda", config=EstimatorConfig(funnel_coarse_faces=1024, **funnel))
    f_full = int(est_big.mesh_tensors["faces"].shape[0])
    f_coarse = int(est_big.mesh_tensors_coarse["faces"].shape[0])
    if not f_coarse < f_full:
        fail(f"funnel_coarse_faces gave no smaller mesh: {f_coarse} vs {f_full} faces")
    pose_big, big_first_ms, big_counts = drive_counted(
        raster_cuda, torch, lambda: est_big.register(*big_args), 13, what + ", 4096-face mesh")
    pose_big2, big_warm_ms = timed(torch, lambda: est_big.register(*big_args))
    for p_ in (pose_big, pose_big2):
        if p_.shape != (4, 4) or not np.isfinite(p_).all():
            fail("funnel register on the 4096-face mesh: pose is not a finite (4,4) matrix")
    add_counts(total, big_counts)
    say("register_funnel", config=funnel, hypotheses=int(est.rot_grid.shape[0]), crop_px=S,
        first_call_ms=first_ms, warm_ms=warm_ms, full_schedule_warm_ms=full_warm_ms,
        launches=counts, **err,
        mesh_4096={"funnel_coarse_faces": 1024, "render_faces": f_full,
                   "coarse_render_faces": f_coarse, "first_call_ms": big_first_ms,
                   "warm_ms": big_warm_ms, "full_schedule_warm_ms": big_full_warm_ms,
                   "launches": big_counts,
                   "translation_err_mm": float(
                       np.linalg.norm(pose_big[:3, 3] - scene["gt"][:3, 3]) * 1000)},
        note="first call and warm repeat beside the full schedule's warm time of this run",
        card=smi)
    return total


def run_geometric(torch, demo, metrics, raster_cuda, scene, frames_in, smi):
    """Geometric mode with the ``run_pose`` schedule: ``register`` (10 ICP
    iterations, 8 more on the top 8), then the tracked frames. Every ICP
    iteration and every score renders with normals."""
    est = demo.build_estimator(scene["mesh"], device="cuda", mode="geometric")
    if (est.cfg.register_iterations, est.cfg.final_refine_iterations) != (10, 8) \
            or est.refiner.cfg.input_size != S or int(est.rot_grid.shape[0]) != 252:
        fail("geometric path is not at the run_pose schedule and full width")
    reg_args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    pose, first_ms, counts = drive_counted(
        raster_cuda, torch, lambda: est.register(*reg_args), 20,
        "geometric register (10 + 1 + 8 + 1 render calls)")
    err = check_pose("register_geometric", pose, scene["gt"], scene["mesh"], est.diameter,
                     metrics, ADDS_GATE_GEOMETRIC)
    chain = est.pose_last.copy()
    pose2, warm_ms = timed(torch, lambda: est.register(*reg_args))
    check_pose("register_geometric (warm repeat)", pose2, scene["gt"], scene["mesh"],
               est.diameter, metrics, ADDS_GATE_GEOMETRIC)
    say("register_geometric", hypotheses=252, crop_px=S, iterations="10 + 8 on top 8",
        first_call_ms=first_ms, warm_ms=warm_ms, launches=counts, **err,
        adds_gate_of_diameter=ADDS_GATE_GEOMETRIC, card=smi)
    total = add_counts({}, counts)
    est.pose_last = chain
    frames = []
    for f, (gt_f, rgb_f, depth_f) in enumerate(frames_in):
        pose_f, ms, n = drive_counted(
            raster_cuda, torch, lambda: est.track_one(rgb_f, depth_f, scene["K"]), 3,
            f"geometric track frame {f} (2 + 1 render calls)")
        err_f = check_pose(f"track_geometric frame {f}", pose_f, gt_f, scene["mesh"],
                           est.diameter, metrics, ADDS_GATE_GEOMETRIC)
        frames.append({"frame": f, "ms": ms, "launches": n, **err_f})
        add_counts(total, n)
    say("track_geometric", frames=frames, hypotheses=est.cfg.track_hypotheses,
        iterations=est.cfg.track_iterations,
        median_ms=float(np.median([fr["ms"] for fr in frames])), card=smi)
    return total


@contextlib.contextmanager
def plain_rasterizer(raster, raster_cuda):
    """While active, a render call on CUDA tensors runs the plain PyTorch
    rasterizer on the card instead of launching K1s and K1r. Only this script
    uses it, to hold a whole path against the same path without the kernels."""
    def plain_call(mt, poses, K, tfs, out_hw, use_light, w_ambient, w_diffuse, light_dir,
                   backface_cull, with_normal, with_tri=False):
        out = raster.render_crops(mt, poses, K, tfs, out_hw=out_hw, use_light=use_light,
                                  with_normal=with_normal, w_ambient=w_ambient,
                                  w_diffuse=w_diffuse, light_dir=light_dir,
                                  backface_cull=backface_cull)
        if not with_tri:
            out.pop("tri")
        return out

    kernel_call = raster_cuda.render_crops_cuda
    raster_cuda.render_crops_cuda = plain_call
    try:
        yield
    finally:
        raster_cuda.render_crops_cuda = kernel_call


def compare_multi_shapes(torch, raster, raster_cuda, tracker, meshes, names, Ks):
    """K1s and K1r against their plain versions at the shape the tracker gives
    them: one pose, 160 px, each object's own unbucketed mesh (12 to <= 4096
    faces, face counts that are no multiple of 32, textures baked to vertex
    colours), the crop window of the tracker's start pose. Then the smallest
    object once more from its slice of the stacked layout (faces padded to the
    largest count with zero-area triangles on vertex 0): K1s must mark every
    pad face invalid, and the render must not change."""
    from foundationpose_tpu_torch.core import geometry as geo
    from foundationpose_tpu_torch.engine.multi import stack_mesh_tensors

    cfg = tracker.refiner.cfg
    cull = cfg.backface_cull
    rows = []

    def compare(name, mt, o):
        pose = torch.tensor(tracker.poses[o:o + 1], device="cuda")
        K = torch.tensor(Ks[o], dtype=torch.float32, device="cuda")
        tfs = geo.compute_crop_window_tf_batch(pose, K, cfg.crop_ratio,
                                               float(tracker.diameters[o]), (S, S))
        tag = {"case": f"multi_object {name}", "batch": "B1", "cull": cull}
        srow, scratch = compare_setup(raster, raster_cuda, torch, mt, pose, K, tfs, cull, tag)
        for with_normal in (False, True):
            kw = dict(out_hw=(S, S), backface_cull=cull, with_normal=with_normal)
            rows.append(compare_with_plain(raster, raster_cuda, torch, mt, pose, K, tfs, kw,
                                           {**tag, "with_normal": with_normal}, scratch))
        out = raster_cuda.rasterize_cuda(mt, scratch, (S, S), True, 0.8, 0.5, False)
        return srow, out

    own = [compare(name, tracker.mesh_tensors[o], o) for o, name in enumerate(names)]
    small = min(range(len(names)), key=lambda o: tracker.mesh_tensors[o]["faces"].shape[0])
    stacked, _, _ = stack_mesh_tensors(meshes, device="cuda")
    padded = {k: v[small].contiguous() for k, v in stacked.items()}
    prow, pout = compare(f"{names[small]} padded to the stacked layout", padded, small)
    srow, sout = own[small]
    if prow["valid_faces"] != srow["valid_faces"] or prow["faces"] <= srow["faces"]:
        fail(f"K1s kept degenerate pad faces: {prow['valid_faces']} valid of {prow['faces']} "
             f"padded, {srow['valid_faces']} of {srow['faces']} unpadded")
    for key in ("mask", "depth", "xyz", "rgb"):
        if not torch.equal(pout[key], sout[key]):
            fail(f"the pad faces of the stacked layout changed the render's {key}")
    return {"n_cases": len(rows),
            "faces": [int(m["faces"].shape[0]) for m in tracker.mesh_tensors],
            "padded_case": {"faces": prow["faces"], "valid_faces": prow["valid_faces"],
                            "unpadded_faces": srow["faces"],
                            "unpadded_valid_faces": srow["valid_faces"],
                            "render": "bit-equal to the unpadded mesh's"},
            "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
            "min_mask_agree": min(r["mask_agree"] for r in rows),
            "worst_abs_err": {key: max(r[f"{key}_max_abs_err"] for r in rows
                                       if f"{key}_max_abs_err" in r) for key, _ in COMPARE_TOL}}


MULTI_POSES_T = ([0.01, -0.02, 0.55], [-0.05, 0.03, 0.60], [0.06, 0.02, 0.50], [0.0, 0.0, 0.65])
MULTI_PERTURB_T = (0.006, -0.005, 0.008)   # metres
MULTI_PERTURB_W = (0.04, -0.05, 0.03)      # axis-angle, rad (~4 degrees)


def run_multi(torch, demo, metrics, raster, raster_cuda, scene, smi):
    """Four objects, each rendered into its own 480x640 stream at a known
    pose; the tracker starts from poses perturbed by ~11 mm and ~4 degrees
    and takes one step of two refine iterations with the shipped RefineNet.
    Each iteration launches each kernel once per object."""
    from foundationpose_tpu_torch.core import geometry as geo, meshio
    from foundationpose_tpu_torch.engine.multi import MultiObjectTracker, stack_mesh_tensors
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner
    from foundationpose_tpu_torch.models.agnostic import load_agnostic

    box = meshio.make_box((0.10, 0.07, 0.05))
    box.vertex_colors = np.clip(128 + 1500 * box.vertices, 0, 255).astype(np.uint8)
    cases = kernel_cases(scene["mesh"])
    meshes = [scene["mesh"], box, cases[1][1], cases[2][1]]
    names = ["demo_lshape", "box", "icosphere_1280_vcol", "textured_20480_baked_cap_4096"]
    gts = np.tile(scene["gt"][None], (4, 1, 1))
    gts[:, :3, 3] = MULTI_POSES_T
    rgbs, depths = [], []
    for mesh, gt in zip(meshes, gts):
        rgb, depth, _ = demo.render_frame(
            raster.make_mesh_tensors(mesh, device="cuda"), gt, scene["K"], scene["hw"])
        rgbs.append(rgb)
        depths.append(depth)
    rgbs, depths = np.stack(rgbs), np.stack(depths)
    Ks = np.stack([scene["K"]] * 4)
    start = gts.copy()
    start[:, :3, 3] += MULTI_PERTURB_T
    dR = geo.so3_exp_map(np.float32([MULTI_PERTURB_W]))[0].numpy().astype(np.float64)
    start[:, :3, :3] = dR @ start[:, :3, :3]

    refiner, _, _ = load_agnostic(demo.default_weights_dir(), device="cuda")
    tracker = MultiObjectTracker(meshes, refiner=refiner, device="cuda")
    if tracker.refiner.cfg.input_size != S \
            or not 2048 < max(m["faces"].shape[0] for m in tracker.mesh_tensors) <= 4096:
        fail("multi-object path is not at full width")
    tracker.set_poses(start)
    shapes = compare_multi_shapes(torch, raster, raster_cuda, tracker, meshes, names, Ks)
    out, first_ms, counts = drive_counted(
        raster_cuda, torch, lambda: tracker.track(rgbs, depths, Ks, iteration=2), 8,
        "multi-object step (4 objects x 2 iterations)")
    tracker.set_poses(start)
    out2, warm_ms = timed(torch, lambda: tracker.track(rgbs, depths, Ks, iteration=2))
    # ---- the same step on the card through the plain rasterizer: no launch,
    # same poses. Held with float32 nets (the shipped weights): a bf16 net turns
    # a last-bit difference of a rendered pixel into up to one bf16 step of its
    # output (0.4 % of the 20 degree rotation scale is 1.4e-3 rad), which says
    # nothing about the rasterizer; the bf16 step's difference is printed.
    def pose_diff(a, b):
        tr = np.einsum("nij,nij->n", a[:, :3, :3], b[:, :3, :3])
        return (float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()),
                float(np.arccos(np.clip((tr - 1) / 2, -1, 1)).max()))

    def step(trk, plain):
        trk.set_poses(start)
        if not plain:
            return trk.track(rgbs, depths, Ks, iteration=2)
        before = dict(raster_cuda.LAUNCHES)
        with plain_rasterizer(raster, raster_cuda):
            poses = trk.track(rgbs, depths, Ks, iteration=2)
        expect_launches(raster_cuda, before, 0, "multi-object step through the plain rasterizer")
        return poses

    # the step's time once more from the slices of the stacked layout (every
    # object padded to the largest vertex and face count), beside the unpadded one
    stacked, _, _ = stack_mesh_tensors(meshes, device="cuda")
    own = tracker.mesh_tensors
    tracker.mesh_tensors = [{k: v[o].contiguous() for k, v in stacked.items()} for o in range(4)]
    step(tracker, plain=False)
    tracker.set_poses(start)
    out_padded, padded_ms = timed(torch, lambda: tracker.track(rgbs, depths, Ks, iteration=2))
    tracker.mesh_tensors = own
    tracker.set_poses(start)
    _, warm2_ms = timed(torch, lambda: tracker.track(rgbs, depths, Ks, iteration=2))
    if not np.allclose(out_padded, out, atol=1e-5):
        FAILURES.append("multi_object: the stacked layout's pad faces changed the poses")

    refiner32 = PoseRefiner(dataclasses.replace(refiner.cfg, dtype="float32"), device="cuda")
    refiner32.net.load_state_dict(refiner.net.state_dict())
    tracker32 = MultiObjectTracker(meshes, refiner=refiner32, device="cuda")
    d_t, d_r = pose_diff(step(tracker32, plain=False), step(tracker32, plain=True))
    d_t_bf16, d_r_bf16 = pose_diff(out, step(tracker, plain=True))
    if d_t > 1e-4 or d_r > 1e-3:
        FAILURES.append(f"multi_object: the step differs from the same step through the plain "
                        f"rasterizer by {d_t:.3g} m / {d_r:.3g} rad (1e-4 m / 1e-3 rad)")
    objects = []
    for i, (name, mesh) in enumerate(zip(names, meshes)):
        diameter = float(tracker.diameters[i])
        before = metrics.adds_err(start[i], gts[i], mesh.vertices)
        after = check_pose(f"multi_object {name}", out[i], gts[i], mesh, diameter, metrics)
        if after["adds_mm"] > before * 1000:
            FAILURES.append(f"multi_object {name}: ADD-S {after['adds_mm']:.2f} mm after "
                            f"tracking, {before * 1000:.2f} mm before")
        if not np.allclose(out[i], out2[i], atol=1e-5):
            FAILURES.append(f"multi_object {name}: two steps from the same poses differ")
        objects.append({"object": name, "faces": int(len(mesh.faces)),
                        "diameter_mm": diameter * 1000, "adds_mm_before": before * 1000,
                        "adds_mm_after": after["adds_mm"],
                        "adds_of_diameter_after": after["adds_of_diameter"]})
    say("multi_object", objects=objects, iteration=2, crop_px=S,
        first_call_ms=first_ms, warm_ms=warm_ms, launches=counts,
        warm_ms_runs=[warm_ms, warm2_ms], warm_ms_stacked_layout=padded_ms,
        kernels_at_this_shape=shapes,
        against_plain_rasterizer={"max_translation_diff_m": d_t, "max_rotation_diff_rad": d_r,
                                  "gate": "1e-4 m / 1e-3 rad, float32 RefineNet on both sides",
                                  "bf16_nets_max_translation_diff_m": d_t_bf16,
                                  "bf16_nets_max_rotation_diff_rad": d_r_bf16},
        gate="per object: ADD-S after the step <= before it and <= 10 % of the diameter",
        card=smi)
    return add_counts({}, counts)


def run_streaming(torch, metrics, raster_cuda, est, chain, scene, frames_in, smi):
    """The tracked frames through ``track_one(sync=False)`` from the
    registered pose, against the same frames through ``sync=True``. The
    streaming calls run under ``set_sync_debug_mode("error")``: any
    synchronisation hidden under ``track_one`` raises. Sync debug mode does
    not see every synchronising call, so the proof is made a second way: the
    profiler's record of the CUDA runtime calls made under two more
    ``sync=False`` frames must hold no synchronise and no blocking copy. Two
    more pairs of frames are enqueued behind a backlog of matrix products, to
    measure how far the host runs ahead of the card — the second pair under
    the profiler, whose durations of the launch calls show what holds the
    host. All of them must give the poses of the ``sync=True`` run."""
    K = scene["K"]

    def run(sync):
        est.pose_last = chain
        reset_launches(raster_cuda)
        host_ms, outs = [], []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for _, rgb_f, depth_f in frames_in:
            t0 = time.perf_counter()
            outs.append(est.track_one(rgb_f, depth_f, K, sync=sync))
            host_ms.append((time.perf_counter() - t0) * 1e3)
        return outs, host_ms, t_all

    run(True)  # warm: caches, allocator
    synced, sync_ms, t_all = run(True)
    last_synced = est.pose_last.copy()
    sync_total_ms = (time.perf_counter() - t_all) * 1e3
    sync_counts = expect_launches(raster_cuda, dict.fromkeys(raster_cuda.LAUNCHES, 0),
                                  4 * len(frames_in), "tracking, sync=True")

    before_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        streamed, enqueue_ms, t_all = run(False)
        enqueued_ms = (time.perf_counter() - t_all) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(before_mode)
    last_streamed = est.pose_last.copy()  # waits for the chain
    stream_total_ms = (time.perf_counter() - t_all) * 1e3
    counts = expect_launches(raster_cuda, dict.fromkeys(raster_cuda.LAUNCHES, 0),
                             4 * len(frames_in), "tracking, sync=False")
    # ---- the same proof from the profiler's record of CUDA runtime calls made
    # while two more frames are enqueued: none may be a synchronise or a
    # blocking copy (the profiler sees every runtime call, whoever makes it)
    from torch.profiler import ProfilerActivity, profile, record_function

    def profiled_frames(backlog_products):
        """Two ``sync=False`` frames under the profiler, behind that many
        queued matrix products. Returns the poses, host ms, the CUDA runtime
        calls made under the frames (name -> count) and the host time spent
        inside the launch calls."""
        est.pose_last = chain
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(backlog_products):
                big_m @ big_m
            t0 = time.perf_counter()
            with record_function("streaming_calls"):
                poses = [est.track_one(rgb_f, depth_f, K, sync=False)
                         for _, rgb_f, depth_f in frames_in[:2]]
            host_ms = (time.perf_counter() - t0) * 1e3
        events = list(prof.events())
        span = next(e for e in events if e.name == "streaming_calls").time_range
        calls, launch_us = {}, []
        for e in events:
            if e.name.startswith("cuda") and span.start <= e.time_range.start <= span.end:
                calls[e.name] = calls.get(e.name, 0) + 1
                if e.name.startswith("cudaLaunchKernel"):
                    launch_us.append(e.time_range.end - e.time_range.start)
        if not launch_us:
            fail("track_streaming: the profiler recorded no cudaLaunchKernel under the calls")
        launch_us = np.asarray(launch_us, np.float64)
        in_launch = {"host_ms_under_profiler": host_ms, "launch_calls": int(launch_us.size),
                     "ms_inside_launch_calls": float(launch_us.sum() / 1e3),
                     "median_us": float(np.median(launch_us)),
                     "longest_ms": float(launch_us.max() / 1e3),
                     "calls_over_1_ms": int((launch_us > 1e3).sum())}
        return poses, calls, in_launch

    big_m = torch.randn(8192, 8192, device="cuda")
    one_ms = event_ms(lambda: big_m @ big_m, 3)
    n_backlog = int(np.ceil(8 * np.median(enqueue_ms) / one_ms))
    profiled, runtime_calls, launch_quiet = profiled_frames(0)
    blocking = {k: v for k, v in runtime_calls.items()
                if "Synchronize" in k or k in ("cudaMemcpy", "cudaMemcpy2D", "cudaFree")}
    if blocking:
        FAILURES.append(f"track_streaming: blocking CUDA runtime calls under sync=False: {blocking}")

    # ---- behind a backlog of matrix products (a measurement, not a gate): how
    # far ahead of the card the host gets. No call under track_one waits for the
    # card, but the CUDA runtime queues only so many launches ahead, and a frame
    # of this eager code is ~2500: once the queue is full a launch call returns
    # only when the card has taken work off it. Measured twice: plainly, and
    # under the profiler, whose record of the launch calls' durations shows
    # where the host's time went (on an H100: nearly all of it inside about as
    # many launch calls as products queued, each as long as one product).
    est.pose_last = chain
    torch.cuda.synchronize()
    for _ in range(n_backlog):
        big_m @ big_m
    backlog_done = torch.cuda.Event()
    backlog_done.record()
    t0 = time.perf_counter()
    behind = [est.track_one(rgb_f, depth_f, K, sync=False) for _, rgb_f, depth_f in frames_in[:2]]
    behind_ms = (time.perf_counter() - t0) * 1e3
    returned_early = not backlog_done.query()
    behind_profiled, _, launch_backlog = profiled_frames(n_backlog)
    streamed_all = streamed + profiled + behind + behind_profiled
    synced_all = synced + synced[:2] * 3
    worst = 0.0
    for f, (a, b) in enumerate(zip(streamed_all, synced_all)):
        if not (isinstance(a, torch.Tensor) and a.is_cuda and a.shape == (4, 4)):
            fail(f"track_streaming frame {f}: sync=False did not return a (4,4) CUDA tensor")
        worst = max(worst, float(np.abs(a.cpu().numpy().astype(np.float64) - b).max()))
    worst = max(worst, float(np.abs(last_streamed - last_synced).max()))
    if worst > 1e-5:
        FAILURES.append(f"track_streaming: sync=False differs from sync=True by {worst:.3g}")
    err = check_pose("track_streaming last frame", streamed[-1].cpu().numpy().astype(np.float64),
                     frames_in[-1][0], scene["mesh"], est.diameter, metrics)
    say("track_streaming", frames=len(frames_in), max_abs_diff_to_sync=worst, atol=1e-5,
        sync_debug_mode="error during the sync=False calls: no hidden synchronisation",
        cuda_runtime_calls_under_two_streaming_frames=runtime_calls,
        blocking_runtime_calls=blocking,
        backlog={"products_queued": n_backlog, "ms_each": one_ms,
                 "backlog_ms": n_backlog * one_ms, "frames_enqueued": 2,
                 "host_ms": behind_ms, "returned_before_backlog_finished": returned_early,
                 "launch_calls_behind_backlog": launch_backlog,
                 "launch_calls_on_idle_card": launch_quiet,
                 "note": "not a gate: no call waits for the card, but with thousands of "
                         "launches per frame the host runs ahead only as far as the CUDA "
                         "runtime queues launches; the host time inside the launch calls, "
                         "behind the backlog against on an idle card, shows it"},
        host_ms_to_enqueue_a_frame=enqueue_ms, host_ms_per_frame_sync=sync_ms,
        median_enqueue_ms=float(np.median(enqueue_ms)),
        median_sync_ms=float(np.median(sync_ms)),
        all_frames_enqueued_ms=enqueued_ms, all_frames_landed_ms_streaming=stream_total_ms,
        all_frames_landed_ms_sync=sync_total_ms, launches=counts, launches_sync=sync_counts,
        **err, card=smi)
    return add_counts({}, counts)


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
    PER_CALL["register (5 + 2 + 2 + 2 render calls)"] = reg_launches
    reg_err = check_pose("register", pose, scene["gt"], scene["mesh"], est.diameter, metrics)
    reg_chain = est.pose_last.copy()  # centred-mesh pose the streaming phase restarts from

    frames = []
    for f, (gt_f, rgb_f, depth_f) in enumerate(frames_in):
        before = dict(raster_cuda.LAUNCHES)
        pose_f, ms = timed(torch, lambda: est.track_one(rgb_f, depth_f, scene["K"]))
        n = expect_launches(raster_cuda, before, 4, f"track frame {f} (2 + 2 render calls)")
        PER_CALL["track_one (2 + 2 render calls)"] = n
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

    # ---- the other serving paths, each with the launch counts set to 0 just
    # before it and read just after
    by_path = {"learned_hybrid register + track_one": main_path_launches,
               "register on the 4096-face mesh": big_launches}
    by_path["funnel register (demo mesh + 4096-face mesh with coarse LOD)"] = run_funnel(
        torch, demo, metrics, raster_cuda, scene, big, big_args, warm_ms, big_warm_ms, smi)
    by_path["geometric register + track_one"] = run_geometric(
        torch, demo, metrics, raster_cuda, scene, frames_in, smi)
    by_path["MultiObjectTracker.track, 4 objects"] = run_multi(
        torch, demo, metrics, raster, raster_cuda, scene, smi)
    by_path["streaming track_one(sync=False)"] = run_streaming(
        torch, metrics, raster_cuda, est, reg_chain, scene, frames_in, smi)
    all_launches = {}
    for counts in by_path.values():
        add_counts(all_launches, counts)

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
                 for c in k1["curve"] + k1["funnel_curve"]]
    common = {"route": "cuda", "library_ms": None, "shape": main_row["shape"], "card": smi}
    kernels = [{
        "name": "K1s face setup and tile binning",
        "source": sources["K1s"],
        "replaces": "foundationpose_tpu/ops/raster_pallas.py:337",
        "launches": all_launches["K1s"],
        "launches_by_path": {k: v["K1s"] for k, v in by_path.items()},
        "launches_per_call": {k: v["K1s"] for k, v in PER_CALL.items()},
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
        "launches": all_launches["K1r"],
        "launches_by_path": {k: v["K1r"] for k, v in by_path.items()},
        "launches_per_call": {k: v["K1r"] for k, v in PER_CALL.items()},
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
