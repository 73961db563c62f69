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
  under ``torch.cuda.set_sync_debug_mode("error")``;
- the accuracy harness over the ``evalsuite`` scenes (four scenes, depth cut
  to two register trials and ten tracked frames, geometric and
  learned_hybrid, every schedule), its renders held against the plain
  rasterizer on the card;
- the I/O entry points on trees it writes with the port's PNG writer:
  ``eval_bop`` on a BOP tree, ``run_track`` (streamed and synchronous) on a
  YCBInEOAT tree, ``run_pose`` at its defaults and at ``--debug 3``, and the
  depth-only auto-mask, with cv2 and PIL blocked where they are installed;
- the training stack (160 px, refine batch 32, score batch 16, float32 nets,
  depth cut to an 8-mesh corpus and 100 + 100 steps): one step of each net
  held against the same step through the plain rasterizer, both corpus
  trainers (3 + 3 launches per step, falling losses), a cut run resumed from
  its snapshot, the saved checkpoint serving a learned-hybrid ``register``,
  and the harness's per-scene training fallback;
- the neural object field through ``run_field.main`` at ``FieldConfig()``
  widths (2048 rays x (128 + 128) samples, triplane encoder, 3 mm mesh, 1024
  texture, ``FIELD_N_STEP`` steps) on 60 frames of the demo
  L-shape it renders and writes: SDF signs and the mesh against the true
  surface, K1s + K1r at the texture bake's shape (with the winning faces and
  barycentrics) against their plain versions, the true mesh baked and
  re-rendered, and the rays/s of the triplane and hash encoders;
- the online model-free tracker at ``OnlineConfig()`` on an orbit of the
  L-shape rendered through K1 (``init``, a ``step`` per frame up to the first
  retrain, drift gated), pose-graph BA on its keyframes' perturbed true
  poses, and ``finalize`` with a texture bake; K1s + K1r held at the
  tracker's B = 1 x 160 px shape;
- two ranks on the card over gloo, each sharded program of the port against
  the same program unsharded: ``register`` (its hypotheses, its row-sharded
  preprocess and its scorer split), ``bundle_adjust``, the data-parallel
  refiner step (160 px, global batch 32), the field step (``FieldConfig()``,
  rays split; triplane and hash), the 4-object tracker split 2 + 2, K1s + K1r
  at every rank's shard shapes, and a scaling table (register hyp/s, field
  rays/s at world 1 and 2); then the same ranks over nccl (expected to be
  refused: two ranks on one device). This checks the collectives' code path,
  not NCCL and not more than one card (``md_cards`` runs the phase over nccl
  with one rank per card);
- ``surface``: ``demo_synthetic --out-dir`` with one tracked frame, its seven
  artefacts held against the scene it renders; K1s and K1r timed part by
  part (``apps/profile_raster.py``) at the 4096-face textured crop and the
  main path's, each part held against the full kernel; and the check that
  every path launched the default build of both kernels, no part's library.

It builds every CUDA kernel of those paths (K1s: face setup and tile binning,
K1r: the crop rasterizer) from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card — also at 480x640, B = 1,
on every mesh of the evaluation suite, and at the training shapes (B = 32 and
16 x 160 px, 2048-face corpus meshes, lit, unculled, no normals) and at the
bake's (views x 480x640, unlit, unculled, tri + bary) —, and counts each kernel's launches
on every path from zero. Imports only
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
import shutil
import subprocess
import sys
import time

import numpy as np

from foundationpose_tpu_torch.utils.profiling import device_ms, event_ms, nvidia_smi_line

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


def kernel_cases(scene_mesh):
    """(name, mesh, max_faces) of the meshes the kernels are checked on."""
    from foundationpose_tpu_torch.apps.profile_raster import coloured_sphere, textured_sphere

    return [
        ("demo_lshape", scene_mesh, None),
        ("icosphere_1280_vcol", coloured_sphere(3, 0.06), None),
        ("textured_cap_4096", textured_sphere(), 4096),
    ]


COMPARE_TOL = (("depth", 1e-4), ("xyz", 1e-4), ("rgb", 1e-3), ("normal", 1e-3))
COMPARE_GATE = (
    "mask equal on >=0.999 of pixels; on common pixels depth/xyz <=1e-4 m and rgb/normal "
    "<=1e-3 for >=0.999 of them, and for EVERY common pixel on which both picked the same "
    "face (textured rgb, now final colour out of the kernel: 1e-2 there, because the "
    "texture's gradient — steepest on the atlas seam — multiplies a ~1e-6 difference in the "
    "interpolated uv). Both sides are float32; the camera-space vertices differ in the "
    "summation order of a 3x3 product, which can flip the winner between two faces that "
    "share an edge, where their scores tie to an ulp. Winner flips are gated by value: a "
    "flip whose depth and xyz agree within the tolerance is such a tie; flips with "
    "differing values <= 0.1 % of common pixels (the raw share is printed beside it). "
    "Barycentrics, where asked for, within 1e-5 on same-winner pixels and 0 on background. "
    "No pixel is excused, except at the texture bake's shape (marching tetrahedra's faces "
    "of ~1e-3 px, whose float32 barycentric coefficients are noise): there a disagreement "
    "is excused only where every winner holds its pixel by its true (float64) barycentrics "
    "or by its float32 coefficients evaluated exactly, and one of them only by the latter; "
    "excused pixels <= 15 % of the frame, and on >= 0.999 of those where the kernel "
    "misses or its winner truly holds the pixel it agrees with the plain render of the mesh "
    "without the view's noise faces"
)
BARY_TOL = 1e-5  # K1r's barycentrics against the plain version's, same-winner pixels
EXCUSE_CAP = 0.15  # share of the bake's frame coefficient noise may excuse (H100: <= 0.076)
NOISE_SUM = 0.5    # a face's coefficients are noise when its barycentrics sum to 1 +- this
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


def compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw, tag, scratch,
                       excuse_cap=0.0):
    """One render call (K1r on the scratch K1s just made) against the plain
    version on the same tensors. Returns the row of figures; exits on a
    disagreement or on a winner lost to binning. ``kw`` may also ask for the
    unlit call (``use_light``) and the barycentrics (``with_bary``, gated at
    BARY_TOL on same-winner pixels).

    Winner flips are gated by what they produce: a flip whose depth and xyz
    agree within COMPARE_TOL is a shared-edge tie (both faces give the same
    point); flips whose values differ are gated at 0.1 % of common pixels.
    The raw count is reported beside it.

    ``excuse_cap`` > 0 (the texture bake's shape) lets that share of the
    pixels be excused as float32 coefficient noise (``coefficient_noise``);
    at 0 (every other shape) no pixel is excused."""
    use_light, with_bary = kw.get("use_light", True), kw.get("with_bary", False)
    a = raster_cuda.rasterize_cuda(mt, scratch, kw["out_hw"], use_light, 0.8, 0.5,
                                   kw["with_normal"], with_tri=True, with_bary=with_bary)
    torch.cuda.synchronize()
    a["tri"] = a["tri"].long()
    ref = raster.render_crops(mt, poses, K, tfs, **kw)
    torch.cuda.synchronize()
    both = a["mask"] & ref["mask"]
    same = both & (a["tri"] == ref["tri"])
    tol = dict(COMPARE_TOL)
    tie = ((a["depth"] - ref["depth"]).abs() <= tol["depth"]) \
        & ((a["xyz"] - ref["xyz"]).abs().amax(dim=-1) <= tol["xyz"])
    # the plain render's winning face of a pixel must be in the kernel's bins
    # of that pixel's tile
    B, F = poses.shape[0], mt["faces"].shape[0]
    H, W = kw["out_hw"]
    ys, xs = torch.meshgrid(torch.arange(H, device=poses.device),
                            torch.arange(W, device=poses.device), indexing="ij")
    tile_of_pixel = ((ys // raster_cuda.TILE) * -(-W // raster_cuda.TILE)
                     + xs // raster_cuda.TILE).reshape(-1)
    tri = ref["tri"].reshape(B, -1).clamp_min(0)
    bins = scratch["bins"]
    words = bins.reshape(B, -1).gather(1, tile_of_pixel[None] * bins.shape[2] + tri // 32)
    binned = ((words >> (tri % 32).int()) & 1).bool().reshape(B, H, W)
    lost = ~binned & ref["mask"]
    cand = (a["mask"] != ref["mask"]) | (both & ~same) | lost
    excused, noise_row = torch.zeros_like(cand), {}
    if excuse_cap > 0:
        excused, noise_row = coefficient_noise(raster, torch, mt, poses, K, tfs, kw, a, ref,
                                               cand)
    n_excused = int(excused.sum().item())
    agree = ((a["mask"] == ref["mask"]) | excused).float().mean().item()
    n_lost = int((lost & ~excused).sum().item())
    value_flips = int((both & ~same & ~tie & ~excused).sum().item())
    n_common = max(both.sum().item(), 1)
    row = {**tag, "faces": F, "mask_agree": agree,
           "mask_agree_raw": (a["mask"] == ref["mask"]).float().mean().item(),
           "covered": both.float().mean().item(), "winners_lost_to_binning": n_lost,
           "winners_lost_to_binning_raw": int(lost.sum().item()),
           "excused_px": n_excused, "excused_share": n_excused / excused.numel(),
           "excuse_cap": excuse_cap, **noise_row,
           "winner_flips_of_common": 1.0 - same.sum().item() / n_common,
           "winner_flips_with_differing_values_of_common": value_flips / n_common}
    ok = (agree >= 0.999 and bool(same.any()) and row["excused_share"] <= excuse_cap
          and row["winner_flips_with_differing_values_of_common"] <= 1e-3 and n_lost == 0
          and noise_row.get("excused_agree_without_noise_faces", 1.0) >= 0.999)
    both = both & ~excused
    if with_bary:
        d = (a["bary"] - ref["bary"]).abs().amax(dim=-1)
        row["bary_max_abs_err"] = d[same].max().item()
        row["bary_zero_on_background"] = bool((a["bary"][~a["mask"]] == 0).all().item())
        ok = ok and row["bary_max_abs_err"] <= BARY_TOL and row["bary_zero_on_background"]
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


def coefficient_noise(raster, torch, mt, poses, K, tfs, kw, a, ref, cand):
    """Of the disagreeing pixels ``cand`` (B,H,W) of the kernel's render ``a``
    and the plain one ``ref``, those that float32 coefficient noise explains.

    Both sides test a pixel against a face with the same float32 barycentric
    coefficients (K1s's equal the plain version's, ``compare_setup``). For a
    face of ~1e-3 px their constant terms cancel products of ~1e5 px^2 over
    |det| ~ 1e-8 px^2, so its three barycentrics sum to ~1e5, not 1, and it
    "holds" pixels far outside itself, each side where it looks (the plain
    version everywhere, K1r in the face's tiles) and with scores that
    differ in rounding. A winner is explained when it holds its pixel by its
    true barycentrics (float64 from the float32 vertices, ``inside_f64``) or
    by its float32 coefficients evaluated exactly (with the rounding of
    their float32 evaluation as slack); it is noise when only the latter
    holds. A pixel is excused when every side that hits it is explained and
    one of them is noise. A winner that neither test explains — a loose edge
    test, a face that does not cover the pixel — is never excused. On the
    excused pixels where the kernel misses or its winner truly holds the
    pixel, it is held against the plain render of the mesh without the
    view's noise faces (barycentrics summing to 1 +- NOISE_SUM or worse at
    the face's centroid): mask equal, depth and xyz within COMPARE_TOL."""
    excused = torch.zeros_like(cand)
    row = {"noise_faces_per_view": [], "excused_noise_winners": {"plain": 0, "kernel": 0}}
    if not cand.any():
        return excused, row
    s = raster.face_setup(mt, poses, K, tfs, backface_cull=kw["backface_cull"])
    coeff = s["coeff"].double()  # (B,F,3,3): rows px / py / 1, a column per corner
    B = poses.shape[0]
    b_of = torch.arange(B, device=poses.device)[:, None, None].expand_as(cand)
    eps = float(torch.finfo(torch.float32).eps)

    def judge(r):
        """(hit, truly holds, noise) of side ``r`` on the pixels ``cand``."""
        hit = cand & r["mask"]
        true_in, noise = torch.zeros_like(cand), torch.zeros_like(cand)
        true_in[hit] = inside_f64(torch, mt, poses, K, tfs, r["tri"], hit)
        b, y, x = torch.nonzero(hit, as_tuple=True)
        c = coeff[b, r["tri"][b, y, x]]  # (P,3,3)
        terms = torch.stack([c[:, 0] * x.double()[:, None], c[:, 1] * y.double()[:, None],
                             c[:, 2]], dim=1)  # (P,3 terms,3 corners)
        slack = 4 * eps * terms.abs().sum(dim=1)
        noise[hit] = (terms.sum(dim=1) >= -1e-6 - slack).all(dim=-1) & ~true_in[hit]
        return hit, true_in, noise

    hit_p, true_p, noise_p = judge(ref)
    hit_k, true_k, noise_k = judge(a)
    excused = (cand & (noise_p | noise_k) & (~hit_p | true_p | noise_p)
               & (~hit_k | true_k | noise_k))
    row["excused_noise_winners"] = {"plain": int((excused & noise_p).sum().item()),
                                    "kernel": int((excused & noise_k).sum().item())}
    g = s["tri_xy"].double().mean(dim=-2)  # (B,F,2) centroids
    total = coeff[..., 0, :].sum(-1) * g[..., 0] + coeff[..., 1, :].sum(-1) * g[..., 1] \
        + coeff[..., 2, :].sum(-1)
    noise_face = ((total - 1).abs() > NOISE_SUM) & s["valid"]
    row["noise_faces_per_view"] = noise_face.sum(dim=1).tolist()
    check = excused & (~hit_k | true_k)
    if check.any():
        tol, agree = dict(COMPARE_TOL), []
        for b in range(B):
            if not check[b].any():
                continue
            faces = mt["faces"].clone()
            faces[noise_face[b]] = 0  # zero faces have zero area and never win
            c = raster.render_crops(dict(mt, faces=faces), poses[b:b + 1], K, tfs[b:b + 1],
                                    **kw)
            m, hit = check[b], a["mask"][b][check[b]]
            dz = (a["depth"][b] - c["depth"][0]).abs()[m]
            dxyz = (a["xyz"][b] - c["xyz"][0]).abs().amax(dim=-1)[m]
            agree.append((c["mask"][0][m] == hit)
                         & (~hit | ((dz <= tol["depth"]) & (dxyz <= tol["xyz"]))))
        row["excused_agree_without_noise_faces"] = torch.cat(agree).float().mean().item()
        row["excused_checked_without_noise_faces"] = int(check.sum().item())
    return excused, row


def inside_f64(torch, mt, poses, K, tfs, tri, sel):
    """For the pixels ``sel`` (B,H,W) bool: does face ``tri`` (B,H,W) hold the
    pixel when its barycentrics are computed in float64 from the same float32
    inputs (the plain version's test, w >= -1e-6 on all three)?"""
    b, y, x = torch.nonzero(sel, as_tuple=True)
    f = tri[b, y, x].long()
    v = mt["pos"].double()[mt["faces"].long()[f]]  # (P,3,3)
    P = poses.double()[b]
    cam = v @ P[:, :3, :3].transpose(1, 2) + P[:, None, :3, 3]
    uvw = cam @ K.double().T
    uv = uvw[..., :2] / uvw[..., 2:3]
    T = tfs.double()[b]
    xy = uv @ T[:, :2, :2].transpose(1, 2) + T[:, None, :2, 2]
    px, py = x.double()[:, None], y.double()[:, None]
    ex, ey = xy[..., 0] - px, xy[..., 1] - py  # corners relative to the pixel
    det = ((xy[:, 1, 0] - xy[:, 0, 0]) * (xy[:, 2, 1] - xy[:, 0, 1])
           - (xy[:, 1, 1] - xy[:, 0, 1]) * (xy[:, 2, 0] - xy[:, 0, 0]))
    w = torch.stack([ex[:, k1] * ey[:, k2] - ex[:, k2] * ey[:, k1]
                     for k1, k2 in ((1, 2), (2, 0), (0, 1))], dim=-1) / det[:, None]
    return (w >= -1e-6).all(dim=-1)


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


def time_render(raster, raster_cuda, torch, name, mt, poses, K, tfs, hw, with_normal, cull=True,
                use_light=True, with_tri_bary=False, plain_twice=True):
    """One render call's times beside its bounds: the call (both wrappers, CUDA
    events), each kernel alone (events round its wrapper, and the profiler's
    device time) and the plain versions, in turns plain, kernels, kernels,
    plain (the second plain turn left out when ``plain_twice`` is false: a
    plain call at the bake's shape takes seconds). ``with_tri_bary``: the
    texture bake's call (winning faces and barycentrics written too)."""
    from foundationpose_tpu_torch.ops.raster_bounds import k1_bounds

    kw = dict(out_hw=hw, backface_cull=cull, with_normal=with_normal, use_light=use_light)
    call_kw = dict(kw, with_tri=with_tri_bary, with_bary=with_tri_bary)
    setup_fn = lambda: raster_cuda.setup_cuda(mt, poses, K, tfs, hw, backface_cull=cull)
    plain_setup_fn = lambda: raster_cuda.tile_bins(
        raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=cull)["rec"], *hw)
    scratch = setup_fn()
    plain_fn = lambda: raster.render_crops(mt, poses, K, tfs, with_bary=with_tri_bary, **kw)
    call_fn = lambda: raster_cuda.render_crops(mt, poses, K, tfs, **call_kw)
    raster_fn = lambda: raster_cuda.rasterize_cuda(mt, scratch, hw, use_light, 0.8, 0.5,
                                                   with_normal, with_tri_bary, with_tri_bary)
    p1 = event_ms(plain_fn, 1)
    c1 = event_ms(call_fn, 30)
    c2 = event_ms(call_fn, 30)
    p2 = event_ms(plain_fn, 1) if plain_twice else p1
    bounds = k1_bounds(mt, poses, K, tfs, scratch, call_fn(), hw)
    dev_ms = device_ms(call_fn, 20, ("setup_kernel", "raster_kernel"))
    return {
        "case": name, "with_normal": with_normal,
        "shape": f"B{poses.shape[0]} x {hw[0]}x{hw[1]} px, {mt['faces'].shape[0]}-face bucket"
                 + (", textured" if "tex" in mt else "") + (", culled, " if cull else ", unculled, ")
                 + ("with normals" if with_normal else "no normals")
                 + ("" if use_light else ", unlit") + (", tri + bary" if with_tri_bary else ""),
        "ms": min(c1, c2), "ms_runs": [c1, c2],
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2] if plain_twice else [p1],
        "K1s_ms": event_ms(setup_fn, 50), "K1r_ms": event_ms(raster_fn, 50),
        "K1s_device_ms": dev_ms["setup_kernel"], "K1r_device_ms": dev_ms["raster_kernel"],
        "K1s_plain_ms": event_ms(plain_setup_fn, 3),
        **bounds["call"],
        "K1s_bound": bounds["K1s"], "K1r_bound": bounds["K1r"],
    }


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
        return time_render(raster, raster_cuda, torch, name, mt, poses, K, tfs, (size, size),
                           with_normal)

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
    """Both kernels must have been launched ``n`` times since ``before``
    (``n=None``: as often as each other, and at least once)."""
    got = {k: n_now - before[k] for k, n_now in raster_cuda.LAUNCHES.items()}
    if n is None:
        if len(set(got.values())) != 1 or min(got.values()) < 1:
            fail(f"{what} launched {got}, expected both kernels equally often, at least once")
    elif any(v != n for v in got.values()):
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
                   backface_cull, with_normal, with_tri=False, with_bary=False):
        out = raster.render_crops(mt, poses, K, tfs, out_hw=out_hw, use_light=use_light,
                                  with_normal=with_normal, w_ambient=w_ambient,
                                  w_diffuse=w_diffuse, light_dir=light_dir,
                                  backface_cull=backface_cull, with_bary=with_bary)
        tri = out.pop("tri")
        if with_tri:
            out["tri"] = tri.int()
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


def multi_inputs(demo, raster, scene):
    """The multi-object phase's four objects, each rendered into its own
    480x640 stream at a known pose, and the start poses ~11 mm and ~4 degrees
    off. Returns (meshes, names, true poses, rgbs, depths, Ks, start poses)."""
    from foundationpose_tpu_torch.core import geometry as geo, meshio

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
    start = gts.copy()
    start[:, :3, 3] += MULTI_PERTURB_T
    dR = geo.so3_exp_map(np.float32([MULTI_PERTURB_W]))[0].numpy().astype(np.float64)
    start[:, :3, :3] = dR @ start[:, :3, :3]
    return (meshes, names, gts, np.stack(rgbs), np.stack(depths), np.stack([scene["K"]] * 4),
            start)


def run_multi(torch, demo, metrics, raster, raster_cuda, scene, smi):
    """Four objects, each rendered into its own 480x640 stream at a known
    pose; the tracker starts from poses perturbed by ~11 mm and ~4 degrees
    and takes one step of two refine iterations with the shipped RefineNet.
    Each iteration launches each kernel once per object."""
    from foundationpose_tpu_torch.engine.multi import MultiObjectTracker, stack_mesh_tensors
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner
    from foundationpose_tpu_torch.models.agnostic import load_agnostic

    meshes, names, gts, rgbs, depths, Ks, start = multi_inputs(demo, raster, scene)
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


def centred_diameter(meshio, mesh):
    """The estimator's diameter: of the mesh centred on its bounding box."""
    b = mesh.bounds
    return meshio.compute_mesh_diameter(mesh=mesh.translated(-(b[0] + b[1]) / 2))


def check_suite_kernels(torch, raster, raster_cuda):
    """K1s and K1r against their plain versions at the shapes the evaluation
    suite gives them: every mesh ``build_suite()`` makes and every distractor,
    at the bucket ``SceneRenderer`` gives it, rendered into the 480x640 frame
    at B = 1 (the target at its first register pose, a distractor at its static
    pose), unculled with normals as ``SceneRenderer`` renders. Then one timed
    call per face bucket, vertex-coloured and textured. Returns the rows."""
    from foundationpose_tpu_torch.evalsuite import scenes

    dev = torch.device("cuda")
    K = torch.tensor(scenes.K_DEFAULT, dtype=torch.float32, device=dev)
    hw = tuple(scenes.HW_DEFAULT)
    eye = torch.eye(3, device=dev)[None]
    cases, seen = [], set()
    for spec in scenes.build_suite():
        r = scenes.SceneRenderer(spec, device=dev)
        cases.append((spec.name, r.mt, r.register_poses()[0]))
        for i, (mesh, pose) in enumerate(spec.distractors):
            if id(mesh) not in seen:
                seen.add(id(mesh))
                mt = raster.make_mesh_tensors(mesh, max_faces=4096, bucket=True, device=dev)
                cases.append((f"{spec.name} distractor {i}", mt, pose))
    rows, setup_rows, timed_rows, buckets = [], [], [], set()
    for name, mt, pose in cases:
        poses = torch.tensor(np.asarray(pose, np.float32)[None], device=dev)
        tag = {"case": f"suite {name}", "batch": "B1 x 480x640", "cull": False}
        srow, scratch = compare_setup(raster, raster_cuda, torch, mt, poses, K, eye, False, tag, hw)
        setup_rows.append(srow)
        kw = dict(out_hw=hw, backface_cull=False, with_normal=True)
        rows.append(compare_with_plain(raster, raster_cuda, torch, mt, poses, K, eye, kw,
                                       {**tag, "with_normal": True}, scratch))
        bucket = (int(mt["faces"].shape[0]), "tex" in mt)
        if bucket not in buckets:
            buckets.add(bucket)
            timed_rows.append(time_render(raster, raster_cuda, torch, f"suite {name}", mt, poses,
                                          K, eye, hw, True, cull=False))
    return {"n_cases": len(rows), "meshes": [c[0] for c in cases],
            "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
            "min_mask_agree": min(r["mask_agree"] for r in rows),
            "winners_lost_to_binning": sum(r["winners_lost_to_binning"] for r in rows),
            "worst_abs_err": {key: max(r[f"{key}_max_abs_err"] for r in rows)
                              for key, _ in COMPARE_TOL},
            "setup_worst": {k: max(r[k] for r in setup_rows)
                            for k in ("vtab_max_abs_err", "bbox_px_max_abs_err",
                                      "invz_max_rel_err", "coeff_max_rel_err",
                                      "validity_flags_differ")},
            "min_bins_agree": min(r["bins_agree"] for r in setup_rows),
            "times_full_frame": timed_rows}


EVAL_SCENES = ("box_gray", "compound_asym", "sphere_occluded", "compound_clutter")
# Scenes whose every register trial and tracked frame must land within
# ADDS_GATE of the diameter, per mode. Geometric mode misses box_gray and
# compound_asym in the JAX package's own record too (ACCURACY_r05.json, first
# two trials: 27.9 and 26.1 mm = 18 % and 10 % of the diameters; flat faces
# leave the ICP under-constrained), so it is gated on the scene of the four
# that record clears; both modes' trials are printed beside that record.
EVAL_GATED = {"geometric": ("sphere_occluded",), "learned_hybrid": ("box_gray", "compound_asym")}
EVAL_DEPTH = dict(n_register=2, n_track=10)


def run_evalsuite(torch, metrics, raster, raster_cuda, smi):
    """The accuracy suite on the card. (1) ``SceneRenderer.render`` through
    the kernels against the same render through the plain rasterizer on the
    card, every scene. (2) The harness at full width (480x640, 252 hypotheses,
    160 px, bf16 nets from weights/agnostic), depth cut to two register trials
    and ten tracked frames, on four scenes, in geometric and learned_hybrid
    mode with every schedule; gated on the two scenes every mode clears, and
    printed beside ``ACCURACY_r05.json``'s same trials (``EVAL_GATED`` says
    which scenes gate which mode)."""
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.evalsuite import harness, scenes

    renders = []
    for spec in scenes.build_suite():
        before = dict(raster_cuda.LAUNCHES)
        with plain_rasterizer(raster, raster_cuda):
            rp = scenes.SceneRenderer(spec, device="cuda")
            gt = rp.register_poses()[0]
            prgb, pdepth, pvis, _ = rp.render(gt)
        expect_launches(raster_cuda, before, 0, "SceneRenderer through the plain rasterizer")
        rgb, depth, vis, _ = scenes.SceneRenderer(spec, device="cuda").render(gt)
        same = vis == pvis
        row = {"scene": spec.name, "mask_agree": float(same.mean()),
               "mask_pixels_differ": int((~same).sum()),
               "depth_max_abs_err": float(np.abs(depth - pdepth)[same].max()),
               "rgb_max_abs_err": float(np.abs(rgb - prgb)[same].max())}
        renders.append(row)
        if row["mask_agree"] < 0.999 or row["depth_max_abs_err"] > 2e-3 or not vis.any():
            say("evalsuite", failed=row)
            fail(f"SceneRenderer on the card disagrees with the plain rasterizer: {row}")

    track_adds = []  # per _track_block call: {scene: [ADD-S of every frame]}
    real_block, real_adds, real_suite = harness._track_block, metrics.adds_err, scenes.build_suite

    def track_block(suite, *a, **kw):
        names = {id(sp.mesh.vertices): sp.name for sp in suite}
        frames = {}

        def adds(pred, gt, pts):
            v = real_adds(pred, gt, pts)
            frames.setdefault(names[id(pts)], []).append(v)
            return v

        metrics.adds_err = adds
        try:
            return real_block(suite, *a, **kw)
        finally:
            metrics.adds_err = real_adds
            track_adds.append(frames)

    harness._track_block = track_block
    scenes.build_suite = lambda quick=False: [dataclasses.replace(sp, **EVAL_DEPTH)
                                              for sp in real_suite(quick)]
    try:
        res, ms, counts = drive_counted(
            raster_cuda, torch, lambda: harness.run_accuracy(
                modes=("geometric", "learned_hybrid"), scene_names=EVAL_SCENES, device="cuda"),
            None, "evalsuite harness, 4 scenes x (geometric + learned_hybrid)")
    finally:
        harness._track_block, scenes.build_suite = real_block, real_suite
    specs = {sp.name: sp for sp in real_suite() if sp.name in EVAL_SCENES}
    diam = {n: centred_diameter(meshio, sp.mesh) for n, sp in specs.items()}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "ACCURACY_r05.json")) as f:
        r05 = json.load(f)["modes"]
    beside, worst = [], {}
    for m_i, mode in enumerate(("geometric", "learned_hybrid")):
        for sched, block in res["modes"][mode]["register"].items():
            for name, sc in block.get("scenes", {}).items():
                ref = r05[mode]["register"].get(sched, {}).get("scenes", {}).get(name, {})
                beside.append({"mode": mode, "schedule": sched, "scene": name,
                               "adds_mm": [a * 1000 for a in sc["adds"]],
                               "r05_adds_mm": [a * 1000 for a in ref.get("adds", [])[:2]]})
                if name in EVAL_GATED[mode]:
                    worst[f"{mode} register {sched} {name}"] = max(sc["adds"]) / diam[name]
        for name in EVAL_GATED[mode]:
            worst[f"{mode} track {name}"] = max(track_adds[m_i][name]) / diam[name]
        if any(len(track_adds[m_i][n]) != EVAL_DEPTH["n_track"] for n in EVAL_SCENES):
            fail(f"evalsuite: {mode} did not track {EVAL_DEPTH['n_track']} frames per scene")
    for k, v in worst.items():
        if v > ADDS_GATE:
            FAILURES.append(f"evalsuite {k}: ADD-S {v:.1%} of the diameter exceeds {ADDS_GATE:.0%}")
    track = {mode: {n: {"adds_mm": [a * 1000 for a in track_adds[i][n]],
                        "auc_adds": res["modes"][mode]["track"]["scenes"][n]["auc_adds"],
                        "ate_m": res["modes"][mode]["track"]["scenes"][n]["ate_m"],
                        "r05_auc_adds": r05[mode]["track"]["scenes"][n]["auc_adds"]}
                     for n in EVAL_SCENES}
             for i, mode in enumerate(("geometric", "learned_hybrid"))}
    say("evalsuite", device=res["meta"]["device"], renders_against_plain=renders,
        render_gate="mask equal on >= 0.999 of pixels (shared-edge ties), depth within 2e-3 m",
        harness={"scenes": list(EVAL_SCENES), "depth": EVAL_DEPTH, "wall_ms": ms,
                 "launches": counts,
                 "overall_auc_adds": {m: {k: v.get("overall_auc_adds")
                                          for k, v in res["modes"][m]["register"].items()}
                                      for m in res["modes"]}},
        worst_adds_of_diameter_gated=worst, gate=f"ADD-S <= {ADDS_GATE:.0%} of the diameter on "
        f"every register trial and tracked frame of {EVAL_GATED}",
        register_beside_r05=beside, track=track,
        r05_note="ACCURACY_r05.json: the JAX package on a TPU v5 lite before track gating "
                 "(559e301); not a gate", card=smi)
    return counts


def _render_scene(torch, raster_cuda, objects, K, hw, backdrop_z, backdrop_rgb=(96, 104, 112)):
    """Render [(mesh_tensors, pose)] on the card into one frame, z-composited
    over a flat backdrop. Returns rgb uint8, depth float32 (m), and per object
    its visible and its full mask."""
    H, W = hw
    rgb = np.empty((H, W, 3), np.uint8)
    rgb[:] = backdrop_rgb
    zbuf = np.full((H, W), np.float32(backdrop_z))
    full = []
    for mt, pose in objects:
        out = raster_cuda.render_full_frame(mt, torch.tensor(np.asarray(pose, np.float32)[None]),
                                            K, hw)
        d = out["depth"][0].cpu().numpy()
        m = out["mask"][0].cpu().numpy() & (d > 0)
        full.append((m, d))
        win = m & (d < zbuf)
        rgb[win] = (out["rgb"][0].cpu().numpy()[win] * 255).astype(np.uint8)
        zbuf[win] = d[win]
    visible = [m & (d <= zbuf) for m, d in full]
    return rgb, zbuf, [(v, m) for v, (m, _) in zip(visible, full)]


@contextlib.contextmanager
def without_modules(names):
    """Make ``import name`` (and its submodules) fail while active."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in names}
    for k in saved:
        del sys.modules[k]
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for k in [k for k in sys.modules if k.split(".")[0] in names]:
            del sys.modules[k]
        sys.modules.update(saved)


def run_io_apps(torch, demo, metrics, raster, raster_cuda, smi):
    """The I/O entry points on trees this script writes at 480x640 with the
    port's PNG writer and ``save_ply``, rendered on the card: a BOP tree (3
    frames, 2 instances, ``models_info.json``) through ``eval_bop`` in
    geometric mode with tracking; a YCBInEOAT tree (6 frames) through
    ``run_track`` streamed and synchronous; ``run_pose.main`` at its defaults
    and at ``--debug 3``; ``depth_box_fallback`` then ``register`` with its
    mask. Runs with cv2 and PIL blocked if either is installed."""
    import tempfile

    from foundationpose_tpu_torch.apps import eval_bop, run_pose, run_track
    from foundationpose_tpu_torch.core import geometry as geo, meshio
    from foundationpose_tpu_torch.detect.pipeline import depth_box_fallback
    from foundationpose_tpu_torch.evalsuite.scenes import HW_DEFAULT, K_DEFAULT
    from foundationpose_tpu_torch.io import png
    from foundationpose_tpu_torch.io.datareader import YcbineoatReader, get_bop_reader

    present = {n: subprocess.run([sys.executable, "-c", f"import {n}"], capture_output=True,
                                 timeout=120).returncode == 0 for n in ("cv2", "PIL")}
    K, hw = K_DEFAULT, tuple(HW_DEFAULT)
    target = demo.make_l_shape()
    other = meshio.make_box((0.07, 0.05, 0.04))
    other.vertex_colors = np.tile(np.array([[90, 140, 200]], np.uint8), (8, 1))
    mt_t = raster.make_mesh_tensors(target, device="cuda")
    mt_o = raster.make_mesh_tensors(other, device="cuda")
    gts = [demo.default_gt_pose()]
    dR = geo.so3_exp_map(np.array([demo.FRAME_DW]))[0].numpy().astype(np.float64)
    for _ in range(5):
        p = gts[-1].copy()
        p[:3, 3] += demo.FRAME_DT
        p[:3, :3] = dR @ p[:3, :3]
        gts.append(p)
    other_pose = np.eye(4)
    other_pose[:3, :3] = geo.euler_matrix(0.2, 0.5, -0.3)[:3, :3].numpy()
    other_pose[:3, 3] = [0.13, 0.09, 0.62]
    diameter = centred_diameter(meshio, target)
    paths, gate_rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp, \
            (without_modules(("cv2", "PIL")) if any(present.values()) else contextlib.nullcontext()):
        # ---- BOP tree: models in mm, depth png in mm (depth_scale 1)
        root = os.path.join(tmp, "bop", "ycbv")
        scene_dir = os.path.join(root, "test", "000048")
        models = os.path.join(root, "ycbv_models", "models")
        for sub in ("rgb", "depth", "mask_visib", "mask"):
            os.makedirs(os.path.join(scene_dir, sub))
        os.makedirs(models)
        info = {}
        for ob_id, mesh in ((1, target), (2, other)):
            mm = meshio.Mesh(mesh.vertices * 1000.0, mesh.faces, vertex_colors=mesh.vertex_colors)
            meshio.save_ply(os.path.join(models, f"obj_{ob_id:06d}.ply"), mm)
            info[str(ob_id)] = {"diameter": centred_diameter(meshio, mm)}
        for ob_id in range(3, 22):  # the reader reads an entry for every YCB-V id
            info[str(ob_id)] = info["1"]
        with open(os.path.join(models, "models_info.json"), "w") as f:
            json.dump(info, f)
        cam, scene_gt = {}, {}
        for i in range(3):
            rgb, depth, masks = _render_scene(torch, raster_cuda,
                                              [(mt_t, gts[i]), (mt_o, other_pose)], K, hw, 0.75)
            png.write_png(os.path.join(scene_dir, "rgb", f"{i:06d}.png"), rgb)
            png.write_png(os.path.join(scene_dir, "depth", f"{i:06d}.png"),
                          np.rint(depth * 1000).astype(np.uint16))
            for k, (vis, full) in enumerate(masks):
                png.write_png(os.path.join(scene_dir, "mask_visib", f"{i:06d}_{k:06d}.png"),
                              vis.astype(np.uint8) * 255)
                png.write_png(os.path.join(scene_dir, "mask", f"{i:06d}_{k:06d}.png"),
                              full.astype(np.uint8) * 255)
            cam[str(i)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
            scene_gt[str(i)] = [{"obj_id": ob, "cam_R_m2c": p[:3, :3].reshape(-1).tolist(),
                                 "cam_t_m2c": (p[:3, 3] * 1000).tolist()}
                                for ob, p in ((1, gts[i]), (2, other_pose))]
        for name, obj in (("scene_camera.json", cam), ("scene_gt.json", scene_gt)):
            with open(os.path.join(scene_dir, name), "w") as f:
                json.dump(obj, f)
        # ---- YCBInEOAT tree: one object over a backdrop at 2 m
        video = os.path.join(tmp, "bleach0")
        for sub in ("rgb", "depth", "masks", "annotated_poses"):
            os.makedirs(os.path.join(video, sub))
        np.savetxt(os.path.join(video, "cam_K.txt"), K)
        for i, gt in enumerate(gts):
            rgb, depth, [(vis, _)] = _render_scene(torch, raster_cuda, [(mt_t, gt)], K, hw, 2.0)
            png.write_png(os.path.join(video, "rgb", f"{i:04d}.png"), rgb)
            png.write_png(os.path.join(video, "depth", f"{i:04d}.png"),
                          np.rint(depth * 1000).astype(np.uint16))
            png.write_png(os.path.join(video, "masks", f"{i:04d}.png"), vis.astype(np.uint8) * 255)
            np.savetxt(os.path.join(video, "annotated_poses", f"{i:04d}.txt"), gt)
        meshio.save_ply(os.path.join(video, "mesh.ply"), target)
        with open(os.path.join(video, "cam.conf"), "w") as f:  # ZED conf format
            f.write(f"[LEFT_CAM_FHD1200]\nfx={K[0, 0]}\nfy={K[1, 1]}\n"
                    f"cx={K[0, 2]}\ncy={K[1, 2]}\n")

        # ---- eval_bop: register frame 0, track frames 1-2 (10 + 8 ICP, 3 per frame)
        summary, ms, counts = drive_counted(
            raster_cuda, torch, lambda: eval_bop.evaluate_scene(
                get_bop_reader(scene_dir), 1, mode="geometric", track=True, device="cuda"),
            20 + 3 * 2, "eval_bop.evaluate_scene (geometric, track)")
        paths["eval_bop.evaluate_scene geometric + track"] = counts
        if summary["n_frames"] != 3:
            fail(f"eval_bop scored {summary['n_frames']} of 3 frames")
        gate_rows["eval_bop"] = {"ms": ms, "launches": counts,
                                 "adds_mm": [fr["adds"] * 1000 for fr in summary["frames"]],
                                 "adds_auc": summary["adds_auc"]}
        for fr in summary["frames"]:
            if fr["adds"] > ADDS_GATE * diameter:
                FAILURES.append(f"eval_bop frame {fr['frame']}: ADD-S {fr['adds'] * 1000:.2f} mm")

        # ---- run_track, streamed and synchronous (10 + 8 ICP; 4 + 1 per frame)
        out = {}
        for stream in (True, False):
            (res, summ), ms, counts = drive_counted(
                raster_cuda, torch, lambda: run_track.track_video(
                    YcbineoatReader(video), mesh=target, mode="geometric", stream=stream,
                    device="cuda"),
                20 + 5 * 5, f"run_track.track_video stream={stream}")
            paths[f"run_track.track_video stream={stream}"] = counts
            out[stream] = res
            gate_rows[f"run_track stream={stream}"] = {
                "ms": ms, "launches": counts, "adds_mm": [r["adds"] * 1000 for r in res],
                "ate_rmse_m": summ["ate_rmse"], "track_fps": summ["track_fps"]}
            for r in res:
                if r["adds"] > ADDS_GATE * diameter:
                    FAILURES.append(f"run_track stream={stream} frame {r['i']}: ADD-S "
                                    f"{r['adds'] * 1000:.2f} mm")
        diff = max(float(np.abs(np.asarray(a["pose"]) - b["pose"]).max())
                   for a, b in zip(out[True], out[False]))
        gate_rows["run_track streamed vs sync max abs diff"] = diff
        if diff > 1e-6:
            FAILURES.append(f"run_track: streamed poses differ from synchronous ones by {diff:.3g}")

        # ---- run_pose: defaults (geometric, --debug 1), then --debug 3
        base = ["--rgb", os.path.join(video, "rgb", "0000.png"),
                "--depth", os.path.join(video, "depth", "0000.png"),
                "--intrinsics", os.path.join(video, "cam.conf"),
                "--mesh", os.path.join(video, "mesh.ply"),
                "--mask", os.path.join(video, "masks", "0000.png")]
        canvas = (5 * S + 4 * 5, 2 * S + 2, 3)
        for debug, n, files in (
                (None, 20, {"vis.png": hw + (3,), "vis_register.png": hw + (3,)}),
                (3, 20 + 1 + 2 * 10, {"vis.png": hw + (3,), "vis_register.png": hw + (3,),
                                      "vis_score_top.png": canvas,
                                      **{f"vis_refine_iter_{i:02d}.png": canvas
                                         for i in range(10)}})):
            d = os.path.join(tmp, f"pose_out_debug{debug or 1}")
            argv = base + ["--out-dir", d] + ([] if debug is None else ["--debug", str(debug)])
            pose, ms, counts = drive_counted(raster_cuda, torch, lambda: run_pose.main(argv), n,
                                             f"run_pose.main --debug {debug or 1}")
            paths[f"run_pose.main --debug {debug or 1}"] = counts
            err = check_pose(f"run_pose --debug {debug or 1}", pose, gts[0], target, diameter,
                             metrics)
            shapes = {}
            for fname, shape in files.items():
                path = os.path.join(d, fname)
                if not os.path.exists(path):
                    fail(f"run_pose --debug {debug or 1}: {fname} was not written")
                shapes[fname] = list(png.read_png(path).shape)
                if tuple(shapes[fname]) != shape:
                    fail(f"run_pose: {fname} decodes to {shapes[fname]}, expected {list(shape)}")
            gate_rows[f"run_pose --debug {debug or 1}"] = {"ms": ms, "launches": counts, **err,
                                                           "pngs": shapes}

        # ---- the depth-only auto-mask, then register with it
        reader = YcbineoatReader(video)
        depth1, rgb1 = reader.get_depth(1), reader.get_color(1)
        mask = depth_box_fallback(depth1)
        true = reader.get_mask(1) > 0
        iou = float((mask.astype(bool) & true).sum() / max((mask.astype(bool) | true).sum(), 1))
        est = demo.build_estimator(target, device="cuda", mode="geometric")
        pose, ms, counts = drive_counted(
            raster_cuda, torch, lambda: est.register(reader.K, rgb1, depth1, mask), 20,
            "depth_box_fallback mask -> geometric register")
        paths["depth_box_fallback + register"] = counts
        gate_rows["depth_box_fallback"] = {"iou_with_true_mask": iou, "ms": ms, "launches": counts,
                                           **check_pose("depth_box_fallback register", pose,
                                                        gts[1], target, diameter, metrics)}
        if iou < 0.9:
            FAILURES.append(f"depth_box_fallback: IoU {iou:.3f} with the true mask")
    say("io_apps", importable_on_this_machine=present,
        ran_with_cv2_and_pil_blocked=any(present.values()), frames_hw=list(hw),
        diameter_mm=diameter * 1000, results=gate_rows,
        gate=f"ADD-S <= {ADDS_GATE:.0%} of the diameter on every frame and pose; streamed = "
             "synchronous within 1e-6; every debug PNG written and of its shape", card=smi)
    total = {}
    for counts in paths.values():
        add_counts(total, counts)
    return total, paths


TRAIN_MESHES = 8      # corpus of the trainer (40 meshes), cut; both appearances present
TRAIN_STEPS = 100     # per net (the trainer's defaults: 20000 + 10000)
TRAIN_CHUNK = 25      # the trainer's default: one host read of the losses per chunk
TRAIN_BATCH = {"refiner": 32, "scorer": 16}  # train_agnostic --batch / --n-hyp
# One training step through the kernels against the same step through the
# plain rasterizer on the card, same draws and initial parameters: the
# batches' elements within the kernel gates (COMPARE_TOL; xyz normalised by
# the radius) on >= 0.999 of them, the targets equal, and the losses within
# this relative difference. Measured on an H100: 6.0e-8 (refiner) and 2.5e-7
# (scorer) — a winner flip moves a few of 819,200 pixels; the gate is 40x that.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_HARNESS = dict(scene_names=["box_gray"], learned_px=64, learned_steps=(40, 40))
TRAIN_HARNESS_DEPTH = dict(n_register=2, n_track=5)


def compare_train_batches(torch, a, b, radius):
    """Share of each batch tensor's elements within the kernel gates."""
    out = {}
    for key in ("A", "B"):
        d = (a[key] - b[key]).abs()
        out[f"{key}_rgb_within_tol"] = (d[..., :3] <= 1e-3).float().mean().item()
        out[f"{key}_xyz_within_tol"] = (d[..., 3:] <= 1e-4 / radius).float().mean().item()
        out[f"{key}_max_abs_err"] = d.max().item()
    for key in ("trans_gt", "rot_gt", "adds"):
        if key in a:
            out[f"{key}_equal"] = bool(torch.equal(a[key], b[key]))
    return out


def run_train(torch, raster, raster_cuda, scene, smi):
    """The training stack on the card at full width (160 px, refine batch 32,
    score batch 16, float32 nets, TF32 off), depth cut to an 8-mesh corpus
    and 100 + 100 steps: K1s + K1r held against their plain versions at the
    training shapes; one step of each net through the kernels against the
    same step through the plain rasterizer; both corpus trainers with their
    launches counted; a cut run resumed from its snapshot; the saved
    checkpoint serving a learned-hybrid ``register``; the harness's
    per-scene training fallback."""
    import tempfile

    from foundationpose_tpu_torch.apps.train_agnostic import K_TRAIN
    from foundationpose_tpu_torch.core import geometry as geo, metrics
    from foundationpose_tpu_torch.engine.estimator import FoundationPoseTorch
    from foundationpose_tpu_torch.engine.scorer import HybridScorer
    from foundationpose_tpu_torch.evalsuite import harness, scenes
    from foundationpose_tpu_torch.models import agnostic, convert, datagen, training
    from foundationpose_tpu_torch.models.refine_net import RefineNet
    from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

    prepped = agnostic.prepare_corpus(TRAIN_MESHES, seed=7, max_faces=2048, device="cuda")
    K = torch.tensor(K_TRAIN, dtype=torch.float32, device="cuda")
    faces = lambda p: int(p["mt"]["faces"].shape[0])  # noqa: E731
    picked = {"textured": max((p for p in prepped if p["textured"]), key=faces),
              "vertex-coloured": max((p for p in prepped if not p["textured"]), key=faces)}

    # ---- (1) the kernels at the training shapes: the hypotheses' crop
    # windows, the hypotheses and the ground truth rendered into them, lit,
    # no normals, unculled, as make_refine_batch / make_score_batch call them
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, setup_rows, timed_rows = [], [], []
    for kind, (ts, rs) in (("refiner", (0.02, 0.3490658503988659)), ("scorer", (0.04, 0.9))):
        B = TRAIN_BATCH[kind]
        for app, p in picked.items():
            gt = datagen.poses_from_draws(datagen.draw_poses(gen, B if kind == "refiner" else 1))
            gt = gt.expand(B, 4, 4).contiguous()
            hyp = datagen.perturb_from_draws(gt, datagen.draw_perturb(gen, B, ts, rs))
            tfs = geo.compute_crop_window_tf_batch(hyp, K, 1.2, p["diameter"], (S, S))
            for which, poses in (("hypotheses", hyp), ("ground truth", gt)):
                tag = {"case": f"train {kind} {app} {faces(p)}-face, {which}", "batch": f"B{B}",
                       "cull": False}
                srow, scratch = compare_setup(raster, raster_cuda, torch, p["mt"], poses, K, tfs,
                                              False, tag)
                setup_rows.append(srow)
                kw = dict(out_hw=(S, S), backface_cull=False, with_normal=False)
                rows.append(compare_with_plain(raster, raster_cuda, torch, p["mt"], poses, K, tfs,
                                               kw, {**tag, "with_normal": False}, scratch))
            timed_rows.append(time_render(raster, raster_cuda, torch, f"train {kind} {app}",
                                          p["mt"], hyp, K, tfs, (S, S), False, cull=False))
    kernels = {"n_cases": len(rows),
               "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
               "min_mask_agree": min(r["mask_agree"] for r in rows),
               "winners_lost_to_binning": sum(r["winners_lost_to_binning"] for r in rows),
               "worst_abs_err": {key: max(r[f"{key}_max_abs_err"] for r in rows)
                                 for key in ("depth", "xyz", "rgb")},
               "setup_worst": {k: max(r[k] for r in setup_rows)
                               for k in ("vtab_max_abs_err", "bbox_px_max_abs_err",
                                         "invz_max_rel_err", "coeff_max_rel_err",
                                         "validity_flags_differ")},
               "min_bins_agree": min(r["bins_agree"] for r in setup_rows)}

    # ---- (2) one step of each net through the kernels against the same step
    # through the plain rasterizer: same generator state, same parameters
    p = picked["textured"]
    diameter_t = torch.tensor(p["diameter"], dtype=torch.float32, device="cuda")

    def one_step(kind, plain):
        g = torch.Generator(device="cuda").manual_seed(1)
        if kind == "refiner":
            net = convert.flax_init(RefineNet(c_in=6), 0).cuda()
            data = datagen.make_refine_batch(g, p["mt"], K, p["diameter"], batch=32,
                                             input_size=S, augment=True)
            step = lambda: training.refiner_train_step_multimesh(  # noqa: E731
                net, agnostic.corpus_optimizer(net, 2e-4, TRAIN_STEPS), data, diameter_t)
        else:
            net = convert.flax_init(ScoreNetMultiPair(c_in=6, norm="group",
                                                      residual_attn=True), 0).cuda()
            data = datagen.make_score_batch(g, p["mt"], K, p["diameter"], p["pts"], n_hyp=16,
                                            input_size=S, augment=True)
            step = lambda: training.scorer_train_step(  # noqa: E731
                net, agnostic.corpus_optimizer(net, 5e-4, TRAIN_STEPS), data)
        return data, float(step())

    step_rows = {}
    for kind in ("refiner", "scorer"):
        data_k, loss_k = one_step(kind, plain=False)
        before = dict(raster_cuda.LAUNCHES)
        with plain_rasterizer(raster, raster_cuda):
            data_p, loss_p = one_step(kind, plain=True)
        expect_launches(raster_cuda, before, 0, f"{kind} step through the plain rasterizer")
        row = {"loss_kernels": loss_k, "loss_plain": loss_p,
               "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
               **compare_train_batches(torch, data_k, data_p, p["diameter"] / 2)}
        step_rows[kind] = row
        ok = (row["loss_rel_diff"] <= TRAIN_LOSS_RTOL and np.isfinite(loss_k)
              and all(v >= 0.999 for k, v in row.items() if k.endswith("_within_tol"))
              and all(v for k, v in row.items() if k.endswith("_equal")))
        if not ok:
            say("train", failed={kind: row})
            fail(f"{kind} step through the kernels disagrees with the plain step: {row}")

    # ---- (3) the corpus trainers, launches counted from zero: three render
    # calls per step (hypotheses, ground truth, the distractor)
    n = 3 * TRAIN_STEPS
    (net_r, stats_r), ms_r, counts_r = drive_counted(
        raster_cuda, torch, lambda: agnostic.train_agnostic_refiner(
            prepped, K_TRAIN, steps=TRAIN_STEPS, batch=TRAIN_BATCH["refiner"], input_size=S,
            chunk=TRAIN_CHUNK), n, f"train_agnostic_refiner ({TRAIN_STEPS} steps x 3 render calls)")
    (net_s, stats_s), ms_s, counts_s = drive_counted(
        raster_cuda, torch, lambda: agnostic.train_agnostic_scorer(
            prepped, K_TRAIN, steps=TRAIN_STEPS, n_hyp=TRAIN_BATCH["scorer"], input_size=S,
            chunk=TRAIN_CHUNK), n, f"train_agnostic_scorer ({TRAIN_STEPS} steps x 3 render calls)")
    trainers = {}
    for kind, stats, ms, counts in (("refiner", stats_r, ms_r, counts_r),
                                    ("scorer", stats_s, ms_s, counts_s)):
        means = stats["chunk_means"]
        trainers[kind] = {"chunk_means": means, "loss_first": stats["loss_first"],
                          "loss_last": stats["loss_last"], "steps": stats["steps"],
                          "wall_ms": ms, "ms_per_step": ms / TRAIN_STEPS,
                          "steps_per_s": TRAIN_STEPS / (ms / 1e3), "launches": counts}
        if len(means) != TRAIN_STEPS // TRAIN_CHUNK or not np.isfinite(means).all():
            fail(f"train_agnostic_{kind}: non-finite or missing losses {means}")
        if not means[-1] < means[0]:
            FAILURES.append(f"train_agnostic_{kind}: the last chunk's mean loss {means[-1]:.4f} "
                            f"is not below the first's {means[0]:.4f}")
    total = add_counts(add_counts({}, counts_r), counts_s)

    # ---- (4) a run cut after two chunks, resumed from its snapshot for one
    # more: the snapshot's step count and the optimiser's count continue
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "resume_refiner.pt")
        kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH["refiner"], input_size=S,
                  chunk=TRAIN_CHUNK, resume_path=snap, ckpt_every=TRAIN_CHUNK)
        before = dict(raster_cuda.LAUNCHES)
        _, cut = agnostic.train_agnostic_refiner(prepped, K_TRAIN, stop_after=2, **kw)
        at_cut = torch.load(snap, map_location="cpu", weights_only=True)
        _, resumed = agnostic.train_agnostic_refiner(prepped, K_TRAIN, stop_after=1, **kw)
        after = torch.load(snap, map_location="cpu", weights_only=True)
        add_counts(total, expect_launches(raster_cuda, before, 3 * 3 * TRAIN_CHUNK,
                                          "cut and resumed refiner run"))
    resume = {"done_at_cut": at_cut["done"], "count_at_cut": int(at_cut["opt"]["count"]),
              "done_after_resume": after["done"], "count_after_resume": int(after["opt"]["count"]),
              "steps_run_after_resume": resumed["steps"], "chunk_means_before_cut": cut["chunk_means"],
              "chunk_means_after_resume": resumed["chunk_means"]}
    if (resume["done_at_cut"], resume["count_at_cut"], resume["done_after_resume"],
            resume["count_after_resume"], resume["steps_run_after_resume"]) != (
            2 * TRAIN_CHUNK, 2 * TRAIN_CHUNK, 3 * TRAIN_CHUNK, 3 * TRAIN_CHUNK, TRAIN_CHUNK) \
            or not np.isfinite(resumed["chunk_means"]).all():
        fail(f"train: the resumed run did not continue from its snapshot: {resume}")

    # ---- (5) the output serves: save, load, a full-width learned-hybrid
    # register on the demo scene (11 + 11 launches, as on the main path)
    with tempfile.TemporaryDirectory() as tmp:
        agnostic.save_agnostic(tmp, net_r, net_s, {"input_size": S, "n_meshes": TRAIN_MESHES,
                                                   "refiner": stats_r, "scorer": stats_s})
        refiner, scorer, meta = agnostic.load_agnostic(tmp, device="cuda")
    est = FoundationPoseTorch(scene["mesh"], refiner=refiner, scorer=HybridScorer(scorer),
                              device="cuda")
    reg_args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    pose, reg_ms, reg_counts = drive_counted(
        raster_cuda, torch, lambda: est.register(*reg_args), 11,
        "register with the freshly trained checkpoint (5 + 2 + 2 + 2 render calls)")
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        fail("train: register with the freshly trained checkpoint gave no finite pose")
    serve = {"first_call_ms": reg_ms, "launches": reg_counts, "net_dtype": refiner.cfg.dtype,
             "adds_mm": metrics.adds_err(pose, scene["gt"], scene["mesh"].vertices) * 1000,
             "diameter_mm": est.diameter * 1000,
             "note": "ADD-S printed, not gated: 100 steps per net on 8 meshes"}
    add_counts(total, reg_counts)

    # ---- (6) the harness's per-scene training fallback (no agnostic
    # checkpoint): one learned scene, depth cut
    real_suite = scenes.build_suite
    scenes.build_suite = lambda quick=False: [dataclasses.replace(sp, **TRAIN_HARNESS_DEPTH)
                                              for sp in real_suite(quick)]
    try:
        res, h_ms, h_counts = drive_counted(
            raster_cuda, torch, lambda: harness.run_accuracy(
                modes=("learned",), agnostic_dir=None, device="cuda", **TRAIN_HARNESS),
            None, "evalsuite harness, learned fallback (per-scene training)")
    finally:
        scenes.build_suite = real_suite
    add_counts(total, h_counts)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "ACCURACY_r04.json")) as f:
        ref = json.load(f)["modes"]["learned"]
    block = res["modes"]["learned"]
    name = TRAIN_HARNESS["scene_names"][0]
    ref_scene = next(iter(ref["register"]["full"]["scenes"].values()))
    keys_ok = (set(block) == set(ref) and set(block["meta"]) == set(ref["meta"])
               and set(block["register"]) == set(ref["register"])
               and all(set(block["register"][k]["scenes"][name]) == set(ref_scene)
                       for k in block["register"])
               and set(block["track"]["scenes"][name])
               == set(next(iter(ref["track"]["scenes"].values()))))
    if not keys_ok:
        fail("train: the harness's learned fallback block lacks keys of the JAX package's")
    fallback = {"wall_ms": h_ms, "launches": h_counts, **TRAIN_HARNESS,
                "depth": TRAIN_HARNESS_DEPTH,
                "adds_mm": {k: [a * 1000 for a in v["scenes"][name]["adds"]]
                            for k, v in block["register"].items()},
                "track_auc_adds": block["track"]["scenes"][name]["auc_adds"]}
    if not all(np.isfinite(v).all() for v in fallback["adds_mm"].values()):
        fail("train: the harness's learned fallback gave non-finite ADD-S")

    say("train", corpus={"n_meshes": TRAIN_MESHES, "seed": 7, "max_faces": 2048,
                         "textured": sum(p_["textured"] for p_ in prepped),
                         "picked_faces": {k: faces(v) for k, v in picked.items()}},
        kernels_at_training_shapes=kernels, times_training_shapes=timed_rows,
        one_step_against_plain=step_rows, loss_rtol=TRAIN_LOSS_RTOL, trainers=trainers,
        resume=resume, serve=serve, harness_fallback=fallback, launches=total,
        gate="K1s/K1r at the kernel gates; one step's batches within the kernel gates on "
             f">= 0.999 of elements and its loss within {TRAIN_LOSS_RTOL} relative; every "
             "loss finite, the last chunk's mean below the first's; 3 + 3 launches per step",
        card=smi)
    return total, {"kernels": kernels, "times": timed_rows}


FIELD_VIEWS = 60         # run_field's --n-frames default
FIELD_DIST = 0.5         # metres from the object's centre to each camera
FIELD_N_STEP = 1000      # FieldConfig().n_step: the only depth the phase may cut (the
                         # phase is to stay under ~90 s; on an H100 it takes ~75 s)
FIELD_TIMED_STEPS = 100  # steady-state rays/s after a 10-step warm-up (bench.py:454-466)
FIELD_HASH_STEPS = (10, 40)  # hash encoder at its defaults: 10 logged, then 40 timed
FIELD_BAND = 0.015       # SDF probes this share of the diameter off the true surface
FIELD_MESH_GATE = 0.05   # mean vertex distance to the true surface, share of the diameter
BAKE_COLOUR_GATE = 0.08  # the JAX package's gate, tests/test_texture_slam.py:65
FIELD_VIEW = 3           # the training view the bakes are re-rendered at


def _boxes_of(mesh):
    """(lo, hi) corners of the demo L-shape's three boxes (8 vertices each)."""
    v = mesh.vertices.reshape(-1, 8, 3)
    return v.min(axis=1), v.max(axis=1)


def _inside_boxes(pts, boxes):
    lo, hi = boxes
    return ((pts[:, None] > lo[None]) & (pts[:, None] < hi[None])).all(axis=-1).any(axis=-1)


def outer_surface_samples(mesh, n, rng):
    """Points on the L-shape's outer surface (not on faces where two boxes
    touch) with outward unit normals, area-weighted."""
    boxes = _boxes_of(mesh)
    tri = mesh.vertices[mesh.faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    centre = ((boxes[0] + boxes[1]) / 2)[np.arange(len(tri)) // 12]
    nrm *= np.sign(((tri.mean(axis=1) - centre) * nrm).sum(-1))[:, None]  # outward
    f = rng.choice(len(tri), size=n, p=area / area.sum())
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pts = tri[f, 0] + u[:, None] * (tri[f, 1] - tri[f, 0]) + v[:, None] * (tri[f, 2] - tri[f, 0])
    keep = ~_inside_boxes(pts + 1e-5 * nrm[f], boxes)
    return pts[keep], nrm[f][keep]


def bake_render_calls(texture, n_faces, hw):
    """Render calls ``bake_texture`` makes for FIELD_VIEWS views of a mesh of
    ``n_faces`` faces: its views go in calls of ``_views_per_call`` views."""
    return -(-FIELD_VIEWS // texture._views_per_call(n_faces, hw, texture.BINS_BUDGET))


def field_views(demo, raster, raster_cuda):
    """The field phase's frames: the demo's L-shape (position-coded vertex
    colours) rendered unlit through K1 at 480x640 from FIELD_VIEWS icosphere
    views FIELD_DIST away, as the reader gives them back (8-bit rgb,
    millimetre depth)."""
    from foundationpose_tpu_torch.core import icosphere
    from foundationpose_tpu_torch.evalsuite.scenes import HW_DEFAULT, K_DEFAULT

    K, hw = K_DEFAULT, tuple(HW_DEFAULT)
    mesh = demo.make_l_shape()
    v = mesh.vertices
    mesh.vertex_colors = ((v - v.min(0)) / np.ptp(v, axis=0) * 190 + 40).astype(np.uint8)
    cams = icosphere.sample_views_icosphere(n_views=FIELD_VIEWS)[:FIELD_VIEWS]
    cams[:, :3, 3] = cams[:, :3, 3] * FIELD_DIST + mesh.bounds.mean(axis=0)  # cam_in_ob
    ob_in_cams = np.linalg.inv(cams)
    frames = raster_cuda.render_full_frame(raster.make_mesh_tensors(mesh, device="cuda"),
                                           ob_in_cams.astype(np.float32), K, hw,
                                           use_light=False)
    return {"mesh": mesh, "cams": cams, "ob_in_cams": ob_in_cams, "K": K, "hw": hw,
            "images": (frames["rgb"].cpu().numpy() * 255).astype(np.uint8),
            "depth_mm": np.rint(frames["depth"].cpu().numpy() * 1000).astype(np.uint16),
            "masks": frames["mask"].cpu().numpy()}


def field_runner_inputs(images, depth_mm, masks, ob_in_cams, K):
    """``NeRFRunner``'s arguments for the field phase's frames, as run_field
    builds them: scene bounds, normalised frames, the fused cloud."""
    from foundationpose_tpu_torch.field import bounds as bounds_mod

    depths = (depth_mm.astype(np.float64) / 1e3).astype(np.float32)
    rmasks = masks.astype(np.uint8)
    poses_in = np.linalg.inv(ob_in_cams)  # as run_field inverts the annotated poses
    translation, sc_factor, cluster = bounds_mod.compute_scene_bounds(depths, rmasks, K, poses_in)
    rgbs_n, depths_n, masks_n, poses_n = bounds_mod.preprocess_data(
        images.astype(np.float32), depths, rmasks, poses_in, sc_factor, translation)
    return (rgbs_n, depths_n, masks_n, poses_n, K, (cluster + translation) * sc_factor,
            sc_factor, translation)


def run_field_phase(torch, demo, raster, raster_cuda, smi):
    """The neural object field through ``run_field.main`` at ``FieldConfig()``
    widths (2048 rays x (128 + 128) samples, triplane encoder, 3 mm mesh,
    1024 texture): the demo's L-shape (position-coded vertex colours) rendered
    unlit through K1 at 480x640 from 60 icosphere views 0.5 m away, written as
    a YCBInEOAT tree with the port's PNG writer. Checks the bounds, the loss
    log, SDF signs off the true surface, the mesh's distance to it, frame 0's
    pose, K1 at the bake's shape against the plain version (with tri + bary),
    the bake's launch count, the ground-truth mesh baked and re-rendered; then
    steady-state rays/s of the triplane field and 50 steps of the hash
    encoder at its defaults. Runs with cv2, PIL, sklearn and yaml blocked
    where they are installed."""
    import tempfile

    from scipy.spatial import cKDTree

    from foundationpose_tpu_torch.apps import run_field
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.field import texture
    from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner
    from foundationpose_tpu_torch.io import png

    t_phase = time.perf_counter()
    blocked = ("cv2", "PIL", "sklearn", "yaml")
    present = {n: subprocess.run([sys.executable, "-c", f"import {n}"], capture_output=True,
                                 timeout=120).returncode == 0 for n in blocked}
    views = field_views(demo, raster, raster_cuda)
    mesh, cams, ob_in_cams, K, hw, images, depth_mm, masks = (views[k] for k in (
        "mesh", "cams", "ob_in_cams", "K", "hw", "images", "depth_mm", "masks"))
    diameter = centred_diameter(meshio, mesh)
    rng = np.random.default_rng(0)
    surf, surf_n = outer_surface_samples(mesh, 400_000, rng)
    tree = cKDTree(surf)
    probe = rng.choice(len(surf), 4000, replace=False)

    with tempfile.TemporaryDirectory() as tmp, \
            (without_modules(blocked) if any(present.values()) else contextlib.nullcontext()):
        video = os.path.join(tmp, "field_lshape")
        for sub in ("rgb", "depth", "masks", "annotated_poses"):
            os.makedirs(os.path.join(video, sub))
        np.savetxt(os.path.join(video, "cam_K.txt"), K)
        for i in range(FIELD_VIEWS):
            png.write_png(os.path.join(video, "rgb", f"{i:04d}.png"), images[i])
            png.write_png(os.path.join(video, "depth", f"{i:04d}.png"), depth_mm[i])
            png.write_png(os.path.join(video, "masks", f"{i:04d}.png"),
                          masks[i].astype(np.uint8) * 255)
            np.savetxt(os.path.join(video, "annotated_poses", f"{i:04d}.txt"), ob_in_cams[i])
        out_dir = os.path.join(tmp, "out")
        reset_launches(raster_cuda)
        (mesh_r, opt_poses, runner), main_ms = timed(torch, lambda: run_field.main(
            ["--data-dir", video, "--save-dir", out_dir, "--n-step", str(FIELD_N_STEP),
             "--device", "cuda"]))
        bake_calls = bake_render_calls(texture, len(mesh_r.faces), hw)
        bake_launches = expect_launches(raster_cuda, dict.fromkeys(raster_cuda.LAUNCHES, 0),
                                        bake_calls, "run_field (texture bake render calls)")
        PER_CALL["run_field: texture bake (one per render call)"] = bake_launches
        artifacts = sorted(os.listdir(out_dir))
    cfg = runner.cfg
    if cfg != FieldConfig(n_step=FIELD_N_STEP):
        fail(f"field: run_field did not train at FieldConfig() widths: {cfg}")
    if artifacts != ["field_latest.ckpt", "mesh_real_world.mtl", "mesh_real_world.obj",
                     "mesh_real_world.png", "optimized_poses.txt"]:
        fail(f"field: run_field left {artifacts}")

    # ---- training: the logged losses
    log = [(step, aux["loss"]) for step, aux in runner.log]
    losses = [l for _, l in log]
    if not np.isfinite(losses).all() or not losses[-1] < 0.5 * losses[0]:
        fail(f"field: losses not finite and falling to below half: {log}")

    # ---- SDF signs off the true surface (normalised frame of the field)
    band = FIELD_BAND * diameter
    to_n = lambda p: (p + runner.translation[None]) * runner.sc_factor  # noqa: E731
    sdf_out = runner.sdf_fn(to_n(surf[probe] + band * surf_n[probe])).cpu().numpy()
    sdf_in = runner.sdf_fn(to_n(surf[probe] - band * surf_n[probe])).cpu().numpy()
    sdf_row = {"probes": len(probe), "band_mm": band * 1000,
               "outside_positive": float((sdf_out > 0).mean()),
               "inside_negative": float((sdf_in < 0).mean())}
    if sdf_row["outside_positive"] < 0.95 or sdf_row["inside_negative"] < 0.75:
        FAILURES.append(f"field: SDF signs {sdf_row} (gates 0.95 outside, 0.75 inside)")

    # ---- the mesh, in metres, against the true outer surface; frame 0's pose
    dist = tree.query(mesh_r.vertices)[0]
    mesh_row = {"faces": int(len(mesh_r.faces)), "vertices": int(len(mesh_r.vertices)),
                "mean_dist_mm": float(dist.mean() * 1000),
                "mean_dist_of_diameter": float(dist.mean() / diameter),
                "p95_dist_mm": float(np.percentile(dist, 95) * 1000),
                "diameter_mm": diameter * 1000,
                "texture": list(mesh_r.texture.shape) if mesh_r.texture is not None else None}
    if not len(mesh_r.faces) or mesh_row["mean_dist_of_diameter"] > FIELD_MESH_GATE:
        FAILURES.append(f"field: mesh {mesh_row} (gate {FIELD_MESH_GATE:.0%} of the diameter)")
    pose0_err = float(np.abs(opt_poses[0] - cams[0]).max())
    if pose0_err > 1e-4:
        fail(f"field: frame 0's optimised pose moved by {pose0_err}")
    pose_drift = np.linalg.norm(opt_poses[:, :3, 3] - cams[:, :3, 3], axis=-1)

    # ---- K1 at the bake's shape against the plain version: the unwrapped
    # reconstructed mesh, the first render call's views, unlit, unculled,
    # tri + bary, no normals
    un = mesh_r.copy()  # the bake's unwrapped mesh, rendered without its texture
    un.texture = None
    mt_un = raster.make_mesh_tensors(un, device="cuda")
    B = min(FIELD_VIEWS, texture._views_per_call(len(un.faces), hw, texture.BINS_BUDGET))
    bposes = torch.tensor(np.linalg.inv(opt_poses[:B]), dtype=torch.float32, device="cuda")
    Kt = torch.tensor(K, dtype=torch.float32, device="cuda")
    eye = torch.eye(3, device="cuda").expand(B, 3, 3).contiguous()
    tag = {"case": f"bake {len(un.faces)}-face reconstructed mesh", "batch": f"B{B}",
           "cull": False}
    srow, scratch = compare_setup(raster, raster_cuda, torch, mt_un, bposes, Kt, eye, False, tag,
                                  hw)
    kw = dict(out_hw=hw, backface_cull=False, with_normal=False, use_light=False, with_bary=True)
    krow = compare_with_plain(raster, raster_cuda, torch, mt_un, bposes, Kt, eye, kw,
                              {**tag, "with_normal": False}, scratch, excuse_cap=EXCUSE_CAP)
    bake_time = time_render(raster, raster_cuda, torch, "texture bake", mt_un, bposes, Kt, eye,
                            hw, False, cull=False, use_light=False, with_tri_bary=True,
                            plain_twice=False)

    # ---- bakes re-rendered at a training view: the true mesh (gated), the
    # reconstruction (printed)
    def colour_err(textured, pose):
        a = raster_cuda.render_full_frame(raster.make_mesh_tensors(textured, device="cuda"),
                                          pose[None].astype(np.float32), K, hw, use_light=False)
        m = a["mask"][0].cpu().numpy() & masks[FIELD_VIEW]
        ref = images[FIELD_VIEW][m] / 255.0
        return float(np.abs(a["rgb"][0].cpu().numpy()[m] - ref).mean()), int(m.sum())

    gt_bake, gt_bake_ms, gt_counts = drive_counted(
        raster_cuda, torch, lambda: texture.bake_texture(mesh, images, masks, cams, K,
                                                         tex_res=1024, device="cuda"),
        bake_render_calls(texture, len(mesh.faces), hw),
        "texture bake of the true mesh (one launch per render call)")
    gt_err, gt_px = colour_err(gt_bake, ob_in_cams[FIELD_VIEW])
    rec_err, rec_px = colour_err(mesh_r, np.linalg.inv(opt_poses[FIELD_VIEW]))
    if not gt_err < BAKE_COLOUR_GATE:
        FAILURES.append(f"field: the true mesh's bake re-rendered off by {gt_err}")

    # ---- steady-state rays/s of the trained triplane field
    runner.train(n_step=10, log_every=10**9)
    t0 = time.perf_counter()
    runner.train(n_step=FIELD_TIMED_STEPS, log_every=10**9)  # ends in a host read
    tri_rays_s = FIELD_TIMED_STEPS * cfg.n_rand / (time.perf_counter() - t0)

    # ---- the hash encoder at its defaults, the same rays (the frames as the
    # reader gives them back: lossless PNGs, millimetre depth)
    hcfg = FieldConfig(encoder="hash")
    hr = NeRFRunner(hcfg, *field_runner_inputs(images, depth_mm, masks, ob_in_cams, K),
                    device="cuda")
    if not torch.equal(hr.rays, runner.rays):
        fail("field: the hash runner's rays differ from run_field's")
    table = hr.field.grid.table
    hr.train(n_step=FIELD_HASH_STEPS[0], log_every=1)
    t0 = time.perf_counter()
    h_last = hr.train(n_step=FIELD_HASH_STEPS[1], log_every=10**9)
    hash_rays_s = FIELD_HASH_STEPS[1] * hcfg.n_rand / (time.perf_counter() - t0)
    h_losses = [aux["loss"] for _, aux in hr.log] + [h_last]
    if not np.isfinite(h_losses).all() or not h_last < h_losses[0]:
        fail(f"field: hash encoder losses not finite and falling: {h_losses}")
    hash_row = {"steps": sum(FIELD_HASH_STEPS), "losses_first_10_and_last": h_losses,
                "rays_per_s": hash_rays_s, "levels": hr.field.grid.resolutions,
                "table_entries": int(table.shape[0]), "table_mib": table.numel() * 4 / 2**20,
                "dense_levels": sum((R + 1) ** 3 <= t for R, t in
                                    zip(hr.field.grid.resolutions, hr.field.grid.table_sizes))}
    del hr

    say("field", n_step=FIELD_N_STEP, n_step_cut_from=FieldConfig().n_step,
        reduced=[] if FIELD_N_STEP == FieldConfig().n_step else
        [f"n_step {FieldConfig().n_step} -> {FIELD_N_STEP}"],
        frames=FIELD_VIEWS, hw=list(hw), distance_m=FIELD_DIST, rays=int(runner.rays.shape[0]),
        config={"n_rand": cfg.n_rand, "samples": [cfg.n_samples, cfg.n_samples_around_depth],
                "encoder": cfg.encoder, "triplane": list(cfg.triplane_resolutions),
                "channels": cfg.triplane_channels, "freqs": cfg.triplane_freqs,
                "mesh_resolution_m": cfg.mesh_resolution, "tex_res": 1024},
        blocked_modules=[n for n, p in present.items() if p],
        bounds={"sc_factor": runner.sc_factor, "translation": runner.translation.tolist(),
                "sklearn_used": False},
        run_field_ms=main_ms, loss_log=log, triplane_rays_per_s=tri_rays_s,
        triplane_timed_steps=FIELD_TIMED_STEPS, sdf_signs=sdf_row, mesh=mesh_row,
        pose0_max_abs_err=pose0_err, pose_drift_mm={"max": float(pose_drift.max() * 1000),
                                                    "mean": float(pose_drift.mean() * 1000)},
        bake={"render_calls": bake_calls, "launches": bake_launches, "views_per_call": B,
              "K1s_vs_plain": srow, "K1r_vs_plain": krow, "times": bake_time,
              "true_mesh_colour_err": gt_err, "true_mesh_common_px": gt_px,
              "true_mesh_bake_ms": gt_bake_ms, "true_mesh_launches": gt_counts,
              "reconstruction_colour_err": rec_err, "reconstruction_common_px": rec_px},
        hash=hash_row, phase_s=time.perf_counter() - t_phase,
        gate="losses finite, the last logged below half the first; SDF > 0 on >= 95 % of "
             f"points {FIELD_BAND:.1%} of the diameter outside the true surface, < 0 on >= 75 % "
             f"inside; mesh vertices within {FIELD_MESH_GATE:.0%} of the diameter of the true "
             "surface on average; frame 0's pose within 1e-4; K1 at the bake's shape at the "
             "kernel gates (bary 1e-5); launches = the bake's render calls; the true mesh's "
             f"bake re-rendered within {BAKE_COLOUR_GATE} mean colour error; hash losses "
             "finite and falling",
        card=smi)
    return ({"K1s": bake_launches["K1s"] + gt_counts["K1s"],
             "K1r": bake_launches["K1r"] + gt_counts["K1r"]},
            {"setup": srow, "raster": krow, "time": bake_time}, views)


SLAM_FRAMES = 40           # the orbit's frames at most; it stops after the first retrain
SLAM_DIST = 0.45           # metres from the camera to the object's origin at frame 0
# per-frame orbit about y and z (rad): half the step of tests/test_online.py:117,
# the same shape. Tracked on past the first retrain, or at the full step for 40
# frames, the reference design drifts beyond the gate (PERF.md, section 6).
SLAM_STEP = (0.0175, 0.006)
SLAM_DRIFT_GATE = (0.02, 8.0)  # metres, degrees: tests/test_online.py:158-160
SLAM_RECON_GATE = 0.03     # median distance to the true surface (m), tests/test_online.py:175
SLAM_BA = dict(n_landmarks=512, rounds=3)
SLAM_BA_NOISE = (0.02, 0.004)  # rad, m: the keyframe perturbation of tests/test_ba.py:207-211


def orbit(n):
    """cam_in_ob of ``n`` frames orbiting the object (tests/test_online.py:112-121)."""
    from foundationpose_tpu_torch.core.poses import euler_matrix_np

    cam0 = np.eye(4)
    cam0[:3, 3] = [0.0, 0.0, -SLAM_DIST]
    traj = [cam0]
    for i in range(1, n):
        c = np.eye(4)
        c[:3, :3] = euler_matrix_np(0.0, SLAM_STEP[0] * i, SLAM_STEP[1] * i)[:3, :3]
        c[:3, 3] = c[:3, :3] @ cam0[:3, 3]
        traj.append(c)
    return np.stack(traj)


def rot_deg(R1, R2):
    return float(np.degrees(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1))))


def run_slam_phase(torch, demo, raster, raster_cuda, smi):
    """The online model-free tracker at ``OnlineConfig()`` (FieldConfig(n_step=
    300) widths, 8192 render faces, 4 ICP iterations, mesh stride 2) on the
    demo L-shape (position-coded colours, unlit) rendered through K1 at
    480x640 along an orbit: ``init``, a ``step`` per frame (4 + 4 launches
    each) with its keyframes, up to and including the step whose eighth
    keyframe triggers the first retrain (at most SLAM_FRAMES frames),
    tracking drift gated on every frame; then ``run_pose_graph_ba`` on the
    keyframes' true poses perturbed as tests/test_ba.py perturbs them (no
    launch; gated as there); then ``finalize(bake=True, tex_res=1024)``
    (launches = the bake's render calls; the reconstruction gated against the
    true surface). K1s + K1r are held against their plain versions at the
    tracker's shape (B = 1 x 160 px, unculled, with normals, unbucketed) on
    the bootstrap depth-map mesh and on the retrained field mesh (at the pose
    the next step would start from). Returns (launches of the path, kernel
    figures at the tracker's shape, the BA problem the multi_device phase
    reuses)."""
    from scipy.spatial import cKDTree

    from foundationpose_tpu_torch.core import geometry as geo
    from foundationpose_tpu_torch.core.poses import euler_matrix_np
    from foundationpose_tpu_torch.evalsuite.scenes import HW_DEFAULT, K_DEFAULT
    from foundationpose_tpu_torch.field import texture
    from foundationpose_tpu_torch.field.runner import FieldConfig
    from foundationpose_tpu_torch.slam import ba as ba_mod
    from foundationpose_tpu_torch.slam.online import ModelFreeTracker, OnlineConfig
    from foundationpose_tpu_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    K, hw = K_DEFAULT, tuple(HW_DEFAULT)
    mesh = demo.make_l_shape()
    v = mesh.vertices
    mesh.vertex_colors = ((v - v.min(0)) / np.ptp(v, axis=0) * 190 + 40).astype(np.uint8)
    traj = orbit(SLAM_FRAMES)
    mt = raster.make_mesh_tensors(mesh, device="cuda")
    out = raster_cuda.render_full_frame(mt, np.linalg.inv(traj).astype(np.float32), K, hw,
                                        use_light=False)
    rgbs = (out["rgb"].cpu().numpy() * 255).astype(np.float32)
    depths = out["depth"].cpu().numpy().astype(np.float32)
    masks = out["mask"].cpu().numpy().astype(np.uint8)
    del out
    expected = np.linalg.inv(traj[0]) @ traj  # cam_in_ob in the tracker's frame (camera 0's)

    cfg = OnlineConfig()
    if cfg != OnlineConfig(field=FieldConfig(n_step=300)) or cfg.max_render_faces != 8192:
        fail(f"slam: OnlineConfig() is not at the JAX package's defaults: {cfg}")
    tracker = ModelFreeTracker(K, cfg, device="cuda")
    timer = StageTimer(device="cuda")
    undo = [timer.wrap(tracker, "retrain", "retrain"),
            timer.wrap(ba_mod, "build_ba_problem", "BA round: problem (host numpy)"),
            timer.wrap(ba_mod, "bundle_adjust", "BA round: Gauss-Newton (device)")]
    reset_launches(raster_cuda)
    try:
        tracker.init(rgbs[0], depths[0], masks[0])
        snapshots = {}
        steps, kf_frames, n_iter = [], [0], cfg.track_iterations

        def snapshot(name):
            """The mesh tensors and the pose the next step starts from."""
            snapshots[name] = (tracker.mesh_tensors,
                               np.linalg.inv(tracker.cam_in_ob) @ tracker._to_center,
                               float(tracker.diameter))

        snapshot("bootstrap depth-map mesh")
        for f in range(1, SLAM_FRAMES):
            n_kf, retrain_ms = len(tracker.keyframes), timer.ms.get("retrain", 0.0)
            before = dict(raster_cuda.LAUNCHES)
            _, ms = timed(torch, lambda: tracker.step(rgbs[f], depths[f], mask=masks[f]))
            n = expect_launches(raster_cuda, before, n_iter,
                                f"slam step frame {f} ({n_iter} ICP render calls)")
            est = tracker.cam_in_ob
            row = {"frame": f, "ms": ms, "launches": n,
                   "keyframe": len(tracker.keyframes) > n_kf,
                   "retrain_ms": timer.ms.get("retrain", 0.0) - retrain_ms,
                   "drift_mm": float(np.linalg.norm(est[:3, 3] - expected[f][:3, 3]) * 1000),
                   "drift_deg": rot_deg(est[:3, :3], expected[f][:3, :3])}
            if row["keyframe"]:
                kf_frames.append(f)
            steps.append(row)
            if timer.counts["retrain"]:
                snapshot("retrained field mesh")
                break
        PER_CALL[f"ModelFreeTracker.step ({n_iter} ICP render calls)"] = n

        # ---- pose-graph BA on the keyframes' true poses, perturbed
        rng = np.random.default_rng(5)
        cams_gt = expected[kf_frames]
        cams_noisy = cams_gt.copy()
        for k in range(1, len(kf_frames)):
            d = np.eye(4)
            d[:3, :3] = euler_matrix_np(*rng.normal(0, SLAM_BA_NOISE[0], 3))[:3, :3]
            d[:3, 3] = rng.normal(0, SLAM_BA_NOISE[1], 3)
            cams_noisy[k] = cams_gt[k] @ d
        for kf, c in zip(tracker.keyframes, cams_noisy):
            kf["cam_in_ob"] = c.copy()
        ba_problem = ba_mod.build_ba_problem(depths[kf_frames], masks[kf_frames], cams_noisy, K,
                                             n_landmarks=SLAM_BA["n_landmarks"])
        before = dict(raster_cuda.LAUNCHES)
        ba_before = timer.ms
        cost, ba_ms = timed(torch, lambda: tracker.run_pose_graph_ba(**SLAM_BA))
        expect_launches(raster_cuda, before, 0, "run_pose_graph_ba (renders nothing)")
        refined = np.stack([kf["cam_in_ob"] for kf in tracker.keyframes])

        def errs(cams):
            te = np.linalg.norm(cams[:, :3, 3] - cams_gt[:, :3, 3], axis=1).mean()
            re = np.mean([np.radians(rot_deg(c[:3, :3], g[:3, :3])) for c, g in zip(cams, cams_gt)])
            return float(te), float(re)

        (te0, re0), (te1, re1) = errs(cams_noisy), errs(refined)
        if not (re1 < 0.5 * re0 and te1 < 2.0 * te0):
            FAILURES.append(f"slam: BA rotation error {re0:.5f} -> {re1:.5f} rad, translation "
                            f"{te0 * 1000:.2f} -> {te1 * 1000:.2f} mm (gate: rotation halved, "
                            "translation not doubled)")

        # ---- final field, texture bake through K1
        n_kf = len(tracker.keyframes)
        before = dict(raster_cuda.LAUNCHES)
        (textured, optimized), fin_ms = timed(torch, lambda: tracker.finalize(bake=True,
                                                                               tex_res=1024))
        calls = -(-n_kf // texture._views_per_call(len(textured.faces), hw, texture.BINS_BUDGET))
        bake_launches = expect_launches(raster_cuda, before, calls,
                                        "finalize (texture bake render calls)")
        PER_CALL["ModelFreeTracker.finalize: texture bake (one per render call)"] = bake_launches
        path_launches = dict(raster_cuda.LAUNCHES)  # read just after the path
    finally:
        for u in undo:
            u()
    ba_stage_ms = {k: v - ba_before.get(k, 0.0) for k, v in timer.ms.items() if k.startswith("BA")}

    drift_mm = max(r["drift_mm"] for r in steps)
    drift_deg = max(r["drift_deg"] for r in steps)
    if drift_mm > SLAM_DRIFT_GATE[0] * 1000 or drift_deg > SLAM_DRIFT_GATE[1]:
        FAILURES.append(f"slam: tracking drift {drift_mm:.1f} mm / {drift_deg:.2f} deg "
                        f"(gates {SLAM_DRIFT_GATE[0] * 1000:.0f} mm, {SLAM_DRIFT_GATE[1]} deg)")
    n_retrain = timer.counts.get("retrain", 0)
    if len(kf_frames) < 4 or n_retrain < 1:
        fail(f"slam: {len(kf_frames)} keyframes and {n_retrain} retrains (the phase needs several "
             "keyframes and at least one retrain)")
    # the reconstruction (tracker frame = camera 0's) against the true outer surface
    rec = textured.vertices @ traj[0][:3, :3].T + traj[0][:3, 3]
    surf, _ = outer_surface_samples(mesh, 200_000, np.random.default_rng(0))
    dist = cKDTree(surf).query(rec)[0]
    recon = {"faces": int(len(textured.faces)), "median_dist_mm": float(np.median(dist) * 1000),
             "mean_dist_mm": float(dist.mean() * 1000),
             "texture": None if textured.texture is None else list(textured.texture.shape)}
    if not len(textured.faces) or np.median(dist) > SLAM_RECON_GATE or textured.texture is None:
        FAILURES.append(f"slam: reconstruction {recon} (gate: textured, median distance "
                        f"< {SLAM_RECON_GATE * 1000:.0f} mm)")

    # ---- K1s + K1r at the tracker's shape against their plain versions
    Kt = torch.tensor(K, dtype=torch.float32, device="cuda")
    k1_rows, k1_times = [], []
    for name, (smt, pose_c, diameter) in snapshots.items():
        poses = torch.tensor(pose_c[None], dtype=torch.float32, device="cuda")
        tfs = geo.compute_crop_window_tf_batch(poses, Kt, 1.2, diameter, (S, S))
        tag = {"case": f"slam tracker, {name}", "batch": "B1", "cull": False}
        srow, scratch = compare_setup(raster, raster_cuda, torch, smt, poses, Kt, tfs, False, tag)
        kw = dict(out_hw=(S, S), backface_cull=False, with_normal=True)
        # marching tetrahedra leaves sub-pixel noise faces in the field mesh
        # (ROADMAP.md queue 3); the bake's excuse covers exactly those
        cap = EXCUSE_CAP if "field" in name else 0.0
        krow = compare_with_plain(raster, raster_cuda, torch, smt, poses, Kt, tfs, kw,
                                  {**tag, "with_normal": True}, scratch, excuse_cap=cap)
        k1_rows.append({"setup": srow, "raster": krow})
        k1_times.append(time_render(raster, raster_cuda, torch, f"slam tracker, {name}", smt,
                                    poses, Kt, tfs, (S, S), True, cull=False))
    rounds = SLAM_BA["rounds"]
    track_ms = [r["ms"] - r["retrain_ms"] for r in steps]
    say("slam", frames=len(steps) + 1, orbit_step_rad=list(SLAM_STEP), hw=list(hw),
        reduced=[f"orbit stops after the first retrain: {len(steps) + 1} of {SLAM_FRAMES} frames"],
        config={"keyframe_min_rot_deg": cfg.keyframe_min_rot_deg,
                "keyframe_min_trans": cfg.keyframe_min_trans,
                "retrain_every_keyframes": cfg.retrain_every_keyframes,
                "track_iterations": n_iter, "mesh_stride": cfg.mesh_stride,
                "max_render_faces": cfg.max_render_faces, "field_n_step": cfg.field.n_step,
                "field_rays": cfg.field.n_rand},
        keyframes=len(kf_frames), keyframe_frames=kf_frames, retrains=n_retrain,
        retrain_ms=timer.ms.get("retrain", 0.0) / max(n_retrain, 1),
        step_launches=PER_CALL[f"ModelFreeTracker.step ({n_iter} ICP render calls)"],
        step_ms_median=float(np.median(track_ms)), step_ms_max=float(np.max(track_ms)),
        drift_max_mm=drift_mm, drift_max_deg=drift_deg, steps=steps,
        ba={"keyframes": n_kf, **SLAM_BA, "cost": cost, "ms": ba_ms,
            "ms_per_round": ba_ms / rounds,
            "stage_ms_per_round": {k: v / rounds for k, v in ba_stage_ms.items()},
            "rot_err_rad": [re0, re1], "trans_err_mm": [te0 * 1000, te1 * 1000],
            "landmarks_observed": int((ba_problem["obs_w"] > 0).any(axis=1).sum())},
        finalize={"ms": fin_ms, "bake_render_calls": calls, "launches": bake_launches,
                  **recon},
        kernels_at_tracker_shape=k1_rows, kernel_times=k1_times,
        phase_s=time.perf_counter() - t_phase,
        gate=f"every step {n_iter} + {n_iter} launches; drift < {SLAM_DRIFT_GATE[0] * 1000:.0f} mm "
             f"and {SLAM_DRIFT_GATE[1]} deg on every frame; >= 4 keyframes and >= 1 retrain; BA "
             "halves the mean rotation error without doubling the translation error, launching "
             "nothing; finalize launches = the bake's render calls; the textured reconstruction "
             f"within {SLAM_RECON_GATE * 1000:.0f} mm of the true surface (median); K1 at the "
             "tracker's shape at the kernel gates (the field mesh: the bake's noise-face excuse)",
        card=smi)
    return path_launches, {"rows": k1_rows, "times": k1_times}, ba_problem


MD_WORLD = 2               # ranks sharing the one card
MD_TIMEOUT = 600           # seconds a launch of the ranks may take
MD_REGISTER_TOL = 1e-3     # tests/test_sharded_register.py:76-84
MD_SCORE_TOL = 1e-4        # the sharded scorer on the same 256 poses, float32 nets
MD_BA_TOL = 1e-4           # tests/test_ba.py:162
MD_LOSS_RTOL = 1e-4        # __graft_entry__.py:140-143
# An all-reduced gradient against the single-process one: largest difference
# over the gradient's norm (only the order of summation differs; float32
# rounding of a sum of ~1e6 terms stays far below it)
MD_GRAD_TOL = 1e-5
# The sharded multi-object step's poses (float32 RefineNet): against an
# unsharded tracker over the rank's own objects — the same RefineNet batch —
# and against the unsharded tracker over all four. cuDNN's float32
# convolutions round otherwise at a batch of 2 crops than of 4, and two refine
# iterations carry it into the poses (H100: 1.5e-5 with 2 + 2 objects), so
# the second gate is the multi_object phase's own for a step that differs in
# rounding only (1e-4, against the plain rasterizer).
MD_MULTI_TOL = 1e-5
MD_MULTI_BATCH_TOL = 1e-4
MD_DP_STEPS = 3            # data-parallel refiner step: steps of each run
MD_DP_BATCH = 32           # its global batch (train_agnostic --batch)
MD_FIELD_STEPS = 5         # sharded field steps, each against the unsharded step
MD_TIMED = 10              # steps or calls timed per figure


class Stages:
    """Wall ms per named stage, each closed by a device synchronise."""

    def __init__(self, torch):
        self.torch, self.ms, self.t = torch, {}, None

    def start(self):
        self.torch.cuda.synchronize()
        self.t = time.perf_counter()

    def mark(self, name):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now

    def mean(self, n):
        return {k: v / n for k, v in self.ms.items()}


def mean_ms(torch, fn, n):
    """Mean wall ms of ``n`` calls of ``fn`` after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def md_kernels(torch, raster, raster_cuda, mt, poses, K, tfs, cull, normals, case, light=True):
    """K1s + K1r against their plain versions at one of a rank's shard
    shapes (exits on a disagreement); returns the row's summary."""
    tag = {"case": case, "batch": f"B{poses.shape[0]}", "cull": cull}
    srow, scratch = compare_setup(raster, raster_cuda, torch, mt, poses, K, tfs, cull, tag)
    kw = dict(out_hw=(S, S), backface_cull=cull, with_normal=normals, use_light=light)
    krow = compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw,
                              {**tag, "with_normal": normals}, scratch)
    return {**tag, "faces": srow["faces"], "K1s_vtab_max_abs_err": srow["vtab_max_abs_err"],
            "K1s_bins_agree": srow["bins_agree"], "mask_agree": krow["mask_agree"],
            "winner_flips_of_common": krow["winner_flips_of_common"],
            **{k: v for k, v in krow.items() if k.endswith("_max_abs_err")}}


def md_register(torch, demo, raster, raster_cuda, multihost, mesh, scene, out, res):
    """The learned-hybrid ``register`` unsharded and sharded, with the shipped
    bf16 nets and float32 copies; the row-sharded preprocess against the
    unsharded one; the sharded scorer on the same poses; K1 at the rank's
    refine and score shards."""
    from foundationpose_tpu_torch.core import geometry as geo
    from foundationpose_tpu_torch.engine.estimator import preprocess_depth
    from foundationpose_tpu_torch.parallel.mesh import shard_batch, shard_rows

    args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    ests = {}
    for dtype in ("bfloat16", "float32"):
        for kind, dm in (("one", None), ("sharded", mesh)):
            est = demo.build_estimator(scene["mesh"], device="cuda", device_mesh=dm)
            if dtype == "float32":
                est.refiner, est.scorer = float32_nets(est.refiner, est.scorer)
            est.register(*args)  # warm: cuDNN's algorithm choice, the allocator
            multihost.sync_hosts()
            reset_launches(raster_cuda)
            pose, ms = timed(torch, lambda: est.register(*args))
            tag = f"{kind}_{dtype}"
            out[f"{tag}_launches"] = dict(raster_cuda.LAUNCHES)
            out[f"{tag}_ms"] = ms
            res.update({f"{tag}_pose": pose, f"{tag}_poses": est.poses,
                        f"{tag}_scores": est.scores, f"{tag}_order": est.hyp_order})
            ests[tag] = est
    out["n_grid"] = int(len(est.rot_grid))
    out["padded_to"] = out["n_grid"] + (-out["n_grid"]) % est._hyp_quantum()

    # ---- the full-frame preprocess, rows sharded with the halo, bit for bit
    K_t = torch.tensor(scene["K"], dtype=torch.float32, device="cuda")
    depth_t = torch.tensor(scene["depth"], dtype=torch.float32, device="cuda")
    d1, x1 = preprocess_depth(depth_t, K_t)
    d2, x2 = preprocess_depth(depth_t, K_t, mesh)
    out["preprocess"] = {
        "bit_equal": bool(torch.equal(d1, d2) and torch.equal(x1, x2)),
        "rows_per_rank": depth_t.shape[0] // mesh.size("batch"),
        "ms_unsharded": mean_ms(torch, lambda: preprocess_depth(depth_t, K_t), MD_TIMED),
        "ms_sharded": mean_ms(torch, lambda: preprocess_depth(depth_t, K_t, mesh), MD_TIMED)}

    # ---- the scorer on the same 256 poses (the float32 run's ranked poses,
    # padded as register pads them), sharded against unsharded
    e = ests["sharded_float32"]
    poses = np.concatenate([e.poses, e.poses[:out["padded_to"] - out["n_grid"]]])
    poses_t = torch.tensor(poses, dtype=torch.float32, device="cuda")
    rgb_t = torch.tensor(scene["rgb"], dtype=torch.float32, device="cuda")
    out["scorer"] = {}
    for dtype in ("float32", "bfloat16"):
        sc = ests[f"sharded_{dtype}"]
        call = lambda dm=None: sc.scorer.score(  # noqa: E731
            sc.mesh_tensors, rgb_t, x1, K_t, poses_t, float(sc.diameter), device_mesh=dm)
        out["scorer"][dtype] = {
            "max_abs_diff": (call() - call(mesh)).abs().max().item(),
            "ms_unsharded": mean_ms(torch, call, 3),
            "ms_sharded": mean_ms(torch, lambda: call(mesh), 3)}

    # ---- K1 at this rank's shard shapes: the refine and learned-score slice
    # (no normals, culled as the watertight mesh is), the geometric score's
    # slice with its wrapped one-hypothesis halo (with normals)
    e = ests["sharded_bfloat16"]
    cull, r = e.refiner.cfg.backface_cull, mesh.index("batch")
    rows = []
    for name, p, normals in (("refine / learned-score shard", shard_batch(mesh, poses_t), False),
                             ("geometric-score shard + halo",
                              shard_rows(mesh, poses_t, 1, wrap=True)[0], True)):
        tfs = geo.compute_crop_window_tf_batch(p, K_t, e.refiner.cfg.crop_ratio,
                                               float(e.diameter), (S, S))
        rows.append(md_kernels(torch, raster, raster_cuda, e.mesh_tensors, p, K_t, tfs, cull,
                               normals, f"multi_device rank {r}: register {name}"))
    out["kernels"] = rows


def md_ba(torch, mesh, tmp, out, res):
    """``bundle_adjust`` on the slam phase's keyframe problem, unsharded and
    with the landmarks split."""
    from foundationpose_tpu_torch.slam import ba as ba_mod

    p = np.load(os.path.join(tmp, "ba.npz"))
    prob = [p[k] for k in ("poses", "X", "kf", "pt", "w", "n")]
    cfg = ba_mod.BAConfig()
    for kind, kw in (("one", dict(device="cuda")), ("sharded", dict(mesh=mesh))):
        (poses, X, costs), ms = timed(torch, lambda: ba_mod.bundle_adjust(
            *prob[:5], obs_n=prob[5], config=cfg, **kw))
        res.update({f"ba_{kind}_poses": poses.cpu().numpy(), f"ba_{kind}_X": X.cpu().numpy(),
                    f"ba_{kind}_costs": costs.cpu().numpy()})
        out[f"ba_{kind}_ms"] = ms


def md_dp_refiner(torch, raster, raster_cuda, mesh, out, res):
    """The data-parallel refiner step at the training phase's width (160 px,
    global batch 32, float32, the corpus trainer's optimiser: warmup, clip at
    global norm 1, non-finite skip) on the training phase's corpus: each
    rank's slice from ``make_refine_batch(mesh=)`` (3 render calls of
    B = 32 / world), MD_DP_STEPS steps sharded against the same steps
    unsharded from the same initial weights; then per-rank stage times."""
    from foundationpose_tpu_torch.apps.train_agnostic import K_TRAIN
    from foundationpose_tpu_torch.core import geometry as geo
    from foundationpose_tpu_torch.models import agnostic, convert, datagen, training
    from foundationpose_tpu_torch.models.refine_net import RefineNet
    from foundationpose_tpu_torch.parallel.mesh import all_reduce_grads

    prepped = agnostic.prepare_corpus(TRAIN_MESHES, seed=7, max_faces=2048, device="cuda")
    p = max((q for q in prepped if q["textured"]), key=lambda q: int(q["mt"]["faces"].shape[0]))
    K = torch.tensor(K_TRAIN, dtype=torch.float32, device="cuda")
    diam_t = torch.tensor(p["diameter"], dtype=torch.float32, device="cuda")
    world = mesh.size("batch")

    def batch(step, dm):
        g = torch.Generator(device="cuda").manual_seed(100 + step)  # alike on every rank
        return datagen.make_refine_batch(g, p["mt"], K, p["diameter"], batch=MD_DP_BATCH,
                                         input_size=S, augment=True, mesh=dm)

    def run(dm):
        net = convert.flax_init(RefineNet(c_in=6), 0).cuda()
        opt = agnostic.corpus_optimizer(net, 2e-4, TRAIN_STEPS)
        losses, grads = [], []
        for step in range(MD_DP_STEPS):
            losses.append(training.refiner_train_step_multimesh(net, opt, batch(step, dm), diam_t,
                                                                mesh=dm))
            grads.append(torch.cat([q.grad.reshape(-1) for q in net.parameters()]))
        return torch.stack(losses).tolist(), grads, net, opt

    reset_launches(raster_cuda)
    l1, g1, _, _ = run(None)
    out["dp_one_launches"] = dict(raster_cuda.LAUNCHES)
    reset_launches(raster_cuda)
    l2, g2, net, opt = run(mesh)
    out["dp_sharded_launches"] = dict(raster_cuda.LAUNCHES)
    # step 1's gradient once more in this process alone at the sharded batch
    # size: the sum over the world's slices of the unsharded batch of each
    # slice's gradient. The sharded gradient differs from it only by the
    # all-reduce's order of summation; from the unsharded one also by the
    # nets' kernels at another batch size
    ref = convert.flax_init(RefineNet(c_in=6), 0).cuda()
    full, per = batch(0, None), MD_DP_BATCH // world
    for k in range(world):
        part = {key: v[k * per:(k + 1) * per] for key, v in full.items()}
        (training.refiner_loss(ref, part, diam_t) / world).backward()
    g_same = torch.cat([q.grad.reshape(-1) for q in ref.parameters()])
    res["dp_losses"] = np.array(l2)
    out["dp"] = {"losses_unsharded": l1, "losses_sharded": l2,
                 "loss_rel_diff": [abs(a - b) / abs(a) for a, b in zip(l1, l2)],
                 "grad_max_abs_diff_of_norm": [((a - b).abs().max() / a.norm()).item()
                                               for a, b in zip(g1, g2)],
                 "grad_vs_same_batch_max_abs_diff_of_norm":
                     ((g2[0] - g_same).abs().max() / g_same.norm()).item(),
                 "grad_norm": [a.norm().item() for a in g1],
                 "batch_per_rank": per, "mesh_faces": int(p["mt"]["faces"].shape[0])}

    # ---- K1 at this rank's slice: hypotheses and ground truth rendered into
    # the hypotheses' windows, lit, unculled, no normals
    data = batch(0, mesh)
    tfs = geo.compute_crop_window_tf_batch(data["poseA"], K, 1.2, p["diameter"], (S, S))
    r = mesh.index("batch")
    out["dp_kernels"] = [md_kernels(torch, raster, raster_cuda, p["mt"], data[k], K, tfs, False,
                                    False, f"multi_device rank {r}: DP refiner slice, {k}")
                         for k in ("poseA", "poseB")]

    # ---- per-rank stage times of the sharded step
    st = Stages(torch)
    for i in range(MD_TIMED):
        st.start()
        data = batch(MD_DP_STEPS + i, mesh)
        st.mark("data (3 render calls + augmentation)")
        for q in opt.params:
            q.grad = None
        loss = training.refiner_loss(net, data, diam_t) / world
        st.mark("forward")
        loss.backward()
        st.mark("backward")
        nbytes = all_reduce_grads(mesh, opt.params)
        st.mark("all_reduce")
        opt.step()
        st.mark("optimizer")
    out["dp"].update(stage_ms=st.mean(MD_TIMED), all_reduce_bytes=nbytes)


def md_field(torch, mesh, args, out, res):
    """The field step at ``FieldConfig()`` widths on the field phase's frames,
    sharded over the rays (2048 / world per rank): MD_FIELD_STEPS triplane
    steps and one hash step at the field phase's hash widths, each held
    against the unsharded step from the same state on the same draws (loss
    and gradients); the all-reduce's size and time, and rays/s per rank."""
    from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner
    from foundationpose_tpu_torch.parallel.mesh import all_reduce_grads

    def grads(r):
        return torch.cat([q.grad.reshape(-1) for q in r.field.parameters()])

    def copy_state(src, dst):
        dst.field.load_state_dict(src.field.state_dict())
        for a, b in ((src.opt, dst.opt), (src.opt_pose, dst.opt_pose)):
            if a is not None:
                b.load_state_dict({k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                                   for k, v in a.state_dict().items()})

    world = mesh.size("batch")
    out["field"] = {}
    for enc, steps in (("triplane", MD_FIELD_STEPS), ("hash", 1)):
        cfg = FieldConfig(encoder=enc)
        one = NeRFRunner(cfg, *args, device="cuda")
        sh = NeRFRunner(cfg, *args, device="cuda", device_mesh=mesh)
        rows = []
        for _ in range(steps):
            copy_state(sh, one)
            d = one.draw()
            l1, _ = one.train_step(d)
            g1 = grads(one)
            l2, _ = sh.train_step(d)
            g2 = grads(sh)
            rows.append({"loss_unsharded": float(l1), "loss_sharded": float(l2),
                         "loss_rel_diff": abs(float(l1) - float(l2)) / abs(float(l1)),
                         "grad_max_abs_diff_of_norm": ((g1 - g2).abs().max() / g1.norm()).item()})
        nbytes = all_reduce_grads(mesh, sh.field.parameters())
        n_ar = MD_TIMED if enc == "triplane" else 2
        row = {"steps": rows, "rays_per_rank": cfg.n_rand // world, "all_reduce_bytes": nbytes,
               "all_reduce_ms": mean_ms(torch, lambda: all_reduce_grads(
                   mesh, sh.field.parameters()), n_ar)}
        res[f"field_{enc}_losses"] = np.array([r_["loss_sharded"] for r_ in rows])
        if enc == "triplane":
            step_ms = mean_ms(torch, sh.train_step, MD_TIMED)
            row.update(step_ms=step_ms, rays_per_s_per_rank=cfg.n_rand / world / (step_ms / 1e3))
        out["field"][enc] = row
        del one, sh
        torch.cuda.empty_cache()


def md_multi(torch, demo, raster, raster_cuda, mesh, scene, out, res):
    """The multi-object phase's 4 objects and step (2 refine iterations) with
    a float32 copy of the shipped RefineNet, unsharded and with the objects
    split over the ranks; K1 at each of this rank's objects' shape."""
    from foundationpose_tpu_torch.core import geometry as geo
    from foundationpose_tpu_torch.engine.multi import MultiObjectTracker
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner
    from foundationpose_tpu_torch.models.agnostic import load_agnostic

    meshes, names, _, rgbs, depths, Ks, start = multi_inputs(demo, raster, scene)
    refiner, _, _ = load_agnostic(demo.default_weights_dir(), device="cuda")
    r32 = PoseRefiner(dataclasses.replace(refiner.cfg, dtype="float32"), device="cuda")
    r32.net.load_state_dict(refiner.net.state_dict())
    for kind, dm in (("one", None), ("sharded", mesh)):
        tracker = MultiObjectTracker(meshes, refiner=r32, device="cuda", device_mesh=dm)
        tracker.set_poses(start)
        tracker.track(rgbs, depths, Ks, iteration=2)  # warm
        tracker.set_poses(start)
        reset_launches(raster_cuda)
        poses, ms = timed(torch, lambda: tracker.track(rgbs, depths, Ks, iteration=2))
        out[f"multi_{kind}_launches"] = dict(raster_cuda.LAUNCHES)
        out[f"multi_{kind}_ms"] = ms
        res[f"multi_{kind}_poses"] = poses
    mine = tracker.mine
    part = MultiObjectTracker(meshes[mine], refiner=r32, device="cuda")
    part.set_poses(start[mine])
    out["multi_own_objects_poses"] = part.track(rgbs[mine], depths[mine], Ks[mine],
                                                iteration=2).tolist()
    cfg, r = r32.cfg, mesh.index("batch")
    out["multi_objects"] = [names[o] for o in range(mine.start, mine.stop)]
    out["multi_slice"] = [mine.start, mine.stop]
    rows = []
    for o, mt in zip(range(tracker.mine.start, tracker.mine.stop), tracker.mesh_tensors):
        pose = torch.tensor(start[o:o + 1], dtype=torch.float32, device="cuda")
        pose = pose @ torch.tensor(tracker._center_tf(o, +1.0), dtype=torch.float32,
                                   device="cuda")
        K = torch.tensor(Ks[o], dtype=torch.float32, device="cuda")
        tfs = geo.compute_crop_window_tf_batch(pose, K, cfg.crop_ratio,
                                               float(tracker.diameters[o]), (S, S))
        rows.append(md_kernels(torch, raster, raster_cuda, mt, pose, K, tfs, cfg.backface_cull,
                               False, f"multi_device rank {r}: multi-object {names[o]}"))
    out["multi_kernels"] = rows


def md_scaling(torch, demo, multihost, mesh, scene, field_args, out):
    """The counterpart of the JAX dry run's scaling table
    (``__graft_entry__.py:204-271``): register hyp/s (fixed work, 252
    hypotheses, the shipped bf16 nets) and field rays/s (2048 rays per rank,
    ``FieldConfig()``) at world 1 — rank 0 alone, the others waiting — and
    at world = every rank, each rank timing itself."""
    from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner

    args = (scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    world = mesh.size("batch")

    def register_rate(dm):
        est = demo.build_estimator(scene["mesh"], device="cuda", device_mesh=dm)
        est.register(*args)
        if dm is not None:
            multihost.sync_hosts()
        ms = mean_ms(torch, lambda: est.register(*args), 3)
        return {"ms": ms, "hyp_per_s": len(est.rot_grid) / (ms / 1e3)}

    def field_rate(dm, n_rand):
        runner = NeRFRunner(FieldConfig(n_rand=n_rand), *field_args, device="cuda",
                            device_mesh=dm)
        runner.train_step()
        if dm is not None:
            multihost.sync_hosts()
        ms = mean_ms(torch, runner.train_step, MD_TIMED)
        return {"n_rand": n_rand, "step_ms": ms, "rays_per_s": n_rand / (ms / 1e3)}

    table = {}
    if mesh.index("batch") == 0:
        table["1"] = {"register": register_rate(None)}
        if field_args is not None:
            table["1"]["field"] = field_rate(None, FieldConfig().n_rand)
    multihost.sync_hosts()
    table[str(world)] = {"register": register_rate(mesh)}
    if field_args is not None:
        table[str(world)]["field"] = field_rate(mesh, FieldConfig().n_rand * world)
    out["scaling"] = table


def md_rank(rank, coord, tmp, backend, world=MD_WORLD):
    """One rank of the multi_device phase (run in its own process). With
    nccl and more ranks than cards it only tries one all_reduce (NCCL refuses
    two ranks on one device). Otherwise it runs each sharded program of the
    port against the same program unsharded, in this process, and writes what
    it got to ``tmp``: ``register`` (its preprocess, scorer and K1 at its shard
    shapes), BA when ``tmp`` holds the slam phase's problem, the data-parallel
    refiner step, the field step when ``tmp`` holds the field phase's frames,
    the multi-object step, and the scaling table."""
    import torch

    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.ops import raster, raster_cuda
    from foundationpose_tpu_torch.parallel import multihost

    multihost.initialize(coord, num_processes=world, process_id=rank, device="cuda",
                         backend=backend)
    if backend == "nccl" and world > torch.cuda.device_count():
        x = torch.ones(4, device="cuda")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        print(f"RANK{rank}_NCCL_ALL_REDUCE {x.tolist()}", flush=True)
        return
    mesh = multihost.make_global_mesh(("batch",))
    out = {"rank": rank, "device": str(multihost.local_device()),
           "backend": torch.distributed.get_backend(),
           "world": multihost.process_count(), "card": torch.cuda.get_device_name()}
    res = {}
    t0 = time.perf_counter()

    def done(part):
        out.setdefault("part_s", {})[part] = time.perf_counter() - t0
        print(f"RANK{rank} {part} done at {out['part_s'][part]:.1f} s", flush=True)

    scene = demo.make_scene((480, 640), device="cuda")
    md_register(torch, demo, raster, raster_cuda, multihost, mesh, scene, out, res)
    done("register")
    if os.path.exists(os.path.join(tmp, "ba.npz")):
        md_ba(torch, mesh, tmp, out, res)
        done("bundle_adjust")
    md_dp_refiner(torch, raster, raster_cuda, mesh, out, res)
    done("dp_refiner")
    field_args = None
    if os.path.exists(os.path.join(tmp, "field.npz")):
        f = np.load(os.path.join(tmp, "field.npz"))
        field_args = field_runner_inputs(f["images"], f["depth_mm"], f["masks"],
                                         f["ob_in_cams"], f["K"])
        done("field inputs")
        md_field(torch, mesh, field_args, out, res)
        done("field")
    md_multi(torch, demo, raster, raster_cuda, mesh, scene, out, res)
    done("multi_object")
    md_scaling(torch, demo, multihost, mesh, scene, field_args, out)
    done("scaling")
    multihost.sync_hosts()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"RANK{rank}_OK", flush=True)


def float32_nets(refiner, scorer):
    """Copies of a learned-hybrid estimator's nets computing in float32."""
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner
    from foundationpose_tpu_torch.engine.scorer import HybridScorer, PoseScorer

    r32 = PoseRefiner(dataclasses.replace(refiner.cfg, dtype="float32"), device="cuda")
    r32.net.load_state_dict(refiner.net.state_dict())
    s32 = PoseScorer(dataclasses.replace(scorer.learned.cfg, dtype="float32"), device="cuda")
    s32.net.load_state_dict(scorer.learned.net.state_dict())
    return r32, HybridScorer(s32, geo_config=scorer.geo_cfg, weight=scorer.weight)


def launch_ranks(tmp, backend, world=MD_WORLD):
    """Start ``world`` processes of ``md_rank``; wait at most MD_TIMEOUT s,
    then stop every one still running. Returns [(returncode or None when
    stopped, output tail)]."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                f"chip_smoke.md_rank({r}, 'localhost:{port}', {tmp!r}, {backend!r}, {world})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.perf_counter() + MD_TIMEOUT
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            results.append((p.returncode, out[-3000:]))
        except subprocess.TimeoutExpired:
            results.append((None, "stopped at the time limit"))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return results


def ranked_diff(a_scores, a_poses, b_scores, b_poses, tol):
    """(largest score difference, largest pose difference, entries matched out
    of place) of two ranked lists. Neighbours scored within ``tol`` of each
    other may trade places: an entry that differs from its slot is matched
    among the other list's entries scored within ``tol`` of it."""
    worst, moved = 0.0, 0
    for i, d in enumerate(np.abs(a_poses - b_poses).max(axis=(1, 2))):
        if d > tol:
            near = np.nonzero(np.abs(b_scores - a_scores[i]) <= tol)[0]
            d = min((np.abs(a_poses[i] - b_poses[j]).max() for j in near), default=d)
            moved += 1
        worst = max(worst, float(d))
    return float(np.abs(a_scores - b_scores).max()), worst, moved


def md_gates(i, x, world, backend):
    """The failed gates of one rank's results (``i``: its JSON, ``x``: its
    arrays), as strings."""
    bad = []
    for dtype in ("float32", "bfloat16"):
        if not np.isfinite(x[f"sharded_{dtype}_scores"]).all():
            bad.append(f"register {dtype}: non-finite scores")
        if set(i[f"sharded_{dtype}_launches"].values()) != {11}:
            bad.append(f"register {dtype}: {i[f'sharded_{dtype}_launches']} launches, not 11")
    ds, dp, _ = ranked_diff(x["sharded_float32_scores"], x["sharded_float32_poses"],
                            x["one_float32_scores"], x["one_float32_poses"], MD_REGISTER_TOL)
    dpose = float(np.abs(x["sharded_float32_pose"] - x["one_float32_pose"]).max())
    if max(ds, dp, dpose) > MD_REGISTER_TOL:
        bad.append(f"register float32: ranked list {ds}, {dp}, pose {dpose}")
    if not (len(x["sharded_float32_scores"]) == i["n_grid"] == 252 and i["padded_to"] == 256):
        bad.append(f"register: {i['n_grid']} hypotheses padded to {i['padded_to']}")
    if not i["preprocess"]["bit_equal"]:
        bad.append("the row-sharded preprocess differs from the unsharded one")
    if i["scorer"]["float32"]["max_abs_diff"] > MD_SCORE_TOL:
        bad.append(f"sharded scorer (float32): {i['scorer']['float32']['max_abs_diff']}")
    if "ba_sharded_poses" in x and float(
            np.abs(x["ba_sharded_poses"] - x["ba_one_poses"]).max()) > MD_BA_TOL:
        bad.append("BA: sharded poses differ")
    dp_ = i["dp"]
    if (max(dp_["loss_rel_diff"]) > MD_LOSS_RTOL
            or dp_["grad_max_abs_diff_of_norm"][0] > MD_GRAD_TOL
            or dp_["grad_vs_same_batch_max_abs_diff_of_norm"] > MD_GRAD_TOL
            or not np.isfinite(dp_["losses_sharded"]).all()):
        bad.append(f"DP refiner step: {dp_}")
    n_dp = 3 * MD_DP_STEPS
    if set(i["dp_one_launches"].values()) != {n_dp} or set(
            i["dp_sharded_launches"].values()) != {n_dp}:
        bad.append(f"DP refiner step launches {i['dp_one_launches']} / "
                   f"{i['dp_sharded_launches']}, not {n_dp}")
    for enc, row in i.get("field", {}).items():
        for st in row["steps"]:
            if (st["loss_rel_diff"] > MD_LOSS_RTOL or not np.isfinite(st["loss_sharded"])
                    or st["grad_max_abs_diff_of_norm"] > MD_GRAD_TOL):
                bad.append(f"field step ({enc}): {st}")
    mine = x["multi_sharded_poses"][i["multi_slice"][0]:i["multi_slice"][1]]
    if (float(np.abs(mine - np.array(i["multi_own_objects_poses"])).max()) > MD_MULTI_TOL
            or float(np.abs(x["multi_sharded_poses"] - x["multi_one_poses"]).max())
            > MD_MULTI_BATCH_TOL):
        bad.append("multi-object: sharded poses differ")
    if set(i["multi_one_launches"].values()) != {8} or set(
            i["multi_sharded_launches"].values()) != {8 // world}:
        bad.append(f"multi-object launches {i['multi_one_launches']} / "
                   f"{i['multi_sharded_launches']}, not 8 / {8 // world}")
    for row in i["scaling"].values():
        for v in row.values():
            if not (np.isfinite(list(v.values())).all() and min(v.values()) > 0):
                bad.append(f"scaling table: {v}")
    if i["backend"] != backend or i["world"] != world:
        bad.append(f"backend {i['backend']}, world {i['world']}")
    return bad


def run_multi_device(torch, raster_cuda, ba_problem, smi, field_in, backend="gloo",
                     world=MD_WORLD):
    """``world`` ranks (``multihost.initialize(..., backend=backend)``; by
    default two ranks on the one card over gloo), each running every sharded
    program against the same program unsharded (``md_rank``): the
    learned-hybrid ``register`` (252 hypotheses, 160 px, bf16 and float32
    nets; preprocess row-sharded, scorer sharded, K1 at the rank's shard
    shapes), ``bundle_adjust`` on the slam phase's keyframes (``ba_problem``,
    when given), the data-parallel refiner step, the field step on the field
    phase's frames (``field_in``), the 4-object tracker step split 2 + 2, and
    the scaling table. Gates (``md_gates``): float32 runs equal to the
    unsharded ones within the MD_* tolerances, the preprocess bit for bit,
    every rank's launch counts, the ranks' results equal. Then, over gloo,
    the same two ranks over nccl, expected to be refused (two ranks on one
    device). Over gloo on one card it checks the code path, not NCCL and not
    scaling. Returns the launch counts by path, summed over the ranks."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if ba_problem is not None:
            np.savez(os.path.join(tmp, "ba.npz"), poses=ba_problem["poses_ob_in_cam"],
                     X=ba_problem["landmarks"], kf=ba_problem["obs_kf"], pt=ba_problem["obs_pt"],
                     w=ba_problem["obs_w"], n=ba_problem["obs_n"])
        if field_in is not None:
            np.savez(os.path.join(tmp, "field.npz"), **{k: field_in[k] for k in (
                "images", "depth_mm", "masks", "ob_in_cams", "K")})
        ranks = launch_ranks(tmp, backend, world)
        for r, (rc, out) in enumerate(ranks):
            if rc != 0 or f"RANK{r}_OK" not in out:
                fail(f"multi_device: {backend} rank {r} exited {rc}:\n{out}")
        info = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]
        res = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]
        probe = launch_ranks(tmp, "nccl") if backend == "gloo" else None
    rows, failed = [], []
    for r, (i, x) in enumerate(zip(info, res)):
        row = {**{k: v for k, v in i.items()
                  if not k.endswith("_launches") and k != "multi_own_objects_poses"},
               "launches": {k: v for k, v in i.items() if k.endswith("_launches")}}
        for dtype in ("float32", "bfloat16"):
            ds, dp, swapped = ranked_diff(x[f"sharded_{dtype}_scores"], x[f"sharded_{dtype}_poses"],
                                          x[f"one_{dtype}_scores"], x[f"one_{dtype}_poses"],
                                          MD_REGISTER_TOL)
            row[dtype] = {"scores_max_abs_diff": ds, "poses_max_abs_diff": dp,
                          "reordered_ties": swapped,
                          "pose_max_abs_diff": float(np.abs(x[f"sharded_{dtype}_pose"]
                                                            - x[f"one_{dtype}_pose"]).max())}
        if "ba_one_poses" in x:
            row.update({
                "ba_poses_max_abs_diff": float(np.abs(x["ba_sharded_poses"]
                                                      - x["ba_one_poses"]).max()),
                "ba_X_max_abs_diff": float(np.abs(x["ba_sharded_X"] - x["ba_one_X"]).max()),
                "ba_costs": [x["ba_one_costs"].tolist(), x["ba_sharded_costs"].tolist()]})
        row["multi_poses_max_abs_diff"] = float(np.abs(x["multi_sharded_poses"]
                                                       - x["multi_one_poses"]).max())
        row["multi_own_objects_max_abs_diff"] = float(np.abs(
            x["multi_sharded_poses"][slice(*i["multi_slice"])]
            - np.array(i["multi_own_objects_poses"])).max())
        rows.append(row)
        failed += [f"rank {r}: {b}" for b in md_gates(i, x, world, backend)]
    across = max(float(np.abs(res[0][k] - x[k]).max()) for x in res[1:] for k in res[0])
    if across > 1e-5:
        failed.append(f"the ranks' results differ by {across}")
    # the scaling table: world 1 from rank 0 alone; at full world, the slowest rank
    scaling = {"1": info[0]["scaling"]["1"], str(world): {}}
    for prog, rate in (("register", "hyp_per_s"), ("field", "rays_per_s")):
        if prog in info[0]["scaling"][str(world)]:
            scaling[str(world)][prog] = min((i["scaling"][str(world)][prog] for i in info),
                                            key=lambda v: v[rate])
    extra = {}
    if probe is not None:
        extra["nccl"] = {"refused": all(rc != 0 for rc, _ in probe),
                         "exit_codes": [rc for rc, _ in probe],
                         "errors": [[ln for ln in o.splitlines() if "rror" in ln][-2:]
                                    for _, o in probe]}
    say("multi_device", backend=backend, world=world, device=info[0]["device"], ranks=rows,
        ranks_max_abs_diff=across, scaling=scaling, **extra, failed_gates=failed,
        reduced=[f"DP refiner: {MD_DP_STEPS} steps (train_agnostic's default 20000)",
                 f"field: {MD_FIELD_STEPS} triplane steps and 1 hash step (FieldConfig().n_step "
                 "1000)", "multi-object: one step of 2 iterations"],
        phase_s=time.perf_counter() - t_phase,
        checks=(f"torch.distributed collectives between {world} processes over {backend}"
                + (" on ONE card: the code path, not NCCL, not scaling" if backend == "gloo"
                   and torch.cuda.device_count() == 1 else "")),
        gate=f"register with float32 nets: ranked list and scores within {MD_REGISTER_TOL} of the "
             f"unsharded run (neighbours within {MD_REGISTER_TOL} may trade places), 252 "
             "hypotheses padded to 256, 11 + 11 launches per rank with either net precision; "
             "the row-sharded preprocess bit for bit; the sharded scorer on the same poses "
             f"within {MD_SCORE_TOL} (float32 nets); BA poses within {MD_BA_TOL}; DP refiner "
             f"and field steps: losses at rtol {MD_LOSS_RTOL}, all-reduced gradients within "
             f"{MD_GRAD_TOL} x the norm of the unsharded ones (DP: also of the same step at the "
             "sharded batch size in one process); multi-object poses within "
             f"{MD_MULTI_TOL} of an unsharded tracker over the rank's own objects and within "
             f"{MD_MULTI_BATCH_TOL} of one over all four (RefineNet's batch rounds otherwise), "
             "8 / world launches per rank; K1s + K1r at every shard "
             "shape at the kernel gates; ranks equal. The bf16 nets' differences are printed",
        card=smi)
    if failed:
        fail("multi_device: " + "; ".join(failed))

    def summed(key):
        total = {}
        for i in info:
            add_counts(total, i[key])
        return total

    return {f"multi_device: sharded register on {world} ranks ({backend})":
            summed("sharded_bfloat16_launches"),
            f"multi_device: data-parallel refiner steps on {world} ranks ({backend})":
            summed("dp_sharded_launches"),
            f"multi_device: sharded multi-object step on {world} ranks ({backend})":
            summed("multi_sharded_launches")}


SURFACE_SHAPES = ("textured4096_B256_112px", "main_B256_160px")  # profile_raster's, lead first
SURFACE_REPS = 30


def corners_equal(a, b, tol=1e-6):
    """Two meshes have the same faces, corner by corner (a mesh file read
    back may number its vertices otherwise)."""
    return a.faces.shape == b.faces.shape and bool(
        np.abs(a.vertices[a.faces] - b.vertices[b.faces]).max() <= tol)


def run_surface_phase(torch, raster_cuda, k1_parts, smi):
    """``demo_synthetic.main(["--out-dir", ..., "--frames", "1"])`` on the
    card, launches counted from zero, its seven artefacts checked against
    the scene it renders; ``profile_raster`` at the 4096-face textured shape
    and the main path's, its rows printed beside their bounds; and the
    default build is the library every path launched: every launch function
    this process called lies, by its address, in the library of a source
    built with no part switch, and in no part's. Returns the demo's launch
    counts."""
    import tempfile

    from foundationpose_tpu_torch.apps import demo_synthetic as demo, profile_raster
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.io import png

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(raster_cuda)
        err = demo.main(["--out-dir", tmp, "--frames", "1"])
        # scene + frame renders (1 + 1), register (11), one tracked frame (4)
        launches = expect_launches(raster_cuda, dict.fromkeys(raster_cuda.LAUNCHES, 0), 17,
                                   "demo_synthetic --out-dir, 1 frame")
        demo_s = time.perf_counter() - t0
        missing = [f for f in demo.ARTEFACTS if not os.path.isfile(os.path.join(tmp, f))]
        if missing:
            fail(f"surface: demo_synthetic --out-dir wrote no {missing}")
        scene = demo.make_scene((480, 640), device="cuda")
        art = lambda f: os.path.join(tmp, f)  # noqa: E731
        checks = {
            "rgb.png": np.array_equal(png.read_png(art("rgb.png")), scene["rgb"]),
            "mask.png": np.array_equal(png.read_png(art("mask.png")),
                                       scene["mask"].astype(np.uint8) * 255),
            "depth.npy": np.array_equal(np.load(art("depth.npy")), scene["depth"]),
            "cam_K.txt": np.array_equal(np.loadtxt(art("cam_K.txt")), scene["K"]),
            "gt_pose.txt": np.array_equal(np.loadtxt(art("gt_pose.txt")), scene["gt"]),
            "object.obj": corners_equal(meshio.load_obj(art("object.obj")), scene["mesh"]),
            "vis_register.png": png.read_png(art("vis_register.png")).shape == scene["rgb"].shape,
        }
        if not all(checks.values()):
            fail(f"surface: demo artefacts differ from the scene it renders: {checks}")
    diameter = meshio.compute_mesh_diameter(mesh=scene["mesh"])
    if not err <= ADDS_GATE * diameter:
        fail(f"surface: demo register ADD-S {err * 1000:.2f} mm over {ADDS_GATE:.0%} of the "
             f"{diameter * 1000:.0f} mm diameter")

    t1 = time.perf_counter()
    rows = profile_raster.run(SURFACE_SHAPES, reps=SURFACE_REPS, parts=k1_parts)
    profile_s = time.perf_counter() - t1

    # the default build is what every path launched: the files the dynamic
    # loader places every launch function in that this process called, from
    # the first phase to the demo and the timer's whole calls, are the
    # libraries of the sources built with no switch, and no part's
    specs = raster_cuda.default_specs()
    if any(f.startswith("-D") for _, flags in specs.values() for f in flags):
        fail("surface: the default build defines a switch")
    expected = {name: os.path.realpath(raster_cuda.library_path(name, *spec))
                for name, spec in specs.items()}
    part_files = {k: os.path.realpath(v) for k, v in k1_parts[2].items() if k not in expected}
    launched = raster_cuda.launched_libraries()
    if launched != {name: {f} for name, f in expected.items()}:
        fail(f"surface: the render calls launched {launched}, not the default build {expected}")
    if set(part_files.values()) & set(expected.values()) or len(part_files) != 4:
        fail(f"surface: the parts' libraries {part_files} are not apart from the default build")
    timed_full = {"K1s": raster_cuda.library_file(k1_parts[0]["setup+bins"]),
                  "K1r": raster_cuda.library_file(k1_parts[1]["+staged stores"])}
    if timed_full != expected:
        fail(f"surface: the parts timer's full kernels {timed_full} are not the ones the "
             f"paths launch {expected}")
    say("surface", demo={"artefacts": checks, "add_s_mm": err * 1000, "launches": launches,
                         "seconds": demo_s},
        profile_raster={"shapes": list(SURFACE_SHAPES), "reps": SURFACE_REPS,
                        "seconds": profile_s,
                        "rows": [{"shape": r["shape"], "call": r["call"], "parts": r["parts"],
                                  "checks": r["checks"]} for r in rows]},
        default_build={"launched": {k: sorted(os.path.basename(f) for f in v)
                                    for k, v in launched.items()},
                       "parts": {k: os.path.basename(v) for k, v in part_files.items()}},
        seconds=time.perf_counter() - t0, card=smi)
    return launches


def md_cards(world=4):
    """The multi_device phase alone over nccl, one rank per card, on a
    machine with ``world`` cards (not run by ``main``, which needs one card):

        python -c "import chip_smoke; chip_smoke.md_cards(4)"

    Builds the kernels, renders the field phase's frames and runs every
    sharded program of the phase (BA, which needs the slam phase, is left
    out) with its gates; prints the phase's line."""
    import torch

    from foundationpose_tpu_torch import native
    from foundationpose_tpu_torch.apps import demo_synthetic as demo
    from foundationpose_tpu_torch.ops import raster, raster_cuda

    if torch.cuda.device_count() < world:
        fail(f"md_cards({world}) needs {world} cards, found {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    raster_cuda.build()
    native.build()
    views = field_views(demo, raster, raster_cuda)
    run_multi_device(torch, raster_cuda, None, smi, views, backend="nccl", world=world)


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
    # (one compiler process per source, side by side), and the port's host
    # library (g++, pose clustering)
    from foundationpose_tpu_torch import native
    from foundationpose_tpu_torch.apps import profile_raster

    t0 = time.perf_counter()
    gxx = subprocess.Popen([sys.executable, "-c", "from foundationpose_tpu_torch import native; "
                            "native.build()"], cwd=os.path.dirname(os.path.abspath(__file__)))
    # K1s, K1r and their parts (the surface phase times them): every nvcc at once
    k1_parts = profile_raster.build_parts(raster_cuda.BUILD_LOG)
    nvcc_s = time.perf_counter() - t0
    if gxx.wait() != 0:
        fail("the host library native/cluster.cpp did not build (is g++ installed?)")
    native.build()
    sources = {k: os.path.relpath(src, os.path.dirname(os.path.abspath(__file__)))
               for k, (src, _) in raster_cuda.SOURCES.items()}
    say("build", kernels=sources, seconds=time.perf_counter() - t0,
        host_library={"source": os.path.relpath(native.SOURCE, os.path.dirname(
            os.path.abspath(__file__))), "compiler": shutil.which("g++"), "flags": native.FLAGS},
        nvcc_seconds=nvcc_s,
        ptxas={k: [l for l in log.splitlines() if "registers" in l or "spill" in l]
               for k, log in raster_cuda.BUILD_LOG.items()})

    scene = demo.make_scene((480, 640), device="cuda")
    k1 = check_kernels(scene, torch)
    suite_k = check_suite_kernels(torch, raster, raster_cuda)
    say("kernels", suite_full_frames=suite_k, gate=COMPARE_GATE + "; K1s: " + SETUP_GATE)

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
    by_path["evalsuite harness, 4 scenes x (geometric + learned_hybrid)"] = run_evalsuite(
        torch, metrics, raster, raster_cuda, smi)
    _, io_paths = run_io_apps(torch, demo, metrics, raster, raster_cuda, smi)
    by_path.update(io_paths)
    by_path["training stack (corpus trainers, resume, serve, harness fallback)"], train_k = \
        run_train(torch, raster, raster_cuda, scene, smi)
    by_path["run_field + true-mesh texture bake"], field_k, field_in = run_field_phase(
        torch, demo, raster, raster_cuda, smi)
    by_path["ModelFreeTracker: init, steps, retrains, pose-graph BA, finalize + bake"], slam_k, \
        ba_problem = run_slam_phase(torch, demo, raster, raster_cuda, smi)
    by_path.update(run_multi_device(torch, raster_cuda, ba_problem, smi, field_in))
    by_path["demo_synthetic --out-dir (render, register, 1 tracked frame)"] = \
        run_surface_phase(torch, raster_cuda, k1_parts, smi)
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
    train_rows = [{k: c[k] for k in ("case", "shape", "ms", "K1s_ms", "K1r_ms", "K1s_device_ms",
                                     "K1r_device_ms", "plain_ms", "K1s_plain_ms", "bound_ms",
                                     "bound_by", "pixel_face_tests")}
                  | {"K1s_bound_ms": c["K1s_bound"]["bound_ms"],
                     "K1r_bound_ms": c["K1r_bound"]["bound_ms"]}
                  for c in train_k["times"]]
    slam_rows = [{k: c[k] for k in ("case", "shape", "ms", "K1s_ms", "K1r_ms", "K1s_device_ms",
                                    "K1r_device_ms", "plain_ms", "K1s_plain_ms", "bound_ms",
                                    "bound_by", "pixel_face_tests")}
                 | {"K1s_bound_ms": c["K1s_bound"]["bound_ms"],
                    "K1r_bound_ms": c["K1r_bound"]["bound_ms"]}
                 for c in slam_k["times"]]
    bake = field_k["time"]
    bake_row = {k: bake[k] for k in ("case", "shape", "ms", "K1s_ms", "K1r_ms", "K1s_device_ms",
                                     "K1r_device_ms", "plain_ms", "K1s_plain_ms", "bound_ms",
                                     "bound_by", "pixel_face_tests")} \
        | {"K1s_bound_ms": bake["K1s_bound"]["bound_ms"],
           "K1r_bound_ms": bake["K1r_bound"]["bound_ms"]}
    kernels = [{
        "name": "K1s face setup and tile binning",
        "source": sources["K1s"],
        "replaces": "foundationpose_tpu/ops/raster_pallas.py:337",
        "launches": all_launches["K1s"],
        "launches_by_path": {k: v["K1s"] for k, v in by_path.items()},
        "launches_per_call": {k: v["K1s"] for k, v in PER_CALL.items()},
        "max_abs_err": max(k1["setup_worst"]["vtab_max_abs_err"],
                           suite_k["setup_worst"]["vtab_max_abs_err"],
                           train_k["kernels"]["setup_worst"]["vtab_max_abs_err"],
                           field_k["setup"]["vtab_max_abs_err"],
                           *(r["setup"]["vtab_max_abs_err"] for r in slam_k["rows"])),
        "worst": k1["setup_worst"], "worst_suite_full_frames": suite_k["setup_worst"],
        "worst_training_shapes": train_k["kernels"]["setup_worst"],
        "training_shapes": train_rows,
        "bake_shape": bake_row, "bake_shape_vs_plain": field_k["setup"],
        "tracker_shape": slam_rows,
        "tracker_shape_vs_plain": [r["setup"] for r in slam_k["rows"]],
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
        "max_abs_err": max(*k1["worst_abs_err"].values(), *suite_k["worst_abs_err"].values(),
                           *train_k["kernels"]["worst_abs_err"].values(),
                           *(field_k["raster"][f"{k}_max_abs_err"] for k in ("depth", "xyz", "rgb")),
                           field_k["raster"]["bary_max_abs_err"],
                           *(r["raster"][f"{k}_max_abs_err"] for r in slam_k["rows"]
                             for k in ("depth", "xyz", "rgb", "normal"))),
        "worst_abs_err": k1["worst_abs_err"],
        "worst_abs_err_training_shapes": train_k["kernels"]["worst_abs_err"],
        "max_winner_flips_training_shapes": train_k["kernels"]["max_winner_flips_of_common"],
        "training_shapes": train_rows,
        "bake_shape": bake_row, "bake_shape_vs_plain": field_k["raster"],
        "tracker_shape": slam_rows,
        "tracker_shape_vs_plain": [r["raster"] for r in slam_k["rows"]],
        "worst_abs_err_suite_full_frames": suite_k["worst_abs_err"],
        "max_winner_flips_suite_full_frames": suite_k["max_winner_flips_of_common"],
        "worst_abs_err_incl_winner_flips": k1["worst_abs_err_incl_winner_flips"],
        "max_winner_flips_of_common": k1["max_winner_flips_of_common"],
        "tolerance": COMPARE_GATE,
        "ms": main_row["K1r_ms"], "device_ms": main_row["K1r_device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["K1r_bound"]["bound_ms"],
        "bound_by": main_row["K1r_bound"]["bound_by"],
        "call_ms": main_row["ms"], "call_bound_ms": main_row["bound_ms"],
        "call_bound_by": main_row["bound_by"], "by_face_bucket": by_bucket,
        "full_frame_480x640_by_bucket": [
            {k: c[k] for k in ("case", "shape", "ms", "K1s_ms", "K1r_ms", "K1s_device_ms",
                               "K1r_device_ms", "plain_ms", "bound_ms", "bound_by")}
            | {"K1s_bound_ms": c["K1s_bound"]["bound_ms"], "K1r_bound_ms": c["K1r_bound"]["bound_ms"]}
            for c in suite_k["times_full_frame"]], **common,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
