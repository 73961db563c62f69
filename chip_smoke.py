#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main path — learned-hybrid ``register`` then ``track_one``
with the shipped object-agnostic checkpoint, 252 hypotheses, 160 px crops,
bf16 nets — through the entry points a user calls, builds every CUDA kernel
of that path from the sources in this checkout, and holds each kernel
against its plain PyTorch version on the card. Imports only
``foundationpose_tpu_torch``. Every phase prints one JSON line; any failed
phase exits non-zero. Without a CUDA device it exits 1 and prints no result.

Times are wall times around work that ends in ``torch.cuda.synchronize()``
(or CUDA events for the kernel table) and include the Python overhead of an
eager loop. Every number belongs to the card named in the ``device`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores. The kernel's bound is stated against
# these whatever the card's power limit, which is printed beside it.
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per pixel x face test that survives tile rejection:
# three barycentrics (2 mul + 2 add each) and three compares. The 1/z score
# of the tests that pass and the per-pixel attribute pass are counted apart.
OPS_PER_TEST = 15
OPS_PER_INSIDE = 6     # 3 mul + 2 add + 1 compare for the 1/z score
OPS_PER_HIT_PIXEL = 80  # winner gather + perspective-correct interpolation

ADDS_GATE = 0.10       # of the mesh diameter
TRACK_FRAMES = 5
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


def tensor_bytes(*trees):
    n = 0
    for tree in trees:
        vals = tree.values() if isinstance(tree, dict) else [tree]
        n += sum(v.numel() * v.element_size() for v in vals if hasattr(v, "numel"))
    return n


def k1_bound(raster_cuda, mesh_tensors, poses, K, tfs, inp, out, S):
    """Least time the card could take for one K1 call on these inputs: bytes
    (every input read once, every output written once) over the memory rate
    against float32 operations (the pixel x face tests left after tile
    rejection, the 1/z scores of the tests that pass — counted as 2 per hit
    pixel, a pixel lying inside few faces — and the attribute pass per hit
    pixel) over the float32 rate."""
    tests = raster_cuda.tile_face_tests(inp["rec"], S, S)
    hit = int(out["mask"].sum().item())
    ops = tests * OPS_PER_TEST + 2 * hit * OPS_PER_INSIDE + hit * OPS_PER_HIT_PIXEL
    nbytes = tensor_bytes(mesh_tensors, poses, K, tfs) + tensor_bytes(out)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "bytes": nbytes, "operations": ops, "pixel_face_tests": tests,
            "pixel_face_tests_untiled": int(poses.shape[0] * S * S * mesh_tensors["faces"].shape[0])}


def kernel_cases(scene_mesh):
    """(name, mesh, max_faces) of the meshes K1 is checked on."""
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
    "face (textured rgb: 1e-2 there, the texture's gradient multiplies a 1e-6 uv difference). "
    "Both sides are float32; FMA contraction and summation order can flip the winner "
    "between two faces that share an edge, where their scores tie to an ulp"
)


def compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw, tag):
    """One K1 call against the plain version on the same tensors. Returns the
    row of figures; exits on a disagreement."""
    a = raster_cuda.render_crops_cuda(
        mt, poses, K, tfs, kw["out_hw"], True, 0.8, 0.5, (0.0, 0.0, 1.0),
        kw["backface_cull"], kw["with_normal"], with_tri=True)
    torch.cuda.synchronize()
    ref = raster.render_crops(mt, poses, K, tfs, **kw)
    torch.cuda.synchronize()
    agree = (a["mask"] == ref["mask"]).float().mean().item()
    both = a["mask"] & ref["mask"]
    same = both & (a["tri"] == ref["tri"])
    row = {**tag, "faces": int(mt["faces"].shape[0]), "mask_agree": agree,
           "covered": both.float().mean().item(),
           "winner_flips_of_common": 1.0 - same.sum().item() / max(both.sum().item(), 1)}
    ok = agree >= 0.999 and bool(same.any()) and row["winner_flips_of_common"] <= 1e-3
    for key, tol in COMPARE_TOL:
        if key not in a:
            continue
        if not torch.isfinite(a[key]).all():
            fail(f"K1 {tag}: non-finite {key}")
        d = (a[key] - ref[key]).abs()
        d = d if d.ndim == 3 else d.amax(dim=-1)
        row[f"{key}_max_abs_err"] = d[same].max().item()
        row[f"{key}_max_abs_err_incl_flips"] = d[both].max().item()
        row[f"{key}_within_tol"] = (d[both] <= tol).float().mean().item()
        # same-winner pixels must all be inside the tolerance; a texture lookup
        # multiplies the ~1e-6 difference in uv by the texture's gradient
        # (steepest on the atlas seam), so textured rgb gets 1e-2 there
        strict = 1e-2 if key == "rgb" and "tex" in mt else tol
        ok = ok and row[f"{key}_within_tol"] >= 0.999 and row[f"{key}_max_abs_err"] <= strict
    if not ok:
        say("kernels", failed=row)
        fail(f"K1 disagrees with its plain version: {row}")
    return row


def check_kernels(scene, torch):
    """K1 against its plain version on the card at the main path's shapes,
    then its times beside its bound."""
    from foundationpose_tpu_torch.core import geometry as geo, meshio, poses as poses_mod
    from foundationpose_tpu_torch.ops import raster, raster_cuda

    dev = torch.device("cuda")
    S = 160
    K = torch.tensor(scene["K"], dtype=torch.float32, device=dev)
    # crop windows from real hypotheses: the 252-pose register grid at the
    # scene's translation, and 8 tracking-style poses around the true one
    hyp252 = poses_mod.make_rotation_grid().astype(np.float32)
    hyp252[:, :3, 3] = scene["gt"][:3, 3]
    hyp8 = np.tile(scene["gt"][None].astype(np.float32), (8, 1, 1))
    hyp8[1:, :3, 3] += np.random.default_rng(1).normal(0, 0.002, (7, 3)).astype(np.float32)
    batches = {"B252": torch.tensor(hyp252, device=dev), "B8": torch.tensor(hyp8, device=dev)}

    meshes = []
    for name, mesh, max_faces in kernel_cases(scene["mesh"]):
        b = mesh.bounds
        mesh = mesh.translated(-(b[0] + b[1]) / 2)
        mt = raster.make_mesh_tensors(mesh, max_faces=max_faces, bucket=True, device=dev)
        meshes.append((name, mt, meshio.compute_mesh_diameter(mesh=mesh)))

    rows = []
    for name, mt, diameter in meshes:
        for bname, poses in batches.items():
            tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, (S, S))
            for with_normal in (False, True):
                for cull in (False, True):
                    kw = dict(out_hw=(S, S), backface_cull=cull, with_normal=with_normal)
                    tag = {"case": name, "batch": bname, "with_normal": with_normal, "cull": cull}
                    rows.append(compare_with_plain(raster, raster_cuda, torch, mt, poses, K, tfs, kw, tag))
    worst = {key: max(r[f"{key}_max_abs_err"] for r in rows if f"{key}_max_abs_err" in r)
             for key, _ in COMPARE_TOL}
    worst_flips = {key: max(r[f"{key}_max_abs_err_incl_flips"] for r in rows
                            if f"{key}_max_abs_err" in r) for key, _ in COMPARE_TOL}

    # ---- times at B=252, 160 px, the refine path's call (no normals, culled),
    # one entry per face bucket; the first (the demo mesh) is the main path's
    kw = dict(out_hw=(S, S), backface_cull=True, with_normal=False)
    poses = batches["B252"]
    curve = []
    for name, mt, diameter in meshes:
        tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, (S, S))
        plain_fn = lambda: raster.render_crops(mt, poses, K, tfs, **kw)
        kern_fn = lambda: raster_cuda.render_crops(mt, poses, K, tfs, **kw)
        setup_fn = lambda: raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=True)
        inp = setup_fn()
        launch_fn = lambda: raster_cuda._launch(
            inp, poses.shape[0], S, S, "tex" in mt, True, False, 0.8, 0.5)
        # in turns: plain, kernel, kernel, plain
        p1 = event_ms(plain_fn, 1)
        k1 = event_ms(kern_fn, 20)
        k2 = event_ms(kern_fn, 20)
        p2 = event_ms(plain_fn, 1)
        curve.append({
            "case": name, "shape": f"B252 x {S}x{S} px, {mt['faces'].shape[0]}-face bucket",
            "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "kernel_only_ms": event_ms(launch_fn, 50), "setup_ms": event_ms(setup_fn, 20),
            **k1_bound(raster_cuda, mt, poses, K, tfs, inp, kern_fn(), S),
        })
    say("kernels", n_cases=len(rows), worst_abs_err=worst,
        worst_abs_err_incl_winner_flips=worst_flips, gate=COMPARE_GATE,
        max_winner_flips_of_common=max(r["winner_flips_of_common"] for r in rows),
        min_mask_agree=min(r["mask_agree"] for r in rows),
        min_within_tol=min(v for r in rows for k, v in r.items() if k.endswith("_within_tol")),
        times_B252=curve)
    return {"max_abs_err": max(worst.values()), "worst_abs_err": worst,
            "worst_abs_err_incl_winner_flips": worst_flips,
            "max_winner_flips_of_common": max(r["winner_flips_of_common"] for r in rows),
            **curve[0],
            "face_curve_B252": curve}


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
    from foundationpose_tpu_torch.ops import raster_cuda

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ---- build every kernel of the path from the sources in this checkout
    t0 = time.perf_counter()
    raster_cuda.build()
    say("build", kernel="K1 raster", source="foundationpose_tpu_torch/csrc/raster.cu",
        seconds=time.perf_counter() - t0, nvcc_seconds=raster_cuda.BUILD_SECONDS,
        ptxas=[l for l in raster_cuda.BUILD_LOG.splitlines() if "registers" in l])

    scene = demo.make_scene((480, 640), device="cuda")
    k1 = check_kernels(scene, torch)

    # ---- main path: register, then track, launches counted from zero
    est = demo.build_estimator(scene["mesh"], device="cuda")
    frames_in = list(demo.motion_frames(scene, TRACK_FRAMES))  # rendered up front
    n_hyp = int(est.rot_grid.shape[0])
    if n_hyp != 252 or est.refiner.cfg.input_size != 160:
        fail(f"main path is not at full width: {n_hyp} hypotheses, "
             f"{est.refiner.cfg.input_size} px")
    raster_cuda.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose = est.register(scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    reg_launches = raster_cuda.LAUNCHES
    reg_err = check_pose("register", pose, scene["gt"], scene["mesh"], est.diameter, metrics)
    if reg_launches != 11:
        fail(f"register launched K1 {reg_launches} times, expected 5 + 2 + 2 + 2 = 11")

    frames = []
    for f, (gt_f, rgb_f, depth_f) in enumerate(frames_in):
        before = raster_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose_f = est.track_one(rgb_f, depth_f, scene["K"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = raster_cuda.LAUNCHES - before
        err = check_pose(f"track frame {f}", pose_f, gt_f, scene["mesh"], est.diameter, metrics)
        if n != 4:
            fail(f"track frame {f} launched K1 {n} times, expected 2 + 2 = 4")
        frames.append({"frame": f, "ms": ms, "launches": n, **err})
    main_path_launches = raster_cuda.LAUNCHES  # read just after the main path
    if main_path_launches != reg_launches + 4 * TRACK_FRAMES:
        fail(f"main path launched K1 {main_path_launches} times, expected "
             f"{reg_launches + 4 * TRACK_FRAMES}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # warm repeat of register, for timing only (not part of the launch count)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose2 = est.register(scene["K"], scene["rgb"], scene["depth"], scene["mask"])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check_pose("register (warm repeat)", pose2, scene["gt"], scene["mesh"], est.diameter, metrics)

    say("register", hypotheses=n_hyp, crop_px=160, net_dtype=est.refiner.cfg.dtype,
        iterations="5 + 2 polish on top 8", first_call_ms=first_ms, warm_ms=warm_ms,
        hyp_per_s_warm=n_hyp / (warm_ms / 1e3), k1_launches=reg_launches,
        diameter_mm=est.diameter * 1000, peak_memory_gib=peak_gb,
        note="wall time incl. Python overhead of the eager loop", card=smi, **reg_err)
    say("track", frames=frames, hypotheses=est.cfg.track_hypotheses,
        iterations=est.cfg.track_iterations, gate_px=est.cfg.track_gate_px,
        precrop_px=est.cfg.track_crop_size,
        median_ms=float(np.median([fr["ms"] for fr in frames])), card=smi)

    if FAILURES:
        fail("; ".join(FAILURES))
    total_s = time.perf_counter() - t_start
    say("total", seconds=total_s)
    print(smi, flush=True)
    kernels = [{
        "name": "K1 crop rasterizer", "route": "cuda",
        "source": "foundationpose_tpu_torch/csrc/raster.cu",
        "replaces": "foundationpose_tpu/ops/raster_pallas.py:71",
        "launches": main_path_launches,
        "launches_per_register": reg_launches, "launches_per_track_one": 4,
        "max_abs_err": k1["max_abs_err"], "worst_abs_err": k1["worst_abs_err"],
        "worst_abs_err_incl_winner_flips": k1["worst_abs_err_incl_winner_flips"],
        "max_winner_flips_of_common": k1["max_winner_flips_of_common"],
        "tolerance": COMPARE_GATE,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "kernel_only_ms": k1["kernel_only_ms"], "setup_ms": k1["setup_ms"],
        "shape": k1["shape"], "card": smi,
        "by_face_bucket": [{k: c[k] for k in ("case", "shape", "ms", "kernel_only_ms", "setup_ms",
                                               "plain_ms", "bound_ms", "bound_by")}
                           for c in k1["face_curve_B252"]],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
