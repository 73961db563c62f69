"""Time the parts of the crop rasterizer's two kernels (K1s, K1r) on the card.

    python -m foundationpose_tpu_torch.apps.profile_raster [--shape NAME] [--out FILE]

Counterpart of the JAX repository's K1 timing scripts
(scripts/profile_kernel_variants.py, probe_raster_overhead.py,
probe_render_modes.py). It builds each kernel in parts from the sources the
package runs (``csrc/raster_setup.cu`` with ``-DK1S_PART=1``,
``csrc/raster.cu`` with ``-DK1R_PART=1..3``; nvcc side by side, into
``_build/`` under their own content hash) and times each part, each adding
to the one before it:

- K1s: the face setup alone (vertex table, face records), then + the tile
  binning (the kernel every path launches);
- K1r: reading the tile's bin row and writing background; + the coverage and
  depth test over the binned faces (depth written only); + the attribute
  pass (interpolation, texture, lighting; every pixel stored on its own);
  + the staged 16-byte stores (the kernel every path launches).

Each part is timed with CUDA events round its launch and with the
profiler's kernel time, beside its bound (``ops/raster_bounds.py``), at
every shape of the render calls the port's paths make (``SHAPES``), the
4096-face textured crop first. The parts are held against the full kernels
on the same inputs (the setup's tables and the attribute pass's outputs bit
for bit, the depth part on the same pixels, its median pixel within 5e-3
relative, background all zero), and it fails if one disagrees. No path of
the package loads a part's library: the render calls launch
``ops/kernels.py``'s own build, with no switch defined.
Needs a CUDA device; prints the card's name and power limit first.
``--out`` also writes the results as JSON: a run of every shape prints more
than a remote run's captured output keeps.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from foundationpose_tpu_torch import native
from foundationpose_tpu_torch.ops import kernels, raster_bounds, raster_cuda
from foundationpose_tpu_torch.utils.profiling import device_ms, event_ms, nvidia_smi_line

K1S_SWITCH = {"setup": "-DK1S_PART=1"}
K1R_SWITCH = {"bins+background": "-DK1R_PART=1", "+coverage+depth": "-DK1R_PART=2",
              "+attributes": "-DK1R_PART=3"}
# 1 / (interpolated 1/z) against the full kernel's interpolated z: the two
# agree where the winner's barycentrics sum to 1, which float32 coefficients
# miss by ~coordinate^2 x 6e-8 / the face's area in pixels: at the median
# pixel 5e-7 on the main path's crops, 6e-4 on the 81920-face sphere's full
# frame, and up to 1.6e-1 at a rim seen edge-on (H100). So the coverage must
# match exactly and the median pixel within DEPTH_RTOL; the worst is printed
DEPTH_RTOL = 5e-3
HW_FRAME = (480, 640)
S = 160

# name -> what the call renders; the first is timed first. ``mesh`` names a
# mesh of ``_Meshes``; ``poses`` the pose set; ``crop`` the crop side in
# pixels (None: a full frame, identity crop transform).
SHAPES = {
    "textured4096_B256_112px": dict(mesh="textured_4096", poses="grid256", crop=112,
                                    cull=True, normals=False),
    "main_B256_160px": dict(mesh="demo", poses="grid256", crop=S, cull=True, normals=False),
    "funnel_coarse_B256_112px": dict(mesh="demo", poses="grid256", crop=112, cull=True,
                                     normals=False),
    "funnel_fine_B64_160px": dict(mesh="demo", poses="grid64", crop=S, cull=True,
                                  normals=False),
    "funnel_fine_B64_160px_normals": dict(mesh="demo", poses="grid64", crop=S, cull=True,
                                          normals=True),
    "icp_B256_160px_normals": dict(mesh="demo", poses="grid256", crop=S, cull=True,
                                   normals=True),
    "train_refiner_B32_textured": dict(mesh="corpus_textured", poses="train32", crop=S,
                                       cull=False, normals=False),
    "train_refiner_B32_vcol": dict(mesh="corpus_vcol", poses="train32", crop=S, cull=False,
                                   normals=False),
    "train_scorer_B16_textured": dict(mesh="corpus_textured", poses="train16", crop=S,
                                      cull=False, normals=False),
    "train_scorer_B16_vcol": dict(mesh="corpus_vcol", poses="train16", crop=S, cull=False,
                                  normals=False),
    "bake_B2_480x640": dict(mesh="bake_81920", poses="bake2", crop=None, cull=False,
                            normals=False, light=False, tri_bary=True),
    "tracker_B1_160px": dict(mesh="depth_grid_7938", poses="tracker1", crop=S, cull=False,
                             normals=True),
    "full_frame_B1_256": dict(mesh="demo", poses="gt1", crop=None, cull=False, normals=True),
    "full_frame_B1_1536": dict(mesh="icosphere_1280", poses="gt1", crop=None, cull=False,
                               normals=True),
}


def build_parts(log=None):
    """Build every card library of ``ops/kernels.py`` and every part side by
    side. Returns ({part: K1s launch function}, {part: K1r launch function},
    {library name: path}); the last part of each is the default build the
    render calls launch."""
    specs = {name: kernels.spec(name) for name in kernels.LIBRARIES}
    for kernel, switches in (("K1s", K1S_SWITCH), ("K1r", K1R_SWITCH)):
        src, flags = specs[kernel]
        for part, flag in switches.items():
            specs[f"{kernel}_{part.strip('+').replace('+', '_')}"] = (src, flags + [flag])
    paths = native.compile_libraries(kernels.nvcc(), specs, {} if log is None else log)
    libs = kernels.build()
    k1s = {part: kernels.load("K1s", paths[f"K1s_{part}"]) for part in K1S_SWITCH}
    k1s["setup+bins"] = libs["K1s"]
    k1r = {part: kernels.load("K1r", paths[f"K1r_{part.strip('+').replace('+', '_')}"])
           for part in K1R_SWITCH}
    k1r["+staged stores"] = libs["K1r"]
    return k1s, k1r, paths


def _launcher(fn, dev, args):
    def go():
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return go


def coloured_sphere(subdivisions, radius):
    """An icosphere coloured by its vertices' positions."""
    from foundationpose_tpu_torch.core import meshio

    sph = meshio.make_icosphere_mesh(subdivisions=subdivisions, radius=radius)
    sph.vertex_colors = (np.abs(sph.vertices) / radius * 255).astype(np.uint8)
    return sph


def textured_sphere():
    """A 20480-face sphere of 6 cm radius with a noisy 256 x 256 texture on
    spherical uv."""
    from foundationpose_tpu_torch.core import meshio

    rng = np.random.default_rng(0)
    mesh = meshio.make_icosphere_mesh(subdivisions=5, radius=0.06)
    v = mesh.vertices / 0.06
    mesh.uv = np.stack([np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5,
                        np.arccos(np.clip(v[:, 2], -1, 1)) / np.pi], axis=-1)
    yy, xx = np.mgrid[0:256, 0:256]
    tex = np.stack([127 + 120 * np.sin(xx / 9.0), 127 + 120 * np.cos(yy / 7.0),
                    127 + 100 * np.sin((xx + yy) / 13.0)], axis=-1)
    mesh.texture = np.clip(tex + rng.normal(0, 4, tex.shape), 0, 255).astype(np.uint8)
    return mesh


class _Meshes:
    """The meshes of ``SHAPES``, built on first use."""

    def __init__(self, dev):
        self.dev, self.cache = dev, {}

    def __getitem__(self, name):
        if name not in self.cache:
            self.cache[name] = getattr(self, "_" + name)()
        return self.cache[name]

    def _tensors(self, mesh, **kw):
        from foundationpose_tpu_torch.core import meshio
        from foundationpose_tpu_torch.ops import raster

        b = mesh.bounds
        mesh = mesh.translated(-(b[0] + b[1]) / 2)
        mt = raster.make_mesh_tensors(mesh, device=self.dev, **kw)
        return mt, float(meshio.compute_mesh_diameter(mesh=mesh))

    def _demo(self):
        from foundationpose_tpu_torch.apps import demo_synthetic

        return self._tensors(demo_synthetic.make_l_shape(), bucket=True)

    def _icosphere_1280(self):
        return self._tensors(coloured_sphere(3, 0.06), bucket=True)

    def _textured_4096(self):
        """The textured sphere decimated to the 4096-face cap, as the
        estimator loads a mesh of the size users bring."""
        return self._tensors(textured_sphere(), max_faces=4096, bucket=True)

    def _corpus(self):
        from foundationpose_tpu_torch.models import agnostic

        prepped = agnostic.prepare_corpus(8, seed=7, max_faces=2048, device=self.dev)
        faces = lambda p: int(p["mt"]["faces"].shape[0])  # noqa: E731
        return {kind: max((p for p in prepped if p["textured"] == textured), key=faces)
                for kind, textured in (("textured", True), ("vcol", False))}

    def _corpus_textured(self):
        p = self["corpus"]["textured"]
        return p["mt"], float(p["diameter"])

    def _corpus_vcol(self):
        p = self["corpus"]["vcol"]
        return p["mt"], float(p["diameter"])

    def _bake_81920(self):
        """Stand-in for the texture bake's reconstructed mesh (~70k faces):
        an 81920-face sphere, unbucketed."""
        return self._tensors(coloured_sphere(6, 0.08))

    def _depth_grid_7938(self):
        """A depth-map mesh as the online tracker renders it: a 64 x 64 grid of
        a wavy surface, 7938 faces, unbucketed."""
        from foundationpose_tpu_torch.core import meshio

        n = 64
        y, x = np.mgrid[0:n, 0:n] / (n - 1) * 0.16 - 0.08
        z = 0.01 * np.sin(x * 60) * np.cos(y * 45)
        verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        i = np.arange(n * n).reshape(n, n)
        a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, :-1], i[1:, 1:]
        faces = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                                np.stack([b, c, d], -1).reshape(-1, 3)]).astype(np.int32)
        mesh = meshio.Mesh(verts, faces)
        mesh.vertex_colors = np.full((len(verts), 3), 160, np.uint8)
        return self._tensors(mesh)


def _poses(name, dev):
    """(B,4,4) float32 poses of the set ``name``."""
    from foundationpose_tpu_torch.apps import demo_synthetic
    from foundationpose_tpu_torch.core import geometry as geo, poses as poses_mod
    from foundationpose_tpu_torch.models import datagen

    gt = demo_synthetic.default_gt_pose().astype(np.float32)
    if name.startswith("grid"):
        hyp = poses_mod.make_rotation_grid().astype(np.float32)
        hyp[:, :3, 3] = gt[:3, 3]
        hyp = np.concatenate([hyp, np.tile(hyp[:1], (4, 1, 1))])  # padded as register pads
        return torch.tensor(hyp[:int(name[4:])], device=dev)
    if name.startswith("train"):
        gen = torch.Generator(device=dev).manual_seed(0)
        return datagen.poses_from_draws(datagen.draw_poses(gen, int(name[5:])))
    if name == "bake2":
        out = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        out[:, 2, 3] = 0.5
        out[1, :3, :3] = geo.euler_matrix(0.0, 0.7, 0.0)[:3, :3].numpy()
        return torch.tensor(out, device=dev)
    if name == "tracker1":
        out = np.eye(4, dtype=np.float32)[None]
        out[0, 2, 3] = 0.45
        return torch.tensor(out, device=dev)
    return torch.tensor(gt[None], device=dev)  # gt1


def make_case(name, meshes, dev):
    """(mesh tensors, poses, K, crop transforms, (H, W), render flags) of the
    shape ``name``."""
    from foundationpose_tpu_torch.apps import demo_synthetic
    from foundationpose_tpu_torch.apps.train_agnostic import K_TRAIN
    from foundationpose_tpu_torch.core import geometry as geo

    spec = SHAPES[name]
    mt, diameter = meshes[spec["mesh"]]
    poses = _poses(spec["poses"], dev)
    K_np = K_TRAIN if spec["poses"].startswith("train") else \
        demo_synthetic.default_intrinsics(HW_FRAME)
    K = torch.tensor(K_np, dtype=torch.float32, device=dev)
    if spec["crop"] is None:
        hw = HW_FRAME
        tfs = torch.eye(3, device=dev).expand(poses.shape[0], 3, 3).contiguous()
    else:
        hw = (spec["crop"], spec["crop"])
        tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, diameter, hw)
    flags = dict(cull=spec["cull"], normals=spec["normals"], light=spec.get("light", True),
                 tri_bary=spec.get("tri_bary", False))
    return mt, poses, K, tfs, hw, flags


def _check_parts(name, outs, setups):
    """Each part against the full kernel on the same inputs; raises on a
    disagreement."""
    full = outs["+staged stores"]
    for key, v in full.items():
        if not torch.equal(outs["+attributes"][key], v):
            raise AssertionError(f"{name}: K1r part '+attributes' differs from the full "
                                 f"kernel in {key}")
    bg = outs["bins+background"]
    if bg["mask"].any() or any(bool(bg[k].ne(0).any()) for k in ("rgb", "xyz", "depth")):
        raise AssertionError(f"{name}: K1r part 'bins+background' wrote a covered pixel")
    d, ref, m = outs["+coverage+depth"]["depth"], full["depth"], full["mask"]
    if not torch.equal(d > 0, m):
        raise AssertionError(f"{name}: K1r part '+coverage+depth' covers other pixels than "
                             "the full kernel")
    rel = ((d - ref).abs() / ref.abs().clamp_min(1e-6))[m].double()
    median = float(rel.median()) if m.any() else 0.0
    if median > DEPTH_RTOL:
        raise AssertionError(f"{name}: K1r part '+coverage+depth' depth {median:.2e} off the "
                             "full kernel's at the median pixel")
    a, b = setups["setup"], setups["setup+bins"]
    checks = {"depth_part_median_rel_err": median,
              "depth_part_max_rel_err": float(rel.max()) if m.any() else 0.0}
    valid = b["rec"][..., 12] <= b["rec"][..., 13]
    if not (torch.equal(a["vtab"], b["vtab"]) and torch.equal(a["rec"][valid], b["rec"][valid])
            and torch.equal(a["rec"][..., 12:], b["rec"][..., 12:])):
        raise AssertionError(f"{name}: K1s part 'setup' differs from the full kernel's tables")
    return checks


def profile_shape(name, meshes, k1s, k1r, reps=50):
    """Times and bounds of every part at the shape ``name``. Returns a dict."""
    mt, poses, K, tfs, hw, fl = make_case(name, meshes, torch.device("cuda"))
    light = (0.0, 0.0, 1.0)
    setups, rows = {}, []
    for part, fn in k1s.items():
        d, args, scratch = raster_cuda.setup_launch_args(mt, poses, K, tfs, hw, light, fl["cull"])
        go = _launcher(fn, d, args)
        go()
        setups[part] = scratch
        dev_ms = device_ms(go, max(reps // 2, 5), ("setup_kernel",))["setup_kernel"]
        rows.append({"kernel": "K1s", "part": part, "events_ms": event_ms(go, reps),
                     "device_ms": dev_ms})
    scratch = setups["setup+bins"]
    outs = {}
    for part, fn in k1r.items():
        d, args, out = raster_cuda.raster_launch_args(
            mt, scratch, hw, fl["light"], 0.8, 0.5, fl["normals"], fl["tri_bary"], fl["tri_bary"])
        go = _launcher(fn, d, args)
        go()
        outs[part] = out
        dev_ms = device_ms(go, max(reps // 2, 5), ("raster_kernel",))["raster_kernel"]
        rows.append({"kernel": "K1r", "part": part, "events_ms": event_ms(go, reps),
                     "device_ms": dev_ms})
    torch.cuda.synchronize()
    checks = _check_parts(name, outs, setups)
    full = outs["+staged stores"]
    parts = raster_bounds.k1_part_bounds(mt, poses, K, tfs, scratch, full, hw)
    for r in rows:
        b = parts[r["part"]]
        r.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                 share_of_bound=b["bound_ms"] / r["device_ms"] if r["device_ms"] else None)
    call = lambda: raster_cuda.render_crops(  # noqa: E731
        mt, poses, K, tfs, out_hw=hw, use_light=fl["light"], backface_cull=fl["cull"],
        with_normal=fl["normals"], with_tri=fl["tri_bary"], with_bary=fl["tri_bary"])
    call_ms = event_ms(call, reps)
    cb = parts["call"]
    spec = SHAPES[name]
    return {"shape": name, "B": int(poses.shape[0]), "hw": list(hw),
            "faces": int(mt["faces"].shape[0]), "textured": "tex" in mt,
            "flags": fl, "mesh": spec["mesh"], "parts": rows, "checks": checks,
            "call": {"events_ms": call_ms, "bound_ms": cb["bound_ms"],
                     "bound_by": cb["bound_by"], "share_of_bound": cb["bound_ms"] / call_ms,
                     "pixel_face_tests": cb["pixel_face_tests"],
                     "hit_pixels": cb["hit_pixels"]}}


def format_rows(res):
    """Text table of one shape's result."""
    lines = [f"{res['shape']}: B={res['B']} x {res['hw'][0]}x{res['hw'][1]}, "
             f"{res['faces']} faces ({res['mesh']})"
             + (", textured" if res["textured"] else "")
             + f"; call {res['call']['events_ms']:.4f} ms, bound {res['call']['bound_ms']:.4f}"
             f" ms ({res['call']['bound_by']}), {100 * res['call']['share_of_bound']:.1f} %"]
    for r in res["parts"]:
        dev = "n/a" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        share = "n/a" if r["share_of_bound"] is None else f"{100 * r['share_of_bound']:.1f} %"
        lines.append(f"  {r['kernel']} {r['part']:<18} events {r['events_ms']:.4f} ms  "
                     f"device {dev} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  {share}")
    return "\n".join(lines)


def run(shapes, reps=50, parts=None):
    """Profile ``shapes`` (names of ``SHAPES``) in order; ``parts`` from
    :func:`build_parts` (built when None). Prints each shape's JSON line and
    table; returns the results."""
    k1s, k1r, _ = parts or build_parts()
    meshes = _Meshes(torch.device("cuda"))
    results = []
    for name in shapes:
        res = profile_shape(name, meshes, k1s, k1r, reps)
        print(json.dumps({"profile_raster": res}), flush=True)
        print(format_rows(res), flush=True)
        results.append(res)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shape", choices=list(SHAPES), action="append",
                   help="shape to time (repeatable; default: every shape)")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_raster: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(1)
    print(nvidia_smi_line(), flush=True)
    results = run(args.shape or list(SHAPES))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": nvidia_smi_line(), "shapes": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
