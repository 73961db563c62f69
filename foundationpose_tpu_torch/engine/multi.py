"""Multi-object / multi-stream tracking.

Counterpart of foundationpose_tpu/engine/multi.py: N objects tracked at
once, each against its own rgb-d stream (per-object intrinsics supported —
distinct cameras).

- every mesh is centred, decimated to ``max_faces`` (not bucketed) and its
  texture baked to vertex colours, so every object has the same attribute
  layout; ``stack_mesh_tensors`` pads them to common (V_max, F_max) and stacks
  them with a leading object axis, as the JAX package does;
- one ``track`` call advances every object's pose by ``iteration`` refine
  steps: no gate, no perturbation fan, no scorer, no host pre-crop.

The JAX package maps one refine step over the object axis with ``vmap`` on
its plain rasterizer. Here the rasterizer kernels take one mesh per launch,
so each iteration renders object by object (one launch of each kernel per
object) and then runs ONE RefineNet forward over the O crops. RefineNet has
no operation across its batch axis (convolutions, per-sample GroupNorm and
attention over the tokens of one sample), so that forward equals the O
single forwards. Rendering one object at a time needs no common shape, so the
tracker keeps each object's own unpadded tensors: the stacked layout would
only make the setup kernel look at the largest object's face count for every
object. The pad faces change no pixel (both rasterizers drop zero-area
triangles), so the poses are those of the stacked layout.

With a ``device_mesh`` (``parallel.mesh.Mesh``, first axis) the object axis
is sharded, as the JAX package shards its stacked objects over the mesh:
each process holds the mesh tensors of its contiguous slice of the objects
only, uploads only its slice of the per-object frames, refines its objects
through K1, and the poses are gathered in order, so every process holds (and
``get_poses`` returns) all of them. The object count must split evenly over
the axis (``ValueError`` otherwise, as ``NamedSharding`` refuses it).
"""

from __future__ import annotations

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.engine.estimator import _upload, preprocess_depth
from foundationpose_tpu_torch.engine.refiner import (
    PoseRefiner, RefinerConfig, apply_net_output, refine_inputs,
)
from foundationpose_tpu_torch.ops import raster


def _vertex_colors_from_texture(mesh):
    """Sample the texture at the vertex uvs -> vertex colours (multi-object
    stacks share one attribute layout, so textured meshes are baked per
    vertex)."""
    if mesh.texture is None or mesh.uv is None:
        return mesh
    m = mesh.copy()
    H, W = mesh.texture.shape[:2]
    u = np.clip(mesh.uv[:, 0], 0, 1)
    v = np.clip(1.0 - mesh.uv[:, 1], 0, 1)
    xi = np.clip((u * (W - 1)).round().astype(int), 0, W - 1)
    yi = np.clip((v * (H - 1)).round().astype(int), 0, H - 1)
    m.vertex_colors = mesh.texture[yi, xi]
    m.texture = None
    m.uv = None
    return m


def object_mesh_tensors(meshes, max_faces=4096, device=None, keep=None):
    """Per-object mesh tensors of the tracker: each mesh centred, its texture
    baked to vertex colours, decimated to ``max_faces``, not bucketed. Returns
    (list of mesh-tensor dicts, diameters (O,) float32 array, centres (O,3)
    array). ``keep``: a slice of the objects whose tensors are built (the
    diameters and centres are every object's); default all."""
    device = resolve_device(device)
    keep = range(len(meshes))[keep if keep is not None else slice(None)]
    prepped, centers, diameters = [], [], []
    for i, mesh in enumerate(meshes):
        bounds = mesh.bounds
        center = (bounds[0] + bounds[1]) / 2
        centered = _vertex_colors_from_texture(mesh.translated(-center))
        centers.append(center)
        diameters.append(meshio.compute_mesh_diameter(mesh=centered))
        if i in keep:
            prepped.append(raster.make_mesh_tensors(centered, max_faces=max_faces,
                                                    device=device))
    return prepped, np.asarray(diameters, np.float32), np.stack(centers)


def stack_mesh_tensors(meshes, max_faces=4096, device=None):
    """Pad the per-object mesh tensors to common sizes and stack them with a
    leading object axis (pad faces index vertex 0 three times, a zero-area
    triangle the rasterizer drops). Returns (stacked mesh-tensor dict,
    diameters (O,) float32 array, centres (O,3) array)."""
    prepped, diameters, centers = object_mesh_tensors(meshes, max_faces, device)
    V = max(int(m["pos"].shape[0]) for m in prepped)
    F = max(int(m["faces"].shape[0]) for m in prepped)

    def pad_stack(key, n):
        return torch.stack([
            torch.nn.functional.pad(m[key], (0, 0, 0, n - m[key].shape[0])) for m in prepped
        ])

    stacked = {
        "pos": pad_stack("pos", V),
        "faces": pad_stack("faces", F),
        "vnormals": pad_stack("vnormals", V),
        "vertex_color": pad_stack("vertex_color", V),
    }
    return stacked, diameters, centers


class MultiObjectTracker:
    """Track N objects at once. Initialise each object's pose from a
    single-object ``FoundationPoseTorch.register`` (or provide poses), then
    call :meth:`track` once per set of frames. ``device=None`` means cuda;
    ``device_mesh`` shards the objects (module docstring)."""

    def __init__(self, meshes, refiner: PoseRefiner | None = None, max_faces=4096,
                 device=None, device_mesh=None):
        self.device = resolve_device(device)
        self.refiner = refiner or PoseRefiner(RefinerConfig(), device=self.device)
        if self.refiner.device.type != self.device.type:
            raise ValueError(f"refiner lives on {self.refiner.device}, tracker on {self.device}")
        self.n_objects = O = len(meshes)
        self.device_mesh = device_mesh
        self.mine = slice(0, O)  # this process's objects
        if device_mesh is not None:
            if device_mesh.device.type != self.device.type:
                raise ValueError(f"device mesh on {device_mesh.device}, tracker on {self.device}")
            axis = device_mesh.axis_names[0]
            n, i = device_mesh.size(axis), device_mesh.index(axis)
            if O % n:
                raise ValueError(f"{O} objects do not split evenly over {n} processes")
            self.mine = slice(i * (O // n), (i + 1) * (O // n))
        self.mesh_tensors, self.diameters, self.centers = object_mesh_tensors(
            meshes, max_faces=max_faces, device=self.device, keep=self.mine
        )  # a list: one unpadded mesh-tensor dict per object of this process
        self.poses = None  # (O,4,4) float32, centred-mesh object-in-camera

    def _center_tf(self, i, sign):
        t = np.eye(4)
        t[:3, 3] = sign * self.centers[i]
        return t

    def set_poses(self, poses, centered=False):
        """poses: (O,4,4) object-in-camera of the ORIGINAL meshes (or of the
        centred ones if ``centered``)."""
        poses = np.asarray(poses, np.float64).copy()
        if not centered:
            for i in range(self.n_objects):
                poses[i] = poses[i] @ self._center_tf(i, +1.0)
        self.poses = poses.astype(np.float32)

    def get_poses(self):
        """(O,4,4) poses of the ORIGINAL meshes in camera."""
        return np.stack([self.poses[i] @ self._center_tf(i, -1.0)
                         for i in range(self.n_objects)])

    @torch.no_grad()
    def track(self, rgbs, depths, Ks, iteration=2):
        """rgbs: (O,H,W,3); depths: (O,H,W); Ks: (O,3,3) — one observation
        per object (the streams may be distinct cameras). Returns the (O,4,4)
        poses of the original meshes (every object's, on every process of a
        device mesh; each uploads and refines only its own)."""
        if self.poses is None:
            raise RuntimeError("set_poses() before track()")
        dev, cfg, mine = self.device, self.refiner.cfg, self.mine
        Ks = _upload(np.asarray(Ks)[mine], dev, torch.float32)
        rgbs = _upload(np.asarray(rgbs)[mine], dev, torch.float32)
        depths = _upload(np.asarray(depths)[mine], dev, torch.float32)
        O = len(self.mesh_tensors)
        xyz_maps = [preprocess_depth(depths[o], Ks[o])[1] for o in range(O)]
        meshes = self.mesh_tensors
        diameters = [float(d) for d in self.diameters[mine]]
        poses = _upload(self.poses[mine], dev)
        for _ in range(int(iteration)):
            data = [
                refine_inputs(meshes[o], poses[o:o + 1], Ks[o], rgbs[o], xyz_maps[o],
                              diameters[o], cfg=cfg)
                for o in range(O)
            ]
            out = self.refiner.net(torch.cat([d["inputA"] for d in data]),
                                   torch.cat([d["inputB"] for d in data]))
            poses = torch.cat([
                apply_net_output({k: v[o:o + 1] for k, v in out.items()}, poses[o:o + 1],
                                 Ks[o], data[o]["tf_to_crops"], diameters[o], cfg=cfg)
                for o in range(O)
            ])
        if self.device_mesh is not None:
            from foundationpose_tpu_torch.parallel.mesh import all_gather_rows

            poses = all_gather_rows(self.device_mesh, poses, self.device_mesh.axis_names[0])
        self.poses = poses.cpu().numpy()
        return self.get_poses()
