"""Synthetic evaluation scenes for the standing accuracy harness.

The port's own copy of foundationpose_tpu/evalsuite/scenes.py: the same
meshes, specs, poses and trajectories. ``SceneRenderer`` renders through
``ops/raster_cuda.render_full_frame`` — K1s + K1r on the card, B = 1 at the
frame's size on each mesh's bucketed tensors — and through the plain
rasterizer on the CPU. ``device=None`` means cuda.

The driver-set north star is "match FoundationPose ADD-S AUC" (BASELINE.md),
and the reference's evaluation protocol is: per-frame GT poses + visible
masks from a BOP-layout reader (src/datareader.py:265-377) fed through
register/track, scored by ADD / ADD-S / AUC (src/Utils.py:232-266). Real BOP
data cannot exist on this zero-egress host, so this module provides a FIXED,
seeded suite of synthetic 640x480 scenes with exact GT — textured,
vertex-colored and flat-gray meshes, discrete- and continuous-symmetric
objects with their symmetry_tfs, partial occlusion, and clutter over a
textured backdrop — rendered by the framework's own rasterizer and composed
with a host-side z-buffer (so the target's mask is the OCCLUSION-AWARE
visible mask, like BOP's mask_visib).

Everything is deterministic: scene content depends only on the spec, so
ACCURACY_r*.json numbers are comparable across rounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo, meshio
from foundationpose_tpu_torch.ops import raster, raster_cuda

K_DEFAULT = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
HW_DEFAULT = (480, 640)
BACKDROP_Z = 1.6  # meters; behind every object, inside the depth range


# ---------------------------------------------------------------------------
# mesh builders


def checker_texture(n=8, size=256, c0=(205, 65, 45), c1=(240, 232, 210)):
    """(size,size,3) uint8 checkerboard."""
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // n
    board = ((ii // cell + jj // cell) % 2).astype(bool)
    tex = np.where(board[..., None], np.array(c0, np.uint8), np.array(c1, np.uint8))
    return tex.astype(np.uint8)


def sphere_uv(verts):
    """Spherical uv mapping (u = azimuth, v = polar), origin top-left."""
    v = np.asarray(verts, np.float64)
    r = np.linalg.norm(v, axis=-1)
    u = np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5
    vv = np.arccos(np.clip(v[:, 2] / np.maximum(r, 1e-12), -1, 1)) / np.pi
    return np.stack([u, vv], axis=-1)


def cylinder_uv(verts, height):
    v = np.asarray(verts, np.float64)
    u = np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5
    vv = 0.5 - v[:, 2] / height
    return np.stack([u, np.clip(vv, 0, 1)], axis=-1)


def make_sphere_tex(radius=0.06, n_checker=10):
    m = meshio.make_icosphere_mesh(subdivisions=3, radius=radius)
    m.uv = sphere_uv(m.vertices)
    m.texture = checker_texture(n=n_checker)
    return m


def make_sphere_vc(radius=0.06, seed=0):
    m = meshio.make_icosphere_mesh(subdivisions=3, radius=radius)
    rng = np.random.default_rng(seed)
    m.vertex_colors = rng.integers(60, 220, (len(m.vertices), 3)).astype(np.uint8)
    return m


def make_box_gray(extents=(0.12, 0.08, 0.05)):
    m = meshio.make_box(extents)
    m.vertex_colors = np.full((len(m.vertices), 3), 140, np.uint8)
    return m


def make_box_sym(side=0.08, height=0.05):
    """Square-footprint box: 4-fold discrete symmetry about z
    (reference YcbVideoReader geometric overrides, datareader.py:483-507)."""
    m = meshio.make_box((side, side, height))
    m.vertex_colors = np.full((len(m.vertices), 3), 170, np.uint8)
    tfs = [np.eye(4)]
    for k in (1, 2, 3):
        t = np.eye(4)
        t[:3, :3] = geo.euler_matrix(0, 0, np.pi / 2 * k)[:3, :3].numpy()
        tfs.append(t)
    return m, np.stack(tfs)


def make_cylinder_sym(radius=0.035, height=0.12, step_deg=15):
    """Uniform-color cylinder: continuous z symmetry, discretized like the
    reference symmetry_tfs_from_info (Utils.py:806-834, 5 deg default —
    coarser here to keep the clustered grid non-trivial)."""
    m = meshio.make_cylinder(radius, height, n_seg=48)
    m.vertex_colors = np.full((len(m.vertices), 3), 120, np.uint8)
    m.vertex_colors[:, 2] = 190  # bluish, uniform (symmetric appearance)
    tfs = []
    for a in np.arange(0, 360, step_deg):
        t = np.eye(4)
        t[:3, :3] = geo.euler_matrix(0, 0, np.radians(a))[:3, :3].numpy()
        tfs.append(t)
    return m, np.stack(tfs)


def make_cylinder_tex(radius=0.035, height=0.12):
    m = meshio.make_cylinder(radius, height, n_seg=48)
    m.uv = cylinder_uv(m.vertices, height)
    m.texture = checker_texture(n=6, c0=(60, 120, 200), c1=(230, 220, 80))
    return m


def make_compound_asym():
    """The asymmetric box compound used by the learned-pipeline proofs
    (scripts/train_learned_e2e.py)."""
    a = meshio.make_box((0.12, 0.04, 0.04))
    b = meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0])
    c = meshio.make_box((0.04, 0.04, 0.07)).translated([-0.04, 0.0, 0.055])
    meshes = [a, b, c]
    verts = np.concatenate([m.vertices for m in meshes])
    offs = np.cumsum([0] + [len(m.vertices) for m in meshes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    m = meshio.Mesh(verts, faces)
    m.vertex_colors = np.full((len(verts), 3), 180, np.uint8)
    return m


def make_ellipsoid_vc(radii=(0.08, 0.05, 0.035), seed=3):
    m = meshio.make_icosphere_mesh(subdivisions=3, radius=1.0)
    m.vertices = m.vertices * np.asarray(radii)[None]
    m.vertex_normals = meshio.compute_vertex_normals(m.vertices, m.faces)
    rng = np.random.default_rng(seed)
    m.vertex_colors = rng.integers(50, 230, (len(m.vertices), 3)).astype(np.uint8)
    return m


def _pose(euler, t):
    p = np.eye(4)
    p[:3, :3] = geo.euler_matrix(*euler)[:3, :3].numpy()
    p[:3, 3] = t
    return p


# ---------------------------------------------------------------------------
# scene specs


@dataclasses.dataclass
class SceneSpec:
    name: str
    mesh: meshio.Mesh
    symmetry_tfs: np.ndarray | None = None
    # static other objects: [(mesh, pose)] — occluders sit in FRONT of the
    # target along the view ray, clutter to the side
    distractors: list = dataclasses.field(default_factory=list)
    backdrop: bool = False  # checkered plane at BACKDROP_Z
    z0: float = 0.55
    n_register: int = 4
    n_track: int = 60
    learned: bool = False  # include in learned-mode evaluation
    # include this scene's ADD in the POOLED ADD AUC. False for spheres:
    # ADD is meaningless under a continuous full rotational symmetry (any
    # rotation is correct), and pooling sphere ADD drags the overall number
    # to noise (round-4 verdict weak #8)
    pool_add: bool = True
    seed: int = 0


def build_suite(quick=False):
    """The fixed scene list. ``quick`` shrinks it for CPU smoke tests."""
    box_sym, box_sym_tfs = make_box_sym()
    cyl_sym, cyl_sym_tfs = make_cylinder_sym()
    occluder = make_box_gray((0.05, 0.16, 0.03))
    occluder.vertex_colors = np.full((len(occluder.vertices), 3), 90, np.uint8)
    clutter = [
        (make_sphere_vc(0.04, seed=11), _pose((0.2, 0.1, 0), [-0.16, 0.05, 0.62])),
        (make_box_gray((0.06, 0.05, 0.08)), _pose((0, 0.4, 0.3), [0.15, -0.07, 0.70])),
        (make_cylinder_tex(0.03, 0.10), _pose((0.9, 0, 0.2), [0.12, 0.11, 0.58])),
    ]
    # occluder in front of the target's line of sight (z0 - 0.18), covering
    # roughly a third of it
    occ = [(occluder, _pose((0.0, 0.0, 0.25), [0.045, 0.0, 0.37]))]

    suite = [
        SceneSpec("sphere_tex", make_sphere_tex(), seed=1, learned=True,
                  pool_add=False),
        SceneSpec("sphere_vc", make_sphere_vc(seed=2), seed=2, pool_add=False),
        SceneSpec("box_gray", make_box_gray(), seed=3, learned=True),
        SceneSpec("compound_asym", make_compound_asym(), seed=4, learned=True),
        SceneSpec("cylinder_sym", cyl_sym, symmetry_tfs=cyl_sym_tfs, seed=5),
        SceneSpec("box_sym", box_sym, symmetry_tfs=box_sym_tfs, seed=6),
        SceneSpec("cylinder_tex", make_cylinder_tex(), seed=7),
        SceneSpec("sphere_occluded", make_sphere_vc(0.07, seed=8),
                  distractors=occ, seed=8, pool_add=False),
        SceneSpec("compound_clutter", make_compound_asym(),
                  distractors=clutter, backdrop=True, seed=9),
        SceneSpec("ellipsoid_vc", make_ellipsoid_vc(), seed=10),
        SceneSpec("box_far", make_box_gray((0.07, 0.05, 0.04)), z0=0.95,
                  seed=11),
        SceneSpec("sphere_tex_clutter", make_sphere_tex(radius=0.07),
                  distractors=clutter, backdrop=True, seed=12,
                  pool_add=False),
    ]
    if quick:
        keep = {"compound_clutter", "sphere_occluded"}
        suite = [dataclasses.replace(s, n_register=2, n_track=6)
                 for s in suite if s.name in keep]
    return suite


# ---------------------------------------------------------------------------
# rendering


def _backdrop_rgbd(hw):
    """Checkered plane at BACKDROP_Z filling the frame (numpy, no render)."""
    H, W = hw
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    board = ((ii // 40 + jj // 40) % 2).astype(bool)
    rgb = np.where(board[..., None], 95.0, 135.0).repeat(3, axis=-1)
    depth = np.full((H, W), BACKDROP_Z, np.float32)
    return rgb.astype(np.float32), depth


class SceneRenderer:
    """Renders a SceneSpec's frames: target at an arbitrary pose over the
    (pre-rendered, static) distractors and backdrop, z-composited on host.
    Returns BOP-style data: rgb [0,255], metric depth, visible mask (numpy on
    the host)."""

    def __init__(self, spec: SceneSpec, K=None, hw=None, device=None):
        self.spec = spec
        self.K = np.asarray(K if K is not None else K_DEFAULT, np.float64)
        self.hw = tuple(hw if hw is not None else HW_DEFAULT)
        self.device = resolve_device(device)
        # bucketed tensors: the meshes render at the shapes the JAX package's
        # shared full-frame program sees
        self.mt = raster.make_mesh_tensors(spec.mesh, max_faces=4096, bucket=True,
                                           device=self.device)
        self._static = self._render_static()

    def _render(self, mt, pose):
        """Full-frame render of one pose -> (rgb [0,1], depth, mask) numpy."""
        out = raster_cuda.render_full_frame(
            mt, torch.as_tensor(np.asarray(pose, np.float32)[None]), self.K, self.hw)
        return (out["rgb"][0].cpu().numpy(), out["depth"][0].cpu().numpy(),
                out["mask"][0].cpu().numpy())

    def _render_static(self):
        H, W = self.hw
        if self.spec.backdrop:
            rgb, depth = _backdrop_rgbd(self.hw)
        else:
            rgb = np.zeros((H, W, 3), np.float32)
            depth = np.zeros((H, W), np.float32)
        zbuf = np.where(depth > 0, depth, np.inf)
        for mesh, pose in self.spec.distractors:
            mt = raster.make_mesh_tensors(mesh, max_faces=4096, bucket=True, device=self.device)
            rgb_d, d, mask_d = self._render(mt, pose)
            m = mask_d & (d < zbuf) & (d > 0)
            rgb = np.where(m[..., None], rgb_d * 255.0, rgb)
            zbuf = np.where(m, d, zbuf)
        return rgb, zbuf

    def render(self, obj_pose):
        """(rgb [0,255] f32, depth m f32, visib_mask u8, visib_frac)."""
        rgb_s, zbuf_s = self._static
        rgb_o, d, mask_o = self._render(self.mt, obj_pose)
        m_obj = mask_o & (d > 0)
        vis = m_obj & (d < zbuf_s)
        rgb = np.where(vis[..., None], rgb_o * 255.0, rgb_s)
        depth = np.where(vis, d, np.where(np.isfinite(zbuf_s), zbuf_s, 0.0))
        frac = float(vis.sum()) / max(int(m_obj.sum()), 1)
        return rgb.astype(np.float32), depth.astype(np.float32), vis.astype(np.uint8), frac

    # -- GT pose generators (deterministic per spec.seed) --
    def register_poses(self):
        rng = np.random.default_rng(self.spec.seed)
        base_eulers = [(0.3, -0.2, 0.5), (-0.45, 0.25, -0.3),
                       (0.15, 0.55, 0.2), (-0.2, -0.4, 1.2)]
        base_t = [(0.02, -0.01, 0.0), (-0.05, 0.03, 0.08),
                  (0.05, 0.02, -0.06), (0.0, -0.04, 0.12)]
        poses = []
        for i in range(self.spec.n_register):
            e = np.asarray(base_eulers[i % 4]) + rng.uniform(-0.1, 0.1, 3)
            t = np.asarray(base_t[i % 4]) + rng.uniform(-0.01, 0.01, 3)
            t[2] += self.spec.z0
            poses.append(_pose(tuple(e), t))
        return poses

    def track_trajectory(self):
        """(T,4,4) smooth GT trajectory starting at register pose 0:
        ~1.5 deg/frame rotation about a slowly-precessing axis + sinusoidal
        translation, the magnitudes of a handheld-object video."""
        T = self.spec.n_track
        p0 = self.register_poses()[0]
        poses = [p0]
        rng = np.random.default_rng(self.spec.seed + 100)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        for i in range(1, T):
            ang = np.radians(1.5)
            # precess the rotation axis slowly
            axis = axis + 0.05 * rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            # float32, as the JAX package computes it
            dR = geo.so3_exp_map((axis * ang)[None].astype(np.float32))[0].numpy()
            p = poses[-1].copy()
            p[:3, :3] = dR @ p[:3, :3]
            t = i / T * 2 * np.pi
            p[:3, 3] = p0[:3, 3] + 0.015 * np.array(
                [np.sin(2 * t), np.cos(3 * t), np.sin(t)]
            )
            poses.append(p)
        return np.stack(poses)
