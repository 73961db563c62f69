"""The pose engine, plain: register's start, the learned refine step
(RefineNet), projective ICP, the hybrid and geometric scores, and the
tracking step, over one object.

``Reference(obj, cfg, device)`` prepares the object as the engine must: the
mesh centred on its bounding-box centre, the diameter as the bounding-box
diagonal in the vertices' principal axes, backface culling only for a closed
consistently wound mesh, and the rotation grid (icosphere views x in-plane
steps, padded to a multiple of 32 with copies of the first).
"""

import numpy as np
import torch

from . import geometry as geo
from . import image, nets, raster

ROT_NORMALIZER = 0.3490658503988659  # 20 degrees
HYP_BUCKET = 32


def diameter(vertices):
    u, s, _ = np.linalg.svd(np.asarray(vertices, np.float64), full_matrices=False)
    proj = u * s
    return float(np.linalg.norm(proj.max(axis=0) - proj.min(axis=0)))


def is_closed(faces):
    """Every directed edge once and its reverse once."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    n = int(f.max() + 1)
    key, rkey = e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]
    return len(np.unique(key)) == len(key) and bool(np.isin(key, rkey).all())


def _icosphere_views(n_views):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                      [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
             [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
             [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    while True:  # at least one subdivision (42 views), then until n_views
        vs = list(map(tuple, verts))
        index = {v: i for i, v in enumerate(vs)}
        cache, new = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = tuple((np.asarray(vs[i]) + np.asarray(vs[j])) / 2.0)
                if m not in index:
                    index[m] = len(vs)
                    vs.append(m)
                cache[key] = index[m]
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vs, np.float64)
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
        faces = new
        if len(verts) >= n_views:
            break
    n = len(verts)
    cams = np.tile(np.eye(4)[None], (n, 1, 1))
    cams[:, :3, 3] = verts
    z = -verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    x = np.cross(np.tile([0.0, 0.0, 1.0], (n, 1)), z)
    x[(np.abs(x) < 1e-12).all(axis=-1)] = [1.0, 0.0, 0.0]
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    cams[:, :3, 0], cams[:, :3, 1], cams[:, :3, 2] = x, y, z
    return cams


def rotation_grid(min_n_views, inplane_step):
    """Object-in-camera rotations: every icosphere view x every in-plane
    step (the engine's clustering at 30 degrees keeps all of them)."""
    out = []
    for cam in _icosphere_views(min_n_views):
        for a in np.deg2rad(np.arange(0, 360, inplane_step)):
            rz = np.eye(4)
            rz[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            out.append(np.linalg.inv(cam @ rz))
    return np.asarray(out).astype(np.float32)


class Observation:
    """A frame as the engine sees it: rgb (H,W,3) float in [0, 255] and the
    camera-space point map of the filtered depth, on the device."""

    def __init__(self, rgb, xyz, K):
        self.rgb, self.xyz, self.K = rgb, xyz, K


class Reference:
    def __init__(self, obj, cfg, device, weights_dir=None, quant=None):
        self.cfg, self.device = cfg, torch.device(device)
        est = cfg["estimator"]
        self.est = est
        self.size = int(cfg["input_size"])
        v = np.asarray(obj["vertices"], np.float64)
        lo, hi = v.min(axis=0), v.max(axis=0)
        self.model_center = (lo + hi) / 2.0
        centred = v - self.model_center
        self.diameter = diameter(centred)
        self.cull = is_closed(obj["faces"])
        self.mesh = raster.mesh_tensors(centred, obj["faces"], obj["normals"], obj.get("uv"),
                                        obj.get("texture"), obj.get("colors"), self.device)
        self.points = torch.as_tensor(centred, dtype=torch.float64, device=self.device)
        self.tf_centred = np.eye(4)
        self.tf_centred[:3, 3] = -self.model_center
        grid = rotation_grid(est["min_n_views"], est["inplane_step"])
        self.n_grid = len(grid)
        pad = np.zeros((-len(grid)) % HYP_BUCKET, int)
        self.grid = torch.as_tensor(grid[np.r_[0:len(grid), pad]], device=self.device)
        self.learned = cfg["mode"] == "learned"
        if self.learned:
            self.refine_net = nets.load_npz(nets.RefineNet(), f"{weights_dir}/refiner.npz")
            self.score_net = nets.load_npz(nets.ScoreNet(), f"{weights_dir}/scorer.npz")
            for n in (self.refine_net, self.score_net):
                nets.set_quant(n.to(self.device).eval(), quant)

    # ---- frames -------------------------------------------------------------
    def register_observation(self, K, rgb, depth, mask):
        """Gate the frame to the dilated mask, filter the depth, and guess the
        translation: mask box centre ray x median masked depth."""
        dev = self.device
        K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rgb_t = torch.as_tensor(np.asarray(rgb, np.uint8), device=dev).float()
        d = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        m = torch.as_tensor(np.asarray(mask) > 0, device=dev)
        r = int(self.est["register_mask_dilation"])
        if r:
            gate = image.dilate(m, r)
            d = torch.where(gate, d, torch.zeros_like(d))
            rgb_t = rgb_t * gate[..., None]
        d = image.bilateral_depth(image.erode_depth(d))
        valid = m & (d >= 0.001)
        n = int(valid.sum())
        vs, us = torch.nonzero(m, as_tuple=True)
        uc = (us.min().float() + us.max().float()) / 2.0
        vc = (vs.min().float() + vs.max().float()) / 2.0
        s = torch.sort(d[valid]).values
        zc = (s[(n - 1) // 2] + s[n // 2]) / 2.0
        center = torch.linalg.inv(K_t) @ torch.stack([uc, vc, torch.ones_like(uc)]) * zc
        return Observation(rgb_t, geo.depth_to_xyz(d, K_t), K_t), center

    def start(self, center):
        hyp = self.grid.clone()
        hyp[:, :3, 3] = center[None]
        return hyp

    def track_observation(self, K, rgb, depth, hint_pose):
        """The fixed host window around the last pose (full frame when the
        object would not fit), depth in 0.25 mm steps, filtered."""
        K = np.asarray(K, np.float64).copy()
        rgb = np.asarray(rgb, np.uint8)
        depth = np.asarray(depth, np.float32)
        S = int(self.est["track_crop_size"])
        H, W = depth.shape
        t = hint_pose[:3, 3]
        z = max(float(t[2]), 1e-3)
        side = 2.0 * (self.diameter * 1.2 / 2.0) * max(K[0, 0], K[1, 1]) / z \
            * self.est["track_crop_margin"]
        if S and not (H <= S and W <= S) and side <= S:
            u = K[0, 0] * t[0] / z + K[0, 2]
            v = K[1, 1] * t[1] / z + K[1, 2]
            u0 = int(np.clip(round(u - S / 2), 0, max(W - S, 0)))
            v0 = int(np.clip(round(v - S / 2), 0, max(H - S, 0)))
            rgb = np.ascontiguousarray(rgb[v0:v0 + S, u0:u0 + S])
            depth = np.ascontiguousarray(depth[v0:v0 + S, u0:u0 + S])
            K[0, 2] -= u0
            K[1, 2] -= v0
        dmax = float(depth.max()) if depth.size else 0.0
        scale = 0.00025 if dmax <= 0.00025 * 65535.0 else dmax / 65535.0
        q = (np.clip(depth, 0.0, None) * (1.0 / scale) + 0.5).astype(np.uint16)
        depth = q.astype(np.float32) * np.float32(scale)
        dev = self.device
        K_t = torch.as_tensor(K.astype(np.float32), device=dev)
        d = image.bilateral_depth(image.erode_depth(torch.as_tensor(depth, device=dev)))
        return Observation(torch.as_tensor(rgb, device=dev).float(), geo.depth_to_xyz(d, K_t), K_t)

    # ---- crops --------------------------------------------------------------
    def crops(self, poses, obs, z_thres, normalize, with_normal=False, gate_px=0):
        S = self.size
        tfs = geo.crop_windows(poses, obs.K, 1.2, self.diameter, S)
        r = raster.render(self.mesh, poses, obs.K, tfs, (S, S), cull=self.cull,
                          with_normal=with_normal)
        rgbB = image.warp_crops(obs.rgb, tfs, S) / 255.0
        valid_src = (obs.xyz[..., 2:] >= z_thres).float()
        w = image.warp_crops(torch.cat([obs.xyz, valid_src], dim=-1), tfs, S, nearest=True)
        xyzB, validB = w[..., :3], w[..., 3:] > 0.5
        if gate_px:
            g = image.dilate(r["mask"], int(gate_px))[..., None]
            rgbB = rgbB * g
            xyzB = torch.where(g, xyzB, torch.zeros_like(xyzB))
            validB = validB & g
        t = poses[:, :3, 3][:, None, None, :]

        def norm(xyz, valid=None):
            invalid = xyz[..., 2:3] < z_thres
            if valid is not None:
                invalid = invalid | ~valid
            c = xyz - t
            if not normalize:
                return c
            s = c / (self.diameter / 2.0)
            return torch.where(invalid | (s.abs() >= 2), torch.zeros_like(s), s)

        return {"A": torch.cat([r["rgb"], norm(r["xyz"])], dim=-1),
                "B": torch.cat([rgbB, norm(xyzB, validB)], dim=-1),
                "mask": r["mask"], "validB": validB, "normalA": r.get("normal")}

    # ---- refine -------------------------------------------------------------
    def refine(self, poses, obs, iterations, gate_px=0):
        for _ in range(int(iterations)):
            poses = self._learned_step(poses, obs, gate_px) if self.learned \
                else self._icp_step(poses, obs, gate_px)
        return poses

    def _learned_step(self, poses, obs, gate_px):
        c = self.crops(poses, obs, 0.001, True, gate_px=gate_px)
        trans, rot = self.refine_net(c["A"], c["B"])
        R = geo.so3_exp(torch.tanh(rot) * ROT_NORMALIZER).transpose(1, 2)
        return geo.apply_delta(poses, trans * (self.diameter / 2.0), R)

    def _icp_step(self, poses, obs, gate_px):
        """One projective ICP step: associate rendered and observed points
        pixel by pixel, keep pairs under twice the mean error (inside [tau_rel
        / 2, tau0_rel] x diameter), and take one damped point-to-plane +
        point-to-point Gauss-Newton step."""
        g = self.cfg["geometric"]
        tau0 = g["tau0_rel"] * self.diameter
        tau1 = 0.5 * g["tau_rel"] * self.diameter
        c = self.crops(poses, obs, 0.001, False, with_normal=True, gate_px=gate_px)
        t = poses[:, :3, 3][:, None, None, :]
        xyzA, xyzB = c["A"][..., 3:] + t, c["B"][..., 3:] + t
        valid = (c["mask"][..., None] & (xyzA[..., 2:3] > 0.001) & c["validB"]).float()
        err = torch.linalg.norm(xyzA - xyzB, dim=-1, keepdim=True)
        n_valid = valid.sum(dim=(1, 2, 3)).clamp_min(1.0)
        e_mean = (valid * err.clamp_max(tau0)).sum(dim=(1, 2, 3)) / n_valid
        tau = (2.0 * e_mean).clamp(tau1, tau0)[:, None, None, None]
        w = (valid * (err < tau).float())[..., 0]
        B = poses.shape[0]
        delta = point_to_plane(xyzA.reshape(B, -1, 3), xyzB.reshape(B, -1, 3),
                               c["normalA"].reshape(B, -1, 3), w.reshape(B, -1))
        return delta @ poses

    # ---- scores -------------------------------------------------------------
    def score(self, poses, obs, gate_px=0):
        g = self.geo_score(poses, obs, gate_px)
        if not self.learned:
            return g
        c = self.crops(poses, obs, 0.1, True, gate_px=gate_px)
        return self.score_net(c["A"], c["B"]) + self.cfg["hybrid_weight"] * g

    def geo_score(self, poses, obs, gate_px=0):
        """Depth inliers minus violations minus half the silhouette misses,
        plus normal agreement and silhouette-edge alignment."""
        g = self.cfg["geometric"]
        tau = g["tau_rel"] * self.diameter * 0.5
        c = self.crops(poses, obs, 0.001, False, with_normal=True, gate_px=gate_px)
        t = poses[:, :3, 3][:, None, None, :]
        xyzB = c["B"][..., 3:] + t
        zA = c["A"][..., 5] + t[..., 2]
        zB = xyzB[..., 2]
        validA = c["mask"] & (zA > 0.001)
        validB = c["validB"][..., 0]
        both = validA & validB
        inlier = both & ((zA - zB).abs() < tau)
        violation = both & (zB < zA - tau)
        miss = validA & ~validB

        def count(m):
            return m.sum(dim=(1, 2)).float()

        depth_score = (count(inlier) - count(violation) - 0.5 * count(miss)) / count(validA).clamp_min(1)
        nB, nB_ok = _observed_normals(xyzB, validB)
        ok = inlier & nB_ok
        cos = ((c["normalA"] * nB).sum(-1) * ok).sum(dim=(1, 2)) / count(ok).clamp_min(1)
        interior = validA
        for s, ax in ((1, -1), (-1, -1), (1, -2), (-1, -2)):
            interior = interior & torch.roll(validA, s, dims=ax)
        edgeA = validA & ~interior
        zB0 = torch.where(validB, zB, torch.zeros_like(zB))
        jump = torch.zeros_like(validB)
        for ax, s in ((-1, 1), (-1, -1), (-2, 1), (-2, -1)):
            nv = torch.roll(validB, s, dims=ax)
            jump = jump | (nv & ((zB0 - torch.roll(zB0, s, dims=ax)).abs() > tau)) | ~nv
        edgeB = validB & jump
        for ax in (-1, -2):
            edgeB = edgeB | torch.roll(edgeB, 1, dims=ax) | torch.roll(edgeB, -1, dims=ax)
        edge = count(edgeA & edgeB) / count(edgeA).clamp_min(1)
        return depth_score + g["w_normal"] * cos + g["w_edge"] * edge

    # ---- tracking -----------------------------------------------------------
    def track_fan(self):
        """The chain pose and its perturbed copies as (K-1, 6) [dt | dw]."""
        dt = self.est["track_perturb_trans_rel"] * self.diameter
        dr = np.radians(self.est["track_perturb_rot_deg"])
        fan = np.array([[+dt, 0, 0, 0, 0, 0], [-dt, 0, 0, 0, 0, 0], [0, +dt, 0, 0, 0, 0],
                        [0, -dt, 0, 0, 0, 0], [0, 0, 0, 0, 0, +dr], [0, 0, 0, 0, 0, -dr],
                        [+dt * 0.7071, +dt * 0.7071, 0, 0, 0, 0]], np.float32)
        k = int(self.est["track_hypotheses"])
        if k - 1 > len(fan):
            raise ValueError("the reference knows the first 8 tracking hypotheses only")
        return torch.as_tensor(fan[:k - 1], device=self.device)

    def track_start(self, chain_pose):
        """The chain pose and its perturbed copies (K,4,4), in the engine's
        order: the chain pose first."""
        pose = torch.as_tensor(np.asarray(chain_pose, np.float32), device=self.device)[None]
        fan = self.track_fan()
        base = pose.expand(fan.shape[0], 4, 4)
        return torch.cat([pose, geo.apply_delta(base, fan[:, :3], geo.so3_exp(fan[:, 3:]))])

    def to_original(self, poses):
        """Poses of the centred mesh (B,4,4) -> of the original mesh, float64
        numpy."""
        return np.asarray(poses.detach().cpu().numpy(), np.float64) @ self.tf_centred


def _observed_normals(xyz, valid):
    """Central-difference normals facing the camera. The validity of the
    'dv' neighbours is taken along the hypothesis axis, as the engine's
    scorer does it."""
    dx = torch.roll(xyz, -1, dims=-2) - torch.roll(xyz, 1, dims=-2)
    dy = torch.roll(xyz, -1, dims=-3) - torch.roll(xyz, 1, dims=-3)
    vx = torch.roll(valid, -1, dims=-2) & torch.roll(valid, 1, dims=-2)
    vy = torch.roll(valid, -1, dims=-3) & torch.roll(valid, 1, dims=-3)
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.where(n[..., 2:3] > 0, -n, n), valid & vx & vy


def point_to_plane(p, q, n, w, mu=0.2, damping=1e-6):
    """D = exp([t, theta]) minimising sum w (n.(p + theta x p + t - q))^2 +
    mu sum w |p + theta x p + t - q|^2, one damped Gauss-Newton step;
    identity where the weights sum to 10 or less."""
    batch = w.shape[:-1]
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    r3 = p - q
    r = (n * r3).sum(dim=-1)
    J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)
    wJt = (w[..., None] * J).transpose(-1, -2)
    A = wJt @ J
    b = -(wJt @ r[..., None])[..., 0]
    wp = w[..., None] * p
    M = wp.transpose(-1, -2) @ p
    sw = w.sum(dim=-1)
    swp = geo.hat(wp.sum(dim=-2))
    A3 = torch.zeros((*batch, 6, 6), dtype=p.dtype, device=p.device)
    A3[..., :3, :3] = M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye3 - M
    A3[..., :3, 3:] = swp
    A3[..., 3:, :3] = -swp
    A3[..., 3:, 3:] = sw[..., None, None] * eye3
    wr3 = w[..., None] * r3
    b3 = torch.cat([torch.linalg.cross(p, wr3, dim=-1).sum(dim=-2), wr3.sum(dim=-2)], dim=-1)
    A = A + mu * A3
    b = b - mu * b3
    eye6 = torch.eye(6, dtype=p.dtype, device=p.device)
    trace = A.diagonal(dim1=-2, dim2=-1).sum(-1)
    A = A + (damping * trace / 6.0)[..., None, None] * eye6 + 1e-9 * eye6
    x = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
    T = geo.se3_exp(torch.cat([x[..., 3:], x[..., :3]], dim=-1))
    eye4 = torch.eye(4, dtype=T.dtype, device=T.device).expand(*batch, 4, 4)
    return torch.where((sw > 10.0)[..., None, None], T, eye4)
