"""Gauss-Newton bundle adjustment with Schur-complement reduction.

Counterpart of foundationpose_tpu/slam/ba.py. Keyframe poses ``T_k`` (object
-> camera, (K,4,4)) and landmarks ``X_l`` (object frame, (L,3)); observation m
of landmark l in keyframe ``k = obs_kf[l,m]`` is a depth-backprojected camera
point ``y``. Residual ``r = R_k X_l + t_k - y`` (point-to-point, plus
point-to-plane ``n.r`` where a normal is observed), Huber IRLS weights,
left-multiplicative pose updates ``T_k <- exp([w, v]) T_k`` and landmark
updates ``X_l <- X_l + dX``:

    J_pose = [ -[p]x | I3 ],  p = R_k X_l + t_k        J_lm = R_k

The landmark block A of the normal equations is 3x3 block-diagonal, so it is
eliminated: ``S = U - W A^-1 W^T`` (6K,6K), ``rhs = b_p - W A^-1 b_l``; solve
``S dxi = rhs`` (damped, gauge poses pinned), back-substitute
``dX = A^-1 (b_l - W^T dxi)``.

Every term of S, rhs and the cost is a sum over landmarks. The GN step runs
on the device in float32 (TF32 off: this is geometry); its sums are einsums
over the landmark axis. With a ``mesh`` the landmark axis is split over the
processes of its ``batch`` axis: each forms its partial (S, rhs, cost), one
``all_reduce`` adds them (where the JAX package ``psum``s), the small dense
solve is repeated on every process, and back-substitution stays per process.
The LM loop reads the two costs on the host once per iteration, as the JAX
package's does.

``build_ba_problem`` and ``_normal_maps`` are host numpy, this module's own
copy of the JAX package's, so the problem it builds (landmark draws from
``np.random.default_rng(seed)`` included) is the same bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.core import geometry as geo


@dataclasses.dataclass(frozen=True)
class BAConfig:
    n_iters: int = 8
    damping: float = 1e-4          # initial LM lambda (adapted per iteration)
    damping_max: float = 1e2
    huber_delta_rel: float = 1.0   # Huber delta as a multiple of `scale`
    scale: float = 0.01            # residual scale (m); sets the IRLS knee
    min_obs: int = 2               # landmarks with fewer valid obs are dropped
    # per-iteration trust region (rad, m): projective re-association only
    # heals within it, so an unclipped step that jumps basins never returns
    max_rot_step: float = 0.15
    max_trans_step: float = 0.02
    # prior anchoring each pose at its initial value (weight per unit of
    # rot[rad] / trans[m] squared error); bounds drift along the null spaces
    # of depth-only BA on symmetric shapes. 0 disables.
    pose_prior: float = 0.0
    # point-to-point weight where a normal is observed (the point-to-plane
    # term carries the constraint; mu damps the in-plane null space)
    mu: float = 0.1


def _skew(p):
    """(...,3) -> (...,3,3) cross-product matrices."""
    z = torch.zeros_like(p[..., 0])
    return torch.stack(
        [
            torch.stack([z, -p[..., 2], p[..., 1]], dim=-1),
            torch.stack([p[..., 2], z, -p[..., 0]], dim=-1),
            torch.stack([-p[..., 1], p[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _huber_weight(r_norm, delta):
    """IRLS weight for the Huber kernel: 1 inside, delta/|r| outside."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm),
                       delta / r_norm.clamp_min(1e-12))


def _row_weights(w, r, obs_n, mu):
    """(w_pt, w_pl, rn): point-row and plane-row weights and the plane
    residuals n.r (zero without normals)."""
    if obs_n is None:
        return w, torch.zeros_like(w), torch.zeros_like(w)
    has_n = (torch.linalg.norm(obs_n, dim=-1) > 0.5).to(w.dtype)
    w_pt = w * torch.where(has_n > 0, torch.full_like(w, mu), torch.ones_like(w))
    return w_pt, w * has_n, torch.einsum("lmi,lmi->lm", obs_n, r)


def _residuals(poses, X, obs_kf, obs_pt):
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Rk = R[obs_kf]  # (Ls,M,3,3)
    p = torch.einsum("lmij,lj->lmi", Rk, X) + t[obs_kf]  # (Ls,M,3)
    return Rk, p, p - obs_pt


def _landmark_terms(poses, X, obs_kf, obs_pt, obs_w, obs_n, K_poses, huber_delta, mu):
    """Per-landmark contributions to the reduced camera system.

    poses: (K,4,4); X: (Ls,3); obs_kf: (Ls,M) int64; obs_pt: (Ls,M,3);
    obs_w: (Ls,M) base weights (0 = padding); obs_n: (Ls,M,3) or None.
    Returns (S_part (K,6,K,6), rhs_part (K,6), A (Ls,3,3), b_l (Ls,3),
    Wd (Ls,K,6,3), cost_part ()) — sums over landmarks, addable across
    processes."""
    Rk, p, r = _residuals(poses, X, obs_kf, obs_pt)
    r_norm = torch.linalg.norm(r, dim=-1)
    w = obs_w * _huber_weight(r_norm, huber_delta)  # (Ls,M)

    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    Jp = torch.cat([-_skew(p), eye3.expand(*p.shape[:-1], 3, 3)], dim=-1)  # (Ls,M,3,6)
    Jl = Rk  # (Ls,M,3,3)
    w_pt, w_pl, rn = _row_weights(w, r, obs_n, mu)
    if obs_n is not None:
        Jpn = torch.einsum("lmi,lmij->lmj", obs_n, Jp)  # (Ls,M,6)
        Jln = torch.einsum("lmi,lmij->lmj", obs_n, Jl)  # (Ls,M,3)
    else:
        Jpn = torch.zeros(Jp.shape[:2] + (6,), dtype=Jp.dtype, device=Jp.device)
        Jln = torch.zeros(Jl.shape[:2] + (3,), dtype=Jl.dtype, device=Jl.device)

    # landmark blocks (A, b_l): 3x3 per landmark
    A = torch.einsum("lm,lmri,lmrj->lij", w_pt, Jl, Jl) + torch.einsum(
        "lm,lmi,lmj->lij", w_pl, Jln, Jln)
    b_l = -torch.einsum("lm,lmri,lmr->li", w_pt, Jl, r) - torch.einsum(
        "lm,lmi,lm->li", w_pl, Jln, rn)

    # pose blocks, scattered over the (small) K axis through a one-hot
    onehot = torch.nn.functional.one_hot(obs_kf, K_poses).to(poses.dtype)  # (Ls,M,K)
    U = torch.einsum("lm,lmk,lmri,lmrj->kij", w_pt, onehot, Jp, Jp) + torch.einsum(
        "lm,lmk,lmi,lmj->kij", w_pl, onehot, Jpn, Jpn)
    b_p = -torch.einsum("lm,lmk,lmri,lmr->ki", w_pt, onehot, Jp, r) - torch.einsum(
        "lm,lmk,lmi,lm->ki", w_pl, onehot, Jpn, rn)
    # coupling W: (Ls,K,6,3)
    Wd = torch.einsum("lm,lmk,lmri,lmrj->lkij", w_pt, onehot, Jp, Jl) + torch.einsum(
        "lm,lmk,lmi,lmj->lkij", w_pl, onehot, Jpn, Jln)

    # Schur pieces
    Ainv = torch.linalg.inv_ex(A + 1e-9 * eye3).inverse  # (Ls,3,3)
    WAinv = torch.einsum("lkij,ljn->lkin", Wd, Ainv)  # (Ls,K,6,3)
    S_corr = torch.einsum("lkin,lqjn->kiqj", WAinv, Wd)  # (K,6,K,6)
    rhs_corr = torch.einsum("lkin,ln->ki", WAinv, b_l)  # (K,6)

    kk = torch.arange(K_poses, device=p.device)
    S_part = torch.zeros((K_poses, 6, K_poses, 6), dtype=p.dtype, device=p.device)
    S_part[kk, :, kk, :] = U
    S_part = S_part - S_corr
    rhs_part = b_p - rhs_corr
    cost_part = (w_pt * r_norm**2).sum() + (w_pl * rn**2).sum()
    return S_part, rhs_part, A, b_l, Wd, cost_part


def _apply_pose_update(poses, dxi):
    """Left-multiplicative SE(3) update: T <- exp([w,v]) T. dxi: (K,6) as
    [w(3), v(3)] (``se3_exp_map`` takes [v, w])."""
    return geo.se3_exp_map(torch.cat([dxi[:, 3:], dxi[:, :3]], dim=-1)) @ poses


def _cost_only(poses, X, obs_kf, obs_pt, obs_w, obs_n, huber_delta, mu):
    """Robust cost at (poses, X): a sum over landmarks."""
    _, _, r = _residuals(poses, X, obs_kf, obs_pt)
    r_norm = torch.linalg.norm(r, dim=-1)
    w = obs_w * _huber_weight(r_norm, huber_delta)
    if obs_n is None:
        return (w * r_norm**2).sum()
    w_pt, w_pl, rn = _row_weights(w, r, obs_n, mu)
    return (w_pt * r_norm**2).sum() + (w_pl * rn**2).sum()


def _prior_eta(poses, poses_init):
    """Per-pose prior residual log(T_k T0_k^-1) as [w, v] (small-angle v)."""
    D = poses @ torch.linalg.inv(poses_init)
    return torch.cat([geo.so3_log_map(D[:, :3, :3]), D[:, :3, 3]], dim=-1)


def _identity(x):
    return x


@torch.no_grad()
def _ba_iteration(poses, X, obs_kf, obs_pt, obs_w, obs_n, fixed_mask, lam, poses_init, cfg,
                  reduce=_identity):
    """One damped-GN iteration. ``reduce`` adds a partial sum over the
    processes that share the landmark axis (the identity on one process).
    ``lam`` is the current LM lambda. Returns (poses_new, X_new, cost_old,
    cost_new); the host accepts the step only when cost_new <= cost_old."""
    K_poses = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    huber_delta = cfg.huber_delta_rel * cfg.scale
    S, rhs, A, b_l, Wd, cost = _landmark_terms(
        poses, X, obs_kf, obs_pt, obs_w, obs_n, K_poses, huber_delta, cfg.mu)
    S, rhs, cost = reduce(S), reduce(rhs), reduce(cost)

    kk = torch.arange(K_poses, device=dev)
    if cfg.pose_prior > 0:
        eta = _prior_eta(poses, poses_init)  # (K,6)
        S = S.clone()
        S[kk, :, kk, :] += cfg.pose_prior * torch.eye(6, dtype=dt, device=dev)
        rhs = rhs - cfg.pose_prior * eta
        cost = cost + cfg.pose_prior * (eta**2).sum()

    S2 = S.reshape(6 * K_poses, 6 * K_poses)
    rhs2 = rhs.reshape(6 * K_poses)
    # gauge fixing: identity rows/cols and zero rhs for pinned poses
    free = (~fixed_mask).repeat_interleave(6).to(dt)  # (6K,)
    S2 = S2 * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    rhs2 = rhs2 * free
    # LM damping on the diagonal
    S2 = S2 + lam * torch.diag(torch.diag(S2)) + 1e-9 * torch.eye(6 * K_poses, dtype=dt, device=dev)

    dxi = torch.linalg.solve_ex(S2, rhs2[:, None]).result[:, 0].reshape(K_poses, 6)
    # trust region: scale each pose's step so |rot| and |trans| stay bounded
    rot_n = torch.linalg.norm(dxi[:, :3], dim=-1, keepdim=True)
    tr_n = torch.linalg.norm(dxi[:, 3:], dim=-1, keepdim=True)
    s = torch.minimum((cfg.max_rot_step / rot_n.clamp_min(1e-12)).clamp_max(1.0),
                      (cfg.max_trans_step / tr_n.clamp_min(1e-12)).clamp_max(1.0))
    dxi = dxi * s
    poses_new = _apply_pose_update(poses, dxi)

    # back-substitution (per landmark, stays with its process)
    Ainv = torch.linalg.inv_ex(A + 1e-9 * torch.eye(3, dtype=dt, device=dev)).inverse
    dX = torch.einsum("lij,lj->li", Ainv, b_l - torch.einsum("lkij,ki->lj", Wd, dxi))
    X_new = X + dX

    cost_new = reduce(_cost_only(poses_new, X_new, obs_kf, obs_pt, obs_w, obs_n,
                                 huber_delta, cfg.mu))
    if cfg.pose_prior > 0:
        eta_new = _prior_eta(poses_new, poses_init)
        cost_new = cost_new + cfg.pose_prior * (eta_new**2).sum()
    return poses_new, X_new, cost, cost_new


def bundle_adjust(poses, landmarks, obs_kf, obs_pt, obs_w, obs_n=None, fixed_mask=None,
                  config: BAConfig | None = None, mesh=None, poses_init=None, device=None):
    """Damped Gauss-Newton BA.

    poses: (K,4,4) object->camera; landmarks: (L,3) object frame; obs_kf:
    (L,M) keyframe index per observation; obs_pt: (L,M,3) observed camera
    points; obs_w: (L,M) weights, 0 = padding; obs_n: optional (L,M,3)
    observed normals (camera frame) for point-to-plane rows; fixed_mask: (K,)
    bool, True = pinned (default: pose 0).

    ``mesh``: optional ``parallel.mesh.Mesh`` whose ``batch`` axis splits the
    landmarks (L padded to a multiple of its size with zero-weight landmarks);
    every process passes the whole problem and gets the whole result.
    ``device=None`` means cuda (the mesh's device when a mesh is given).

    Returns (poses (K,4,4), landmarks (L,3), costs (n_iters,)) as float32
    tensors on the device.
    """
    cfg = config or BAConfig()
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    poses = geo.as_f32(poses, dev)
    X = geo.as_f32(landmarks, dev)
    obs_kf = torch.as_tensor(obs_kf, device=dev).long()
    obs_pt = geo.as_f32(obs_pt, dev)
    obs_w = geo.as_f32(obs_w, dev)
    if obs_n is not None:
        obs_n = geo.as_f32(obs_n, dev)
    K_poses = poses.shape[0]
    if fixed_mask is None:
        fixed_mask = np.zeros(K_poses, bool)
        fixed_mask[0] = True
    fixed_mask = torch.as_tensor(np.asarray(fixed_mask, bool), device=dev)
    poses_init = poses if poses_init is None else geo.as_f32(poses_init, dev)

    # drop under-observed landmarks (their A would be singular)
    keep = (obs_w > 0).sum(dim=1) >= cfg.min_obs
    obs_w = obs_w * keep[:, None]

    if mesh is None:
        return _lm_loop(functools.partial(_ba_iteration, cfg=cfg), poses, X, obs_kf, obs_pt,
                        obs_w, obs_n, fixed_mask, poses_init, cfg)

    from foundationpose_tpu_torch.parallel.mesh import all_gather_rows, all_sum

    n_proc, i = mesh.size("batch"), mesh.index("batch")
    L = X.shape[0]
    per = -(-L // n_proc)

    def mine(x):
        """This process's landmarks, zero-padded to ``per`` rows."""
        x = torch.cat([x, x.new_zeros((per * n_proc - L,) + x.shape[1:])])
        return x[i * per:(i + 1) * per]

    step = functools.partial(_ba_iteration, cfg=cfg,
                             reduce=functools.partial(all_sum, mesh, axis="batch"))
    poses, X_mine, costs = _lm_loop(step, poses, mine(X), mine(obs_kf), mine(obs_pt),
                                    mine(obs_w), None if obs_n is None else mine(obs_n),
                                    fixed_mask, poses_init, cfg)
    return poses, all_gather_rows(mesh, X_mine, "batch")[:L], costs


def _lm_loop(step, poses, X, obs_kf, obs_pt, obs_w, obs_n, fixed_mask, poses_init, cfg):
    """Levenberg-Marquardt control on the host: accept a step only when the
    robust cost does not rise, else keep the state and raise lambda. One
    host read of the two costs per iteration."""
    lam = cfg.damping
    costs = []
    for _ in range(cfg.n_iters):
        poses_new, X_new, cost, cost_new = step(
            poses, X, obs_kf, obs_pt, obs_w, obs_n, fixed_mask,
            torch.tensor(lam, dtype=torch.float32, device=poses.device), poses_init)
        costs.append(cost)
        c_old, c_new = torch.stack([cost, cost_new]).tolist()
        if c_new <= c_old:
            poses, X = poses_new, X_new
            lam = max(lam * 0.5, 1e-6)
        else:
            lam = min(lam * 10.0, cfg.damping_max)
    return poses, X, torch.stack(costs)


# ---------------------------------------------------------------------------
# Problem construction from keyframes (projective data association), host numpy
# ---------------------------------------------------------------------------

def _normal_maps(depths, K):
    """Camera-space surface normals from depth maps by central differences of
    the backprojected xyz map; zero where invalid. depths: (F,H,W)."""
    F, H, W = depths.shape
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    x = (us - K[0, 2]) / K[0, 0] * depths
    y = (vs - K[1, 2]) / K[1, 1] * depths
    xyz = np.stack([x, y, depths], axis=-1)  # (F,H,W,3)
    du = np.zeros_like(xyz)
    dv = np.zeros_like(xyz)
    du[:, :, 1:-1] = xyz[:, :, 2:] - xyz[:, :, :-2]
    dv[:, 1:-1, :] = xyz[:, 2:, :] - xyz[:, :-2, :]
    n = np.cross(du, dv)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    # orient toward the camera (points have +z; camera at origin)
    flip = np.sum(n * xyz, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    valid = (depths > 0.001)[..., None] & (norm > 1e-9)
    # a normal differenced across a depth edge is garbage: the neighbours
    # used must be close in depth
    edge = np.zeros_like(depths, bool)
    edge[:, :, 1:-1] |= np.abs(depths[:, :, 2:] - depths[:, :, :-2]) > 0.02
    edge[:, 1:-1, :] |= np.abs(depths[:, 2:, :] - depths[:, :-2, :]) > 0.02
    edge |= depths <= 0.001
    return np.where(valid & ~edge[..., None], n, 0.0).astype(np.float32)


def build_ba_problem(depths, masks, cam_in_obs, K, n_landmarks=512, max_obs=None,
                     assoc_tau=0.015, seed=0, use_normals=True, crease_w=0.2):
    """3D-point BA problem from keyframe depth maps by projective association.

    Landmark candidates are drawn from every keyframe's masked depth and
    backprojected into the object frame with the current pose estimates; a
    landmark is observed in keyframe k when it projects inside k's mask and
    the bilinear depth there agrees within ``assoc_tau``. Normals from the
    depth maps make the residuals point-to-plane.

    depths: (F,H,W); masks: (F,H,W); cam_in_obs: (F,4,4); K: (3,3). Returns
    dict(poses_ob_in_cam (F,4,4), landmarks (L,3), obs_kf (L,M), obs_pt
    (L,M,3), obs_w (L,M), obs_n (L,M,3) or None), numpy.
    """
    depths = np.asarray(depths, np.float32)
    masks = np.asarray(masks) > 0
    cam_in_obs = np.asarray(cam_in_obs, np.float64)
    K = np.asarray(K, np.float64)
    F, H, W = depths.shape
    max_obs = max_obs or F
    rng = np.random.default_rng(seed)
    Kinv = np.linalg.inv(K)
    normals = _normal_maps(depths, K) if use_normals else None

    # candidates round-robin across frames; pixels without a clean normal
    # (creases, silhouettes) stay and become point-to-point rows
    per_frame = int(np.ceil(n_landmarks / F))
    lm_obj = []
    lm_n_obj = []
    for f in range(F):
        ok = masks[f] & (depths[f] > 0.001)
        vs, us = np.where(ok)
        if len(us) == 0:
            continue
        sel = rng.choice(len(us), size=min(per_frame, len(us)), replace=False)
        u, v = us[sel], vs[sel]
        z = depths[f][v, u]
        pc = (Kinv @ np.stack([u * z, v * z, z])).T  # cam points (n,3)
        po = (cam_in_obs[f] @ np.concatenate([pc, np.ones((len(pc), 1))], 1).T).T[:, :3]
        lm_obj.append(po)
        if normals is not None:
            lm_n_obj.append(normals[f][v, u] @ cam_in_obs[f][:3, :3].T)
    if not lm_obj:
        raise ValueError("no valid landmark candidates (empty masks/depths)")
    lm_obj = np.concatenate(lm_obj)[:n_landmarks]
    lm_n_obj = np.concatenate(lm_n_obj)[:n_landmarks] if lm_n_obj else None
    L = len(lm_obj)

    ob_in_cams = np.linalg.inv(cam_in_obs)  # (F,4,4)
    pts_h = np.concatenate([lm_obj, np.ones((L, 1))], axis=1)  # (L,4)
    cam_pts = np.einsum("fij,lj->fli", ob_in_cams, pts_h)[..., :3]  # (F,L,3)
    z = cam_pts[..., 2]
    uv = np.einsum("ij,flj->fli", K, cam_pts)
    u = uv[..., 0] / np.maximum(uv[..., 2], 1e-9)
    v = uv[..., 1] / np.maximum(uv[..., 2], 1e-9)

    # bilinear depth at the exact subpixel; valid only when all four taps
    # exist and agree (no sampling across depth edges)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0).astype(np.float32)
    fv = (v - v0).astype(np.float32)
    inb = (z > 0.001) & (u0 >= 0) & (u0 < W - 1) & (v0 >= 0) & (v0 < H - 1)
    u0c = np.clip(u0, 0, W - 2)
    v0c = np.clip(v0, 0, H - 2)
    fidx = np.arange(F)[:, None]
    d00 = depths[fidx, v0c, u0c]
    d01 = depths[fidx, v0c, u0c + 1]
    d10 = depths[fidx, v0c + 1, u0c]
    d11 = depths[fidx, v0c + 1, u0c + 1]
    taps = np.stack([d00, d01, d10, d11])
    taps_ok = (taps > 0.001).all(0) & (taps.max(0) - taps.min(0) < assoc_tau)
    d_obs = (d00 * (1 - fu) * (1 - fv) + d01 * fu * (1 - fv)
             + d10 * (1 - fu) * fv + d11 * fu * fv)
    m_obs = masks[fidx, v0c, u0c]
    valid = inb & taps_ok & m_obs & (np.abs(d_obs - z) < assoc_tau)

    # observed camera point at the exact subpixel
    y = np.stack([(u - K[0, 2]) / K[0, 0] * d_obs, (v - K[1, 2]) / K[1, 1] * d_obs, d_obs],
                 axis=-1)  # (F,L,3)
    if normals is not None:
        n_obs_map = normals[fidx, np.round(v).astype(np.int64).clip(0, H - 1),
                            np.round(u).astype(np.int64).clip(0, W - 1)]  # (F,L,3)
        lm_n_cam = np.einsum("fij,lj->fli", ob_in_cams[:, :3, :3], lm_n_obj)
        has_lm_n = np.linalg.norm(lm_n_obj, axis=-1) > 0.5  # (L,)
        has_obs_n = np.linalg.norm(n_obs_map, axis=-1) > 0.5  # (F,L)
        agree = np.sum(n_obs_map * lm_n_cam, axis=-1)  # (F,L)
        # both normals clean and within ~20 deg: a plane observation; either
        # crease-like: a point observation; both clean but disagreeing: a
        # mis-association across surfaces, dropped
        plane_obs = has_lm_n[None] & has_obs_n & (agree > 0.94)
        mismatch = has_lm_n[None] & has_obs_n & (agree <= 0.94)
        valid &= ~mismatch
        n_obs_map = np.where(plane_obs[..., None], n_obs_map, 0.0)
        # crease / silhouette point observations: down-weighted anchors
        w_map = np.where(plane_obs, 1.0, crease_w).astype(np.float32)
    else:
        w_map = np.ones((F, L), np.float32)

    # pack to (L, max_obs)
    obs_kf = np.zeros((L, max_obs), np.int32)
    obs_pt = np.zeros((L, max_obs, 3), np.float32)
    obs_w = np.zeros((L, max_obs), np.float32)
    obs_n = np.zeros((L, max_obs, 3), np.float32)
    for l in range(L):
        fs = np.where(valid[:, l])[0][:max_obs]
        obs_kf[l, : len(fs)] = fs
        obs_pt[l, : len(fs)] = y[fs, l]
        obs_w[l, : len(fs)] = w_map[fs, l]
        if normals is not None:
            obs_n[l, : len(fs)] = n_obs_map[fs, l]

    return dict(
        poses_ob_in_cam=ob_in_cams.astype(np.float32),
        landmarks=lm_obj.astype(np.float32),
        obs_kf=obs_kf,
        obs_pt=obs_pt,
        obs_w=obs_w,
        obs_n=obs_n if normals is not None else None,
    )


def pose_graph_ba(depths, masks, cam_in_obs, K, n_landmarks=512, config: BAConfig | None = None,
                  mesh=None, rounds=3, device=None):
    """Pose-graph BA over keyframes: ``rounds`` outer loops of [projective
    re-association -> Schur-complement GN] (re-association per round lets
    wrong initial correspondences heal, as in ICP). Returns the refined
    ``cam_in_obs`` (F,4,4) float64 and the final cost. ``pose_prior`` (off by
    default) anchors the poses at the tracked initialisation."""
    cfg = config or BAConfig()
    cams = np.asarray(cam_in_obs, np.float64).copy()
    poses_anchor = np.linalg.inv(cams).astype(np.float32)
    cost = float("nan")
    for _ in range(rounds):
        prob = build_ba_problem(depths, masks, cams, K, n_landmarks=n_landmarks)
        poses, _, costs = bundle_adjust(
            prob["poses_ob_in_cam"], prob["landmarks"], prob["obs_kf"], prob["obs_pt"],
            prob["obs_w"], obs_n=prob["obs_n"], config=cfg, mesh=mesh,
            poses_init=poses_anchor, device=device)
        cams = np.linalg.inv(poses.cpu().numpy().astype(np.float64))
        cost = float(costs[-1])
    return cams, cost
