"""``track_one`` frame after frame, on a camera orbiting the object.

One object on the table and a camera circling it at a fixed step per frame,
while the point it looks at drifts on a smooth seeded path; the pool plays
forward, then back (ping-pong). The engine registers on frame 0 before the
first call, outside the window. One tracked frame is one unit of work.

Parameters (``traffic/<name>.json``): ``pool``, ``distance_m``,
``distance_wobble_m``, ``deg_per_frame``, ``elevation_deg`` [low, high],
``target_amplitude_m``, ``target_speed_m`` (per frame), ``warm_calls``,
``trace_calls``, ``check_calls``.
"""

import numpy as np

from fpbench import judge as judge_mod, pose, scene, traffic


def make_inputs(seed, cfg, tr, device):
    obj = scene.make_object(seed, cfg["object"], device)
    rng, gen = traffic.streams(seed, device)
    K, render = traffic.renderer(seed, cfg, obj, device)
    v = np.asarray(obj["vertices"])
    T_wo = traffic.resting(v, scene.random_rotation(rng))
    boxes_t = traffic.boxes_of(rng, obj, device)
    az0, sense = rng.uniform(0, 2 * np.pi), rng.choice([-1.0, 1.0])
    el_lo, el_hi = np.radians(tr["elevation_deg"])
    phase = rng.uniform(0, 2 * np.pi, 4)
    amp, speed = tr["target_amplitude_m"], tr["target_speed_m"]
    w = speed / amp  # rad per frame: the look-at point moves ~speed per frame
    n = tr["pool"]
    rgb, depth, mask, gt = [], [], [], []
    for k in range(n):
        az = az0 + sense * np.radians(tr["deg_per_frame"]) * k
        el = el_lo + (el_hi - el_lo) * 0.5 * (1 + np.sin(2 * np.pi * k / n + phase[3]))
        off = amp * np.array([np.sin(w * k + phase[0]), np.sin(w * k + phase[1]),
                              0.5 * np.sin(w * k + phase[2])])
        d = tr["distance_m"] + tr["distance_wobble_m"] * np.sin(w * k + phase[3])
        T_cw = traffic.camera(T_wo[:3, 3] + off, d, az, el)
        T = T_cw @ T_wo
        f = render.frame(T, T_cw, boxes_t, gen, cfg["noise"])
        for lst, x in zip((rgb, depth, mask, gt), (*f, T)):
            lst.append(x)
    return pose.Inputs(obj, traffic.Frames(K, rgb, depth, mask, gt))


class Client(pose.Client):
    """``chain[i]`` is the engine's chain pose after call ``i`` (``chain[0]``
    after the registration), the state the next frame starts from."""

    def start(self):
        f = self.inputs.frames
        self.est.register(f.K, f.rgb[0], f.depth[0], f.mask[0])
        self.chain = [self.est.pose_last.copy()]
        self.i = 1

    def call(self):
        f = self.inputs.frames
        j = traffic.pool_index(self.i, len(f), True)
        n = self._record(j, lambda: self.est.track_one(f.rgb[j], f.depth[j], f.K))
        self.chain.append(self.est.pose_last.copy())
        return n

    def state(self):
        return {**super().state(), "chain": self.chain}


def judge(cell, state, rng, impl, control=None):
    """The readings of a seeded sample of the window's frames, each from the
    engine's chain pose of the frame before; ``control`` (a reference and its
    precision) stands in for the engine's records when given."""
    f, est_cfg = state["inputs"].frames, cell.config["estimator"]
    out = []
    for p in judge_mod.sample(rng, len(state["answers"]), cell.traffic["check_calls"]):
        i, j, _ = state["answers"][p]
        args = (state["chain"][i - 1], f.K, f.rgb[j], f.depth[j])
        if control is None:
            rec = state["calls"][p]
        else:
            ctl, precision = control
            with precision():
                rec = judge_mod.engine_track(ctl, *args, est_cfg)
        out.append(judge_mod.judge_track(impl, rec, *args, est_cfg))
    return out


summarize = judge_mod.pooled


reference = pose.make_reference
