"""A closed loop of ``register`` calls with one client over a pool of frames.

Each frame shows the object at a seeded rotation resting on the table, seen
from a seeded direction at a distance from a fixed list (the same distances
for every seed, in a seeded order); the ``i``-th call takes pool frame
``i % pool``. One ``register`` call is one unit of work.

Parameters (``traffic/<name>.json``): ``pool``, ``distance_m`` [near, far],
``elevation_deg`` [low, high], ``target_jitter_m``, ``warm_calls``,
``trace_calls``, ``check_calls``.
"""

import numpy as np

from fpbench import judge as judge_mod, pose, scene, traffic

def make_inputs(seed, cfg, tr, device):
    obj = scene.make_object(seed, cfg["object"], device)
    rng, gen = traffic.streams(seed, device)
    K, render = traffic.renderer(seed, cfg, obj, device)
    v = np.asarray(obj["vertices"])
    rgb, depth, mask, gt = [], [], [], []
    n = tr["pool"]
    for d in np.linspace(*tr["distance_m"], n)[rng.permutation(n)]:
        T_wo = traffic.resting(v, scene.random_rotation(rng))
        boxes_t = traffic.boxes_of(rng, obj, device)
        target = T_wo[:3, 3] + rng.uniform(-1, 1, 3) * tr["target_jitter_m"]
        T_cw = traffic.camera(target, d, rng.uniform(0, 2 * np.pi),
                              np.radians(rng.uniform(*tr["elevation_deg"])))
        T = T_cw @ T_wo
        f = render.frame(T, T_cw, boxes_t, gen, cfg["noise"])
        for lst, x in zip((rgb, depth, mask, gt), (*f, T)):
            lst.append(x)
    return pose.Inputs(obj, traffic.Frames(K, rgb, depth, mask, gt))


class Client(pose.Client):
    def call(self):
        f = self.inputs.frames
        j = traffic.pool_index(self.i, len(f), False)
        return self._record(j, lambda: self.est.register(f.K, f.rgb[j], f.depth[j], f.mask[j]))


def judge(cell, state, rng, impl, control=None):
    """The readings of a seeded sample of the window's calls; ``control``
    (a reference and its precision) stands in for the engine's records when
    given."""
    f, est_cfg = state["inputs"].frames, cell.config["estimator"]
    out = []
    for p in judge_mod.sample(rng, len(state["answers"]), cell.traffic["check_calls"]):
        j = state["answers"][p][1]
        args = (f.K, f.rgb[j], f.depth[j])
        if control is None:
            rec = state["calls"][p]
        else:
            ctl, precision = control
            with precision():
                rec = judge_mod.engine_register(ctl, *args, f.mask[j], est_cfg)
        out.append(judge_mod.judge_register(impl, rec, *args, f.mask[j], est_cfg))
    return out


summarize = judge_mod.worst


reference = pose.make_reference
