"""What decides ``correct`` for the pose engine: the engine's timed outputs
held against the plain reference (``benchmark/reference``).

The engine's ``refiner.refine`` and ``scorer.score`` calls of every call of
the window are kept by ``pose.Recorder``. For a seeded sample of calls:

register: the engine hands ``refine`` the start poses (rotation grid x
translation guess) and ``score`` the refined ones, then refines and rescores
the best ``final_refine_top_k`` and returns the best of those. The reference

- learned: refines its own start poses (from the frame) as many iterations
  as the configuration states, and the polish's input as it follows from the
  engine's own refined poses and scores. Per hypothesis the gap is the
  largest distance a model point lands apart under the engine's and the
  reference's pose; ``refine_gap_p75_mm`` is its 75th percentile over the
  hypotheses of the main refinement (a quarter of them left unrefined or
  refined wrong moves it; the widest swings from call to call, a few far-off
  hypotheses wander in bf16 about as far as in the fp8 control);
- geometric: makes each ICP step from the poses the engine's step began
  with (the main chain's first from its own start, the polish's first from
  its own selection): chained, a hard inlier threshold turns last-bit
  differences between K1 and the plain rasterizer into other inliers and
  other renders, so only single steps are held; ``icp_step_gap_p99_mm`` is
  the 99th percentile of the step gaps over every hypothesis and step;
- scores the engine's refined poses, in the engine's batches: ``score_gap``
  is the largest difference of a score, ``score_gap_median`` the median;
- ``answer_gap_m``: how far the returned pose is from the engine's polished
  candidate it should be (exactly 0).

track: the engine refines the chain pose of the frame before and its
perturbed copies, scores them and returns the best (the chain's own wins
ties by +0.01). The reference makes its own hypotheses from that chain pose
and its own observation (host window, 0.25 mm depth steps, filters), refines
them as many iterations as the configuration states, and scores the
engine's refined poses. Hypothesis k is held against hypothesis k:
``refine_gap_p75_mm`` is the 75th percentile of the per-hypothesis gaps
pooled over the judged frames (half of the hypotheses left unrefined moves
it), ``score_gap_median`` the median score difference; ``answer_gap_m`` how
far the returned pose is from the engine's best candidate by its own scores
(float32 rounding only: the engine moves it off the centred mesh on the
card).

Which numbers a cell compares, its limits file says (``limits/<cell>.json``);
the others, and ``choice_gap`` (how far the reference scores the returned
candidate below its best), are reported by ``readings.py``.
"""

import numpy as np
import torch

from reference import geometry as rgeo

from .cell import StructureError


def sample(rng, n, k):
    """``k`` of the ``n`` calls of the window (all where fewer), in order."""
    return sorted(rng.choice(n, size=min(k, n), replace=False))


def _mm(a, b, points):
    return (rgeo.add_gap(a, b, points) * 1e3).cpu().numpy()


def engine_register(impl, K, rgb, depth, mask, est_cfg):
    """A register call made by a reference (a control stands in for the
    engine): its record in the form ``Recorder`` keeps."""
    obs, center = impl.register_observation(K, rgb, depth, mask)

    def refine(poses, n):
        iters = []
        for _ in range(n):
            iters.append(poses)
            poses = impl.refine(poses, obs, 1)
        return poses, iters

    start = impl.start(center)
    main, it0 = refine(start, est_cfg["register_iterations"])
    s0 = impl.score(main, obs)
    steps = [("refine", start, est_cfg["register_iterations"], 0, main, it0),
             ("score", main, None, 0, s0, None)]
    top = _top(s0, impl.n_grid, est_cfg["final_refine_top_k"])
    pol, it1 = refine(main[top], est_cfg["final_refine_iterations"])
    s1 = impl.score(pol, obs)
    steps += [("refine", main[top], est_cfg["final_refine_iterations"], 0, pol, it1),
              ("score", pol, None, 0, s1, None)]
    return {"steps": steps, "answer": impl.to_original(pol)[int(torch.argmax(s1))]}


def _top(scores, n_grid, k):
    masked = scores.clone()
    masked[n_grid:] = -torch.inf
    return torch.argsort(-masked, stable=True)[:k]


def judge_register(ref, rec, K, rgb, depth, mask, est_cfg):
    """The numbers of one register call."""
    steps = rec["steps"]
    kinds = [step[0] for step in steps]
    if kinds != ["refine", "score", "refine", "score"]:
        raise StructureError(f"register made the calls {kinds}, not refine, score, refine, score")
    (_, _, _, _, main, iters0), (_, _, _, _, s0, _), (_, _, _, _, pol, iters1), \
        (_, _, _, _, s1, _) = steps
    # as many iterations as the configuration states, whatever the engine ran
    it0, it1 = est_cfg["register_iterations"], est_cfg["final_refine_iterations"]
    n, dev = ref.n_grid, ref.device
    obs, center = ref.register_observation(K, rgb, depth, mask)
    start = ref.start(center)
    main, s0, pol, s1 = main.to(dev), s0.to(dev), pol.to(dev), s1.to(dev)
    top = _top(s0, n, est_cfg["final_refine_top_k"])
    out = {}
    if not ref.learned:
        for chain, it in ((iters0, it0), (iters1, it1)):
            if len(chain) != it:
                raise StructureError(f"the ICP made {len(chain)} steps of the {it} asked for")
        # ICP, step by step: each step from the poses the engine's step began
        # with, the first of the main chain from the reference's own start and
        # the polish's from the reference's selection of the engine's best
        gaps = []
        for first, chain, last, m in ((start, iters0, main, n), (main[top], iters1, pol, len(pol))):
            begins = [first] + [p.to(dev) for p in chain[1:]]
            ends = [p.to(dev) for p in chain[1:]] + [last]
            for b, e in zip(begins, ends):
                gaps.append(_mm(e[:m], ref.refine(b, obs, 1)[:m], ref.points))
        q = np.quantile(np.concatenate(gaps), [0.75, 0.99, 1.0])
        out.update(icp_step_gap_p75_mm=float(q[0]), icp_step_gap_p99_mm=float(q[1]),
                   icp_step_gap_widest_mm=float(q[2]))
    else:
        # the learned refinement, chained as the engine ran it
        main_gaps = _mm(main[:n], ref.refine(start, obs, it0)[:n], ref.points)
        pol_gaps = _mm(pol, ref.refine(main[top], obs, it1), ref.points)
        q = np.quantile(main_gaps, [0.5, 0.75, 0.9, 1.0])
        out.update(refine_gap_p75_mm=float(q[1]), refine_gap_p50_mm=float(q[0]),
                   refine_gap_p90_mm=float(q[2]), refine_gap_widest_mm=float(q[3]),
                   polish_gap_mm=float(pol_gaps.max()))
    ref_s0 = ref.score(main, obs)
    ref_s1 = ref.score(pol, obs)
    sgap = torch.cat([(s0[:n] - ref_s0[:n]).abs(), (s1 - ref_s1).abs()]).cpu().numpy()
    cands = ref.to_original(pol)
    miss = np.abs(cands - rec["answer"][None]).reshape(len(cands), -1).max(-1)
    k = int(np.argmin(miss))
    out.update(score_gap=float(sgap.max()), score_gap_median=float(np.median(sgap)),
               answer_gap_m=float(miss[k]), choice_gap=float(ref_s1.max() - ref_s1[k]))
    return out


def engine_track(impl, chain_prev, K, rgb, depth, est_cfg):
    """A tracked frame made by a reference (a control stands in for the
    engine): its record in the form ``Recorder`` keeps."""
    obs = impl.track_observation(K, rgb, depth, chain_prev)
    hyp = impl.track_start(chain_prev)
    it, gate = est_cfg["track_iterations"], est_cfg["track_gate_px"]
    refined = impl.refine(hyp, obs, it, gate_px=gate)
    scores = impl.score(refined, obs, gate_px=gate)
    steps = [("refine", hyp, it, gate, refined, None), ("score", refined, None, gate, scores, None)]
    return {"steps": steps, "answer": impl.to_original(refined)[_track_best(scores)]}


def _track_best(scores):
    s = scores.clone()
    s[0] += 0.01
    return int(torch.argmax(s))


def judge_track(ref, rec, chain_prev, K, rgb, depth, est_cfg):
    """The readings of one tracked frame: per-hypothesis refine and score
    gaps (arrays, pooled over frames by ``pooled``) and the answer's gap."""
    kinds = [step[0] for step in rec["steps"]]
    if kinds != ["refine", "score"]:
        raise StructureError(f"track_one made the calls {kinds}, not refine, score")
    (_, _, _, _, refined, _), (_, _, _, _, scores, _) = rec["steps"]
    dev = ref.device
    refined, scores = refined.to(dev), scores.to(dev)
    obs = ref.track_observation(K, rgb, depth, chain_prev)
    hyp = ref.track_start(chain_prev)
    if len(refined) != len(hyp) or len(scores) != len(hyp):
        raise StructureError(f"track_one refined {len(refined)} and scored {len(scores)} "
                             f"of {len(hyp)} hypotheses")
    gate = est_cfg["track_gate_px"]
    gaps = _mm(refined, ref.refine(hyp, obs, est_cfg["track_iterations"], gate_px=gate),
               ref.points)
    ref_s = ref.score(refined, obs, gate_px=gate)
    k = _track_best(scores)
    cands = ref.to_original(refined)
    return {"refine_gaps_mm": gaps, "score_gaps": (scores - ref_s).abs().cpu().numpy(),
            "answer_gap_m": float(np.abs(cands[k] - rec["answer"]).max()),
            "choice_gap": float(ref_s.max() - ref_s[k])}


def pooled(readings, names):
    """Per number, over every hypothesis of the judged frames: the gaps'
    quantiles and the scores' median and largest difference; the answer's
    and the choice's largest reading."""
    gaps = np.concatenate([r["refine_gaps_mm"] for r in readings])
    sgap = np.concatenate([r["score_gaps"] for r in readings])
    q = np.quantile(gaps, [0.5, 0.75, 0.9, 1.0])
    out = {"refine_gap_p50_mm": q[0], "refine_gap_p75_mm": q[1], "refine_gap_p90_mm": q[2],
           "refine_gap_widest_mm": q[3], "score_gap_median": np.median(sgap),
           "score_gap": sgap.max(), "answer_gap_m": max(r["answer_gap_m"] for r in readings),
           "choice_gap": max(r["choice_gap"] for r in readings)}
    return {k: float(v) for k, v in out.items() if names is None or k in names}


def worst(readings, names):
    """Per number, the largest reading over the judged calls."""
    return {k: max(r[k] for r in readings) for k in (names or readings[0])}
