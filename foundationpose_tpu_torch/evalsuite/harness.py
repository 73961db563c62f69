"""Standing accuracy harness: ADD-S / ADD AUC + tracking ATE over the fixed
synthetic scene suite, in geometric and learned modes, across register
schedules (full / funnel / coarse-funnel).

The port's own copy of foundationpose_tpu/evalsuite/harness.py, with the same
protocol and the same output JSON, key for key: ``meta``,
``modes.<mode>.register.<schedule>.scenes.<scene>``, ``overall_auc_adds``,
``overall_auc_add``, ``track`` and ``summary``. The reference evaluates
register/track against BOP ground truth with ADD / ADD-S / AUC
(src/Utils.py:232-266); here the scenes are synthetic with exact ground
truth (``evalsuite/scenes.py``) and the AUC sweep is the same (0..0.1 m).

Modes: ``geometric`` (projective ICP + geometric score), ``learned`` (one
object-agnostic RefineNet/ScoreNet pair for every scene) and
``learned_hybrid`` (the same pair with ``HybridScorer``, the shipping
default). Without an agnostic checkpoint, ``learned`` falls back to a net
pair trained per scene (the scenes marked ``learned``) with
``models/datagen.py``'s per-mesh trainers, as the JAX package does.

    python -m foundationpose_tpu_torch.evalsuite.harness --out /tmp/acc.json \\
        [--quick] [--modes geometric,learned,learned_hybrid] [--no-track] \\
        [--agnostic-dir auto] [--scenes box_gray,compound_asym] [--device cpu]

The JSON is written only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.apps.demo_synthetic import default_weights_dir
from foundationpose_tpu_torch.core import metrics
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch
from foundationpose_tpu_torch.engine.geometric import (
    GeometricConfig, GeometricRefiner, GeometricScorer,
)
from foundationpose_tpu_torch.evalsuite import scenes as scenes_mod


def _schedules(input_size):
    """Register schedules under evaluation. The coarse pass of the third
    schedule runs at 112 px for 160-px nets (scaled proportionally for
    smaller inputs)."""
    coarse = 112 if input_size >= 160 else max(32, int(input_size * 0.7))
    return {
        "full": {},
        "funnel": dict(funnel_top_k=64, funnel_coarse_iterations=1),
        "coarse112": dict(funnel_top_k=64, funnel_coarse_iterations=1,
                          funnel_coarse_size=coarse),
    }


def _auc(errs, max_val=0.1):
    return round(metrics.compute_auc(np.asarray(errs), max_val=max_val), 4)


def _register_block(suite, renderers, make_estimator, est_cfg, schedules,
                    scene_filter=None, progress_cb=None, out=None):
    out = {} if out is None else out  # filled in place so incremental
    for sched_name, sched_kw in schedules.items():  # checkpoints see it
        cfg = dataclasses.replace(est_cfg, **sched_kw)
        per_scene = {}
        pooled_adds, pooled_add = [], []
        for spec in suite:
            if scene_filter and not scene_filter(spec):
                continue
            r = renderers[spec.name]
            est = make_estimator(spec, cfg)
            adds_l, add_l, terr_l, vis_l = [], [], [], []
            for gt in r.register_poses():
                rgb, depth, vis_mask, vis_frac = r.render(gt)
                t0 = time.perf_counter()
                pose = est.register(r.K, rgb, depth, vis_mask)
                dt = time.perf_counter() - t0
                adds = float(metrics.adds_err(pose, gt, spec.mesh.vertices))
                add = float(metrics.add_err(pose, gt, spec.mesh.vertices))
                # symmetric objects: ADD is only meaningful up to the
                # symmetry group — the minimum over symmetry_tfs
                if spec.symmetry_tfs is not None:
                    add = min(
                        float(metrics.add_err(pose, gt @ s, spec.mesh.vertices))
                        for s in spec.symmetry_tfs
                    )
                adds_l.append(adds)
                add_l.append(add)
                terr_l.append(float(np.linalg.norm(pose[:3, 3] - gt[:3, 3])))
                vis_l.append(round(vis_frac, 3))
                logging.info(
                    "[%s/%s] adds=%.4f add=%.4f visib=%.2f %.2fs",
                    sched_name, spec.name, adds, add, vis_frac, dt,
                )
            pooled_adds += adds_l
            if spec.pool_add:
                pooled_add += add_l
            per_scene[spec.name] = {
                "adds": [round(x, 5) for x in adds_l],
                "add": [round(x, 5) for x in add_l],
                "t_err": [round(x, 5) for x in terr_l],
                "visib_frac": vis_l,
                "auc_adds": _auc(adds_l),
                "auc_add": _auc(add_l),
                "adds_mean": round(float(np.mean(adds_l)), 5),
            }
            if not spec.pool_add:
                # continuous full symmetry (spheres): ADD is meaningless;
                # reported per scene, left out of the pooled number
                per_scene[spec.name]["add_pooled"] = False
        out[sched_name] = {
            "scenes": per_scene,
            "overall_auc_adds": _auc(pooled_adds),
            "overall_auc_add": _auc(pooled_add) if pooled_add else None,
        }
        if progress_cb:
            progress_cb()
    return out


def _track_block(suite, renderers, make_estimator, est_cfg, scene_filter=None):
    per_scene = {}
    pooled_adds = []
    ates = []
    for spec in suite:
        if scene_filter and not scene_filter(spec):
            continue
        r = renderers[spec.name]
        est = make_estimator(spec, est_cfg)
        traj = r.track_trajectory()
        rgb, depth, vis_mask, _ = r.render(traj[0])
        est.register(r.K, rgb, depth, vis_mask)
        pred = [est.pose_last @ est.get_tf_to_centered_mesh()]
        adds_l = [float(metrics.adds_err(pred[0], traj[0], spec.mesh.vertices))]
        for gt in traj[1:]:
            rgb, depth, _, _ = r.render(gt)
            pose = est.track_one(rgb, depth, r.K)
            pred.append(pose)
            adds_l.append(float(metrics.adds_err(pose, gt, spec.mesh.vertices)))
        pred = np.stack(pred)
        ate = metrics.ate_rmse(pred, traj, align=False)
        rpe_t, rpe_r = metrics.rpe(pred, traj)
        pooled_adds += adds_l
        ates.append(ate)
        per_scene[spec.name] = {
            "ate_m": round(ate, 5),
            "rpe_t_m": round(rpe_t, 5),
            "rpe_r_deg": round(rpe_r, 3),
            "auc_adds": _auc(adds_l),
            "adds_mean": round(float(np.mean(adds_l)), 5),
            "n_frames": len(traj),
        }
        logging.info("[track/%s] ate=%.4f auc=%.3f", spec.name,
                     ate, per_scene[spec.name]["auc_adds"])
    return {
        "scenes": per_scene,
        "median_ate_m": round(float(np.median(ates)), 5) if ates else None,
        "overall_auc_adds": _auc(pooled_adds) if pooled_adds else None,
    }


def run_accuracy(out_path=None, quick=False, modes=("geometric", "learned"),
                 input_size=160, learned_px=64, learned_steps=(2000, 4000), hyp_grid=None,
                 track=True, agnostic_dir="auto", scene_names=None, device=None):
    """Run the whole suite; returns (and optionally writes) the results dict.

    quick=True: 2 scenes, 2 register poses, 6 track frames, quarter
    resolution, small grids — the CPU configuration of the tests.
    ``scene_names``: optional subset (full protocol; pooled numbers then cover
    only the subset); a name the suite lacks raises ``ValueError``.
    ``agnostic_dir``: the object-agnostic checkpoint that
    ``learned`` and ``learned_hybrid`` evaluate on every scene at its native
    resolution; "auto" = ``weights/agnostic`` of this checkout when present,
    None = the per-scene training fallback: a refiner and a scorer trained
    for each scene marked ``learned`` at ``learned_px`` for ``learned_steps``
    (refiner, scorer) steps, float32.
    ``device=None`` means cuda (raises without a card).
    """
    device = resolve_device(device)
    if agnostic_dir == "auto":
        agnostic_dir = default_weights_dir() if os.path.isdir(default_weights_dir()) else None
    if ({"learned", "learned_hybrid"} & set(modes)) and agnostic_dir \
            and not os.path.isdir(agnostic_dir):
        raise FileNotFoundError(f"agnostic checkpoint dir not found: {agnostic_dir}")
    suite = scenes_mod.build_suite(quick=quick)
    if scene_names:
        # a name the suite lacks would leave the pooled AUCs NaN (as in the
        # JAX package, which does not check): refuse it instead
        unknown = sorted(set(scene_names) - {s.name for s in suite})
        if unknown:
            raise ValueError(f"unknown scene names {unknown}; this suite has "
                             f"{[s.name for s in suite]}")
        suite = [s for s in suite if s.name in set(scene_names)]
    # quick mode renders at quarter resolution (geometry and protocol unchanged)
    K_s, hw_s = (scenes_mod.K_DEFAULT, scenes_mod.HW_DEFAULT)
    if quick:
        K_s = scenes_mod.K_DEFAULT.copy()
        K_s[:2] *= 0.25
        hw_s = (120, 160)
    renderers = {
        s.name: scenes_mod.SceneRenderer(s, K=K_s, hw=hw_s, device=device) for s in suite
    }
    if hyp_grid is None:
        hyp_grid = dict(min_n_views=12, inplane_step=120) if quick else {}
    est_cfg = EstimatorConfig(register_iterations=5, **hyp_grid)
    schedules = _schedules(input_size)

    results = {
        "meta": {
            "quick": bool(quick),
            "n_scenes": len(suite),
            "scenes": [s.name for s in suite],
            "input_size": input_size,
            "auc_max_m": 0.1,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            "protocol": "ADD/ADD-S per register trial pooled per scene and "
            "overall; AUC threshold sweep 0..0.1 m (Utils.py:255-266 "
            "semantics); track: ATE/RPE + per-frame ADD-S",
        },
        "modes": {},
    }

    def checkpoint():
        # incremental write: a partial run still leaves a valid artifact
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)

    # ---- geometric mode: shared projective-ICP refiner/scorer ----
    if "geometric" in modes:
        gcfg = GeometricConfig(input_size=input_size)

        def make_geo(spec, cfg):
            # fresh predictors per estimator: the estimator turns on backface
            # culling in its predictors' configs for watertight meshes
            return FoundationPoseTorch(
                spec.mesh, symmetry_tfs=spec.symmetry_tfs, config=cfg,
                refiner=GeometricRefiner(gcfg, device), scorer=GeometricScorer(gcfg, device),
                device=device,
            )

        block = {"register": {}}
        results["modes"]["geometric"] = block
        # coarse112 is identical to funnel in geometric mode: the ICP refiner
        # ignores the coarse crop resolution, so it is marked, not re-run
        geo_schedules = {k: v for k, v in schedules.items() if k != "coarse112"}
        _register_block(
            suite, renderers, make_geo, est_cfg, geo_schedules,
            progress_cb=checkpoint, out=block["register"])
        if "coarse112" in schedules:
            block["register"]["coarse112"] = {
                "equivalent_to": "funnel",
                "note": "ICP ignores crop resolution; see funnel for numbers",
            }
        checkpoint()
        if track:
            block["track"] = _track_block(suite, renderers, make_geo, est_cfg)
            checkpoint()

    # ---- learned modes (agnostic): ONE net pair for every scene ----
    if ({"learned", "learned_hybrid"} & set(modes)) and agnostic_dir:
        from foundationpose_tpu_torch.engine.scorer import HybridScorer
        from foundationpose_tpu_torch.models import agnostic

        refiner0, scorer0, meta = agnostic.load_agnostic(agnostic_dir, device=device)
        px = int(meta["input_size"])

        def make_maker(hybrid):
            def make_learned(spec, cfg):
                # fresh predictor objects per estimator (it replaces their
                # configs for backface culling) around the SHARED nets
                scorer = copy.copy(scorer0)
                if hybrid:
                    scorer = HybridScorer(scorer)
                return FoundationPoseTorch(
                    spec.mesh, symmetry_tfs=spec.symmetry_tfs, config=cfg,
                    refiner=copy.copy(refiner0), scorer=scorer, device=device,
                )
            return make_learned

        for mode_name in ("learned", "learned_hybrid"):
            if mode_name not in modes:
                continue
            maker = make_maker(hybrid=mode_name == "learned_hybrid")
            block = {"meta": {"px": px, "checkpoint": agnostic_dir,
                              "object_agnostic": True,
                              "hybrid_scorer": mode_name == "learned_hybrid",
                              "train": {k: meta.get(k) for k in
                                        ("n_meshes", "refiner", "scorer")}}}
            results["modes"][mode_name] = block
            block["register"] = {}
            _register_block(
                suite, renderers, maker, est_cfg, _schedules(px),
                progress_cb=checkpoint, out=block["register"])
            checkpoint()
            if track:
                block["track"] = _track_block(suite, renderers, maker, est_cfg)
                checkpoint()
    # ---- learned mode (fallback): per-mesh synthetically-trained nets ----
    elif "learned" in modes:
        from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
        from foundationpose_tpu_torch.engine.scorer import PoseScorer, ScorerConfig
        from foundationpose_tpu_torch.models import datagen

        steps_r, steps_s = learned_steps
        learned_nets = {}
        for spec in suite:
            if not spec.learned:
                continue
            t0 = time.perf_counter()
            net_r, losses_r = datagen.train_refiner_synthetic(
                spec.mesh, scenes_mod.K_DEFAULT, steps=steps_r, batch=16,
                input_size=learned_px, lr=3e-4, device=device)
            net_s, losses_s = datagen.train_scorer_synthetic(
                spec.mesh, scenes_mod.K_DEFAULT, steps=steps_s, n_hyp=8,
                input_size=learned_px, lr=1e-3, device=device)
            refiner = PoseRefiner(RefinerConfig(input_size=learned_px, dtype="float32"),
                                  device=device)
            refiner.net.load_state_dict(net_r.state_dict())
            scorer = PoseScorer(ScorerConfig(input_size=learned_px, dtype="float32",
                                             norm="group", residual_attn=True), device=device)
            scorer.net.load_state_dict(net_s.state_dict())
            learned_nets[spec.name] = (refiner, scorer)
            logging.info(
                "learned[%s]: trained in %.0fs (refine loss %.3f->%.3f, "
                "score %.3f->%.3f)", spec.name, time.perf_counter() - t0,
                np.mean(losses_r[:10]), np.mean(losses_r[-10:]),
                np.mean(losses_s[:10]), np.mean(losses_s[-10:]),
            )

        def make_learned(spec, cfg):
            # fresh predictor objects per estimator (it replaces their configs
            # for backface culling) around the scene's SHARED nets
            refiner, scorer = learned_nets[spec.name]
            return FoundationPoseTorch(spec.mesh, symmetry_tfs=spec.symmetry_tfs, config=cfg,
                                       refiner=copy.copy(refiner), scorer=copy.copy(scorer),
                                       device=device)

        sel = lambda spec: spec.learned  # noqa: E731
        block = {"meta": {"px": learned_px, "steps": list(learned_steps)}}
        results["modes"]["learned"] = block
        block["register"] = {}
        _register_block(
            suite, renderers, make_learned, est_cfg, _schedules(learned_px),
            scene_filter=sel, progress_cb=checkpoint, out=block["register"])
        checkpoint()
        if track:
            block["track"] = _track_block(suite, renderers, make_learned, est_cfg,
                                          scene_filter=sel)
            checkpoint()

    # ---- headline comparisons ----
    summary = {}
    if "geometric" in results["modes"]:
        reg = results["modes"]["geometric"]["register"]
        summary["geometric_full_auc_adds"] = reg["full"]["overall_auc_adds"]
        summary["funnel_vs_full_auc_delta"] = round(
            reg["funnel"]["overall_auc_adds"] - reg["full"]["overall_auc_adds"], 4
        )
        if "overall_auc_adds" in reg.get("coarse112", {}):
            summary["coarse112_vs_full_auc_delta"] = round(
                reg["coarse112"]["overall_auc_adds"]
                - reg["full"]["overall_auc_adds"], 4
            )
    if "learned" in results["modes"] and "geometric" in results["modes"]:
        g = results["modes"]["geometric"]["register"]["full"]["scenes"]
        lrn = results["modes"]["learned"]["register"]["full"]["scenes"]
        common = sorted(set(g) & set(lrn))
        summary["learned_vs_geometric_adds_mean"] = {
            k: {"geometric": g[k]["adds_mean"], "learned": lrn[k]["adds_mean"]}
            for k in common
        }
    results["summary"] = summary

    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        logging.info("wrote %s", out_path)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="accuracy harness over the evalsuite scenes")
    ap.add_argument("--out", default=None, help="results JSON (written only when given)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--modes", default="geometric,learned")
    ap.add_argument("--no-track", action="store_true")
    ap.add_argument("--agnostic-dir", default="auto",
                    help="object-agnostic checkpoint; 'auto' = weights/agnostic")
    ap.add_argument("--scenes", default=None, help="comma-separated scene subset")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s] %(message)s")
    agnostic_dir = None if args.agnostic_dir in ("", "none") else args.agnostic_dir
    t0 = time.perf_counter()
    results = run_accuracy(
        out_path=args.out, quick=args.quick, modes=tuple(args.modes.split(",")),
        track=not args.no_track, agnostic_dir=agnostic_dir,
        scene_names=args.scenes.split(",") if args.scenes else None, device=args.device,
    )
    print(json.dumps({"device": results["meta"]["device"],
                      "wall_s": time.perf_counter() - t0, "summary": results["summary"]}))
    return results


if __name__ == "__main__":
    main()
