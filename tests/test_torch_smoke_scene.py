"""The JAX package on the scene ``chip_smoke.py`` registers on the card.

``chip_smoke.py`` gates the port's pose at ADD-S <= 10 % of the diameter.
That gate only means something on a scene the reference clears with margin
at the same settings, so this test runs the JAX package's ``register`` (252
hypotheses, 160 px) and five ``track_one`` frames (8 hypotheses, 2
iterations, gate 12) on that scene on the CPU and holds each pose to half the
gate, in the three configurations the smoke run drives: learned-hybrid with
the full schedule (5 + 2 iterations), learned-hybrid with the documented
funnel (top 64 after 1 coarse iteration at 112 px), and geometric mode with
the ``run_pose`` schedule (10 + 8 ICP iterations). A full-width register on
the CPU takes minutes, so the test is marked ``slow``; run it with

    python -m pytest tests/test_torch_smoke_scene.py -m slow -s
"""

import numpy as np
import pytest

from foundationpose_tpu.core import meshio as jmeshio, metrics as jmetrics
from foundationpose_tpu.engine.estimator import EstimatorConfig, FoundationPoseTPU
from foundationpose_tpu.engine.scorer import HybridScorer
from foundationpose_tpu.models import agnostic
from foundationpose_tpu_torch.apps import demo_synthetic as demo


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["learned_hybrid", "learned_hybrid_funnel", "geometric"])
def test_jax_package_clears_smoke_scene_with_margin(mode):
    scene = demo.make_scene((480, 640), device="cpu")
    m = scene["mesh"]
    mesh = jmeshio.Mesh(m.vertices, m.faces, vertex_colors=m.vertex_colors)
    if mode == "geometric":
        from foundationpose_tpu.engine.geometric import (
            GeometricConfig, GeometricRefiner, GeometricScorer,
        )

        est = FoundationPoseTPU(
            mesh, config=EstimatorConfig(register_iterations=10, final_refine_iterations=8),
            refiner=GeometricRefiner(GeometricConfig()), scorer=GeometricScorer(GeometricConfig()))
    else:
        cfg = (EstimatorConfig(funnel_top_k=64, funnel_coarse_iterations=1, funnel_coarse_size=112)
               if mode == "learned_hybrid_funnel" else EstimatorConfig())
        refiner, scorer, _ = agnostic.load_agnostic(demo.default_weights_dir())
        est = FoundationPoseTPU(mesh, config=cfg, refiner=refiner, scorer=HybridScorer(scorer))
    print(f"JAX package, CPU, {mode}:")
    assert est.rot_grid.shape[0] == 252
    pose = est.register(scene["K"], scene["rgb"].astype(np.float32),
                        scene["depth"], scene["mask"].astype(np.uint8))
    adds = float(jmetrics.adds_err(pose, scene["gt"], m.vertices))
    add = float(jmetrics.add_err(pose, scene["gt"], m.vertices))
    print(f"JAX package, CPU: ADD-S {adds * 1000:.2f} mm ({adds / est.diameter:.4f} "
          f"of diameter), ADD {add * 1000:.2f} mm ({add / est.diameter:.4f}), "
          f"diameter {est.diameter * 1000:.1f} mm")
    assert adds <= 0.05 * est.diameter
    for f, (gt_f, rgb_f, depth_f) in enumerate(demo.motion_frames(scene, 5)):
        pose_f = est.track_one(rgb_f.astype(np.float32), depth_f, scene["K"])
        adds_f = float(jmetrics.adds_err(pose_f, gt_f, m.vertices))
        print(f"JAX package, CPU: track frame {f}: ADD-S {adds_f * 1000:.2f} mm "
              f"({adds_f / est.diameter:.4f} of diameter)")
        assert adds_f <= 0.05 * est.diameter
