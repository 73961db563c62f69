"""Load side of the object-agnostic RefineNet/ScoreNet checkpoint.

Counterpart of foundationpose_tpu/models/agnostic.py::load_agnostic: reads
``refiner.npz`` + ``scorer.npz`` + ``meta.json`` (flax key paths, float16
storage) and returns predictors that plug straight into
``FoundationPoseTorch`` for any mesh. Training is not part of the port yet.
"""

from __future__ import annotations

import json
import os

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.models.convert import load_flax_npz


def load_agnostic(ckpt_dir, device=None, input_size=None):
    """Build (PoseRefiner, PoseScorer, meta) from an agnostic checkpoint dir.
    ``device=None`` means cuda. The nets compute in bfloat16 on the card and
    in float32 on the CPU."""
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
    from foundationpose_tpu_torch.engine.scorer import PoseScorer, ScorerConfig

    device = resolve_device(device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    px = int(input_size or meta["input_size"])
    refiner = PoseRefiner(RefinerConfig(input_size=px, dtype=dtype), device=device)
    load_flax_npz(os.path.join(ckpt_dir, "refiner.npz"), refiner.net)
    scorer = PoseScorer(
        ScorerConfig(input_size=px, dtype=dtype, norm="group", residual_attn=True),
        device=device,
    )
    load_flax_npz(os.path.join(ckpt_dir, "scorer.npz"), scorer.net)
    return refiner, scorer, meta
