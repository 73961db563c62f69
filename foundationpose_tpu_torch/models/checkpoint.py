"""Engine and field checkpoints.

Counterpart of foundationpose_tpu/models/checkpoint.py. The JAX package
writes orbax PyTree directories; the port has no orbax, so ``save_engine``
writes one ``torch.save`` of both nets' state dicts (``{"format": ...,
"refiner": state_dict, "scorer": state_dict}``), and ``save_field`` the
field runner's whole training state through ``NeRFRunner.save``. The orbax
directories of the JAX package are not read here: the object-agnostic npz
checkpoint (``models/agnostic.py``) is the format both packages share.
"""

from __future__ import annotations

import logging
import os

import torch

FORMAT = "foundationpose_tpu_torch engine v1"


def save_engine(estimator, path):
    """Save the refiner's and the scorer's nets (a ``HybridScorer`` saves its
    learned half)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"format": FORMAT,
             "refiner": {k: v.cpu() for k, v in _net(estimator.refiner).state_dict().items()},
             "scorer": {k: v.cpu() for k, v in _net(estimator.scorer).state_dict().items()}}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    logging.info("engine checkpoint saved to %s", path)


def is_engine_checkpoint(path):
    """True for a file ``save_engine`` wrote."""
    if not os.path.isfile(path):
        return False
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # not a torch file, or not one of ours
        return False
    return isinstance(state, dict) and state.get("format") == FORMAT


def load_engine(estimator, path):
    """Load both nets (strict) from a ``save_engine`` file."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: orbax engine checkpoints of the JAX package are not read "
            "by the port; carry weights across as an object-agnostic checkpoint "
            "(refiner.npz + scorer.npz + meta.json, models/agnostic.py)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not an engine checkpoint written by save_engine")
    _net(estimator.refiner).load_state_dict(state["refiner"], strict=True)
    _net(estimator.scorer).load_state_dict(state["scorer"], strict=True)
    logging.info("engine checkpoint loaded from %s", path)


def _net(part):
    """The net of a predictor, or of a ``HybridScorer``'s learned half."""
    if hasattr(part, "net"):
        return part.net
    if hasattr(part, "learned"):
        return part.learned.net
    raise TypeError(f"{type(part).__name__} has no net to checkpoint (geometric mode)")


def save_field(runner, path):
    """Save a ``NeRFRunner``'s whole training state (parameters, both
    optimisers, step, normalisation, occupancy grid), resumable."""
    path = os.path.abspath(path)
    runner.save(path)
    logging.info("field checkpoint saved to %s", path)


def load_field(runner, path):
    """Restore a ``save_field`` file into ``runner`` (built on the same data:
    its normalisation is its own, as in the JAX package)."""
    path = os.path.abspath(path)
    runner.load(path)
    logging.info("field checkpoint loaded from %s", path)
