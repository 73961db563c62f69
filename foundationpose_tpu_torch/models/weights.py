"""Torch-checkpoint import: load the reference's released RefineNet/ScoreNet
weights into the port's nets.

The port's own copy of foundationpose_tpu/models/weights.py. The reference
expects ``weights/<run>/model_best.pth`` (predict_pose_refine.py:97-141,
predict_score.py:120-154). The mapping below is the JAX package's, numpy
only: it builds the flax parameter tree from a torch state_dict

- Conv2d OIHW -> flax HWIO; Linear (out,in) -> (in,out)
- torch MultiheadAttention fused in_proj (3D,D) -> the fused in_proj Dense
- BatchNorm (use_BN configs) FOLDED into the preceding conv, so the nets
  always run norm-free at inference
- the sinusoidal position table is a buffer and is recomputed, not loaded

and ``models/convert.py`` carries that tree into the port's modules (the
inverse layout map), so a checkpoint goes through the same two maps as in
the JAX package plus the one the shipped agnostic weights already use.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from foundationpose_tpu_torch.models.convert import flax_params_to_state_dict


def _t(x):
    return np.asarray(x, dtype=np.float32)


def _conv(sd, prefix):
    w = _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)  # OIHW -> HWIO
    out = {"kernel": w}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    else:
        out["bias"] = np.zeros(w.shape[-1], np.float32)
    return out


def _fold_bn(conv, sd, prefix, eps=1e-5):
    """Fold BatchNorm running stats + affine into the preceding conv."""
    gamma = _t(sd[f"{prefix}.weight"])
    beta = _t(sd[f"{prefix}.bias"])
    mean = _t(sd[f"{prefix}.running_mean"])
    var = _t(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    conv["kernel"] = conv["kernel"] * scale[None, None, None, :]
    conv["bias"] = (conv["bias"] - mean) * scale + beta
    return conv


def _linear(sd, prefix):
    return {
        "kernel": _t(sd[f"{prefix}.weight"]).T,
        "bias": _t(sd[f"{prefix}.bias"]),
    }


def _layernorm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _mha(sd, prefix):
    return {
        "in_proj": {
            "kernel": _t(sd[f"{prefix}.in_proj_weight"]).T,
            "bias": _t(sd[f"{prefix}.in_proj_bias"]),
        },
        "out_proj": _linear(sd, f"{prefix}.out_proj"),
    }


def _conv_bn_relu(sd, prefix, use_bn):
    """reference ConvBNReLU: net = Sequential[Conv2d, (BN), ReLU]."""
    conv = _conv(sd, f"{prefix}.net.0")
    if use_bn and f"{prefix}.net.1.running_mean" in sd:
        conv = _fold_bn(conv, sd, f"{prefix}.net.1")
    return {"conv": conv}


def _res_block(sd, prefix, use_bn):
    c1 = _conv(sd, f"{prefix}.conv1")
    c2 = _conv(sd, f"{prefix}.conv2")
    if use_bn and f"{prefix}.bn1.running_mean" in sd:
        c1 = _fold_bn(c1, sd, f"{prefix}.bn1")
        c2 = _fold_bn(c2, sd, f"{prefix}.bn2")
    return {"conv1": c1, "conv2": c2}


def _encoder_a(sd, prefix, use_bn):
    return {
        "conv0": _conv_bn_relu(sd, f"{prefix}.0", use_bn),
        "conv1": _conv_bn_relu(sd, f"{prefix}.1", use_bn),
        "res0": _res_block(sd, f"{prefix}.2", use_bn),
        "res1": _res_block(sd, f"{prefix}.3", use_bn),
    }


def _encoder_ab(sd, prefix, use_bn):
    return {
        "res0": _res_block(sd, f"{prefix}.0", use_bn),
        "res1": _res_block(sd, f"{prefix}.1", use_bn),
        "conv0": _conv_bn_relu(sd, f"{prefix}.2", use_bn),
        "res2": _res_block(sd, f"{prefix}.3", use_bn),
        "res3": _res_block(sd, f"{prefix}.4", use_bn),
    }


def _transformer_layer(sd, prefix):
    return {
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "linear1": _linear(sd, f"{prefix}.linear1"),
        "linear2": _linear(sd, f"{prefix}.linear2"),
    }


def refine_params_from_torch(state_dict, use_bn=False):
    """torch RefineNet state_dict -> flax params for models.refine_net.RefineNet
    (norm=None; BN folded)."""
    sd = state_dict
    params = {
        "encodeA": _encoder_a(sd, "encodeA", use_bn),
        "encodeAB": _encoder_ab(sd, "encodeAB", use_bn),
        "trans_tf": _transformer_layer(sd, "trans_head.0"),
        "trans_out": _linear(sd, "trans_head.1"),
        "rot_tf": _transformer_layer(sd, "rot_head.0"),
        "rot_out": _linear(sd, "rot_head.1"),
    }
    return {"params": params}


def score_params_from_torch(state_dict, use_bn=False):
    """torch ScoreNetMultiPair state_dict -> flax params."""
    sd = state_dict
    params = {
        "encoderA": _encoder_a(sd, "encoderA", use_bn),
        "encoderAB": _encoder_ab(sd, "encoderAB", use_bn),
        "att": _mha(sd, "att"),
        "att_cross": _mha(sd, "att_cross"),
        "linear": _linear(sd, "linear"),
    }
    return {"params": params}


def flatten_params(tree, prefix="params"):
    """Nested flax tree -> {"params/a/b/kernel": array} (the layout of
    ``models/convert.py``)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = v
    return flat


def load_torch_checkpoint(path):
    """Load a .pth file -> flat numpy state dict (unwraps ckpt['model'],
    matching predict_pose_refine.py:138-141)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


def refine_state_dict(state_dict, net, use_bn=False):
    """torch RefineNet state_dict -> state_dict of the port's ``RefineNet``."""
    tree = refine_params_from_torch(state_dict, use_bn=use_bn)["params"]
    return flax_params_to_state_dict(flatten_params(tree), net)


def score_state_dict(state_dict, net, use_bn=False):
    """torch ScoreNetMultiPair state_dict -> state_dict of the port's
    ``ScoreNetMultiPair``."""
    tree = score_params_from_torch(state_dict, use_bn=use_bn)["params"]
    return flax_params_to_state_dict(flatten_params(tree), net)


def load_engine_params(estimator, weights_dir):
    """Load refiner + scorer weights into a ``FoundationPoseTorch`` engine from
    a directory holding ``refiner.pth`` / ``scorer.pth`` (torch). The nets
    must be built norm-free (``norm=None``, the configs' default) for these
    checkpoints; a ``HybridScorer`` takes the weights into its learned half.
    The flax serialization (``.msgpack``) is not read by the port."""
    for name, target, convert in (("refiner", estimator.refiner, refine_state_dict),
                                  ("scorer", estimator.scorer, score_state_dict)):
        pth = os.path.join(weights_dir, f"{name}.pth")
        msg = os.path.join(weights_dir, f"{name}.msgpack")
        if os.path.exists(pth):
            net = target.net
            sd = convert(load_torch_checkpoint(pth), net)
            net.load_state_dict(sd, strict=True)
            logging.info("loaded %s weights from %s", name, pth)
        elif os.path.exists(msg):
            raise NotImplementedError(
                f"{msg}: flax-serialized weights are not read by the port; the "
                "checkpoint formats of the JAX training stack come with the training "
                "slice of the port (use the torch .pth files)")
        else:
            logging.warning("no %s weights found in %s", name, weights_dir)
