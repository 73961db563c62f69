"""One typed configuration tree with YAML load/save.

The port's own copy of foundationpose_tpu/utils/config.py: every subsystem's
config is a frozen dataclass (``FieldConfig``, ``EstimatorConfig``, ...) and
this module converts between YAML and dataclasses with explicit precedence:
defaults < YAML file < overrides dict. Reference-style BundleSDF YAML keys
(config_ycbv.yml) are accepted through a key-translation table.

``yaml`` (PyYAML) is imported where a file is read or written, so the rest of
the port runs without it; a missing ``yaml`` raises an ImportError naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Type, TypeVar

T = TypeVar("T")

# reference config_ycbv.yml keys -> FieldConfig field names
_FIELD_KEY_MAP = {
    "n_step": "n_step",
    "N_rand": "n_rand",
    "lrate": "lrate",
    "lrate_pose": "lrate_pose",
    "decay_rate": "decay_rate",
    "N_samples": "n_samples",
    "N_samples_around_depth": "n_samples_around_depth",
    "trunc": "trunc",
    "sdf_lambda": "sdf_lambda",
    "neg_trunc_ratio": "neg_trunc_ratio",
    "fs_sdf": "fs_sdf",
    "near": "near",
    "far": "far",
    "rgb_weight": "rgb_weight",
    "fs_weight": "fs_weight",
    "empty_weight": "empty_weight",
    "trunc_weight": "trunc_weight",
    "feature_reg_weight": "feature_reg_weight",
    "pose_reg_weight": "pose_reg_weight",
    "first_frame_weight": "first_frame_weight",
    "frame_features": "frame_features",
    "optimize_poses": "optimize_poses",
    "max_trans": "max_trans",
    "max_rot": "max_rot",
    "num_levels": "num_levels",
    "log2_hashmap_size": "log2_hashmap_size",
    "base_res": "base_res",
    "finest_res": "finest_res",
    "feature_grid_dim": "feature_grid_dim",
    "multires_views": "sh_degree",
    "mesh_resolution": "mesh_resolution",
    "dilate_mask_size": "mask_dilate",
    "rays_valid_depth_only": "rays_valid_depth_only",
}


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing a YAML config needs PyYAML ('yaml'), "
                          "which is not installed") from e
    return yaml


def from_dict(cls: Type[T], data: dict, key_map: dict | None = None) -> T:
    """Build a dataclass from a dict, ignoring unknown keys, recursing into
    dataclass-typed fields."""
    if key_map:
        data = {key_map[k]: v for k, v in data.items() if k in key_map} | {
            k: v for k, v in data.items() if k in {f.name for f in dataclasses.fields(cls)}
        }
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue
        f = fields[k]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[k] = from_dict(f.type, v)
        elif isinstance(v, list) and isinstance(f.default, tuple):
            # YAML has no tuple type; restore tuple-typed fields on load
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def load_yaml(cls: Type[T], path: str, overrides: dict | None = None,
              key_map: dict | None = None) -> T:
    """defaults < YAML < overrides."""
    yaml = _yaml()
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if overrides:
        data.update(overrides)
    return from_dict(cls, data, key_map=key_map)


def save_yaml(cfg, path: str):
    yaml = _yaml()
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def load_field_config(path: str, overrides: dict | None = None):
    """Load a FieldConfig from our YAML or a reference-style BundleSDF YAML
    (config_ycbv.yml keys translated)."""
    from foundationpose_tpu_torch.field.runner import FieldConfig

    return load_yaml(FieldConfig, path, overrides=overrides, key_map=_FIELD_KEY_MAP)
