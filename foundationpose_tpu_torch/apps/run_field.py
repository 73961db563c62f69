"""Neural-object-field reconstruction CLI.

Counterpart of foundationpose_tpu/apps/run_field.py (after
bundlesdf/run_nerf.py's entry points): reconstruct one object from a BOP
scene (``--video-dir`` + ``--ob-id``) or from a YCBInEOAT-style directory of
rgb / depth / mask / pose files (``--data-dir``), and write
``mesh_real_world.obj``, ``optimized_poses.txt`` and ``field_latest.ckpt``
under ``--save-dir``. Accepts our YAML configs or reference-style BundleSDF
configs (config_ycbv.yml keys translated; reading one needs PyYAML).

    python -m foundationpose_tpu_torch.apps.run_field --data-dir <video> [--device cpu]

Same flags as the JAX package's CLI plus ``--device`` (default: cuda).
``main`` returns the textured mesh, the optimised poses and the trained
runner.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="neural object field reconstruction")
    p.add_argument("--video-dir", default=None, help="BOP-style scene dir")
    p.add_argument("--ob-id", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="raw dir with rgb/*.png depth/*.png masks/*.png "
                        "annotated_poses/*.txt cam_K.txt")
    p.add_argument("--cfg", default=None, help="YAML config (ours or BundleSDF style)")
    p.add_argument("--n-step", type=int, default=None)
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--save-dir", default="./field_out")
    p.add_argument("--tex-res", type=int, default=1024)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")

    from foundationpose_tpu_torch.field.runner import FieldConfig
    from foundationpose_tpu_torch.slam.reconstruction import (
        run_neural_object_field,
        run_one_object,
    )
    from foundationpose_tpu_torch.utils.config import load_field_config

    overrides = {}
    if args.n_step is not None:
        overrides["n_step"] = args.n_step
    cfg = load_field_config(args.cfg, overrides) if args.cfg else FieldConfig(**overrides)

    if args.video_dir:
        from foundationpose_tpu_torch.io.datareader import get_bop_reader

        reader = get_bop_reader(args.video_dir)
        ob_id = args.ob_id or reader.ob_ids[0]
        mesh, poses, runner = run_one_object(reader, ob_id, cfg, args.save_dir,
                                             n_frames=args.n_frames, tex_res=args.tex_res,
                                             device=args.device)
    elif args.data_dir:
        from foundationpose_tpu_torch.io.datareader import YcbineoatReader

        reader = YcbineoatReader(args.data_dir)
        ids = np.unique(np.linspace(0, len(reader) - 1, args.n_frames).astype(int))
        rgbs = np.stack([reader.get_color(i) for i in ids])
        depths = np.stack([reader.get_depth(i) for i in ids])
        masks = np.stack([reader.get_mask(i) for i in ids])
        poses = np.stack([np.linalg.inv(reader.get_gt_pose(i)) for i in ids])  # cam_in_ob
        mesh, poses, runner = run_neural_object_field(
            cfg, reader.K, rgbs, depths, masks, poses, save_dir=args.save_dir,
            tex_res=args.tex_res, device=args.device)
    else:
        raise SystemExit("provide --video-dir or --data-dir")
    logging.info("done: mesh with %d faces", len(mesh.faces))
    return mesh, poses, runner


if __name__ == "__main__":
    main()
