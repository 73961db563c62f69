"""Train the object-agnostic RefineNet + ScoreNet pair on the randomised mesh
corpus and save a reusable checkpoint (``weights/agnostic`` by default).

The port's counterpart of scripts/train_agnostic.py, flag for flag, with
``--device`` in place of ``--cpu``:

    python -m foundationpose_tpu_torch.apps.train_agnostic --out weights/agnostic   # the card
    python -m foundationpose_tpu_torch.apps.train_agnostic --device cpu --n-meshes 2 \\
        --steps-refiner 4 --steps-scorer 4 --batch 2 --n-hyp 2 --input-size 32 \\
        --chunk 2 --out /tmp/agnostic                                              # tiny, CPU

Writes ``refiner.npz``, ``scorer.npz`` (flax key paths, float16: what both
packages' ``load_agnostic`` read), ``train_stats.json`` and ``meta.json``.
``--resume`` skips a finished refiner phase and continues an interrupted
phase from its snapshot (``resume_refiner.pt`` / ``resume_scorer.pt``).
"""

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

K_TRAIN = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])


def build_parser():
    ap = argparse.ArgumentParser(description="object-agnostic RefineNet + ScoreNet training")
    ap.add_argument("--out", default="weights/agnostic")
    ap.add_argument("--n-meshes", type=int, default=40)
    ap.add_argument("--corpus-seed", type=int, default=7)
    ap.add_argument("--steps-refiner", type=int, default=20000)
    ap.add_argument("--steps-scorer", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-hyp", type=int, default=16)
    ap.add_argument("--input-size", type=int, default=160)
    ap.add_argument("--lr-refiner", type=float, default=2e-4)
    ap.add_argument("--lr-scorer", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-faces", type=int, default=2048,
                    help="training render face budget (eval uses 4096; the nets are "
                    "resolution / face-count independent)")
    ap.add_argument("--chunk", type=int, default=25,
                    help="steps between two reads of the losses on the host")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="skip a finished refiner phase; continue an interrupted phase "
                    "from its snapshot")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    import torch

    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.models import agnostic

    device = resolve_device(args.device)
    t0 = time.time()

    def note(msg):
        print(f"[train_agnostic +{time.time() - t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    note(f"preparing {args.n_meshes}-mesh corpus on {device}")
    prepped = agnostic.prepare_corpus(args.n_meshes, seed=args.corpus_seed,
                                      max_faces=args.max_faces, device=device)
    note(f"corpus ready ({sum(p['textured'] for p in prepped)} textured); training refiner")

    def cb(tag):
        return lambda step, loss: note(f"{tag} step {step} loss {loss:.4f}")

    os.makedirs(args.out, exist_ok=True)
    ref_path = os.path.join(args.out, "refiner.npz")
    sco_path = os.path.join(args.out, "scorer.npz")
    stats_path = os.path.join(args.out, "train_stats.json")
    stats = {}
    if args.resume and os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)

    def save_stats():
        with open(stats_path, "w") as f:
            json.dump(stats, f)

    if args.resume and os.path.exists(ref_path) and "refiner" in stats:
        note("refiner phase already done; skipping")
    else:
        net_r, stats_r = agnostic.train_agnostic_refiner(
            prepped, K_TRAIN, steps=args.steps_refiner, batch=args.batch,
            input_size=args.input_size, lr=args.lr_refiner, seed=args.seed, chunk=args.chunk,
            log_cb=cb("refiner"), resume_path=os.path.join(args.out, "resume_refiner.pt"))
        agnostic.save_params_npz(ref_path, net_r, dtype=np.float16)
        stats["refiner"] = stats_r
        save_stats()
        note(f"refiner done (loss {stats_r['loss_first']:.4f} -> {stats_r['loss_last']:.4f}); "
             "training scorer")

    net_s, stats_s = agnostic.train_agnostic_scorer(
        prepped, K_TRAIN, steps=args.steps_scorer, n_hyp=args.n_hyp,
        input_size=args.input_size, lr=args.lr_scorer, seed=args.seed, chunk=args.chunk,
        log_cb=cb("scorer"), resume_path=os.path.join(args.out, "resume_scorer.pt"))
    agnostic.save_params_npz(sco_path, net_s, dtype=np.float16)
    stats["scorer"] = stats_s
    save_stats()
    meta = {
        "input_size": args.input_size,
        "n_meshes": args.n_meshes,
        "corpus_seed": args.corpus_seed,
        "refiner": stats.get("refiner"),
        "scorer": stats_s,
        "K_train": K_TRAIN.tolist(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "note": "one net pair for every object (object-agnostic); corpus meshes are random "
                "primitives/compounds held out from the evaluation suite",
    }
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps({k: v for k, v in meta.items() if k not in ("refiner", "scorer")}
                     | {"refiner_loss": [stats["refiner"]["loss_first"],
                                         stats["refiner"]["loss_last"]],
                        "scorer_loss": [stats_s["loss_first"], stats_s["loss_last"]]}))
    return meta


if __name__ == "__main__":
    main()
