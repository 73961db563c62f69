"""Run one cell of the pose engine's benchmark once and print its result.

    python benchmark/run.py --workload learned.register --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and, with
``--trace 1``, ``breakdown``; its last key, ``checks``, holds each number the
correctness judge compared beside its limit, which the last lines of
standard error repeat. Exits non-zero, printing no result, without the
card(s), outside a full checkout, or when jax, flax, optax or the JAX
package were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "foundationpose_tpu"}
# build and kernel caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package (compared whole: the port's name starts with the package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    torch.set_num_threads(1)  # one process, few threads: the host path is the engine's

    from fpbench import cell as cell_mod

    cell = cell_mod.Cell(BENCH_DIR, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import foundationpose_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the engine under test is not in this checkout: {e}", file=sys.stderr)
        return 4
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX stack were loaded: {bad}", file=sys.stderr)
        return 5
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
