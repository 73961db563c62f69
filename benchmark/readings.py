"""The readings the correctness limits are set from: a cell's judge over
many seeds in one process, its lower-precision control and the planted
faults on some of them.

    python benchmark/readings.py --workload learned.track --seeds 11,12,13 \\
        --control-seeds 11,12 --fault-seeds 11,12 --faults half \\
        --seconds 5 --out chiprun_out/readings.jsonl

For each seed: one run of the cell (a short window) and the judge's numbers
for every judged call; for a control seed, the same calls again with the
configuration's control (``controls/<name>.py``) in the engine's place; for
a fault seed, one more run of the cell with each fault of
``fpbench/faults.py`` planted underneath. One JSON line per seed. The
benchmark's own runs never run the control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]
    import torch

    torch.set_num_threads(1)
    from fpbench import cell as cell_mod, faults

    cell = cell_mod.Cell(BENCH_DIR, args.workload)

    def summary(kept):
        """Every number the judge reads, compared or not (none where the
        calls no longer had the judge's form)."""
        return cell.kind.summarize(kept["readings"], None) if kept["readings"] else {}

    controls, faulted = set(_seeds(args.control_seeds)), set(_seeds(args.fault_seeds))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for seed in _seeds(args.seeds):
            t0 = time.perf_counter()
            keep = {}
            result = cell_mod.run(cell, seed, args.seconds, False, "cuda", t0, keep=keep)
            line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                    "metrics": result["metrics"], "program": summary(keep),
                    "run_s": time.perf_counter() - t0}
            if seed in controls:
                t1 = time.perf_counter()
                _, ctl = cell_mod.check(cell, seed, keep["state"], "cuda", sys.stderr,
                                        control=True)
                line["control"] = summary({"readings": ctl})
                line["control_s"] = time.perf_counter() - t1
            del keep
            if seed in faulted:
                line["faults"] = {}
                for name in args.faults.split(","):
                    kept = {}
                    with faults.planted(name):
                        r = cell_mod.run(cell, seed, args.seconds, False, "cuda",
                                         time.perf_counter(), keep=kept)
                    line["faults"][name] = {"correct": r["correct"], **summary(kept)}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
