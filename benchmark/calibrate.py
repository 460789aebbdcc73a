"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's numbers (set-up's warm-up run
and a short window, judged as a benchmark run judges them), and on the
first ``--control-seeds`` seeds the control's (the reference put in the
program's place, in the nearest precision below the configuration's:
float32 with TF32 products) and each fault's that the cell can have.
Prints one JSON line a seed and writes them to ``--out``.

    python3 benchmark/calibrate.py --workload box_r25.train --seeds 12 \
        --control-seeds 3 --out chiprun_out/calib_box_r25.train.jsonl

The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache",
                                                  "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.Cell(args.workload, harness.load_manifest(ROOT, unproven=True))
    lines = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        line = {"seed": seed, "control": i < args.control_seeds}
        line.update(cell.driver.calibrate(cell, seed, args.device, args.seconds,
                                          with_control=i < args.control_seeds))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write("".join(json.dumps(x) + "\n" for x in lines))
    print(json.dumps({"forbidden": harness.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
