"""Run one cell of the benchmark: ``python3 benchmark/run.py --workload
<config>.<traffic> --seed <n> --seconds <s> --trace <0|1>`` from the root
of a checkout. Prints one JSON line last on stdout (the end-to-end metrics
with ``--trace 0``, the per-layer ones with ``--trace 1``), and each
compared number beside its limit last on stderr. Exits non-zero, printing
no result, without enough CUDA devices or when JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# Every build and kernel cache inside the checkout, at fixed paths, so that
# only the first run of a cell in a checkout builds (the program's own CUDA
# library lives in depth_correction_tpu_torch/_build/, keyed by its sources).
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    man = harness.load_manifest(ROOT)
    if args.workload not in {w["name"] for w in man["workloads"]}:
        man = harness.load_manifest(ROOT, unproven=True)
    cell = harness.Cell(args.workload, man)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("benchmark: %s needs %d CUDA device(s); %d available"
              % (args.workload, cell.chips,
                 torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print("benchmark: the run loaded %s (JAX or the JAX package); no result"
              % ", ".join(bad), file=sys.stderr)
        return 3
    harness.print_checks(out)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
