"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  It
prints the result as the last line of standard output (one JSON object)
and the numbers the ``correct`` comparison held to their limits as the
last lines of standard error.  ``--trace 0`` measures the end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` reads the per-layer
metrics from two profiler passes of the mix's ``trace_steps`` steps, one
of the device's work alone and one of host calls too.  A run
without the cards, or whose process finds JAX or the JAX package
loaded, exits with a code other than 0 and prints no result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the caches of what the program compiles stay at fixed places inside the
# checkout (the port's kernels build into src/repro_torch/kernels/build/)
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload, ROOT)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="portbench-pg-") as rdv:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START,
                               "file://" + os.path.join(rdv, "rendezvous"))
    found = harness.forbidden_modules()
    if out.pop("forbidden_modules") or found:
        print("portbench: JAX or the JAX package was loaded: "
              + (", ".join(found) or "in a rank's process"), file=sys.stderr)
        return 4
    # the numbers compared, beside their limits, last on standard error
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
