"""Reads, on the chip at a cell's own size, the numbers the ``correct``
comparison holds to its limits: for sound runs of the program over many
seeds, for the control (the reference in fp8, put in the program's
place) and for the planted faults of ``faults.py``.  The limits in
``limits/<cell>.json`` are set from these readings; the benchmark's own
runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,half_batch --out chiprun_out/cal.jsonl

One process (one a rank) reads every seed: the model is built once and
given each seed's weights.  The ranks take the seeds W at a time: all
run the program on each, then each rank runs one seed's reference (and
control) at once.  Each line of ``--out`` is one (seed, mode): its gaps,
its losses and the reference's, its worst leaves, and both sides' norms
of each leaf, from which any gap can be worked out again.
"""
import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


def _row(seed, mode, mine, ref):
    g = harness.leaf_gaps(mine, ref)
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]
    return {"seed": seed, "mode": mode, **harness.gaps(mine, ref),
            "losses": mine["losses"], "ref_losses": ref["losses"],
            "worst_grad_own": worst(g["grad_own"]),
            "worst_update_own": worst(g["update_own"]),
            "grad_norms": mine["grad_norms"], "change": mine["change"],
            "ref_grad_norms": ref["grad_norms"], "ref_change": ref["change"],
            "dtypes": ref["dtypes"]}


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def calibrate_rank(rank, cell, seeds, modes, full, device, init, out,
                   queue=None):
    """``modes`` on the first ``full`` seeds, the program alone on the
    rest."""
    rows = []
    modes_of = {s: modes if i < full else ["program"]
                for i, s in enumerate(seeds)}
    b1 = cell.mix["adamw"]["b1"]
    W = cell.world
    with harness.process_group(rank, W, device, init) as (dev, host):
        model = None
        for at in range(0, len(seeds), W):
            group = seeds[at:at + W]
            mine = {}
            for seed in group:
                for mode in modes_of[seed]:
                    if mode == "control":
                        continue
                    fault = FAULTS[mode]() if mode in FAULTS \
                        else contextlib.nullcontext()
                    with fault:
                        prog = harness.build_program(cell, seed, dev, rank,
                                                     model=model)
                        mine[seed, mode] = harness.check_steps(prog, b1)
                    model = prog.model
                    del prog
                    _free(dev)
            mine_rows = []
            if rank < len(group):
                seed = group[rank]
                ref = harness.reference_readings(cell, seed, dev)
                if "control" in modes_of[seed]:
                    mine[seed, "control"] = harness.reference_readings(
                        cell, seed, dev, "fp8")
                mine_rows = [_row(seed, mode, mine[seed, mode], ref)
                             for mode in modes_of[seed]]
                del ref
                _free(dev)
            got = [None] * W
            dist.all_gather_object(got, mine_rows, group=host)
            if rank == 0:
                for row in (r for part in got for r in part):
                    rows.append(row)
                    print(json.dumps({k: v for k, v in row.items()
                                      if "norms" not in k and "change"
                                      not in k and k != "dtypes"}),
                          flush=True)
                    with open(out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    if rank == 0 and queue is not None:
        queue.put(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--full", type=int, default=None,
                    help="the seeds, from the first, that read every mode; "
                    "the rest read the program alone (default: all)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = args.modes.split(",")
    full = len(seeds) if args.full is None else args.full
    with tempfile.TemporaryDirectory(prefix="portbench-pg-") as rdv:
        harness.run_ranks(calibrate_rank, cell.world,
                          (cell, seeds, modes, full, args.device,
                           "file://" + os.path.join(rdv, "rendezvous"),
                           args.out))


if __name__ == "__main__":
    main()
