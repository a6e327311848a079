"""Whole runs on the CPU with the timed path broken underneath: each
fault a training cell can have comes out as not correct.  The runs skip
only the harness's look for a card; the tiny cells keep the program's
precision (bf16) and the limits are the cells' own."""
import json
import os
import time

import pytest

from portbench.tests import threads  # noqa: F401
from portbench import harness
from portbench.faults import FAULTS
from portbench.tests import tiny

CELLS = {"mixtral-8x7b-l1.train.2x4096": 1, "rwkv6-7b-l4.train.1x4096": 1,
         "mixtral-8x7b-l1.dp4-allreduce.2x4096": 2}


def _limits(cell):
    return json.loads((harness.HERE / "limits" / f"{cell}.json")
                      .read_text())


def _tiny_cell(workload):
    real = harness.load_cell(workload)
    # a larger lr than the cells', so a bf16 step at these small widths
    # moves its weights by more than their rounding
    m = tiny.mix(world=CELLS[workload], batch=real.mix["batch"], lr=3e-2)
    return tiny.cell(tiny.config(real.cfg["name"], dtype="bfloat16"), m,
                     _limits(workload))


def faulty_rank(rank, fault, *args):
    """``harness.run_rank`` with ``fault`` planted in this process."""
    with FAULTS[fault]():
        return harness.run_rank(rank, *args)


def _run(c, fault, tmp_path):
    return harness.run_ranks(
        faulty_rank, c.world,
        (fault, c, 2 ** 31 + 99, 0.3, False, "cpu", time.time(),
         "file://" + os.path.join(tmp_path, "rdv")))


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in ("frozen", "fp32_frozen", "half_batch")
] + [("mixtral-8x7b-l1.dp4-allreduce.2x4096", "no_exchange")])
def test_planted_fault_is_not_correct(workload, fault, tmp_path):
    out = _run(_tiny_cell(workload), fault, tmp_path)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", list(CELLS))
@pytest.mark.parametrize("seed", [2 ** 31 + 99, 5, 6])
def test_control_is_not_correct(workload, seed):
    """The reference in fp8 (e4m3 operands, e5m2 gradients), put in the
    program's place, fails the cell's limits."""
    c = _tiny_cell(workload)
    ref = harness.reference_readings(c, seed, "cpu")
    control = harness.reference_readings(c, seed, "cpu", "fp8")
    correct, checks = harness.compare(control, ref, c.limits)
    assert not correct, checks


def test_calibration_reads_each_seed_and_mode(tmp_path):
    """Two ranks take the seeds two at a time; the first seed reads every
    mode, and a run whose float32 leaves never move reads 1 on their
    own-norm update gap."""
    from portbench import calibrate
    c = _tiny_cell("mixtral-8x7b-l1.dp4-allreduce.2x4096")
    out = tmp_path / "cal.jsonl"
    harness.run_ranks(calibrate.calibrate_rank, c.world,
                      (c, [5, 6, 7], ["program", "fp32_frozen"], 1, "cpu",
                       "file://" + os.path.join(tmp_path, "rdv"), str(out)))
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["seed"], r["mode"]) for r in rows] == [
        (5, "program"), (5, "fp32_frozen"), (6, "program"), (7, "program")]
    assert rows[1]["update_gap_own_fp32"] == 1.0
    assert rows[0]["update_gap_own_fp32"] < 1.0
    assert set(rows[0]["ref_change"]) == set(rows[0]["change"])
