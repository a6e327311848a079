"""The benchmark is data: its cells, configurations, mixes, limits and
metrics are found by name, a cell added as files and an entry needs no
edit, and ``BENCHMARK.json`` keeps to the contract's shape."""
import json
import re
import shutil

import pytest

from portbench.tests import threads  # noqa: F401
from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_root(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for d in ("configs", "mixes", "limits", "metrics"):
        shutil.copytree(harness.HERE / d, tmp_path / "portbench" / d)
    return tmp_path


def test_a_cell_added_as_files_is_found(tmp_path):
    root = _copy_root(tmp_path)
    cfg = json.loads((root / "portbench/configs/mixtral-8x7b-l1.json")
                     .read_text())
    cfg["name"] = "mixtral-8x7b-l2"
    cfg["n_layers"] = 2
    (root / "portbench/configs/mixtral-8x7b-l2.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "portbench/mixes/train.2x4096.json")
                     .read_text())
    mix["batch"] = 1
    (root / "portbench/mixes/train.1x2048.json").write_text(
        json.dumps(dict(mix, seq=2048)))
    name = "mixtral-8x7b-l2.train.1x2048"
    (root / f"portbench/limits/{name}.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (root / "portbench/metrics/layer_count.py").write_text(
        "def read(ctx):\n    return float(ctx.cell.cfg['n_layers'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "mixtral-8x7b-l2",
                               "traffic": "train.1x2048", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "layer_count", "unit": "layers",
                               "better": "lower", "source":
                               "program_counter", "layer": "models",
                               "moves": "train_tokens_per_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(name, root)
    assert cell.cfg["n_layers"] == 2 and cell.mix["seq"] == 2048
    assert cell.limits == {"loss_gap": 1.0}
    names = [m["name"] for m in cell.per_layer]
    assert "layer_count" in names and "wkv6_roofline" not in names
    assert "swa_attn_roofline" not in names      # listed for other cells
    read = harness.metric_reader("layer_count", root)
    assert read(harness.MetricContext(cell, None, 1, 1, 1, 1, [])) == 2.0


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_and_reports_what_it_must(w):
    cell = harness.load_cell(w)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    assert set(cell.limits) <= {"loss_gap", "grad_gap", "grad_gap_median",
                                "update_gap", "grad_gap_own",
                                "update_gap_own_bf16", "update_gap_own_fp32"}
    assert (harness.HERE / "reference" /
            f"{cell.cfg['reference']}.py").exists()
    harness.model_config(cell.cfg)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its clock at this run length
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for part, allowed in keys.items():
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names))
        for e in BENCH[part]:
            assert set(e) <= allowed, e
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in (
            "d_model", "d_ff", "experts_per_token") for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 0 < len(e["why"]) <= 200 and "\n" not in e["why"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)


def test_a_leaf_that_is_not_finite_fails_every_gap():
    ref = {"losses": [2.0, 2.0], "grad_norms": {"a": 1.0, "b": 2.0},
           "change": {"a": 1.0, "b": 1.0},
           "dtypes": {"a": "float32", "b": "bfloat16"}}
    prog = {"losses": [2.0, 2.0], "grad_norms": {"a": float("nan"),
                                                 "b": 2.0},
            "change": {"a": 1.0, "b": float("nan")}}
    g = harness.gaps(prog, ref)
    assert g["grad_gap"] == g["grad_gap_median"] == g["update_gap"] \
        == g["grad_gap_own"] == g["update_gap_own_bf16"] == float("inf")
    assert g["loss_gap"] == 0.0 and g["update_gap_own_fp32"] == 0.0
    correct, _ = harness.compare(prog, ref, {"grad_gap": 1.0})
    assert not correct


def _leaves(numels, dtype="bfloat16"):
    """Reference readings of leaves whose gradient and change grow with
    the square root of their size, as AdamW's first steps move them."""
    return {"losses": [2.0], "dtypes": {n: dtype for n in numels},
            "grad_norms": {n: k ** 0.5 for n, k in numels.items()},
            "change": {n: 1e-3 * k ** 0.5 for n, k in numels.items()}}


@pytest.mark.parametrize("dtype,number", [
    ("float32", "update_gap_own_fp32"), ("bfloat16", "update_gap_own_bf16")])
def test_a_small_leaf_left_unmoved_reads_one(dtype, number):
    """A leaf a thousandth of the median's size that does not move reads
    1 against its own change, and little against the median's."""
    ref = _leaves({"big": 1 << 24, "mid": 1 << 22}, "bfloat16")
    small = _leaves({"small": 1 << 12}, dtype)
    for k in ("grad_norms", "change", "dtypes"):
        ref[k].update(small[k])
    prog = {"losses": [2.0], "grad_norms": dict(ref["grad_norms"]),
            "change": dict(ref["change"], small=0.0)}
    g = harness.gaps(prog, ref)
    assert g[number] == 1.0
    assert g["update_gap"] < 0.05 and g["grad_gap_own"] == 0.0


def test_the_own_gaps_leave_out_leaves_moved_by_round_off():
    ref = _leaves({"a": 1 << 20, "b": 1 << 20, "c": 1 << 20}, "float32")
    ref["grad_norms"]["c"] = 1e-4 * ref["grad_norms"]["a"]
    prog = {"losses": [2.0], "grad_norms": dict(ref["grad_norms"], c=1.0),
            "change": dict(ref["change"], c=0.0)}
    g = harness.gaps(prog, ref)
    assert g["grad_gap_own"] == g["update_gap_own_fp32"] == 0.0
    assert g["grad_gap"] > 0
