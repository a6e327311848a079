"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's compiled numbers, with no process of the reference: at the
small case whose numbers the reference's ``compiled.memory_analysis()``
and ``analyze_collectives`` give on a 4-device ``("data",)`` mesh (reduced
SmolLM, fp32, global batch 8 x 64), the argument bytes and every
collective's bytes; the H100 roofline against the reference's formulas;
one production-mesh dry-run on the fake process group."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

from repro.costmodel import roofline as jroofline  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.costmodel import roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_groups  # noqa: E402

SMALL = InputShape("small", 64, 8, "train")
# the reference's compiled step on 4 devices: argument bytes per device
# (the state shard plus the 1,024 B batch shard) and {kind: (bytes, ops)}
REFERENCE = {
    "zero3": (6_495_240, {"all-reduce": 1_049_604,
                          "all-gather": (8_921_088, 36),
                          "reduce-scatter": (1_115_136, 18)}),
    "dp": (16_531_464, {"all-reduce": 5_510_148, "all-gather": (0, 0),
                        "reduce-scatter": (0, 0)}),
}


@pytest.mark.parametrize("profile", ["zero3", "dp"])
def test_small_case_equals_the_reference_compiled_numbers(profile):
    res = dryrun.dryrun_one(
        "smollm-135m", "small", profile=profile, save=False,
        mesh=make_mesh((4,), ("data",)),
        config=get_config("smollm-135m").reduced(), input_shape=SMALL)
    args, coll = REFERENCE[profile]
    assert res["memory"]["argument_bytes"] == args
    assert res["fsdp"] == (profile == "zero3") and res["chips"] == 4
    got = res["collectives"]
    assert got["bytes_by_kind"]["all-reduce"] == coll["all-reduce"]
    for kind in ("all-gather", "reduce-scatter"):
        assert (got["bytes_by_kind"][kind], got["counts"][kind]) == \
            coll[kind]
    assert got["unresolved_loops"] == 0
    assert res["memory"]["temp_bytes"] > 0
    assert res["cost_analysis_raw"] is None
    # wire bytes: the all-reduce twice, the reduce-scatter W - 1 times
    assert got["wire_bytes_per_device"] == 2 * coll["all-reduce"] + \
        coll["all-gather"][0] + 3 * coll["reduce-scatter"][0]


@pytest.mark.parametrize("terms", [
    (1.7e15, 3.1e9, 6.2e8, 256, 1.0e15), (3.3e12, 1.2e10, 0.0, 4, 2.2e12),
    (0.0, 0.0, 0.0, 1, 0.0)])
def test_roofline_equals_the_reference_under_h100_constants(terms,
                                                            monkeypatch):
    monkeypatch.setattr(jroofline, "HW", roofline.HW)
    want = jroofline.roofline(*terms).as_dict()
    got = roofline.roofline(*terms).as_dict()
    assert got == want


def test_h100_constants():
    hw = roofline.HW
    assert (hw.peak_flops_bf16, hw.hbm_bandwidth, hw.ici_bandwidth,
            hw.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)


def test_long_500k_fits_one_card_at_zero3():
    """SmolLM-135M decoding at batch 1 x 524,288 on 16x16 under zero3 (the
    reference's SWA variant: a ring of the 4,096-slot window a layer):
    the ring is sequence-sharded over the 256 ranks (16 slots each) and
    flash-decode's three all-reduces a layer are the only collectives."""
    res = dryrun.dryrun_one("smollm-135m", "long_500k", profile="zero3",
                            save=False)
    assert res["swa_variant"] and res["chips"] == 256
    assert 0 < res["memory"]["peak_estimate_gb"] < 80
    coll = res["collectives"]["counts"]
    assert coll["all-reduce"] == 3 * 30 and coll["all-gather"] == 0
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


def test_baseline_profile_waits_for_tp():
    """``baseline``, the default profile as in the reference, runs the
    dense LMs with tensor parallelism over the 16-way model axis (the
    strategy over the 16 data ranks, no FSDP for SmolLM), and the other
    families too: reduced Mixtral and RWKV6 on the production mesh at a
    small shape, whose parameters a rank holds are about 1/16 of the
    ``dp`` profile's (RWKV's 8 heads do not divide over 16: its time-mix
    runs every head on every rank from whole leaves)."""
    from repro_torch.configs.base import InputShape, get_config
    res = dryrun.dryrun_one("smollm-135m", "train_4k", save=False)
    assert res["profile"] == "baseline" and res["fsdp"] is False
    assert res["chips"] == 256 and 0 < res["memory"]["peak_estimate_gb"] < 80
    counts = res["collectives"]["counts"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0
    small = InputShape("small", 32, 256, "train")
    for arch in ("mixtral-8x7b", "rwkv6-7b"):
        got = {prof: dryrun.dryrun_one(
            arch, "small", profile=prof, save=False,
            config=get_config(arch).reduced(), input_shape=small)
            for prof in ("baseline", "dp")}
        assert "skipped" not in got["baseline"]
        assert got["baseline"]["collectives"]["counts"]["all-gather"] > 0
        assert got["baseline"]["memory"]["argument_bytes"] < \
            got["dp"]["memory"]["argument_bytes"] / 8


def test_fsdp_required_recomputed_for_80gb():
    """Parameters at 2 B and moments at 8 B a parameter over the 16-way
    model axis: only Mixtral 8x22B passes 80 GB."""
    assert dryrun.FSDP_REQUIRED == {"mixtral-8x22b"}


def test_transformer_archs_are_the_registry_s_non_cnn_names():
    """``TRANSFORMER_ARCHS`` (in the order ``--all`` runs them) holds
    exactly the non-CNN names of ``all_arch_names()``."""
    from repro_torch.configs.base import all_arch_names, get_config
    want = [a for a in all_arch_names() if get_config(a).family != "cnn"]
    assert sorted(dryrun.TRANSFORMER_ARCHS) == want
    assert len(set(dryrun.TRANSFORMER_ARCHS)) == len(want) == 10


def test_fsdp_flag_of_the_command_line(tmp_path, monkeypatch):
    """``--fsdp`` gives the JSON of ``dryrun_one(..., fsdp=True)`` but for
    the trace time; without it ``FSDP_REQUIRED`` decides (SmolLM: no
    FSDP), as in the reference's CLI."""
    import json
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "results")
    runs = {}
    for flag in ("--fsdp", None):
        out = tmp_path / f"{flag}.json"
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                     "--json-out", str(out)] + ([flag] if flag else []))
        (runs[flag],) = json.loads(out.read_text())
        runs[flag].pop("trace_s")
    want = json.loads(json.dumps(dryrun.dryrun_one(
        "smollm-135m", "train_4k", fsdp=True, save=False), default=float))
    want.pop("trace_s")
    assert runs["--fsdp"] == want and want["fsdp"] is True
    assert runs[None]["fsdp"] is ("smollm-135m" in dryrun.FSDP_REQUIRED) \
        is False
    assert runs[None]["memory"] != want["memory"]
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == [
        "smollm-135m__train_4k__16x16.json"]


def test_record_collectives_kinds_and_wire_factors():
    """Every collective the port issues, on a fake group of 4 ranks:
    result bytes and the reference's wire factors (all-reduce 2x,
    reduce-scatter g - 1 times its result); the wrappers go again on
    exit."""
    import torch.distributed as dist
    from repro_torch.costmodel.collectives import (io_bytes,
                                                   record_collectives,
                                                   stats)
    before = dist.all_reduce
    x = torch.zeros(10)                      # 40 B
    with dryrun.fake_group(4):
        with record_collectives() as recs:
            dist.all_reduce(x)
            dist.all_gather_into_tensor(torch.zeros(40), x)
            dist.all_gather([torch.zeros(10) for _ in range(4)], x)
            dist.reduce_scatter_tensor(torch.zeros(10), torch.zeros(40))
            dist.all_to_all_single(torch.zeros(40), torch.zeros(40))
            dist.broadcast(x, src=0)
    assert dist.all_reduce is before
    st = stats(recs)
    assert st.counts == {"all-reduce": 1, "all-gather": 2,
                         "reduce-scatter": 1, "all-to-all": 1,
                         "collective-permute": 0, "broadcast": 1}
    assert st.bytes_by_kind["all-gather"] == 320
    assert st.total_bytes == 40 + 320 + 40 + 160 + 40
    assert st.wire_bytes == 2 * 40 + 320 + 3 * 40 + 160 + 40
    assert all(r.group_size == 4 for r in recs)
    assert io_bytes({"a": x, "b": [torch.zeros(2, dtype=torch.int8)]},
                    (torch.zeros(3, dtype=torch.float64),)) == (42, 24)


def test_distributed_bring_up_from_the_env_contract(monkeypatch):
    """``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
    bring up the default group (gloo on the CPU), idempotently; the
    production topology check and the host's batch slice read it."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch import distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("REPRO_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "1")
    monkeypatch.setenv("REPRO_PROCESS_ID", "0")
    distributed.initialize_distributed(device="cpu")
    try:
        distributed.initialize_distributed(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="expected 256 ranks"):
            distributed.assert_production_topology(False)
        assert distributed.host_local_batch_slice(256) == (0, 256)
        # the slice that is the whole default group is that group
        assert mesh_groups(make_mesh((1, 1), ("data", "model")),
                           ("data",)) == {(0,): None}
    finally:
        dist.destroy_process_group()
