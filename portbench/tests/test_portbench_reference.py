"""Each plain reference against the program at reduced widths on the
CPU, in fp32: the same loss and gradients from the same weights and
batch, and the same three training steps through the harness, on one
rank and on two."""
import os
import time

import pytest
import torch

from portbench.tests import threads  # noqa: F401
from portbench import harness
from portbench.reference import common
from portbench.tests import tiny


def _program_and_reference(cfg, m, seed):
    from repro_torch.core.train_step import default_loss
    from repro_torch.models import build_model
    dev = torch.device("cpu")
    model = build_model(harness.model_config(cfg), use_kernel=True,
                        device=dev, seed=0)
    ref = harness.reference_module(cfg)
    specs = ref.leaf_specs(cfg)
    model.load_state_dict(common.draw_state(specs, seed, dev))
    batch = {k: torch.from_numpy(v) for k, v in
             harness.global_batches(cfg, m, seed)[0].items()}
    loss = default_loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    params = {n: t.float().requires_grad_() for n, t in
              common.draw_state(specs, seed, dev).items()}
    rloss = ref.loss(params, batch, cfg, common.exact)
    rgrads = torch.autograd.grad(rloss, [params[n] for n in names])
    return loss, dict(zip(names, grads)), rloss, dict(zip(names, rgrads))


@pytest.mark.parametrize("name,changes", [
    ("mixtral-8x7b-l1", {}),
    # a capacity that drops pairs, and two layers
    ("mixtral-8x7b-l1", {"capacity_factor": 0.5, "n_layers": 2}),
    ("rwkv6-7b-l4", {}),
])
def test_reference_matches_program(name, changes):
    cfg = tiny.config(name, **changes)
    loss, grads, rloss, rgrads = _program_and_reference(
        cfg, tiny.mix(), 2 ** 31 + 77)
    loss, rloss = float(loss.detach()), float(rloss.detach())
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    for n, g in grads.items():
        r = rgrads[n]
        assert torch.linalg.vector_norm(g - r) <= \
            1e-4 * torch.linalg.vector_norm(r) + 1e-9, n


def test_leaf_specs_name_every_program_leaf():
    for name in ("mixtral-8x7b-l1", "rwkv6-7b-l4"):
        cfg = tiny.config(name)
        from repro_torch.models import build_model
        model = build_model(harness.model_config(cfg), device="meta")
        specs = harness.reference_module(cfg).leaf_specs(cfg)
        assert {n: tuple(t.shape) for n, t in model.state_dict().items()} \
            == {n: tuple(s[0]) for n, s in specs.items()}


def test_draw_state_repeats_for_a_seed():
    specs = harness.reference_module(tiny.config("rwkv6-7b-l4")) \
        .leaf_specs(tiny.config("rwkv6-7b-l4"))
    a = common.draw_state(specs, 2 ** 33 + 1, "cpu")
    b = common.draw_state(specs, 2 ** 33 + 1, "cpu")
    c = common.draw_state(specs, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])
    lo, hi = specs["blocks.0.rwkv.decay_base"][2][1:]
    assert lo <= float(a["blocks.0.rwkv.decay_base"].min()) and \
        float(a["blocks.0.rwkv.decay_base"].max()) <= hi


@pytest.mark.parametrize("name,world", [("mixtral-8x7b-l1", 1),
                                        ("rwkv6-7b-l4", 1),
                                        ("mixtral-8x7b-l1", 2)])
def test_harness_run_in_fp32_reads_correct(name, world, tmp_path):
    """A whole run on the CPU in fp32: the program's three steps read
    as the reference's, on one rank and as the mean of two ranks'."""
    c = tiny.cell(tiny.config(name), tiny.mix(world=world))
    out = harness.run_cell(c, 2 ** 31 + 5, 0.5, False, "cpu", time.time(),
                           "file://" + os.path.join(tmp_path, "rdv"))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    for k in ("loss_gap", "grad_gap", "update_gap"):
        assert out["checks"][k]["value"] < 1e-4
    assert list(out)[-1] == "checks"
