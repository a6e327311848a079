"""The port's continuous-batching engine on the CPU: token for token against
the reference's ``ServingEngine`` on the same parameters and prompts, and
against sequential single-request generation, over the reference test
file's cases (more requests than slots, slot reuse, admission waiting for
a free slot, eos, a one-token request, a seeded queue).  Reduced fp32
models; greedy tokens must be equal, not close."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ServingEngine, _batch_dim, _scatter_request,
)


def _pair(arch, kw=None, seed=0):
    kw = kw or {}
    jcfg, cfg = jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jmodel = jbuild_model(jcfg, remat=False)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = transformer.Model(cfg)
    model.load_state_dict(transformer.params_from_reference(tree))
    return jmodel, tree, model


@pytest.fixture(scope="module")
def small():
    return _pair("smollm-135m")


def _sequential_generate(model, prompt, n_new, cache_len):
    V = model.cfg.vocab_size
    logits, cache = model.prefill({"tokens": torch.as_tensor(prompt[None, :])},
                                  cache_len=cache_len)
    toks = [int(torch.argmax(logits[0, -1, :V]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(torch.tensor([[toks[-1]]]), cache,
                                          pos)
        toks.append(int(torch.argmax(logits[0, 0, :V])))
        pos += 1
    return toks


def _prompts(cfg, lens, seed=2):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch,kw", [("smollm-135m", {}),
                                     ("gemma3-4b", {"n_layers": 6}),
                                     ("rwkv6-7b", {})],
                         ids=["smollm", "gemma6", "rwkv"])
def test_engine_matches_reference_engine_and_sequential(arch, kw):
    """Three requests over two slots (gemma: prompts past its window of 64,
    so the local rings wrap); the port's engine gives the reference
    engine's tokens and each request's sequential generation."""
    jmodel, tree, model = _pair(arch, kw)
    lens = (70, 12, 90) if arch == "gemma3-4b" else (7, 12, 5)
    prompts = _prompts(model.cfg, lens, seed=0)
    n_new = [4, 3, 5]
    cache_len = 128 if arch == "gemma3-4b" else 32
    jeng = JServingEngine(jmodel, tree, batch_size=2, cache_len=cache_len)
    eng = ServingEngine(model, batch_size=2, cache_len=cache_len)
    for p, n in zip(prompts, n_new):
        jeng.submit(p, n)
        eng.submit(p, n)
    want, got = jeng.run(), eng.run()
    assert got == want
    for rid, (p, n) in enumerate(zip(prompts, n_new)):
        assert got[rid] == _sequential_generate(model, p, n, cache_len)


def test_seeded_queue_matches_reference_engine(small):
    """A seeded queue of 9 requests with prompt lengths 3-20 and 1-6 new
    tokens over 3 slots, eos on: the same tokens as the reference engine,
    and the same engine steps."""
    jmodel, tree, model = small
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(0, model.cfg.vocab_size, int(rs.randint(3, 21)))
             .astype(np.int32), int(rs.randint(1, 7))) for _ in range(9)]
    eos = int(rs.randint(0, model.cfg.vocab_size))
    jeng = JServingEngine(jmodel, tree, batch_size=3, cache_len=32)
    eng = ServingEngine(model, batch_size=3, cache_len=32)
    for p, n in reqs:
        jeng.submit(p, n, eos_id=eos)
        eng.submit(p, n, eos_id=eos)
    steps = 0
    while True:
        a, b = jeng.step(), eng.step()
        assert a == b
        steps += 1
        if b == 0 and not eng.queue:
            break
        assert list(eng.positions) == list(jeng.positions)
    assert steps > 1
    assert {r: q.generated for r, q in eng.finished.items()} == \
        {r: q.generated for r, q in jeng.finished.items()}


def test_engine_more_requests_than_slots(small):
    _, _, model = small
    engine = ServingEngine(model, batch_size=2, cache_len=16)
    rs = np.random.RandomState(1)
    for _ in range(5):
        engine.submit(rs.randint(0, model.cfg.vocab_size, 4), 3)
    out = engine.run()
    assert len(out) == 5
    assert all(len(v) == 3 for v in out.values())


def test_slot_reuse_after_retire(small):
    """A retired slot admits the next queued request at once (no
    head-of-line blocking), and reuse does not corrupt outputs."""
    _, _, model = small
    prompts = _prompts(model.cfg, (6, 9, 5, 7))
    n_new = [2, 5, 3, 4]                 # rid 0 retires early -> reuse
    engine = ServingEngine(model, batch_size=2, cache_len=32)
    rids = [engine.submit(p, n) for p, n in zip(prompts, n_new)]
    out = engine.run()
    assert len(out) == 4
    for rid, prompt, n in zip(rids, prompts, n_new):
        assert out[rid] == _sequential_generate(model, prompt, n, 32)


def test_admission_waits_for_free_slot(small):
    """With the batch full, a new submission stays queued: step() decodes
    the residents and admits only once one retires."""
    _, _, model = small
    prompts = _prompts(model.cfg, (6, 8, 5))
    engine = ServingEngine(model, batch_size=2, cache_len=32)
    engine.submit(prompts[0], 4)
    engine.submit(prompts[1], 4)
    engine.step()                        # both admitted + 1 decode each
    late = engine.submit(prompts[2], 2)
    assert len(engine.queue) == 1        # batch full: queued, not admitted
    assert engine.step() == 2            # still the two residents
    assert len(engine.queue) == 1 and late not in engine.finished
    out = engine.run()
    assert out[late] == _sequential_generate(model, prompts[2], 2, 32)


def test_eos_early_stop(small):
    """Generation stops the step the eos id is produced, freeing the slot
    before max_new_tokens is exhausted."""
    _, _, model = small
    prompt = _prompts(model.cfg, (7,))[0]
    free_run = _sequential_generate(model, prompt, 6, 32)
    eos = free_run[2]
    engine = ServingEngine(model, batch_size=2, cache_len=32)
    rid = engine.submit(prompt, 6, eos_id=eos)
    out = engine.run()
    stop = free_run.index(eos)
    assert out[rid] == free_run[:stop + 1]
    assert out[rid][-1] == eos and len(out[rid]) < 6


def test_single_token_request_stops_at_prefill(small):
    """max_new_tokens=1 yields exactly one token (the prefill's) without
    ever occupying a decode slot."""
    _, _, model = small
    prompt = _prompts(model.cfg, (6,))[0]
    engine = ServingEngine(model, batch_size=1, cache_len=32)
    rid = engine.submit(prompt, 1)
    engine._admit()
    assert engine.slots == [None] and rid in engine.finished
    other = engine.submit(prompt, 3)     # rides the same single slot
    out = engine.run()
    assert out[rid] == _sequential_generate(model, prompt, 1, 32)
    assert len(out[rid]) == 1
    assert out[other] == _sequential_generate(model, prompt, 3, 32)


def test_seeded_queue_is_deterministic(small):
    """Same seeded queue -> identical outputs across fresh engines."""
    _, _, model = small

    def run_once():
        rs = np.random.RandomState(7)
        engine = ServingEngine(model, batch_size=2, cache_len=32)
        for _ in range(5):
            engine.submit(rs.randint(0, model.cfg.vocab_size, 6),
                          int(rs.randint(1, 5)))
        return engine.run()

    assert run_once() == run_once()


def test_scatter_request_writes_one_slot_row_in_place():
    """A batch-1 cache lands in row ``slot`` (dim 1 under blocks, dim 0
    under tail) of the batched cache's own tensors, nothing else moves."""
    _, _, model = _pair("gemma3-4b", {"n_layers": 7})   # 1 block + 1 tail
    full = model.init_cache(3, 40)
    one = model.init_cache(1, 40)
    for leaf in [t for blk in one["blocks"] + one["tail"]
                 for t in blk.values()]:
        leaf.normal_()
    ptrs = [t.data_ptr() for blk in full["blocks"] + full["tail"]
            for t in blk.values()]
    assert _scatter_request(full, one, 2) is full
    assert [t.data_ptr() for blk in full["blocks"] + full["tail"]
            for t in blk.values()] == ptrs
    for b, o in zip(full["blocks"], one["blocks"]):
        assert torch.equal(b["k"][:, 2], o["k"][:, 0])
        assert not b["k"][:, :2].any()
    for b, o in zip(full["tail"], one["tail"]):
        assert torch.equal(b["v"][2], o["v"][0])
        assert not b["v"][:2].any()
    assert _batch_dim(("blocks", 0, "k")) == 1
    assert _batch_dim(("tail", 0, "k")) == 0

