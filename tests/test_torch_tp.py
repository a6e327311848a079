"""Tensor parallelism's building blocks (``repro_torch.models.tp`` and the
TP routes of ``models.layers`` / ``models.attention``) on 2 gloo ranks
against the plain op on the whole weights, in float64: the forward and
every gradient (inputs and each rank's slice of each weight) to 1e-6
relative.  Row- and column-parallel linears, a leaf used whole (a norm
scale: its gradient is the rank's slice, not a sum), the vocab-parallel
embedding and cross-entropy over a padded vocab, the gated MLP, and
attention with head-local and with replicated heads.

In process: the dense LMs' reduced configs laid out on a (2, 2) ("data",
"model") mesh spec for spec as the reference lays them out, each rank's
slices tiling every leaf; the CNNs and Whisper under FSDP refused."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import sharding as jshard  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import param_tree  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DENSE = ("smollm-135m", "gemma3-4b", "qwen1.5-4b", "phi3-mini-3.8b")
CASES = ("row", "column", "whole", "embed_rows", "embed_columns",
         "cross_entropy", "mlp_swiglu", "mlp_gelu", "attention_local",
         "attention_local_kv", "attention_replicated")

_RANKS = """
import sys
import dataclasses
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from repro_torch.configs.base import get_config
from repro_torch.core import losses
from repro_torch.models import attention, layers
from repro_torch.models.tp import TensorParallel

rank, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
torch.set_default_dtype(torch.float64)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
tp = TensorParallel(None, 2, rank)
rs = np.random.RandomState(0)
B, S, d, n = 2, 5, 8, 6


def t(*shape):
    return torch.from_numpy(rs.randn(*shape))


def mine(w, dim):
    return w.chunk(2, dim)[rank].clone().requires_grad_()


def grads(y, g, leaves):
    return torch.autograd.grad((y * g).sum(), leaves)


def rel(a, b):
    # a gradient that is zero in exact arithmetic (a key bias's, which the
    # softmax cancels) is held against 1e-3
    return float((a - b).abs().max() / max(b.abs().max(), 1e-3))


res = {{}}


def compare(name, got, want, slices):
    # got, want: lists of tensors; slices: dim along which got is this
    # rank's slice of want (None: whole)
    errs = []
    for a, b, dim in zip(got, want, slices):
        if dim is not None:
            b = b.chunk(2, dim)[rank]
        errs.append(rel(a, b))
    res[name] = np.asarray(errs)


# row- and column-parallel linears, a leaf used whole
for name, dim in (("row", 0), ("column", 1)):
    x, w, g = t(B, S, d), t(d, n), t(B, S, n)
    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    xl, wl = x.clone().requires_grad_(), mine(w, dim)
    y = tp.linear(xl, wl, (d, n))
    want = xw @ ww
    compare(name, [y, *grads(y, g, [xl, wl])],
            [want, *grads(want, g, [xw, ww])], [None, None, dim])
x, w, g = t(B, S, d), 0.1 * t(d), t(B, S, d)
xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
xl, wl = x.clone().requires_grad_(), mine(w, 0)
y = layers.rmsnorm(xl, wl, tp=tp)
want = layers.rmsnorm(xw, ww)
compare("whole", [y, *grads(y, g, [xl, wl])],
        [want, *grads(want, g, [xw, ww])], [None, None, 0])

# the embedding over rows (vocab-parallel) and over columns
V = 12
ids = torch.from_numpy(rs.randint(0, V, (B, S)))
for name, dim in (("embed_rows", 0), ("embed_columns", 1)):
    table, g = t(V, d), t(B, S, d)
    tw, tl = table.clone().requires_grad_(), mine(table, dim)
    y = layers.embed(tl, ids, tp=tp, shape=(V, d))
    want = F.embedding(ids, tw)
    compare(name, [y, *grads(y, g, [tl])], [want, *grads(want, g, [tw])],
            [None, dim])

# vocab-parallel cross-entropy: a padded vocab of 16, labels under 11
Vp = 16
x, table = t(B, S, d), t(d, Vp)
labels = torch.from_numpy(rs.randint(0, 11, (B, S)))
xw, tw = x.clone().requires_grad_(), table.clone().requires_grad_()
xl, tl = x.clone().requires_grad_(), mine(table, 1)
loss = losses.softmax_cross_entropy(
    layers.unembed(tl, xl, tp=tp, shape=(d, Vp)), labels, tp=tp)
want = losses.softmax_cross_entropy(xw @ tw, labels)
compare("cross_entropy", [loss, *torch.autograd.grad(loss, [xl, tl])],
        [want, *torch.autograd.grad(want, [xw, tw])], [None, None, 1])

# the MLP: column-parallel up (and gate), row-parallel down
ff = 10
for kind in ("swiglu", "gelu"):
    x, g = t(B, S, d), t(B, S, d)
    p = {{"w_up": t(d, ff), "w_down": t(ff, d)}}
    if kind == "swiglu":
        p["w_gate"] = t(d, ff)
    dims = {{k: 0 if k == "w_down" else 1 for k in p}}
    pw = {{k: v.clone().requires_grad_() for k, v in p.items()}}
    pl = {{k: mine(v, dims[k]) for k, v in p.items()}}
    xw, xl = x.clone().requires_grad_(), x.clone().requires_grad_()
    keys = sorted(p)
    y = layers.mlp_apply(pl, xl, kind, tp=tp, d_ff=ff)
    want = layers.mlp_apply(pw, xw, kind)
    compare("mlp_" + kind, [y, *grads(y, g, [xl] + [pl[k] for k in keys])],
            [want, *grads(want, g, [xw] + [pw[k] for k in keys])],
            [None, None] + [dims[k] for k in keys])

# attention: project, causal attention, wo
base = get_config("smollm-135m").reduced()
for name, H, KV in (("attention_local", 4, 1), ("attention_local_kv", 4, 2),
                    ("attention_replicated", 3, 3)):
    cfg = dataclasses.replace(base, d_model=32, n_heads=H, n_kv_heads=KV,
                              head_dim=8, qkv_bias=True)
    x, g = t(B, S, 32), t(B, S, 32)
    p = {{"wq": t(32, H * 8), "wk": t(32, KV * 8), "wv": t(32, KV * 8),
         "wo": t(H * 8, 32), "bq": t(H * 8), "bk": t(KV * 8),
         "bv": t(KV * 8)}}
    # the layout leaf_pspec gives: wq, wk, wv and wo on their widest dim
    # (ties to the lower), the biases on theirs where it divides
    dims = {{k: int(np.argmax(v.shape)) if v.shape[int(np.argmax(v.shape))]
            % 2 == 0 else None for k, v in p.items()}}
    pw = {{k: v.clone().requires_grad_() for k, v in p.items()}}
    pl = {{k: mine(v, dims[k]) if dims[k] is not None
          else v.clone().requires_grad_() for k, v in p.items()}}
    xw, xl = x.clone().requires_grad_(), x.clone().requires_grad_()

    def causal(q, k, v):
        # float64 causal softmax attention, head h reading kv head h // G
        G = q.shape[2] // k.shape[2]
        k, v = (u.repeat_interleave(G, dim=2) for u in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        mask = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)

    def run(p, x, tp):
        q, k, v = attention.project_qkv(p, x, cfg, tp)
        k, v = attention.heads_for(q, k, v, cfg, tp)
        o = causal(q, k, v)
        return attention.attention_out(p, o, cfg, tp), q.shape[2]

    keys = sorted(p)
    y, heads = run(pl, xl, tp)
    want, _ = run(pw, xw, None)
    compare(name, [y, *grads(y, g, [xl] + [pl[k] for k in keys])],
            [want, *grads(want, g, [xw] + [pw[k] for k in keys])],
            [None, None] + [dims[k] for k in keys])
    res[name + "/heads"] = np.asarray(heads)
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANKS.format()), str(r),
         str(tmp / f"rank{r}.npz"), f"file://{tmp}/pg"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [np.load(tmp / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("case", CASES)
def test_tp_function_matches_the_whole_weight_op(results, case):
    """The output and every gradient to 1e-6 relative on both ranks (each
    rank's weight gradients against its slice of the whole one)."""
    for res in results:
        errs = res[case]
        assert len(errs) >= 3 or case.startswith("embed")
        assert errs.max() <= 1e-6, errs


def test_attention_heads_local_where_the_model_axis_divides_them(results):
    """4 heads over 2 ranks: 2 a rank, k and v whole (1 kv head) or 1 kv
    head a rank; 3 heads: every rank all three."""
    for res in results:
        assert int(res["attention_local/heads"]) == 2
        assert int(res["attention_local_kv/heads"]) == 2
        assert int(res["attention_replicated/heads"]) == 3


def _spec_list(tree, is_leaf):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=is_leaf)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_layout_on_2x2_equals_the_reference(arch, fsdp):
    """``param_pspecs`` on the (2, 2) mesh spec for spec as the
    reference's; each rank's ``ShardLayout`` slice has the spec's local
    shape, and the four slices tile every leaf."""
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(get_config(arch).reduced(), device="meta")
    tree = param_tree(model)
    specs = sharding.param_pspecs(tree, mesh, fsdp=fsdp)
    jtree = jax.eval_shape(jbuild_model(jget_config(arch).reduced()).init,
                           jax.random.PRNGKey(0))
    want = _spec_list(jshard.param_pspecs(jtree, mesh, fsdp=fsdp),
                      lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = sharding.tree_leaves(specs)
    assert [tuple(s) for s in leaves] == want
    shapes = [tuple(t.shape) for t in sharding.tree_leaves(
        tree, lambda x: isinstance(x, torch.Tensor))]
    for i, (shape, spec) in enumerate(zip(shapes, leaves)):
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        seen = torch.zeros(shape, dtype=torch.int64)
        for r in range(4):
            lay = sharding.shard_layout(shapes, leaves, mesh, ("data",), r,
                                        model_axis="model")
            part = lay.shard(i, full)
            assert tuple(part.shape) == lay.local_shape(i) == \
                sharding.Sharding(mesh, spec).shard_shape(shape)
            assert torch.equal(
                part, sharding.Sharding(mesh, spec).shard(full, r))
            lay.shard(i, seen).add_(1)
        # each element on the ranks the spec replicates it over
        reps = 4 // (int(np.prod(shape)) // int(np.prod(lay.local_shape(i))))
        assert bool((seen == reps).all())
    # the model axis on every dense leaf but where nothing divides
    assert sum("model" in s for s in want) >= len(want) - 1


@pytest.mark.parametrize("case", ["cnn", "whisper-fsdp"])
def test_cnn_and_whisper_fsdp_are_still_refused(case):
    """Every transformer family runs a model axis above 1; the CNNs still
    refuse it (the reference runs them on a model axis of 1), and
    Whisper's encoder still refuses FSDP (the reference shards the
    encoder's leaves but never gathers them)."""
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.launch.dryrun import fake_group
    mesh = make_mesh((2, 2), ("data", "model"))
    if case == "cnn":
        with pytest.raises(NotImplementedError, match="a CNN"):
            sharding.require_tp_family(get_config("mobilenet-cifar"), mesh,
                                       "model")
        for arch in ("mixtral-8x7b", "rwkv6-7b", "recurrentgemma-2b",
                     "whisper-small", "pixtral-12b"):
            sharding.require_tp_family(get_config(arch).reduced(), mesh,
                                       "model")
        return
    with fake_group(4):
        model = Model(get_config("whisper-small").reduced(), device="meta")
        with pytest.raises(ValueError, match="encoder"):
            build_train_step(model, optim.adamw(1e-3),
                             get_strategy("allreduce"), mesh,
                             model_axis="model", fsdp=True).init_state()


def test_a_ring_sharded_on_its_slots_is_refused():
    """Reduced SmolLM on (1, 3): 1 kv head and head_dim 64 do not divide
    over 3, so ``cache_pspecs`` puts the model axis on the ring's 66
    slots.  The serve step no longer refuses it: each rank's cache holds
    22 slots, and the decode step runs on them (shapes only, over a fake
    process group) to whole logits."""
    from repro_torch.core import build_serve_step
    from repro_torch.launch.dryrun import fake_group
    with fake_group(3):
        model = Model(get_config("smollm-135m").reduced(), device="meta")
        ss = build_serve_step(model, make_mesh((1, 3), ("data", "model")),
                              model_axis="model", batch_size=1, cache_len=66)
        token, cache, pos = ss.make_inputs("decode", 66)
        assert cache["blocks"][0]["k"].shape == (2, 1, 22, 1, 64)
        logits, _ = ss.decode_fn(token, cache, pos)
        assert logits.shape == (1, 1, model.padded_vocab)
