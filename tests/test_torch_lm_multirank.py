"""The LM training entry point on two gloo ranks on the CPU against the
JAX reference's train step on a two-device pure-DP mesh, each in its own
process (the reference needs its host-device count before it imports
jax): reduced SmolLM, global batch 4 (2 a rank), seq 64, all-reduce,
fused AdamW, the attention kernel's path, two steps from the same
parameters and the same ``lm_batches``."""
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
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
W, STEPS, BATCH, SEQ = 2, 2, 4, 64

_PORT = """
import sys
import numpy as np
import torch
from repro_torch.kernels import fused_adamw, swa_attention
from repro_torch.launch.train import train

rank, inp, out, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
d = np.load(inp)
res = train(arch="smollm-135m", reduced=True, device="cpu",
            strategy="allreduce", steps={steps}, batch={batch}, seq={seq},
            fused_optimizer=True, rank=rank, world_size={W},
            init_method=init, log=None,
            init_params={{k: torch.from_numpy(d[k]) for k in d.files}})
np.savez(out, losses=np.asarray(res["losses"]),
         launches=np.asarray([fused_adamw.LAUNCHES["fused_adamw_flat"],
                              swa_attention.LAUNCHES["swa_attention_fwd"]]))
"""

_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro import optim
from repro.configs.base import get_config
from repro.core import build_train_step, get_strategy
from repro.data import lm_batches, token_stream
from repro.models.transformer import build_model

out = sys.argv[1]
cfg = get_config("smollm-135m").reduced()
model = build_model(cfg, use_pallas=True)
mesh = jax.make_mesh(({W},), ("data",))
ts = build_train_step(model, optim.adamw(3e-3, use_fused=True),
                      get_strategy("allreduce"), mesh, data_axes=("data",),
                      model_axis=None)
state = ts.init_state(jax.random.PRNGKey(0))
it = lm_batches(token_stream({batch} * {seq} * 64, cfg.vocab_size),
                {batch}, {seq})
losses = []
for _ in range({steps}):
    state, m = ts.step_fn(state, jax.tree.map(jnp.asarray, next(it)))
    losses.append(float(m["loss"]))
np.savez(out, losses=np.asarray(losses))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_multirank")
    inp = str(tmp / "params.npz")
    model = jbuild_model(jget_config("smollm-135m").reduced())
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    np.savez(inp, **{k: v.numpy() for k, v in
                     params_from_reference(tree).items()})
    fmt = dict(W=W, steps=STEPS, batch=BATCH, seq=SEQ)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt)),
         str(tmp / "reference.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
                 JAX_PLATFORMS="cpu"))]
    for r in range(W):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_PORT.format(**fmt)),
             str(r), inp, str(tmp / f"port{r}.npz"), f"file://{tmp}/pg"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="2")))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "reference.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(W)])


def test_lm_entry_point_matches_reference_on_two_ranks(results):
    """Each rank trains on its half of the global batch and reports the
    mean loss over ranks: both ranks' losses equal the reference's mean
    over its two shards to 1e-5 (fp32, sums in other orders).  The
    second loss is taken after one fused-AdamW update of the synced
    gradient."""
    ref, ports = results
    assert len(ref["losses"]) == STEPS
    for port in ports:
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)


def test_lm_entry_point_takes_the_plain_versions_on_cpu(results):
    """CPU tensors: no kernel launches on either rank."""
    _, ports = results
    for port in ports:
        assert port["launches"].tolist() == [0, 0]
