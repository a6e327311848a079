"""Context-parallel flash-decode on 2 and 4 gloo ranks against the
reference's single-device ``decode_attention`` over the whole cache, over
the cases of ``tests/test_flash_decode.py`` (a window or none; a position
before the ring's wrap or past it), atol 2e-5.  Each rank holds a
contiguous shard of the ring; the inputs come from a numpy seed."""
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.attention import decode_attention as jdecode_attention  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
B, L, KV, G, hd = 2, 64, 2, 3, 32
CASES = list(itertools.product([None, 48], [False, True]))

_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core.flash_decode import flash_decode_attention

rank, W, inp, out, init = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4], sys.argv[5])
d = np.load(inp)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=W)
L_loc = d["k"].shape[1] // W
sl = slice(rank * L_loc, (rank + 1) * L_loc)
res = {}
for c, (window, pos) in enumerate(zip(d["windows"], d["positions"])):
    got = flash_decode_attention(
        torch.from_numpy(d["q"]), torch.from_numpy(d["k"][:, sl].copy()),
        torch.from_numpy(d["v"][:, sl].copy()), torch.tensor(int(pos)),
        total_len=d["k"].shape[1], window=None if window < 0 else int(window))
    res[str(c)] = got.numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.randn(B, 1, KV * G, hd).astype(np.float32),
            rs.randn(B, L, KV, hd).astype(np.float32),
            rs.randn(B, L, KV, hd).astype(np.float32))


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def ranks(tmp_path_factory, request):
    W = request.param
    tmp = tmp_path_factory.mktemp(f"flash{W}")
    q, k, v = _inputs()
    inp = str(tmp / "inputs.npz")
    # ring semantics: if pos wrapped, all slots hold recent positions
    np.savez(inp, q=q, k=k, v=v,
             windows=np.array([-1 if w is None else w for w, _ in CASES]),
             positions=np.array([L + 7 if wrap else L - 1
                                 for _, wrap in CASES]))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(W), inp,
         str(tmp / f"rank{r}.npz"), f"file://{tmp}/pg"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(W)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [np.load(tmp / f"rank{r}.npz") for r in range(W)]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"window{w}-{'wrapped' if p else 'unwrapped'}"
                              for w, p in CASES])
def test_flash_decode_matches_reference(ranks, case):
    """Every rank returns the whole result, equal to the reference's
    decode attention over the unsharded cache."""
    window, wrapped = CASES[case]
    q, k, v = _inputs()
    pos = L + 7 if wrapped else L - 1
    want = np.asarray(jdecode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(pos),
                                        window=window))
    for res in ranks:
        np.testing.assert_allclose(res[str(case)], want, atol=2e-5)
