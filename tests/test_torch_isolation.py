"""The port stands alone: no module under ``src/repro_torch/``, and not
``chip_smoke.py``, imports ``jax`` or the reference package ``repro``
(the GPU machine has no JAX; the port keeps its own copies), nor
``msgpack`` or ``ml_dtypes``, which the GPU machine does not list (the
checkpoint format has its own codec)."""
import ast
from pathlib import Path

import pytest
import torch_threads  # noqa: F401  (pins torch's CPU threads)

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_modules_to_check():
    assert len(FILES) > 10
    port = ROOT / "src" / "repro_torch"
    for rel in ("kernels/ops.py", "kernels/fused_adamw.py",
                "kernels/swa_attention.py", "models/transformer.py",
                "models/attention.py", "models/layers.py", "models/params.py",
                "configs/smollm_135m.py", "configs/gemma3_4b.py",
                "configs/rwkv6_7b.py", "kernels/wkv6.py", "models/rwkv6.py",
                "core/compression.py", "guards.py", "costmodel/pricing.py",
                "serverless/archs.py", "serverless/simulator.py",
                "serverless/traces.py", "serverless/autoscale.py",
                "serverless/runtime_ref.py", "serverless/runtime.py",
                "serverless/sweep.py", "models/kvquant.py",
                "core/serve_step.py", "core/flash_decode.py",
                "serving/__init__.py", "serving/engine.py",
                "serving/workload.py", "serving/fleet.py",
                "serving/steady_state.py", "launch/serve.py",
                "costmodel/flops.py", "checkpoint/checkpoint.py",
                "checkpoint/codec.py", "resilience/harness.py",
                "resilience/schedule.py", "resilience/store.py",
                "resilience/state.py", "launch/resilient_train.py",
                "launch/_subprocess.py", "models/moe.py",
                "models/rglru.py", "data/loader.py",
                "configs/mixtral_8x7b.py", "configs/mixtral_8x22b.py",
                "configs/recurrentgemma_2b.py", "configs/whisper_small.py",
                "configs/pixtral_12b.py", "core/sharding.py",
                "launch/mesh.py", "launch/distributed.py",
                "launch/dryrun.py", "costmodel/collectives.py",
                "costmodel/roofline.py"):
        assert port / rel in FILES, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_dynamic_imports_are_seen(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import importlib\n"
                     "importlib.import_module('repro.core')\n"
                     "from jax import numpy\n")
    assert {"repro", "jax"} <= set(_imported_roots(probe))
