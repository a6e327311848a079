"""Tiny cells of the benchmark's two configurations, for the CPU tests:
every width cut, the mechanisms kept (experts with capacity, a window
shorter than the sequence, several WKV heads and chunks)."""
import json

from portbench import harness

LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "update_gap": 1e-2,
          "grad_gap_own": 1e-2, "update_gap_own_bf16": 1e-2,
          "update_gap_own_fp32": 1e-2}


def config(name: str, dtype: str = "float32", **changes) -> dict:
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json")
                     .read_text())
    if cfg["reference"] == "mixtral":
        cfg.update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                   d_ff=96, vocab_size=256, window=48, n_experts=4)
    else:
        cfg.update(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                   d_ff=96, vocab_size=256, rwkv_head_dim=32,
                   rwkv_lora_rank=8, n_layers=2)
    cfg.update(dtype=dtype, **changes)
    return cfg


def mix(world: int = 1, batch: int = 2, seq: int = 64, lr: float = 3e-4):
    return {"strategy": "allreduce", "world_size": world, "batch": batch,
            "seq": seq, "lr": lr,
            "adamw": {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                      "weight_decay": 0.0},
            "trace_steps": 2}


def cell(cfg: dict, m: dict, limits=LIMITS) -> harness.Cell:
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    per_layer = [p for p in bench["per_layer"] if "workloads" not in p]
    return harness.Cell(f"tiny-{cfg['name']}", m["world_size"], cfg, m,
                        limits, bench["end_to_end"], per_layer)
