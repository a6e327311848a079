"""Cloud pricing constants and cost formulas (paper §3.1/§4.1).

The Lambda formula is the paper's:  Cost = Time(s) × RAM(GB) × $/GB-s.
TPU v5e pricing extends the comparison beyond-paper (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses

# --- AWS (paper's constants) ---
LAMBDA_USD_PER_GB_S = 0.0000166667          # x86, us-east
G4DN_XLARGE_USD_PER_HOUR = 0.526            # 1x NVIDIA T4, on-demand
S3_PUT_USD = 0.005 / 1000                   # per request
S3_GET_USD = 0.0004 / 1000
SQS_USD_PER_MILLION = 0.40
STEP_FUNCTIONS_USD_PER_TRANSITION = 0.000025

# --- TPU (beyond-paper extension) ---
TPU_V5E_USD_PER_CHIP_HOUR = 1.20            # on-demand, us-central


def lambda_cost(seconds: float, ram_gb: float, invocations: int = 1) -> float:
    return seconds * ram_gb * LAMBDA_USD_PER_GB_S * invocations


def gpu_cost(seconds: float, n_instances: int = 1,
             usd_per_hour: float = G4DN_XLARGE_USD_PER_HOUR) -> float:
    return seconds / 3600.0 * usd_per_hour * n_instances


def tpu_cost(seconds: float, n_chips: int,
             usd_per_chip_hour: float = TPU_V5E_USD_PER_CHIP_HOUR) -> float:
    return seconds / 3600.0 * usd_per_chip_hour * n_chips


def storage_ops_cost(puts: int, gets: int) -> float:
    return puts * S3_PUT_USD + gets * S3_GET_USD


@dataclasses.dataclass(frozen=True)
class TPUv5e:
    """Roofline hardware constants (per chip)."""
    peak_flops_bf16: float = 197e12       # FLOP/s
    hbm_bandwidth: float = 819e9          # B/s
    ici_bandwidth: float = 50e9           # B/s per link
    hbm_bytes: float = 16e9


HW = TPUv5e()
