"""Roofline terms of a step (``repro.costmodel.roofline``), for the
NVIDIA H100 in place of the reference's TPU v5e:

    compute term    = FLOPs_global / (chips x peak FLOP/s)
    memory term     = HBM bytes per device / HBM bandwidth
    collective term = wire bytes per device / link bandwidth

The formulas are the reference's; the bytes per device come from the
dry-run (``launch.dryrun``: the state and batch shards, the tracked
temporaries, and ``costmodel.collectives``' wire bytes), the global FLOPs
from ``costmodel.flops``.

The constants are NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16
on the tensor cores, 3.35 TB/s HBM3, 80 GB of HBM, and NVLink 4 at 900
GB/s in total, 450 GB/s each way.  ``pricing.py`` stays the cost model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class H100:
    name: str = "NVIDIA H100 SXM5 80GB"
    peak_flops_bf16: float = 989e12      # dense, tensor cores
    hbm_bandwidth: float = 3.35e12       # B/s, HBM3
    ici_bandwidth: float = 450e9         # B/s, NVLink 4, one direction
    hbm_bytes: float = 80e9


HW = H100()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # 6 N_active D
    hlo_flops: float            # the analytic count (``costmodel.flops``)
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * HW.peak_flops_bf16)

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_lower_bound_s": self.step_time_s,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_upper_bound": self.mfu_upper_bound, "chips": self.chips,
        }


def roofline(flops_global: float, hbm_bytes_per_dev: float,
             wire_bytes_per_dev: float, chips: int,
             model_flops: float) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_global / (chips * HW.peak_flops_bf16),
        memory_s=hbm_bytes_per_dev / HW.hbm_bandwidth,
        collective_s=wire_bytes_per_dev / HW.ici_bandwidth,
        model_flops=model_flops, hlo_flops=flops_global, chips=chips)
