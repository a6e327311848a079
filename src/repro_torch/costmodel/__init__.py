"""Cost models (``repro.costmodel``): the cloud pricing the serverless
simulator bills with, the analytic FLOP / byte / parameter counts, the
collective bytes a step issues and the H100 roofline."""
from repro_torch.costmodel import (  # noqa: F401
    collectives, flops, pricing, roofline,
)
