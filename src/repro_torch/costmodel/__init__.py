"""Cost models (``repro.costmodel``): the cloud pricing the serverless
simulator bills with, and the analytic FLOP / byte / parameter counts.
The roofline model waits for the sharding and dry-run slice."""
from repro_torch.costmodel import flops, pricing  # noqa: F401
