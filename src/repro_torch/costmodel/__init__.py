"""Cloud pricing (``repro.costmodel``): the constants and cost formulas the
serverless simulator bills with.  The FLOP and roofline models are not
ported yet."""
from repro_torch.costmodel import pricing  # noqa: F401
