"""Byzantine-robust training (``repro.serverless``, the part real training
uses): the attack registry, ``ByzantineGradients`` and the robust
aggregators.  The simulator, event runtime and cost stack are not ported
yet, so nothing here imports them."""
from repro_torch.serverless.adversarial import (  # noqa: F401
    AttackSpec, get_attack, list_attacks, register_attack,
    unregister_attack,
)
from repro_torch.serverless.faults import ByzantineGradients  # noqa: F401
from repro_torch.serverless.recovery import (  # noqa: F401
    CoordinateMedian, GeometricMedian, Krum, TrimmedMean,
    coordinate_median, geometric_median, krum, trimmed_mean,
    trimmed_mean_sort,
)
