from repro_torch.models.cnn import (  # noqa: F401
    build_cnn, params_from_reference, params_to_reference, reference_leaves,
)
from repro_torch.models.transformer import Model, build_model  # noqa: F401
