from repro_torch.data.synthetic import (  # noqa: F401
    cifar_like, lm_batches, token_stream,
)
