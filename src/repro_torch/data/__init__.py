from repro_torch.data.loader import (  # noqa: F401
    WorkerShards, global_batch_iter,
)
from repro_torch.data.synthetic import (  # noqa: F401
    cifar_like, lm_batches, token_stream,
)
