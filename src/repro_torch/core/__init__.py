from repro_torch.core.strategies import (  # noqa: F401
    AllReduce, MLLess, ParameterServer, ScatterReduce, Spirt, Strategy,
    get_strategy,
)
from repro_torch.core.train_step import TrainStep, build_train_step  # noqa: F401
from repro_torch.core.serve_step import ServeStep, build_serve_step  # noqa: F401
