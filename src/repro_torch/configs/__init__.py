from repro_torch.configs.base import (  # noqa: F401
    GLOBAL, LOCAL, CNNConfig, ModelConfig, get_config, register,
)
