from repro_torch.configs.base import CNNConfig, get_config, register  # noqa: F401
