from repro_torch.data.synthetic import cifar_like  # noqa: F401
