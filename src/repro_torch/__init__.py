"""PyTorch / CUDA port of the gradient-sync study, written for an NVIDIA
H100 beside the JAX package ``repro``, which stays the reference.

Module names mirror ``repro`` so each counterpart is easy to find.  Public
functions keep the reference's layouts at their boundary (images NHWC,
parameter trees of the same shape), so the parity tests compare like with
like.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see ``repro_torch.device.resolve_device``.
"""
