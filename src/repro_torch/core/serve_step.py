"""Serving steps (``repro.core.serve_step``): prefill and
single-token decode for one device.

The reference jits both under a mesh with explicit shardings and donates
the cache to decode.  The port runs them eagerly on the model's device:
the model holds its parameters, so neither step takes them, and decode
writes the cache in place (what donation buys the reference).  Meshes,
shardings and the dry-run that lowers ``make_inputs`` belong to the
sharding slice; here ``make_inputs`` gives tensors on the ``meta`` device
with the reference's shapes and dtypes, which allocate nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch


@dataclasses.dataclass
class ServeStep:
    prefill_fn: Callable      # batch -> (last-token logits, cache)
    decode_fn: Callable       # (token, cache, pos) -> (logits, cache)
    make_inputs: Callable     # (shape_kind, seq_len) -> meta inputs


def build_serve_step(model, *, batch_size: int, cache_len: int,
                     swa_variant: bool = False) -> ServeStep:
    prefill = functools.partial(model.prefill, cache_len=cache_len,
                                swa_variant=swa_variant)

    def decode(token, cache, pos):
        return model.decode_step(token, cache, pos, swa_variant=swa_variant)

    def make_inputs(shape_kind: str, seq_len: int):
        """Meta tensors of the step's inputs: ``{"tokens": (B, seq_len)}``
        (with a VLM's ``patch_emb`` (B, n_patches, d) and an
        encoder-decoder's ``frames`` (B, encoder_seq, d) in the model
        dtype) for ``"prefill"``, else (token (B, 1), the cache, pos ()),
        every id and position int32 as in the reference."""
        B = batch_size
        meta = torch.device("meta")
        cfg = model.cfg
        if shape_kind == "prefill":
            batch = {"tokens": torch.empty((B, seq_len), dtype=torch.int32,
                                           device=meta)}
            dtype = getattr(torch, cfg.dtype)
            if cfg.family == "vlm":
                batch["patch_emb"] = torch.empty(
                    (B, cfg.n_patches, cfg.d_model), dtype=dtype, device=meta)
            if cfg.is_encoder_decoder:
                batch["frames"] = torch.empty(
                    (B, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                    device=meta)
            return batch
        token = torch.empty((B, 1), dtype=torch.int32, device=meta)
        cache = model.init_cache(B, cache_len, swa_variant=swa_variant,
                                 device=meta)
        return token, cache, torch.empty((), dtype=torch.int32, device=meta)

    return ServeStep(prefill_fn=prefill, decode_fn=decode,
                     make_inputs=make_inputs)
