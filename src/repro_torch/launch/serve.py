"""Serving entry point (``repro.launch.serve``): prefill a batch of
prompts, then decode N tokens greedily through ``core.build_serve_step``.

  # full-width SmolLM-135M on one GPU, prefill through the attention kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 64 --decode-tokens 16

  # reduced, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --device cpu --batch 4 --prompt-len 64 --decode-tokens 16

The model's attention runs through the Hopper kernel (``use_kernel``,
the plain version on the CPU); weights are drawn from ``--seed`` on the
device, prompts from a numpy ``RandomState(seed)``, and from the same
draws, as the reference makes them, a VLM's stub patch embeddings and an
encoder-decoder's stub frames (``0.1 * randn`` in the model dtype).  ``--layers`` cuts
the depth and nothing else.

``--mesh DxM`` serves over D x M ranks (``--world-size``, one process
each, as ``launch.train`` runs them): the cache is batch-sharded where the
batch divides over the D data ranks and sequence-sharded otherwise
(``core.serve_step``); a model axis M above 1 is tensor parallelism
(every family): each rank of a model group holds its slice of the
parameters and of the cache's kv heads, head_dim or ring slots, an
RWKV6 state's N dim, an RG-LRU state's channels or taps.

  # reduced SmolLM, batch 1, the cache sequence-sharded over 4 CPU ranks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --device cpu --world-size 4 --mesh 4x1 --batch 1

  # full-width SmolLM, 2-way data x 2-way tensor parallel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --world-size 4 --mesh 2x2 --batch 16 --prompt-len 512

  # reduced RWKV6, its state sharded on an N dim over the model axis
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --reduced --device cpu --world-size 4 --mesh 2x2 --batch 4

  # reduced SmolLM, its ring on its 21 slots over the model axis of 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --device cpu --world-size 3 --mesh 1x3 --batch 2 \
      --prompt-len 16 --decode-tokens 5
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import build_serve_step
from repro_torch.launch.train import _rank_device, parse_mesh, process_group
from repro_torch.models import build_model


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(*, arch: str, batch: int = 4, prompt_len: int = 64,
          decode_tokens: int = 16, reduced: bool = False, n_layers=None,
          device="cuda", seed: int = 0, mesh=None, rank: int = 0,
          world_size: int = 1, init_method=None, log=print) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``decode_tokens`` more; returns the tokens ((rows, 1 + decode_tokens)
    numpy int32, the first from the prefill; the rank's rows over a
    batch-sharded mesh) and the host times.  ``mesh`` (``"DxM"``) serves
    as ``rank`` of ``world_size`` (see the module docstring)."""
    mesh = parse_mesh(mesh, world_size)
    dev = _rank_device(device, rank)
    if mesh is None:
        return _serve(arch, batch, prompt_len, decode_tokens, reduced,
                      n_layers, dev, seed, None, log)
    with process_group(dev, rank, world_size, init_method):
        return _serve(arch, batch, prompt_len, decode_tokens, reduced,
                      n_layers, dev, seed, mesh, log if rank == 0 else
                      (lambda _: None))


def _serve(arch, batch, prompt_len, decode_tokens, reduced, n_layers, dev,
           seed, mesh, log):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, use_kernel=True, device=dev, seed=seed)
    cache_len = prompt_len + decode_tokens
    if mesh is None:
        ss = build_serve_step(model, batch_size=batch, cache_len=cache_len)
    else:
        ss = build_serve_step(model, mesh,
                              data_axes=tuple(a for a in mesh.axis_names
                                              if a != "model"),
                              model_axis="model", batch_size=batch,
                              cache_len=cache_len)
    rs = np.random.RandomState(seed)
    inputs = {"tokens": torch.as_tensor(
        rs.randint(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32),
        device=dev)}
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        inputs["patch_emb"] = torch.as_tensor(
            0.1 * rs.randn(batch, cfg.n_patches, cfg.d_model),
            device=dev).to(dtype)
    if cfg.is_encoder_decoder:
        inputs["frames"] = torch.as_tensor(
            0.1 * rs.randn(batch, cfg.encoder_seq, cfg.d_model),
            device=dev).to(dtype)

    if mesh is not None:
        inputs = {k: ss.local_rows(v) for k, v in inputs.items()}
    t0 = time.perf_counter()
    logits, cache = ss.prefill_fn(inputs)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"prefill {batch}x{prompt_len}: {prefill_s:.2f}s")

    V = cfg.vocab_size
    tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
    out = [tok]
    t0 = time.perf_counter()
    for i in range(decode_tokens):
        logits, cache = ss.decode_fn(tok, cache, prompt_len + i)
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    log(f"decoded {decode_tokens} tokens in {dt:.2f}s "
        f"({decode_tokens * tok.shape[0] / dt:.1f} tok/s a rank)")
    toks = torch.cat(out, dim=1).cpu().numpy()
    log(f"sample: {toks[0][:16]}")
    return {"tokens": toks, "prefill_s": prefill_s, "decode_s": dt,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="data x model ranks; a model axis above 1 is "
                         "tensor parallelism")
    ap.add_argument("--world-size", type=int, default=1)
    args = ap.parse_args(argv)
    kwargs = dict(arch=args.arch, batch=args.batch,
                  prompt_len=args.prompt_len,
                  decode_tokens=args.decode_tokens, reduced=args.reduced,
                  n_layers=args.layers, device=args.device, seed=args.seed,
                  mesh=args.mesh, world_size=args.world_size)
    if args.world_size == 1:
        return serve(**kwargs)
    kwargs["init_method"] = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_pg_"), "rendezvous")
    torch.multiprocessing.spawn(_worker, args=(kwargs,),
                                nprocs=args.world_size)


def _worker(rank, kwargs):
    serve(rank=rank, **kwargs)


if __name__ == "__main__":
    main()
