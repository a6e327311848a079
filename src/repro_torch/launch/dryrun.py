"""Dry-run of every (architecture x input shape) on the production meshes
(``repro.launch.dryrun``), for the H100.

The reference lowers and compiles each step for 256 or 512 placeholder
host devices and reads the compiler's memory analysis and collectives.
The port runs the step itself, once, as rank 0 of a fake process group of
``chips`` ranks (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once) on a full-width model on the ``meta`` device,
so nothing is allocated and nothing is computed, only shapes:

  * the model, the optimizer state and the batch are this rank's shards,
    from the sharding rules (``core.sharding``): ``memory.argument_bytes``
    is their exact size (the reference layout: parameters, both AdamW
    moments, the strategy's per-rank state, two int32 steps, the batch
    shard; for serving, the parameters and the step's inputs, and for a
    decode step only the parameters it reads, ``ReadStorages``, as the
    reference's compiler drops the arguments a step never reads);
  * a dispatch mode sums the live bytes of every storage the step
    creates: ``temp_bytes`` is its peak less the outputs the step returns
    (``output_bytes``; the port updates the state in place, so a train
    step's outputs are its metrics);
  * ``costmodel.collectives.record_collectives`` records every collective
    the step issues: the reference's ``CollectiveStats`` per rank;
  * ``costmodel.flops`` gives the analytic FLOPs and ``costmodel.roofline``
    the three H100 roofline terms.

Kernel 8 runs as a shape-only stand-in on ``meta`` tensors (its output;
its tiles live on chip), the rest of the step as the plain PyTorch path.
Profiles, as the reference's: ``baseline`` (the default: tensor
parallelism over the 16-way model axis, ``models.tp``, for every
family, the strategies over the data axes, FSDP where ``FSDP_REQUIRED``
says), ``dp`` (every mesh axis data-parallel, no tensor parallelism)
and ``zero3`` (the same, with FSDP).  ``cost_analysis_raw`` has no
analogue (None);
``trace_s`` takes the place of ``lower_s`` and ``compile_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
      --profile zero3
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
      --fsdp
  python -m repro_torch.launch.dryrun --all --both-meshes
Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__<tag>].json``
(no tag for ``baseline``, the profile's name for ``dp`` and ``zero3``, as
the reference names them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import optim
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.core import build_serve_step, build_train_step, get_strategy
from repro_torch.costmodel import flops as flopslib
from repro_torch.costmodel.collectives import (record_collectives, stats,
                                               tree_bytes)
from repro_torch.core import sharding
from repro_torch.costmodel.roofline import HW, roofline
from repro_torch.launch.mesh import data_axes_of, make_production_mesh
from repro_torch.models.transformer import Model

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

TRANSFORMER_ARCHS = [
    "mixtral-8x22b", "gemma3-4b", "mixtral-8x7b", "rwkv6-7b", "pixtral-12b",
    "smollm-135m", "whisper-small", "phi3-mini-3.8b", "recurrentgemma-2b",
    "qwen1.5-4b",
]
MODEL_AXIS = 16     # the production meshes' "model" axis


def fsdp_required(arch: str, hbm_bytes: float = HW.hbm_bytes) -> bool:
    """The reference's rule: the parameters at 2 B and the AdamW moments
    at 8 B a parameter, sharded over the 16-way model axis alone, exceed
    one card's HBM."""
    n = flopslib.param_count(get_config(arch))
    return (2 * n + 8 * n) / MODEL_AXIS > hbm_bytes


# recomputed for 80 GB cards, not copied from the reference's 16 GB set
FSDP_REQUIRED = frozenset(a for a in TRANSFORMER_ARCHS if fsdp_required(a))


class LiveBytes(TorchDispatchMode):
    """Sums the bytes of the storages the ops create while it is on (each
    storage once; a view or an in-place result, whose storage is an
    input's, is no new storage) and keeps the peak of that sum; a storage
    leaves the sum when it is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._keys = set()

    def _free(self, key, n):
        self._keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage()._cdata
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._keys or key in inputs:
                continue
            n = st.nbytes()
            self._keys.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


class ReadStorages(TorchDispatchMode):
    """Records the storages that the ops other than views take as inputs
    while it is on: a parameter a step reads is among them, one it only
    slices (a layer of a stacked leaf) is not."""

    def __init__(self):
        super().__init__()
        self.keys = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.keys.update(t.untyped_storage()._cdata
                             for t in tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor))
        return func(*args, **(kwargs or {}))


class _ShapeOnlyAttention(torch.autograd.Function):
    """Kernel 8 on ``meta`` tensors: its output (and, backward, the
    gradients' shapes), nothing else."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def shape_only_attention(q, k, v, *, window=None, causal=True):
    del window, causal
    return _ShapeOnlyAttention.apply(q, k, v)


@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as rank 0 of ``world_size`` ranks whose
    collectives do nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a default "
                           "process group (it makes a fake one)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _extras(cfg, B, meta):
    dtype = getattr(torch, cfg.dtype)
    out = {}
    if cfg.family == "vlm":
        out["patch_emb"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                       dtype=dtype, device=meta)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=dtype, device=meta)
    return out


def _train(model, cfg, shp, mesh, data_axes, model_axis, strategy, fsdp,
           rs_dtype):
    W = 1
    for a in data_axes:
        W *= mesh.shape[a]
    if shp.global_batch % W:
        raise ValueError(f"global batch {shp.global_batch} does not divide "
                         f"over the {W} ranks of {data_axes}")
    strat = get_strategy(strategy)
    if hasattr(strat, "use_kernel"):     # the plain twins on meta tensors
        strat = dataclasses.replace(strat, use_kernel=False)
    ts = build_train_step(model, optim.adamw(3e-4), strat, mesh,
                          data_axes=data_axes, model_axis=model_axis,
                          fsdp=fsdp, fsdp_rs_dtype=rs_dtype)
    state = ts.init_state()
    meta = torch.device("meta")
    B = shp.global_batch // W
    batch = {k: torch.empty((B, shp.seq_len), dtype=torch.int32,
                            device=meta) for k in ("tokens", "labels")}
    batch.update(_extras(cfg, B, meta))
    # the reference's state: parameters, m, v, the strategy's row and the
    # two int32 steps (optimizer and train step)
    args = tree_bytes([state["params"], state["opt"]["m"],
                       state["opt"]["v"], list(state["strat"])]) + 8 + \
        tree_bytes(batch)

    def run():
        _, metrics = ts.step_fn(state, batch)
        return metrics
    return lambda: args, run


def _serve(model, cfg, shp, mesh, data_axes, model_axis, swa_variant):
    ss = build_serve_step(model, mesh, data_axes=data_axes,
                          model_axis=model_axis,
                          batch_size=shp.global_batch, cache_len=shp.seq_len,
                          swa_variant=swa_variant)
    if shp.kind == "prefill":
        batch = ss.make_inputs("prefill", shp.seq_len)
        batch.update(_extras(cfg, batch["tokens"].shape[0],
                             torch.device("meta")))
        args = tree_bytes(list(model.parameters())) + tree_bytes(batch)
        return lambda: args, lambda: ss.prefill_fn(batch)
    token, cache, pos = ss.make_inputs("decode", shp.seq_len)
    reads = ReadStorages()

    def run():
        with reads:
            logits, _ = ss.decode_fn(token, cache, pos)
        return logits           # the cache is written in place

    def args():
        # the parameters the step read, as the reference's compiled decode
        # drops the arguments it never reads (an encoder-decoder's encoder
        # and its cross-attention's k and v weights: ``enc_kv`` is cached)
        read = [p for p in model.parameters()
                if p.untyped_storage()._cdata in reads.keys]
        return tree_bytes(read) + tree_bytes([token, cache, pos])
    return args, run


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               strategy: str = "allreduce", fsdp=None,
               profile: str = "baseline", tag: str = "", save: bool = True,
               fsdp_rs_dtype="float32", remat: bool = True,
               kv_quant: bool = False, mesh=None, config=None,
               input_shape=None) -> dict:
    """One dry-run; the result has the reference's keys.  ``profile``:
    ``baseline`` (tensor parallelism over the mesh's ``model`` axis, the
    strategies over its data axes; ``fsdp`` None follows ``FSDP_REQUIRED``,
    as in the reference), ``dp`` (pure data parallelism
    over every mesh axis) or ``zero3`` (the same, parameters and optimizer
    state sharded too; ``fsdp`` follows the profile, as in the
    reference).  For small cases (tests), ``mesh`` replaces the production
    mesh, ``config`` the arch's config and ``input_shape`` (an
    ``InputShape``) the named shape."""
    if profile not in ("baseline", "dp", "zero3"):
        raise ValueError(f"profile {profile!r}: baseline, dp or zero3")
    cfg = config or get_config(arch)
    shp = input_shape or INPUT_SHAPES[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if shp.name == "long_500k" and cfg.long_context == "skip":
        res = {"arch": arch, "shape": shape_name, "skipped":
               "long_500k skipped for this arch (DESIGN.md §3)"}
        if save:
            _save(res, arch, shape_name, mesh_tag, tag)
        return res
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh_tag = "x".join(str(n) for n in mesh.shape.values())
    chips = mesh.size
    if profile == "baseline":
        data_axes, model_axis = data_axes_of(mesh), "model"
        sharding.require_tp_family(cfg, mesh, model_axis)
        if fsdp is None:
            fsdp = arch in FSDP_REQUIRED
    else:
        data_axes, model_axis = tuple(mesh.axis_names), None
        fsdp = profile == "zero3"
    swa_variant = shp.name == "long_500k" and cfg.long_context == "swa"

    with fake_group(chips):
        model = Model(cfg, remat=remat, kv_quant=kv_quant, device="meta")
        model.attention_fn = shape_only_attention
        t0 = time.perf_counter()  # repro: allow[no-wallclock] -- trace time is a reported dry-run field
        if shp.kind == "train":
            args, run = _train(model, cfg, shp, mesh, data_axes,
                               model_axis, strategy, fsdp,
                               getattr(torch, fsdp_rs_dtype))
        else:
            args, run = _serve(model, cfg, shp, mesh, data_axes,
                               model_axis, swa_variant)
        with record_collectives() as records, LiveBytes() as live:
            out = run()
            out_bytes = tree_bytes(out)
        args = args()   # after the run: a decode step counts what it read
        trace_s = time.perf_counter() - t0  # repro: allow[no-wallclock] -- trace time is a reported dry-run field
    coll = stats(records)
    temp = max(live.peak - out_bytes, 0)

    if shp.kind == "train":
        flops_g = flopslib.train_step_flops(cfg, shp.global_batch,
                                            shp.seq_len)
        tokens = shp.global_batch * shp.seq_len
    elif shp.kind == "prefill":
        flops_g = flopslib.forward_flops(cfg, shp.global_batch, shp.seq_len,
                                         "prefill")
        tokens = shp.global_batch * shp.seq_len
    else:
        flops_g = flopslib.forward_flops(cfg, shp.global_batch, shp.seq_len,
                                         "decode")
        tokens = shp.global_batch
    nd = flopslib.active_param_count(cfg) * tokens
    model_flops = 6.0 * nd if shp.kind == "train" else 2.0 * nd
    hbm_per_dev = args + out_bytes + 2 * temp
    rf = roofline(flops_g, hbm_per_dev, coll.wire_bytes, chips, model_flops)

    if profile != "baseline" and not tag:
        tag = profile
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "chips": chips, "strategy": strategy if shp.kind == "train" else None,
        "fsdp": fsdp, "swa_variant": swa_variant, "profile": profile,
        "kv_quant": kv_quant, "trace_s": trace_s,
        "memory": {
            "argument_bytes": args, "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_estimate_gb": (args + out_bytes + temp) / 2**30,
        },
        "cost_analysis_raw": None,
        "collectives": {
            "counts": coll.counts,
            "bytes_by_kind": coll.bytes_by_kind,
            "total_bytes_per_device": coll.total_bytes,
            "wire_bytes_per_device": coll.wire_bytes,
            "unresolved_loops": coll.unresolved_loops,
        },
        "analytic": {
            "flops_global": flops_g,
            "model_flops_6nd": model_flops,
            "params": flopslib.param_count(cfg),
            "active_params": flopslib.active_param_count(cfg),
        },
        "roofline": rf.as_dict(),
        "hardware": HW.name,
        "fsdp_required": arch in FSDP_REQUIRED,
    }
    if save:
        _save(res, arch, shape_name, mesh_tag, tag)
    return res


def _save(res, arch, shape_name, mesh_tag, tag):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_tag}"
    if tag:
        name += f"__{tag}"
    with open(RESULTS_DIR / f"{name}.json", "w") as f:
        json.dump(res, f, indent=2, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="allreduce")
    ap.add_argument("--fsdp", action="store_true", default=None,
                    help="shard parameters and optimizer state over the "
                         "data axes too (baseline; absent: FSDP_REQUIRED "
                         "decides)")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "dp", "zero3"],
                    help="baseline (the default, the reference's): TP over "
                         "the model axis; dp; zero3")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None,
                    help="also write the list of results here")
    args = ap.parse_args(argv)

    archs = TRANSFORMER_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures, results = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    r = dryrun_one(arch, shape, multi_pod=mp,
                                   strategy=args.strategy, fsdp=args.fsdp,
                                   profile=args.profile, tag=args.tag)
                    results.append(r)
                    if "skipped" in r:
                        print(f"[skip] {label}: {r['skipped']}")
                        continue
                    rf = r["roofline"]
                    print(f"[ok]   {label}: trace {r['trace_s']:.1f}s "
                          f"mem {r['memory']['peak_estimate_gb']:.2f}GB "
                          f"dominant={rf['dominant']} "
                          f"t*={rf['step_time_lower_bound_s']:.4f}s",
                          flush=True)
                except Exception as e:
                    failures.append((label, repr(e)))
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "error": repr(e)})
                    print(f"[FAIL] {label}: {e}", flush=True)
                    traceback.print_exc()
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(results, default=float))
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print(f"\nAll dry-runs traced (FSDP required on {HW.name}: "
          f"{sorted(FSDP_REQUIRED)}).")


if __name__ == "__main__":
    main()
