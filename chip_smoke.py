#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which must pass (the script exits nonzero otherwise):

1. set-up: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and prints the compiler's register report and the card's name and
   power limit.  TF32 is off for convolutions and matrix products, so
   every phase runs in full fp32.
2. kernels: each Hopper kernel against its plain PyTorch twin at the
   block view of every full-width MobileNet leaf, a ragged row count, an
   unpacked row width and bf16; then times the kernel, the twin and a
   library call at the shapes of one MLLess step (the 83 leaf views).
3. train: the training entry point on full-width MobileNet, batch 96,
   MLLess, 30 steps on a one-rank NCCL group; the loss must fall and each
   kernel must launch 83 times a step.  One step through the kernels is
   held against the same step through the twins, a reduced model's logits
   against the same model on the CPU, and the other four strategies and
   ResNet-18 take a few steps each.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12     # fp32 outside the tensor cores
BLOCK = 256


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, reps=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def setup():
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build._build_all()
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{sorted(libs)}")
    for stem, path in sorted(libs.items()):
        report = path.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[setup] {stem}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def leaf_views(dev):
    """Block views of the full-width MobileNet leaves, as MLLess cuts
    them (random gradients of the leaves' sizes, seeded)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_cnn, reference_leaves
    model = build_cnn(get_config("mobilenet-cifar"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    views = []
    for p in reference_leaves(model):
        n = -(-p.numel() // BLOCK)
        scale = torch.rand((n, 1), generator=gen, device=dev) * 4
        views.append(torch.randn((n, BLOCK), generator=gen, device=dev)
                     * scale)
    return views


def kernel_parity(views, dev):
    """Each kernel against its twin; returns the largest errors."""
    import torch
    from repro_torch.kernels import block_significance as bs
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    extra = [torch.randn((1001, BLOCK), generator=gen, device=dev),
             torch.randn((37, 7), generator=gen, device=dev)]
    abs_err, rel_err, cases = 0.0, 0.0, 0
    for x in views + extra + [v.bfloat16() for v in extra]:
        got, want = bs.block_norms(x), ref.block_norms(x)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"block_norms shape/dtype {got.shape} {got.dtype}")
        diff = (got - want).abs()
        abs_err = max(abs_err, float(diff.max()))
        rel_err = max(rel_err, float((diff / want.abs().clamp_min(
            1e-30)).max()))
        mask = ref.block_significance(x, 0.5)
        kept, resid = bs.masked_filter(x, mask)
        k2, r2 = ref.masked_filter(x, mask)
        torch.cuda.synchronize()
        check(kept.dtype == x.dtype and torch.equal(kept, k2)
              and torch.equal(resid, r2),
              f"masked_filter differs from its twin at {tuple(x.shape)} "
              f"{x.dtype}")
        cases += 1
    # block_norms: fp32 fma sums in another order than the twin's
    check(rel_err <= 1e-5, f"block_norms relative error {rel_err:.3e} "
          "> 1e-5")
    log(f"[kernels] parity on {cases} shapes (83 MobileNet leaf views, "
        f"ragged n=1001, b=7, bf16): block_norms max rel err "
        f"{rel_err:.3e} (tol 1e-5), max abs err {abs_err:.3e}; "
        "masked_filter exact")
    return abs_err, rel_err


def graphed_ms(fn):
    """Device time of ``fn`` replayed as a CUDA graph: the launches
    without the host's per-call overhead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


def kernel_times(views):
    """Times one MLLess step's worth of each kernel (83 launches, one per
    leaf view) against the twin and a library call, with CUDA events;
    the same 83 launches as a CUDA graph; and, as CUDA graphs, one launch
    over all 12,582 rows at once, what a multi-tensor launch would take
    on the device."""
    import torch
    from repro_torch.kernels import block_significance as bs
    from repro_torch.kernels import ref
    masks = [ref.block_significance(v, 0.5) for v in views]
    rows, rows_mask = torch.cat(views), torch.cat(masks)
    n_el = sum(v.numel() for v in views)
    n_rows = sum(v.shape[0] for v in views)
    bytes_norms = 4 * n_el + 4 * n_rows
    bytes_filter = 4 * n_el + n_rows + 2 * 4 * n_el

    def loop(fn, *cols):
        return lambda: [fn(*a) for a in zip(*cols)]

    bound_norms = max(bytes_norms / H100_BYTES_PER_S,
                      2 * n_el / H100_FP32_FLOP_PER_S) * 1e3
    bound_filter = max(bytes_filter / H100_BYTES_PER_S,
                       2 * n_el / H100_FP32_FLOP_PER_S) * 1e3
    return {
        "block_norms": dict(
            ms=time_ms(loop(bs.block_norms, views)),
            plain_ms=time_ms(loop(ref.block_norms, views)),
            library_ms=time_ms(loop(lambda v: torch.linalg.vecdot(v, v,
                                                                  dim=1),
                                    views)),
            bound_ms=bound_norms, bound_by="bytes",
            bytes=bytes_norms,
            graph_ms=graphed_ms(loop(bs.block_norms, views)),
            one_launch_graph_ms=graphed_ms(lambda: bs.block_norms(rows)),
            one_launch_plain_graph_ms=graphed_ms(
                lambda: ref.block_norms(rows)),
            one_launch_library_graph_ms=graphed_ms(
                lambda: torch.linalg.vecdot(rows, rows, dim=1))),
        "masked_filter": dict(
            ms=time_ms(loop(bs.masked_filter, views, masks)),
            plain_ms=time_ms(loop(ref.masked_filter, views, masks)),
            library_ms=None, bound_ms=bound_filter, bound_by="bytes",
            bytes=bytes_filter,
            graph_ms=graphed_ms(loop(bs.masked_filter, views, masks)),
            one_launch_graph_ms=graphed_ms(
                lambda: bs.masked_filter(rows, rows_mask)),
            one_launch_plain_graph_ms=graphed_ms(
                lambda: ref.masked_filter(rows, rows_mask)),
            one_launch_library_graph_ms=None),
    }


def train_phase(init_method):
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import block_significance as bs
    from repro_torch.launch.train import train

    dist.init_process_group("nccl", init_method=init_method, rank=0,
                            world_size=1)
    try:
        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        steps = 30
        res = train(arch="mobilenet-cifar", strategy="mlless", steps=steps,
                    batch=96, lr=0.01, device="cuda", log_every=10,
                    log=log)
        launches = dict(bs.LAUNCHES)
        losses = res["losses"]
        check(all(math.isfinite(l) for l in losses), f"loss not finite: "
              f"{losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last < first, f"loss did not fall: first five {first:.4f}, "
              f"last five {last:.4f}")
        for k, n in launches.items():
            check(n == 83 * steps, f"{k} launched {n} times in {steps} "
                  f"steps, expected {83 * steps}")
        log(f"[train] mobilenet-cifar full width, batch 96, mlless, "
            f"{steps} steps: loss {first:.4f} (first five) -> {last:.4f} "
            f"(last five); launches {launches} = 83/step; "
            f"{res['ms_per_step']:.3f} ms/step after the first "
            f"({res['first_step_ms']:.1f} ms); peak memory "
            f"{res['peak_mem_bytes'] / 2**20:.1f} MiB; "
            f"significant_fraction {res['metrics']['significant_fraction']:.4f}")
        kernels_vs_twins()
        cuda_vs_cpu()
        profile_step("mlless")
        profile_step("allreduce")
        for strategy in ("allreduce", "parameter_server", "scatterreduce",
                         "spirt"):
            other = train(arch="mobilenet-cifar", strategy=strategy,
                          steps=4, batch=96, lr=0.01, device="cuda",
                          log=None)
            check(all(map(math.isfinite, other["losses"])),
                  f"{strategy}: loss not finite")
            log(f"[train] mobilenet-cifar {strategy}: losses "
                f"{[round(l, 4) for l in other['losses']]}, "
                f"{other['ms_per_step']:.3f} ms/step")
        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        for strategy in ("mlless", "allreduce"):
            rn = train(arch="resnet18-cifar", strategy=strategy, steps=4,
                       batch=96, lr=0.01, device="cuda", log=None)
            check(all(map(math.isfinite, rn["losses"])),
                  f"resnet18 {strategy}: loss not finite")
            log(f"[train] resnet18-cifar {strategy}: params {rn['params']:,}"
                f", losses {[round(l, 4) for l in rn['losses']]}, "
                f"{rn['ms_per_step']:.3f} ms/step, peak memory "
                f"{rn['peak_mem_bytes'] / 2**20:.1f} MiB")
        check(all(n == 62 * 4 for n in bs.LAUNCHES.values()),
              f"resnet18 mlless launches {bs.LAUNCHES}, expected 62/step")
        return launches
    finally:
        dist.destroy_process_group()


def kernels_vs_twins():
    """Two MLLess steps of full-width MobileNet through the kernels and
    through the plain twins, from the same weights and batches, with
    deterministic cuDNN.  Masks come from fp32 norms that agree to 1e-5,
    so a block on the threshold could flip: losses must agree to 1e-5 and
    parameters to 1e-5."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import cifar_like
    from repro_torch.models import build_cnn

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    imgs, labels = cifar_like(192, seed=7)
    batches = [{"images": torch.from_numpy(imgs[i:i + 96]).cuda(),
                "labels": torch.from_numpy(labels[i:i + 96]).cuda()}
               for i in (0, 96)]
    base = build_cnn(get_config("mobilenet-cifar"), device="cuda", seed=3)
    runs = {}
    for use_kernel in (True, False):
        model = copy.deepcopy(base)
        ts = build_train_step(model, optim.sgd(0.01, momentum=0.9),
                              get_strategy("mlless", use_kernel=use_kernel))
        state = ts.init_state()
        losses = [float(ts.step_fn(state, b)[1]["loss"]) for b in batches]
        runs[use_kernel] = (losses, [p.detach() for p in state["params"]])
    torch.backends.cudnn.deterministic = False
    (lk, pk), (lp, pp) = runs[True], runs[False]
    dloss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    dparam = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    check(dloss <= 1e-5 and dparam <= 1e-5,
          f"kernel step vs twin step: loss rel diff {dloss:.3e}, param "
          f"max abs diff {dparam:.3e}")
    log(f"[train] 2 MLLess steps through the kernels vs the twins: losses "
        f"{lk} vs {lp} (rel diff {dloss:.3e}, tol 1e-5), params max abs "
        f"diff {dparam:.3e} (tol 1e-5)")


def profile_step(strategy, steps=5):
    """Where a step's time goes: ``torch.profiler`` over a few steps of
    full-width MobileNet at batch 96 (after warm-up), device time by
    kernel against the host clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import cifar_like
    from repro_torch.models import build_cnn

    imgs, labels = cifar_like(96, seed=9)
    batch = {"images": torch.from_numpy(imgs).cuda(),
             "labels": torch.from_numpy(labels).cuda()}
    model = build_cnn(get_config("mobilenet-cifar"), device="cuda")
    ts = build_train_step(model, optim.sgd(0.01, momentum=0.9),
                          get_strategy(strategy))
    state = ts.init_state()
    for _ in range(3):
        ts.step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ts.step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return
    log(f"[profile] {strategy} step under the profiler: {wall_ms:.3f} "
        f"ms/step on the host clock, device busy {busy_ms:.3f} ms/step, "
        f"idle share "
        f"{1 - busy_ms / wall_ms:.3f}; device kernels launched per step "
        f"{sum(e.count for e in kernels) / steps:.0f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms"
            f"/step {e.count / steps:6.0f}/step  {e.key[:90]}")
    if strategy != "mlless":
        return
    for name in ("block_norms_kernel", "masked_filter_kernel"):
        mine = [e for e in kernels if name in e.key]
        us = sum(e.self_device_time_total for e in mine) / steps
        n = sum(e.count for e in mine) / steps
        log(f"[profile]   {name}: {us:.1f} us/step of device time in "
            f"{n:.0f} launches ({us / max(n, 1):.2f} us each)")


def cuda_vs_cpu():
    """Reduced MobileNet logits on the card against the port on the CPU,
    same weights and images: fp32 with TF32 off, different conv
    algorithms, so 1e-4."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import cifar_like
    from repro_torch.models import build_cnn
    cfg = get_config("mobilenet-cifar").reduced()
    imgs, _ = cifar_like(8, seed=5)
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        gpu = build_cnn(cfg, device="cuda", seed=1)(x.cuda()).cpu()
        cpu = build_cnn(cfg, device="cpu", seed=1)(x)
    check(gpu.shape == (8, 10) and torch.isfinite(gpu).all(),
          f"logits {tuple(gpu.shape)} not finite")
    err = float((gpu - cpu).abs().max())
    check(err <= 1e-4, f"cuda vs cpu logits differ by {err:.3e}")
    log(f"[train] reduced MobileNet logits, card vs CPU: max abs diff "
        f"{err:.3e} (tol 1e-4)")


def main():
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the repository: src/repro_torch is "
              "missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    setup()
    dev = torch.device("cuda", 0)
    views = leaf_views(dev)
    check(len(views) == 83 and sum(v.shape[0] for v in views) == 12582,
          "MobileNet leaf views")
    norm_abs, norm_rel = kernel_parity(views, dev)
    times = kernel_times(views)
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                                    "pg")
    launches = train_phase(init)
    src = "src/repro_torch/kernels/csrc/block_significance.cu"
    line = {"kernels": [
        {"name": "block_norms", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_significance.py:24",
         "launches": launches["block_norms"], "max_abs_err": norm_abs,
         "max_rel_err": norm_rel,
         **times["block_norms"],
         "shapes": "one MLLess step: 83 views (n_i, 256) fp32, 12582 rows",
         "library": "torch.linalg.vecdot(x, x, dim=1)"},
        {"name": "masked_filter", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_significance.py:55",
         "launches": launches["masked_filter"], "max_abs_err": 0.0,
         **times["masked_filter"],
         "shapes": "one MLLess step: 83 views (n_i, 256) fp32, 12582 rows",
         "library": None},
    ]}
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
