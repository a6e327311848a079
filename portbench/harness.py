"""One run of one cell: set-up, the measured window or the traced one,
and the comparison that decides ``correct``.

The cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``), and its limits are ``limits/<cell>.json``.
Every rank of the cell runs ``run_rank``.  It builds what
``repro_torch.launch.train`` builds (``build_model(cfg, use_kernel=True)``,
``adamw(lr, use_fused=True)``, ``build_train_step(model, opt,
get_strategy(name))``), loads the weights the benchmark draws from the
seed, and drives ``step_fn`` on a ring of batches kept on the device.

Set-up ends with the steps the check reads: the first three steps'
losses, each leaf's gradient as the optimizer got it (from AdamW's
first moment after one step) and each leaf's change after three.  The
same train step then warms up and goes into the window.  Once the window
has closed and the program's state is freed, rank 0 runs the plain fp32
reference (``reference/<family>.py``) through the same three steps on
the same weights and batches, and ``compare`` holds the readings to the
cell's limits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from portbench import tokens as tok
from portbench.reference import common
from portbench.trace import WINDOW, Trace, device_busy_s

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_SYNC = "portbench/sync"
SPAN_UPDATE = "portbench/update"
RING = 8                    # global batches kept on the device, cycled
CHECK_STEPS = 3             # steps the comparison reads
WARMUP_STEPS = 2            # steps between those and the window


# ---------------------------------------------------------------------------
# the cell, from its files
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict                   # configs/<config>.json
    mix: dict                   # mixes/<traffic>.json
    limits: dict                # limits/<cell>.json
    end_to_end: list            # the cell's end-to-end metric entries
    per_layer: list             # the cell's per-layer metric entries

    @property
    def world(self) -> int:
        return self.mix["world_size"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files under
    ``root/portbench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    here = root / "portbench"
    cfg = json.loads((here / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((here / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    if mix["world_size"] != w["chips"]:
        raise ValueError(f"{name}: the mix runs {mix['world_size']} ranks "
                         f"on {w['chips']} chips")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", (name,))]
    names = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells is read wherever the
    # end-to-end metric it moves is
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or "workloads" not in m and m["moves"] in names]
    return Cell(name, w["chips"], cfg, mix, limits, e2e, per_layer)


def reference_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["layer_pattern"] = tuple(kw["layer_pattern"])
    return ModelConfig(**kw)


def global_batches(cfg: dict, mix: dict, seed: int) -> list:
    """The ring of ``RING`` global batches (numpy, rows all different)
    drawn from the seed."""
    W, B, S = mix["world_size"], mix["batch"], mix["seq"]
    rows = RING * W * B
    s = tok.seed32(seed)
    stream = tok.token_stream(rows * S + 1, cfg["vocab_size"], seed=s)
    it = tok.lm_batches(stream, W * B, S, seed=s)
    return [next(it) for _ in range(RING)]


def shard(batch: dict, rank: int, B: int) -> dict:
    return {k: v[rank * B:(rank + 1) * B] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------
class _SpannedStrategy:
    """The strategy, its sync under the span ``SPAN_SYNC``."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def sync(self, *a, **kw):
        with torch.profiler.record_function(SPAN_SYNC):
            return self._inner.sync(*a, **kw)


def _spanned_optimizer(opt):
    from repro_torch.optim.optimizers import Optimizer

    def update(*a, **kw):
        with torch.profiler.record_function(SPAN_UPDATE):
            return opt.update(*a, **kw)
    return Optimizer(opt.init, update)


@dataclasses.dataclass
class Program:
    model: object
    ts: object
    state: dict
    names: list                 # leaf names in state["params"] order
    ring: list                  # this rank's shards on the device


def build_program(cell: Cell, seed: int, dev, rank: int, spans=False,
                  model=None) -> Program:
    """The model with the seed's weights, the optimizer and the train
    step, and this rank's ring of batches on ``dev``.  ``model``: one
    built before, whose weights are replaced."""
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.models import build_model
    cfg, mix = cell.cfg, cell.mix
    ref = reference_module(cfg)
    if model is None:
        model = build_model(model_config(cfg), use_kernel=True, device=dev,
                            seed=seed)
    specs = ref.leaf_specs(cfg)
    have = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for n, t in model.state_dict().items()}
    want = {n: (tuple(s), dt) for n, (s, dt, _) in specs.items()}
    if have != want:
        raise ValueError(f"{cfg['name']}: the program's leaves "
                         f"{sorted(set(have) ^ set(want)) or have} differ "
                         "from the reference's")
    state = common.draw_state(specs, seed, dev)
    model.load_state_dict(state)
    del state
    a = mix["adamw"]
    opt = optim.adamw(mix["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
                      weight_decay=a["weight_decay"], use_fused=True)
    strategy = get_strategy(mix["strategy"])
    if spans:
        opt, strategy = _spanned_optimizer(opt), _SpannedStrategy(strategy)
    ts = build_train_step(model, opt, strategy)
    st = ts.init_state()
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id[id(p)] for p in st["params"]]
    ring = [{k: torch.from_numpy(v).to(dev) for k, v in
             shard(b, rank, mix["batch"]).items()}
            for b in global_batches(cfg, mix, seed)]
    return Program(model, ts, st, names, ring)


def _step(prog: Program, i: int) -> dict:
    """Step ``i`` of the run, on the ring's batch ``i``; its metrics."""
    prog.state, metrics = prog.ts.step_fn(prog.state,
                                          prog.ring[i % len(prog.ring)])
    return metrics


def check_steps(prog: Program, b1: float, n: int = CHECK_STEPS) -> dict:
    """Runs the first ``n`` steps on the ring's first ``n`` batches and
    returns the program's readings: each step's loss, each leaf's
    gradient norm at step 1 (AdamW's first moment over ``1 - b1``) and
    each leaf's change after step ``n``."""
    params = prog.state["params"]
    start = [p.detach().clone() for p in params]
    losses, grads = [], None
    for i in range(n):
        losses.append(_step(prog, i)["loss"])
        if i == 0:
            grads = [torch.linalg.vector_norm(m) / (1 - b1)
                     for m in prog.state["opt"]["m"]]
    change = [torch.linalg.vector_norm(p.detach().float() - s.float())
              for p, s in zip(params, start)]
    del start
    return {"losses": [float(x) for x in losses],
            "grad_norms": dict(zip(prog.names, map(float, grads))),
            "change": dict(zip(prog.names, map(float, change)))}


def reference_readings(cell: Cell, seed: int, dev, precision="fp32",
                       steps=CHECK_STEPS) -> dict:
    """The plain reference's readings over the first ``steps`` global
    batches, every rank's shard, from the seed's weights, in
    ``precision`` (``fp32``; ``fp8`` is the control), and the dtype
    the configuration stores each leaf in."""
    cfg, mix = cell.cfg, cell.mix
    ref = reference_module(cfg)
    common.set_fp32_math()
    cast = common.PRECISIONS[precision]
    specs = ref.leaf_specs(cfg)
    params = {n: t.float() for n, t in
              common.draw_state(specs, seed, dev).items()}
    batches = global_batches(cfg, mix, seed)[:steps]
    W, B = mix["world_size"], mix["batch"]
    shards = [[{k: torch.from_numpy(v).to(dev)
                for k, v in shard(b, r, B).items()} for r in range(W)]
              for b in batches]
    a = mix["adamw"]
    out = common.train_readings(
        lambda p, batch: ref.loss(p, batch, cfg, cast), params, shards,
        lr=mix["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
        wd=a["weight_decay"])
    out["dtypes"] = {n: dt for n, (_, dt, _) in specs.items()}
    return out


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------
def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each step's relative loss gap (``loss``), and each leaf's gap of
    gradient norms and of change norms over the larger of the reference
    leaf's norm and the median leaf's (``grad``, ``update``) and over the
    reference leaf's own norm (``grad_own``, ``update_own``).  A leaf
    whose reference gradient is under a thousandth of the median leaf's
    moves by round-off alone and is left out of all but ``grad``."""
    loss = [abs(a - b) / abs(b) for a, b in
            zip(prog["losses"], ref["losses"])]
    g_ref, c_ref = ref["grad_norms"], ref["change"]
    g_med = float(np.median(list(g_ref.values())))
    grad = {n: abs(prog["grad_norms"][n] - g) / max(g, g_med)
            for n, g in g_ref.items()}
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = float(np.median([c_ref[n] for n in moved]))
    update = {n: abs(prog["change"][n] - c_ref[n]) / max(c_ref[n], c_med)
              for n in moved}
    grad_own = {n: abs(prog["grad_norms"][n] - g_ref[n]) / g_ref[n]
                for n in moved}
    update_own = {n: abs(prog["change"][n] - c_ref[n]) / c_ref[n]
                  for n in moved}
    return {"loss": loss, "grad": grad, "update": update,
            "grad_own": grad_own, "update_own": update_own}


def _worst(values) -> float:
    # a leaf that is not finite is the worst whatever the others read
    values = list(values)
    return max(values, default=0.0) if all(map(math.isfinite, values)) \
        else float("inf")


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared.  ``loss_gap``: the largest relative gap of a
    step's loss.  ``grad_gap`` and ``update_gap``: over leaves, the
    largest gap between the program's norm and the reference's (of the
    step-1 gradient; of the change after the last step), over the
    larger of the reference leaf's norm and the median leaf's;
    ``grad_gap_median``: the median leaf's gradient gap.  The same over
    the reference leaf's own norm, which a small leaf cannot hide under
    the median's: ``grad_gap_own`` over every leaf,
    ``update_gap_own_fp32`` over the leaves stored in float32 and
    ``update_gap_own_bf16`` over the others (bf16 in these
    configurations), whose parameters round each step.  Leaves the
    reference moves by round-off alone are left out (``leaf_gaps``)."""
    g = leaf_gaps(prog, ref)
    grads = list(g["grad"].values())
    fp32 = {n for n, dt in ref["dtypes"].items() if dt == "float32"}
    own = g["update_own"]
    return {"loss_gap": _worst(g["loss"]), "grad_gap": _worst(grads),
            "grad_gap_median": float(np.median(grads))
            if all(map(math.isfinite, grads)) else float("inf"),
            "update_gap": _worst(g["update"].values()),
            "grad_gap_own": _worst(g["grad_own"].values()),
            "update_gap_own_bf16": _worst(v for n, v in own.items()
                                          if n not in fp32),
            "update_gap_own_fp32": _worst(v for n, v in own.items()
                                          if n in fp32)}


def compare(prog: dict, ref: dict, limits: dict):
    """(correct, {name: {"value", "limit"}})."""
    g = gaps(prog, ref)
    checks = {k: {"value": g[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


# ---------------------------------------------------------------------------
# one rank's run
# ---------------------------------------------------------------------------
def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def _window(prog: Program, seconds: float, dev, group, k0: int):
    """Closed loop for ``seconds``: steps issued back to back, rank 0's
    host clock deciding for every rank when the last is issued.  Returns
    (steps, wall seconds, step times in seconds, losses)."""
    cuda = dev.type == "cuda"
    marks, losses = [], []
    flag = torch.ones(1, dtype=torch.int32)
    _sync(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    i = k0
    while True:
        if dist.get_rank() == 0:
            flag[0] = int(time.perf_counter() - t0 < seconds)
        dist.broadcast(flag, 0, group=group)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        if not flag[0]:
            break
        losses.append(_step(prog, i)["loss"])
        i += 1
    _sync(dev)
    wall = time.perf_counter() - t0
    if cuda:
        times = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        times = [b - a for a, b in zip(marks, marks[1:])]
    return i - k0, wall, times, losses


def p90(values) -> float:
    """The 90th percentile by nearest rank."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def _timed_steps(prog: Program, steps: int, dev, k0: int) -> float:
    """Host seconds of ``steps`` steps from step ``k0``, from a
    synchronise to a synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(k0, k0 + steps):
        _step(prog, i)
    _sync(dev)
    return time.perf_counter() - t0


def _profiled(prog: Program, steps: int, dev, k0: int, path: str,
              activities: list):
    """One step that starts the profiler, then ``steps`` steps under it
    (inside the span ``WINDOW``); the trace goes to ``path``.  Returns
    the host seconds of those steps."""
    from torch.profiler import profile, schedule
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        _step(prog, k0)
        _sync(dev)
        prof.step()
        with torch.profiler.record_function(WINDOW):
            window = _timed_steps(prog, steps, dev, k0 + 1)
        prof.step()
    return window


def _device_pass(prog: Program, steps: int, dev, k0: int, tmpdir: str):
    """``steps`` steps under a profiler that records the device's work
    alone: the host issues them at its untraced pace.  Returns (busy,
    window) seconds: the union of the device's intervals, and the
    steps' host time between two synchronises.  The device's intervals
    are those of the profiler's active window, which holds these steps
    and nothing else."""
    from torch.profiler import ProfilerActivity
    if dev.type != "cuda":
        return 0.0, _timed_steps(prog, steps, dev, k0 + 1)
    path = os.path.join(tmpdir, f"device-{dist.get_rank()}.json")
    window = _profiled(prog, steps, dev, k0, path, [ProfilerActivity.CUDA])
    return device_busy_s(path), window


def _traced(prog: Program, steps: int, dev, k0: int, tmpdir: str):
    """``steps`` steps under the profiler, host calls and the device's
    work, after one step that starts it; returns their trace."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(tmpdir, f"trace-{dist.get_rank()}.json")
    _profiled(prog, steps, dev, k0, path, acts)
    return Trace.load(path)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, init_method: str) -> dict:
    """Runs every rank of the cell and returns rank 0's result."""
    return run_ranks(run_rank, cell.world, (cell, seed, seconds, trace,
                                            device, t_start, init_method))


def run_ranks(fn, world: int, args: tuple):
    """``fn(rank, *args, queue)`` on every rank: in this process for one
    rank, else in spawned processes, one a card; returns what rank 0
    puts on the queue (one rank: what ``fn`` returns)."""
    if world == 1:
        return fn(0, *args)
    import torch.multiprocessing as mp
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(fn, args=(*args, queue), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join():
        pass
    return queue.get()


@contextlib.contextmanager
def process_group(rank: int, world: int, device: str, init_method: str):
    """This rank's device, with the default group (NCCL on cards, gloo
    on the CPU) and a gloo group for host-side flags; destroyed on
    exit."""
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        host = dist.new_group(backend="gloo")
        yield dev, host
        dist.barrier(group=host)
    finally:
        dist.destroy_process_group()


def run_rank(rank: int, cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, init_method: str,
             result_queue=None):
    """One rank of a run.  Rank 0 returns the result (and puts it on
    ``result_queue`` when given); the others return None."""
    with process_group(rank, cell.world, device, init_method) as (dev,
                                                                   host):
        out = _run(rank, cell, seed, seconds, trace, dev, t_start, host)
    if rank == 0 and result_queue is not None:
        result_queue.put(out)
    return out


def _run(rank, cell, seed, seconds, trace, dev, t_start, host):
    mix = cell.mix
    W, cuda = cell.world, dev.type == "cuda"
    marks = [time.time()]
    prog = build_program(cell, seed, dev, rank, spans=trace)
    marks.append(time.time())
    mine = check_steps(prog, mix["adamw"]["b1"])
    marks.append(time.time())
    k = CHECK_STEPS + WARMUP_STEPS
    for i in range(CHECK_STEPS, k):
        _step(prog, i)
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    if rank == 0:
        print(f"[setup] {setup_s:.2f} s: start to the group "
              f"{marks[0] - t_start:.2f}, model, weights, step and batches "
              f"{marks[1] - marks[0]:.2f}, the checked steps "
              f"{marks[2] - marks[1]:.2f}, warm-up "
              f"{t_start + setup_s - marks[2]:.2f}", file=sys.stderr)
    tokens_per_step = W * mix["batch"] * mix["seq"]
    res = {"attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        n = mix["trace_steps"]
        # busy and window from a pass that traces the device alone; the
        # spans, kernels and breakdown from one that traces the host too,
        # which slows the host's issue of each step
        with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
            busy, window = _device_pass(prog, n, dev, k, tmp)
            tr = _traced(prog, n, dev, k + n + 1, tmp)
        busy = torch.tensor([busy, window], dtype=torch.float64)
        dist.all_reduce(busy, group=host)
        busy /= W
        res["attempted"] = 2 * n
        res["trace"] = tr
        res["busy_s"], res["window_s"] = float(busy[0]), float(busy[1])
    else:
        n, wall, times, losses = _window(prog, seconds, dev, host, k)
        bad = sum(int(not torch.isfinite(x)) for x in losses)
        res["attempted"], res["failed"] = n, bad
        res["metrics"] = {
            "train_tokens_per_s": {"value": n * tokens_per_step / wall,
                                   "unit": "tokens/s"},
            "step_ms_p90": {"value": p90(times) * 1e3, "unit": "ms"},
        }
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if cuda
                         else 0], dtype=torch.int64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=host)
    res["peak"] = int(peak[0])
    res["setup_s"] = setup_s
    leaves = [(p.numel(), str(p.dtype).replace("torch.", ""))
              for p in prog.state["params"]]
    found = torch.tensor([len(forbidden_modules())], dtype=torch.int64)
    dist.all_reduce(found, group=host)
    # the program's state goes before the reference runs
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    ref = reference_readings(cell, seed, dev)
    correct, checks = compare(mine, ref, cell.limits)
    return finish(cell, res, correct, checks, leaves, dev,
                  forbidden=int(found[0]), tokens_per_step=tokens_per_step)


def finish(cell, res, correct, checks, leaves, dev, forbidden,
           tokens_per_step):
    """The result line's object (``checks`` last)."""
    metrics = res["metrics"]
    if "trace" in res:
        ctx = MetricContext(cell, res["trace"], res["busy_s"],
                            res["window_s"], cell.mix["trace_steps"],
                            tokens_per_step, leaves)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics["peak_mem_gib"] = {"value": res["peak"] / 2 ** 30,
                                   "unit": "GiB"}
        metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in names}
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.world, "memory_peak_bytes": res["peak"]}
    out = {"correct": bool(correct) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if "trace" in res:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
        out["breakdown"] = res["trace"].breakdown()
    out["forbidden_modules"] = forbidden
    out["checks"] = checks
    return out


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader reads."""
    cell: Cell
    trace: Trace                # rank 0's, host calls and device work
    busy_s: float               # of the device-only pass, averaged over
    window_s: float             # the ranks
    steps: int                  # steps in each pass
    tokens_per_step: int        # over all ranks
    leaves: list                # (numel, dtype) of each parameter
