#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which must pass (the script exits nonzero otherwise):

1. set-up: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and prints the compiler's register report and the card's name and
   power limit.  TF32 is off for convolutions and matrix products, so
   every phase runs in full fp32.
2. kernels: the per-leaf MLLess kernels against their plain PyTorch
   twins at the block view of every full-width MobileNet leaf, a ragged
   row count, an unpacked row width and bf16, timed (kernel, twin, library
   call) at one MLLess step's 83 leaf views; then the segmented pair,
   which the MLLess step runs (every leaf at once), against its twins at
   the 83 MobileNet and 62 ResNet-18 leaves in fp32 and bf16 and a ragged
   layout aligned and not, timed at one MobileNet and one ResNet-18 step.
3. train: the training entry point on full-width MobileNet, batch 96,
   MLLess, 30 steps on a one-rank NCCL group; the loss must fall and each
   segmented kernel must launch once a step (no per-leaf launch).  One
   step through the kernels is held against the same step through the
   twins, a reduced model's logits against the same model on the CPU;
   the other four strategies and ResNet-18 take a few steps each (the
   profiler windows over the MLLess step of MobileNet and ResNet-18 are
   cut for the time limit: PERF.md keeps their earlier readings, and
   ``--compare-mlless`` still runs them).
4. robust kernels: the four robust-aggregation kernels against their
   plain versions at W = 4 stacks of the full-width MobileNet and
   ResNet-18 gradients and at W = 3..16 over a ragged D, with tie and
   constant columns and a 1e30 row; Krum also at W = 1, 2, 4, 5, 8, 9, 16
   and 32 over D of every residue mod 4, from an aligned base and from
   one 4 bytes off; then each is timed against its plain version and a
   library call at the MobileNet stack, Krum's streaming kernel beside
   its earlier tile form (through its C entry point) at W = 4 and 8, and
   the tile form, which W above 8 takes, at W = 16 and 32, with
   ``torch.cdist(x, x) ** 2`` as a CUDA graph beside it at every W.
5. byzantine: ``repro_torch.launch.byzantine_train.run`` on full-width
   MobileNet, 4 ranks on the one card over gloo, global batch 96 (4
   microbatches of 6 a rank), rank 0 under a -8x attack.  The trimmed mean
   must train (30 steps) where plain all-reduce diverges (15 steps); the
   other robust inners and attacks take 4 steps each; a same-seed replay
   must repeat its losses; each kernel's launches are counted per rank
   (the profiler window over rank 0's steps is cut for the time limit:
   PERF.md keeps its earlier reading).
6. table3: the paper's experiment through the ArchSpec registry.  Each
   paper arch (spirt, mlless, scatterreduce, allreduce, gpu) trains
   full-width MobileNet through ``get_arch(name).make_strategy()`` on a
   one-rank NCCL group (SGD lr TABLE3_LR, momentum 0.9, global batch 96,
   50 steps), with test accuracy after steps 25 and 50 and its
   ``simulate_epoch`` time and cost; the Table 3 gates hold (gpu's
   simulated epoch the smallest, spirt below allreduce, every final
   accuracy above 0.25) and MLLess launches each segmented kernel once a
   step.  The seven beyond-paper archs with a strategy train 5 steps
   each.  Then QuantizedScatterReduce on 4 gloo ranks sharing the card:
   one sync of the full-width gradient on CUDA tensors (int8 through
   gloo) against the same sync on CPU tensors (bit for bit), its
   distance to the exact mean, and 5 steps of
   ``scatterreduce_q8``.  Its record is a JSON line of its own.
7. lm: the LM kernels (fused AdamW, sliding-window attention: bf16 on
   wgmma, fp32 on 3xTF32 mma.sync at every head_dim, both on the tensor
   cores) against their plain versions at every SmolLM-135M leaf, at
   SmolLM's train and long shapes, windows 64 and 1024, a ragged S and
   head_dims 96 and 128, and the attention
   gradient in fp32 and bf16; the attention
   kernels' SASS (wgmma and TMA; TF32 mma and no spill); their times
   against bound, plain version, library call and, for attention, the
   CUDA-core kernel in bf16; the fp32 route's times at SmolLM's long
   shape, Gemma-3's (in turns with the CUDA-core kernel, its route there
   before) and the families' head_dims 128, 160 and 256, against its fp32
   bound, its design's least time and ``F.scaled_dot_product_attention``
   in fp32 under each backend, with their errors; then the LM entry
   point on full-width SmolLM-135M (bf16, batch 16 x seq 128, fused
   AdamW, 30 steps, one-rank NCCL group) at lr 1e-3 with each kernel's
   launches counted per step
   (every attention launch on the tensor-core route), two steps through
   the kernels against the kernel-free path, a record of the entry point's
   default lr 3e-3 on the same steps, reduced logits on the card against
   the CPU, SPIRT and MLLess for 3 steps each, and 5 steps at seq 2048
   (its profiler windows, at seq 128 and at seq 2048 with attention's
   device time split, are cut for the time limit: PERF.md keeps their
   earlier readings).
8. gemma: attention at the wide head_dims (Gemma-3's 320 at its train
   shape, local and global, and a ragged S; 160; 256) against its plain
   version in bf16 (every launch on the wgmma route) and fp32 (every
   launch on the 3xTF32 route, a warp pair a row at hd 320); its times at
   Gemma-3's shape against bound, plain version, the CUDA-core kernel in
   bf16 (its earlier route) and
   ``F.scaled_dot_product_attention`` under each backend (which one the
   default picks, which refuse hd 320); then the LM entry point on
   full-width gemma3-4b cut to 6 layers (one 5:1 local/global group;
   bf16, batch 1 x seq 2048, fused AdamW lr 3e-4, 10 steps) with 12
   tensor-core attention launches a step, peak memory, two steps against
   the kernel-free path and a record of lr 3e-3 and 1e-3 (the profiler
   window over the step is cut for the time limit: PERF.md keeps its
   earlier reading).
9. rwkv: the WKV recurrence's two routes (the tensor-core kernel at N
   32/64 with chunks 16/32/64, the CUDA-core kernel elsewhere and, through
   its C entry point, at those shapes too) against the plain chunked twin
   (and the exact recurrence where T <= 128, and the tensor-core route
   against its two-level twin) at N 16, 32 and 64, chunks 1 to 64, a
   ragged T, B*H from 1 to 256, fp32 and bf16, decays up to the strong
   ones where the Pallas body overflows, and the gradient through
   ``ops.wkv6`` on the card against the CPU; the tensor-core kernel's SASS
   (TF32 mma); both routes' times at rwkv6-7b's train shape and a long
   shape in turns, against bound and plain twins; then the LM entry
   point on full-width rwkv6-7b cut to 4 layers (bf16, batch 4 x seq 512,
   fused AdamW lr 3e-4, 20 steps, one-rank NCCL group) with 8 WKV launches
   a step, all on the tensor cores, and 17
   fused-AdamW launches a step, two steps against the kernel-free path, a
   record of the default lr 3e-3 on both paths (every WKV call of the
   kernel path watched, every form of WKV run on the first call with an
   input or output that is not finite) and MLLess for 2 steps (the
   profiler window is cut for the time limit: PERF.md keeps its earlier
   reading); the full 32-layer model's forward at batch 4 x seq
   2048 through the kernel (32 launches) against the kernel-free forward,
   with the kernel-free forward at another chunk as the witness of what
   rounding alone does, in bf16 and in fp32; reduced logits on the card
   against the CPU.

10. serve: the serving path.  Full-width SmolLM-135M (bf16) through
   ``build_serve_step``: batch 16, prompt 512, decode_32k's context of
   32,768 (its batch of 128 cut to 16: the KV cache is 755 MB a
   sequence), 32 greedy decode tokens, kernel 8 launched 30 times a
   prefill, all on the tensor-core route; the decode logits against the
   teacher-forced forward over the prompt and the generated tokens,
   within twice what the kernel-free path's own comparison gives; the
   decode step's bytes (``costmodel.flops.step_bytes_hbm``) and bound
   (the profiler window over 8 decode steps is cut for the time limit:
   PERF.md keeps its earlier reading).  A prompt of prefill_32k's
   32,768 tokens (batch 1), its layer-0 launch held against the plain
   chunked attention.  Gemma-3 cut to 6 layers (batch 4, prompt 1,536
   past its window of 1,024, cache 2,048, 64 tokens; 6 hd-320 tensor-core
   launches a prefill) and rwkv6-7b cut to 4 layers (batch 4, prompt 512,
   32 tokens; its prefill takes the plain chunked WKV, as the
   reference's does), gated as SmolLM; both also in fp32 with decode held
   to 1e-3 of the largest logit: rwkv at the same shape, Gemma-3 at batch
   1, prompt 1,536, cache 2,048, 8 tokens, its 6 prefill launches of
   kernel 8 all on the 3xTF32 route at hd 320.
   ``ServingEngine`` on SmolLM-135M cut to 10 layers (its decode step's
   eager and graph times at full depth): fp32, 16 requests over 8 slots,
   every request equal to its sequential generation; bf16, 64 requests
   over 16 slots, engine steps, tokens a second, occupancy, time to first
   token and the agreement count, a divergence allowed only at a near
   tie (within this model's bf16 decode error).  Flash-decode on 4 gloo
   ranks sharing the card, 524,288 slots,
   against single-process decode attention.  Its record is the line
   ``{"serve": {...}}``; the kernels line's attention entry gains the
   launches and routes of each prefill.
11. resilience: the chaos harness (``repro_torch.resilience``) on
   full-width SmolLM-135M cut 30 -> 10 layers (``MULTI_RANK_LAYERS``,
   every trainer the ranks build; bf16, SPIRT), 4 ranks sharing the card
   over gloo, global batch 12 x seq 128, lr 1e-3, 5 steps, worker 1
   killed at step 3, a checkpoint every 2 steps and the in-DB store
   pushed every step: the baseline, checkpoint restore twice (each bit for bit the
   baseline; where not, the ops without a deterministic implementation
   are named), SPIRT's peer takeover (no replay, 3 ranks on, the dead
   partition's bytes, final loss within 0.5 of the baseline's), the
   restore onto the 3 survivors, and 2 baseline steps at the harness's
   default lr 1e-2 as a record; each rank's fused-AdamW and attention
   launches against the counts of the steps it ran (all wgmma); a bf16
   checkpoint of the card's state through ``dumps``/``loads`` bit for
   bit; ``benchmarks/recovery_replay.py``'s sign check through the port's
   event runtime; wall times split into read, decode, to-device and
   replay (its profiler window over rank 0's step is cut for the time
   limit: PERF.md keeps its earlier reading).  The lm phase keeps
   SmolLM's full depth on one card.  Its record is the line
   ``{"resilience": {...}}``; the kernels line's fused-AdamW and
   attention entries gain its launches.

12. families: the model families beyond the dense and RWKV LMs, at full
   width.  Kernel 8 at each family's prefill shape (Mixtral 8x7B's and
   8x22B's, RecurrentGemma's, Whisper's decoder's, Pixtral's) against its
   plain version, timed against bound and SDPA.  Training through the
   entry point (bf16, fused AdamW lr 3e-4, 5 steps, one-rank NCCL group):
   mixtral-8x7b cut to 1 layer and pixtral-12b to 2 (batch 1 x seq 2048),
   recurrentgemma-2b cut to one (RG-LRU, RG-LRU, local) group (batch 1 x
   seq 2048), whisper-small at full depth (batch 4 x 448 over stub frames
   of 1500); losses finite and falling, fused AdamW once a leaf a step,
   kernel 8 twice an attention layer a step (all wgmma), the first step's
   loss against the kernel-free path's to 2^-9, a record at the
   reference's lr 3e-3, peak memory (the profiler windows over each
   family's step are cut for the time limit: PERF.md keeps their
   earlier readings).  Serving through ``serve_model`` with the stub
   inputs: Mixtral 8x7B (1 layer) and 8x22B (2 layers), RecurrentGemma and
   Whisper at full depth, Pixtral at full depth (1,024 patches and 512
   text tokens); kernel 8 once an attention layer a prefill, decode
   against the teacher-forced forward within the witness gate, ms a token
   against ``costmodel.flops.step_bytes_hbm``'s bound.  An MoE model
   prefills once at the reference's capacity factor (the share of slots
   kept is recorded) and is then held at capacity factor E / k, where no
   slot drops; positions where rounding flipped an expert choice between
   the served path and the forward are left out and counted.  Its record
   is the line ``{"families": {...}}``; the kernels line's attention and
   fused-AdamW entries gain its shapes and launches.

13. sharding: FSDP training and data-sharded serving (``core.sharding``,
   ``core.train_step``, ``core.serve_step``) on full-width SmolLM-135M
   cut 30 -> 10 layers (``MULTI_RANK_LAYERS``; the dry-runs of the
   phase's own configuration and the serving too), 4 ranks sharing the
   card over gloo (gloo's all-gather and
   reduce-scatter on CUDA tensors checked first).  Global batch 8 x seq
   512, 3 steps each of allreduce replicated, allreduce under FSDP and
   MLLess under FSDP (bf16, fused AdamW, kernel 8): the FSDP losses within
   2^-9 of the replicated run's, each rank's FSDP leaves and both their
   moments a quarter of the whole, the first step's collective bytes equal
   kind for kind to what ``launch.dryrun`` predicts for the same
   configuration, launches as counted, peak memory a rank beside the
   dry-run's estimate.  Serving over the 4 ranks, SmolLM cut to 10
   layers, 16 greedy tokens, in fp32 token for token against one rank's
   decoding of the same prompts and timed in bf16: batch 16 x cache 2,048
   batch-sharded, batch 1 x cache 32,768 sequence-sharded
   (flash-decode).  The dry-run of
   full-depth SmolLM's train_4k and long_500k on the 16x16 mesh under zero3 (peak
   GB a device, dominant roofline term).  Its record is the line
   ``{"sharding": {...}}``; the kernels line's fused-AdamW, attention and
   segmented entries gain its launches.

14. tp: tensor parallelism (``models.tp``) on full-width SmolLM-135M cut
   30 -> 10 layers (``MULTI_RANK_LAYERS``: the train runs, the dry-runs
   they are held against and the serving on every mesh), 4 ranks sharing
   the card over gloo on a (2, 2) ("data", "model") mesh
   (gloo's bf16 all-reduce and reduce-scatter on CUDA tensors checked
   first).  The sharding phase's batches (global 8 x seq 512), 3 steps
   each of allreduce, allreduce under FSDP and MLLess (whole leaves, as
   the reference's): losses finite, the allreduce runs within 2^-9 of
   the sharding phase's replicated run, the first step's collective
   bytes and counts equal to the ``baseline`` dry-run of the same mesh,
   peak memory a rank below the replicated run's, launches as counted
   (kernel 8 on all 9 heads: 9 do not divide over 2).  Serving SmolLM
   cut to 10 layers, batch 16 x cache 2,048 (the cache on head_dim: 3 kv
   heads do not divide), 8 greedy tokens, fp32 token for token against
   one rank's and timed in bf16.  Then ranks 0-2 on (1, 3), where 9 / 3
   heads and d 576 divide: prefill through kernel 8 on 3 heads a rank
   (fp32 and bf16, the cache on the kv heads; 10 layers), 8 fp32 tokens
   against one rank's.  Then the other
   families on the (2, 2) mesh in the same spawn, at full width, depth
   cut (mixtral-8x7b 1 layer, rwkv6-7b 2, recurrentgemma-2b 3, pixtral-12b
   1, whisper-small whole; bf16, fused AdamW lr 3e-4): 2 allreduce steps
   each (and 2 under FSDP for Mixtral), the losses within 2^-9 of a
   replicated run on rank 0 (the same rows, each data rank's gradient
   taken in turn and averaged), the first step's collective bytes and
   counts equal to the ``baseline`` dry-run's, peak memory a rank beside
   the dry-run's estimate and below the replicated run's, launches as
   counted (fused AdamW once a leaf, kernel 8 twice a causal attention
   layer, kernel 9 twice an RWKV layer, on 32 of 64 heads a rank), the
   first call of kernels 8 and 9 on the TP path held against their plain
   versions at those sharded shapes and timed; fp32 serving, batch 4, 8
   greedy tokens token for token against one rank's, gloo calls a
   prefill and a token, kernel 8 once a causal attention layer a
   prefill.  Then 6 ranks on (1, 6), where neither 9 / 3 heads nor
   head_dim 64 divide and the model axis lands on the ring's slots: 10
   layers, batch 2, cache 3,072 (512 slots a rank), prompt 2,048,
   kernel 8 on all 9 heads a rank in the prefill (fp32 on 3xTF32, bf16
   on wgmma), 8 greedy tokens through flash-decode over the model group,
   fp32 token for token against one rank's, gloo calls a token against
   the design's count (1 + 8 a layer + 2).  SmolLM's full depth stays
   on one card: the lm phase trains all 30 layers, the serve phase
   serves them.  Its record is the line ``{"tp": {...}}``; the
   kernels line's fused-AdamW, attention, WKV and segmented entries gain
   its launches.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  The table3, serve, resilience,
families, sharding and tp records come earlier, on lines of their own:
``{"table3": {...}}``, ``{"serve": {...}}``, ``{"resilience": {...}}``,
``{"families": {...}}``, ``{"sharding": {...}}``, ``{"tp": {...}}``.

Where a phase spawns W ranks on the one host (``spawn_ranks``), each
rank's torch takes at most ``os.cpu_count() // W`` CPU threads, through
``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``; a ``[spawn]`` line says how
many.  The resilience, sharding and tp phases print ``[budget]`` lines:
each spawn's start-up (seconds from the spawn until the ranks entered
their function, held a CUDA context and joined the group), each train
run's build, first step and later steps, each trainer's build and warm
steps, each run's snapshots, each serving call, and the dry-run child's
time and the wait for it.

    python3 chip_smoke.py --compare-mlless ROOT

times only the MLLess step of MobileNet and ResNet-18 (``profile_step``)
on the checkout at ROOT and on this one, in turns, one process each.
"""
import copy
import functools
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
H100_BF16_FLOP_PER_S = 989e12    # bf16 dense tensor cores
H100_TF32_FLOP_PER_S = 495e12    # TF32 dense tensor cores
BLOCK = 256
ROBUST_SRC = "src/repro_torch/kernels/csrc/robust_agg.cu"
BYZ_RANKS = 4
# the reference's lr 0.1 does not train full-width MobileNet under the
# attack (the loss peaks above 25); the paper's 0.01 does (PERF.md)
BYZ_LR = 0.01


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def spawn_ranks(fn, args, nprocs):
    """``torch.multiprocessing.spawn`` of ``nprocs`` ranks on this host,
    each rank's torch given at most ``os.cpu_count() // nprocs`` CPU
    threads (fewer where the caller's ``OMP_NUM_THREADS`` says so).  A
    spawned interpreter's torch sizes its pool from these variables as it
    starts; ranks that each start a pool as wide as the host keep threads
    spinning on cores they do not hold."""
    import torch
    cpus = os.cpu_count() or 1
    saved = {v: os.environ.get(v) for v in THREAD_VARS}
    n = min([max(1, cpus // nprocs)] + [int(old) for old in saved.values()
                                        if old and old.isdigit()
                                        and int(old) > 0])
    os.environ.update({v: str(n) for v in THREAD_VARS})
    log(f"[spawn] {fn.__name__}: {nprocs} ranks on {cpus} CPUs, {n} torch "
        "threads a rank")
    try:
        torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs)
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def start_rank(rank, world, init, t_spawn):
    """A spawned rank's start: TF32 off, its device, its CUDA context and
    the default process group over ``init``.  Returns the device and the
    seconds from the spawn (``t_spawn``: the parent's ``time.time()``
    just before it) until the rank entered its function (interpreter and
    imports), held its CUDA context and had joined the group."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import _rank_device, backend_for
    clock = {"entered": time.time() - t_spawn}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _rank_device("cuda", rank)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    clock["cuda"] = time.time() - t_spawn
    dist.init_process_group(backend_for(dev, world), init_method=init,
                            rank=rank, world_size=world)
    clock["group"] = time.time() - t_spawn
    return dev, clock


def budget_spawn(where, clocks, spawn_s):
    """The ``[budget]`` line of one spawn: each start-up stage's seconds
    from the spawn, first and last rank (``clocks``, ``start_rank``'s),
    and when the spawn returned."""
    stages = ", ".join(
        f"{k} {min(c[k] for c in clocks):.1f}-{max(c[k] for c in clocks):.1f}"
        for k in ("entered", "cuda", "group"))
    log(f"[budget] {where}: {len(clocks)} ranks, spawn -> first rank ready "
        f"{min(c['group'] for c in clocks):.1f} s (from the spawn, first-"
        f"last rank: {stages} s); the spawn returned after {spawn_s:.1f} s")


def budget_train(where, run):
    """The ``[budget]`` line of one rank's train run: the model's and the
    step's build, the first step and the later ones."""
    ms = run["step_ms"]
    log(f"[budget] {where} (rank 0): build {run['build_s']:.1f} s, first "
        f"step {ms[0] / 1e3:.1f} s, later steps "
        f"{[round(m / 1e3, 1) for m in ms[1:]]} s")


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
        if not report.exists():
            continue
        entry = ""
        for line in report.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"[setup] {stem} {entry}: {line.strip()}")
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


def layout_shapes(arch):
    """The leaf shapes of a full-width CIFAR CNN, in MLLess's order."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_cnn, reference_leaves
    return [tuple(p.shape) for p in reference_leaves(
        build_cnn(get_config(arch), device="cpu"))]


def segment_case(shapes, gdtype, dev, gen, misalign=False):
    """Seeded gradients of ``shapes`` (mixed-scale 256-wide rows, so the
    masks vary), a padded fp32 residual and their layout.  ``misalign``
    cuts the gradients from one buffer at odd element offsets, so no leaf
    is 16-byte aligned and the kernels take their one-value path."""
    import torch
    from repro_torch.kernels.block_significance import SegmentLayout
    grads = []
    for shape in shapes:
        n = math.prod(shape)
        rows = -(-n // BLOCK)
        scale = torch.rand((rows, 1), generator=gen, device=dev) ** 3 * 4
        g = (torch.randn((rows, BLOCK), generator=gen, device=dev) * scale)
        g = g.reshape(-1)[:n].to(gdtype)
        if misalign:
            g = torch.cat([g.new_zeros(1), g])[1:]
        grads.append(g.view(shape))
    layout = SegmentLayout(grads)
    resid = layout.pack([0.3 * torch.randn(g.shape, generator=gen,
                                           device=dev) for g in grads], dev)
    return grads, resid, layout


def segment_parity(dev):
    """The segmented pair against its plain twins on the card: the 83
    MobileNet leaves and the 62 ResNet-18 leaves in fp32 and bf16
    (fp32 residuals), and a ragged layout (1, 255, 257 and 100,003
    values) aligned and not.  Sums of squares within 1e-5 relative; masks
    equal wherever a row's norm is more than 1e-4 from the leaf's cut
    (the margin is checked from the twin's own numbers); counts the sum
    of the kernel's mask; kept and residual bit-exact given the mask."""
    import torch
    from repro_torch.kernels import block_significance as bs
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = []
    for arch in ("mobilenet-cifar", "resnet18-cifar"):
        for gdtype in (torch.float32, torch.bfloat16):
            cases.append((f"{arch} {str(gdtype)[6:]}", layout_shapes(arch),
                          gdtype, False))
    ragged = [(1,), (255,), (257,), (100_003,)]
    for gdtype in (torch.float32, torch.bfloat16):
        for mis in (False, True):
            cases.append((f"ragged {str(gdtype)[6:]}"
                          + (" misaligned" if mis else ""), ragged, gdtype,
                          mis))
    abs_err, rel_err, near, rows = 0.0, 0.0, 0, 0
    for label, shapes, gdtype, mis in cases:
        grads, resid, layout = segment_case(shapes, gdtype, dev, gen, mis)
        sq, mask, counts = bs.segment_norms(grads, resid, layout, 0.5)
        sq2, mask2, _ = ref.segment_norms(grads, resid, layout, 0.5)
        torch.cuda.synchronize()
        check(sq.shape == sq2.shape and mask.dtype == torch.bool
              and counts.shape == (len(shapes),),
              f"segment_norms {label}: shapes {sq.shape} {mask.dtype} "
              f"{counts.shape}")
        diff = (sq - sq2).abs()
        rel = float((diff / sq2.abs().clamp_min(1e-30)).max())
        abs_err, rel_err = max(abs_err, float(diff.max())), max(rel_err, rel)
        check(rel <= 1e-5, f"segment_norms {label}: rel err {rel:.3e}")
        # each row's distance from its leaf's cut, from the twin's numbers
        cut = torch.cat([
            0.5 * torch.sqrt(sq2[b0:b0 + nb].double().mean() + 1e-20)
            .expand(nb) for b0, nb in zip(layout.block0, layout.blocks)])
        margin = (sq2.double().sqrt() / cut - 1).abs()
        far = margin > 1e-4
        check(torch.equal(mask[far], mask2[far]),
              f"segment_norms {label}: masks differ away from the cut")
        near += int((~far).sum())
        rows += layout.n_rows
        per_leaf = torch.stack([mask[b0:b0 + nb].sum() for b0, nb in
                                zip(layout.block0, layout.blocks)])
        check(torch.equal(counts, per_leaf),
              f"segment_norms {label}: counts {counts} vs mask {per_leaf}")
        kept, new = bs.segment_filter(grads, resid, layout, mask)
        kept2, new2 = ref.segment_filter(grads, resid, layout, mask)
        torch.cuda.synchronize()
        check(torch.equal(kept, kept2) and torch.equal(new, new2),
              f"segment_filter {label}: differs from its twin")
        del grads, resid, kept, new, kept2, new2
    log(f"[segments] parity on {len(cases)} layouts "
        f"({', '.join(c[0] for c in cases)}): segment_norms max rel err "
        f"{rel_err:.3e} (tol 1e-5; max abs err {abs_err:.3e}), masks equal "
        f"away from the cut "
        f"({near} of {rows} rows within 1e-4 of it), counts exact; "
        "segment_filter bit-exact")
    return abs_err, rel_err


def segment_times(dev):
    """The segmented pair at one MLLess step of full-width MobileNet and
    ResNet-18 (fp32 gradients): called back to back, as a CUDA graph,
    the plain twins; bounds count g and the residual read once and every
    output written once."""
    import torch
    from repro_torch.kernels import block_significance as bs
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for arch in ("mobilenet-cifar", "resnet18-cifar"):
        grads, resid, layout = segment_case(layout_shapes(arch),
                                            torch.float32, dev, gen)
        _, mask, _ = ref.segment_norms(grads, resid, layout, 0.5)
        L, rows = len(layout.numels), layout.n_rows
        g_bytes = sum(g.numel() * g.element_size() for g in grads)
        r_bytes = resid.numel() * 4
        nbytes = {"segment_norms": g_bytes + r_bytes + 5 * rows + 8 * L,
                  "segment_filter": g_bytes + r_bytes + rows
                  + 4 * layout.numel + r_bytes}
        fns = {"segment_norms": (
                   lambda: bs.segment_norms(grads, resid, layout, 0.5),
                   lambda: ref.segment_norms(grads, resid, layout, 0.5)),
               "segment_filter": (
                   lambda: bs.segment_filter(grads, resid, layout, mask),
                   lambda: ref.segment_filter(grads, resid, layout, mask))}
        for name, (kernel, plain) in fns.items():
            t_bytes = nbytes[name] / H100_BYTES_PER_S
            t_ops = 2 * layout.numel / H100_FP32_FLOP_PER_S
            out.setdefault(name, {})[arch] = dict(
                ms=time_ms(kernel), graph_ms=graphed_ms(kernel),
                plain_ms=time_ms(plain, reps=10),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes[name], leaves=L, rows=rows)
            r = out[name][arch]
            log(f"[segments] {name}, one {arch} MLLess step ({L} leaves, "
                f"{rows} rows, fp32): kernel {r['ms']:.5f} ms (as a CUDA "
                f"graph {r['graph_ms']:.5f} ms), plain {r['plain_ms']:.4f} "
                f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                f"{r['bytes'] / 1e6:.2f} MB)")
        del grads, resid, mask
    return out


MLLESS_STEP = {"segment_norms": 1, "segment_filter": 1, "block_norms": 0,
               "masked_filter": 0}   # launches an MLLess step, any model


def mlless_launches(steps):
    return {k: n * steps for k, n in MLLESS_STEP.items()}


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
        check(launches == mlless_launches(steps), f"launches {launches} in "
              f"{steps} steps, expected {mlless_launches(steps)}")
        log(f"[train] mobilenet-cifar full width, batch 96, mlless, "
            f"{steps} steps: loss {first:.4f} (first five) -> {last:.4f} "
            f"(last five); launches {launches} = {MLLESS_STEP} a step "
            f"(83 leaves); "
            f"{res['ms_per_step']:.3f} ms/step after the first "
            f"({res['first_step_ms']:.1f} ms); peak memory "
            f"{res['peak_mem_bytes'] / 2**20:.1f} MiB; "
            f"significant_fraction {res['metrics']['significant_fraction']:.4f}")
        kernels_vs_twins()
        cuda_vs_cpu()
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
        check(bs.LAUNCHES == mlless_launches(4),
              f"resnet18 mlless launches {bs.LAUNCHES}, expected "
              f"{mlless_launches(4)} (62 leaves, {MLLESS_STEP} a step)")
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


# the MLLess filter's kernels, per-leaf and segmented, as the profiler
# names them
MLLESS_KERNELS = ("block_norms_kernel", "masked_filter_kernel",
                  "segment_norms_kernel", "segment_significance_kernel",
                  "segment_filter_kernel")


def profile_step(strategy, arch="mobilenet-cifar", steps=5):
    """Where a step's time goes: ``torch.profiler`` over a few steps of a
    full-width CIFAR CNN at batch 96 (after warm-up), device time by
    kernel against the host clock; returns the step's numbers.  It runs
    on whichever ``repro_torch`` is first on ``sys.path``, so
    ``--compare-mlless`` applies it to another checkout too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import cifar_like
    from repro_torch.models import build_cnn

    imgs, labels = cifar_like(96, seed=9)
    batch = {"images": torch.from_numpy(imgs).cuda(),
             "labels": torch.from_numpy(labels).cuda()}
    model = build_cnn(get_config(arch), device="cuda")
    ts = build_train_step(model, optim.sgd(0.01, momentum=0.9),
                          get_strategy(strategy))
    state = ts.init_state()
    for _ in range(3):
        ts.step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ts.step_fn(state, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ts.step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    log(f"[profile] {arch} {strategy}: {plain_ms:.3f} ms/step unprofiled")
    out = profile_report(prof, steps, wall_ms, f"{arch} {strategy}",
                         MLLESS_KERNELS if strategy == "mlless" else (), 8)
    out.update(arch=arch, strategy=strategy, ms_per_step=plain_ms)
    return out


def compare_mlless(parent, rounds=("parent", "change", "change", "parent")):
    """The MLLess step (``profile_step``) of MobileNet and ResNet-18 on
    another checkout (``parent``, its root) and on this one, in turns,
    one process each, on the one card; prints one JSON line per run."""
    trees = {"parent": Path(parent).resolve(), "change": ROOT}
    for name, tree in trees.items():
        check((tree / "src" / "repro_torch").is_dir(),
              f"{name}: {tree} holds no src/repro_torch")
    runs = []
    for arch in ("mobilenet-cifar", "resnet18-cifar"):
        for who in rounds:
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mlless-step", arch, "--src", str(trees[who] / "src")],
                capture_output=True, text=True, timeout=600)
            check(res.returncode == 0, f"{who} {arch}: {res.stderr[-2000:]}")
            run = json.loads(res.stdout.strip().splitlines()[-1])
            run["tree"] = who
            runs.append(run)
            log(f"[compare] {who} {arch}: {run['ms_per_step']:.3f} ms/step "
                f"unprofiled, {run['wall_ms']:.3f} profiled, "
                f"busy {run['busy_ms']:.3f}, idle share "
                f"{run.get('idle_share', float('nan')):.3f}, "
                f"{run['kernels_per_step']:.0f} kernels a step")
    return runs


def mlless_step(arch):
    """One checkout's MLLess step under ``profile_step`` (the child of
    ``compare_mlless``); its last line is the JSON of the numbers."""
    import torch
    import torch.distributed as dist
    setup()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_cmp_"), "pg"), rank=0,
        world_size=1)
    try:
        out = profile_step("mlless", arch)
    finally:
        dist.destroy_process_group()
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


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


def flat_sizes():
    """D of the full-width MobileNet and ResNet-18 gradients."""
    return {arch: sum(map(math.prod, layout_shapes(arch)))
            for arch in ("mobilenet-cifar", "resnet18-cifar")}


def robust_stack(W, D, dev, gen, edges):
    """A seeded (W, D) fp32 stack of mixed-scale rows; ``edges`` adds
    constant columns, ties, rounded columns and a stretch of one row
    scaled by 1e30."""
    import torch
    x = torch.randn((W, D), generator=gen, device=dev) \
        * torch.rand((W, 1), generator=gen, device=dev).mul(99).add(1)
    if edges:
        x[:, :7] = 2.5
        x[1, 7:40] = x[2, 7:40]
        x[:, 40:60] = x[:, 40:60].round()
        x[0, 60:90] *= 1e30
    return x


def robust_parity(sizes, dev):
    """Each robust-aggregation kernel against its plain version: the
    trimmed mean (every legal trim) and the median bit-exact; Krum within
    1e-5 of ||xi||^2 + ||xj||^2 (fp32 sums in other orders, TF32 off),
    its diagonal 0 and a second call the same bits; the Weiszfeld step
    within 1e-5 of the largest value, a second call the same bits.
    Returns the largest absolute errors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust_agg as ra
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(4, sizes["mobilenet-cifar"]), (4, sizes["resnet18-cifar"])]
    cases += [(W, 100_003) for W in (3, 5, 7, 8, 12, 16)]
    err = dict.fromkeys(ra.LAUNCHES, 0.0)
    for W, D in cases:
        x = robust_stack(W, D, dev, gen, edges=True)
        for trim in range(1, (W - 1) // 2 + 1):
            got = ra.trimmed_mean(x, trim)
            check(torch.equal(got, ref.trimmed_mean(x, trim))
                  and bool(torch.isfinite(got).all()),
                  f"trimmed_mean differs from its plain version at W={W} "
                  f"D={D} trim={trim}")
        check(torch.equal(ra.coordinate_median(x),
                          ref.coordinate_median(x)),
              f"coordinate_median differs at W={W} D={D}")
        del x
        y = robust_stack(W, D, dev, gen, edges=False)  # squares stay finite
        got, again = ra.krum_pairwise(y), ra.krum_pairwise(y)
        want = ref.krum_pairwise(y)
        n = torch.sum(y.double() ** 2, dim=1)
        diff = (got.double() - want.double()).abs()
        check(bool((diff <= 1e-5 * (n[:, None] + n[None, :])).all())
              and torch.equal(got, again)
              and bool((torch.diagonal(got) == 0).all()),
              f"krum_pairwise at W={W} D={D}: max diff {float(diff.max())}")
        err["krum_pairwise"] = max(err["krum_pairwise"], float(diff.max()))
        z = ref.coordinate_median(y)
        floor = 1e-12 * float(torch.linalg.vector_norm(y, dim=1).max())
        got = ra.weiszfeld_step(y, z, floor)
        again = ra.weiszfeld_step(y, z, floor)
        want = ref.weiszfeld_step(y, z, floor)
        diff = float((got - want).abs().max())
        check(diff <= 1e-5 * float(want.abs().max())
              and torch.equal(got, again),
              f"weiszfeld_step at W={W} D={D}: max diff {diff:.3e}")
        err["weiszfeld_step"] = max(err["weiszfeld_step"], diff)
        del y
    torch.cuda.synchronize()
    log(f"[robust] parity on {len(cases)} stacks (W=4 at D="
        f"{sizes['mobilenet-cifar']:,} and {sizes['resnet18-cifar']:,}; "
        f"W=3,5,7,8,12,16 at D=100,003; ties, constant columns, a 1e30 "
        f"row): trimmed_mean (every trim) and coordinate_median bit-exact;"
        f" krum_pairwise max abs err {err['krum_pairwise']:.3e} (tol 1e-5 "
        f"of ni+nj), weiszfeld_step max abs err "
        f"{err['weiszfeld_step']:.3e} (tol 1e-5 of the largest value); "
        "second calls bit-identical")
    return err


# Krum's W: both instantiations of the streaming kernel (4, 8) and either
# side of them, and the tile form above them; D of every residue mod 4
KRUM_W = (1, 2, 4, 5, 8, 9, 16, 32)
KRUM_D = 100_000


def krum_parity(dev):
    """Krum against its plain version at every W of ``KRUM_W`` and D of
    each residue mod 4, the stack from a 16-byte aligned base and from one
    4 bytes off (a view of a longer buffer, which the wrapper takes as it
    is): each distance within 1e-5 of ||xi||^2 + ||xj||^2, the diagonal 0,
    the matrix symmetric, two launches the same bits.  Returns the largest
    absolute error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust_agg as ra
    gen = torch.Generator(device=dev).manual_seed(16)
    worst, cases = 0.0, 0
    for W in KRUM_W:
        for D in range(KRUM_D, KRUM_D + 4):
            y = robust_stack(W, D, dev, gen, edges=False)
            shifted = torch.cat([y.new_zeros(1), y.reshape(-1)])[1:]
            for x in (y, shifted.view(W, D)):
                before = ra.LAUNCHES["krum_pairwise"]
                got, again = ra.krum_pairwise(x), ra.krum_pairwise(x)
                want = ref.krum_pairwise(x)
                torch.cuda.synchronize()
                n = torch.sum(x.double() ** 2, dim=1)
                diff = (got.double() - want.double()).abs()
                check(ra.LAUNCHES["krum_pairwise"] == before + 2
                      and bool((diff <= 1e-5 * (n[:, None] + n[None, :]))
                               .all())
                      and torch.equal(got, again)
                      and torch.equal(got, got.T)
                      and bool((torch.diagonal(got) == 0).all()),
                      f"krum_pairwise at W={W} D={D} base "
                      f"{x.data_ptr() % 16}: max diff {float(diff.max())}")
                worst = max(worst, float(diff.max()))
                cases += 1
    log(f"[robust] krum_pairwise at W={KRUM_W} x D={KRUM_D}..{KRUM_D + 3} "
        f"(every residue mod 4) x base aligned / 4 bytes off ({cases} "
        f"stacks): max abs err {worst:.3e} (tol 1e-5 of ni+nj), diagonal "
        "0, symmetric, second launches bit-identical")
    return worst


def krum_tile(x):
    """Krum's tile form (the kernel before the streaming one, still the
    route above W = 8) through its C entry point: launched at every W to
    time the two designs in one run; counts nothing."""
    import torch
    from repro_torch.kernels import robust_agg as ra
    W, D = x.shape
    out = torch.empty((W, W), dtype=torch.float32, device=x.device)
    partial, counter = ra._scratch(x)
    err = ra._lib().rt_krum_pairwise_tile(
        x.data_ptr(), D, W, partial.data_ptr(), counter.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"Krum tile kernel failed: CUDA error {err}")
    return out


def krum_times(D, dev):
    """Krum at W = 4, 8, 16 and 32 on a (W, D) stack: the wrapper as a
    CUDA graph (the streaming kernel at W <= 8, the tile form above) and
    the tile form through its C entry point, in turns (tile, wrapper,
    wrapper, tile), against the bytes bound, and ``torch.cdist(x, x) **
    2`` as a CUDA graph beside them (the library call)."""
    import torch
    from repro_torch.kernels import robust_agg as ra
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for W in (4, 8, 16, 32):
        x = robust_stack(W, D, dev, gen, edges=False)
        check(torch.equal(krum_tile(x), krum_tile(x)), "krum tile form")
        tile = [graphed_ms(lambda: krum_tile(x))]
        new = [graphed_ms(lambda: ra.krum_pairwise(x)) for _ in range(2)]
        tile.append(graphed_ms(lambda: krum_tile(x)))
        library = graphed_ms(lambda: torch.cdist(x, x) ** 2)
        nbytes = 4 * W * D + 4 * W * W
        r = dict(graph_ms=min(new), tile_graph_ms=min(tile),
                 route="stream" if W <= 8 else "tile",
                 library_graph_ms=library, library="torch.cdist(x, x) ** 2",
                 bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bytes=nbytes)
        out[f"W{W}"] = r
        log(f"[robust] krum_pairwise W={W} D={D:,}: wrapper ({r['route']} "
            f"kernel) as a CUDA graph {new[0]:.4f} / {new[1]:.4f} ms, tile "
            f"form {tile[0]:.4f} / {tile[1]:.4f} ms (in turns), "
            f"torch.cdist(x, x) ** 2 as a CUDA graph {library:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes, {nbytes / 1e6:.1f} MB): "
            f"{r['bound_ms'] / r['graph_ms']:.3f} of the bound")
        del x
    return out


def robust_times(sizes, dev):
    """Each kernel, its plain version and, where one PyTorch call
    computes the same function, that call, at the W = 4 stack of the
    full-width MobileNet gradient (51.5 MB fp32), with CUDA events; the
    kernel's wrapper also replayed as a CUDA graph, its device time
    without the host's per-call work.  Bounds count each input read once
    and each output written once."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust_agg as ra
    W, D = 4, sizes["mobilenet-cifar"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = robust_stack(W, D, dev, gen, edges=False)
    z = ref.coordinate_median(x)
    floor = 1e-12 * float(torch.linalg.vector_norm(x, dim=1).max())
    stack = 4 * W * D
    work = {   # (bytes, fp32 operations)
        "trimmed_mean": (stack + 4 * D, 4 * W * D),
        # 6 compare-exchanges of the 4-row network, then the mean of two
        "coordinate_median": (stack + 4 * D, 14 * D),
        "krum_pairwise": (stack + 4 * W * W, W * (W + 1) * D),
        "weiszfeld_step": (2 * stack + 8 * D, 5 * W * D),
    }
    fns = {
        "trimmed_mean": (lambda: ra.trimmed_mean(x, 1),
                         lambda: ref.trimmed_mean(x, 1), None),
        "coordinate_median": (
            lambda: ra.coordinate_median(x),
            lambda: ref.coordinate_median(x),
            ("torch.quantile(x, 0.5, dim=0)",
             lambda: torch.quantile(x, 0.5, dim=0))),
        "krum_pairwise": (lambda: ra.krum_pairwise(x),
                          lambda: ref.krum_pairwise(x),
                          ("torch.cdist(x, x) ** 2",
                           lambda: torch.cdist(x, x) ** 2)),
        "weiszfeld_step": (lambda: ra.weiszfeld_step(x, z, floor),
                           lambda: ref.weiszfeld_step(x, z, floor), None),
    }
    out = {}
    for name, (kernel, plain, library) in fns.items():
        nbytes, ops = work[name]
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP32_FLOP_PER_S
        out[name] = dict(
            ms=time_ms(kernel, reps=20), plain_ms=time_ms(plain, reps=20),
            graph_ms=graphed_ms(kernel),
            library_ms=time_ms(library[1], reps=20) if library else None,
            library=library[0] if library else None,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, shapes=f"(4, {D}) fp32 stack",
            resnet18_bound_ms=max(t_bytes, t_ops) * 1e3
            * sizes["resnet18-cifar"] / D)
        r = out[name]
        lib = "none" if library is None else \
            f"{r['library_ms']:.4f} ms ({library[0]})"
        log(f"[robust] {name}: kernel {r['ms']:.4f} ms (replayed as a "
            f"CUDA graph {r['graph_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} "
            f"MB; ResNet-18 stack {r['resnet18_bound_ms']:.4f} ms)")
    del x
    out["krum_pairwise"]["by_W"] = krum_times(D, dev)
    return out


# (label, byzantine_train.run arguments, expected launches a rank per step)
BYZ_PLANS = [
    ("trimmed_mean", dict(inner="trimmed_mean", steps=30),
     {"trimmed_mean": 1}),
    ("allreduce", dict(inner="allreduce", steps=15), {}),
    ("coordinate_median", dict(inner="coordinate_median", steps=4),
     {"coordinate_median": 1}),
    ("krum", dict(inner="krum", steps=4), {"krum_pairwise": 1}),
    ("geometric_median", dict(inner="geometric_median", steps=4),
     {"coordinate_median": 1}),     # + 2 Weiszfeld launches an iteration
] + [(f"trimmed_mean/{a}", dict(inner="trimmed_mean", attack=a, steps=4),
      {"trimmed_mean": 1})
     for a in ("sign_flip", "gaussian_noise", "little_is_enough", "zero")] \
  + [(f"replay/{i}", dict(inner="trimmed_mean", steps=5),
      {"trimmed_mean": 1}) for i in (0, 1)]


def byz_rank(rank, init, out_dir):
    """One of the byzantine phase's ranks: every plan through the entry
    point, launch counts set to 0 just before each run and read just
    after; the replays with deterministic cuDNN; then the profile."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.launch import byzantine_train
    from repro_torch.launch.train import _rank_device, backend_for
    from repro_torch.serverless import recovery
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _rank_device("cuda", rank)
    dist.init_process_group(backend_for(dev, BYZ_RANKS), init_method=init,
                            rank=rank, world_size=BYZ_RANKS)
    results = []
    for label, kw, _ in BYZ_PLANS:
        torch.backends.cudnn.deterministic = label.startswith("replay")
        for k in ra.LAUNCHES:
            ra.LAUNCHES[k] = 0
        recovery.ITERATIONS["geometric_median"] = 0
        r = byzantine_train.run(
            arch="mobilenet-cifar", reduced=False, batch=96, lr=BYZ_LR,
            device="cuda", rank=rank, world_size=BYZ_RANKS,
            log=log if rank == 0 and label == "trimmed_mean" else None, **kw)
        r.update(label=label, launches=dict(ra.LAUNCHES),
                 iterations=recovery.ITERATIONS["geometric_median"],
                 backend=dist.get_backend())
        results.append(r)
    torch.backends.cudnn.deterministic = False
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(
        {"runs": results}))
    dist.destroy_process_group()


def byzantine_phase():
    """Four ranks on the one card through ``byzantine_train.run``;
    returns rank 0's runs by label."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_byz_")
    t0 = time.perf_counter()
    spawn_ranks(
        byz_rank, args=("file://" + os.path.join(out_dir, "pg"), out_dir),
        nprocs=BYZ_RANKS)
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(BYZ_RANKS)]
    runs = {r["label"]: r for r in ranks[0]["runs"]}
    log(f"[byzantine] {BYZ_RANKS} ranks on one card, backend "
        f"{runs['trimmed_mean']['backend']}; collectives staged through "
        f"host memory by the port: none (gloo takes the CUDA tensors); "
        f"{time.perf_counter() - t0:.1f} s for every plan")
    for rank, res in enumerate(ranks):
        for i, (label, kw, per_step) in enumerate(BYZ_PLANS):
            r = res["runs"][i]
            want = {k: n * kw["steps"] for k, n in per_step.items()}
            if label == "geometric_median":
                check(r["iterations"] >= kw["steps"], f"rank {rank}: "
                      f"{r['iterations']} Weiszfeld iterations")
                want["weiszfeld_step"] = 2 * r["iterations"]
            got = {k: n for k, n in r["launches"].items() if n}
            check(got == want, f"rank {rank} {label}: launches {got}, "
                  f"expected {want}")
            check(all(map(math.isfinite, r["losses"])),
                  f"rank {rank} {label}: loss not finite {r['losses']}")
            check(r["losses"] == ranks[0]["runs"][i]["losses"],
                  f"rank {rank} {label}: losses differ from rank 0's")
    robust, plain = runs["trimmed_mean"], runs["allreduce"]
    check(robust["max_loss"] < 4.0 and robust["tail_loss"]
          < robust["head_loss"], f"trimmed mean under attack: max "
          f"{robust['max_loss']:.4f}, head {robust['head_loss']:.4f}, tail "
          f"{robust['tail_loss']:.4f}")
    check(plain["final_loss"] > 10 * robust["final_loss"],
          f"allreduce under attack ended at {plain['final_loss']:.4f}, "
          f"not 10x the trimmed mean's {robust['final_loss']:.4f}")
    check(runs["replay/0"]["losses"] == runs["replay/1"]["losses"],
          f"same-seed replay differs: {runs['replay/0']['losses']} vs "
          f"{runs['replay/1']['losses']}")
    for label, r in runs.items():
        log(f"[byzantine] {label}: losses "
            f"{[round(l, 4) for l in r['losses']]}; acc {r['acc']:.4f}; "
            f"{r['ms_per_step']:.3f} ms/step after the first "
            f"({r['first_step_ms']:.1f} ms); launches a rank "
            f"{ {k: n for k, n in r['launches'].items() if n} }"
            + (f"; {r['iterations']} Weiszfeld iterations"
               if label == "geometric_median" else ""))
    log(f"[byzantine] trimmed mean trains under the -8x attack: max loss "
        f"{robust['max_loss']:.4f} < 4, tail {robust['tail_loss']:.4f} < "
        f"head {robust['head_loss']:.4f}; allreduce final "
        f"{plain['final_loss']:.4f} > 10 x {robust['final_loss']:.4f}; "
        f"replay of 5 steps identical")
    return runs


# ---------------------------------------------------------------------------
# table3: the paper's experiment through the ArchSpec registry
# ---------------------------------------------------------------------------
TABLE3_STEPS = 50
TABLE3_BATCH = 96
TABLE3_EVAL = (25, 50)
# the reference's rate (benchmarks/table3_convergence.py) does not train
# full-width MobileNet (the reference only trains it reduced): the loss
# climbs past 7 and the accuracy stays near chance; 0.01 trains (PERF.md).
# The phase gates at TABLE3_LR and records TABLE3_REF_LR beside it.
TABLE3_REF_LR = 0.05
TABLE3_LR = 0.01
BEYOND_STEPS = 5
QSR_RANKS = 4
QSR_TOL = 5e-2           # relative L2 to the exact mean, the reference's
MLLESS_ARCHS = {"mlless", "spirt_sf"}


def table3_data(dev):
    """The reference benchmark's sets: 4096 training and 512 test images
    of ``cifar_like``, on ``dev``."""
    import torch
    from repro_torch.data import cifar_like
    sets = cifar_like(4096, seed=0) + cifar_like(512, seed=99)
    return [torch.from_numpy(a).to(dev) for a in sets]


def table3_train(name, steps, lr, data, rank=0, world_size=1, evals=()):
    """``steps`` steps of full-width MobileNet (seed 0) through
    ``get_arch(name).make_strategy()``: SGD with momentum 0.9, global
    batch 96 drawn as the reference draws it, this rank's shard of it;
    the MLLess kernels' launch counts set to 0 just before and read just
    after; test accuracy after the steps in ``evals``."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, losses
    from repro_torch.kernels import block_significance as bs
    from repro_torch.models import build_cnn
    from repro_torch.serverless import get_arch
    imgs, labels, test_imgs, test_labels = data
    dev = imgs.device
    strategy = get_arch(name).make_strategy()
    model = build_cnn(get_config("mobilenet-cifar"), device=dev, seed=0)
    ts = build_train_step(model, optim.sgd(lr, momentum=0.9), strategy)
    state = ts.init_state()
    rs = np.random.RandomState(0)
    B = TABLE3_BATCH // world_size
    torch.cuda.reset_peak_memory_stats(dev)
    for k in bs.LAUNCHES:
        bs.LAUNCHES[k] = 0
    step_losses, acc, step_s = [], {}, []
    for step in range(steps):
        idx = rs.randint(0, 4096, TABLE3_BATCH)[rank * B:(rank + 1) * B]
        idx = torch.from_numpy(idx).to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = ts.step_fn(state, {"images": imgs[idx],
                                      "labels": labels[idx]})
        step_losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        if step + 1 in evals:
            with torch.no_grad():
                acc[step + 1] = float(losses.accuracy(model(test_imgs),
                                                      test_labels))
    return {"arch": name, "strategy": type(strategy).__name__,
            "strategy_name": strategy.name, "lr": lr,
            "losses": step_losses, "acc": acc,
            "launches": {k: n for k, n in bs.LAUNCHES.items() if n},
            "ms_per_step": sum(step_s[1:]) * 1e3 / max(steps - 1, 1),
            "first_step_ms": step_s[0] * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "params": sum(p.numel() for p in state["params"])}


def table3_paper(lr, data):
    """The five paper archs at ``lr``, each with its simulated epoch."""
    from repro_torch.serverless import paper_archs, simulate_epoch
    runs = {}
    for name in paper_archs():
        r = table3_train(name, TABLE3_STEPS, lr, data, evals=TABLE3_EVAL)
        rep = simulate_epoch(name, n_params=int(4.2e6),
                             compute_s_per_batch=0.25 if name == "gpu"
                             else 1.0)
        r.update(sim_epoch_s=rep.per_worker_s, sim_total_cost=rep.total_cost,
                 sim_cost_per_worker=rep.cost_per_worker)
        runs[name] = r
        log(f"[table3] lr {lr} {name} ({r['strategy']} "
            f"{r['strategy_name']!r}): acc {r['acc']}, loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
            f"{r['ms_per_step']:.3f} ms/step after the first "
            f"({r['first_step_ms']:.1f} ms), peak memory "
            f"{r['peak_mem_bytes'] / 2**20:.1f} MiB, launches "
            f"{r['launches']}; simulated epoch {rep.per_worker_s:.4f} s, "
            f"${rep.cost_per_worker:.6f} a worker, ${rep.total_cost:.6f} "
            "in all")
    return runs


def table3_gates(runs):
    """The reference benchmark's Table 3 asserts; each arch's MLLess
    kernel launches."""
    sim = {n: r["sim_epoch_s"] for n, r in runs.items()}
    check(sim["gpu"] <= min(sim.values()) + 1e-9,
          f"gpu's simulated epoch {sim['gpu']} is not the smallest: {sim}")
    check(sim["spirt"] < sim["allreduce"],
          f"spirt {sim['spirt']} s not below allreduce {sim['allreduce']} s")
    for name, r in runs.items():
        check(all(map(math.isfinite, r["losses"])),
              f"{name}: loss not finite {r['losses']}")
        final = r["acc"][TABLE3_STEPS]
        check(final > 0.25, f"{name}: final accuracy {final} <= 0.25")
        want = mlless_launches(TABLE3_STEPS) if name in MLLESS_ARCHS else {}
        want = {k: n for k, n in want.items() if n}
        check(r["launches"] == want, f"{name}: launches {r['launches']}, "
              f"expected {want}")


def qsr_rank(rank, init, out_dir, lr):
    """One of the quantized sync's ranks: one sync of this rank's
    full-width MobileNet gradient on CUDA tensors (gloo carries the int8
    rows and fp32 scales as they are) and on CPU copies of them; its
    distance to the exact mean; its time; then ``scatterreduce_q8``
    trains ``BEYOND_STEPS`` steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.core import losses
    from repro_torch.launch.train import _rank_device
    from repro_torch.models import build_cnn, reference_leaves
    from repro_torch.serverless import get_arch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _rank_device("cuda", rank)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=QSR_RANKS)
    res = {}
    data = table3_data(dev)
    imgs, labels = data[:2]
    model = build_cnn(get_config("mobilenet-cifar"), device=dev, seed=0)
    B = TABLE3_BATCH // QSR_RANKS
    idx = np.random.RandomState(0).randint(0, 4096, TABLE3_BATCH)
    idx = torch.from_numpy(idx[rank * B:(rank + 1) * B]).to(dev)
    loss = losses.classification_loss(model(imgs[idx]), labels[idx])
    grads = list(torch.autograd.grad(loss, reference_leaves(model)))
    qsr = get_arch("scatterreduce_q8").make_strategy()
    out, resid, _ = qsr.sync(grads, qsr.init_state(grads))
    cpu = [g.cpu() for g in grads]
    out_h, resid_h, _ = qsr.sync(cpu, qsr.init_state(cpu))
    res["cuda_equals_cpu"] = all(
        torch.equal(a.cpu(), b) for a, b in zip(out + resid,
                                               out_h + resid_h))
    exact = torch.cat([g.reshape(-1) for g in grads]).float()
    dist.all_reduce(exact)
    exact = exact / QSR_RANKS
    got = torch.cat([o.reshape(-1) for o in out])
    res["rel_l2"] = float(torch.linalg.norm(got - exact)
                          / torch.linalg.norm(exact))
    res["n"] = exact.numel()
    res["leaves"] = len(grads)
    res["sync_ms"] = time_ms(
        lambda: qsr.sync(grads, qsr.init_state(grads)), reps=5, warmup=1)
    res["train"] = table3_train("scatterreduce_q8", BEYOND_STEPS, lr, data,
                                rank, QSR_RANKS)
    res["backend"] = dist.get_backend()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def qsr_phase(lr):
    """QuantizedScatterReduce on ``QSR_RANKS`` gloo ranks sharing the
    card; returns rank 0's record."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_qsr_")
    t0 = time.perf_counter()
    spawn_ranks(
        qsr_rank, args=("file://" + os.path.join(out_dir, "pg"), out_dir,
                        lr), nprocs=QSR_RANKS)
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(QSR_RANKS)]
    r0 = ranks[0]
    log(f"[table3] quantized sync, {QSR_RANKS} {r0['backend']} ranks on one "
        f"card ({time.perf_counter() - t0:.1f} s): int8 all_to_all_single "
        "and all_gather on CUDA tensors")
    for rank, r in enumerate(ranks):
        check(r["cuda_equals_cpu"], f"rank {rank}: the sync on CUDA tensors "
              "differs from the same sync on CPU tensors")
        check(r["rel_l2"] < QSR_TOL, f"rank {rank}: relative L2 to the "
              f"exact mean {r['rel_l2']:.4e} >= {QSR_TOL}")
        t = r["train"]
        check(all(map(math.isfinite, t["losses"]))
              and t["losses"][-1] < t["losses"][0],
              f"rank {rank}: scatterreduce_q8 losses {t['losses']}")
        check(t["losses"] == r0["train"]["losses"],
              f"rank {rank}: losses differ from rank 0's")
    t = r0["train"]
    log(f"[table3] one sync of the full-width MobileNet gradient "
        f"({r0['n']:,} floats, {r0['leaves']} leaves) on CUDA tensors "
        f"equals the same sync on CPU tensors bit for bit on every rank; "
        f"relative L2 to the exact mean {max(r['rel_l2'] for r in ranks):.4e}"
        f" (tol {QSR_TOL}); {r0['sync_ms']:.3f} ms a sync on rank 0; "
        f"scatterreduce_q8 over {QSR_RANKS} ranks, {BEYOND_STEPS} steps: "
        f"losses {[round(l, 4) for l in t['losses']]}, "
        f"{t['ms_per_step']:.3f} ms/step")
    return r0


def table3_phase(init_method):
    """The paper's experiment on the card: each paper arch's strategy
    from ``get_arch(name).make_strategy()`` (never ``get_strategy(name)``:
    the arch ``allreduce`` is the parameter server) trains full-width
    MobileNet, with its simulated epoch, under the Table 3 gates; each
    beyond-paper arch with a strategy trains 5 steps; then the quantized
    sync across ranks.  Returns the phase's record."""
    import torch.distributed as dist
    from repro_torch.serverless import get_arch, list_archs, paper_archs
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=init_method, rank=0,
                            world_size=1)
    try:
        data = table3_data("cuda")
        paper = table3_paper(TABLE3_LR, data)
        reference_lr = None if TABLE3_LR == TABLE3_REF_LR else \
            table3_paper(TABLE3_REF_LR, data)
        table3_gates(paper)
        beyond = {}
        for name in list_archs():
            if name in paper_archs() or get_arch(name).jax_strategy is None:
                continue
            r = table3_train(name, BEYOND_STEPS, TABLE3_LR, data)
            want = {k: n for k, n in mlless_launches(BEYOND_STEPS).items()
                    if n} if name in MLLESS_ARCHS else {}
            check(all(map(math.isfinite, r["losses"]))
                  and r["losses"][-1] < r["losses"][0],
                  f"{name}: losses {r['losses']}")
            check(r["launches"] == want, f"{name}: launches "
                  f"{r['launches']}, expected {want}")
            log(f"[table3] {name} ({r['strategy']} {r['strategy_name']!r}),"
                f" {BEYOND_STEPS} steps: losses "
                f"{[round(l, 4) for l in r['losses']]}, "
                f"{r['ms_per_step']:.3f} ms/step, launches {r['launches']}")
            beyond[name] = r
        check(len(beyond) == 7, f"beyond-paper archs trained: {list(beyond)}")
    finally:
        dist.destroy_process_group()
    qsr = qsr_phase(TABLE3_LR)
    sim = {n: r["sim_epoch_s"] for n, r in paper.items()}
    log(f"[table3] gates held: gpu's simulated epoch {sim['gpu']:.4f} s is "
        f"the smallest, spirt {sim['spirt']:.4f} s < allreduce "
        f"{sim['allreduce']:.4f} s, every final accuracy > 0.25 "
        f"({ {n: r['acc'][TABLE3_STEPS] for n, r in paper.items()} }); "
        f"phase took {time.perf_counter() - t0:.1f} s")
    return {"lr": TABLE3_LR, "reference_lr": TABLE3_REF_LR,
            "paper": paper, "reference_lr_record": reference_lr,
            "beyond": beyond, "quantized_sync": qsr}


# ---------------------------------------------------------------------------
# the LM slice: fused AdamW and sliding-window attention
# ---------------------------------------------------------------------------
LM_ARCH = "smollm-135m"
ADAMW_SRC = "src/repro_torch/kernels/csrc/fused_adamw.cu"
SWA_SRC = "src/repro_torch/kernels/csrc/swa_attention.cu"
SWA_TC_SRC = "src/repro_torch/kernels/csrc/swa_attention_tc.cu"
SWA_TF32_SRC = "src/repro_torch/kernels/csrc/swa_attention_tf32.cu"
LM_BATCH, LM_SEQ, LM_STEPS = 16, 128, 30
# the entry point's default lr 3e-3 makes full-width SmolLM's loss rise
# over 30 steps (11.21 -> 11.58, first and last five); 1e-3 trains (PERF.md)
LM_LR = 1e-3
LONG_BATCH, LONG_SEQ, LONG_STEPS = 8, 2048, 5
ADAMW_KW = dict(lr=LM_LR, b1=0.9, b2=0.95, eps=1e-8, wd=0.0)
# (label, B, S, H, KV, hd, window, causal): SmolLM's train and long
# shapes, Gemma-3's windows, a ragged S, Phi-3's and Qwen1.5's head_dims
SWA_PARITY = [
    ("smollm train", 16, 128, 9, 3, 64, None, True),
    ("smollm long", 8, 2048, 9, 3, 64, None, True),
    ("window 64", 2, 2048, 9, 3, 64, 64, True),
    ("window 1024", 2, 2048, 8, 4, 64, 1024, True),
    ("ragged S 1000", 2, 1000, 9, 3, 64, None, True),
    ("ragged S 1000, window 100", 2, 1000, 9, 3, 64, 100, True),
    ("hd 96", 1, 1024, 32, 32, 96, None, True),
    ("hd 128", 1, 1024, 20, 20, 128, 256, True),
]
# bf16: each side rounds its fp32 result once, so one bf16 step apart
SWA_BF16_RTOL, SWA_BF16_ATOL, SWA_F32_ATOL = 2 ** -7, 1e-5, 2e-5
# the kernel step against the kernel-free step, bf16 model: losses agree
# to within half a bf16 step of the loss (2^-9 relative)
LM_STEP_RTOL = 2 ** -9
# SmolLM's depth on every multi-rank path (the resilience phase's
# trainers; the sharding and tp phases' train runs, the dry-runs they are
# held against and their serving on every mesh), cut 30 -> 10 for the
# time limit: their time is gloo traffic and snapshots, which grow with
# the parameters (92,024,640 at 10 layers, 162,826,560 at 30).  The width
# stays; the lm and serve phases train and serve all 30 layers.
MULTI_RANK_LAYERS = 10


def multi_rank_config():
    """Full-width SmolLM cut to ``MULTI_RANK_LAYERS``, registered under a
    name of its own for the harnesses that build an arch by name."""
    import dataclasses
    from repro_torch.configs.base import get_config, register
    return register(dataclasses.replace(
        get_config(LM_ARCH), name=f"{LM_ARCH}-{MULTI_RANK_LAYERS}l",
        n_layers=MULTI_RANK_LAYERS))


def lm_leaves(dev):
    """Full-width SmolLM-135M leaves (bf16) with bf16 gradients and fp32
    moments, seeded."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer
    model = transformer.Model(get_config(LM_ARCH))
    shapes = [tuple(p.shape) for p in transformer.reference_leaves(model)]
    del model
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for shape in shapes:
        n = math.prod(shape)
        out.append((torch.randn(n, generator=gen, device=dev).bfloat16(),
                    torch.randn(n, generator=gen, device=dev) * 1e-3,
                    torch.rand(n, generator=gen, device=dev) * 1e-6,
                    torch.randn(n, generator=gen, device=dev).bfloat16()
                    * 0.02))
    return shapes, out


def attention_pairs(S, window, causal):
    """Unmasked (query, key) pairs of one head."""
    if not causal:
        return S * S if window is None else sum(
            min(S, i + window) - max(0, i - window + 1) for i in range(S))
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def lm_kernel_parity(dev):
    """Fused AdamW bit-exact against its plain version at every SmolLM
    leaf (bf16 p with bf16 and fp32 g) and at ragged n; attention against
    its plain version at ``SWA_PARITY`` in bf16 and fp32; the gradient
    through ``ops.swa_attention`` against plain autograd.  Returns the
    largest errors."""
    import torch
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.optim import bias_corrections
    shapes, leaves = lm_leaves(dev)
    c1, c2 = bias_corrections(0.9, 0.95, 3, dev)
    cases = 0
    for g, m, v, p in leaves + [(g[:n], m[:n], v[:n], p[:n]) for n in
                                (1, 7, 257, 100_003)
                                for g, m, v, p in leaves[:1]]:
        for gg in (g, g.float()):
            mm, vv = m.clone(), v.clone()
            want = ref.fused_adamw_flat(gg, mm, vv, p, c1, c2, **ADAMW_KW)
            u, _, _ = fa.fused_adamw_flat(gg, mm, vv, p, c1, c2, **ADAMW_KW)
            torch.cuda.synchronize()
            check(torch.equal(u, want[0].to(p.dtype))
                  and torch.equal(mm, want[1]) and torch.equal(vv, want[2]),
                  f"fused_adamw_flat differs from its plain version at "
                  f"n={p.numel()} g {gg.dtype}")
            cases += 1
    del leaves
    log(f"[lm] fused_adamw_flat bit-exact against its plain version in "
        f"{cases} cases: the 12 SmolLM-135M leaves {shapes} and n = 1, 7, "
        "257, 100003, bf16 parameters with bf16 and fp32 gradients")
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, B, S, H, KV, hd, window, causal in SWA_PARITY:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       .to(dtype) for n in (H, KV, KV))
            before = dict(swa.LAUNCHES)
            got = swa.swa_attention_fwd(q, k, v, window=window,
                                        causal=causal)
            want = ref.swa_attention(q, k, v, window=window, causal=causal)
            torch.cuda.synchronize()
            check_attention_route(
                {name: n - before[name]
                 for name, n in swa.LAUNCHES.items()}, 1,
                str(dtype).split(".")[-1], f"swa_attention_fwd at {label}",
                hd)
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= SWA_F32_ATOL).all())
            else:
                ok = bool((diff <= SWA_BF16_ATOL + SWA_BF16_RTOL
                           * want.float().abs()).all())
            check(ok and bool(torch.isfinite(got).all()),
                  f"swa_attention_fwd at {label} {dtype}: max abs diff "
                  f"{float(diff.max()):.3e}")
            err[dtype] = max(err[dtype], float(diff.max()))
            del q, k, v, got, want, diff
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = [torch.randn(2, 512, n, 64, generator=gen, device=dev)
           for n in (9, 3, 3)]
    a = [t.clone().requires_grad_() for t in qkv]
    b = [t.clone().requires_grad_() for t in qkv]
    torch.sum(torch.tanh(ops.swa_attention(*a, window=128))).backward()
    torch.sum(torch.tanh(ref.swa_attention(*b, window=128))).backward()
    gerr = max(float((x.grad - y.grad).abs().max()) for x, y in zip(a, b))
    check(gerr <= 1e-4, f"swa_attention gradient differs by {gerr:.3e}")
    # bf16, the main path's dtype (the forward on the tensor-core kernel):
    # held within one bf16 step (2^-7) of the largest plain fp32 gradient
    # of the same values, as in tests/test_torch_cuda.py; plain bf16
    # autograd is measured beside it as the witness of rounding alone.
    grads = {}
    for name, fn, dtype in (("kernel", ops.swa_attention, torch.bfloat16),
                            ("plain_bf16", ref.swa_attention, torch.bfloat16),
                            ("plain_fp32", ref.swa_attention, torch.float32)):
        x = [t.bfloat16().to(dtype).requires_grad_() for t in qkv]
        before = swa.LAUNCHES["swa_attention_fwd_wgmma"]
        torch.sum(torch.tanh(fn(*x, window=128).float())).backward()
        check(swa.LAUNCHES["swa_attention_fwd_wgmma"] - before
              == (name == "kernel"), f"swa_attention {name}: wrong route")
        grads[name] = [t.grad.float() for t in x]
    scale = max(float(g.abs().max()) for g in grads["plain_fp32"])
    gerr16, witness = (max(float((x - y).abs().max()) / scale for x, y in
                           zip(grads[name], grads["plain_fp32"]))
                       for name in ("kernel", "plain_bf16"))
    check(gerr16 <= 2 ** -7, f"swa_attention bf16 gradient differs by "
          f"{gerr16:.3e} of the largest fp32 gradient")
    log(f"[lm] swa_attention_fwd (bf16 on the wgmma kernel, fp32 on the "
        f"3xTF32 kernel) against its plain version at "
        f"{len(SWA_PARITY)} shapes x bf16/fp32 "
        f"({', '.join(c[0] for c in SWA_PARITY)}): max abs err fp32 "
        f"{err[torch.float32]:.3e} (tol {SWA_F32_ATOL}), bf16 "
        f"{err[torch.bfloat16]:.3e} (tol one bf16 step, {SWA_BF16_RTOL} "
        f"relative + {SWA_BF16_ATOL}); gradient through ops.swa_attention "
        f"(B 2, S 512, window 128) fp32 max abs err {gerr:.3e} (tol 1e-4), "
        f"bf16 max abs err {gerr16:.3e} of the largest fp32 gradient "
        f"{scale:.3e} (tol 2^-7; plain bf16 autograd lands {witness:.3e} "
        f"of it away)")
    return {"fused_adamw_flat": 0.0, "swa_attention_fwd": err[torch.float32],
            "swa_attention_fwd_bf16": err[torch.bfloat16],
            "swa_attention_grad": gerr, "swa_attention_grad_bf16": gerr16,
            "swa_attention_grad_bf16_plain": witness}


def sass_counts(stem, kernel, ops):
    """{mangled name: {op: count}} for each instantiation of ``kernel`` in
    the library built from ``csrc/<stem>.cu`` (``cuobjdump -sass``)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "",
                                                     "bin", "cuobjdump")
    lib = _build._build_all()[stem]
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    counts = {}
    for body in res.stdout.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel in name:
            counts[name] = {op: body.count(op) for op in ops}
    return counts


# the tensor-core kernel's instantiations: hd padded to a multiple of 64
SWA_TC_WIDTHS = {64: "hd 32/64", 128: "hd 96/128", 192: "hd 160",
                 256: "hd 256", 320: "hd 320"}


def swa_sass():
    """The tensor-core attention kernel's SASS: counts of wgmma (HGMMA),
    TMA loads (UTMALDG) and stores (UTMASTG) in each instantiation of
    ``swa_wgmma_kernel``; fails unless there is one for every width of
    ``SWA_TC_WIDTHS`` and every one has wgmma and TMA loads."""
    counts = {}
    for name, c in sass_counts("swa_attention_tc", "swa_wgmma_kernel",
                               ("HGMMA", "UTMALDG", "UTMASTG")).items():
        width = [w for w in SWA_TC_WIDTHS if f"ILi{w}E" in name]
        check(len(width) == 1, f"unexpected instantiation {name}")
        counts[SWA_TC_WIDTHS[width[0]]] = c
    check(len(counts) == len(SWA_TC_WIDTHS)
          and all(c["HGMMA"] and c["UTMALDG"] for c in counts.values()),
          f"swa_wgmma_kernel SASS lacks an instantiation, wgmma or TMA: "
          f"{counts}")
    log(f"[lm] swa_wgmma_kernel SASS (cuobjdump -sass): {counts}")
    return counts


def cuda_core_attention(q, k, v, window):
    """The CUDA-core attention kernel (causal) in q's dtype, launched
    through its C entry point to time it beside the routes that replaced
    it (bf16 on wgmma, fp32 on 3xTF32, at every head_dim) in one run;
    counts nothing."""
    import math
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as swa
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lib = _build._library("swa_attention", swa._SIGNATURES)
    err = lib.rt_swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        swa._DTYPES[q.dtype], B, S, H, k.shape[2], hd,
        0 if window is None else window, 1, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core attention kernel failed: CUDA error {err}")
    return out


def lm_kernel_times(dev):
    """Each LM kernel at the slice's shapes: the wrapper called back to
    back (CUDA events), the same calls replayed as a CUDA graph, the
    plain version and one PyTorch call computing the same function.
    Bounds count each input read once and each output written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.optim import bias_corrections
    out = {}
    # ---- fused AdamW: one SmolLM step, 12 leaves, bf16 p and g ----
    shapes, leaves = lm_leaves(dev)
    c1, c2 = bias_corrections(0.9, 0.95, 3, dev)
    n_params = sum(p.numel() for _, _, _, p in leaves)
    nbytes = sum(p.numel() * (g.element_size() + 8 + 2 * p.element_size()
                              + 8) for g, _, _, p in leaves)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, \
        15 * n_params / H100_FP32_FLOP_PER_S

    def kernel_step():
        for g, m, v, p in leaves:
            fa.fused_adamw_flat(g, m, v, p, c1, c2, **ADAMW_KW)

    def plain_step():
        for g, m, v, p in leaves:
            ref.fused_adamw_flat(g, m, v, p, c1, c2, **ADAMW_KW)

    r = dict(ms=time_ms(kernel_step, reps=20),
             graph_ms=graphed_ms(kernel_step),
             plain_ms=time_ms(plain_step, reps=5))
    params32 = [p.float().requires_grad_() for _, _, _, p in leaves]
    for q, (g, _, _, _) in zip(params32, leaves):
        q.grad = g.float()
    lib = torch.optim.AdamW(params32, lr=LM_LR, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.0, fused=True)
    r["library_ms"] = time_ms(lib.step, reps=20)
    del params32, lib
    r.update(bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=nbytes, params=n_params,
             shapes=f"one SmolLM-135M step: {len(leaves)} leaves, "
                    f"{n_params:,} bf16 parameters, bf16 gradients, fp32 "
                    "moments",
             library="torch.optim.AdamW(fused=True).step() on fp32 copies "
                     "of the 12 leaves (fp32 p, g, m, v)")
    out["fused_adamw_flat"] = r
    log(f"[lm] fused_adamw_flat, one SmolLM step (12 launches): kernel "
        f"{r['ms']:.4f} ms (as a CUDA graph {r['graph_ms']:.4f} ms), plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
        f"({r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
        f"{nbytes / 1e9:.3f} GB)")
    del leaves
    # ---- attention: SmolLM long and train shapes, and window 1024 ----
    gen = torch.Generator(device=dev).manual_seed(6)
    for key, (B, S, H, KV, hd, window) in (
            ("long", (LONG_BATCH, LONG_SEQ, 9, 3, 64, None)),
            ("train", (LM_BATCH, LM_SEQ, 9, 3, 64, None)),
            ("long_window_1024", (LONG_BATCH, LONG_SEQ, 9, 3, 64, 1024))):
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   .bfloat16() for n in (H, KV, KV))
        flops = 4 * B * H * hd * attention_pairs(S, window, True)
        nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
        t_ops, t_bytes = flops / H100_BF16_FLOP_PER_S, nbytes / H100_BYTES_PER_S
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            library = ("F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), (B, H, S, hd)")
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            library = ("F.scaled_dot_product_attention(attn_mask=band, "
                       "enable_gqa=True), (B, H, S, hd)")
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        fn = lambda: swa.swa_attention_fwd(q, k, v, window=window)  # noqa: E731
        old = lambda: cuda_core_attention(q, k, v, window)  # noqa: E731
        r = dict(ms=time_ms(fn, reps=10), graph_ms=graphed_ms(fn),
                 cuda_core_ms=time_ms(old, reps=10),
                 cuda_core_graph_ms=graphed_ms(old),
                 plain_ms=time_ms(lambda: ref.swa_attention(
                     q, k, v, window=window), reps=3, warmup=1),
                 library_ms=time_ms(lib_fn, reps=10), library=library,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 bytes_ms=t_bytes * 1e3, flops=flops, bytes=nbytes,
                 shapes=f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, "
                        f"{hd}) bf16, causal, window {window}")
        out[f"swa_attention_fwd/{key}"] = r
        log(f"[lm] swa_attention_fwd {r['shapes']}: tensor-core kernel "
            f"{r['ms']:.4f} ms (as a CUDA graph {r['graph_ms']:.4f} ms; its "
            f"design's three products {1.5 * t_ops * 1e3:.4f} ms at "
            f"peak), CUDA-core kernel {r['cuda_core_ms']:.4f} ms (graph "
            f"{r['cuda_core_graph_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({library}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP at bf16 tensor-core peak; "
            f"{r['bytes_ms']:.4f} ms for {nbytes / 1e6:.1f} MB; fp32 "
            f"CUDA-core bound {flops / H100_FP32_FLOP_PER_S * 1e3:.4f} ms)")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# kernel 8's fp32 route at the shapes its callers give it: SmolLM's long
# shape, Gemma-3's local and global layers, and the families' head_dims
# 128, 160 and 256 at their prefill shapes (``FAM_ATTENTION``)
# (label, B, S, H, KV, hd, window), causal
SWA_F32_SHAPES = [
    ("smollm long", LONG_BATCH, LONG_SEQ, 9, 3, 64, None),
    ("gemma3 local", 1, 2048, 8, 4, 320, 1024),
    ("gemma3 global", 1, 2048, 8, 4, 320, None),
    ("mixtral-8x7b", 4, 512, 32, 8, 128, 4096),
    ("recurrentgemma-2b", 4, 512, 10, 1, 256, 2048),
    ("pixtral-12b", 1, 1536, 32, 8, 160, None),
]


def tf32_tile_exps(B, S, H, KV, hd, window):
    """exp2s the fp32 kernel takes (``swa_attention_tf32.cu``): one a row
    and key of every kv tile it visits (64 rows a q tile of 64 / G
    queries, each row's taken by both warps of its pair at hd 320; 64 keys
    a tile at hd <= 64, 32 at 96 and 128, 16 at 160 and 256, 32 at 320),
    causal."""
    keys = 64 if hd <= 64 else 32 if hd <= 128 else 16 if hd <= 256 else 32
    rows = 64 if hd <= 256 else 128
    bq = 64 // (H // KV)
    tiles = 0
    for q0 in range(0, S, bq):
        lo = max(q0 - window + 1, 0) if window else 0
        tiles += (min(q0 + bq, S) - 1) // keys - lo // keys + 1
    return B * KV * rows * keys * tiles


def swa_f32_times(dev):
    """Kernel 8's fp32 route at ``SWA_F32_SHAPES``: the wrapper (the
    3xTF32 kernel) called back to back and as a CUDA graph, against the
    plain version; at hd 320, the route the CUDA-core kernel kept
    longest, that kernel (through its C entry point) too, as graphs in
    turns (old, new, new, old); the bound at the fp32 peak outside the
    tensor cores, the design's own least time (three TF32 products at the
    TF32 peak) and its exp2 count; ``F.scaled_dot_product_attention`` in
    fp32 with TF32 off, as the default dispatcher runs it and under each
    backend, with its error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for label, B, S, H, KV, hd, window in SWA_F32_SHAPES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   for n in (H, KV, KV))
        flops = 4 * B * H * hd * attention_pairs(S, window, True)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        t_ops, t_bytes = flops / H100_FP32_FLOP_PER_S, \
            nbytes / H100_BYTES_PER_S
        design = 3 * flops / H100_TF32_FLOP_PER_S
        want = ref.swa_attention(q, k, v, window=window)
        fn = lambda: swa.swa_attention_fwd(q, k, v, window=window)  # noqa: E731
        err = float((fn() - want).abs().max())
        check(err <= SWA_F32_ATOL, f"[lm] fp32 attention at {label}: max "
              f"abs err {err:.3e} (the 3xTF32 kernel)")
        r = {}
        if hd == 320:
            old = lambda: cuda_core_attention(q, k, v, window)  # noqa: E731
            err_old = float((old() - want).abs().max())
            check(err_old <= SWA_F32_ATOL, f"[lm] fp32 attention at "
                  f"{label}: max abs err {err_old:.3e} (CUDA cores)")
            turns = [graphed_ms(old), graphed_ms(fn), graphed_ms(fn),
                     graphed_ms(old)]
            r.update(graph_ms=min(turns[1:3]),
                     cuda_core_ms=time_ms(old, reps=10),
                     cuda_core_graph_ms=min(turns[0], turns[3]),
                     turns=turns, cuda_core_max_abs_err=err_old)
            before = (f"; CUDA-core kernel {r['cuda_core_ms']:.4f} ms "
                      f"(graph {r['cuda_core_graph_ms']:.4f} ms; err "
                      f"{err_old:.3e}; graphs in turns old, new, new, old "
                      f"{[round(t, 4) for t in turns]})")
        else:
            r["graph_ms"] = graphed_ms(fn)
            before = ""
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
        if window is None or window >= S:
            mask = dict(is_causal=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = dict(attn_mask=(pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - window))
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **mask)
        expanded = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, ke, ve, **mask)
        backend, _ = sdpa_backend_of(lib_fn)
        r.update(ms=time_ms(fn, reps=10),
                 plain_ms=time_ms(lambda: ref.swa_attention(
                     q, k, v, window=window), reps=2, warmup=1),
                 max_abs_err=err, library_ms=time_ms(lib_fn, reps=10),
                 library_max_abs_err=float((lib_fn().transpose(1, 2)
                                            - want).abs().max()),
                 library_backend=backend,
                 sdpa_backends=sdpa_by_backend(lib_fn, expanded, want),
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 design_ms=design * 1e3, flops=flops, bytes=nbytes,
                 exps=tf32_tile_exps(B, S, H, KV, hd, window),
                 shapes=f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, "
                        f"{hd}) fp32, causal, window {window}")
        out[label] = r
        backends = "; ".join(
            f"{name} " + (f"{b['gqa_ms']:.4f} ms" if "gqa_ms" in b else
                          f"refuses GQA ({b['gqa_refused']})"
                          + (f", expanded k/v {b['expanded_ms']:.4f} ms"
                             if "expanded_ms" in b else
                             f", expanded refused too "
                             f"({b.get('expanded_refused')})"))
            + (f" (err {b['max_abs_err']:.3e})" if "max_abs_err" in b
               else "")
            for name, b in r["sdpa_backends"].items())
        log(f"[lm] fp32 swa_attention_fwd {label} {r['shapes']}: the "
            f"3xTF32 kernel {r['ms']:.4f} ms (graph {r['graph_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['graph_ms']:.3f} of the fp32 bound, "
            f"{r['design_ms'] / r['graph_ms']:.3f} of the design's least "
            f"time {r['design_ms']:.4f} ms; err {err:.3e}){before}, "
            f"plain {r['plain_ms']:.4f} ms, SDPA default {backend} "
            f"{r['library_ms']:.4f} ms (err {r['library_max_abs_err']:.3e})"
            f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP at the fp32 peak; {nbytes / 1e6:.1f} "
            f"MB), exp2s {r['exps'] / 1e6:.1f} M")
        log(f"[lm] fp32 SDPA by backend, {label}: {backends}")
        del q, k, v, qt, kt, vt, ke, ve, want
        torch.cuda.empty_cache()
    return out


def swa_tf32_sass():
    """The fp32 attention kernel's SASS: counts of TF32 mma (HMMA) and
    local-memory stores (STL, a spill) in each instantiation of
    ``swa_tf32_kernel``; fails unless there is one for every head_dim of
    ``TF32_HEAD_DIMS``, each with HMMA and no STL."""
    from repro_torch.kernels import swa_attention as swa
    counts = {}
    for name, c in sass_counts("swa_attention_tf32", "swa_tf32_kernel",
                               ("HMMA", "STL")).items():
        hd = [h for h in swa.TF32_HEAD_DIMS if f"ILi{h}E" in name]
        check(len(hd) == 1, f"unexpected instantiation {name}")
        counts[f"hd {hd[0]}"] = c
    check(len(counts) == len(swa.TF32_HEAD_DIMS)
          and all(c["HMMA"] and not c["STL"] for c in counts.values()),
          f"swa_tf32_kernel SASS lacks an instantiation or HMMA, or "
          f"spills: {counts}")
    log(f"[lm] swa_tf32_kernel SASS (cuobjdump -sass): {counts}")
    return counts


def _lm_counters():
    from repro_torch.kernels import block_significance as bs
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.kernels import wkv6
    return fa.LAUNCHES, swa.LAUNCHES, wkv6.LAUNCHES, bs.LAUNCHES


def lm_launches():
    return {k: n for counts in _lm_counters() for k, n in counts.items()}


def reset_lm_launches():
    for counts in _lm_counters():
        for k in counts:
            counts[k] = 0


def expected_lm_launches(layers, steps, microbatches=1, mlless=False):
    """Per ``steps`` of SmolLM at ``layers``: fused AdamW once per leaf
    (12, each block leaf stacked over the layers); the attention kernel
    once per layer in the forward and once more in the backward's
    recompute of each checkpointed layer, per microbatch (2 x layers x
    Ke), every launch on the tensor-core route (the model is bf16);
    MLLess's segmented filter once over all 12 leaves."""
    n = {"fused_adamw_flat": 12 * steps,
         "swa_attention_fwd": 2 * layers * microbatches * steps,
         "wkv6_chunked": 0, "wkv6_chunked_tc": 0,
         **mlless_launches(steps if mlless else 0)}
    n["swa_attention_fwd_wgmma"] = n["swa_attention_fwd"]   # bf16: all
    n["swa_attention_fwd_tf32"] = 0
    return n


def lm_train_phase(init_method):
    """The LM entry point on full-width SmolLM-135M over a one-rank NCCL
    group; the main path's launch counts; the kernel step against the
    kernel-free step; reduced logits on the card against the CPU; SPIRT
    and MLLess; the long sequence."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import train

    layers = get_config(LM_ARCH).n_layers
    dist.init_process_group("nccl", init_method=init_method, rank=0,
                            world_size=1)
    try:
        reset_lm_launches()
        res = train(arch=LM_ARCH, batch=LM_BATCH, seq=LM_SEQ, steps=LM_STEPS,
                    lr=LM_LR, fused_optimizer=True, device="cuda",
                    log_every=10, log=log)
        launches = lm_launches()
        losses = res["losses"]
        check(all(math.isfinite(l) for l in losses), f"loss not finite: "
              f"{losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last < first, f"loss did not fall: first five {first:.4f}, "
              f"last five {last:.4f}")
        want = expected_lm_launches(layers, LM_STEPS)
        check(launches == want, f"launches {launches}, expected {want}")
        log(f"[lm] {LM_ARCH} full width ({res['params']:,} parameters), "
            f"bf16, batch {LM_BATCH} x seq {LM_SEQ}, allreduce, fused AdamW "
            f"lr {LM_LR}, {LM_STEPS} steps: loss {first:.4f} (first five) "
            f"-> {last:.4f} (last five); launches {launches} = "
            f"{ {k: n // LM_STEPS for k, n in launches.items()} } a step; "
            f"{res['ms_per_step']:.3f} ms/step after the first "
            f"({res['first_step_ms']:.1f} ms); peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
        lm_kernel_vs_plain_step()
        lm_default_lr_record()
        lm_cuda_vs_cpu()
        runs = {"allreduce": res}
        for strategy, k_mb, mlless in (("spirt", 4, False),
                                       ("mlless", 1, True)):
            reset_lm_launches()
            r = train(arch=LM_ARCH, strategy=strategy, batch=LM_BATCH,
                      seq=LM_SEQ, steps=3, lr=LM_LR, fused_optimizer=True,
                      device="cuda", log=None)
            got = lm_launches()
            want = expected_lm_launches(layers, 3, k_mb, mlless)
            check(got == want, f"{strategy}: launches {got}, expected {want}")
            check(all(map(math.isfinite, r["losses"])),
                  f"{strategy}: loss not finite {r['losses']}")
            log(f"[lm] {LM_ARCH} {strategy}: losses "
                f"{[round(l, 4) for l in r['losses']]}, "
                f"{r['ms_per_step']:.3f} ms/step; launches {got}"
                + (f"; significant_fraction "
                   f"{r['metrics']['significant_fraction']:.4f}"
                   if mlless else ""))
            runs[strategy] = r
        reset_lm_launches()
        torch.cuda.empty_cache()
        r = train(arch=LM_ARCH, batch=LONG_BATCH, seq=LONG_SEQ,
                  steps=LONG_STEPS, lr=LM_LR, fused_optimizer=True,
                  device="cuda", log=None)
        got = lm_launches()
        want = expected_lm_launches(layers, LONG_STEPS)
        check(got == want, f"long: launches {got}, expected {want}")
        check(all(map(math.isfinite, r["losses"])),
              f"long: loss not finite {r['losses']}")
        log(f"[lm] {LM_ARCH} batch {LONG_BATCH} x seq {LONG_SEQ}, "
            f"{LONG_STEPS} steps: losses {[round(l, 4) for l in r['losses']]}"
            f", {r['ms_per_step']:.3f} ms/step after the first "
            f"({r['first_step_ms']:.1f} ms), peak memory "
            f"{r['peak_mem_bytes'] / 2**30:.2f} GiB")
        runs["long"] = r
        torch.cuda.empty_cache()
        return launches, runs
    finally:
        dist.destroy_process_group()


def lm_kernel_vs_plain_step(steps=2):
    """Two steps of full-width SmolLM-135M (bf16, batch 16 x seq 128) from
    the same weights and batches: through the kernels (attention kernel,
    fused AdamW) and through the kernel-free path (the chunked flash
    attention, the plain AdamW).  The attention kernel keeps p in fp32
    where the chunked path rounds it to bf16, so bf16 activations differ
    by a rounding here and there: losses must agree to half a bf16 step
    (2^-9 relative)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.models import build_model
    cfg = get_config(LM_ARCH)
    it = lm_batches(token_stream(LM_BATCH * LM_SEQ * 8, cfg.vocab_size,
                                 seed=11), LM_BATCH, LM_SEQ, seed=11)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
               for _ in range(steps)]
    runs = {}
    for kernels in (True, False):
        model = build_model(cfg, use_kernel=kernels, device="cuda", seed=3)
        ts = build_train_step(model, optim.adamw(LM_LR, use_fused=kernels),
                              get_strategy("allreduce"))
        state = ts.init_state()
        losses = [float(ts.step_fn(state, b)[1]["loss"]) for b in batches]
        runs[kernels] = (losses, [p.detach().float() for p in
                                  state["params"]])
        del model, ts, state
    (lk, pk), (lp, pp) = runs[True], runs[False]
    dloss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    dparam = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    moved = sum(int(((a - b).abs() > 0).sum()) for a, b in zip(pk, pp))
    total = sum(a.numel() for a in pk)
    check(dloss <= LM_STEP_RTOL, f"kernel step vs kernel-free step: loss "
          f"rel diff {dloss:.3e} > {LM_STEP_RTOL:.3e}")
    log(f"[lm] {steps} steps through the kernels vs the kernel-free path "
        f"(bf16): losses {lk} vs {lp} (rel diff {dloss:.3e}, tol 2^-9 = "
        f"{LM_STEP_RTOL:.3e}); parameters max abs diff {dparam:.3e}, "
        f"{moved:,} of {total:,} differ (AdamW's early steps move each "
        "element by ~lr whatever the gradient's size)")


def lm_default_lr_record(lr=3e-3):
    """A record, not a gate: the entry point's default lr (the
    reference's 3e-3) on the same 30 steps, through the kernels and
    through the kernel-free path (chunked flash attention, plain AdamW),
    so a rise of the loss there can be told from a fault of the kernels.
    Both must stay finite."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.models import build_model
    cfg = get_config(LM_ARCH)
    for kernels in (True, False):
        it = lm_batches(token_stream(LM_BATCH * LM_SEQ * 64, cfg.vocab_size),
                        LM_BATCH, LM_SEQ)
        ts = build_train_step(build_model(cfg, use_kernel=kernels,
                                          device="cuda"),
                              optim.adamw(lr, use_fused=kernels),
                              get_strategy("allreduce"))
        state = ts.init_state()
        losses = []
        for _ in range(LM_STEPS):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in next(it).items()}
            losses.append(float(ts.step_fn(state, batch)[1]["loss"]))
        check(all(map(math.isfinite, losses)), f"lr {lr}: loss not finite")
        log(f"[lm] lr {lr} ({'kernels' if kernels else 'kernel-free path'})"
            f", the train phase's {LM_STEPS} steps: loss "
            f"{sum(losses[:5]) / 5:.4f} (first five) -> "
            f"{sum(losses[-5:]) / 5:.4f} (last five); every third "
            f"{[round(l, 3) for l in losses[::3]]}")
        del ts, state
    torch.cuda.empty_cache()


def lm_cuda_vs_cpu():
    """Reduced SmolLM logits through the attention kernel on the card
    against the same model on the CPU (plain attention), same weights and
    tokens, fp32 with TF32 off: 1e-4."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import build_model
    cfg = get_config(LM_ARCH).reduced()
    b = next(lm_batches(token_stream(4 * 128 * 8, cfg.vocab_size), 4, 128))
    tokens = torch.from_numpy(b["tokens"])
    before = swa.LAUNCHES["swa_attention_fwd"]
    model = build_model(cfg, use_kernel=True, device="cpu", seed=1)
    with torch.no_grad():
        gpu, _ = copy.deepcopy(model).cuda()({"tokens": tokens.cuda()})
        cpu, _ = model({"tokens": tokens})
    check(swa.LAUNCHES["swa_attention_fwd"] == before + cfg.n_layers,
          "the card's forward did not go through the kernel")
    gpu = gpu.cpu()
    check(gpu.shape == (4, 128, 512) and bool(torch.isfinite(gpu).all()),
          f"logits {tuple(gpu.shape)} not finite")
    err = float((gpu - cpu).abs().max())
    check(err <= 1e-4, f"cuda vs cpu logits differ by {err:.3e}")
    log(f"[lm] reduced SmolLM logits (fp32), card (kernel) vs CPU (plain): "
        f"max abs diff {err:.3e} (tol 1e-4)")


def profile_report(prof, steps, wall_ms, label, names=(), top=10):
    """Device time by kernel from a ``torch.profiler`` window over
    ``steps`` steps against the host clock's ``wall_ms`` a step: busy and
    idle share, the ``top`` largest kernels, and the time and launches a
    step of the kernels whose names hold one of ``names``."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "kernels_per_step": sum(e.count for e in kernels) / steps}
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return out
    out["idle_share"] = 1 - busy_ms / wall_ms
    log(f"[profile] {label} under the profiler: {wall_ms:.3f} ms/step on "
        f"the host clock, device busy {busy_ms:.3f} ms/step, idle share "
        f"{out['idle_share']:.3f}; device kernels per step "
        f"{out['kernels_per_step']:.0f}")
    largest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    out["top"] = [(e.key[:90], e.self_device_time_total / 1e3 / steps,
                   e.count / steps) for e in largest]
    for name, ms, n in out["top"]:
        log(f"[profile]   {ms:8.3f} ms/step {n:6.0f}/step  {name}")
    for name in names:
        mine = [e for e in kernels if name in e.key]
        us = sum(e.self_device_time_total for e in mine) / steps
        n = sum(e.count for e in mine) / steps
        out[name] = {"us_per_step": us, "launches_per_step": n}
        log(f"[profile]   {name}: {us:.1f} us/step of device time in "
            f"{n:.0f} launches ({us / max(n, 1):.2f} us each)")
    return out


def lm_phase():
    """The LM slice; returns its entries of the kernels line."""
    import torch
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    err = lm_kernel_parity(dev)
    sass = swa_sass()
    tf32_sass = swa_tf32_sass()
    times = lm_kernel_times(dev)
    t1 = time.perf_counter()
    f32 = swa_f32_times(dev)
    log(f"[lm] fp32 attention times took {time.perf_counter() - t1:.1f} s")
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="chip_smoke_lm_"),
                                    "pg")
    launches, runs = lm_train_phase(init)
    log(f"[lm] phase took {time.perf_counter() - t0:.1f} s")
    main_path = (f"{LM_ARCH} train, batch {LM_BATCH} x seq {LM_SEQ}, "
                 f"{LM_STEPS} steps")
    long = times["swa_attention_fwd/long"]
    return [
        {"name": "fused_adamw_flat", "route": "cuda", "source": ADAMW_SRC,
         "replaces": "src/repro/kernels/fused_adamw.py:34",
         "launches": launches["fused_adamw_flat"], "launches_run": main_path,
         "max_abs_err": err["fused_adamw_flat"],
         **times["fused_adamw_flat"]},
        {"name": "swa_attention_fwd", "route": "cuda", "source": SWA_TC_SRC,
         "fp32_source": SWA_TF32_SRC,
         "replaces": "src/repro/kernels/swa_attention.py:81",
         "launches": launches["swa_attention_fwd"],
         "launches_wgmma": launches["swa_attention_fwd_wgmma"],
         "launches_run": main_path,
         "max_abs_err": err["swa_attention_fwd_bf16"],
         "max_abs_err_fp32": err["swa_attention_fwd"],
         "grad_max_abs_err": err["swa_attention_grad"],
         "grad_bf16_rel_err": err["swa_attention_grad_bf16"],
         "grad_bf16_plain_rel_err": err["swa_attention_grad_bf16_plain"],
         **long,
         "train_shape": times["swa_attention_fwd/train"],
         "window_1024": times["swa_attention_fwd/long_window_1024"],
         "sass": sass},
        # the fp32 route; its launches come from the serve phase's fp32
        # engine run (``main``)
        {"name": "swa_attention_fwd_tf32", "route": "cuda",
         "source": SWA_TF32_SRC, "cuda_core_source": SWA_SRC,
         "replaces": "src/repro/kernels/swa_attention.py:81",
         "launches": None,
         "max_abs_err": max([err["swa_attention_fwd"]]
                            + [r["max_abs_err"] for r in f32.values()]),
         **{key: f32["smollm long"][key] for key in (
             "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "design_ms", "shapes")},
         "library": "F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True) in fp32, TF32 off, (B, H, S, hd)",
         "at_shapes": f32, "sass": tf32_sass},
    ]


# ---------------------------------------------------------------------------
# Gemma-3: attention at head_dim 320, on the tensor-core kernel
# ---------------------------------------------------------------------------
GEMMA_ARCH = "gemma3-4b"
# one 5:1 local/global group at full width (d_model 2560, 8 / 4 heads of
# 320, d_ff 10240, vocab 262144): the depth is cut from 34 to 6 layers only
# because this script runs under a time limit
GEMMA_LAYERS, GEMMA_PARAMS, GEMMA_LEAVES = 6, 1_774_748_160, 51
GEMMA_BATCH, GEMMA_SEQ, GEMMA_STEPS = 1, 2048, 10
# the entry point's default lr 3e-3 makes the loss jump (12.97 -> 23.68 at
# the eighth step) and 1e-3 spikes (17.21 at the eighth); 3e-4 trains
# (PERF.md)
GEMMA_LR = 3e-4
# (label, B, S, H, KV, hd, window, causal): Gemma-3's local and global
# layers at its train shape, a ragged S, pixtral-12b's hd 160 (32 heads on
# 8) and recurrentgemma-2b's hd 256 (10 heads on 1), non-causal at 256
GEMMA_PARITY = [
    ("gemma3 local", 1, 2048, 8, 4, 320, 1024, True),
    ("gemma3 global", 1, 2048, 8, 4, 320, None, True),
    ("hd 320 ragged S 1000, window 100", 2, 1000, 8, 4, 320, 100, True),
    ("hd 160", 1, 512, 32, 8, 160, None, True),
    ("hd 256", 1, 512, 10, 1, 256, 128, True),
    ("hd 256 full", 2, 300, 4, 2, 256, None, False),
]


def gemma_kernel_parity(dev):
    """Attention against its plain version at ``GEMMA_PARITY`` in bf16
    (every launch on the wgmma route) and fp32 (every launch on the 3xTF32
    route), at the gates of ``lm_kernel_parity``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(14)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, B, S, H, KV, hd, window, causal in GEMMA_PARITY:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       .to(dtype) for n in (H, KV, KV))
            before = dict(swa.LAUNCHES)
            got = swa.swa_attention_fwd(q, k, v, window=window,
                                        causal=causal)
            want = ref.swa_attention(q, k, v, window=window, causal=causal)
            torch.cuda.synchronize()
            check_attention_route(
                {name: n - before[name]
                 for name, n in swa.LAUNCHES.items()}, 1,
                str(dtype).split(".")[-1], f"swa_attention_fwd at {label}",
                hd)
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= SWA_F32_ATOL).all())
            else:
                ok = bool((diff <= SWA_BF16_ATOL + SWA_BF16_RTOL
                           * want.float().abs()).all())
            check(ok and bool(torch.isfinite(got).all()),
                  f"swa_attention_fwd at {label} {dtype}: max abs diff "
                  f"{float(diff.max()):.3e}")
            err[dtype] = max(err[dtype], float(diff.max()))
            del q, k, v, got, want, diff
    log(f"[gemma] swa_attention_fwd (bf16 on the wgmma kernel, fp32 on "
        f"the 3xTF32 kernel) against its plain version at "
        f"{len(GEMMA_PARITY)} shapes x bf16/fp32 "
        f"({', '.join(c[0] for c in GEMMA_PARITY)}): max abs err fp32 "
        f"{err[torch.float32]:.3e} (tol {SWA_F32_ATOL}), bf16 "
        f"{err[torch.bfloat16]:.3e} (tol one bf16 step)")
    return {"max_abs_err": err[torch.bfloat16],
            "max_abs_err_fp32": err[torch.float32]}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_backend_of(fn):
    """The backend the default dispatcher picks for ``fn``, read from the
    names of the device kernels that two calls run (``torch.profiler``,
    after a call outside it; a window that records no kernel is taken
    again once), and those names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    text = " ".join(names).lower()
    for backend, marks in (("CUDNN_ATTENTION", ("cudnn",)),
                           ("EFFICIENT_ATTENTION", ("fmha", "cutlass",
                                                    "efficient")),
                           ("FLASH_ATTENTION", ("flash",))):
        if any(m in text for m in marks):
            return backend, names
    return ("MATH" if names else "not measured"), names


def sdpa_by_backend(lib_fn, expanded_fn, want=None):
    """``F.scaled_dot_product_attention`` under each backend of
    ``SDPA_BACKENDS`` (``torch.nn.attention.sdpa_kernel``): its time as
    called, or why it refuses; where it refuses the GQA call, the same
    call on k and v expanded to every q head.  With ``want`` (B, S, H, hd)
    also its largest error against it."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in SDPA_BACKENDS:
        r = {}
        for form, fn in (("gqa", lib_fn), ("expanded", expanded_fn)):
            try:
                with sdpa_kernel(getattr(SDPBackend, name)), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    r[f"{form}_ms"] = time_ms(fn, reps=10)
                    if want is not None:
                        r["max_abs_err"] = float(
                            (fn().transpose(1, 2).float() - want.float())
                            .abs().max())
                break
            except RuntimeError as e:
                r[f"{form}_refused"] = str(e).strip().splitlines()[0][:160]
        out[name] = r
    return out


def gemma_kernel_times(dev):
    """Attention at Gemma-3's train shape (B 1, S 2048, H 8, KV 4, hd 320,
    bf16), the local layers' window 1024 and the global layer's none: the
    wrapper (the tensor-core kernel) called back to back and as a CUDA
    graph, the CUDA-core kernel in bf16 (the route before it) in turns
    with it, the plain version, and ``F.scaled_dot_product_attention``:
    as the default dispatcher runs it (which backend, from its kernels'
    names) and under each backend."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(15)
    B, S, H, KV, hd = GEMMA_BATCH, GEMMA_SEQ, 8, 4, 320
    out = {}
    for key, window in (("local", 1024), ("global", None)):
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   .bfloat16() for n in (H, KV, KV))
        flops = 4 * B * H * hd * attention_pairs(S, window, True)
        nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
        t_ops, t_bytes = flops / H100_BF16_FLOP_PER_S, nbytes / H100_BYTES_PER_S
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
        if window is None:
            library = ("F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), (B, H, S, hd)")
            mask = dict(is_causal=True)
        else:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            library = ("F.scaled_dot_product_attention(attn_mask=band, "
                       "enable_gqa=True), (B, H, S, hd)")
            mask = dict(attn_mask=band)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **mask)
        expanded = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, ke, ve, **mask)
        fn = lambda: swa.swa_attention_fwd(q, k, v, window=window)  # noqa: E731
        old = lambda: cuda_core_attention(q, k, v, window)  # noqa: E731
        turns = [graphed_ms(old), graphed_ms(fn), graphed_ms(fn),
                 graphed_ms(old)]
        backend, names = sdpa_backend_of(lib_fn)
        r = dict(ms=time_ms(fn, reps=10), graph_ms=min(turns[1:3]),
                 cuda_core_graph_ms=min(turns[0], turns[3]), turns=turns,
                 cuda_core_ms=time_ms(old, reps=10),
                 plain_ms=time_ms(lambda: ref.swa_attention(
                     q, k, v, window=window), reps=3, warmup=1),
                 library_ms=time_ms(lib_fn, reps=10), library=library,
                 library_backend=backend,
                 library_kernels=[n[:90] for n in names[:4]],
                 sdpa_backends=sdpa_by_backend(lib_fn, expanded),
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 flops=flops, bytes=nbytes,
                 shapes=f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, "
                        f"{hd}) bf16, causal, window {window}")
        out[key] = r
        backends = "; ".join(
            f"{name} " + (f"{b['gqa_ms']:.4f} ms" if "gqa_ms" in b else
                          f"refuses GQA ({b['gqa_refused']})"
                          + (f", expanded k/v {b['expanded_ms']:.4f} ms"
                             if "expanded_ms" in b else
                             f", expanded refused too "
                             f"({b.get('expanded_refused')})"))
            for name, b in r["sdpa_backends"].items())
        log(f"[gemma] swa_attention_fwd {r['shapes']}: tensor-core kernel "
            f"{r['ms']:.4f} ms (as a CUDA graph {r['graph_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['graph_ms']:.3f} of the bound; its "
            f"design's three products {1.5 * t_ops * 1e3:.4f} ms at peak), "
            f"CUDA-core kernel {r['cuda_core_ms']:.4f} ms (graph "
            f"{r['cuda_core_graph_ms']:.4f} ms; graphs in turns old, new, "
            f"new, old: {[round(t, 4) for t in turns]}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({library}; the default dispatcher ran {backend}: "
            f"{r['library_kernels'][:2]}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {flops / 1e9:.2f} GFLOP at the bf16 "
            f"tensor-core peak; {nbytes / 1e6:.1f} MB; fp32 CUDA-core bound "
            f"{flops / H100_FP32_FLOP_PER_S * 1e3:.4f} ms)")
        log(f"[gemma] SDPA by backend, {key}: {backends}")
        del q, k, v, qt, kt, vt, ke, ve
    torch.cuda.empty_cache()
    return out


# Gemma-3's causal global layer is one wave of 128 blocks (8 heads x 16 q
# tiles of 128) on 132 SMs, q tile i carrying 4 (i + 1) kv tiles of 32
# keys: the longest 64, the mean 34.  Beside it, grids that each hold one
# block length: the longest blocks (one head: 16 blocks on 16 SMs, the
# longest 64 kv tiles), a mean block (one head at S 1088: the longest 34
# kv tiles) and 128 blocks all as long as the longest (not causal).
# (label, H, KV, S, causal)
GEMMA_BALANCE = [
    ("global layer", 8, 4, 2048, True),
    ("longest blocks alone", 1, 1, 2048, True),
    ("a mean block alone", 1, 1, 1088, True),
    ("128 longest blocks", 8, 4, 2048, False),
]


def gemma_balance(dev):
    """The one-wave balance of Gemma-3's global layer: each grid of
    ``GEMMA_BALANCE`` on the tensor-core kernel as a CUDA graph, in turns
    (forward through the list, then back), the least of its two turns."""
    import torch
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(16)
    fns = []
    for label, H, KV, S, causal in GEMMA_BALANCE:
        q, k, v = (torch.randn(1, S, n, 320, generator=gen, device=dev)
                   .bfloat16() for n in (H, KV, KV))
        fns.append(lambda q=q, k=k, v=v, causal=causal:
                   swa.swa_attention_fwd(q, k, v, causal=causal))
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    turns = [[] for _ in fns]
    for i in order:
        turns[i].append(graphed_ms(fns[i]))
    out = {label: {"graph_ms": min(t), "turns": t,
                   "shape": f"q (1, {S}, {H}, 320), k/v (1, {S}, {KV}, 320) "
                            f"bf16, {'causal' if causal else 'not causal'}"}
           for (label, H, KV, S, causal), t in zip(GEMMA_BALANCE, turns)}
    full = out["global layer"]["graph_ms"]
    for label, r in out.items():
        log(f"[gemma] balance, {label} ({r['shape']}): {r['graph_ms']:.4f} "
            f"ms as a graph ({r['graph_ms'] / full:.3f} of the global "
            f"layer; turns {[round(t, 4) for t in r['turns']]})")
    del fns
    torch.cuda.empty_cache()
    return out


def gemma_config():
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(GEMMA_ARCH), n_layers=GEMMA_LAYERS)


def expected_gemma_launches(steps):
    """Per step: fused AdamW once per leaf (51); attention once per layer
    in the forward and once more in the backward's recompute of the
    checkpointed block (2 x 6), all on the wgmma route (bf16, hd 320),
    none on the fp32 route."""
    return {"fused_adamw_flat": GEMMA_LEAVES * steps,
            "swa_attention_fwd": 2 * GEMMA_LAYERS * steps,
            "swa_attention_fwd_wgmma": 2 * GEMMA_LAYERS * steps,
            "swa_attention_fwd_tf32": 0, "wkv6_chunked": 0,
            "wkv6_chunked_tc": 0, **mlless_launches(0)}


def _gemma_steps(kernels, lr, steps, seed):
    """Losses of ``steps`` seeded batches through the kernels (attention
    kernel, fused AdamW) or through the kernel-free path (chunked flash
    attention, plain AdamW), from the weights of ``seed``."""
    import torch
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.models import build_model
    cfg = gemma_config()
    it = lm_batches(token_stream(GEMMA_BATCH * GEMMA_SEQ * 8, cfg.vocab_size,
                                 seed=11), GEMMA_BATCH, GEMMA_SEQ, seed=11)
    ts = build_train_step(build_model(cfg, use_kernel=kernels,
                                      device="cuda", seed=seed),
                          optim.adamw(lr, use_fused=kernels),
                          get_strategy("allreduce"))
    state = ts.init_state()
    losses = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        losses.append(float(ts.step_fn(state, batch)[1]["loss"]))
    del ts, state
    torch.cuda.empty_cache()
    return losses


def gemma_train_phase(init_method):
    """The LM entry point on full-width gemma3-4b cut to 6 layers over a
    one-rank NCCL group, with the main path's launch counts and peak
    memory; two steps against the kernel-free path; the default lr."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import train
    dist.init_process_group("nccl", init_method=init_method, rank=0,
                            world_size=1)
    try:
        torch.cuda.empty_cache()
        reset_lm_launches()
        res = train(arch=GEMMA_ARCH, n_layers=GEMMA_LAYERS,
                    batch=GEMMA_BATCH, seq=GEMMA_SEQ, steps=GEMMA_STEPS,
                    lr=GEMMA_LR, fused_optimizer=True, device="cuda",
                    log_every=5, log=log)
        launches = lm_launches()
        losses = res["losses"]
        check(res["params"] == GEMMA_PARAMS, f"params {res['params']}")
        check(all(math.isfinite(l) for l in losses), f"loss not finite: "
              f"{losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last < first, f"loss did not fall: first five {first:.4f}, "
              f"last five {last:.4f}")
        want = expected_gemma_launches(GEMMA_STEPS)
        check(launches == want, f"launches {launches}, expected {want}")
        log(f"[gemma] {GEMMA_ARCH} full width cut to {GEMMA_LAYERS} layers "
            f"({res['params']:,} parameters), bf16, batch {GEMMA_BATCH} x "
            f"seq {GEMMA_SEQ}, allreduce, fused AdamW lr {GEMMA_LR}, "
            f"{GEMMA_STEPS} steps: loss {first:.4f} (first five) -> "
            f"{last:.4f} (last five), {[round(l, 4) for l in losses]}; "
            f"launches {launches} = "
            f"{ {k: n // GEMMA_STEPS for k, n in launches.items()} } a step; "
            f"{res['ms_per_step']:.3f} ms/step after the first "
            f"({res['first_step_ms']:.1f} ms); peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        reset_lm_launches()
        lk = _gemma_steps(True, GEMMA_LR, 2, seed=3)
        got = lm_launches()
        check(got == expected_gemma_launches(2), f"kernel steps: launches "
              f"{got}, expected {expected_gemma_launches(2)}")
        lp = _gemma_steps(False, GEMMA_LR, 2, seed=3)
        dloss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        check(dloss <= LM_STEP_RTOL, f"gemma kernel step vs kernel-free "
              f"step: loss rel diff {dloss:.3e} > {LM_STEP_RTOL:.3e}")
        log(f"[gemma] 2 steps through the kernels vs the kernel-free path "
            f"(bf16, lr {GEMMA_LR}): losses {lk} vs {lp} (rel diff "
            f"{dloss:.3e}, tol 2^-9 = {LM_STEP_RTOL:.3e})")
        # a record, not a gate: the entry point's default lr and SmolLM's
        others = {}
        for lr in (3e-3, 1e-3):
            others[lr] = _gemma_steps(True, lr, GEMMA_STEPS, seed=0)
            log(f"[gemma] lr {lr} (kernels), {GEMMA_STEPS} steps: losses "
                f"{[round(l, 4) for l in others[lr]]}")
        return launches, {"train": res, "kernel_vs_plain_rel": dloss,
                          "other_lr_losses": others}
    finally:
        dist.destroy_process_group()


def gemma_phase():
    """Kernel 8 at head_dims 160, 256 and 320 and Gemma-3's training;
    returns the numbers for the kernels line's attention entry."""
    import torch
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    err = gemma_kernel_parity(dev)
    times = gemma_kernel_times(dev)
    balance = gemma_balance(dev)
    init = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_gemma_"), "pg")
    launches, runs = gemma_train_phase(init)
    log(f"[gemma] phase took {time.perf_counter() - t0:.1f} s")
    res = runs["train"]
    return {"launches": launches["swa_attention_fwd"],
            "launches_wgmma": launches["swa_attention_fwd_wgmma"],
            "launches_run": f"{GEMMA_ARCH} ({GEMMA_LAYERS} of 34 layers) "
                            f"train, batch {GEMMA_BATCH} x seq {GEMMA_SEQ}, "
                            f"{GEMMA_STEPS} steps",
            **err, **times["local"], "global": times["global"],
            "balance": balance,
            "ms_per_step": res["ms_per_step"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "losses": res["losses"],
            "kernel_vs_plain_rel": runs["kernel_vs_plain_rel"],
            "other_lr_losses": runs["other_lr_losses"]}


# ---------------------------------------------------------------------------
# the RWKV slice: the WKV recurrence
# ---------------------------------------------------------------------------
RWKV_ARCH = "rwkv6-7b"
WKV_SRC = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV_TC_SRC = "src/repro_torch/kernels/csrc/wkv6_tc.cu"
# AdamW's training state (12 B a parameter) of the full 32 layers, 84 GB,
# does not fit one 80 GB card: training runs full width at 4 layers
RWKV_LAYERS, RWKV_PARAMS, RWKV_FULL_PARAMS = 4, 1_344_425_984, 6_997_282_816
RWKV_BATCH, RWKV_SEQ, RWKV_STEPS = 4, 512, 20
# the entry point's default lr 3e-3 makes the loss of full-width rwkv6-7b
# rise (PERF.md); 3e-4 trains
RWKV_LR = 3e-4
FULL_BATCH, FULL_SEQ = 4, 2048
# (label, B, T, H, N, chunk, mu) with logw = -exp(N(mu, 0.5)): every N
# and chunk the port calls, a ragged T (ops.wkv6 halves 64 to 32), chunk
# 1, B*H from 1 to 256, decays from the reference test's to strong ones
# (mu 3: the Pallas body's unmasked exp overflows)
WKV_PARITY = [
    ("N 16, chunk 16", 2, 64, 3, 16, 16, -2.0),
    ("N 32, T 96, chunk 32", 2, 96, 8, 32, 32, -2.0),
    ("T 37, chunk 1", 1, 37, 2, 32, 1, -2.0),
    ("B*H 1", 1, 128, 1, 64, 64, -2.0),
    ("rwkv6-7b train shape", 4, 512, 64, 64, 64, -2.0),
    ("mild decay", 1, 256, 4, 64, 64, 0.0),
    ("strong decay, mu 1.5", 1, 64, 2, 32, 64, 1.5),
    ("strong decay, mu 3", 2, 128, 8, 64, 64, 3.0),
]
# fp32: the reference test's 1e-4; bf16: 5e-2 plus one bf16 step (each
# side rounds its fp32 result once)
WKV_F32_ATOL, WKV_BF16_ATOL, WKV_BF16_RTOL = 1e-4, 5e-2, 2 ** -7
# the full-depth forward through the kernel against the kernel-free
# forward, relative L2 of the logits.  Beside it a witness: the kernel-free
# forward at chunk 64 against the same at its own chunk 128, the same
# arithmetic summed in another order, so its spread is what a change of
# the WKV outputs' last bits alone does to the logits through 32 layers.
# fp32: the paths stay close, 1e-3.  bf16: the casts after the fp32 WKV
# outputs round some elements the other way in every layer and the
# random-init model carries that on; the kernel path may differ from the
# kernel-free one by at most twice the witness's spread.
FULL_REL_TOL = {"float32": 1e-3}
FULL_WITNESS_CHUNK, FULL_WITNESS_FACTOR = 64, 2.0


def wkv_operands(B, T, H, N, mu, dtype, dev, gen):
    import torch
    r, k, v = (torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5
               for _ in range(3))
    lw = -torch.exp(torch.randn(B, T, H, N, generator=gen, device=dev) * 0.5
                    + mu)
    u = torch.randn(H, N, generator=gen, device=dev) * 0.5
    return [t.to(dtype) for t in (r, k, v, lw, u)]


def wkv_work(B, T, H, N):
    """(operations, of them exp) that the recurrence needs, per token and
    head: the state update diag(w) S + k^T v (3 N^2), r S (2 N^2), the
    bonus (r . (u * k)) v and the sum (5 N), and w = exp(logw) (N exp).
    This is the work of the function, whatever form computes it: the bound
    counts this."""
    n = B * T * H
    return n * (5 * N * N + 6 * N), n * N


def wkv_kernel_work(B, T, H, N, c):
    """(operations, of them exp) of one kernel call as the chunked form
    does it: per chunk and (b, h) the cumsum, the lower triangle of a with
    the bonus on its diagonal, the decayed r and k, y and the state
    update.  More than ``wkv_work`` (the pairwise decays of each chunk's
    lower triangle); printed beside the bound, not used for it."""
    P = c * (c - 1) // 2
    ops = (5 * P * N + 4 * c * N * N + 2 * (P + c) * N + N * N + 9 * c * N
           + N)
    exps = P * N + 2 * c * N + N
    n = B * H * (T // c)
    return n * ops, n * exps


def wkv_tc_work(B, T, H, N, c, sub=16):
    """(tensor-core FLOP, CUDA-core operations, exps) of one call of the
    tensor-core kernel's two-level form (``csrc/wkv6_tc.cu``).  Products,
    counted as issued, three TF32 products each (3xTF32): the cross
    blocks (rho D kap^T) and the block-triangular a V every chunk, the S
    product and the state update every chunk but the first and the last.
    CUDA cores: the scan, w, rho and kap (4 an element), each diagonal
    block's pairs s < t (a multiply-add and the running product, 2 N a
    pair) and its bonus (2 N a row).  Exps: w, rho, kap (3 an element) and
    the per-column factors.  Printed beside the bound, not used for it."""
    n, ns = T // c, c // sub
    np_ = ns * (ns - 1) // 2
    mac = ((n - 1) * 2 * c * N * N + n * (ns * (ns + 1) // 2 + np_)
           * sub * sub * N)
    core = n * (4 * c * N + ns * (sub * (sub - 1) // 2 + sub) * 2 * N)
    exps = n * (3 * c * N + (2 * (ns - 1) + (ns - 1) * (ns - 2) // 2 + 1)
                * N)
    return B * H * 3 * 2 * mac, B * H * core, B * H * exps


def wkv_cuda_core(ins, c):
    """The CUDA-core WKV kernel (``csrc/wkv6.cu``) at a shape the wrapper
    sends to the tensor cores: launched through its C entry point only to
    hold and time the two routes in one run; counts nothing."""
    import torch
    from repro_torch.kernels import _build, wkv6
    r = ins[0]
    B, T, H, N = r.shape
    y = torch.empty_like(r)
    lib = _build._library("wkv6", wkv6._SIGNATURES)
    err = lib.rt_wkv6_chunked(*(t.data_ptr() for t in ins), y.data_ptr(),
                              wkv6._DTYPES[r.dtype], B, T, H, N, c,
                              torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core WKV kernel failed: CUDA error {err}")
    return y


def wkv_sass():
    """The tensor-core WKV kernel's SASS: its count of TF32 mma (HMMA)
    in each instantiation of ``wkv6_tc_kernel`` (dtype, N, c); fails
    unless every one of the 12 has them."""
    counts = {name[name.index("wkv6_tc_kernel") + 15:name.index("EEEv")]:
              c["HMMA"] for name, c in sass_counts(
                  "wkv6_tc", "wkv6_tc_kernel", ("HMMA",)).items()}
    check(len(counts) == 12 and all(counts.values()),
          f"wkv6_tc_kernel SASS lacks tensor-core mma: {counts}")
    log(f"[rwkv] wkv6_tc_kernel SASS (cuobjdump -sass): HMMA in all "
        f"{len(counts)} instantiations, {min(counts.values())} to "
        f"{max(counts.values())} each")
    return counts


def rwkv_kernel_parity(dev):
    """Both WKV routes against the plain chunked twin (and the exact
    recurrence for T <= 128) at ``WKV_PARITY`` in fp32 and bf16: the
    wrapper, which takes the tensor-core kernel at N 32/64 with chunk
    16/32/64 (checked by its counter) and the CUDA-core kernel elsewhere,
    and at the tensor-core shapes the CUDA-core kernel too, through its C
    entry point; the tensor-core route also against its own twin
    ``ref.wkv6_subchunked``.  The gradient through ``ops.wkv6`` (the
    model's autograd Function) on the card against the same on the CPU.
    Returns the largest errors, per route."""
    import torch
    from repro_torch.kernels import ref, wkv6
    from repro_torch.models import rwkv6
    gen = torch.Generator(device=dev).manual_seed(7)
    keys = ("f32", "bf16", "strong", "exact")
    err = {route: dict.fromkeys(keys, 0.0) for route in ("tc", "cuda_core")}
    tc_cases = 0
    for label, B, T, H, N, c, mu in WKV_PARITY:
        tc = N in wkv6.TC_HEAD_DIMS and c in wkv6.TC_CHUNKS
        tc_cases += tc
        for dtype in (torch.float32, torch.bfloat16):
            ins = wkv_operands(B, T, H, N, mu, dtype, dev, gen)
            before = wkv6.LAUNCHES["wkv6_chunked_tc"]
            outs = {"tc" if tc else "cuda_core":
                    wkv6.wkv6_chunked(*ins, chunk=c)}
            check(wkv6.LAUNCHES["wkv6_chunked_tc"] - before == tc,
                  f"wkv6_chunked at {label}: the tensor-core route was "
                  f"{'not ' if tc else ''}taken")
            if tc:
                outs["cuda_core"] = wkv_cuda_core(ins, c)
            wants = {"twin": ref.wkv6_chunked(*ins, chunk=c)}
            if tc:
                wants["tc twin"] = ref.wkv6_subchunked(*ins, chunk=c)
            if T <= 128:
                wants["exact"] = ref.wkv6(*ins)
            torch.cuda.synchronize()
            for route, got in outs.items():
                check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                      f"wkv6_chunked ({route}) at {label} {dtype}: "
                      f"{got.dtype}, not finite or")
                for name, want in wants.items():
                    if name == "tc twin" and route != "tc":
                        continue
                    diff = (got.float() - want.float()).abs()
                    if dtype == torch.float32:
                        ok = bool((diff <= WKV_F32_ATOL).all())
                        key = "exact" if name == "exact" else (
                            "strong" if mu > 0 else "f32")
                    else:
                        ok = bool((diff <= WKV_BF16_ATOL + WKV_BF16_RTOL
                                   * want.float().abs()).all())
                        key = "bf16"
                    check(ok, f"wkv6_chunked ({route}) at {label} {dtype} "
                              f"vs {name}: max abs diff "
                              f"{float(diff.max()):.3e}")
                    err[route][key] = max(err[route][key],
                                          float(diff.max()))
            del ins, outs, wants
    ins = wkv_operands(2, 256, 4, 64, -1.0, torch.float32, dev, gen)
    gy = torch.randn(2, 256, 4, 64, generator=gen, device=dev)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.cpu().requires_grad_() for t in ins]
    before = wkv6.LAUNCHES["wkv6_chunked_tc"]
    rwkv6._WkvKernel.apply(*a).backward(gy)
    check(wkv6.LAUNCHES["wkv6_chunked_tc"] == before + 1,
          "the gradient's forward did not take the tensor-core route")
    rwkv6._WkvKernel.apply(*b).backward(gy.cpu())
    gerr = max(float((x.grad.cpu() - y.grad).abs().max())
               for x, y in zip(a, b))
    check(gerr <= 1e-4, f"wkv6 gradient, card vs CPU: {gerr:.3e}")
    err["grad"] = gerr
    n_cases = {"tensor-core": tc_cases, "CUDA-core": len(WKV_PARITY)}
    for route, e in (("tensor-core", err["tc"]),
                     ("CUDA-core", err["cuda_core"])):
        log(f"[rwkv] wkv6_chunked, {route} route, against its plain "
            f"chunked twin at {n_cases[route]} "
            f"shapes x fp32/bf16: max abs err fp32 {e['f32']:.3e}, strong "
            f"decay {e['strong']:.3e} (tol {WKV_F32_ATOL}), against the "
            f"exact recurrence (T <= 128) {e['exact']:.3e} (tol "
            f"{WKV_F32_ATOL}); bf16 {e['bf16']:.3e} (tol {WKV_BF16_ATOL} + "
            f"one bf16 step); no NaN")
    log(f"[rwkv] shapes ({'; '.join(c[0] for c in WKV_PARITY)}): "
        f"{tc_cases} on the tensor cores, the rest on the CUDA cores; "
        f"gradient through ops.wkv6 (B 2, T 256, H 4, N 64, tensor-core "
        f"forward), card vs CPU, max abs err {gerr:.3e} (tol 1e-4)")
    return err


def rwkv_kernel_times(dev):
    """The kernel at rwkv6-7b's train shape (B 4, T 512) and a long shape
    (B 4, T 2048), H 64, N 64, fp32 as the model calls it, chunk 64: the
    wrapper (the tensor-core route) called back to back and as a CUDA
    graph, the CUDA-core kernel on the same inputs in the same turns
    (before, tc, tc, before), the plain twins (chunked, and the
    two-level twin of the tensor-core kernel), and the bound (the larger
    of the bytes at the memory rate and the operations the recurrence
    needs, an exp counted as one, at the fp32 CUDA-core peak).  No one
    PyTorch call computes the recurrence."""
    import torch
    from repro_torch.kernels import ref, wkv6
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for key, B, T in (("long", 4, 2048), ("train", RWKV_BATCH, RWKV_SEQ)):
        ins = wkv_operands(B, T, 64, 64, -2.0, torch.float32, dev, gen)
        fn = lambda: wkv6.wkv6_chunked(*ins, chunk=64)  # noqa: E731
        core = lambda: wkv_cuda_core(ins, 64)  # noqa: E731
        turns = [(name, f, time_ms(f, reps=10), graphed_ms(f))
                 for name, f in (("cuda_core", core), ("tc", fn),
                                 ("tc", fn), ("cuda_core", core))]
        t = {name: (min(a for n, _, a, _ in turns if n == name),
                    min(g for n, _, _, g in turns if n == name))
             for name in ("tc", "cuda_core")}
        nbytes = sum(t_.numel() * 4 for t_ in ins) + ins[0].numel() * 4
        flops, exps = wkv_work(B, T, 64, 64)
        k_flops, k_exps = wkv_kernel_work(B, T, 64, 64, 64)
        tc_flops, tc_core, tc_exps = wkv_tc_work(B, T, 64, 64, 64)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOP_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        r = dict(ms=t["tc"][0], graph_ms=t["tc"][1],
                 turns_graph_ms=[round(g, 5) for _, _, _, g in turns],
                 cuda_core_ms=t["cuda_core"][0],
                 cuda_core_graph_ms=t["cuda_core"][1],
                 plain_ms=time_ms(lambda: ref.wkv6_chunked(*ins, chunk=64),
                                  reps=2, warmup=1),
                 plain_tc_twin_ms=time_ms(
                     lambda: ref.wkv6_subchunked(*ins, chunk=64), reps=2,
                     warmup=1),
                 library_ms=None,
                 library="none: no one PyTorch call computes the recurrence",
                 bound_ms=bound,
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3, bytes=nbytes,
                 flops=flops, exps=exps,
                 shapes=f"r, k, v, logw ({B}, {T}, 64, 64) fp32, u (64, 64),"
                        " chunk 64")
        out[key] = r
        log(f"[rwkv] wkv6_chunked {r['shapes']}: tensor-core kernel "
            f"{r['ms']:.4f} ms (as a CUDA graph {r['graph_ms']:.4f} ms, "
            f"{bound / r['graph_ms']:.3f} of the bound), CUDA-core kernel "
            f"{r['cuda_core_ms']:.4f} ms (graph {r['cuda_core_graph_ms']:.4f}"
            f" ms) in the same turns (graph ms, core/tc/tc/core: "
            f"{r['turns_graph_ms']}); plain {r['plain_ms']:.4f} ms, its "
            f"two-level twin {r['plain_tc_twin_ms']:.4f} ms; bound "
            f"{bound:.4f} ms ({r['bound_by']}: {nbytes / 1e6:.1f} MB "
            f"{t_bytes * 1e3:.4f} ms; the recurrence's {flops / 1e9:.2f} "
            f"GFLOP of which {exps / 1e9:.4f} G exp at the fp32 peak "
            f"{t_ops * 1e3:.4f} ms); the two-level form issues "
            f"{tc_flops / 1e9:.2f} GFLOP of 3xTF32 products "
            f"({tc_flops / H100_TF32_FLOP_PER_S * 1e3:.4f} ms at the TF32 "
            f"peak), "
            f"{tc_core / 1e9:.2f} G CUDA-core operations and "
            f"{tc_exps / 1e9:.4f} G exp; the CUDA-core kernel's chunked "
            f"form {k_flops / 1e9:.2f} GFLOP with {k_exps / 1e9:.3f} G exp")
        del ins
    torch.cuda.empty_cache()
    return out


def expected_rwkv_launches(steps, mlless=False):
    """Per step: fused AdamW once per leaf (17); the WKV kernel once per
    layer in the forward and once more in the backward's recompute of
    each checkpointed layer (2 x 4), every launch on the tensor-core route
    (N 64, chunk 64); MLLess's segmented filter once over all 17 leaves."""
    wkv = 2 * RWKV_LAYERS * steps
    return {"fused_adamw_flat": 17 * steps, "swa_attention_fwd": 0,
            "swa_attention_fwd_wgmma": 0, "swa_attention_fwd_tf32": 0,
            "wkv6_chunked": wkv,
            "wkv6_chunked_tc": wkv,
            **mlless_launches(steps if mlless else 0)}


def rwkv_config():
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_LAYERS)


def rwkv_train_phase(init_method):
    """The entry point on full-width rwkv6-7b cut to 4 layers over a
    one-rank NCCL group, with the main path's launch counts; two steps
    against the kernel-free path; MLLess; a profile."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import train

    dist.init_process_group("nccl", init_method=init_method, rank=0,
                            world_size=1)
    try:
        reset_lm_launches()
        res = train(arch=RWKV_ARCH, n_layers=RWKV_LAYERS, batch=RWKV_BATCH,
                    seq=RWKV_SEQ, steps=RWKV_STEPS, lr=RWKV_LR,
                    fused_optimizer=True, device="cuda", log_every=5,
                    log=log)
        launches = lm_launches()
        losses = res["losses"]
        check(res["params"] == RWKV_PARAMS, f"params {res['params']}")
        check(all(math.isfinite(l) for l in losses), f"loss not finite: "
              f"{losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last < first, f"loss did not fall: first five {first:.4f}, "
              f"last five {last:.4f}")
        want = expected_rwkv_launches(RWKV_STEPS)
        check(launches == want, f"launches {launches}, expected {want}")
        log(f"[rwkv] {RWKV_ARCH} full width cut to {RWKV_LAYERS} layers "
            f"({res['params']:,} parameters), bf16, batch {RWKV_BATCH} x seq "
            f"{RWKV_SEQ}, allreduce, fused AdamW lr {RWKV_LR}, {RWKV_STEPS} "
            f"steps: loss {first:.4f} (first five) -> {last:.4f} (last "
            f"five), every fifth {[round(l, 4) for l in losses[::5]]}; "
            f"launches {launches} = "
            f"{ {k: n // RWKV_STEPS for k, n in launches.items()} } a step; "
            f"{res['ms_per_step']:.3f} ms/step after the first "
            f"({res['first_step_ms']:.1f} ms); peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        rwkv_kernel_vs_plain_step()
        default_lr = rwkv_default_lr_record()
        reset_lm_launches()
        r = train(arch=RWKV_ARCH, n_layers=RWKV_LAYERS, strategy="mlless",
                  batch=RWKV_BATCH, seq=RWKV_SEQ, steps=2, lr=RWKV_LR,
                  fused_optimizer=True, device="cuda", log=None)
        got, want = lm_launches(), expected_rwkv_launches(2, mlless=True)
        check(got == want, f"mlless: launches {got}, expected {want}")
        check(all(map(math.isfinite, r["losses"])),
              f"mlless: loss not finite {r['losses']}")
        log(f"[rwkv] {RWKV_ARCH} mlless: losses "
            f"{[round(l, 4) for l in r['losses']]}, {r['ms_per_step']:.3f} "
            f"ms/step; launches {got}; significant_fraction "
            f"{r['metrics']['significant_fraction']:.4f}")
        return launches, {"allreduce": res, "mlless": r,
                          "default_lr": default_lr}
    finally:
        dist.destroy_process_group()


def _rwkv_steps(kernels, lr, batches, seed):
    """Losses of ``batches`` through the kernels (WKV kernel, fused AdamW)
    or through the kernel-free path (chunked WKV, plain AdamW)."""
    import torch
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.models import build_model
    ts = build_train_step(build_model(rwkv_config(), use_kernel=kernels,
                                      device="cuda", seed=seed),
                          optim.adamw(lr, use_fused=kernels),
                          get_strategy("allreduce"))
    state = ts.init_state()
    losses = [float(ts.step_fn(state, b)[1]["loss"]) for b in batches()]
    del ts, state
    torch.cuda.empty_cache()
    return losses


def _rwkv_batches(steps, seed):
    import torch
    from repro_torch.data import lm_batches, token_stream
    vocab = rwkv_config().vocab_size

    def gen():
        it = lm_batches(token_stream(RWKV_BATCH * RWKV_SEQ * 64, vocab,
                                     seed=seed), RWKV_BATCH, RWKV_SEQ,
                        seed=seed)
        for _ in range(steps):
            yield {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
    return gen


def rwkv_kernel_vs_plain_step(steps=2):
    """Two steps of the 4-layer model from the same weights and batches,
    through the kernels and through the kernel-free path: the fp32 WKV
    outputs differ in the last bits, so bf16 activations differ by a
    rounding here and there; losses must agree to half a bf16 step (2^-9
    relative)."""
    batches = _rwkv_batches(steps, seed=11)
    reset_lm_launches()
    lk = _rwkv_steps(True, RWKV_LR, batches, seed=3)
    got = lm_launches()
    want = expected_rwkv_launches(steps)
    check(got == want, f"kernel steps: launches {got}, expected {want}")
    lp = _rwkv_steps(False, RWKV_LR, batches, seed=3)
    dloss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    check(dloss <= LM_STEP_RTOL, f"rwkv kernel step vs kernel-free step: "
          f"loss rel diff {dloss:.3e} > {LM_STEP_RTOL:.3e}")
    log(f"[rwkv] {steps} steps through the kernels vs the kernel-free path "
        f"(bf16, lr {RWKV_LR}): losses {lk} vs {lp} (rel diff {dloss:.3e}, "
        f"tol 2^-9 = {LM_STEP_RTOL:.3e})")


class _WkvWatch:
    """Watches every call of the WKV wrapper while a run goes on (the model
    looks the wrapper up at each call): the first call with an input that
    is not finite, and the first whose inputs are all finite and whose
    output is not, each with its inputs kept.  A training step calls it
    twice a layer (the forward and the recompute of the checkpointed
    layer)."""

    NAMES = ("r", "k", "v", "logw", "u")

    def __init__(self, calls_per_step):
        from repro_torch.kernels import wkv6
        self.module, self.inner = wkv6, wkv6.wkv6_chunked
        self.per_step, self.calls = calls_per_step, 0
        self.bad_input = self.bad_output = None

    def __enter__(self):
        self.module.wkv6_chunked = self
        return self

    def __exit__(self, *exc):
        self.module.wkv6_chunked = self.inner

    def __call__(self, *ins, chunk=64):
        import torch
        y = self.inner(*ins, chunk=chunk)
        call, self.calls = self.calls, self.calls + 1
        bad = [n for n, t in zip(self.NAMES, ins)
               if not bool(torch.isfinite(t).all())]
        where = {"call": call, "step": call // self.per_step}
        if bad and self.bad_input is None:
            self.bad_input = {**where, "chunk": chunk, "not_finite": bad,
                              "logw_neg_inf": bool(torch.isneginf(
                                  ins[3]).any()),
                              "inputs": [t.detach().clone() for t in ins]}
        if (not bad and self.bad_output is None
                and not bool(torch.isfinite(y).all())):
            self.bad_output = {**where, "chunk": chunk,
                               "inputs": [t.detach().clone() for t in ins]}
        return y


def wkv_routes_on(ins, chunk):
    """Every form of WKV on one set of inputs: the tensor-core route (the
    wrapper), the CUDA-core kernel, the plain chunked twin and the exact
    recurrence; for each, the count of outputs that are not finite.  With
    the inputs' extremes: the most negative logw, the most negative sum of
    logw over one chunk (-inf where fp32 overflows, as every chunked form's
    cumsum does), and the largest |r|, |k|, |v|, |u|."""
    import torch
    from repro_torch.kernels import ref, wkv6
    r, k, v, logw, u = ins
    B, T, H, N = r.shape
    outs = {"tensor_core": wkv6.wkv6_chunked(*ins, chunk=chunk),
            "cuda_core": wkv_cuda_core(ins, chunk),
            "plain_chunked": ref.wkv6_chunked(*ins, chunk=chunk),
            "exact": ref.wkv6(*ins)}
    torch.cuda.synchronize()
    sums = logw.float().reshape(B, T // chunk, chunk, H, N).sum(2)
    return {"not_finite": {name: int((~torch.isfinite(y)).sum())
                           for name, y in outs.items()},
            "outputs": r.numel(),
            "logw_min": float(logw.min()), "chunk_sum_min": float(sums.min()),
            **{f"max_abs_{n}": float(t.abs().max())
               for n, t in zip(("r", "k", "v", "u"), (r, k, v, u))}}


def rwkv_default_lr_record(lr=3e-3):
    """A record, not a gate: the entry point's default lr on the train
    phase's steps, through the kernels and through the kernel-free path,
    so a rise of the loss there can be told from a fault of the kernels.
    The record names the first step whose loss is not finite.  On the
    kernel path every WKV call is watched (``_WkvWatch``); every form of
    WKV is run (``wkv_routes_on``) on the inputs of the first call with an
    input that is not finite and of the first that turns finite inputs
    into an output that is not, to name the forms that give NaN there.
    Returns what was found."""
    batches = _rwkv_batches(RWKV_STEPS, seed=0)
    out = {}
    for kernels in (True, False):
        if kernels:
            with _WkvWatch(2 * RWKV_LAYERS) as watch:
                losses = _rwkv_steps(kernels, lr, batches, seed=0)
        else:
            losses = _rwkv_steps(kernels, lr, batches, seed=0)
        bad = [i for i, l in enumerate(losses) if not math.isfinite(l)]
        path = "kernels" if kernels else "kernel-free path"
        out[path] = {"losses": losses, "first_not_finite": bad[0] if bad
                     else None}
        log(f"[rwkv] lr {lr} ({path}), {RWKV_STEPS} steps: losses "
            f"{[round(l, 3) for l in losses]}; "
            + (f"first loss not finite at step {bad[0]}" if bad else
               "all finite"))
    watched = {"calls": watch.calls}
    for key in ("bad_input", "bad_output"):
        found = getattr(watch, key)
        if found is not None:
            found = dict(found)
            found["routes"] = wkv_routes_on(found.pop("inputs"),
                                            found["chunk"])
        watched[key] = found
    out["watch"] = watched
    log(f"[rwkv] lr {lr}, kernel path, {watch.calls} WKV calls watched: "
        f"first with an input not finite: {watched['bad_input']}; first "
        f"turning finite inputs into an output not finite: "
        f"{watched['bad_output']}")
    return out


def rwkv_full_depth(dtype):
    """rwkv6-7b at all 32 layers, forward only, batch 4 x seq 2048, in
    ``dtype`` (the config's bf16, and fp32): drawn on the card from a
    seed, through the kernel (32 launches) and through the kernel-free
    chunked path on the same weights and tokens, and the kernel-free path
    again at another chunk as the witness of rounding alone."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.models import build_model, rwkv6
    cfg = dataclasses.replace(get_config(RWKV_ARCH), dtype=dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, use_kernel=True, device="cuda", seed=5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == RWKV_FULL_PARAMS, f"full depth: {n_params} params")
    b = next(lm_batches(token_stream(FULL_BATCH * FULL_SEQ * 4,
                                     cfg.vocab_size), FULL_BATCH, FULL_SEQ))
    batch = {"tokens": torch.from_numpy(b["tokens"]).cuda()}
    times = []
    with torch.no_grad():
        for _ in range(2):
            reset_lm_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = lm_launches()
            launches, tc = got["wkv6_chunked"], got["wkv6_chunked_tc"]
            check(launches == tc == cfg.n_layers, f"full depth: {launches} "
                  f"WKV launches, {tc} on the tensor cores, expected "
                  f"{cfg.n_layers} and {cfg.n_layers}")
        peak = torch.cuda.max_memory_allocated()
        model.use_kernel = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, _ = model(batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the witness: the model's layers look rwkv_apply up in rwkv6 at
        # each call, so the kernel-free forward runs at the other chunk
        apply = rwkv6.rwkv_apply
        rwkv6.rwkv_apply = functools.partial(apply, chunk=FULL_WITNESS_CHUNK)
        try:
            witness, _ = model(batch)
        finally:
            rwkv6.rwkv_apply = apply
    check(logits.shape == (FULL_BATCH, FULL_SEQ, 65536)
          and bool(torch.isfinite(logits).all()),
          f"full depth logits {tuple(logits.shape)} not finite")
    a, p, w = logits.float(), plain.float(), witness.float()
    del logits, plain, witness
    norm = torch.linalg.vector_norm(p)
    rel = float(torch.linalg.vector_norm(a - p) / norm)
    w_rel = float(torch.linalg.vector_norm(w - p) / norm)
    maxabs = float((a - p).abs().max())
    agree = float((a.argmax(-1) == p.argmax(-1)).float().mean())
    w_agree = float((w.argmax(-1) == p.argmax(-1)).float().mean())
    if dtype in FULL_REL_TOL:
        tol, tol_by = FULL_REL_TOL[dtype], "fixed"
    else:
        tol = FULL_WITNESS_FACTOR * w_rel
        tol_by = f"{FULL_WITNESS_FACTOR:g} x the witness"
    check(rel <= tol, f"full depth {dtype}: kernel vs kernel-free logits "
          f"rel L2 diff {rel:.3e} > {tol:.3e} ({tol_by})")
    log(f"[rwkv] {RWKV_ARCH} full depth ({cfg.n_layers} layers, "
        f"{n_params:,} parameters, {dtype}) drawn on the card in "
        f"{build_s:.2f} s; forward batch {FULL_BATCH} x seq {FULL_SEQ} "
        f"through the kernel ({cfg.n_layers} launches, all on the tensor "
        f"cores): {times[0]:.1f} ms "
        f"first, {times[1]:.1f} ms second; kernel-free forward "
        f"{plain_ms:.1f} ms; peak memory {peak / 2**30:.2f} GiB; logits max "
        f"|x| {float(p.abs().max()):.3f}, kernel vs kernel-free rel L2 diff "
        f"{rel:.3e} (tol {tol:.3e}, {tol_by}), max abs diff {maxabs:.3e}, "
        f"argmax agreement {agree:.4f}; witness, kernel-free at chunk "
        f"{FULL_WITNESS_CHUNK} vs 128: rel L2 diff {w_rel:.3e}, argmax "
        f"agreement {w_agree:.4f}")
    del model, a, p, w
    torch.cuda.empty_cache()
    return {"build_s": build_s, "forward_ms": times, "plain_ms": plain_ms,
            "peak_mem_bytes": peak, "rel_l2": rel, "rel_l2_tol": tol,
            "max_abs": maxabs, "argmax_agreement": agree,
            "witness_rel_l2": w_rel, "witness_argmax_agreement": w_agree}


def rwkv_cuda_vs_cpu():
    """Reduced rwkv6-7b logits through the WKV kernel on the card against
    the same model on the CPU (the plain twin), same weights and tokens,
    fp32 with TF32 off: 1e-4."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.kernels import wkv6
    from repro_torch.models import build_model
    cfg = get_config(RWKV_ARCH).reduced()
    b = next(lm_batches(token_stream(4 * 128 * 8, cfg.vocab_size), 4, 128))
    tokens = torch.from_numpy(b["tokens"])
    before = dict(wkv6.LAUNCHES)
    model = build_model(cfg, use_kernel=True, device="cpu", seed=1)
    with torch.no_grad():
        gpu, _ = copy.deepcopy(model).cuda()({"tokens": tokens.cuda()})
        cpu, _ = model({"tokens": tokens})
    check(all(wkv6.LAUNCHES[k] == before[k] + cfg.n_layers
              for k in ("wkv6_chunked", "wkv6_chunked_tc")),
          "the card's forward did not go through the tensor-core kernel")
    gpu = gpu.cpu()
    check(gpu.shape == (4, 128, 512) and bool(torch.isfinite(gpu).all()),
          f"logits {tuple(gpu.shape)} not finite")
    err = float((gpu - cpu).abs().max())
    check(err <= 1e-4, f"cuda vs cpu logits differ by {err:.3e}")
    log(f"[rwkv] reduced rwkv6-7b logits (fp32, N 32), card (tensor-core "
        f"kernel) vs CPU (plain twin): max abs diff {err:.3e} (tol 1e-4)")
    return err


def rwkv_phase():
    """The RWKV slice; returns its entry of the kernels line."""
    import torch
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sass = wkv_sass()
    err = rwkv_kernel_parity(dev)
    times = rwkv_kernel_times(dev)
    init = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_rwkv_"), "pg")
    launches, runs = rwkv_train_phase(init)
    full = {dtype: rwkv_full_depth(dtype)
            for dtype in ("bfloat16", "float32")}
    cpu_err = rwkv_cuda_vs_cpu()
    log(f"[rwkv] phase took {time.perf_counter() - t0:.1f} s")
    return [
        {"name": "wkv6_chunked", "route": "cuda", "source": WKV_TC_SRC,
         "cuda_core_source": WKV_SRC,
         "replaces": "src/repro/kernels/wkv6.py:72",
         "launches": launches["wkv6_chunked"],
         "launches_tc": launches["wkv6_chunked_tc"],
         "launches_run": f"{RWKV_ARCH} ({RWKV_LAYERS} of 32 layers) train, "
                         f"batch {RWKV_BATCH} x seq {RWKV_SEQ}, "
                         f"{RWKV_STEPS} steps",
         "max_abs_err": err["tc"]["f32"],
         "max_abs_err_strong_decay": err["tc"]["strong"],
         "max_abs_err_exact": err["tc"]["exact"],
         "max_abs_err_bf16": err["tc"]["bf16"],
         "cuda_core_max_abs_err": err["cuda_core"],
         "grad_max_abs_err": err["grad"], "cuda_vs_cpu_logits": cpu_err,
         **times["long"], "train_shape": times["train"],
         "full_depth_forward": full, "sass_hmma": sass,
         "default_lr_record": runs["default_lr"]},
    ]


# ---------------------------------------------------------------------------
# serve: prefill through kernel 8, ring-cache decode, continuous batching
# ---------------------------------------------------------------------------
SERVE_ARCH = "smollm-135m"
# decode_32k's context of 32,768 at batch 16: its batch of 128 is cut
# because the bf16 KV cache takes 23,040 B a token (30 layers x k and v x
# 3 heads x 64 x 2 B), 755 MB a sequence, so 128 sequences would need
# 96.6 GB of the card's 80
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE, SERVE_TOKENS = 16, 512, 32768, 32
# prefill_32k's length; its global batch of 32 is cut to 1 for time
PREFILL_LEN = 32768
# Gemma-3 cut to one 5:1 group (the gemma phase's cut): its prompt is
# longer than the window of 1,024, so the local rings wrap in prefill
GEMMA_SERVE = dict(batch=4, prompt=1536, cache=2048, tokens=64)
# the same Gemma-3 in fp32 (7.1 GB of weights), as served for the
# reference's exact arithmetic: its prefill runs kernel 8's 3xTF32 route at
# hd 320
GEMMA_SERVE_FP32 = dict(batch=1, prompt=1536, cache=2048, tokens=8)
# rwkv6-7b cut to the rwkv phase's 4 layers
RWKV_SERVE = dict(batch=4, prompt=512, tokens=32)
# the witness's factor (a bf16 gate, as the rwkv phase's full-depth one)
SERVE_WITNESS_FACTOR = 2.0
RWKV_SERVE_FP32_TOL = 1e-3       # fp32 decode vs forward, of the largest
ENGINE_FP32 = dict(slots=8, requests=16, prompt=(16, 512), new=(4, 32),
                   cache=1024, seed=11)
ENGINE_BF16 = dict(slots=16, requests=64, prompt=(128, 1024),
                   new=(32, 128), cache=2048, seed=12)
# the engine's SmolLM cut 30 -> 10 layers, for the time limit: at full
# depth its bf16 run and the sequential runs it is held against took 75 s
ENGINE_LAYERS = 10
# flash-decode: one SmolLM attention layer's heads at long_500k's context
FLASH_RANKS, FLASH_LEN, FLASH_WINDOW = 4, 524288, 4096
FLASH_TOL = 2e-5


def serve_launches():
    from repro_torch.kernels import swa_attention as swa
    return dict(swa.LAUNCHES)


def check_attention_route(launches, n, dtype, where, hd=64):
    """Kernel 8 launched ``n`` times in ``launches`` (None: at least once),
    every launch on the route of ``dtype`` and ``hd``: wgmma in bf16,
    3xTF32 in fp32 at ``TF32_HEAD_DIMS`` (every head_dim)."""
    from repro_torch.kernels import swa_attention as swa
    got = launches["swa_attention_fwd"]
    want = {"swa_attention_fwd_wgmma": got if dtype == "bfloat16" else 0,
            "swa_attention_fwd_tf32": got if dtype == "float32"
            and hd in swa.TF32_HEAD_DIMS else 0}
    check((got == n if n is not None else got > 0)
          and all(launches[k] == v for k, v in want.items()),
          f"{where}: kernel 8 launches {launches}, expected "
          f"{'some' if n is None else n}, {want}")


def serve_tokens(vocab, batch, n, seed):
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, vocab, (batch, n))
                            .astype(np.int32)).cuda()


def serve_run(model, prompt, cache_len, n_tokens, label, extras=None):
    """Prefill ``prompt`` (with ``extras``, a VLM's patch embeddings or an
    encoder-decoder's frames) through ``build_serve_step``, then
    ``n_tokens`` greedy decode steps; the kernel-8 launches of the prefill
    alone (the counts set to 0 just before it), the times, the decode
    logits (B, n, vocab) and the tokens fed."""
    import torch
    from repro_torch.core import build_serve_step
    from repro_torch.kernels import swa_attention as swa
    B, P = prompt.shape
    V = model.cfg.vocab_size
    ss = build_serve_step(model, batch_size=B, cache_len=cache_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in swa.LAUNCHES:
        swa.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = ss.prefill_fn({"tokens": prompt, **(extras or {})})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = serve_launches()
    fed, outs = [], [logits[:, 0]]
    tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_tokens):
        fed.append(tok)
        logits, cache = ss.decode_fn(tok, cache, P + i)
        outs.append(logits[:, 0])
        tok = torch.argmax(logits[:, 0, :V], dim=-1)[:, None].int()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_tokens
    peak = torch.cuda.max_memory_allocated()
    out = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tokens_per_s": B / decode_ms * 1e3, "peak_mem_bytes": peak,
           "launches": launches}
    del cache
    return out, torch.stack(outs, 1), torch.cat(fed, 1)


def teacher_forced(model, prompt, fed, extras=None):
    """The forward's logits (fp32) at the prefill's last position and at
    every decoded position, the forward run over the prompt and the fed
    tokens (with the prefill's ``extras``): (B, n + 1, vocab)."""
    import torch
    with torch.no_grad():
        full, _ = model({"tokens": torch.cat([prompt, fed], 1),
                         **(extras or {})})
    P, n = prompt.shape[1], fed.shape[1]
    return full[:, P - 1:P + n].float()


def logits_err(logits, ref, skip=None):
    """Max |logits - ref| over the positions that ``skip``, a (B, n + 1)
    mask, does not mark."""
    diff = (logits.float() - ref).abs().amax(-1)
    if skip is not None:
        diff = diff[~skip]
    return float(diff.max()) if diff.numel() else 0.0


def teacher_forced_err(model, prompt, fed, logits, extras=None):
    """Max |decode logits - forward logits| (``teacher_forced``) and the
    forward's largest |logit|."""
    ref = teacher_forced(model, prompt, fed, extras)
    return logits_err(logits, ref), float(ref.abs().max())


class RouteWatch:
    """Records the set of experts each token chose in every MoE layer call
    made inside the block: ``calls``, one (T, k) tensor (sorted) a call."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe._route, []

        def watch(p, xf, cfg, **kw):
            out = self.route(p, xf, cfg, **kw)
            dest, C = out[1], out[4]
            self.calls.append((dest // C).reshape(
                -1, cfg.experts_per_token).sort(dim=-1).values)
            return out
        moe._route = watch
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def route_flips(calls, B, P, n):
    """(B, n + 1) bool: the positions P - 1 .. P + n - 1 where some MoE
    layer chose other experts in the prefill or a decode step than in the
    teacher-forced forward.  ``calls`` are a ``RouteWatch``'s over the
    prefill, n decode steps and the forward, in that order (L calls each,
    no slot dropped)."""
    import torch
    L = len(calls) // (n + 2)
    check(len(calls) == L * (n + 2), f"route calls {len(calls)}")
    flips = []
    for l in range(L):
        served = torch.stack([calls[l].reshape(B, P, -1)[:, -1]] + [
            calls[L * (1 + i) + l] for i in range(n)], 1)
        forward = calls[L * (n + 1) + l].reshape(B, P + n, -1)[:, P - 1:]
        flips.append((served != forward).any(-1))
    return torch.stack(flips).any(0)


def serve_model(cfg, prompt, cache_len, n_tokens, label, expect_launches,
                seed=0, witness=None, extras=None, model=None):
    """One model (``model``, or one drawn from ``seed``) served through
    the kernel and through the kernel-free path (or ``witness``, a context
    manager around the witness's run) on the same weights and prompt (and
    ``extras``), each held against its own teacher-forced forward; gates
    the kernel's error against ``SERVE_WITNESS_FACTOR`` times the
    witness's (at least one bf16 step of the largest logit)."""
    import contextlib
    import torch
    from repro_torch.models import build_model
    if model is None:
        model = build_model(cfg, use_kernel=True, device="cuda", seed=seed)
    model.use_kernel = True
    B, P = prompt.shape

    def served():
        """serve_run and the teacher-forced error; an MoE model's positions
        where rounding flipped an expert choice between the served path
        and the forward are left out, and counted."""
        with RouteWatch() if cfg.is_moe else contextlib.nullcontext() as w:
            res, logits, fed = serve_run(model, prompt, cache_len, n_tokens,
                                         label, extras=extras)
            ref = teacher_forced(model, prompt, fed, extras)
        skip = None
        if w is not None:
            skip = route_flips(w.calls, B, P, n_tokens)
            res["route_flips"] = int(skip.sum())
        return (res, logits, fed, logits_err(logits, ref, skip),
                float(ref.abs().max()))

    res, logits, fed, err, scale = served()
    check(bool(torch.isfinite(logits).all()), f"[serve] {label}: decode "
          "logits not finite")
    got = res["launches"]
    check(got == expect_launches, f"[serve] {label}: prefill launched "
          f"{got}, expected {expect_launches}")
    del logits
    model.use_kernel = False
    with witness() if witness else contextlib.nullcontext():
        wres, wlogits, wfed, werr, _ = served()
    del wlogits, model
    torch.cuda.empty_cache()
    tol = max(SERVE_WITNESS_FACTOR * werr, 2 ** -7 * scale)
    check(err <= tol, f"[serve] {label}: decode vs teacher-forced forward "
          f"max abs {err:.4e} > {tol:.4e} (witness {werr:.4e})")
    agree = float((fed == wfed).float().mean())
    if "route_flips" in res:
        res["witness_route_flips"] = wres["route_flips"]
        log(f"[serve] {label}: positions left out where an expert choice "
            f"flipped between the served path and the forward: "
            f"{res['route_flips']} (witness {wres['route_flips']}) of "
            f"{B * (n_tokens + 1)}")
    res.update(max_abs_err=err, witness_max_abs_err=werr, tol=tol,
               max_abs_logit=scale, witness_prefill_ms=wres["prefill_ms"],
               witness_decode_ms_per_token=wres["decode_ms_per_token"],
               tokens_agree_with_witness=agree)
    log(f"[serve] {label}: prefill {res['prefill_ms']:.2f} ms (kernel-8 "
        f"launches {got}), decode {res['decode_ms_per_token']:.3f} ms a "
        f"token ({res['tokens_per_s']:.1f} tok/s), peak "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; decode vs teacher-forced "
        f"forward max abs {err:.4e} (tol {tol:.4e}; witness {werr:.4e}, "
        f"largest |logit| {scale:.3f}); greedy tokens equal to the "
        f"witness's: {agree:.4f}")
    return res


def serve_prefill_32k():
    """SmolLM-135M prefills one prompt of prefill_32k's length: a
    tensor-core launch of kernel 8 a layer (30), its time and peak memory,
    and layer 0's launch held against the plain chunked attention at that
    length."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models import attention, build_model, layers
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg, use_kernel=True, device="cuda", seed=1)
    prompt = serve_tokens(cfg.vocab_size, 1, PREFILL_LEN, 1)
    times = []
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in swa.LAUNCHES:
            swa.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompt},
                                      cache_len=PREFILL_LEN)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = serve_launches()
        check(launches == {"swa_attention_fwd": cfg.n_layers,
                           "swa_attention_fwd_wgmma": cfg.n_layers,
                           "swa_attention_fwd_tf32": 0},
              f"[serve] prefill_32k launched {launches}")
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(logits).all()), "prefill_32k logits")
    # layer 0's q, k, v, recomputed as the prefill computed them
    with torch.no_grad():
        _, p, _, _ = next(model._serve_layers(cache, False))
        h = layers.rmsnorm(layers.embed(model.embed.table, prompt),
                           p["norm1"])
        q, k, v = attention.project_qkv(p["attn"], h, cfg)
        pos = torch.arange(PREFILL_LEN, device=q.device)[None, :]
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        got = swa.swa_attention_fwd(q, k, v)
        want = attention.chunked_attention(q.float(), k.float(), v.float())
        err = float((got.float() - want).abs().max())
        rel = float(((got.float() - want).abs()
                     / (want.abs() + 1e-5 / 2 ** -7)).max())
        stored = float((cache["blocks"][0]["k"][0] - k).abs().max())
    check(rel <= 2 ** -7, f"[serve] prefill_32k layer 0: kernel vs plain "
          f"chunked attention max abs {err:.3e}, relative {rel:.3e} > 2^-7")
    check(stored == 0.0, "prefill_32k: layer 0's cache is not its k")
    del model, cache, q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"[serve] prefill_32k ({SERVE_ARCH}, batch 1 x {PREFILL_LEN}): "
        f"{times[0]:.1f} ms first, {times[1]:.1f} ms second, peak "
        f"{peak / 2**30:.2f} GiB, kernel-8 launches {launches}; layer 0's "
        f"launch against the plain chunked attention (fp32 on the same "
        f"bf16 values): max abs {err:.3e}, within one bf16 step")
    return {"prefill_ms": times, "peak_mem_bytes": peak,
            "launches": launches, "layer0_max_abs_err": err}


def rwkv_fp32_serve(prompt, n_tokens):
    """rwkv6-7b (4 layers) in fp32 with TF32 off: decode against the
    teacher-forced forward to ``RWKV_SERVE_FP32_TOL`` of the largest
    logit."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(rwkv_config(), dtype="float32")
    model = build_model(cfg, use_kernel=True, device="cuda", seed=2)
    res, logits, fed = serve_run(model, prompt, prompt.shape[1] + n_tokens,
                                 n_tokens, "rwkv fp32")
    err, scale = teacher_forced_err(model, prompt, fed, logits)
    del model, logits
    torch.cuda.empty_cache()
    check(err <= RWKV_SERVE_FP32_TOL * scale, f"[serve] rwkv fp32: decode "
          f"vs forward max abs {err:.3e} > {RWKV_SERVE_FP32_TOL} x {scale}")
    log(f"[serve] {RWKV_ARCH} ({RWKV_LAYERS} layers) fp32: prefill "
        f"{res['prefill_ms']:.2f} ms, decode {res['decode_ms_per_token']:.3f}"
        f" ms a token; decode vs teacher-forced forward max abs {err:.3e} "
        f"(tol {RWKV_SERVE_FP32_TOL} x {scale:.3f})")
    res.update(max_abs_err=err, max_abs_logit=scale)
    return res


def gemma_fp32_serve():
    """gemma3-4b (``GEMMA_LAYERS`` layers) in fp32 with TF32 off at
    ``GEMMA_SERVE_FP32``: kernel 8 once a layer a prefill, every launch on
    the 3xTF32 route at hd 320; decode against the teacher-forced forward
    to ``RWKV_SERVE_FP32_TOL`` of the largest logit."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    g = GEMMA_SERVE_FP32
    cfg = dataclasses.replace(gemma_config(), dtype="float32")
    model = build_model(cfg, use_kernel=True, device="cuda", seed=5)
    prompt = serve_tokens(cfg.vocab_size, g["batch"], g["prompt"], 5)
    label = (f"{GEMMA_ARCH} ({GEMMA_LAYERS} layers) fp32 batch {g['batch']},"
             f" prompt {g['prompt']}, cache {g['cache']}")
    res, logits, fed = serve_run(model, prompt, g["cache"], g["tokens"],
                                 label)
    check_attention_route(res["launches"], GEMMA_LAYERS, "float32",
                          f"[serve] {label}", hd=cfg.head_dim)
    check(bool(torch.isfinite(logits).all()), f"[serve] {label}: decode "
          "logits not finite")
    err, scale = teacher_forced_err(model, prompt, fed, logits)
    del model, logits
    torch.cuda.empty_cache()
    check(err <= RWKV_SERVE_FP32_TOL * scale, f"[serve] {label}: decode vs "
          f"forward max abs {err:.3e} > {RWKV_SERVE_FP32_TOL} x {scale}")
    log(f"[serve] {label}: prefill {res['prefill_ms']:.2f} ms (kernel-8 "
        f"launches {res['launches']}), decode "
        f"{res['decode_ms_per_token']:.3f} ms a token, peak "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; decode vs teacher-forced "
        f"forward max abs {err:.3e} (tol {RWKV_SERVE_FP32_TOL} x "
        f"{scale:.3f})")
    res.update(max_abs_err=err, max_abs_logit=scale)
    return res


def sequential_generate(model, prompt, n_new, cache_len):
    """One request alone: batch-1 prefill, then batch-1 decode steps; the
    tokens and, at each step, the gap between the two largest logits.
    The first decode step runs eagerly (on a side stream, the warm-up
    CUDA graphs ask for); the rest replay a CUDA graph of ``decode_step``
    captured on this request's cache, with the token and the position in
    static device buffers: the same kernels on the same operands without
    the host's issue time, which would otherwise take minutes here."""
    import torch
    V = model.cfg.vocab_size
    P = len(prompt)
    logits, cache = model.prefill(
        {"tokens": torch.as_tensor(prompt[None, :], device="cuda")},
        cache_len=cache_len)
    rows = [logits[0, -1, :V]]
    tok = torch.argmax(rows[-1])[None, None].int()
    toks = [tok]
    if n_new > 1:
        pos = torch.tensor(P, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            logits, _ = model.decode_step(tok, cache, pos)
        torch.cuda.current_stream().wait_stream(side)
        rows.append(logits[0, 0, :V])
        tok = torch.argmax(rows[-1])[None, None].int()
        toks.append(tok)
    if n_new > 2:
        tok_buf, pos_buf = tok.clone(), pos.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static, _ = model.decode_step(tok_buf, cache, pos_buf)
        for i in range(1, n_new - 1):
            tok_buf.copy_(tok)
            pos_buf.fill_(P + i)
            graph.replay()
            rows.append(static[0, 0, :V].clone())
            tok = torch.argmax(rows[-1])[None, None].int()
            toks.append(tok)
        del graph, static
    top2 = torch.topk(torch.stack(rows).float(), 2, dim=-1).values
    return ([int(t) for t in torch.cat(toks).reshape(-1).cpu()],
            (top2[:, 0] - top2[:, 1]).cpu().tolist())


def decode_graph_times(model, cache_len, batches=(1, 16)):
    """ms a ``decode_step`` at each batch, issued eagerly and replayed as
    a CUDA graph of the same kernels: how much of a step is the host's."""
    import torch
    out = {}
    for B in batches:
        cache = model.init_cache(B, cache_len)
        tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
        pos = torch.full((B,), cache_len // 2, device="cuda")
        eager = time_ms(lambda: model.decode_step(tok, cache, pos), reps=20,
                        warmup=3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            model.decode_step(tok, cache, pos)
        out[B] = {"eager_ms": eager,
                  "graph_ms": time_ms(graph.replay, reps=20, warmup=3)}
        del graph, cache
    log(f"[serve] {model.cfg.name} ({model.cfg.dtype}) decode step at cache "
        f"{cache_len}: " + "; ".join(
            f"batch {B} {t['eager_ms']:.3f} ms issued eagerly, "
            f"{t['graph_ms']:.3f} ms as a CUDA graph" for B, t in out.items()))
    return out


def engine_requests(vocab, spec):
    import numpy as np
    rs = np.random.RandomState(spec["seed"])
    lo, hi = spec["prompt"]
    nlo, nhi = spec["new"]
    return [(rs.randint(0, vocab, int(rs.randint(lo, hi + 1)))
             .astype(np.int32), int(rs.randint(nlo, nhi + 1)))
            for _ in range(spec["requests"])]


def engine_run(model, spec):
    """Every request of ``spec`` through one ``ServingEngine``: the
    tokens, engine steps, mean occupancy, generated tokens a second and
    each request's time to first token (its batch-1 prefill's end, on the
    host clock after a synchronise, less the time the queue was filled)."""
    import torch
    from repro_torch.serving.engine import ServingEngine
    reqs = engine_requests(model.cfg.vocab_size, spec)
    eng = ServingEngine(model, batch_size=spec["slots"],
                        cache_len=spec["cache"])
    firsts = []
    prefill = model.prefill

    def timed_prefill(*a, **kw):
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        firsts.append(time.perf_counter())
        return out
    model.prefill = timed_prefill
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, n in reqs:
            eng.submit(p, n)
        steps, occupied = 0, 0
        while True:
            active = eng.step()
            steps += 1
            occupied += active
            if active == 0 and not eng.queue:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill
    out = {rid: r.generated for rid, r in eng.finished.items()}
    ttft = sorted(t - t0 for t in firsts)
    n_gen = sum(len(v) for v in out.values())
    return reqs, out, {
        "engine_steps": steps, "wall_s": wall,
        "generated_tokens": n_gen, "tokens_per_s": n_gen / wall,
        "mean_occupancy": occupied / steps / spec["slots"],
        "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1]}


def serve_engine():
    """The engine on full-width SmolLM-135M cut to ``ENGINE_LAYERS``: (a)
    fp32, every request's tokens equal to its sequential generation; (b)
    bf16, the agreement count, a divergence allowed only where the
    sequential run's two largest logits lie within ``gap`` (the bf16
    decode's teacher-forced error on this model at the phase's SmolLM
    shape, the size of what reordering the same products in another
    batch shape moves a logit by).  The decode step's eager and graph
    times on the full-depth bf16 model."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    out = {}
    for dtype, spec in (("float32", ENGINE_FP32), ("bfloat16", ENGINE_BF16)):
        full = dataclasses.replace(get_config(SERVE_ARCH), dtype=dtype)
        cfg = dataclasses.replace(full, n_layers=ENGINE_LAYERS)
        model = build_model(cfg, use_kernel=True, device="cuda", seed=3)
        gap = 0.0
        if dtype == "bfloat16":
            prompt = serve_tokens(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT,
                                  0)
            _, logits, fed = serve_run(model, prompt, SERVE_CACHE,
                                       SERVE_TOKENS, "engine's model")
            gap, _ = teacher_forced_err(model, prompt, fed, logits)
            del logits
            torch.cuda.empty_cache()
        reset_lm_launches()
        reqs, got, rec = engine_run(model, spec)
        rec["launches"] = serve_launches()
        check_attention_route(rec["launches"], None, dtype,
                              f"[serve] engine {dtype}")
        t0 = time.perf_counter()
        agree, ties, bad = 0, 0, []
        for rid, (p, n) in enumerate(reqs):
            want, gaps = sequential_generate(model, p, n, spec["cache"])
            if got[rid] == want:
                agree += 1
                continue
            j = next(i for i, (a, b) in enumerate(zip(got[rid], want))
                     if a != b)
            if dtype == "bfloat16" and gaps[j] <= gap:
                ties += 1
            else:
                bad.append((rid, j, gaps[j]))
        rec.update(requests=len(reqs), agree_in_full=agree,
                   near_tie_divergences=ties, sequential_s=
                   time.perf_counter() - t0, gap=gap, layers=ENGINE_LAYERS)
        check(not bad, f"[serve] engine {dtype}: requests {bad} (rid, step, "
              f"top-2 gap) differ from sequential generation")
        log(f"[serve] engine {dtype}, {ENGINE_LAYERS} layers: {len(reqs)} "
            f"requests over "
            f"{spec['slots']} slots (prompts {spec['prompt']}, new tokens "
            f"{spec['new']}, cache {spec['cache']}): {rec['engine_steps']} "
            f"steps, {rec['generated_tokens']} tokens in {rec['wall_s']:.2f}"
            f" s ({rec['tokens_per_s']:.1f} tok/s), mean occupancy "
            f"{rec['mean_occupancy']:.3f}, time to first token median "
            f"{rec['ttft_median_s']:.3f} s, largest {rec['ttft_max_s']:.3f} "
            f"s; {agree} of {len(reqs)} equal sequential generation in "
            f"full, {ties} diverge at a near tie (top-2 gap <= "
            f"{rec['gap']:.4f}); sequential runs took "
            f"{rec['sequential_s']:.1f} s; kernel 8 launches in the engine's "
            f"run {rec['launches']}")
        out[dtype] = rec
        del model
        torch.cuda.empty_cache()
    model = build_model(full, use_kernel=True, device="cuda", seed=3)
    out["bfloat16"]["decode_step"] = decode_graph_times(model,
                                                        ENGINE_BF16["cache"])
    del model
    torch.cuda.empty_cache()
    return out


def flash_rank(rank, init, out_dir):
    """One of the flash-decode ranks: this rank's contiguous shard of a
    524,288-slot ring (SmolLM's 9 / 3 heads, hd 64, batch 1, fp32, the
    same seeded cache on every rank), held against ``decode_attention``
    over the whole cache in this process."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.flash_decode import flash_decode_attention
    from repro_torch.models.attention import decode_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=FLASH_RANKS)
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(1, 1, 9, 64, generator=gen, device=dev)
    k, v = (torch.randn(1, FLASH_LEN, 3, 64, generator=gen, device=dev)
            for _ in range(2))
    n = FLASH_LEN // FLASH_RANKS
    ks, vs = (t[:, rank * n:(rank + 1) * n].contiguous() for t in (k, v))
    res = {"cases": {}}
    for window, pos in ((None, FLASH_LEN - 1), (FLASH_WINDOW, FLASH_LEN - 1),
                        (None, FLASH_LEN + 1000),
                        (FLASH_WINDOW, FLASH_LEN + 1000)):
        got = flash_decode_attention(q, ks, vs, pos, total_len=FLASH_LEN,
                                     window=window)
        want = decode_attention(q, k, v, pos, window=window)
        res["cases"][f"window={window},pos={pos}"] = float(
            (got - want).abs().max())
    res["flash_ms"] = time_ms(lambda: flash_decode_attention(
        q, ks, vs, FLASH_LEN - 1, total_len=FLASH_LEN), reps=20, warmup=3)
    res["single_ms"] = time_ms(lambda: decode_attention(
        q, k, v, FLASH_LEN - 1), reps=20, warmup=3)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def serve_flash():
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_flash_")
    t0 = time.perf_counter()
    spawn_ranks(
        flash_rank, args=("file://" + os.path.join(out_dir, "pg"), out_dir),
        nprocs=FLASH_RANKS)
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(FLASH_RANKS)]
    worst = max(e for r in ranks for e in r["cases"].values())
    check(worst <= FLASH_TOL, f"[serve] flash-decode: max abs {worst:.3e} "
          f"> {FLASH_TOL} against single-process decode attention")
    r0 = ranks[0]
    log(f"[serve] flash-decode on {FLASH_RANKS} gloo ranks sharing the card "
        f"({time.perf_counter() - t0:.1f} s): {FLASH_LEN:,} slots (9 / 3 "
        f"heads, hd 64, fp32), {FLASH_LEN // FLASH_RANKS:,} a rank, windows "
        f"None and {FLASH_WINDOW}, before and past the wrap: max abs "
        f"{worst:.3e} (tol {FLASH_TOL}); {r0['flash_ms']:.3f} ms a step on "
        f"rank 0 against {r0['single_ms']:.3f} ms for one process over the "
        "whole cache")
    return {"max_abs_err": worst, "cases": r0["cases"],
            "flash_ms": r0["flash_ms"], "single_ms": r0["single_ms"]}


def serve_phase():
    """The serving path; returns its record."""
    import contextlib
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.costmodel import flops
    from repro_torch.models import rwkv6
    t0 = time.perf_counter()
    rec = {}
    cfg = get_config(SERVE_ARCH)
    attn = {"swa_attention_fwd": cfg.n_layers,
            "swa_attention_fwd_wgmma": cfg.n_layers,
            "swa_attention_fwd_tf32": 0}
    prompt = serve_tokens(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, 0)
    smol = serve_model(cfg, prompt, SERVE_CACHE, SERVE_TOKENS,
                       f"{SERVE_ARCH} batch {SERVE_BATCH}, prompt "
                       f"{SERVE_PROMPT}, cache {SERVE_CACHE}", attn)
    nbytes = flops.step_bytes_hbm(cfg, SERVE_BATCH, SERVE_CACHE, "decode")
    smol.update(step_bytes_hbm=nbytes,
                bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
    log(f"[serve] decode step bytes (costmodel.flops.step_bytes_hbm, batch "
        f"{SERVE_BATCH}, context {SERVE_CACHE}): {nbytes:,} B, bound "
        f"{smol['bound_ms']:.3f} ms at 3.35 TB/s; measured "
        f"{smol['decode_ms_per_token']:.3f} ms "
        f"({smol['bound_ms'] / smol['decode_ms_per_token']:.3f} of the "
        "bound)")
    rec["smollm"] = smol
    rec["prefill_32k"] = serve_prefill_32k()
    g = GEMMA_SERVE
    gcfg = gemma_config()
    rec["gemma3"] = serve_model(
        gcfg, serve_tokens(gcfg.vocab_size, g["batch"], g["prompt"], 2),
        g["cache"], g["tokens"], f"{GEMMA_ARCH} ({GEMMA_LAYERS} layers) "
        f"batch {g['batch']}, prompt {g['prompt']}, cache {g['cache']}",
        {"swa_attention_fwd": 6, "swa_attention_fwd_wgmma": 6,
         "swa_attention_fwd_tf32": 0}, seed=4)
    rec["gemma3_fp32"] = gemma_fp32_serve()
    r = RWKV_SERVE
    rcfg = rwkv_config()
    rprompt = serve_tokens(rcfg.vocab_size, r["batch"], r["prompt"], 3)

    @contextlib.contextmanager
    def chunk_64():     # the witness of rounding alone: prefill at chunk 64
        apply = rwkv6.rwkv_apply
        rwkv6.rwkv_apply = functools.partial(apply, chunk=64)
        try:
            yield
        finally:
            rwkv6.rwkv_apply = apply
    rec["rwkv6"] = serve_model(
        rcfg, rprompt, r["prompt"] + r["tokens"], r["tokens"],
        f"{RWKV_ARCH} ({RWKV_LAYERS} layers) batch {r['batch']}, prompt "
        f"{r['prompt']}", {"swa_attention_fwd": 0,
                           "swa_attention_fwd_wgmma": 0,
                           "swa_attention_fwd_tf32": 0}, seed=2,
        witness=chunk_64)
    rec["rwkv6_fp32"] = rwkv_fp32_serve(rprompt, r["tokens"])
    rec["engine"] = serve_engine()
    rec["flash_decode"] = serve_flash()
    rec["seconds"] = time.perf_counter() - t0
    log(f"[serve] phase took {rec['seconds']:.1f} s")
    return rec



# ---------------------------------------------------------------------------
# families: MoE, RG-LRU, encoder-decoder and VLM at full width
# ---------------------------------------------------------------------------
# the working lr of the gated runs (Gemma-3's, a model of like width), and
# the reference's default, a record
FAM_LR = 3e-4
FAM_REF_LR = 3e-3
FAM_STEPS = 5
# each family's train cell (depth cut to ``layers``, None for full depth;
# its leaves) and serve cell; mixtral-8x22b is not trained on the card (one
# layer is 2.9 B parameters, ~58 GB with its AdamW state)
FAMILIES = {
    "mixtral-8x7b": dict(
        train=dict(layers=1, batch=1, seq=2048, leaves=13),
        serve=dict(layers=1, batch=4, prompt=512, cache=1024, tokens=16)),
    "mixtral-8x22b": dict(
        train=None,
        serve=dict(layers=2, batch=2, prompt=512, cache=1024, tokens=16)),
    "recurrentgemma-2b": dict(
        train=dict(layers=3, batch=1, seq=2048, leaves=33),
        serve=dict(layers=None, batch=4, prompt=512, cache=1024, tokens=16)),
    "whisper-small": dict(
        train=dict(layers=None, batch=4, seq=448, leaves=34),
        serve=dict(layers=None, batch=4, prompt=64, cache=128, tokens=32)),
    "pixtral-12b": dict(
        train=dict(layers=2, batch=1, seq=2048, leaves=12),
        serve=dict(layers=None, batch=1, prompt=1536, cache=2048,
                   tokens=16)),
}
# Whisper's window (the largest) is left out for the sharding phase's time
# kernel 8 at each family's prefill shape: (label, B, S, H, KV, hd, window)
FAM_ATTENTION = [
    ("mixtral-8x7b", 4, 512, 32, 8, 128, 4096),
    ("mixtral-8x22b", 2, 512, 48, 8, 128, 4096),
    ("recurrentgemma-2b", 4, 512, 10, 1, 256, 2048),
    ("whisper-small", 4, 64, 12, 12, 64, None),
    ("pixtral-12b", 1, 1536, 32, 8, 160, None),
]


def fam_config(arch, layers):
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def attention_layers(cfg):
    pat = cfg.layer_pattern
    return sum(pat[i % len(pat)] in ("global", "local")
               for i in range(cfg.n_layers))


def fam_stubs(cfg, batch, seed):
    """The stub patch embeddings or frames of one batch, on the card (fp32
    draws; the model casts them to its dtype)."""
    import numpy as np
    import torch
    from repro_torch.launch.train import stub_inputs
    return {k: torch.from_numpy(v).cuda() for k, v in
            stub_inputs(cfg, batch, np.random.RandomState(seed)).items()}


def fam_kernel8(dev):
    """Kernel 8 at each family's prefill shape: against its plain version
    (bf16, one launch on the tensor-core route each), then the wrapper
    called back to back and as a CUDA graph, the plain version, SDPA
    (causal, GQA) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    for label, B, S, H, KV, hd, window in FAM_ATTENTION:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   .bfloat16() for n in (H, KV, KV))
        before = dict(swa.LAUNCHES)
        got = swa.swa_attention_fwd(q, k, v, window=window)
        want = ref.swa_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        check(swa.LAUNCHES["swa_attention_fwd_wgmma"]
              == before["swa_attention_fwd_wgmma"] + 1
              and swa.LAUNCHES["swa_attention_fwd"]
              == before["swa_attention_fwd"] + 1,
              f"[families] swa_attention_fwd at {label}: not one launch on "
              "the tensor-core route")
        diff = (got.float() - want.float()).abs()
        check(bool(torch.isfinite(got).all()) and bool(
            (diff <= SWA_BF16_ATOL + SWA_BF16_RTOL * want.float().abs())
            .all()), f"[families] swa_attention_fwd at {label}: max abs "
                     f"diff {float(diff.max()):.3e}")
        # the windows (4096, 2048) reach past S: every call is causal alone
        flops = 4 * B * H * hd * attention_pairs(S, window, True)
        nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
        t_ops, t_bytes = flops / H100_BF16_FLOP_PER_S, \
            nbytes / H100_BYTES_PER_S
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((lib_fn().transpose(1, 2).float()
                         - want.float()).abs().max())
        fn = lambda: swa.swa_attention_fwd(q, k, v, window=window)  # noqa: E731
        r = dict(max_abs_err=float(diff.max()), ms=time_ms(fn, reps=10),
                 graph_ms=graphed_ms(fn),
                 plain_ms=time_ms(lambda: ref.swa_attention(
                     q, k, v, window=window), reps=3, warmup=1),
                 library_ms=time_ms(lib_fn, reps=10),
                 library_max_abs_err=lib_err,
                 library="F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True), (B, H, S, hd)",
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 flops=flops, bytes=nbytes,
                 shapes=f"q ({B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, "
                        f"{hd}) bf16, causal, window {window}")
        out[label] = r
        log(f"[families] swa_attention_fwd at {label}'s prefill, "
            f"{r['shapes']}: max abs err {r['max_abs_err']:.3e} against "
            f"the plain version; kernel {r['ms']:.4f} ms (CUDA graph "
            f"{r['graph_ms']:.4f} ms, {r['bound_ms'] / r['graph_ms']:.3f} "
            f"of the bound), plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        del q, k, v, got, want, diff, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def fam_train(arch, spec):
    """The LM entry point on ``arch`` (its train cut) over the open
    one-rank group: FAM_STEPS steps at FAM_LR, the launch counts, the
    first step's loss against the kernel-free path's on the same weights
    and batch, a record of the reference's default lr."""
    import numpy as np
    import torch
    from repro_torch.core.train_step import default_loss
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.launch.train import stub_inputs, train
    from repro_torch.models import build_model
    cfg = fam_config(arch, spec["layers"])
    B, S = spec["batch"], spec["seq"]
    torch.cuda.empty_cache()
    reset_lm_launches()
    res = train(arch=arch, n_layers=spec["layers"], batch=B, seq=S,
                steps=FAM_STEPS, lr=FAM_LR, fused_optimizer=True,
                device="cuda", log_every=FAM_STEPS, log=None)
    launches = lm_launches()
    n_att = attention_layers(cfg)
    want = {"fused_adamw_flat": spec["leaves"] * FAM_STEPS,
            "swa_attention_fwd": 2 * n_att * FAM_STEPS,
            "swa_attention_fwd_wgmma": 2 * n_att * FAM_STEPS,
            "swa_attention_fwd_tf32": 0, "wkv6_chunked": 0, "wkv6_chunked_tc": 0, **mlless_launches(0)}
    check(launches == want, f"[families] {arch} train: launches "
          f"{launches}, expected {want}")
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"[families] {arch}: "
          f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"[families] {arch}: loss did not fall "
          f"at lr {FAM_LR}: {losses}")
    # the first step's loss, kernel-free, on the entry point's weights (the
    # same seed on the card) and first batch
    it = lm_batches(token_stream(B * S * 64, cfg.vocab_size, seed=0), B, S,
                    seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             {**next(it), **stub_inputs(cfg, B, np.random.RandomState(0))}
             .items()}
    torch.cuda.empty_cache()
    model = build_model(cfg, use_kernel=False, device="cuda", seed=0)
    with torch.no_grad():
        plain = float(default_loss(model, batch))
    del model, batch
    rel = abs(losses[0] - plain) / abs(plain)
    check(rel <= LM_STEP_RTOL, f"[families] {arch}: first step through the "
          f"kernels {losses[0]:.6f} vs kernel-free {plain:.6f}: rel "
          f"{rel:.3e} > {LM_STEP_RTOL:.3e}")
    torch.cuda.empty_cache()
    record = train(arch=arch, n_layers=spec["layers"], batch=B, seq=S,
                   steps=FAM_STEPS, lr=FAM_REF_LR, fused_optimizer=True,
                   device="cuda", log=None)["losses"]
    log(f"[families] {arch} train, {cfg.n_layers} layers "
        f"({res['params']:,} parameters), bf16, batch {B} x seq {S}, fused "
        f"AdamW lr {FAM_LR}, {FAM_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}; launches a step "
        f"{ {k: n // FAM_STEPS for k, n in launches.items() if n} }; "
        f"{res['ms_per_step']:.2f} ms/step after the first "
        f"({res['first_step_ms']:.1f} ms); peak "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; first step vs "
        f"kernel-free {plain:.6f} (rel {rel:.2e}); lr {FAM_REF_LR} "
        f"(record): {[round(x, 4) for x in record]}")
    return {"layers": cfg.n_layers, "params": res["params"],
            "batch": B, "seq": S, "lr": FAM_LR, "losses": losses,
            "launches": launches, "ms_per_step": res["ms_per_step"],
            "first_step_ms": res["first_step_ms"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "first_step_kernel_free_loss": plain,
            "kernel_vs_plain_rel": rel,
            "reference_lr_losses": {str(FAM_REF_LR): record}}


def moe_kept_shares(fn):
    """Runs ``fn`` and returns, for each MoE layer call in it, the share of
    (token, slot) pairs that kept a place in their expert's buffer."""
    from repro_torch.models import moe
    shares, route = [], moe._route

    def watch(p, xf, cfg, **kw):
        out = route(p, xf, cfg, **kw)
        shares.append(float(out[2].float().mean()))
        return out
    moe._route = watch
    try:
        fn()
    finally:
        moe._route = route
    return shares


def fam_serve(arch, spec, seed):
    """``serve_model`` on ``arch`` (its serve cut) with the stub inputs,
    the prefill's kernel-8 launches one an attention layer, and ms a token
    against ``costmodel.flops.step_bytes_hbm``'s bound.

    An MoE model first prefills at the reference's capacity (its time,
    launches and the share of slots kept), then is held at capacity
    factor E / k, where no slot is dropped: capacity comes from the
    call's token count, so at the reference's factor a prompt's prefill
    and the teacher-forced forward drop slots (a random-init router
    sends most tokens of a long prompt to the same experts) where a
    decode step of B tokens never does, and the three would compute
    different functions."""
    import dataclasses
    import torch
    from repro_torch.costmodel import flops
    from repro_torch.models import build_model
    cfg = fam_config(arch, spec["layers"])
    B = spec["batch"]
    n_att = attention_layers(cfg)
    want = {"swa_attention_fwd": n_att, "swa_attention_fwd_wgmma": n_att,
            "swa_attention_fwd_tf32": 0}
    label = (f"{arch} ({cfg.n_layers} layers) batch {B}, prompt "
             f"{spec['prompt']}, cache {spec['cache']}")
    prompt = serve_tokens(cfg.vocab_size, B, spec["prompt"], seed)
    extras = fam_stubs(cfg, B, seed)
    torch.cuda.empty_cache()
    model = build_model(cfg, use_kernel=True, device="cuda", seed=seed)
    reference_capacity = None
    if cfg.is_moe:
        runs = []
        kept = moe_kept_shares(lambda: runs.append(serve_run(
            model, prompt, spec["cache"], 1, label, extras=extras)[0]))
        check(runs[0]["launches"] == want, f"[families] {label}: prefill "
              f"launched {runs[0]['launches']}, expected {want}")
        reference_capacity = {"prefill_ms": runs[0]["prefill_ms"],
                              "prefill_kept_share": kept[:cfg.n_layers]}
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
        log(f"[families] {label}: at the reference's capacity factor "
            f"{cfg.capacity_factor} the prefill keeps "
            f"{[round(k, 4) for k in kept[:cfg.n_layers]]} of its slots "
            f"(per layer) in {runs[0]['prefill_ms']:.2f} ms; held below at "
            f"capacity factor {model.cfg.capacity_factor} (no drops)")
        label += f", capacity factor {model.cfg.capacity_factor}"
        del runs
    rec = serve_model(model.cfg, prompt, spec["cache"], spec["tokens"],
                      label, want, extras=extras, model=model)
    del model
    if reference_capacity:
        rec["reference_capacity"] = reference_capacity
    nbytes = flops.step_bytes_hbm(cfg, B, spec["cache"], "decode")
    rec.update(spec)
    rec.update(layers=cfg.n_layers, step_bytes_hbm=nbytes,
               bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
    log(f"[families] {arch} decode: {rec['decode_ms_per_token']:.3f} ms a "
        f"token against the bound {rec['bound_ms']:.3f} ms "
        f"({nbytes / 1e9:.3f} GB at 3.35 TB/s; "
        f"{rec['bound_ms'] / rec['decode_ms_per_token']:.3f} of it)")
    torch.cuda.empty_cache()
    return rec


def families_phase():
    """Mixtral 8x7B and 8x22B, RecurrentGemma-2B, Whisper-small and
    Pixtral-12B on the card at full width; returns the record."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rec = {"attention": fam_kernel8(dev), "train": {}, "serve": {}}
    init = "file://" + os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_fam_"), "pg")
    dist.init_process_group("nccl", init_method=init, rank=0, world_size=1)
    try:
        for arch, spec in FAMILIES.items():
            if spec["train"] is not None:
                rec["train"][arch] = fam_train(arch, spec["train"])
    finally:
        dist.destroy_process_group()
    for seed, (arch, spec) in enumerate(FAMILIES.items()):
        rec["serve"][arch] = fam_serve(arch, spec["serve"], seed)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[families] phase took {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# resilience: the chaos harness on full-width SmolLM-135M, 4 ranks, one card
# ---------------------------------------------------------------------------
RES_RANKS = 4
# the fewest steps that hold a replay (kill 3, checkpoint 2) and two
# steps of the shrunk fleet: a step takes about 2.3 s, gloo's all-reduce
# of the 651 MB fp32 gradient most of it
RES_STEPS = 5
RES_REF_STEPS = 2                # the lr 1e-2 record
RES_BATCH, RES_SEQ = 12, 128
RES_KILL = (3, 1)                # (step, worker)
RES_CKPT_EVERY = 2
# SmolLM's 3e-3 does not train at full width (LM_LR); the harness's
# default 1e-2 belongs to the reduced config and is recorded beside it
RES_LR = LM_LR
RES_REF_LR = 1e-2
# takeover's losses from the kill on, against the baseline's: within
# RES_GAP_SHARE of the baseline's own movement over the run (the right
# state on a W-1 batch split lands within a few hundredths; a stale or
# zeroed one lands the whole movement away or more), and never beyond
# RES_LOSS_GAP
RES_GAP_SHARE = 0.5
RES_LOSS_GAP = 0.5


def res_config(lr=RES_LR, steps=RES_STEPS, **kw):
    """The harness's config: SmolLM at ``MULTI_RANK_LAYERS``, full
    width."""
    from repro_torch.resilience import ResilienceConfig
    return ResilienceConfig(
        arch=multi_rank_config().name, sim_arch="spirt",
        n_workers=RES_RANKS, steps=steps, global_batch=RES_BATCH,
        seq=RES_SEQ, lr=lr,
        checkpoint_every=RES_CKPT_EVERY, push_every=1, reduced=False, **kw)


def res_widths(label, rank):
    """The fleet width of each step ``rank`` runs in ``label``'s run:
    restore replays the steps since the last checkpoint, a shrinking
    recovery leaves the killed rank out from the kill on."""
    W, (k, dead) = RES_RANKS, RES_KILL
    replay = k % RES_CKPT_EVERY
    if label == "baseline":
        return [W] * RES_STEPS
    if label.startswith("baseline/"):
        return [W] * RES_REF_STEPS
    if label.startswith("restore/"):
        return [W] * (RES_STEPS + replay)
    if rank == dead:
        return [W] * k
    return [W] * k + [W - 1] * (RES_STEPS - k
                                + (replay if label == "shrunk" else 0))


def res_expected(label, rank, layers):
    """Kernel launches of one rank's run of SmolLM at ``layers``: fused
    AdamW once per leaf a step (12), attention once per layer a
    microbatch (layers x Ke, Ke = gcd(4, local batch): 1 at W 4, 4 at W
    3), forward only (the harness builds the model without remat), all on
    the tensor-core route."""
    widths = res_widths(label, rank)
    attn = sum(layers * math.gcd(4, RES_BATCH // w) for w in widths)
    n = {k: 0 for k in lm_launches()}
    n.update(fused_adamw_flat=12 * len(widths), swa_attention_fwd=attn,
             swa_attention_fwd_wgmma=attn)
    return n


def res_roundtrip(model):
    """A checkpoint of the card's bf16 parameters and fp32 moments (drawn
    from a seed) through ``dumps`` and ``loads``, onto the card (the two
    int32 steps onto the host, where the state tree keeps them) and onto
    the host: every leaf bit for bit, and the bytes again the same."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.models.params import reference_leaves
    from repro_torch.resilience import state as bridge
    params = reference_leaves(model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    moments = [[torch.randn(p.shape, generator=gen, device="cuda")
                for p in params] for _ in range(2)]
    st = {"params": params, "opt": {"step": 6, "m": moments[0],
                                    "v": moments[1]},
          "strat": (), "step": 6}
    tree = bridge.to_reference(st, model)
    t0 = time.perf_counter()
    blob = checkpoint.dumps(tree)
    dumps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.loads(blob, like=tree)
    torch.cuda.synchronize()
    loads_s = time.perf_counter() - t0
    host = checkpoint.loads(blob, like=bridge.describe(tree))

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    leaves = checkpoint.flatten(tree)
    same = all(b.device == a.device and b.dtype == a.dtype
               and torch.equal(bits(a), bits(b)) for a, b in
               zip(leaves, checkpoint.flatten(back)))
    same_host = all(h.device.type == "cpu" and torch.equal(
        bits(a).cpu(), bits(h)) for a, h in
        zip(leaves, checkpoint.flatten(host)))
    return {"bytes": len(blob), "leaves": len(leaves),
            "bf16_leaves": sum(t.dtype == torch.bfloat16 for t in leaves),
            "leaves_on_card": sum(t.device.type == "cuda" for t in
                                  checkpoint.flatten(back)),
            "equal_on_card": same, "equal_on_host": same_host,
            "dumps_again_equal": checkpoint.dumps(back) == blob,
            "dumps_s": dumps_s, "loads_to_card_s": loads_s}


def res_nondeterminism(trainer):
    """One step with ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the ops that warn have no deterministic
    implementation on the card."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.fault_free_steps(1)
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:200] for w in caught})


def res_rank(rank, init, out_dir, ckpt_dir, t_spawn):
    """One rank of the resilience phase: baseline, restore twice, takeover
    and the shrunk restore through ``ResilientTrainer``, launch counts set
    to 0 just before each run and read just after; each trainer's build
    and warm-up timed."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.resilience import FaultSchedule, ResilientTrainer
    from repro_torch.serverless.recovery import (CheckpointRestore,
                                                 PeerTakeover)
    dev, clock = start_rank(rank, RES_RANKS, init, t_spawn)
    schedule = FaultSchedule.single(*RES_KILL)
    restore = CheckpointRestore(checkpoint_every=RES_CKPT_EVERY)
    rec = {"backend": dist.get_backend(), "runs": {}, "start": clock,
           "trainers": {}}
    torch.cuda.reset_peak_memory_stats(dev)

    def trainer_for(label, *warm, **kw):
        t0 = time.perf_counter()
        trainer = ResilientTrainer(res_config(**kw), ckpt_dir,
                                   device="cuda", keep_checkpoints=False)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        trainer.warm(*warm)
        torch.cuda.synchronize(dev)
        rec["trainers"][label] = {"build_s": t1 - t0,
                                  "warm_s": time.perf_counter() - t1}
        return trainer

    def run(trainer, label, policy=None):
        reset_lm_launches()
        t0 = time.perf_counter()
        res = trainer.run(schedule if policy else None, policy)
        torch.cuda.synchronize(dev)
        r = dataclasses.asdict(res)
        r.update(run_s=time.perf_counter() - t0, launches=lm_launches(),
                 replay_exact=res.replay_exact)
        rec["runs"][label] = r
        return r

    trainer = trainer_for("fleet", schedule, PeerTakeover())
    rec["setup_s"] = sum(rec["trainers"]["fleet"].values())
    run(trainer, "baseline")
    run(trainer, "restore/0", restore)
    run(trainer, "restore/1", restore)
    run(trainer, "takeover", PeerTakeover())
    runs = rec["runs"]
    if not (runs["restore/0"]["losses"] == runs["restore/1"]["losses"]
            == runs["baseline"]["losses"]):
        rec["nondeterministic_ops"] = res_nondeterminism(trainer)
    if rank == 0:
        rec["roundtrip"] = res_roundtrip(trainer.model)
    del trainer
    torch.cuda.empty_cache()
    shrunk = trainer_for("shrunk", schedule, restore,
                         restore_reinvoke=False)
    run(shrunk, "shrunk", restore)
    del shrunk
    torch.cuda.empty_cache()
    ref_lr = trainer_for(f"lr{RES_REF_LR}", lr=RES_REF_LR,
                         steps=RES_REF_STEPS)
    run(ref_lr, f"baseline/lr{RES_REF_LR}")
    del ref_lr
    torch.cuda.empty_cache()
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def res_sign_check(base, restore, takeover):
    """``benchmarks/recovery_replay.py``'s sign check through the port's
    event runtime: the measured step time and state bytes go in, the
    crash lands at the kill step's fraction of the epoch; the sign of
    (restore wall - takeover wall) must equal that of (TTR_restore -
    TTR_takeover)."""
    from repro_torch.serverless import (FaultPlan, ServerlessSetup,
                                        WorkerCrash, run_event_epoch)
    k, worker = RES_KILL
    setup = ServerlessSetup(n_workers=RES_RANKS,
                            batches_per_worker=RES_STEPS,
                            model_bytes=float(base["state_bytes"]))
    kw = dict(n_params=base["n_params"], compute_s_per_batch=base["step_s"],
              setup=setup)
    ttr = {}
    for mode in ("restore", "takeover"):
        clean = run_event_epoch("spirt", faults=FaultPlan(), recovery=mode,
                                **kw)
        crash = clean.makespan_s * k / RES_STEPS
        ttr[mode] = run_event_epoch(
            "spirt", faults=FaultPlan(crashes=(WorkerCrash(worker, crash),)),
            recovery=mode, **kw).time_to_recover_s
    real = (restore["recoveries"][0]["wall_s"]
            - takeover["recoveries"][0]["wall_s"])
    sim = ttr["restore"] - ttr["takeover"]
    return {"real_delta_s": real, "sim_delta_s": sim, "sim_ttr_s": ttr,
            "consistent": (real > 0) == (sim > 0)}


def resilience_phase():
    """The chaos harness on the card; returns its record.  Every run is
    logged before the gates are held."""
    import shutil
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_res_")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t_spawn = time.time()
        spawn_ranks(
            res_rank, args=("file://" + os.path.join(out_dir, "pg"),
                            out_dir, ckpt_dir, t_spawn), nprocs=RES_RANKS)
        spawn_s = time.time() - t_spawn
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(RES_RANKS)]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    runs = ranks[0]["runs"]
    base, takeover, shrunk = (runs["baseline"], runs["takeover"],
                              runs["shrunk"])
    k, dead = RES_KILL
    n = base["n_params"]
    log(f"[resilience] {LM_ARCH} full width, {MULTI_RANK_LAYERS} layers "
        f"({n:,} parameters), bf16, "
        f"{RES_RANKS} ranks sharing the card over {ranks[0]['backend']}, "
        f"global batch {RES_BATCH} x seq {RES_SEQ}, spirt (K 4), lr "
        f"{RES_LR}, {RES_STEPS} steps, kill step {k} worker {dead}, "
        f"checkpoint every {RES_CKPT_EVERY}, push every step; set-up "
        f"(build, groups, warm steps at W {RES_RANKS} and "
        f"{RES_RANKS - 1}) {ranks[0]['setup_s']:.1f} s")
    log(f"[resilience] state_bytes {base['state_bytes']:,} B "
        f"({base['state_bytes'] / n:.4f} B a parameter)")
    for label, r in runs.items():
        per_rank = [ranks[q]["runs"][label]["launches"]
                    for q in range(RES_RANKS)]
        log(f"[resilience] {label}: losses {r['losses']}; run "
            f"{r['run_s']:.3f} s, snapshots {r['snapshot_s']:.3f} s; "
            f"step_s by width {r['step_s_by_width']}; attention launches "
            f"a rank {[q['swa_attention_fwd'] for q in per_rank]}, fused "
            f"AdamW {[q['fused_adamw_flat'] for q in per_rank]}")
        for rr in r["recoveries"]:
            log(f"[resilience]   {rr['mode']}: wall {rr['wall_s']:.6f} s "
                f"{ {p: round(v, 6) for p, v in rr['split_s'].items()} }, "
                f"bytes moved {rr['bytes_moved']:,}, replayed "
                f"{rr['replayed_steps']}, workers after "
                f"{rr['n_workers_after']}")
    rt = ranks[0]["roundtrip"]
    log(f"[resilience] bf16 round trip: {rt}")
    log(f"[resilience] peak memory a rank: "
        f"{[r['peak_mem_bytes'] for r in ranks]} B")
    sign = res_sign_check(base, runs["restore/0"], takeover)
    log(f"[resilience] sign check: real restore - takeover "
        f"{sign['real_delta_s']:+.6f} s, event runtime TTR "
        f"{sign['sim_delta_s']:+.6f} s ({sign['sim_ttr_s']})")
    budget_spawn("resilience", [r["start"] for r in ranks], spawn_s)
    for label, tr in ranks[0]["trainers"].items():
        log(f"[budget] resilience trainer {label} (rank 0): build "
            f"{tr['build_s']:.1f} s, warm steps {tr['warm_s']:.1f} s")
    for label, r in runs.items():
        log(f"[budget] resilience {label} (rank 0): run {r['run_s']:.1f} s, "
            f"snapshots {r['snapshot_s']:.1f} s, recoveries "
            f"{sum(rr['wall_s'] for rr in r['recoveries']):.1f} s, median "
            f"step by width {r['step_s_by_width']} s")

    for rank, res in enumerate(ranks):
        for label, r in res["runs"].items():
            want = res_expected(label, rank, MULTI_RANK_LAYERS)
            check(r["launches"] == want, f"[resilience] rank {rank} "
                  f"{label}: launches {r['launches']}, expected {want}")
            check(r["losses"] == runs[label]["losses"], f"rank {rank} "
                  f"{label}: its result differs from rank 0's")
    if "nondeterministic_ops" in ranks[0]:
        fail(f"[resilience] restore is not bit-exact: baseline "
             f"{base['losses']}, restores {runs['restore/0']['losses']} "
             f"and {runs['restore/1']['losses']}; ops without a "
             f"deterministic implementation in one step: "
             f"{ranks[0]['nondeterministic_ops']}")
    for label in ("restore/0", "restore/1"):
        r = runs[label]
        rec = r["recoveries"][0]
        check(r["replay_exact"] and rec["replayed_steps"] == k
              % RES_CKPT_EVERY and rec["n_workers_after"] == RES_RANKS
              and r["n_workers_end"] == RES_RANKS, f"[resilience] {label}: "
              f"{rec}, replay checks {r['replay_checks']}")
    rec_t = takeover["recoveries"][0]
    check(rec_t["replayed_steps"] == 0 and rec_t["n_workers_after"]
          == RES_RANKS - 1 and rec_t["bytes_moved"]
          == base["state_bytes"] // RES_RANKS, f"[resilience] takeover: "
          f"{rec_t}, state {base['state_bytes']} B")
    gap_limit = min(RES_LOSS_GAP, RES_GAP_SHARE * abs(
        base["losses"][0] - base["losses"][-1]))
    gaps = [abs(a - b) for a, b in zip(takeover["losses"][k:],
                                       base["losses"][k:])]
    check(takeover["losses"][:k] == base["losses"][:k]
          and all(map(math.isfinite, takeover["losses"]))
          and len(gaps) == RES_STEPS - k and max(gaps) < gap_limit,
          f"[resilience] takeover losses {takeover['losses']} against the "
          f"baseline's {base['losses']}: the steps before the kill must be "
          f"equal, those after within {gap_limit}")
    rec_s = shrunk["recoveries"][0]
    ckpt = k - k % RES_CKPT_EVERY
    check(rec_s["n_workers_after"] == RES_RANKS - 1
          and rec_s["replayed_steps"] == k % RES_CKPT_EVERY
          and shrunk["losses"][:ckpt] == base["losses"][:ckpt]
          and all(map(math.isfinite, shrunk["losses"])),
          f"[resilience] shrunk restore: {rec_s}, losses "
          f"{shrunk['losses']}")
    check(rt["equal_on_card"] and rt["equal_on_host"]
          and rt["dumps_again_equal"] and rt["bf16_leaves"] > 0
          and rt["leaves_on_card"] == rt["leaves"] - 2,
          f"[resilience] bf16 checkpoint round trip: {rt}")
    check(sign["consistent"], f"[resilience] restore - takeover wall "
          f"{sign['real_delta_s']:+.3f} s disagrees in sign with the event "
          f"runtime's TTR delta {sign['sim_delta_s']:+.3f} s")
    log(f"[resilience] restore bit-exact against the baseline in both runs; "
        f"takeover on {RES_RANKS - 1} ranks, final loss "
        f"{takeover['losses'][-1]} vs baseline {base['losses'][-1]}, the "
        f"steps before the kill equal, after it gaps {gaps} < {gap_limit}; "
        f"launches as counted on every rank; the bf16 "
        f"round trip bit for bit; the sign check holds")
    record = {
        "runs": runs, "sign_check": sign, "roundtrip": rt,
        "launches": {label: [r["runs"][label]["launches"] for r in ranks]
                     for label in runs},
        "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
        "setup_s": ranks[0]["setup_s"], "layers": MULTI_RANK_LAYERS,
        "start": [r["start"] for r in ranks],
        "trainers": ranks[0]["trainers"], "spawn_s": spawn_s}
    record["seconds"] = time.perf_counter() - t0
    log(f"[resilience] phase took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# sharding: FSDP training and data-sharded serving, 4 ranks, one card
# ---------------------------------------------------------------------------
SHARD_RANKS = 4
SHARD_STEPS = 3
SHARD_BATCH, SHARD_SEQ = 8, 512          # global batch: 2 rows a rank
# (strategy, fsdp): the replicated baseline and the two FSDP runs
SHARD_RUNS = (("allreduce", False), ("allreduce", True), ("mlless", True))
# (label, batch, cache, prompt): 4 rows a rank; batch 1 sequence-sharded
# (8,192 ring slots a rank), its 16 tokens crossing from rank 0's slots
# into rank 1's
SHARD_SERVE = (("batch16", 16, 2048, 512), ("batch1", 1, 32768, 8184))
SHARD_TOKENS = 16
SHARD_DRYRUN = ("train_4k", "long_500k")


def shard_expected(strategy, layers, steps=SHARD_STEPS):
    """Launches a rank makes in ``steps`` train steps of SmolLM at
    ``layers``: fused AdamW once a leaf, attention twice a layer (forward
    and remat), MLLess's segmented pair once (FSDP changes none of
    them)."""
    return expected_lm_launches(layers, steps, mlless=strategy == "mlless")


def shard_dryruns():
    """The dry-run on the fake group: the phase's own configuration (W =
    4, every run's strategy and profile, SmolLM at ``MULTI_RANK_LAYERS``)
    and full-depth SmolLM's train_4k and long_500k on the 16x16 mesh
    under zero3."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    shape = InputShape("sharding_phase", SHARD_SEQ, SHARD_BATCH, "train")
    t0 = time.perf_counter()
    out = {"phase": {}, "production": {}}
    for strategy, fsdp in SHARD_RUNS:
        out["phase"][f"{strategy}/{'zero3' if fsdp else 'dp'}"] = \
            dryrun.dryrun_one(LM_ARCH, shape.name, strategy=strategy,
                              profile="zero3" if fsdp else "dp", save=False,
                              mesh=make_mesh((SHARD_RANKS,), ("data",)),
                              config=multi_rank_config(), input_shape=shape)
    for name in SHARD_DRYRUN:
        out["production"][name] = dryrun.dryrun_one(
            LM_ARCH, name, profile="zero3", save=False)
    out["fsdp_required"] = sorted(dryrun.FSDP_REQUIRED)
    out["seconds"] = time.perf_counter() - t0
    return out


def shard_gloo_check(dev):
    """gloo's all_gather_into_tensor and reduce_scatter_tensor on CUDA
    tensors of this card, against their definitions."""
    import torch
    import torch.distributed as dist
    W, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * r
    out = torch.empty(W * 6, device=dev)
    dist.all_gather_into_tensor(out, x)
    want = torch.cat([torch.arange(6, dtype=torch.float32, device=dev)
                      + 10 * q for q in range(W)])
    full = torch.arange(W * 3, dtype=torch.float32, device=dev) * (r + 1)
    part = torch.empty(3, device=dev)
    dist.reduce_scatter_tensor(part, full)
    scale = W * (W + 1) / 2
    return {"all_gather_into_tensor": bool(torch.equal(out, want)),
            "reduce_scatter_tensor": bool(torch.equal(
                part, full[r * 3:(r + 1) * 3] / (r + 1) * scale)),
            "device": str(out.device)}


def shard_train(dev, strategy, fsdp, batches):
    """``SHARD_STEPS`` steps of full-width SmolLM at ``MULTI_RANK_LAYERS``
    from seed 0's weights; the first step's collectives, the shards each
    rank holds, launches, build and step times and peak memory."""
    import torch
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.costmodel.collectives import record_collectives, stats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(multi_rank_config(), use_kernel=True, device=dev)
    ts = build_train_step(model, optim.adamw(LM_LR, use_fused=True),
                          get_strategy(strategy),
                          make_mesh((SHARD_RANKS,), ("data",)), fsdp=fsdp)
    state = ts.init_state()
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_lm_launches()
    losses, ms, coll = [], [], None
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with record_collectives() as recs:
            state, m = ts.step_fn(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            st = stats(recs)
            coll = {"bytes_by_kind": st.bytes_by_kind, "counts": st.counts,
                    "wire_bytes": st.wire_bytes}
    rec = {"losses": losses, "step_ms": ms, "collectives": coll,
           "launches": lm_launches(), "build_s": build_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    if ts.layout is not None:
        lay = ts.layout
        rec["shards"] = [
            {"global": int(math.prod(lay.shapes[i])), "sharded": m,
             "param": p.numel(), "m": mm.numel(), "v": vv.numel()}
            for i, (m, p, mm, vv) in enumerate(zip(
                lay.mask, state["params"], state["opt"]["m"],
                state["opt"]["v"]))]
    return rec


def shard_serve(dev, dtype, B, cache_len, prompt_len):
    """Greedy decoding of ``SHARD_TOKENS`` tokens over the data mesh and,
    on this rank alone, of the same prompts: this rank's rows of both,
    ms a decode step of each, the call's seconds."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import build_serve_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = dataclasses.replace(multi_rank_config(), dtype=dtype)
    model = build_model(cfg, use_kernel=True, device=dev)
    rs = np.random.RandomState(B)
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, prompt_len))
                             .astype(np.int32), device=dev)
    V = cfg.vocab_size

    def greedy(prefill, decode, tokens):
        logits, cache = prefill({"tokens": tokens})
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
        out = [tok]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(SHARD_TOKENS):
            logits, cache = decode(tok, cache, prompt_len + i)
            tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
            out.append(tok)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / SHARD_TOKENS
        del cache
        return torch.cat(out, dim=1).cpu(), ms

    reset_lm_launches()
    ss = build_serve_step(model, make_mesh((SHARD_RANKS,), ("data",)),
                          batch_size=B, cache_len=cache_len)
    sharded, ms = greedy(ss.prefill_fn, ss.decode_fn, ss.local_rows(prompt))
    launches = lm_launches()
    torch.cuda.empty_cache()
    one = build_serve_step(model, batch_size=B, cache_len=cache_len)
    whole, ms_one = greedy(one.prefill_fn, one.decode_fn, prompt)
    whole = ss.local_rows(whole)
    return {"equal": bool(torch.equal(sharded, whole)),
            "tokens": sharded.tolist(), "one_rank_tokens": whole.tolist(),
            "ms_per_token": ms, "one_rank_ms_per_token": ms_one,
            "launches": launches, "seconds": time.perf_counter() - t0}


def shard_rank(rank, init, out_dir, t_spawn):
    """One rank of the sharding phase."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batches, token_stream
    dev, clock = start_rank(rank, SHARD_RANKS, init, t_spawn)
    rec = {"start": clock}
    rec["backend"] = dist.get_backend()
    rec["gloo_cuda"] = shard_gloo_check(dev)
    cfg = get_config(LM_ARCH)
    it = lm_batches(token_stream(SHARD_BATCH * SHARD_SEQ * 8,
                                 cfg.vocab_size, seed=23), SHARD_BATCH,
                    SHARD_SEQ, seed=23)
    B = SHARD_BATCH // SHARD_RANKS
    batches = [{k: torch.from_numpy(v[rank * B:(rank + 1) * B]).to(dev)
                for k, v in next(it).items()} for _ in range(SHARD_STEPS)]
    rec["train"] = {}
    for strategy, fsdp in SHARD_RUNS:
        label = f"{strategy}/{'fsdp' if fsdp else 'dp'}"
        rec["train"][label] = shard_train(dev, strategy, fsdp, batches)
        torch.cuda.empty_cache()
    rec["serve"] = {}
    for dtype in ("float32", "bfloat16"):
        for label, Bs, cache, prompt in SHARD_SERVE:
            rec["serve"][f"{label}/{dtype}"] = shard_serve(
                dev, dtype, Bs, cache, prompt)
            torch.cuda.empty_cache()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def sharding_phase():
    """FSDP training, data-sharded serving and the dry-run on the card;
    returns the record.  Every number is logged before the gates."""
    import shutil
    import torch
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    dry_path = os.path.join(out_dir, "dryrun.json")
    # the dry-runs (host only, a fake process group of their own) run in
    # a process of their own beside the ranks
    child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--sharding-dryrun", dry_path])
    try:
        t_spawn = time.time()
        spawn_ranks(
            shard_rank, args=("file://" + os.path.join(out_dir, "pg"),
                              out_dir, t_spawn), nprocs=SHARD_RANKS)
        spawn_s = time.time() - t_spawn
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(SHARD_RANKS)]
        check(child.wait(timeout=300) == 0, "[sharding] the dry-run failed")
        wait_s = time.time() - t_spawn - spawn_s
        dry = json.loads(Path(dry_path).read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    log(f"[sharding] {LM_ARCH} full width, {MULTI_RANK_LAYERS} layers, "
        f"bf16, {SHARD_RANKS} ranks "
        f"sharing the card over {r0['backend']}, global batch "
        f"{SHARD_BATCH} x seq {SHARD_SEQ}, {SHARD_STEPS} steps a run; "
        f"gloo on CUDA tensors: {[r['gloo_cuda'] for r in ranks]}")
    for label, run in r0["train"].items():
        log(f"[sharding] train {label}: losses {run['losses']}, ms/step "
            f"{run['step_ms']}, peak MB a rank "
            f"{[r['train'][label]['peak_mem_bytes'] / 2**20 for r in ranks]}"
            f", first step's collectives {run['collectives']}, launches "
            f"{run['launches']}")
    for key, res in dry["phase"].items():
        log(f"[sharding] dry-run {key} (W {SHARD_RANKS}): collectives "
            f"{res['collectives']['bytes_by_kind']}, memory "
            f"{res['memory']}, roofline {res['roofline']}")
    for name, res in dry["production"].items():
        log(f"[sharding] dry-run {LM_ARCH} x {name} on 16x16 zero3: peak "
            f"{res['memory']['peak_estimate_gb']:.4f} GB a device, "
            f"dominant {res['roofline']['dominant']}, roofline "
            f"{res['roofline']}, collectives "
            f"{res['collectives']['bytes_by_kind']}")
    log(f"[sharding] FSDP required on 80 GB (params 2 B + m, v 8 B over "
        f"16): {dry['fsdp_required']}; dry-runs took {dry['seconds']:.1f} s")
    from repro_torch.costmodel.roofline import HW
    hw = {"name": HW.name, "peak_flops_bf16": HW.peak_flops_bf16,
          "hbm_bandwidth": HW.hbm_bandwidth,
          "ici_bandwidth": HW.ici_bandwidth, "hbm_bytes": HW.hbm_bytes,
          "card_total_memory": torch.cuda.get_device_properties(0)
          .total_memory, "card": torch.cuda.get_device_name(0)}
    log(f"[sharding] the roofline's constants beside this card: {hw}")
    for label, res in r0["serve"].items():
        log(f"[sharding] serve {label}: ms a token {res['ms_per_token']:.3f}"
            f" over {SHARD_RANKS} ranks, {res['one_rank_ms_per_token']:.3f}"
            f" on one; tokens equal on every rank "
            f"{[r['serve'][label]['equal'] for r in ranks]}; launches "
            f"{res['launches']}")
    budget_spawn("sharding", [r["start"] for r in ranks], spawn_s)
    for label, run in r0["train"].items():
        budget_train(f"sharding train {label}", run)
    log(f"[budget] sharding serve (rank 0): "
        f"{ {k: round(v['seconds'], 1) for k, v in r0['serve'].items()} } s")
    log(f"[budget] sharding dry-run child: {dry['seconds']:.1f} s of "
        f"dry-runs beside the ranks; waited {wait_s:.1f} s for it after "
        "them")

    for r, res in enumerate(ranks):
        check(all(res["gloo_cuda"][k] for k in ("all_gather_into_tensor",
                                                 "reduce_scatter_tensor")),
              f"[sharding] rank {r}: gloo on CUDA tensors {res['gloo_cuda']}")
        for label, run in res["train"].items():
            strategy = label.split("/")[0]
            want = shard_expected(strategy, MULTI_RANK_LAYERS)
            check(run["launches"] == want, f"[sharding] rank {r} {label}: "
                  f"launches {run['launches']}, expected {want}")
            check(run["losses"] == r0["train"][label]["losses"]
                  and all(map(math.isfinite, run["losses"])),
                  f"[sharding] rank {r} {label}: losses {run['losses']}")
            profile = "zero3" if label.endswith("fsdp") else "dp"
            want = dry["phase"][f"{strategy}/{profile}"]["collectives"]
            check(run["collectives"]["bytes_by_kind"] ==
                  want["bytes_by_kind"], f"[sharding] rank {r} {label}: "
                  f"collective bytes {run['collectives']['bytes_by_kind']}"
                  f" against the dry-run's {want['bytes_by_kind']}")
            for leaf in run.get("shards", []):
                n = leaf["global"] // SHARD_RANKS if leaf["sharded"] \
                    else leaf["global"]
                check(leaf["param"] == leaf["m"] == leaf["v"] == n,
                      f"[sharding] rank {r} {label}: shard {leaf}")
            if "shards" in run:
                check(sum(leaf["sharded"] for leaf in run["shards"]) > 0,
                      f"[sharding] {label}: no leaf sharded")
        for label, sres in res["serve"].items():
            if label.endswith("float32"):
                check(sres["equal"], f"[sharding] rank {r} serve {label}: "
                      f"{sres['tokens']} against one rank's "
                      f"{sres['one_rank_tokens']}")
            check_attention_route(
                sres["launches"], None,
                "float32" if label.endswith("float32") else "bfloat16",
                f"[sharding] rank {r} serve {label}")
    base, fsdp = (r0["train"]["allreduce/dp"]["losses"],
                  r0["train"]["allreduce/fsdp"]["losses"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(fsdp, base)]
    check(max(gaps) <= LM_STEP_RTOL, f"[sharding] FSDP losses {fsdp} "
          f"against the replicated run's {base}: rel gaps {gaps} > "
          f"{LM_STEP_RTOL}")
    for name, res in dry["production"].items():
        check(0 < res["memory"]["peak_estimate_gb"] < 80,
              f"[sharding] dry-run {name}: {res['memory']}")
    mem = {label: {"peak_mem_bytes": [r["train"][label]["peak_mem_bytes"]
                                      for r in ranks],
                   "dryrun_peak_gb": dry["phase"][
                       f"{label.split('/')[0]}/"
                       f"{'zero3' if label.endswith('fsdp') else 'dp'}"]
                   ["memory"]["peak_estimate_gb"]}
           for label in r0["train"]}
    log(f"[sharding] peak memory against the dry-run's estimate: {mem}")
    log(f"[sharding] FSDP losses within {LM_STEP_RTOL} of the replicated "
        f"run's (gaps {gaps}); collective bytes equal the dry-run's kind "
        f"for kind; each FSDP leaf a quarter on every rank; fp32 tokens "
        f"equal one rank's in both layouts")
    record = {"train": {k: {kk: v for kk, v in run.items()
                            if kk != "shards"}
                        for k, run in r0["train"].items()},
              "launches": {label: [r["train"][label]["launches"]
                                   for r in ranks] for label in r0["train"]},
              "memory": mem, "serve": r0["serve"],
              "dryrun": dry, "gloo_cuda": r0["gloo_cuda"],
              "loss_gaps": gaps, "hardware": hw, "layers": MULTI_RANK_LAYERS,
              "start": [r["start"] for r in ranks], "spawn_s": spawn_s,
              "dryrun_wait_s": wait_s}
    record["seconds"] = time.perf_counter() - t0
    log(f"[sharding] phase took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------
# tp: tensor parallelism on a (2, 2) ("data", "model") mesh, 4 ranks, one
# card; the head-local case on (1, 3), 3 ranks
# ---------------------------------------------------------------------------
TP_MESH = (2, 2)
TP_RANKS = 4
# (strategy, fsdp), on the sharding phase's batches: global 8 x 512
TP_RUNS = (("allreduce", False), ("allreduce", True), ("mlless", False))
# batch, cache, prompt: 8 rows a data rank
TP_SERVE = (16, 2048, 512)
TP_TOKENS = 8
# SmolLM's 9 / 3 heads and d 576 divide over 3: head-local attention, the
# cache sharded on its kv heads
TP_LOCAL_MESH = (1, 3)
TP_LOCAL = (4, 1024, 512)
TP_LOCAL_TOKENS = 8
# neither 9 / 3 heads nor head_dim 64 divide over 6: the model axis on the
# ring's slots (512 a rank), flash-decode over the model group
TP_SLOTS_MESH = (1, 6)
TP_SLOTS = (2, 3072, 2048)
TP_SLOTS_TOKENS = 8


def tp_slots_calls(layers):
    """gloo calls a decode token on the ring's slots, by design: the
    vocab-parallel embedding's all-reduce; a layer's two norm scales
    gathered whole, q/k/v's all-reduce, flash-decode's three (max, sum,
    weighted sum), the row-parallel output and MLP down projections' two;
    the final norm's gather and the logits' gather over the vocab."""
    return 1 + layers * 8 + 2


def tp_label(strategy, fsdp):
    return f"{strategy}/{'fsdp' if fsdp else 'tp'}"


def tp_dryruns():
    """The ``baseline`` dry-run (fake process group, meta tensors) of each
    train run of the phase on its (2, 2) mesh, at its shape and depth."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    shape = InputShape("tp_phase", SHARD_SEQ, SHARD_BATCH, "train")
    t0 = time.perf_counter()
    out = {tp_label(s, f): dryrun.dryrun_one(
        LM_ARCH, shape.name, strategy=s, fsdp=f, profile="baseline",
        save=False, mesh=make_mesh(TP_MESH, ("data", "model")),
        config=multi_rank_config(), input_shape=shape) for s, f in TP_RUNS}
    return {"runs": out, "families": tp_family_dryruns(),
            "seconds": time.perf_counter() - t0}


def tp_gloo_check(dev):
    """gloo's bf16 all-reduce and reduce-scatter on CUDA tensors of this
    card (the TP collectives run in the activations' dtype)."""
    import torch
    import torch.distributed as dist
    W, r = dist.get_world_size(), dist.get_rank()
    x = torch.full((6,), r + 1.0, dtype=torch.bfloat16, device=dev)
    dist.all_reduce(x)
    full = torch.arange(W * 3, dtype=torch.bfloat16, device=dev)
    part = torch.empty(3, dtype=torch.bfloat16, device=dev)
    dist.reduce_scatter_tensor(part, full)
    return {"all_reduce_bf16": bool((x == W * (W + 1) / 2).all()),
            "reduce_scatter_bf16": bool(torch.equal(
                part, full[r * 3:(r + 1) * 3] * W))}


def tp_train(dev, strategy, fsdp, batches):
    """``SHARD_STEPS`` steps of full-width SmolLM at ``MULTI_RANK_LAYERS``
    on the (2, 2) mesh from seed 0's weights: losses, the first step's
    collectives, launches, build and step times, peak memory and the
    parameters a rank holds."""
    import torch
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.costmodel.collectives import record_collectives, stats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(multi_rank_config(), use_kernel=True, device=dev)
    ts = build_train_step(model, optim.adamw(LM_LR, use_fused=True),
                          get_strategy(strategy),
                          make_mesh(TP_MESH, ("data", "model")),
                          model_axis="model", fsdp=fsdp)
    state = ts.init_state()
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_lm_launches()
    losses, ms, coll = [], [], None
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with record_collectives() as recs:
            state, m = ts.step_fn(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            st = stats(recs)
            coll = {"bytes_by_kind": st.bytes_by_kind, "counts": st.counts,
                    "wire_bytes": st.wire_bytes}
    return {"losses": losses, "step_ms": ms, "collectives": coll,
            "launches": lm_launches(), "build_s": build_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "local_params": sum(p.numel() for p in state["params"])}


def tp_greedy(dev, prefill, decode, tokens, prompt_len, n, V):
    import torch
    logits, cache = prefill({"tokens": tokens})
    tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
    out = [tok]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(n):
        logits, cache = decode(tok, cache, prompt_len + i)
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None].int()
        out.append(tok)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / n if n else None
    del cache
    return torch.cat(out, dim=1).cpu(), ms


def tp_serve(dev, dtype, mesh_shape, B, cache_len, prompt_len, n):
    """Greedy decoding of ``n`` tokens over the mesh and, on this rank
    alone, of the same prompts (its rows of both), full-width SmolLM at
    ``MULTI_RANK_LAYERS``; ms a decode step of each; the query heads
    kernel 8 saw a launch in the mesh's prefill; the collectives each
    decode step over the mesh issued; the call's seconds."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import build_serve_step
    from repro_torch.costmodel.collectives import record_collectives, stats
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = dataclasses.replace(multi_rank_config(), dtype=dtype)
    model = build_model(cfg, use_kernel=True, device=dev)
    heads = []

    def attention(q, k, v, window=None):
        heads.append((q.shape[2], k.shape[2]))
        return kops.swa_attention(q, k, v, window=window)
    model.attention_fn = attention
    rs = np.random.RandomState(B)
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, prompt_len))
                             .astype(np.int32), device=dev)
    reset_lm_launches()
    ss = build_serve_step(model, make_mesh(mesh_shape, ("data", "model")),
                          model_axis="model", batch_size=B,
                          cache_len=cache_len)
    cache_shape = list(ss.make_inputs("decode", cache_len)[1]["blocks"][0]
                       ["k"].shape)
    calls = []

    def decode(token, cache, pos):
        with record_collectives() as recs:
            out = ss.decode_fn(token, cache, pos)
        calls.append(stats(recs).counts)
        return out
    tokens, ms = tp_greedy(dev, ss.prefill_fn, decode,
                           ss.local_rows(prompt), prompt_len, n,
                           cfg.vocab_size)
    launches = lm_launches()
    prefill_heads = sorted(set(heads))
    torch.cuda.empty_cache()
    one = build_serve_step(model, batch_size=B, cache_len=cache_len)
    whole, ms_one = tp_greedy(dev, one.prefill_fn, one.decode_fn, prompt,
                              prompt_len, n, cfg.vocab_size)
    whole = ss.local_rows(whole)
    return {"equal": bool(torch.equal(tokens, whole)),
            "tokens": tokens.tolist(), "one_rank_tokens": whole.tolist(),
            "ms_per_token": ms, "one_rank_ms_per_token": ms_one,
            "launches": launches, "prefill_heads": prefill_heads,
            "cache_shape": cache_shape,
            "calls_per_token": [sum(c.values()) for c in calls],
            "call_kinds": calls[0] if calls else None,
            "seconds": time.perf_counter() - t0}


def tp_rank(rank, init, out_dir, t_spawn):
    """One rank of the phase's (2, 2) mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.launch.mesh import make_mesh, mesh_groups
    dev, clock = start_rank(rank, TP_RANKS, init, t_spawn)
    rec = {"start": clock}
    rec["backend"] = dist.get_backend()
    rec["gloo_cuda"] = tp_gloo_check(dev)
    cfg = get_config(LM_ARCH)
    # the sharding phase's batches, this rank's data coordinate's rows
    it = lm_batches(token_stream(SHARD_BATCH * SHARD_SEQ * 8,
                                 cfg.vocab_size, seed=23), SHARD_BATCH,
                    SHARD_SEQ, seed=23)
    D = TP_MESH[0]
    B = SHARD_BATCH // D
    di = make_mesh(TP_MESH, ("data", "model")).coords(rank)["data"]
    batches = [{k: torch.from_numpy(v[di * B:(di + 1) * B]).to(dev)
                for k, v in next(it).items()} for _ in range(SHARD_STEPS)]
    rec["train"] = {}
    for strategy, fsdp in TP_RUNS:
        rec["train"][tp_label(strategy, fsdp)] = tp_train(
            dev, strategy, fsdp, batches)
        # the run's model and state, held in cycles, go before the next
        # run's peak is read
        free_device_memory()
    rec["serve"] = {}
    for dtype in ("float32", "bfloat16"):
        rec["serve"][dtype] = tp_serve(dev, dtype, TP_MESH, *TP_SERVE,
                                       TP_TOKENS)
        free_device_memory()
    # the head-local case on ranks 0-2; rank 3 takes part in making the
    # mesh's groups (``dist.new_group`` is collective) and waits
    local = make_mesh(TP_LOCAL_MESH, ("data", "model"))
    runs = (("float32", TP_LOCAL_TOKENS), ("bfloat16", 0))
    if rank < local.size:
        rec["head_local"] = {
            dtype: tp_serve(dev, dtype, TP_LOCAL_MESH, *TP_LOCAL, n)
            for dtype, n in runs}
    else:
        for _ in runs:
            for axes in (("data",), ("model",)):
                mesh_groups(local, axes)
    free_device_memory()
    t0 = time.perf_counter()
    rec["families"] = tp_family_runs(rank, dev)
    rec["families_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def tp_slots_rank(rank, init, out_dir, t_spawn):
    """One rank of the (1, 6) mesh, SmolLM's ring on its slots at
    ``MULTI_RANK_LAYERS``: fp32 and bf16 serving."""
    import torch.distributed as dist
    dev, clock = start_rank(rank, math.prod(TP_SLOTS_MESH), init, t_spawn)
    rec = {"backend": dist.get_backend(), "start": clock}
    for dtype in ("float32", "bfloat16"):
        rec[dtype] = tp_serve(dev, dtype, TP_SLOTS_MESH, *TP_SLOTS,
                              TP_SLOTS_TOKENS)
        free_device_memory()
    Path(out_dir, f"slots{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


# the other families under tensor parallelism on the same (2, 2) mesh, in
# the same spawn: full width, depth cut (None: full depth), bf16 training
# at a global batch x seq (each data rank its half of the rows), then fp32
# serving at the same depth.  Pixtral is cut to one layer because four
# ranks' states share the card (two layers' TP step, beside the script's
# own process, ran out of its 80 GB); 2 steps a run because each step is
# the gloo all-reduce of 2-4 GB of fp32 gradient (4-6 s) and the script
# runs under a time limit
TP_FAMILIES = {
    "mixtral-8x7b": dict(layers=1, batch=4, seq=512, fsdp=True),
    "rwkv6-7b": dict(layers=2, batch=4, seq=512),
    "recurrentgemma-2b": dict(layers=3, batch=4, seq=512),
    "pixtral-12b": dict(layers=1, batch=2, seq=1280),
    "whisper-small": dict(layers=None, batch=4, seq=448),
}
TP_FAM_STEPS = 2
TP_FAM_LR = 3e-4
# fp32 greedy decoding: batch, prompt (Pixtral's holds its 1,024 patches),
# tokens; the ring holds the prompt and the tokens
TP_FAM_SERVE = dict(batch=4, prompt=64, tokens=8)
TP_FAM_PIXTRAL_PROMPT = 1088


def tp_family_config(arch, dtype="bfloat16"):
    import dataclasses
    return dataclasses.replace(fam_config(arch, TP_FAMILIES[arch]["layers"]),
                               dtype=dtype)


def tp_family_dryruns():
    """The ``baseline`` dry-run of each family's train runs (allreduce,
    and allreduce under FSDP where the phase runs it) at the phase's
    depth, width and shape on its (2, 2) mesh."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for arch, spec in TP_FAMILIES.items():
        shape = InputShape("tp_families", spec["seq"], spec["batch"],
                           "train")
        for fsdp in (False, True) if spec.get("fsdp") else (False,):
            out[tp_label("allreduce", fsdp) + "/" + arch] = dryrun.dryrun_one(
                arch, shape.name, fsdp=fsdp, profile="baseline", save=False,
                mesh=make_mesh(TP_MESH, ("data", "model")),
                config=tp_family_config(arch), input_shape=shape)
    return out


class _FirstCall:
    """Wraps ``fn`` and keeps a copy of the inputs of its first call."""

    def __init__(self, fn):
        self.fn, self.args, self.kwargs = fn, None, None

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = tuple(a.detach().clone() for a in args)
            self.kwargs = dict(kwargs)
        return self.fn(*args, **kwargs)


def tp_family_batches(arch, dev, rows):
    """TP_FAM_STEPS global batches of ``arch`` (token stream and stub
    inputs from fixed seeds), this data coordinate's ``rows``."""
    import numpy as np
    import torch
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.launch.train import stub_inputs
    spec, cfg = TP_FAMILIES[arch], tp_family_config(arch)
    B, S = spec["batch"], spec["seq"]
    it = lm_batches(token_stream(B * S * 8, cfg.vocab_size, seed=25), B, S,
                    seed=25)
    rs = np.random.RandomState(25)
    out = []
    for _ in range(TP_FAM_STEPS):
        b = {**next(it), **stub_inputs(cfg, B, rs)}
        out.append({k: torch.from_numpy(v[rows]).to(dev)
                    for k, v in b.items()})
    return out


def tp_family_expected(cfg, leaves, steps):
    """Launches a rank makes in ``steps`` allreduce steps: fused AdamW once
    a leaf (its slice), kernel 8 twice a causal attention layer (forward
    and remat; Whisper's encoder and cross-attention are not causal),
    kernel 9 twice an RWKV layer (on the tensor-core route)."""
    pat = cfg.layer_pattern
    wkv = 2 * steps * sum(pat[i % len(pat)] == "rwkv"
                          for i in range(cfg.n_layers))
    att = 2 * steps * attention_layers(cfg)
    return {"fused_adamw_flat": leaves * steps, "swa_attention_fwd": att,
            "swa_attention_fwd_wgmma": att, "swa_attention_fwd_tf32": 0,
            "wkv6_chunked": wkv,
            "wkv6_chunked_tc": wkv, **mlless_launches(0)}


def tp_family_replicated(dev, arch, shards):
    """The replicated run on one rank, no collective: TP_FAM_STEPS AdamW
    steps of ``arch`` from seed 0's weights, each on the mean of the
    gradients of the data ranks' rows (``shards``: per step, each data
    coordinate's batch, taken one after the other), the loss their mean,
    as the allreduce strategy over the data ranks computes them.  Losses,
    ms a step, peak memory."""
    import torch
    from repro_torch import optim
    from repro_torch.core.train_step import default_loss
    from repro_torch.models import build_model
    from repro_torch.models.params import reference_leaves
    from repro_torch.optim.optimizers import apply_updates
    model = build_model(tp_family_config(arch), use_kernel=True, device=dev)
    params = reference_leaves(model)
    opt = optim.adamw(TP_FAM_LR, use_fused=True)
    state = opt.init(params)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for step in shards:
        t0 = time.perf_counter()
        gsum, lsum = None, 0.0
        for b in step:
            loss = default_loss(model, b)
            g = torch.autograd.grad(loss, params)
            gsum = [x.float() for x in g] if gsum is None else \
                [a.add_(x.float()) for a, x in zip(gsum, g)]
            lsum += float(loss.detach())
        grads = [(a / len(step)).to(p.dtype) for a, p in zip(gsum, params)]
        updates, state = opt.update(grads, state, params)
        apply_updates(params, updates)
        losses.append(lsum / len(step))
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "step_ms": ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    del model, params, state, gsum, grads
    free_device_memory()
    return out


def tp_family_train(dev, arch, mesh, fsdp, batches):
    """TP_FAM_STEPS allreduce steps of ``arch`` from seed 0's weights over
    the (2, 2) mesh: losses, the first step's collectives, launches, ms a
    step, peak memory, parameters a rank, and the first call's inputs of
    kernels 8 and 9."""
    import torch
    from repro_torch import optim
    from repro_torch.core import build_train_step, get_strategy
    from repro_torch.costmodel.collectives import record_collectives, stats
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    cfg = tp_family_config(arch)
    model = build_model(cfg, use_kernel=True, device=dev)
    ts = build_train_step(model, optim.adamw(TP_FAM_LR, use_fused=True),
                          get_strategy("allreduce"), mesh, model_axis="model",
                          fsdp=fsdp)
    state = ts.init_state()
    k8, k9, wkv = _FirstCall(kops.swa_attention), _FirstCall(kops.wkv6), \
        kops.wkv6
    model.attention_fn = k8
    kops.wkv6 = k9
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_lm_launches()
    losses, ms, coll = [], [], None
    try:
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            with record_collectives() as recs:
                state, m = ts.step_fn(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                st = stats(recs)
                coll = {"bytes_by_kind": st.bytes_by_kind,
                        "counts": st.counts, "calls": len(recs)}
    finally:
        kops.wkv6 = wkv
    out = {"losses": losses, "step_ms": ms, "collectives": coll,
           "launches": lm_launches(),
           "expected": tp_family_expected(cfg, len(state["params"]),
                                          len(batches)),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "local_params": sum(p.numel() for p in state["params"])}
    del model, state, ts
    free_device_memory()
    return out, (k8.args, k8.kwargs), k9.args


def tp_family_parity(k8, k9):
    """Kernels 8 and 9 on the inputs of their first call on the TP path
    (this rank's heads), each against its plain version; ms of the
    kernel and of the plain version there.  Their launches here come after
    the main path's counts were read."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.kernels import wkv6
    out = {}
    if k8[0] is not None:
        (q, k, v), kw = k8
        window = kw.get("window")
        got = swa.swa_attention_fwd(q, k, v, window=window)
        want = ref.swa_attention(q, k, v, window=window)
        diff = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (diff <= SWA_BF16_ATOL + SWA_BF16_RTOL * want.float().abs())
            .all())
        out["swa_attention_fwd"] = {
            "shapes": [list(q.shape), list(k.shape)], "window": window,
            "dtype": str(q.dtype), "max_abs_err": float(diff.max()),
            "ok": ok,
            "ms": time_ms(lambda: swa.swa_attention_fwd(
                q, k, v, window=window), reps=10),
            "plain_ms": time_ms(lambda: ref.swa_attention(
                q, k, v, window=window), reps=3, warmup=1)}
    if k9 is not None:
        r, k, v, lw, u = k9
        got = wkv6.wkv6_chunked(r, k, v, lw, u)
        want = ref.wkv6_chunked(r, k, v, lw, u)
        diff = (got - want).abs()
        # the model's decays sit near 1 (exp(-exp(-6))), so y sums about
        # T outer products: WKV_F32_ATOL of the largest output where it
        # passes 1, the unit-scale cases' bar
        scale = max(1.0, float(want.abs().max()))
        out["wkv6_chunked"] = {
            "shapes": list(r.shape), "max_abs_err": float(diff.max()),
            "max_abs_out": float(want.abs().max()),
            "ok": bool(torch.isfinite(got).all())
            and float(diff.max()) <= WKV_F32_ATOL * scale,
            "ms": time_ms(lambda: wkv6.wkv6_chunked(r, k, v, lw, u),
                          reps=10),
            "plain_ms": time_ms(lambda: ref.wkv6_chunked(r, k, v, lw, u),
                                reps=3, warmup=1)}
    return out


def tp_family_serve(dev, arch, mesh):
    """fp32 greedy decoding over the mesh and, on this rank alone, of the
    same prompts (its rows of both): tokens, gloo calls of the prefill and
    a decode token, ms a token, kernel 8's launches and the heads it saw
    in the mesh's prefill, the cache a rank."""
    import numpy as np
    import torch
    from repro_torch.core import build_serve_step
    from repro_torch.costmodel.collectives import record_collectives
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    cfg = tp_family_config(arch, "float32")
    model = build_model(cfg, use_kernel=True, device=dev)
    heads = []

    def attention(q, k, v, window=None):
        heads.append((q.shape[2], k.shape[2]))
        return kops.swa_attention(q, k, v, window=window)
    model.attention_fn = attention
    B, n = TP_FAM_SERVE["batch"], TP_FAM_SERVE["tokens"]
    P = TP_FAM_PIXTRAL_PROMPT if cfg.family == "vlm" \
        else TP_FAM_SERVE["prompt"]
    cache_len = P + n
    rs = np.random.RandomState(B)
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, P))
                             .astype(np.int32), device=dev)
    extras = fam_stubs(cfg, B, seed=26)

    def greedy(ss, rows):
        batch = {"tokens": rows(prompt), **{k: rows(v)
                                            for k, v in extras.items()}}
        with record_collectives() as pre:
            logits, cache = ss.prefill_fn(batch)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        out, tok = [tok.int()], tok.int()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with record_collectives() as dec:
            for i in range(n):
                logits, cache = ss.decode_fn(tok, cache, P + i)
                tok = torch.argmax(logits[:, -1, :cfg.vocab_size],
                                   dim=-1)[:, None].int()
                out.append(tok)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / n
        shapes = [list(t.shape) for t in
                  _tree_tensors(cache)][:4]
        del cache
        return torch.cat(out, dim=1).cpu(), ms, len(pre), len(dec) / n, \
            sum(r.bytes for r in dec) / n, shapes

    reset_lm_launches()
    ss = build_serve_step(model, mesh, model_axis="model", batch_size=B,
                          cache_len=cache_len)
    tokens, ms, pre_calls, tok_calls, tok_bytes, cache_shapes = greedy(
        ss, ss.local_rows)
    launches = lm_launches()
    prefill_heads = sorted(set(heads))
    rows = ss.local_rows
    del model, ss
    free_device_memory()
    # one rank alone: the same seed's weights, drawn again whole
    one = build_serve_step(build_model(cfg, use_kernel=True, device=dev),
                           batch_size=B, cache_len=cache_len)
    whole, ms_one, _, _, _, _ = greedy(one, lambda x: x)
    whole = rows(whole)
    del one
    free_device_memory()
    return {"equal": bool(torch.equal(tokens, whole)),
            "tokens": tokens.tolist(), "one_rank_tokens": whole.tolist(),
            "ms_per_token": ms, "one_rank_ms_per_token": ms_one,
            "prefill_calls": pre_calls, "calls_per_token": tok_calls,
            "bytes_per_token": tok_bytes,
            "launches": launches, "prefill_heads": prefill_heads,
            "cache_shapes": cache_shapes, "prompt": P}


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return [tree]


def host_memory():
    """(this process's resident GiB, the machine's available GiB)."""
    def field(path, key):
        for line in Path(path).read_text().splitlines():
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2**20
        return None
    return field("/proc/self/status", "VmRSS"), \
        field("/proc/meminfo", "MemAvailable")


def free_host_cache():
    """Returns the pinned host blocks that gloo's copies of CUDA tensors
    left in PyTorch's host cache."""
    import torch
    getattr(torch._C, "_host_emptyCache", lambda: None)()


def free_device_memory():
    """Collects the cyclic garbage a model and its step leave (a step's
    closures hold the model) before returning the cached blocks, so the
    next rank's model finds the card free."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def tp_family_runs(rank, dev):
    """Every family of TP_FAMILIES on this rank: the mesh's train runs;
    on rank 0 the replicated run and the kernels' parity; then fp32
    serving."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(TP_MESH, ("data", "model"))
    D = TP_MESH[0]
    out = {}
    for arch, spec in TP_FAMILIES.items():
        t0 = time.perf_counter()
        half = spec["batch"] // D
        shards = [tp_family_batches(arch, dev, slice(i * half,
                                                     (i + 1) * half))
                  for i in range(D)]
        batches = shards[mesh.coords(rank)["data"]]
        rec = {"train": {}}
        parity_inputs = None
        for fsdp in (False, True) if spec.get("fsdp") else (False,):
            run, k8, k9 = tp_family_train(dev, arch, mesh, fsdp, batches)
            run["host_memory"] = host_memory()
            rec["train"][tp_label("allreduce", fsdp)] = run
            free_host_cache()
            if not fsdp:
                parity_inputs = (k8, k9)
            if rank == 0:
                log(f"[tp] {arch} {tp_label('allreduce', fsdp)}: losses "
                    f"{run['losses']}, ms {run['step_ms']}, host GiB (rank "
                    f"0, available) {run['host_memory']}")
        if rank == 0:
            rec["replicated"] = tp_family_replicated(
                dev, arch, list(zip(*shards)))
            rec["parity"] = tp_family_parity(*parity_inputs)
        del parity_inputs, shards, batches
        dist.barrier()
        free_device_memory()
        free_host_cache()
        rec["serve"] = tp_family_serve(dev, arch, mesh)
        free_host_cache()
        rec["seconds"] = time.perf_counter() - t0
        rec["host_memory"] = host_memory()
        out[arch] = rec
        dist.barrier()
        if rank == 0:
            log(f"[tp] {arch}: {rec['seconds']:.1f} s, host GiB (rank 0, "
                f"available) {rec['host_memory']}")
    return out


def tp_family_gates(ranks, dry):
    """Logs, then gates, each family's record from every rank: launches,
    losses (the same on every rank, within 2^-9 of the replicated run's),
    collectives equal to the dry-run's, peak a rank below the replicated
    run's, kernels 8 and 9 against their plain versions on the TP path,
    fp32 tokens equal to one rank's.  Returns rank 0's record with the
    others' launches and peaks."""
    fams = [r["families"] for r in ranks]
    out = {}
    for arch in TP_FAMILIES:
        spec, cfg = TP_FAMILIES[arch], tp_family_config(arch)
        recs = [f[arch] for f in fams]
        r0 = recs[0]
        rep = r0["replicated"]
        rep_peak, rep_losses = rep["peak_mem_bytes"], rep["losses"]
        log(f"[tp] {arch} ({spec['layers'] or 'all'} layers, full width, "
            f"bf16, global batch {spec['batch']} x seq {spec['seq']}, "
            f"{TP_FAM_STEPS} steps, lr {TP_FAM_LR}) on {TP_MESH}: "
            f"{r0['seconds']:.1f} s; the replicated run (one rank, both "
            f"data ranks' rows): losses {rep_losses}, ms/step "
            f"{rep['step_ms']}, peak MiB {rep_peak / 2**20:.1f}")
        gaps = {}
        for label, run in r0["train"].items():
            want = dry[label + "/" + arch]
            log(f"[tp] {arch} {label}: losses {run['losses']}, ms/step "
                f"{run['step_ms']}, peak MiB a rank "
                f"{[r['train'][label]['peak_mem_bytes'] / 2**20 for r in recs]}"
                f" (the dry-run's estimate "
                f"{want['memory']['peak_estimate_gb'] * 1024:.1f}, argument "
                f"{want['memory']['argument_bytes'] / 2**20:.1f}), "
                f"parameters a rank {run['local_params']:,}, first step's "
                f"collectives {run['collectives']}, launches "
                f"{run['launches']}")
            gaps[label] = [abs(a - b) / abs(b)
                           for a, b in zip(run["losses"], rep_losses)]
        srv = r0["serve"]
        log(f"[tp] {arch} serve fp32 batch {TP_FAM_SERVE['batch']} x prompt "
            f"{srv['prompt']}, {TP_FAM_SERVE['tokens']} tokens: "
            f"{srv['ms_per_token']:.3f} ms a token over {TP_RANKS} ranks "
            f"({srv['one_rank_ms_per_token']:.3f} on one), gloo calls "
            f"{srv['prefill_calls']} a prefill and "
            f"{srv['calls_per_token']:.1f} a token "
            f"({srv['bytes_per_token']:,.0f} B); kernel 8 heads (q, kv) "
            f"{srv['prefill_heads']}; cache a rank {srv['cache_shapes']}; "
            f"launches {srv['launches']}; tokens equal "
            f"{[r['serve']['equal'] for r in recs]}")
        for name, par in r0["parity"].items():
            log(f"[tp] {arch} {name} on the TP path's first call "
                f"{par['shapes']}: max abs err {par['max_abs_err']:.3e} "
                f"against the plain version, {par['ms']:.4f} ms (plain "
                f"{par['plain_ms']:.4f} ms)")
        for r, rec in enumerate(recs):
            for label, run in rec["train"].items():
                check(run["launches"] == run["expected"],
                      f"[tp] {arch} rank {r} {label}: launches "
                      f"{run['launches']}, expected {run['expected']}")
                check(run["losses"] == r0["train"][label]["losses"]
                      and all(map(math.isfinite, run["losses"])),
                      f"[tp] {arch} rank {r} {label}: losses "
                      f"{run['losses']}")
                want = dry[label + "/" + arch]["collectives"]
                check(run["collectives"]["bytes_by_kind"]
                      == want["bytes_by_kind"]
                      and run["collectives"]["counts"] == want["counts"],
                      f"[tp] {arch} rank {r} {label}: collectives "
                      f"{run['collectives']} against the dry-run's {want}")
                check(run["peak_mem_bytes"] < rep_peak,
                      f"[tp] {arch} rank {r} {label}: peak "
                      f"{run['peak_mem_bytes']} B, not below the "
                      f"replicated run's {rep_peak}")
            check(rec["serve"]["equal"], f"[tp] {arch} rank {r} serve: "
                  f"{rec['serve']['tokens']} against one rank's "
                  f"{rec['serve']['one_rank_tokens']}")
            check_attention_route(rec["serve"]["launches"],
                                  attention_layers(cfg), "float32",
                                  f"[tp] {arch} rank {r} prefill",
                                  cfg.head_dim)
        for label, g in gaps.items():
            check(max(g) <= LM_STEP_RTOL,
                  f"[tp] {arch} {label} losses against the replicated "
                  f"run's {rep_losses}: rel gaps {g} > {LM_STEP_RTOL}")
        for name, par in r0["parity"].items():
            check(par["ok"], f"[tp] {arch} {name} on the TP path: "
                  f"max abs err {par['max_abs_err']:.3e}")
        if "rwkv" in cfg.layer_pattern:
            B = spec["batch"] // TP_MESH[0]
            check(r0["parity"]["wkv6_chunked"]["shapes"]
                  == [B, spec["seq"], cfg.d_model // cfg.rwkv_head_dim
                      // TP_MESH[1], cfg.rwkv_head_dim],
                  f"[tp] {arch}: kernel 9 at "
                  f"{r0['parity']['wkv6_chunked']['shapes']}")
        if attention_layers(cfg):
            check("swa_attention_fwd" in r0["parity"],
                  f"[tp] {arch}: kernel 8 never called on the TP path")
        out[arch] = {**r0, "loss_gaps": gaps,
                     "launches": {label: [r["train"][label]["launches"]
                                          for r in recs]
                                  for label in r0["train"]},
                     "peak_mem_bytes": {
                         label: [r["train"][label]["peak_mem_bytes"]
                                 for r in recs] for label in r0["train"]},
                     "replicated_peak_mem_bytes": rep_peak}
    log("[tp] families: losses within 2^-9 of the replicated runs', "
        "collectives equal the baseline dry-run's, peaks below the "
        "replicated runs', kernels 8 and 9 match their plain versions on "
        "the TP path, fp32 tokens equal one rank's")
    return out


def tp_phase(shard):
    """Tensor-parallel training and serving and the ``baseline`` dry-run
    on the card, held against the sharding phase's replicated run
    (``shard``, its record); returns the record.  Every number is logged
    before the gates."""
    import shutil
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    dry_path = os.path.join(out_dir, "dryrun.json")
    child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--tp-dryrun", dry_path])
    try:
        t_spawn = time.time()
        spawn_ranks(
            tp_rank, args=("file://" + os.path.join(out_dir, "pg"),
                           out_dir, t_spawn), nprocs=TP_RANKS)
        spawn_s = time.time() - t_spawn
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(TP_RANKS)]
        local = [r["head_local"] for r in ranks if "head_local" in r]
        check(len(local) == math.prod(TP_LOCAL_MESH),
              f"[tp] head-local ranks {len(local)}")
        n_slots = math.prod(TP_SLOTS_MESH)
        t_slots = time.time()
        spawn_ranks(
            tp_slots_rank, args=("file://" + os.path.join(out_dir,
                                                          "pg_slots"),
                                 out_dir, t_slots), nprocs=n_slots)
        slots_s = time.time() - t_slots
        slots = [json.loads(Path(out_dir, f"slots{r}.json").read_text())
                 for r in range(n_slots)]
        t_wait = time.time()
        check(child.wait(timeout=300) == 0, "[tp] the dry-run failed")
        wait_s = time.time() - t_wait
        dry = json.loads(Path(dry_path).read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    base = shard["train"]["allreduce/dp"]
    base_peak = max(shard["memory"]["allreduce/dp"]["peak_mem_bytes"])
    log(f"[tp] {LM_ARCH} full width, {MULTI_RANK_LAYERS} layers, bf16, "
        f"{TP_RANKS} ranks sharing the "
        f"card over {r0['backend']} on a {TP_MESH} (data, model) mesh, "
        f"global batch {SHARD_BATCH} x seq {SHARD_SEQ}, {SHARD_STEPS} steps "
        f"a run; gloo bf16 on CUDA tensors: "
        f"{[r['gloo_cuda'] for r in ranks]}")
    for label, run in r0["train"].items():
        log(f"[tp] train {label}: losses {run['losses']}, ms/step "
            f"{run['step_ms']}, peak MiB a rank "
            f"{[r['train'][label]['peak_mem_bytes'] / 2**20 for r in ranks]}"
            f", parameters a rank {run['local_params']:,}, first step's "
            f"collectives {run['collectives']}, launches {run['launches']}")
    log(f"[tp] the sharding phase's replicated run (4 data ranks): losses "
        f"{base['losses']}, peak MiB a rank {base_peak / 2**20:.1f}")
    for label, res in dry["runs"].items():
        log(f"[tp] dry-run {label} (baseline, {TP_MESH}): collectives "
            f"{res['collectives']['counts']} "
            f"{res['collectives']['bytes_by_kind']}, memory {res['memory']}"
            f", roofline {res['roofline']}")
    for dtype, res in r0["serve"].items():
        log(f"[tp] serve {dtype} batch {TP_SERVE[0]} x cache {TP_SERVE[1]} "
            f"on {TP_MESH}: ms a token {res['ms_per_token']:.3f} over "
            f"{TP_RANKS} ranks, {res['one_rank_ms_per_token']:.3f} on one; "
            f"tokens equal on every rank "
            f"{[r['serve'][dtype]['equal'] for r in ranks]}; kernel 8 heads "
            f"(q, kv) {res['prefill_heads']}; cache leaf a rank "
            f"{res['cache_shape']}; launches {res['launches']}")
    for dtype, res in local[0].items():
        log(f"[tp] head-local {TP_LOCAL_MESH} {dtype}: kernel 8 heads (q, kv)"
            f" {res['prefill_heads']}, cache leaf a rank "
            f"{res['cache_shape']}, launches {res['launches']}, tokens equal "
            f"{[r[dtype]['equal'] for r in local]}, ms a token "
            f"{res['ms_per_token']} ({res['one_rank_ms_per_token']} on one)")

    log(f"[tp] slots {TP_SLOTS_MESH}: the spawn of {len(slots)} ranks took "
        f"{slots_s:.1f} s")
    slots_calls = tp_slots_calls(MULTI_RANK_LAYERS)
    for dtype in ("float32", "bfloat16"):
        res = slots[0][dtype]
        log(f"[tp] slots {TP_SLOTS_MESH} {dtype}, {len(slots)} ranks over "
            f"{slots[0]['backend']}, batch {TP_SLOTS[0]} x cache "
            f"{TP_SLOTS[1]}, prompt {TP_SLOTS[2]}: kernel 8 heads (q, kv) "
            f"{res['prefill_heads']}, cache leaf a rank {res['cache_shape']}"
            f", launches {res['launches']}, gloo calls a token "
            f"{res['calls_per_token']} (by design {slots_calls}; kinds "
            f"{res['call_kinds']}), tokens equal "
            f"{[r[dtype]['equal'] for r in slots]}, ms a token "
            f"{res['ms_per_token']} ({res['one_rank_ms_per_token']} on one)")
    budget_spawn(f"tp {TP_MESH}", [r["start"] for r in ranks], spawn_s)
    for label, run in r0["train"].items():
        budget_train(f"tp train {label}", run)
    log(f"[budget] tp serve (rank 0): {TP_MESH} "
        f"{ {k: round(v['seconds'], 1) for k, v in r0['serve'].items()} } s, "
        f"{TP_LOCAL_MESH} "
        f"{ {k: round(v['seconds'], 1) for k, v in local[0].items()} } s; "
        f"the families {r0['families_s']:.1f} s")
    budget_spawn(f"tp slots {TP_SLOTS_MESH}", [r["start"] for r in slots],
                 slots_s)
    slot_s = {k: round(slots[0][k]["seconds"], 1)
              for k in ("float32", "bfloat16")}
    log(f"[budget] tp slots serve (rank 0): {slot_s} s")
    log(f"[budget] tp dry-run child: {dry['seconds']:.1f} s of dry-runs "
        f"beside the ranks; waited {wait_s:.1f} s for it after them")

    gaps = {}
    for r, res in enumerate(ranks):
        check(all(res["gloo_cuda"].values()),
              f"[tp] rank {r}: gloo on CUDA tensors {res['gloo_cuda']}")
        for label, run in res["train"].items():
            strategy = label.split("/")[0]
            want = shard_expected(strategy, MULTI_RANK_LAYERS)
            check(run["launches"] == want, f"[tp] rank {r} {label}: "
                  f"launches {run['launches']}, expected {want}")
            check(run["losses"] == r0["train"][label]["losses"]
                  and all(map(math.isfinite, run["losses"])),
                  f"[tp] rank {r} {label}: losses {run['losses']}")
            want = dry["runs"][label]["collectives"]
            check(run["collectives"]["bytes_by_kind"] == want["bytes_by_kind"]
                  and run["collectives"]["counts"] == want["counts"],
                  f"[tp] rank {r} {label}: collectives "
                  f"{run['collectives']} against the dry-run's {want}")
            check(run["peak_mem_bytes"] < base_peak,
                  f"[tp] rank {r} {label}: peak {run['peak_mem_bytes']} B, "
                  f"not below the replicated run's {base_peak}")
        for dtype, sres in res["serve"].items():
            if dtype == "float32":
                check(sres["equal"], f"[tp] rank {r} serve: {sres['tokens']}"
                      f" against one rank's {sres['one_rank_tokens']}")
            check_attention_route(sres["launches"], MULTI_RANK_LAYERS,
                                  dtype, f"[tp] rank {r} serve {dtype}")
            # 9 heads do not divide over 2: every head on every rank
            check(sres["prefill_heads"] == [[9, 3]],
                  f"[tp] rank {r}: kernel 8 saw {sres['prefill_heads']}")
    for label in ("allreduce/tp", "allreduce/fsdp"):
        got = r0["train"][label]["losses"]
        gaps[label] = [abs(a - b) / abs(b) for a, b in zip(got,
                                                           base["losses"])]
        check(max(gaps[label]) <= LM_STEP_RTOL,
              f"[tp] {label} losses {got} against the replicated run's "
              f"{base['losses']}: rel gaps {gaps[label]} > {LM_STEP_RTOL}")
    for r, res in enumerate(local):
        check(res["float32"]["equal"], f"[tp] head-local rank {r}: "
              f"{res['float32']['tokens']} against one rank's "
              f"{res['float32']['one_rank_tokens']}")
        for dtype, sres in res.items():
            check(sres["prefill_heads"] == [[3, 1]],
                  f"[tp] head-local rank {r} {dtype}: heads "
                  f"{sres['prefill_heads']}")
            check_attention_route(sres["launches"], MULTI_RANK_LAYERS,
                                  dtype, f"[tp] head-local rank {r} {dtype}")
    for r, res in enumerate(slots):
        check(res["float32"]["equal"], f"[tp] slots rank {r}: "
              f"{res['float32']['tokens']} against one rank's "
              f"{res['float32']['one_rank_tokens']}")
        for dtype in ("float32", "bfloat16"):
            sres = res[dtype]
            # every head on every rank: 9 / 3 do not divide over 6
            check(sres["prefill_heads"] == [[9, 3]],
                  f"[tp] slots rank {r} {dtype}: heads "
                  f"{sres['prefill_heads']}")
            check_attention_route(sres["launches"], MULTI_RANK_LAYERS, dtype,
                                  f"[tp] slots rank {r} {dtype}")
            check(sres["cache_shape"] == [MULTI_RANK_LAYERS, TP_SLOTS[0],
                                          TP_SLOTS[1] // math.prod(
                                              TP_SLOTS_MESH), 3, 64],
                  f"[tp] slots rank {r} {dtype}: cache leaf "
                  f"{sres['cache_shape']}")
            check(sres["calls_per_token"] == [slots_calls]
                  * TP_SLOTS_TOKENS, f"[tp] slots rank {r} {dtype}: gloo "
                  f"calls a token {sres['calls_per_token']}, by design "
                  f"{slots_calls}")
    log(f"[tp] allreduce losses within {LM_STEP_RTOL} of the replicated "
        f"run's (gaps {gaps}); collective bytes and counts equal the "
        "baseline dry-run's; peak memory a rank below the replicated run's; "
        "fp32 tokens equal one rank's on all three meshes; kernel 8 on 3 "
        "heads a rank on (1, 3), on 9 on (1, 6) with the ring on its slots")
    families = tp_family_gates(ranks, dry["families"])
    record = {"train": r0["train"],
              "launches": {label: [r["train"][label]["launches"]
                                   for r in ranks] for label in r0["train"]},
              "peak_mem_bytes": {label: [r["train"][label]["peak_mem_bytes"]
                                         for r in ranks]
                                 for label in r0["train"]},
              "replicated": {"losses": base["losses"],
                             "peak_mem_bytes": base_peak},
              "loss_gaps": gaps, "serve": r0["serve"],
              "head_local": local[0], "dryrun": dry,
              "slots": slots[0], "slots_seconds": slots_s,
              "slots_launches": {dtype: [r[dtype]["launches"] for r in slots]
                                 for dtype in ("float32", "bfloat16")},
              "gloo_cuda": r0["gloo_cuda"], "families": families,
              "layers": MULTI_RANK_LAYERS, "spawn_s": spawn_s,
              "start": [r["start"] for r in ranks],
              "slots_start": [r["start"] for r in slots],
              "dryrun_wait_s": wait_s}
    record["seconds"] = time.perf_counter() - t0
    log(f"[tp] phase took {record['seconds']:.1f} s")
    return record


def main(argv):
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the repository: src/repro_torch is "
              "missing", file=sys.stderr)
        return 2
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare-mlless", metavar="ROOT",
                    help="only time the MLLess step of this checkout and of "
                         "the one at ROOT, in turns")
    ap.add_argument("--mlless-step", metavar="ARCH", help=argparse.SUPPRESS)
    ap.add_argument("--sharding-dryrun", metavar="PATH",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-dryrun", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--src", default=str(SRC), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.mlless_step:
        mlless_step(args.mlless_step)
        return 0
    if args.sharding_dryrun:
        Path(args.sharding_dryrun).write_text(json.dumps(shard_dryruns()))
        return 0
    if args.tp_dryrun:
        Path(args.tp_dryrun).write_text(json.dumps(tp_dryruns()))
        return 0
    t0 = time.perf_counter()
    setup()
    if args.compare_mlless:
        print(json.dumps({"compare_mlless": compare_mlless(
            args.compare_mlless)}))
        return 0
    dev = torch.device("cuda", 0)
    views = leaf_views(dev)
    check(len(views) == 83 and sum(v.shape[0] for v in views) == 12582,
          "MobileNet leaf views")
    norm_abs, norm_rel = kernel_parity(views, dev)
    times = kernel_times(views)
    seg_abs, seg_rel = segment_parity(dev)
    seg_times = segment_times(dev)
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                                    "pg")
    launches = train_phase(init)
    sizes = flat_sizes()
    robust_err = robust_parity(sizes, dev)
    robust_err["krum_pairwise"] = max(robust_err["krum_pairwise"],
                                      krum_parity(dev))
    robust_t = robust_times(sizes, dev)
    torch.cuda.empty_cache()
    runs = byzantine_phase()
    torch.cuda.empty_cache()
    table3 = table3_phase("file://" + os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_t3_"), "pg"))
    print(json.dumps({"table3": table3}))
    src = "src/repro_torch/kernels/csrc/block_significance.cu"
    main_path = "mobilenet-cifar MLLess train, batch 96, 30 steps"
    per_leaf = ("none: the MLLess step runs the segmented pair; timed here "
                "as one MLLess MobileNet step's 83 per-leaf calls")
    line = {"kernels": [
        {"name": "block_norms", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_significance.py:24",
         "launches": launches["block_norms"], "launches_run": per_leaf,
         "max_abs_err": norm_abs, "max_rel_err": norm_rel,
         **times["block_norms"],
         "shapes": "one MLLess step: 83 views (n_i, 256) fp32, 12582 rows",
         "library": "torch.linalg.vecdot(x, x, dim=1)"},
        {"name": "masked_filter", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_significance.py:55",
         "launches": launches["masked_filter"], "launches_run": per_leaf,
         "max_abs_err": 0.0, **times["masked_filter"],
         "shapes": "one MLLess step: 83 views (n_i, 256) fp32, 12582 rows",
         "library": None},
    ]}
    for name, line_no, err in (("segment_norms", 24, seg_abs),
                               ("segment_filter", 55, 0.0)):
        mobile = seg_times[name]["mobilenet-cifar"]
        line["kernels"].append(
            {"name": name, "route": "cuda", "source": src,
             "replaces": f"src/repro/kernels/block_significance.py:{line_no}",
             "launches": launches[name], "launches_run": main_path,
             "max_abs_err": err, **mobile, "library_ms": None,
             "max_rel_err": seg_rel if name == "segment_norms" else 0.0,
             "table3_launches": table3["paper"]["mlless"]["launches"][name],
             "table3_launches_run": f"table3 phase, arch mlless, "
                                    f"{TABLE3_STEPS} steps",
             "library": None, "resnet18": seg_times[name]["resnet18-cifar"],
             "shapes": "one MLLess MobileNet step: 83 leaves, fp32 "
                       "gradients, 12582 rows"})
    for name, line_no, run in (("trimmed_mean", 192, "trimmed_mean"),
                               ("coordinate_median", 213,
                                "coordinate_median"),
                               ("krum_pairwise", 241, "krum"),
                               ("weiszfeld_step", 285, "geometric_median")):
        line["kernels"].append(
            {"name": name, "route": "cuda", "source": ROBUST_SRC,
             "replaces": f"src/repro/kernels/robust_agg.py:{line_no}",
             "launches": runs[run]["launches"][name],
             "launches_run": f"rank 0 of {BYZ_RANKS}, byzantine {run}, "
                             f"{len(runs[run]['losses'])} steps",
             "max_abs_err": robust_err[name], **robust_t[name]})
    line["kernels"] += lm_phase()
    gemma = gemma_phase()
    attention = next(k for k in line["kernels"]
                     if k["name"] == "swa_attention_fwd")
    attention["gemma3"] = gemma
    adamw = next(k for k in line["kernels"]
                 if k["name"] == "fused_adamw_flat")
    # bf16 p and g, fp32 m and v: p, g, m, v read, m, v, update written
    adamw_bytes = 22 * GEMMA_PARAMS
    adamw["gemma3"] = {
        "bytes": adamw_bytes,
        "bound_ms": adamw_bytes / H100_BYTES_PER_S * 1e3,
        "run": f"{GEMMA_ARCH} ({GEMMA_LAYERS} layers) step, {GEMMA_LEAVES} "
               "leaves"}
    line["kernels"] += rwkv_phase()
    serve = serve_phase()
    print(json.dumps({"serve": serve}))
    attention["serve"] = {
        run: {"launches_per_prefill": serve[run]["launches"][
            "swa_attention_fwd"], "routes": {
                "wgmma": serve[run]["launches"]["swa_attention_fwd_wgmma"],
                "tf32": serve[run]["launches"]["swa_attention_fwd_tf32"]}}
        for run in ("smollm", "prefill_32k", "gemma3", "gemma3_fp32")}
    attention["serve"]["engine"] = {
        dtype: serve["engine"][dtype]["launches"]
        for dtype in ("float32", "bfloat16")}
    tf32 = next(k for k in line["kernels"]
                if k["name"] == "swa_attention_fwd_tf32")
    tf32["launches"] = serve["engine"]["float32"]["launches"][
        "swa_attention_fwd_tf32"]
    tf32["launches_run"] = (f"serve phase: the fp32 engine, {SERVE_ARCH} "
                            f"cut to {ENGINE_LAYERS} layers")
    tf32["gemma3_fp32_serve"] = {
        "launches_per_prefill": serve["gemma3_fp32"]["launches"][
            "swa_attention_fwd_tf32"],
        "run": f"serve phase: {GEMMA_ARCH} cut to {GEMMA_LAYERS} layers, "
               f"fp32, hd 320, batch {GEMMA_SERVE_FP32['batch']} x prompt "
               f"{GEMMA_SERVE_FP32['prompt']}"}
    torch.cuda.empty_cache()
    res = resilience_phase()
    print(json.dumps({"resilience": res}))
    for entry, key in ((adamw, "fused_adamw_flat"),
                       (attention, "swa_attention_fwd")):
        entry["resilience"] = {
            "launches": {label: [r[key] for r in ranks]
                         for label, ranks in res["launches"].items()},
            "run": f"resilience phase: {LM_ARCH} full width, "
                   f"{MULTI_RANK_LAYERS} layers, {RES_RANKS} ranks sharing "
                   "the card, one list entry a rank, each run's launches"}
    attention["resilience"]["wgmma_launches"] = {
        label: [r["swa_attention_fwd_wgmma"] for r in ranks]
        for label, ranks in res["launches"].items()}
    torch.cuda.empty_cache()
    fam = families_phase()
    print(json.dumps({"families": fam}))
    torch.cuda.empty_cache()
    shard = sharding_phase()
    print(json.dumps({"sharding": shard}))
    run = (f"sharding phase: {LM_ARCH} full width, {MULTI_RANK_LAYERS} "
           f"layers, {SHARD_RANKS} ranks sharing the card, {SHARD_STEPS} "
           "steps a run, one list entry a rank")
    for entry, keys in ((adamw, ("fused_adamw_flat",)),
                        (attention, ("swa_attention_fwd",
                                     "swa_attention_fwd_wgmma",
                                     "swa_attention_fwd_tf32"))):
        entry["sharding"] = {"launches": {
            label: [{k: r[k] for k in keys} for r in ranks]
            for label, ranks in shard["launches"].items()}, "run": run}
    for entry in line["kernels"]:
        if entry["name"] in ("segment_norms", "segment_filter"):
            entry["sharding"] = {"launches": {
                label: [r[entry["name"]] for r in ranks]
                for label, ranks in shard["launches"].items()}, "run": run}
    free_device_memory()
    tp = tp_phase(shard)
    print(json.dumps({"tp": tp}))
    run = (f"tp phase: {LM_ARCH} full width, {MULTI_RANK_LAYERS} layers, "
           f"on a {TP_MESH} (data, model) mesh, {TP_RANKS} ranks sharing "
           f"the card, {SHARD_STEPS} steps a run, one list entry a rank")
    for entry, keys in ((adamw, ("fused_adamw_flat",)),
                        (attention, ("swa_attention_fwd",
                                     "swa_attention_fwd_wgmma",
                                     "swa_attention_fwd_tf32"))):
        entry["tp"] = {"launches": {
            label: [{k: r[k] for k in keys} for r in ranks]
            for label, ranks in tp["launches"].items()}, "run": run}
    for entry in line["kernels"]:
        if entry["name"] in ("segment_norms", "segment_filter"):
            entry["tp"] = {"launches": {
                label: [r[entry["name"]] for r in ranks]
                for label, ranks in tp["launches"].items()}, "run": run}
    attention["tp_slots"] = {
        "launches": {dtype: [{k: r[k] for k in ("swa_attention_fwd",
                                                "swa_attention_fwd_wgmma",
                                                "swa_attention_fwd_tf32")}
                             for r in ranks]
                     for dtype, ranks in tp["slots_launches"].items()},
        "run": f"tp phase: {LM_ARCH} full width, {MULTI_RANK_LAYERS} "
               f"layers, on a {TP_SLOTS_MESH} (data, model) mesh, the ring "
               f"on its slots, {math.prod(TP_SLOTS_MESH)} ranks sharing the "
               f"card, one prefill of batch {TP_SLOTS[0]} x {TP_SLOTS[2]} a "
               "dtype, one list entry a rank"}
    # the other families on the TP path: each kernel's launches a rank in
    # each train run, and its first call there against its plain version
    run = (f"tp phase, families: full width, depth cut, on a {TP_MESH} "
           f"(data, model) mesh, {TP_RANKS} ranks sharing the card, "
           f"{TP_FAM_STEPS} steps a run, one list entry a rank")
    wkv = next(k for k in line["kernels"] if k["name"] == "wkv6_chunked")
    for entry, keys in ((adamw, ("fused_adamw_flat",)),
                        (attention, ("swa_attention_fwd",
                                     "swa_attention_fwd_wgmma",
                                     "swa_attention_fwd_tf32")),
                        (wkv, ("wkv6_chunked", "wkv6_chunked_tc"))):
        entry["tp_families"] = {
            "launches": {f"{arch}/{label}": [{k: r[k] for k in keys}
                                             for r in ranks]
                         for arch, fam in tp["families"].items()
                         for label, ranks in fam["launches"].items()},
            "tp_path": {arch: fam["parity"][entry["name"]]
                        for arch, fam in tp["families"].items()
                        if entry["name"] in fam["parity"]},
            "run": run}
    attention["families"] = {
        "prefill_shapes": fam["attention"],
        "train_launches": {a: {k: r["launches"][k] for k in (
            "swa_attention_fwd", "swa_attention_fwd_wgmma",
            "swa_attention_fwd_tf32")}
            for a, r in fam["train"].items()},
        "prefill_launches": {a: r["launches"]
                             for a, r in fam["serve"].items()},
        "run": f"families phase: each family's train cell, {FAM_STEPS} "
               "steps, and one prefill of each serve cell"}
    adamw["families"] = {
        "launches": {a: r["launches"]["fused_adamw_flat"]
                     for a, r in fam["train"].items()},
        "leaves": {a: FAMILIES[a]["train"]["leaves"] for a in fam["train"]},
        "run": f"families phase: each family's train cell, {FAM_STEPS} "
               "steps"}
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
