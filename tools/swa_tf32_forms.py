#!/usr/bin/env python3
"""Forms of the fp32 attention kernel's hd-320 layout, timed against each
other on one NVIDIA GPU (built for an H100).

    python3 tools/swa_tf32_forms.py      # from the root of the repository

``csrc/swa_attention_tf32.cu`` at hd 320 splits each 16-row group's work
over a warp pair: O's columns, and Q.K^T's k steps, whose partial scores
the pair exchanges through shared memory.  This builds, beside the source
as it stands, the forms that design was chosen over, as text edits of the
source (hd 320 alone compiled): 16-key kv tiles, and each warp taking the
whole of Q.K^T (no exchange, 1.5x the products).  For each it prints
ptxas' spills and times it at Gemma-3's local and global layers (B 1, S
2048, 8 / 4 heads) as CUDA graphs in turns (every form, then every form
again in reverse order), with its largest error against the plain
version.  The last line is a JSON object with the readings.
"""
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/swa_attention_tf32.cu"
WHOLE_S = [
    ("constexpr int KD = HW / 8;", "constexpr int KD = HD / 8;"),
    ("const float* qr = Qs + col0 + 8 * kk + t;",
     "const float* qr = Qs + 8 * kk + t;"),
    ("const float* kr = Ks + (8 * j + g) * LD + col0 + 8 * kk + t;",
     "const float* kr = Ks + (8 * j + g) * LD + 8 * kk + t;"),
    ("    if constexpr (SPLIT > 1) {\n      // the pair's partials",
     "    if constexpr (false) {\n      // the pair's partials"),
]
FORMS = {
    "as built": [],
    "16-key tiles": [("HD <= 256 ? 16 : 32;", "HD <= 256 ? 16 : 16;")],
    "whole S a warp": WHOLE_S,
}
# (label, B, S, H, KV, hd, window), causal
SHAPES = [("gemma3 local", 1, 2048, 8, 4, 320, 1024),
          ("gemma3 global", 1, 2048, 8, 4, 320, None)]


def form_source(edits):
    """The kernel's source with ``edits`` made and only the hd-320 case of
    the entry point's switch left."""
    text = re.sub(r"    case (32|64|96|128|160|256): return launch<\d+>\(.*\n",
                  "", SOURCE.read_text())
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"swa_tf32_forms: the source no longer holds "
                             f"{old!r} once")
        text = text.replace(old, new)
    return text


def build(workdir):
    """{form: (library, ptxas' spill line at hd 320)}, built in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as swa
    procs = {}
    for i, (name, edits) in enumerate(FORMS.items()):
        src = workdir / f"form{i}.cu"
        src.write_text(form_source(edits))
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"swa_tf32_forms: nvcc failed on {name}:\n{log}")
        spill = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads",
                          log)
        handle = ctypes.CDLL(str(lib))
        fn = handle.rt_swa_attention_fwd_tf32
        fn.argtypes = swa._TF32_SIGNATURES["rt_swa_attention_fwd_tf32"]
        fn.restype = ctypes.c_int
        out[name] = (fn, spill.group(0) if spill else "no report")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("swa_tf32_forms: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(28)
    record = {"device": torch.cuda.get_device_name(0),
              "power_limit": smi.stdout.strip(), "forms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        forms = build(Path(tmp))
        for name, (_, spill) in forms.items():
            print(f"{name}: ptxas at hd 320: {spill}")
            record["forms"][name] = {"ptxas": spill}
        for label, B, S, H, KV, hd, window in SHAPES:
            q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       for n in (H, KV, KV))
            want = ref.swa_attention(q, k, v, window=window)

            def call(fn):
                o = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, S, H, KV, hd,
                         0 if window is None else window, 1,
                         1.0 / math.sqrt(hd),
                         torch.cuda.current_stream().cuda_stream)
                cs.check(err == 0, f"{label}: CUDA error {err}")
                return o

            times = {name: [] for name in forms}
            for name in list(forms) + list(reversed(list(forms))):
                times[name].append(cs.graphed_ms(
                    lambda fn=forms[name][0]: call(fn)))
            for name, (fn, _) in forms.items():
                err = float((call(fn) - want).abs().max())
                record["forms"][name][label] = {"graph_ms": times[name],
                                                "max_abs_err": err}
                print(f"{label} {name}: graphs in turns "
                      f"{[round(t, 4) for t in times[name]]} ms, max abs "
                      f"err {err:.3e}")
            del q, k, v, want
            torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
