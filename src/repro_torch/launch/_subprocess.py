"""Shared bootstrap for the multi-rank subprocess launchers
(``repro.launch._subprocess``, its generic half).

A launcher that runs a fleet of ranks (``resilient_train``) runs as
``python -m repro_torch.launch.<launcher>`` in a child process, which
spawns the ranks itself.  This module builds that child's environment
and reads its answer back.  The reference's ``child_env`` also forces a
count of XLA host devices, which has no meaning here: the child's ranks
are processes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Dict, Sequence


def src_root() -> str:
    """The ``src/`` directory providing the ``repro_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def child_env() -> Dict[str, str]:
    """A copy of the environment putting this repo's ``src/`` first on
    the child's PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (src_root() + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return env


def run_module(module: str, argv: Sequence[str], *,
               timeout: float = 1800.0) -> str:
    """Run ``python -m <module> <argv>``; return its stdout, raising
    ``RuntimeError`` (with the stderr tail) on a non-zero exit."""
    out = subprocess.run(
        [sys.executable, "-m", module, *argv],
        capture_output=True, text=True, timeout=timeout, env=child_env())
    if out.returncode != 0:
        raise RuntimeError(
            f"{module} exited {out.returncode}: {out.stderr[-3000:]}")
    return out.stdout


def parse_result_line(stdout: str,
                      numeric_except: Sequence[str] = ()) -> Dict[str, Any]:
    """Parse the last ``RESULT,k=v,...`` line of a launcher's stdout.

    Values are floated except the keys in ``numeric_except`` (kept as
    strings).  Raises ``RuntimeError`` when no RESULT line was printed
    (the launcher died before reporting)."""
    lines = [l for l in stdout.splitlines() if l.startswith("RESULT,")]
    if not lines:
        raise RuntimeError(
            f"no RESULT line in the launcher's output: {stdout[-2000:]!r}")
    fields = dict(kv.split("=", 1) for kv in lines[-1].split(",")[1:])
    return {k: (v if k in numeric_except else float(v))
            for k, v in fields.items()}


def read_json_out(path: str) -> Any:
    """Load a launcher's ``--json-out`` payload."""
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)
