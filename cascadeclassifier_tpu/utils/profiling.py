"""Tracing / profiling utilities.

The reference's only observability is wall-clock prints (TIME macro,
cascadeclassifier.cpp:277-283; precalculation timing,
o_cvcascadeboosttraindata.cpp:585-595). This rebuild upgrades this to:

  - ``timed(name)``: structured wall-clock scopes collected into a global
    registry (and optionally printed), replacing ad-hoc prints
  - ``trace(dir)``: a context manager around the JAX profiler — produces
    TensorBoard-compatible traces of device execution
  - ``annotate(name)``: jax.profiler.TraceAnnotation passthrough for
    labelling regions inside traced programs
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_TIMINGS: dict = defaultdict(list)


def timings() -> dict:
    """All collected {scope: [seconds, ...]} so far."""
    return dict(_TIMINGS)


def reset_timings():
    _TIMINGS.clear()


@contextlib.contextmanager
def timed(name: str, verbose: bool = False):
    """Wall-clock scope: appends to the timing registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TIMINGS[name].append(dt)
        if verbose:
            print(f"[{name}] {dt:.3f}s", flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """JAX device profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region inside device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def summary() -> str:
    lines = []
    for name, vals in sorted(_TIMINGS.items()):
        total = sum(vals)
        lines.append(
            f"{name:40s} n={len(vals):4d} total={total:8.3f}s "
            f"mean={total / len(vals):8.4f}s"
        )
    return "\n".join(lines)
