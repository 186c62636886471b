"""Profiling/tracing utilities (reference C14 + nvprof analogue).

The reference wraps phases in clock() timers and leans on external nvprof
(gpuLS.cuh:41 includes cuda_profiler_api.h but never calls it).  Here:

* ``trace(logdir)``    -- context manager around ``jax.profiler`` emitting a
                          TensorBoard-loadable trace of device activity.
* ``annotate(name)``   -- named trace region (shows up in the trace viewer).
* ``summarize_trace``  -- per-op device time from a ``trace`` capture.
* ``device_time(fn)``  -- elision-proof on-device timing of a jitted callable
                          using the repeat-loop differencing method (see
                          bench.py: a host sync carries a fixed cost that the
                          R-vs-1 difference cancels).
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region for the trace viewer."""
    return jax.profiler.TraceAnnotation(name)


# Process names the profiler gives a GPU's tracks in the perfetto JSON
# ("/device:GPU:0", ...); host threads are "/host:CPU" and the like.
DEVICE_TRACK = re.compile(r"^/device:GPU:\d+")


def summarize_trace(logdir: str, device_only: bool = True):
    """Aggregate per-op durations from a ``trace(logdir)`` capture.

    Parses the perfetto JSON the profiler writes (no TensorBoard needed) and
    returns {op_name: (total_seconds, count)}, sorted descending by time.
    With ``device_only`` (default) only events on GPU device tracks
    (``DEVICE_TRACK``) are counted: each kernel XLA launched (a cuFFT call,
    a fusion) appears under its own name.
    """
    import collections
    import glob as _glob
    import gzip
    import json

    paths = _glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz")
    if not paths:
        raise FileNotFoundError(f"no trace capture under {logdir!r}")
    d = json.load(gzip.open(sorted(paths)[-1]))
    evs = d.get("traceEvents", [])
    pids = {e.get("pid"): str(e["args"].get("name")) for e in evs
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dur = collections.defaultdict(float)
    cnt = collections.Counter()
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if device_only and not DEVICE_TRACK.match(pids.get(e.get("pid"), "")):
            continue
        dur[e["name"]] += e["dur"] * 1e-6
        cnt[e["name"]] += 1
    return dict(sorted(((k, (v, cnt[k])) for k, v in dur.items()),
                       key=lambda kv: -kv[1][0]))


def device_time(per_item: Callable, items, reps_hi: int = 101,
                best_of: int = 4) -> float:
    """Seconds per item of ``per_item`` (a traceable fn CArray/pytree->pytree)
    applied across ``items`` (a stacked pytree), measured on-device.

    Builds jitted programs that scan ``per_item`` over the items R times with
    a scalar data dependency between repetitions (so nothing is elided) and
    returns (t(R_hi) - t(1)) / ((R_hi - 1) * K): fixed dispatch/sync overhead
    cancels exactly.  Keep R_hi large: short bursts are dominated by host
    jitter.
    """
    leaves = jax.tree_util.tree_leaves(items)
    k = leaves[0].shape[0]

    def make(reps: int):
        def prog(its):
            def rep(_, acc):
                def body(c, x):
                    # EVERY leaf must depend on the carry or XLA can hoist
                    # the whole scan out of the rep loop.  Float leaves take
                    # the tiny carry directly; integer leaves (the sc16
                    # planar format) add a carry-derived value that rounds
                    # to 0 -- a true data dependence the compiler cannot
                    # fold away without knowing c.
                    def shift(l):
                        if jnp.issubdtype(l.dtype, jnp.floating):
                            return l + c
                        return l + (c * 1e-30).astype(l.dtype)
                    shifted = jax.tree_util.tree_map(shift, x)
                    out = per_item(shifted)
                    s = sum(jnp.sum(l) for l in jax.tree_util.tree_leaves(out))
                    return c + s * 1e-20, None
                c, _ = jax.lax.scan(body, acc, its)
                return c
            return jax.lax.fori_loop(0, reps, rep, jnp.float32(0.0))
        return jax.jit(prog)

    def timed(reps: int) -> float:
        f = make(reps)
        float(f(items))  # compile + warm
        best = float("inf")
        for _ in range(best_of):
            t0 = time.perf_counter()
            float(f(items))
            best = min(best, time.perf_counter() - t0)
        return best

    t1, thi = timed(1), timed(reps_hi)
    return max(thi - t1, 1e-12) / ((reps_hi - 1) * k)
