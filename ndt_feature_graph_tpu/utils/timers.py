"""Profiling/observability: wall-clock stage timers + jax profiler
hooks.

The replacement of the reference's getDoubleTime()
checkpoints (t0..t6 in fuser_hmt.cpp:189-488) and callgrind hooks
(publish_graph_message.cpp:1264): stage timers that block on device
results, a scans/s tracker, and a context manager around
jax.profiler.trace for deep dives.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from collections import defaultdict

import jax
import jax.numpy as jnp


@jax.jit
def _digest(leaves):
    """ONE scalar depending on every (arithmetic) leaf buffer."""
    return sum(
        jnp.sum(x.astype(jnp.float32)) for x in leaves
    ) if leaves else jnp.float32(0.0)


def force_readback(tree):
    """Wait for a pytree's computation by reading back one jitted
    scalar digest of every leaf.  On the GPU, jax.block_until_ready
    waits just as well; the digest also forces leaves that are still
    lazy and costs one dispatch and one transfer however many leaves
    the tree has.  Non-arithmetic leaves (typed PRNG key arrays,
    strings) are keyed to their raw data or skipped."""
    leaves = []
    for leaf in jax.tree.leaves(tree):
        try:
            arr = jnp.asarray(leaf)
        except (TypeError, ValueError):
            continue
        if jax.dtypes.issubdtype(arr.dtype, jax.dtypes.prng_key):
            arr = jax.random.key_data(arr)
        if not (
            jnp.issubdtype(arr.dtype, jnp.number)
            or jnp.issubdtype(arr.dtype, jnp.bool_)
        ):
            continue
        leaves.append(arr)
    return float(_digest(leaves))


class StageTimers:
    """Accumulating named wall-clock timers (device-blocking)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                force_readback(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean_ms(self, name):
        c = self.counts[name]
        return 1e3 * self.totals[name] / c if c else 0.0

    def report(self):
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name:30s} {self.mean_ms(name):9.3f} ms avg "
                f"x{self.counts[name]}"
            )
        return "\n".join(lines)


class ThroughputMeter:
    """scans/s tracker (the BASELINE.md metric)."""

    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def tick(self, k=1):
        self.n += k

    @property
    def per_sec(self):
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0


@contextlib.contextmanager
def device_trace(logdir):
    """jax profiler trace around a region (view with tensorboard /
    xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_busy_s(logdir, device="/device:GPU:0"):
    """Busy seconds of one device in the newest trace under `logdir`:
    the union of the intervals in which a kernel or copy ran on any of
    its streams (the trace's own per-module summary lines, which span
    the gaps between kernels, are left out)."""
    paths = sorted(
        glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                               "*.xplane.pb"))
    )
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {logdir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    spans = []
    for plane in data.planes:
        if plane.name != device:
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or list(plane.lines):
            spans.extend((e.start_ns, e.end_ns) for e in line.events)
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9
