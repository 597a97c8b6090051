"""Profiling hooks.

The reference has only coarse wall-clock prints (SURVEY §5.1). Here:
a jax.profiler trace context for capturing device traces (viewable with
TensorBoard/XProf) and a lightweight epoch timer that forces device sync
so measured times are real.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Optional

import jax


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Capture an XLA device trace into logdir (no-op when logdir is None)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class EpochTimer:
    """Per-epoch wall timing with forced device synchronization."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


def annotate(name: str):
    """Named profiler region (shows up in captured traces)."""
    return jax.profiler.TraceAnnotation(name)


class TimedCalls(list):
    """Per-call seconds of a function swapped in by ``timed_calls``;
    ``last`` holds the last call's (args, kwargs)."""

    last = None


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """Swap ``owner.<name>`` (a module function or an instance method) for
    a wrapper that waits for each call's outputs with block_until_ready
    and records its wall time. Timing the jitted epoch program a ``fit``
    calls this way excludes fit's host-side set-up; the first call
    includes compilation."""
    fn = getattr(owner, name)
    calls = TimedCalls()

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        calls.append(time.perf_counter() - t0)
        calls.last = (args, kwargs)
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        if inspect.ismodule(owner):
            setattr(owner, name, fn)
        else:
            delattr(owner, name)  # drop the instance override


def busy_ns(intervals) -> int:
    """Length of the union of ``(start_ns, duration_ns)`` intervals: the
    time in which at least one of them runs."""
    total, end = 0, None
    for start, dur in sorted(intervals):
        stop = start + dur
        if end is None or start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return int(total)


def trace_breakdown(xplane_path: str, plane_prefix: str = "/device:", top: int = 10) -> dict:
    """Per trace line of every plane whose name starts with
    ``plane_prefix``: event count, busy time (union of the events), the
    span from first start to last end, and the ``top`` event names by
    summed duration. Reads the ``.xplane.pb`` that ``jax.profiler.trace``
    writes."""
    from collections import Counter

    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            events = [(e.start_ns, e.duration_ns, e.name) for e in line.events]
            if not events:
                continue
            by_name = Counter()
            for _, dur, name in events:
                by_name[name] += dur
            out[f"{plane.name} | {line.name}"] = {
                "events": len(events),
                "busy_ns": busy_ns((s, d) for s, d, _ in events),
                "span_ns": int(max(s + d for s, d, _ in events) - min(s for s, _, _ in events)),
                "top": [[name, int(ns)] for name, ns in by_name.most_common(top)],
            }
    return out
