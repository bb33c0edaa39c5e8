"""Timing spans and profiler traces (port of ``scann_tpu/utils/profiling.py``).

- ``Timer``: a named wall-clock accumulator for the stages of a path
  (featurize, pad and launch, a training step),
- ``trace(logdir)``: ``torch.profiler`` around a block, written as a Chrome
  trace (``*.pt.trace.json``) that ``chrome://tracing``, Perfetto or
  TensorBoard's profile plugin open.

Per-epoch structures/s is recorded by the Trainer in ``metrics.jsonl``;
these tools are for breaking a time down.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str, python_tracer: bool = True) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``logdir``; yields the
    profiler, whose ``key_averages()`` sums the events by name.

    The CPU activity is always recorded, the CUDA activity (kernels and
    copies on the card, from CUPTI) when a card is present. ``python_tracer
    =False`` drops the Python stack of each event (``with_stack=False``):
    use it for long windows, where the stacks dominate the trace's size."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, with_stack=python_tracer) as prof:
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


class Timer:
    """Accumulating wall-clock timer: ``with timer("featurize"): ...``.

    Host time: the span ends when the block returns. PyTorch returns before
    the card finishes, so a span around device work must end in
    ``torch.cuda.synchronize()`` (on the caller's side, inside the block),
    or it times the enqueue."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {c} calls, {t / c * 1e3:.2f} ms/call")
        return "\n".join(lines)
