"""Stage timers, the samples/s logger and trace capture.

Port of ``deepim_tpu/utils/profiling.py``:

- :func:`stage`: a named region (``torch.profiler.record_function``) that
  shows in a :func:`trace` as the reference's ``jax.named_scope`` does in
  xprof;
- :func:`trace`: ``torch.profiler.profile`` of the enclosed block (CPU,
  and CUDA when the card is there), written to ``logdir`` as a Chrome
  trace;
- :class:`StageTimer`: wall-clock per stage, synchronizing the device the
  stage ran on before it stops the clock;
- :class:`Speedometer`: the reference's samples/s iterator, same log line.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def stage(name: str):
    """A named region of a pipeline stage (shows in :func:`trace`)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block into ``logdir/trace.json`` (Chrome trace)."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or a tree of
    them): each CUDA device a tensor lies on is synchronized."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(result)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class StageTimer:
    """Wall-clock stage timing with device synchronization.

    >>> t = StageTimer()
    >>> with t.time("render") as box:
    ...     box["result"] = render(...)  # timed to the device's completion
    >>> print(t.summary())

    A stage that hands no result syncs the current CUDA device (when there
    is one); one that hands a result syncs the devices its tensors lie on.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if out is not None:
                _sync(out)
            elif torch.cuda.is_available():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda x: -x[1]):
            n = self.counts[name]
            lines.append(f"{name:<24} {tot * 1e3 / max(n, 1):>9.2f} ms/call"
                         f"  x{n} = {tot * 1e3:>9.1f} ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Speedometer:
    """samples/s logging iterator (the reference's ``Speedometer``).

    >>> for step, batch in Speedometer(loader, batch_size=16, every=20, log=print):
    ...     ...
    """

    def __init__(self, iterable, batch_size: int, every: int = 20, log=print):
        self.iterable = iterable
        self.batch_size = batch_size
        self.every = every
        self.log = log

    def __iter__(self):
        t0 = time.perf_counter()
        for i, item in enumerate(self.iterable):
            yield i, item
            if (i + 1) % self.every == 0:
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                self.log(f"[speedometer] step {i + 1}: "
                         f"{self.every * self.batch_size / dt:.1f} samples/s")
