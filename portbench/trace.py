"""The traced stretch of a ``--trace 1`` run and what is read from it.

The refine and training drivers open the stretch a little into the window
and close it later, at call boundaries of the one thread that launches
work; the serving driver traces its whole window, opening and closing it
with the service idle.  ``torch.profiler``
records the card's activity only (CUPTI: kernels, copies, sets), which
costs the host little; recording every CPU operation as well slowed the
host-bound refine loop about twofold on the chip, so what the host was
doing is taken instead by a sampler thread that reads the launching
thread's Python stack every ``SAMPLE_S`` seconds.  The events are read
raw from the profiler's result, without building its tables.  From them:

- ``busy_s``: the union of the device's intervals, so overlapping
  streams count once; ``window_s``: the stretch's host-clock length; the
  idle share is ``1 - busy_s / window_s``;
- ``device_ops``: device seconds by kernel name, the ten largest;
- ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by the program function (file and name) the launching
  thread was in most often during it.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

import torch

TRACE_FROM = 0.2  # share of the window before the stretch opens
TRACE_SPAN = 0.6  # share of the window the stretch lasts at most
TRACE_MAX_S = 6.0  # and at most this many seconds
SAMPLE_S = 0.002  # the host sampler's period
PROGRAM = "deepim_tpu_torch"


def _label(frame) -> str:
    """The innermost frame of the program on ``frame``'s stack, else the innermost."""
    inner = frame
    while frame is not None:
        path = frame.f_code.co_filename
        if PROGRAM in path:
            rel = path[path.index(PROGRAM) + len(PROGRAM) + 1:]
            return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return f"{os.path.basename(inner.f_code.co_filename)}:{inner.f_code.co_name}"


class _Sampler(threading.Thread):
    def __init__(self, ident: int):
        super().__init__(daemon=True)
        self.target = ident
        self.samples: list[tuple[int, str]] = []
        self.halt = threading.Event()

    def run(self):
        while not self.halt.is_set():
            frame = sys._current_frames().get(self.target)
            if frame is not None:
                self.samples.append((time.time_ns(), _label(frame)))
            time.sleep(SAMPLE_S)


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._prof = None
        self._sampler = None
        self.launcher = threading.get_ident()
        self.events = None
        self.samples = []
        self.t0 = self.t1 = None
        self.calls = 0  # calls or steps launched inside the stretch
        self.traced_s = 0.0  # host seconds from the stretch's opening to its close
        self._opened = None

    def _profile(self):
        return torch.autograd.profiler.profile(use_device="cuda" if self.cuda else None,
                                              use_kineto=True, use_cpu=not self.cuda)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up (CUPTI's first start is slow)."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def span(self, seconds: float) -> tuple[float, float]:
        """(open, close) of the stretch, in seconds into a window of ``seconds``."""
        start = TRACE_FROM * seconds
        return start, start + min(TRACE_SPAN * seconds, TRACE_MAX_S)

    @property
    def open(self) -> bool:
        return self._prof is not None

    @property
    def done(self) -> bool:
        return self.t1 is not None

    def start(self) -> None:
        self._sync()  # work launched before the stretch ends before it
        self._opened = time.perf_counter()
        self._prof = self._profile()
        self._prof.__enter__()
        self._sampler = _Sampler(self.launcher)
        self._sampler.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.time_ns()
        self._sampler.halt.set()
        self._prof.__exit__(None, None, None)
        self._sampler.join()
        self.samples = self._sampler.samples
        self.events = list(self._prof.kineto_results.events())
        self._prof = None
        self.traced_s += time.perf_counter() - self._opened

    def summary(self) -> dict:
        """busy_s, window_s, device intervals and the breakdown of the stretch."""
        from torch.autograd import DeviceType

        dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in self.events
                     if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
        t0, t1 = self.t0, self.t1
        merged = []
        for s, e, _ in dev:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        by_name: dict[str, float] = collections.defaultdict(float)
        for s, e, n in dev:
            by_name[n] += (e - s) / 1e9
        gaps, last = [], t0
        for s, e in merged + [[t1, t1]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        stamps = [t for t, _ in self.samples]

        def doing(s, e):
            import bisect

            lo, hi = bisect.bisect_left(stamps, s), bisect.bisect_right(stamps, e)
            inside = [label for _, label in self.samples[lo:hi]]
            if inside:
                return collections.Counter(inside).most_common(1)[0][0]
            return self.samples[lo - 1][1] if lo > 0 else "(no sample)"

        return {
            "busy_s": sum(e - s for s, e in merged) / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "device": dev,
            "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[doing(s, e)[:160], (e - s) / 1e9] for s, e in gaps[:10]],
        }


def kernel_seconds(summary: dict, fragment: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds ``fragment``."""
    hits = [(e - s) for s, e, n in summary["device"] if fragment in n]
    return sum(hits) / 1e9, len(hits)


def idle_share(run) -> float | None:
    """100 * (1 - busy / window) of the traced stretch, in percent."""
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
