"""Spans of the program's stages, the host syncs inside them, and trace capture.

Port of ``deepim_tpu/utils/profiling.py``'s ``stage`` and ``trace``:

- :func:`stage`: a named region of a pipeline stage.  It records only
  while a torch profiler records in this thread
  (``torch.autograd._profiler_enabled()``); otherwise it returns one
  shared no-op context manager, so an untraced program pays one C call a
  span.  While recording, each span keeps a :class:`Span` in a buffer of
  at most ``MAX_SPANS`` (:func:`spans`, :func:`clear_spans`,
  :func:`dropped_spans`) and opens ``torch.profiler.record_function(name)``,
  so a :func:`trace` shows it as the reference's ``jax.named_scope``
  shows in xprof.  Start and end are read from ``time.time_ns()``, the
  clock kineto stamps its events with, so a device interval of the same
  profile falls inside the span that launched it with no conversion.
- Host syncs: while a root span (one opened with no span open in its
  thread) records, every device-to-host synchronisation of that thread is
  counted on its innermost open span (``Span.syncs``).  CUDA's sync debug
  mode is at warn while any root is open in the process (the first to
  open sets it, the last to close restores it) and its warnings are
  counted and kept from the user: ``.item()``, ``int(t)``, ``bool(t)``,
  a blocking ``.cpu()`` and a blocking copy from pageable host memory
  each count one.
- :func:`trace`: ``torch.profiler.profile`` of the enclosed block (CPU,
  and CUDA when the card is there), written to ``logdir`` as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
import time
import types
import warnings
from typing import Any, Mapping, NamedTuple

import torch

MAX_SPANS = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"
_SYNC_FILTER = ("always", re.compile(SYNC_WARNING, re.I), Warning, None, 0)


class Span(NamedTuple):
    """One closed span: ids are unique in the process; ``root`` is the id
    of the outermost span open when it opened (its own for a root)."""

    name: str
    id: int
    parent: int | None
    root: int
    attrs: Mapping[str, Any]
    start_ns: int
    end_ns: int
    syncs: int


_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_kept: list[Span] = []
_dropped = 0
_watching = 0  # root spans open, in every thread
_shown = warnings.showwarning  # what _seen hands other warnings to
_user_mode = None  # the sync debug mode the first root found (None: CUDA was down)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def stage(name: str, **attrs):
    """A named region of a pipeline stage: a recorded span while a profiler
    records in this thread, else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _OpenSpan(name, attrs)


def spans() -> tuple[Span, ...]:
    """The spans kept since the last :func:`clear_spans`, in closing order."""
    with _lock:
        return tuple(_kept)


def dropped_spans() -> int:
    """Spans closed while the buffer held ``MAX_SPANS``, and so not kept."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0


def _keep(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_kept) < MAX_SPANS:
            _kept.append(span)
        else:
            _dropped += 1


class _OpenSpan:
    """A recording span while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "syncs", "start_ns", "_region")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.syncs = name, attrs, 0

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        if up is None:
            _watch_open()
        stack.append(self)
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        try:
            self._region.__exit__(*exc)
        finally:
            _stack().pop()
            if self.parent is None:
                _watch_close()
        _keep(Span(self.name, self.id, self.parent, self.root,
                   types.MappingProxyType(self.attrs), self.start_ns, end_ns, self.syncs))
        return False


def _watch_open() -> None:
    """A root span opens.  The first of the process's open roots sets CUDA's
    sync debug mode to warn (when CUDA is up) and hands warnings to
    :func:`_seen`; the filter that lets every sync warning through is put
    first once and left there (CUDA raises none outside that mode), so the
    registry of warnings already shown is not reset at every root."""
    global _watching, _shown, _user_mode
    with _lock:
        _watching += 1
        if _watching > 1:
            return
        if not warnings.filters or warnings.filters[0] != _SYNC_FILTER:
            warnings.filterwarnings("always", message=SYNC_WARNING)
        _user_mode = None
        if torch.cuda.is_initialized():
            _user_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        if warnings.showwarning is not _seen:
            _shown = warnings.showwarning
        warnings.showwarning = _seen


def _watch_close() -> None:
    """A root span closes; the last open one restores what the first set."""
    global _watching
    with _lock:
        _watching -= 1
        if _watching:
            return
        if warnings.showwarning is _seen:
            warnings.showwarning = _shown
        if _user_mode is not None:
            torch.cuda.set_sync_debug_mode(_user_mode)


def _seen(message, category, filename, lineno, file=None, line=None):
    """A sync warning counts on its thread's innermost open span.  One from
    a thread with no span open reaches the user only where the debug mode
    was theirs; every other warning goes on as before."""
    if str(message).startswith(SYNC_WARNING):
        stack = _stack()
        if stack:
            stack[-1].syncs += 1
            return
        if not _user_mode:
            return
    _shown(message, category, filename, lineno, file, line)


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
