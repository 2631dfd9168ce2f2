"""The program's spans against the card's intervals of a traced stretch.

The program records a span a stage while a profiler records
(``deepim_tpu_torch.utils.profiling``: name, ids of the span, its parent
and its root, ``time.time_ns()`` start and end, the host syncs counted on
it).  Kineto stamps the device's events on the same clock, so the rule
needs no conversion: the idle time inside a set of host intervals is
their length less the union of the device intervals (kernels and copies,
every stream) that overlap them.  A span's own intervals are its interval
less its children's: where it is the innermost open span.

The per-layer metrics ``refine.raster_front_idle_share``,
``refine.host_syncs_per_call``, ``train.synthesis_idle_share``,
``train.host_syncs_per_step`` and ``train.launch_idle_share`` read them
here.  Each reads nothing where the program records no span, as a program
without ``profiling.spans`` records none, and nothing where the program's
buffer dropped spans.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds 51

makes one traced run of a cell through ``run.execute`` and prints its
result line with ``spans`` added: the stretch's calls or steps a second,
the idle seconds by innermost span (the idle outside every span
included) and the syncs by span name.
"""

from __future__ import annotations

import collections

OUTSIDE = "(outside any span)"


def program_spans() -> list | None:
    """The spans the program kept, or None where it keeps none, and where
    its buffer overflowed: a partial set of spans would read short."""
    try:
        from deepim_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or profiling.dropped_spans():
        return None
    return list(read())


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint intervals covering the same points as ``intervals``."""
    out: list[list[int]] = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> int:
    """Length of the intersection of two unions."""
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def minus(a, b) -> list[tuple[int, int]]:
    """The union ``a`` less the union ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def idle_ns(host, device) -> int:
    """Idle nanoseconds of the union ``host`` against the union ``device``."""
    return sum(e - s for s, e in host) - overlap(host, device)


def own_intervals(spans, names) -> list[tuple[int, int]]:
    """Where a span named in ``names`` is the innermost open span."""
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append((s.start_ns, s.end_ns))
    own = []
    for s in spans:
        if s.name in names:
            own += minus([(s.start_ns, s.end_ns)], union(kids[s.id]))
    return union(own)


def whole_intervals(spans, names) -> list[tuple[int, int]]:
    """Where a span named in ``names`` is open, its children included."""
    return union((s.start_ns, s.end_ns) for s in spans if s.name in names)


def device_union(trace: dict) -> list[tuple[int, int]]:
    return union((s, e) for s, e, _ in trace["device"])


def idle_share(run, host) -> float | None:
    """100 x idle seconds inside ``host`` over the stretch's seconds."""
    t = run.trace
    if not host or not t or t["window_s"] <= 0:
        return None
    return 100.0 * idle_ns(host, device_union(t)) / 1e9 / t["window_s"]


def syncs_per_root(spans, name: str) -> float | None:
    """Host syncs counted under the root spans called ``name``, a root."""
    roots = {s.id for s in spans if s.name == name and s.parent is None}
    if not roots:
        return None
    return sum(s.syncs for s in spans if s.root in roots) / len(roots)


def idle_by_innermost(spans, device, t0: int, t1: int) -> dict[str, float]:
    """Idle seconds of the stretch [t0, t1] by innermost open span, and outside all."""
    dev = union((max(s, t0), min(e, t1)) for s, e, _ in device)
    out = {name: idle_ns(own_intervals(spans, {name}), dev) / 1e9
           for name in sorted({s.name for s in spans})}
    roots = union((s.start_ns, s.end_ns) for s in spans if s.parent is None)
    out[OUTSIDE] = idle_ns(minus([(t0, t1)], roots), dev) / 1e9
    return out


def main(argv=None, overrides: dict | None = None) -> int:
    """One traced run through ``run.execute`` (its set-up, window and check
    of ``correct``), then the stretch's spans against its device intervals."""
    import json

    import torch

    from portbench import run

    kept = []

    class Keeping(run.Tracer):
        def __init__(self, device):
            super().__init__(device)
            kept.append(self)

    args = run.parse(argv)
    args.trace = 1
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    tracer_class, run.Tracer = run.Tracer, Keeping
    try:
        result = run.execute(args, device, overrides)
    finally:
        run.Tracer = tracer_class
    tracer = kept[0]
    got = program_spans() or []
    result["spans"] = {
        "traced": tracer.calls, "traced_s": tracer.traced_s,
        "traced_rate": tracer.calls / tracer.traced_s if tracer.traced_s else None,
        "count": len(got),
        "idle_by_span": idle_by_innermost(got, tracer.summary()["device"], tracer.t0,
                                          tracer.t1),
        "syncs_by_span": {n: sum(s.syncs for s in got if s.name == n)
                          for n in sorted({s.name for s in got})},
    }
    print(json.dumps({"workload": args.workload, "seed": args.seed, **result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
