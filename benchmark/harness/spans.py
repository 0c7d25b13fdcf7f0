"""What the per-layer metrics read of the program's own spans
(`kuiperllama_tpu_torch/utils/profiling.py`, names `kt.*`): their times as
the traced slice's host events of those names, on the device events' clock;
their attributes from the program's records. The program keeps records only
while a profiler records, and the set-up's warm profile runs none of its
code, so in a `--trace 1` run the records are the slice's. A program
without the recorder leaves both empty, and every reader here returns None.
"""

from __future__ import annotations

import bisect

from benchmark.harness import readers, trace

PREFIX = "kt."


def records(name: str) -> list:
    """The program's span records named `name` ([] where it keeps none)."""
    from benchmark.harness import program

    return [r for r in program.span_records() if r.name == name]


def host(s) -> list:
    """(name, start s, end s) of the slice's program spans, by start."""
    return sorted((e for e in s.host if e[0].startswith(PREFIX)), key=lambda e: e[1])


def mean(values):
    return sum(values) / len(values) if values else None


def queue_wait(ctx):
    """(mean ms, detail) of the waits from submit() to admission of the
    slice's first admissions."""
    recs = records("kt.engine.admit")
    waits = [w for r in recs for w in r.attrs.get("waits", ())]
    if not waits:
        return None, {}
    why = [r.attrs.get("why") for r in recs]
    return 1e3 * mean(waits), {"n": len(waits), "max_ms": 1e3 * max(waits),
                               "admits": len(recs), "no_slot": why.count("no_slot"),
                               "no_pages": why.count("no_pages")}


def prefill_seconds(s) -> list:
    """Each engine prefill span's length plus that of the fetch
    (`kt.engine.sync`) that follows it before another prefill or a decode
    chunk (a wave's chunks before its last have none)."""
    out, open_ = [], None
    for name, a, b in host(s):
        if name == "kt.engine.sync" and open_ is not None:
            out.append(open_ + (b - a))
            open_ = None
        elif name in ("kt.engine.prefill", "kt.engine.chunk"):
            if open_ is not None:
                out.append(open_)
            open_ = b - a if name == "kt.engine.prefill" else None
    if open_ is not None:
        out.append(open_)
    return out


def prefill_ms(ctx):
    """(mean ms, detail) of the slice's engine prefills, each with the
    fetch of its first tokens; detail: how many, and the prefill records'
    T, rows and graph route, counted by value."""
    s = ctx.slice
    t = [] if s is None else prefill_seconds(s)
    if not t:
        return None, {}
    recs = records("kt.engine.prefill")
    detail = {"n": len(t)}
    for key in ("T", "rows", "graph"):
        values = [str(r.attrs.get(key)) for r in recs]
        detail[key] = {v: values.count(v) for v in sorted(set(values))}
    return 1e3 * mean(t), detail


def useful_share(name: str):
    """(percent, detail): the real prompt tokens of the slice's `name`
    prefills over the tokens they computed."""
    recs = [r for r in records(name) if r.attrs.get("computed")]
    if not recs:
        return None, {}
    real = sum(r.attrs["tokens"] for r in recs)
    computed = sum(r.attrs["computed"] for r in recs)
    return 100.0 * real / computed, {"n": len(recs), "tokens": real,
                                     "computed": computed}


def page_use(ctx):
    """(percent, detail): pages holding tokens over pages allocated and
    still claimed for growth, mean over the slice's decode chunks."""
    recs = [r.attrs for r in records("kt.engine.chunk") if "pages_held" in r.attrs]
    recs = [a for a in recs if a["pages_allocated"] + a["pages_growth"] > 0]
    if not recs:
        return None, {}
    used = [a["pages_held"] / (a["pages_allocated"] + a["pages_growth"]) for a in recs]
    return 100.0 * mean(used), {
        "n": len(recs),
        "growth_pct_of_pool": 100.0 * mean([a["pages_growth"] / a["pool"] for a in recs]),
        "allocated_pct_of_pool": 100.0 * mean([a["pages_allocated"] / a["pool"]
                                               for a in recs])}


def idle_by_span(s) -> tuple:
    """The slice's device-idle seconds split by the innermost program span
    over each part ({name: seconds}), and the idle seconds outside every
    program span."""
    spans = host(s)
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    by, outside = {}, 0.0
    for a, b in trace.gaps([(x, y) for _, x, y in s.device], 0.0, s.length_s):
        cut = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cut, cut[1:]):
            mid = (x + y) / 2
            cover = [(e - st, n) for n, st, e in spans if st <= mid <= e]
            if cover:
                n = min(cover)[1]
                by[n] = by.get(n, 0.0) + (y - x)
            else:
                outside += y - x
    return by, outside


def program_idle(ctx):
    """(percent, detail): the device-idle share of the slice that lies
    inside a program span; the slice's device-idle share
    (`readers.device_idle`) less the idle time outside every program span,
    so never above it."""
    s = ctx.slice
    idle = readers.device_idle(ctx)
    if idle is None or not host(s):
        return None, {}
    by, outside = idle_by_span(s)
    detail = {"n": len(host(s)), "device_idle_pct": idle,
              "idle_s": {**{k: by[k] for k in sorted(by, key=lambda k: -by[k])},
                         "outside": outside}}
    return idle - 100.0 * outside / s.length_s, detail
