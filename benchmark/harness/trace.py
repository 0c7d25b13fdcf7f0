"""The traced slice of a `--trace 1` run: torch.profiler (CUPTI) over a
bounded steady part of the window, opened and closed at the driver's step
boundaries, and the device intervals read from it.

The slice opens at the first step boundary after `start_share` of the
window and closes at the first boundary at least `slice_s` later (or at the
window's end). A user annotation `bench.slice` spans it, so its length and
the device's work are read on the profiler's own clock. Device activity is
every event the profiler puts on the device (kernels, copies, sets); busy
time is the length of their union inside the slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

SLICE = "bench.slice"


@dataclass
class Slice:
    """What the traced slice saw: its host-clock bounds within the window
    (t0, t1), the driver's steps inside it [first, last), its length on the
    profiler's clock, and the device and host events, each (name, start s,
    end s) from the slice's start."""

    t0: float = 0.0
    t1: float = 0.0
    first: int = 0
    last: int = 0
    length_s: float = 0.0
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)  # program counters over the slice


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, t0: float, t1: float) -> list:
    """(start, end) of the idle stretches of [t0, t1] between intervals."""
    out, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


class Tracer:
    """Opens and closes the profiler at step boundaries; `enabled=False`
    makes every call a no-op."""

    def __init__(self, enabled: bool, seconds: float, trace: Optional[dict] = None,
                 counters=dict):
        trace = trace or {}
        self.enabled = enabled
        self.counters = counters
        self.start_at = seconds * float(trace.get("start_share", 0.3))
        self.slice_s = float(trace.get("slice_s", 2.0))
        self.slice: Optional[Slice] = None
        self._prof = self._rf = None
        self._t_open = None

    def warm(self, sync):
        """One empty profile during set-up, so that the profiler's own start
        (CUPTI's) is not paid inside the window."""
        if self.enabled:
            prof = self._new()
            prof.start()
            sync()
            prof.stop()

    @staticmethod
    def _new():
        import torch.profiler as tp

        return tp.profile(activities=[tp.ProfilerActivity.CPU,
                                      tp.ProfilerActivity.CUDA])

    def boundary(self, now: float, step: int, sync, final: bool = False):
        """Called between steps (`now` seconds into the window, `step` the
        index of the next step); opens or closes the slice."""
        if not self.enabled:
            return
        if self._prof is None and self.slice is None and not final and now >= self.start_at:
            import torch

            sync()
            self._prof = self._new()
            self._prof.start()
            self._rf = torch.autograd.profiler.record_function(SLICE)
            self._rf.__enter__()
            self._t_open = now
            self._c_open = self.counters()
            self.slice = Slice(t0=now, first=step)
        elif self._prof is not None and (final or now - self._t_open >= self.slice_s):
            sync()
            self._rf.__exit__(None, None, None)
            self._prof.stop()
            self.slice.t1 = now
            self.slice.last = step
            c = self.counters()
            self.slice.counters = {k: c[k] - self._c_open.get(k, 0) for k in c}
            self._read(self._prof)
            self._prof = self._rf = None

    def _read(self, prof):
        from torch._C._autograd import DeviceType

        evs = prof.profiler.kineto_results.events()
        mark = [e for e in evs if e.name() == SLICE]
        if not mark:
            return
        a = mark[0].start_ns()
        b = a + mark[0].duration_ns()
        s = self.slice
        s.length_s = (b - a) / 1e9
        for e in evs:
            st, en = e.start_ns(), e.start_ns() + e.duration_ns()
            if en <= a or st >= b or e.name() == SLICE:
                continue
            item = (e.name(), (max(st, a) - a) / 1e9, (min(en, b) - a) / 1e9)
            if e.device_type() == DeviceType.CUDA:
                s.device.append(item)
            elif e.device_type() == DeviceType.CPU:
                s.host.append(item)


def busy_seconds(s: Slice) -> float:
    return union_seconds((a, b) for _, a, b in s.device)


def device_seconds(s: Slice, pattern) -> float:
    """Summed device time of the events whose name matches `pattern` (a
    compiled regular expression)."""
    return sum(b - a for n, a, b in s.device if pattern.search(n))


def breakdown(s: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host event that covers each gap's middle."""
    by = {}
    for n, a, b in s.device:
        by[n] = by.get(n, 0.0) + (b - a)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for a, b in sorted(gaps([(x, y) for _, x, y in s.device], 0.0, s.length_s),
                       key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        cover = [(y - x, n) for n, x, y in s.host if x <= mid <= y]
        idle.append([min(cover)[1] if cover else "no host event", b - a])
    return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": idle}
