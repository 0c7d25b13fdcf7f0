"""What the per-layer metrics read (metrics/<name>.py each call one of
these): the run's record, the program's counters and the traced slice. A
reader that finds nothing to read returns None, and the metric is left out
of the run's line."""

from __future__ import annotations

import re
from dataclasses import dataclass

from benchmark.counts import peaks
from benchmark.harness import stats, trace

# The per-step megakernels' launch counters and their kernels' names: a
# slice whose trace shows fewer of these kernels than the counters say ran
# has lost launches, and its device-time readings are not sound.
MEGAKERNELS = {"fused_decode_step": "fused_decode_kernel",
               "fused_decode_step_big": "fused_big_kernel",
               "fused_decode_chunk": "fused_chunk_kernel"}


@dataclass
class Context:
    cell: object
    run: object
    counts: object   # counts/<family>.py

    @property
    def slice(self):
        s = self.run.slice
        return s if s is not None and s.length_s > 0 else None

    def slice_steps(self) -> list:
        s = self.slice
        return [] if s is None else self.run.steps[s.first:s.last]


def lost_launches(s) -> bool:
    for counter, kernel in MEGAKERNELS.items():
        n = s.counters.get(counter, 0)
        if n and sum(1 for name, _, _ in s.device if kernel in name) < n:
            return True
    return False


def least_seconds(ctx, st) -> float:
    """The least time the card could take for one step's work: prefill and
    decode each at the larger of their compute and memory bounds."""
    c, cfg = ctx.counts, ctx.cell.config
    t = 0.0
    if st.prefill_lens:
        t += peaks.least_seconds(*c.prefill_work(cfg, st.prefill_lens, st.prefill_calls))
    if st.decode_steps:
        t += peaks.least_seconds(*c.decode_work(cfg, st.decode_tokens, st.decode_ctx,
                                                st.decode_steps))
    return t


def step_mfu(ctx):
    """Percent: the slice's steps' least time over the slice's wall time."""
    s = ctx.slice
    steps = ctx.slice_steps()
    if s is None or not steps:
        return None
    return 100.0 * sum(least_seconds(ctx, st) for st in steps) / (s.t1 - s.t0)


def step_bound(ctx) -> str:
    """Which bound the slice's work sits under, summed over its steps."""
    c, cfg = ctx.counts, ctx.cell.config
    f = b = 0.0
    for st in ctx.slice_steps():
        if st.prefill_lens:
            pf, pb = c.prefill_work(cfg, st.prefill_lens, st.prefill_calls)
            f, b = f + pf, b + pb
        if st.decode_steps:
            df, db = c.decode_work(cfg, st.decode_tokens, st.decode_ctx, st.decode_steps)
            f, b = f + df, b + db
    return peaks.bound_of(f, b)


def roofline(ctx, nbytes: float, kernels: str):
    """Percent: `nbytes` over the peak bandwidth, over the device time of
    the kernels whose names match `kernels` in the slice."""
    s = ctx.slice
    if s is None or nbytes <= 0 or lost_launches(s):
        return None
    t = trace.device_seconds(s, re.compile(kernels))
    if t <= 0:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t


def device_idle(ctx):
    """Percent of the slice with nothing running on the device."""
    s = ctx.slice
    if s is None or not s.device or lost_launches(s):
        return None
    return 100.0 * (1.0 - trace.busy_seconds(s) / s.length_s)


def send_lag_p95_ms(ctx):
    lags = [(r.sent - r.due) * 1e3 for r in ctx.run.reqs]
    return stats.percentile(lags, 95) if lags else None


def mean_active(ctx):
    steps = [st for st in ctx.run.steps if st.decode_steps]
    return sum(st.active for st in steps) / len(steps) if steps else None


def megakernel_share(ctx):
    """Percent of the window's decode steps taken by a per-step
    megakernel."""
    steps = sum(st.decode_steps for st in ctx.run.steps)
    if not steps:
        return None
    c = ctx.run.counters
    n = c.get("fused_decode_step", 0) + c.get("fused_decode_step_big", 0)
    return 100.0 * n / steps
