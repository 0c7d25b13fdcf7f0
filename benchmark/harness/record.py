"""What a driver records of one run: each request with its times, and each
step of work the driver saw (an engine step, or a Generator request) with
the work it did. Times are seconds from the window's start."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Req:
    index: int          # in the schedule
    prompt: list
    max_new: int
    due: float
    sent: float
    first: Optional[float] = None
    finish: Optional[float] = None
    out: list = field(default_factory=list)


@dataclass
class Step:
    t0: float
    t1: float
    prefill_lens: list = field(default_factory=list)  # real prompt tokens prefilled
    prefill_calls: int = 0
    decode_tokens: int = 0    # tokens decoded (first tokens are the prefill's)
    decode_ctx: float = 0.0   # cached positions those tokens' queries attend, summed
    decode_steps: int = 0
    active: int = 0           # rows that decoded in the step


@dataclass
class Run:
    reqs: list               # Req due in the window
    steps: list              # Step in the window
    window_s: float
    delivered: int           # output tokens on the host by the window's end
    counters: dict           # program counters over the window (deltas)
    slice: object = None     # trace.Slice of a traced run
    extra: dict = field(default_factory=dict)
