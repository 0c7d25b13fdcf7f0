"""The scratch tensors that kernel launches share, and their epoch.

The GEMV's split counters and the megakernels' staging buffers, partials
and tile counters live here, one tensor per (device, name), reused by every
launch and replaced by a larger one when a launch needs more. A CUDA graph
keeps the pointers it captured, so every replacement raises `epoch`: a
graph captured at an earlier epoch may point at freed memory, and
serving/graphs.py captures it again before its next replay. The GEMM's
split partials are not kept here: each call allocates its own (inside a
capture, from the graph's pool), so a prefill at a larger bucket, which
only raises the GEMM's rows, moves no epoch. The GEMV's counters grow with
a weight's columns and the megakernels' scratch with their plan, so the
first calls of a process move it, a decode step's after the prefill
before it was captured.

The counters start at zero and every kernel leaves them at zero. A launch
or a replay that fails part way can leave them dirty; `invalidate` zeroes
them and raises the epoch, so that nothing captured before runs again.
"""

from __future__ import annotations

import torch

_tensors: dict = {}
_counters: set = set()
epoch = 0


def scratch(device, name: str, numel: int, dtype, zero: bool = False) -> torch.Tensor:
    """A tensor of at least `numel` elements of `dtype`, kept per device and
    name; `zero` marks a counter, allocated as zeros (the kernels leave it
    at zero)."""
    global epoch
    key = (device.index, name)
    t = _tensors.get(key)
    if t is None or t.numel() < numel or t.dtype != dtype:
        t = (torch.zeros if zero else torch.empty)(max(numel, 1), dtype=dtype,
                                                   device=device)
        _tensors[key] = t
        if zero:
            _counters.add(key)
        epoch += 1
    return t


def invalidate():
    """Zero every counter and raise the epoch: after a failed launch or
    replay, no graph captured before runs again without a new capture."""
    global epoch
    for key in _counters:
        _tensors[key].zero_()
    epoch += 1
