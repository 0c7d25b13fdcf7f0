"""The one traffic generator. A traffic file under `traffic/` gives its
parameters; a seed gives the order of each block, the token ids and the
weights.

Lengths follow the file's lognormal distributions (median, sigma), clipped
to [min, max], and are stratified: each block of `strata` consecutive
requests takes one length from each of `strata` equal-probability strata,
at a point inside each stratum that is the block's own (a low-discrepancy
offset of the block index), in an order that the seed draws. Open-loop gaps
are exponential at the file's rate, stratified the same way; request i is
due at the sum of the gaps before it (request 0 at 0). So every seed serves
the same set of lengths and gaps in each block, in an order of its own, and
the prompt token ids (uniform over the vocabulary) change with it too.
Points drawn from the seed as well changed the work from seed to seed: on
an H100 the Qwen2.5-0.5B chat-b1 cell's TPOT p95 spread 5% over seeds and
0.3% between two runs of one seed.

Requests are drawn block by block on demand, so a run draws as many as its
window takes and request i is the same however many are drawn.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

# Offsets of the strata points in block b: frac((b + 1) * c), one constant
# per drawn quantity, so prompts, outputs and gaps do not line up.
_OFFSET = {"prompt": (math.sqrt(5) - 1) / 2, "output": math.sqrt(2) - 1,
           "gap": math.sqrt(3) - 1}
_SEED_MOD = 2 ** 64


def stratum_points(strata: int, block: int, what: str) -> list:
    """The `strata` probabilities of block `block`, one inside each stratum."""
    off = ((block + 1) * _OFFSET[what]) % 1.0
    return [(k + off) / strata for k in range(strata)]


def lognormal_length(dist: dict, u: float) -> int:
    """The u-quantile of the lognormal (median, sigma), rounded and clipped."""
    z = NormalDist().inv_cdf(u)
    x = math.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return int(min(max(round(x), dist["min"]), dist["max"]))


def exponential_gap(rate: float, u: float) -> float:
    return -math.log1p(-u) / rate


class Schedule:
    """The requests of one run of a traffic mix at one seed."""

    def __init__(self, traffic: dict, vocab_size: int, seed: int):
        self.traffic = traffic
        self.vocab = int(vocab_size)
        self.seed = int(seed) % _SEED_MOD
        self.strata = int(traffic.get("strata", 8))
        self.rate = traffic.get("rate_per_s")
        self._blocks: dict = {}
        self._due = [0.0]

    def _block(self, b: int) -> list:
        blk = self._blocks.get(b)
        if blk is not None:
            return blk
        rng = np.random.default_rng([self.seed, b])
        n = self.strata
        p_pts, o_pts, g_pts = (
            [stratum_points(n, b, what)[k] for k in rng.permutation(n)]
            for what in ("prompt", "output", "gap"))
        blk = []
        for j in range(n):
            P = lognormal_length(self.traffic["prompt"], p_pts[j])
            N = lognormal_length(self.traffic["output"], o_pts[j])
            gap = exponential_gap(self.rate, g_pts[j]) if self.rate else 0.0
            ids = rng.integers(0, self.vocab, size=P).tolist()
            blk.append((ids, N, gap))
        self._blocks[b] = blk
        return blk

    def _entry(self, i: int):
        return self._block(i // self.strata)[i % self.strata]

    def prompt(self, i: int) -> list:
        return self._entry(i)[0]

    def lengths(self, i: int) -> tuple:
        """(prompt tokens, output tokens) of request i."""
        ids, N, _ = self._entry(i)
        return len(ids), N

    def max_new(self, i: int) -> int:
        return self._entry(i)[1]

    def due(self, i: int) -> float:
        """Open loop: seconds from the window's start at which request i is
        due."""
        while len(self._due) <= i:
            k = len(self._due) - 1
            self._due.append(self._due[-1] + self._entry(k)[2])
        return self._due[i]

    def expected_requests(self, seconds: float) -> int:
        """An upper bound on the requests a window of `seconds` can start,
        for sizing the warm-up: the open loop's due count with room, or the
        traffic file's `max_requests_per_s` times the window."""
        if self.rate:
            n = 0
            while self.due(n) < seconds * 1.5:
                n += 1
            return n + self.strata
        return int(self.traffic["max_requests_per_s"] * seconds) + self.strata
