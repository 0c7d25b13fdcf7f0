"""Percentiles and rates of the end-to-end metrics."""

import numpy as np
import pytest

from benchmark.harness import stats


@pytest.mark.parametrize("n", [1, 2, 7, 20, 301])
@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear(n, q):
    xs = np.random.default_rng(n).lognormal(size=n).tolist()
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_counts_misses_beyond_every_limit():
    xs = [1.0] * 95 + [stats.MISS_MS] * 5
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 99) == stats.MISS_MS
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)

