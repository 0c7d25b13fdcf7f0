"""The seeded, stratified traffic schedule."""

import math

import pytest

from benchmark.harness.traffic import Schedule, lognormal_length, stratum_points

TRAFFIC = {"rate_per_s": 4.0, "strata": 8,
           "prompt": {"median": 512, "sigma": 1.0, "min": 32, "max": 2048},
           "output": {"median": 160, "sigma": 0.8, "min": 16, "max": 768}}


@pytest.mark.parametrize("what", ["prompt", "output"])
def test_each_block_takes_one_length_from_each_stratum(what):
    s = Schedule(TRAFFIC, 1000, seed=5)
    k = 0 if what == "prompt" else 1
    for b in range(4):
        pts = stratum_points(8, b, what)
        want = sorted(lognormal_length(TRAFFIC[what], u) for u in pts)
        assert sorted(s.lengths(i)[k] for i in range(8 * b, 8 * b + 8)) == want
        assert all(j / 8 <= u < (j + 1) / 8 for j, u in enumerate(pts))


def test_every_seed_the_same_set_in_each_block_in_an_order_of_its_own():
    a, b = Schedule(TRAFFIC, 1000, seed=1), Schedule(TRAFFIC, 1000, seed=2 ** 31 + 7)
    la = [a.lengths(i) for i in range(64)]
    lb = [b.lengths(i) for i in range(64)]
    assert la != lb
    for k in range(0, 64, 8):
        assert sorted(x[0] for x in la[k:k + 8]) == sorted(x[0] for x in lb[k:k + 8])
        assert sorted(x[1] for x in la[k:k + 8]) == sorted(x[1] for x in lb[k:k + 8])
        assert a.due(k) == pytest.approx(b.due(k), rel=1e-12)
    assert [a.due(i) for i in range(9)] != [b.due(i) for i in range(9)]
    assert a.prompt(3) != b.prompt(3)
    # the blocks of one seed are not all in one order
    firsts = {tuple(x[0] for x in la[k:k + 8]) for k in range(0, 64, 8)}
    assert len(firsts) == 8


def test_same_seed_same_requests_however_many_are_drawn():
    a, b = Schedule(TRAFFIC, 1000, seed=9), Schedule(TRAFFIC, 1000, seed=9)
    b.prompt(40)  # draws block 5 first
    assert all(a.prompt(i) == b.prompt(i) and a.due(i) == b.due(i) for i in range(48))
    assert all(0 <= t < 1000 for i in range(48) for t in a.prompt(i))


def test_open_loop_due_times_are_stratified_exponential_gaps():
    s = Schedule(TRAFFIC, 1000, seed=3)
    assert s.due(0) == 0.0
    gaps = [s.due(i + 1) - s.due(i) for i in range(800)]
    assert all(g > 0 for g in gaps)
    assert sum(gaps) / len(gaps) == pytest.approx(1 / 4.0, rel=0.02)
    # about `rate * seconds` requests are due in a window
    assert s.expected_requests(10.0) >= 40


def test_lengths_are_clipped_and_the_median_is_the_files():
    d = TRAFFIC["prompt"]
    assert lognormal_length(d, 0.5) == 512
    assert lognormal_length(d, 1e-9) == 32 and lognormal_length(d, 1 - 1e-9) == 2048
    assert lognormal_length(d, 0.6) == round(math.exp(math.log(512) + 0.2533471031357997))
