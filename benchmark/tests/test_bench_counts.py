"""The FLOP and byte arithmetic against sizes worked out by hand."""

import json
import os

import pytest

from benchmark.counts import peaks
from benchmark.harness import spec

CONFIGS = os.path.join(spec.BENCH_DIR, "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def qwen2():
    return spec.family_module("counts", "qwen2")


def test_7b_int8_stream_bytes_by_hand(qwen2):
    cfg = _cfg("qwen2.5-7b-int8")
    # per layer: wqkv 3584 x 4608, wo 3584 x 3584, w13 3584 x 37888, w2 18944 x 3584
    int8_layer = 3584 * 4608 + 3584 * 3584 + 3584 * 37888 + 18944 * 3584
    assert int8_layer == 233_046_016
    # bf16 scales at group 256: 14 rows for K = 3584, 74 for K = 18944
    scales_layer = 2 * (14 * 4608 + 14 * 3584 + 14 * 37888 + 74 * 3584)
    assert scales_layer == 1_820_672
    lm = 3584 * 152064 + 2 * 14 * 152064
    assert qwen2.projection_bytes(cfg) == 28 * (int8_layer + scales_layer)
    assert qwen2.lm_head_bytes(cfg) == lm
    small = (2 * 28 + 1) * 3584 * 4 + 28 * (3584 + 1024) * 2
    assert qwen2.stream_bytes(cfg) == 28 * (int8_layer + scales_layer) + lm + small
    assert qwen2.stream_bytes(cfg) == 7_126_597_632
    assert qwen2.int8_stream_bytes(cfg) == 28 * (int8_layer + scales_layer) + lm
    # the floor of a B = 1 decode step: 2.127 ms at 3.35 TB/s
    assert qwen2.stream_bytes(cfg) / peaks.HBM_BYTES_PER_S == pytest.approx(2.1273e-3, rel=1e-4)


def test_kv_bytes_per_token_by_hand(qwen2):
    # 28 layers x 4 kv heads x 128 lanes x (k, v) x bf16 = 56 KiB
    assert qwen2.kv_bytes_per_token(_cfg("qwen2.5-7b-int8")) == 57_344
    # 24 layers x 2 kv heads x 64 lanes x 2 x 2
    assert qwen2.kv_bytes_per_token(_cfg("qwen2.5-0.5b-bf16")) == 12_288


def test_05b_bf16_bytes_by_hand(qwen2):
    cfg = _cfg("qwen2.5-0.5b-bf16")
    params_layer = 896 * 1152 + 896 * 896 + 896 * 9728 + 4864 * 896
    assert qwen2.projection_params(cfg) == 24 * params_layer == 357_826_560
    assert qwen2.lm_head_bytes(cfg) == 151936 * 896 * 2  # tied: the embedding
    assert qwen2.int8_stream_bytes(cfg) == 0
    total = qwen2.stream_bytes(cfg) + 151936 * 896 * 2 - qwen2.lm_head_bytes(cfg)
    assert total == pytest.approx(988e6, rel=2e-3)  # the whole model, tied once


def test_decode_and_prefill_work(qwen2):
    cfg = _cfg("qwen2.5-7b-int8")
    proj, lm = qwen2.projection_params(cfg), qwen2.lm_head_params(cfg)
    f, b = qwen2.decode_work(cfg, tokens=1, ctx_sum=100, steps=1)
    assert f == 2 * (proj + lm) + 4 * 100 * 28 * 28 * 128
    assert b == qwen2.stream_bytes(cfg) + 3584 * 2 + 101 * 57_344
    f, b = qwen2.prefill_work(cfg, [3, 5], calls=1)
    pairs = 3 * 4 / 2 + 5 * 6 / 2
    assert f == 2 * proj * 8 + 2 * lm * 2 + 4 * pairs * 28 * 28 * 128
    assert b == qwen2.stream_bytes(cfg) + 8 * (3584 * 2 + 57_344)
    # B = 1 decode is memory-bound, a long prefill compute-bound
    assert peaks.bound_of(*qwen2.decode_work(cfg, 1, 500, 1)) == "memory"
    assert peaks.bound_of(*qwen2.prefill_work(cfg, [2048], 1)) == "compute"
