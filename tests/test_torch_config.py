"""The port's config copy against the JAX package's: field-equal presets."""

import dataclasses

import pytest

from kuiperllama_tpu import config as jcfg
from kuiperllama_tpu_torch import config as tcfg


@pytest.mark.parametrize("name", sorted(jcfg.MODEL_SHAPES))
def test_presets_field_equal(name):
    want = dataclasses.asdict(jcfg.preset_config(name, seq_len=1024))
    got = dataclasses.asdict(tcfg.preset_config(name, seq_len=1024))
    assert got == want
    assert sorted(tcfg.MODEL_SHAPES) == sorted(jcfg.MODEL_SHAPES)


@pytest.mark.parametrize("family", ["llama2", "llama3", "qwen2"])
def test_tiny_config_and_derived_fields(family):
    j = jcfg.tiny_config(family, seq_len=64)
    t = tcfg.tiny_config(family, seq_len=64)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.kv_dim, t.kv_mul) == (j.head_dim, j.kv_dim, j.kv_mul)


def test_json_round_trip_and_hf_rope_scaling():
    cfg = tcfg.preset_config("llama3.2-1b")
    assert tcfg.ModelConfig.from_json(cfg.to_json()) == cfg
    hf = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
    assert (dataclasses.asdict(tcfg.RopeScaling.from_hf(hf))
            == dataclasses.asdict(jcfg.RopeScaling.from_hf(hf)))
    assert tcfg.RopeScaling.from_hf({"type": "linear", "factor": 2.0}).factor == 2.0
    assert tcfg.RopeScaling.from_hf(None) is None
