"""The plain float32 reference against the port's plain path on tiny qwen2
models (the test may import the port; the reference does not), and the
control one precision below."""

import pytest
import torch

from benchmark.harness import check, program, spec, weights
from benchmark.reference import lower

from conftest import TINY_GAP_LIMIT


def _port_logits(config, raw, ids):
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.linear import set_use_kernels
    from kuiperllama_tpu_torch.params import to_device

    T = len(ids)
    cfg = program.model_config(config, seq_len=T)
    params = to_device(program.params(raw), device="cpu", dtype=torch.float32)
    cache = decoder.init_kv_cache(cfg, batch=1, max_len=T, dtype=torch.float32,
                                  device="cpu")
    tokens = torch.tensor([ids], dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None]
    set_use_kernels(False)
    try:
        logits, _ = decoder.forward(cfg, params, tokens, pos, cache,
                                    drop_past_end=False)
    finally:
        set_use_kernels(True)
    return logits[0]


@pytest.mark.parametrize("name", ["tiny-int8", "tiny-bf16"])
def test_reference_matches_the_ports_plain_path(tiny_root, name):
    config = spec.load_json(f"{tiny_root}/benchmark/configs/{name}.json")
    ref = spec.family_module("reference", "qwen2", f"{tiny_root}/benchmark")
    ids = torch.randint(0, config["vocab_size"], (200,),
                        generator=torch.Generator().manual_seed(3)).tolist()
    raw = weights.make(config, 2 ** 33 + 1, "cpu")
    want = ref.logits(config, raw, [(ids, list(range(len(ids))))])[0]
    got = _port_logits(config, weights.make(config, 2 ** 33 + 1, "cpu"), ids)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale


def test_weights_are_the_same_bytes_from_one_seed():
    config = spec.load_json(f"{spec.BENCH_DIR}/configs/qwen2.5-7b-int8.json")
    config = dict(config, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, vocab_size=300,
                  benchmark=dict(config["benchmark"], group_size=32))
    a, b = weights.make(config, 7, "cpu"), weights.make(config, 7, "cpu")
    c = weights.make(config, 8, "cpu")
    assert torch.equal(a["layers"]["w2"]["q"], b["layers"]["w2"]["q"])
    assert torch.equal(a["lm_head"]["s"], b["lm_head"]["s"])
    assert not torch.equal(a["layers"]["w2"]["q"], c["layers"]["w2"]["q"])
    w = weights.dequantize(a["layers"]["wq"], 1)
    # fan-in scaled: GAIN / sqrt(K), times sqrt(13 / 12) from the spread scales
    want = weights.GAIN * 64 ** -0.5 * (13 / 12) ** 0.5
    assert w.shape == (64, 64) and 0.95 * want < float(w.std()) < 1.05 * want


@pytest.mark.parametrize("name", ["tiny-int8", "tiny-bf16"])
def test_the_control_is_one_precision_below(tiny_root, name):
    config = spec.load_json(f"{tiny_root}/benchmark/configs/{name}.json")
    raw = weights.make(config, 11, "cpu")
    w = weights.dequantize(raw["layers"]["w1"], 0)
    low = lower.weight_fn(config)(raw["layers"]["w1"], 0)
    if name == "tiny-int8":  # int4: at most 15 levels in a group of 32 rows
        assert all(len(torch.unique(low[i:i + 32, j])) <= 15
                   for i in range(0, 64, 32) for j in range(4))
    else:  # fp8 e4m3 of w / scale: half a step of 2^-3 relative, 2^-9 below 2^-6
        scale = w.abs().amax(dim=0, keepdim=True) / lower.FP8_MAX
        assert bool(((low - w).abs() <= 2 ** -4 * w.abs() + 2 ** -10 * scale + 1e-9).all())
    assert 0 < float((low - w).abs().max()) < float(w.abs().max())


@pytest.mark.parametrize("cell", ["tiny-int8.chat-b1", "tiny-bf16.chat-b1"])
def test_the_control_fails_the_limit_the_program_passes(tiny_root, cell):
    """The control tool at a tiny size: through the harness's own
    comparison against the cell's limits the program is correct on every
    seed and the control, put in its place, on none."""
    import contextlib
    import io
    import json

    from benchmark import control

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = control.main(["--workload", cell, "--seconds", "1.0", "--seeds", "21,22",
                           "--control-seeds", "21,22"],
                          device=torch.device("cpu"), root=tiny_root)
    assert rc == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summary["limit"] == TINY_GAP_LIMIT
    assert summary["lower"] <= TINY_GAP_LIMIT < summary["upper"]
    assert summary["program_correct"] == summary["seeds"] == 2
    assert summary["control_seeds"] == 2 and summary["control_correct"] == 0


def test_gaps_of_served_tokens():
    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 2.5]])
    assert check.served_gaps(lg, [1, 2]).tolist() == [0.0, 0.5]
    assert check.widest_gap([lg], [[2, 0]]) == 1.0
    limits = {k: {"limit": v} for k, v in
              {"max_logit_gap": 0.75, "short_answers": 0, "unfinished": 0}.items()}
    assert check.passed(check.judge([lg], [[1, 2]], [], 0, limits))
    assert not check.passed(check.judge([lg], [[2, 0]], [], 0, limits))
