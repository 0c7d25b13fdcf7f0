"""The big-kernel phase-cost probe (tools/big_phase_costs.py) on the CPU:
each variant's replacements still apply to csrc/fused_decode_big.cu and its
header as often as they say, and change only what they name; without a
card the probe exits."""

import pytest

from kuiperllama_tpu_torch.tools import big_phase_costs as bpc


@pytest.mark.parametrize("name", [n for n in bpc.VARIANTS if n != "kernel"])
def test_variant_applies_once(name):
    src = bpc.sources()
    out = bpc.variant_files(name, src)
    for f, old, new, n in bpc.SUBSTITUTIONS[name]:
        assert src[f].count(old) == n and out[f] != src[f]
        assert out[f].count(old) == 0 or old in new
    for f in bpc.FILES:
        assert len(out[f].splitlines()) <= len(src[f].splitlines())
    # a piece missing from the source is an error, not a silent no-op
    f, old = bpc.SUBSTITUTIONS[name][0][:2]
    with pytest.raises(ValueError):
        bpc.substitutions(name, dict(src, **{f: src[f].replace(old, "")}))


def test_variants_differ():
    src = bpc.sources()
    outs = {tuple(bpc.variant_files(n, src).values()) for n in bpc.VARIANTS}
    assert len(outs) == len(bpc.VARIANTS)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(bpc.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bpc.main([])
