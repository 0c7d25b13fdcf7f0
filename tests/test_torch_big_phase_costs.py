"""The big-kernel phase-cost probe (tools/big_phase_costs.py) on the CPU:
each variant's replacement still applies to csrc/fused_decode_big.cu, once,
and changes only what it names; without a card the probe exits."""

import pytest

from kuiperllama_tpu_torch.tools import big_phase_costs as bpc


@pytest.mark.parametrize("name", [n for n in bpc.VARIANTS if n != "kernel"])
def test_variant_applies_once(name):
    src = bpc.variant_source("kernel")
    out = bpc.variant_source(name)
    old, new = bpc.VARIANTS[name]
    assert src.count(old) == 1 and out != src
    assert out.count(old) == 0 and len(out.splitlines()) <= len(src.splitlines())


def test_variants_differ():
    outs = {bpc.variant_source(n) for n in bpc.VARIANTS}
    assert len(outs) == len(bpc.VARIANTS)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(bpc.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bpc.main([])
