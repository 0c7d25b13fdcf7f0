"""The small megakernels' phase-cost probe (tools/fused_phase_costs.py) on
the CPU: each variant's substitutions still apply to csrc/fused_decode.cu,
csrc/fused_decode_chunk.cu and their header exactly as often as they say,
and change only what they name; without a card the probe exits."""

import pytest

from kuiperllama_tpu_torch.tools import fused_phase_costs as fpc

VARIANTS = [n for n in fpc.VARIANTS if n != "kernel"]


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_applies_once(name):
    src = fpc.sources()
    files = fpc.variant_files(name, src)
    for f, old, new, n in fpc.substitutions(name, src):
        assert src[f].count(old) == n
        assert files[f].count(old) == 0 or new.count(old)
    changed = {f for f in files if files[f] != src[f]}
    touched = {f for f, *_ in fpc.substitutions(name, src)}
    assert changed == touched
    # the header goes beside the sources, so that they include this one
    assert set(files) == set(fpc.FILES)


@pytest.mark.parametrize("name", VARIANTS)
def test_every_variant_clamps_the_token(name):
    """A wrong step reads an embedding row that exists."""
    files = fpc.variant_files(name, fpc.sources())
    assert "min(max(reduce_token(c, sm), 0), c.vocab - 1)" in files[fpc.CHUNK_CU]


def test_variants_differ_and_kernel_is_the_source():
    src = fpc.sources()
    assert fpc.variant_files("kernel", src) == src
    outs = {tuple(sorted(fpc.variant_files(n, src).items())) for n in fpc.VARIANTS}
    assert len(outs) == len(fpc.VARIANTS)


def test_barrier_variants_cover_every_phase():
    assert {n for n in fpc.VARIANTS if n.startswith("no_barrier_")} == {
        f"no_barrier_{p}" for p in fpc.PHASES}


def test_sources_from_another_directory(tmp_path):
    """--csrc: an earlier commit's sources, the same substitutions."""
    src = fpc.sources()
    for f, text in src.items():
        (tmp_path / f).write_text(text.replace("// ", "//  "))
    other = fpc.sources(tmp_path)
    assert other != src
    for name in fpc.VARIANTS:
        fpc.variant_files(name, other)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(fpc.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        fpc.main([])
