"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: `correct` comes out false for each fault a served cell
can have, and true without one. A single chip has no exchange between
chips to leave out."""

import pytest

from kuiperllama_tpu_torch.ops.sampling import DecodeState

from conftest import run_cell

ENGINES = ("tiny-int8.serve", "tiny-int8.rag")
GENERATORS = ("tiny-int8.chat-b1", "tiny-bf16.chat-b1")


def _frozen(self, logits, generator=None, temperature=0.0, top_k=0, top_p=1.0):
    """A step that returns its state unchanged: the last token again, the
    position where it was."""
    B = self.token.shape[0]
    self.toks.scatter_(1, self.col.expand(B)[:, None], self.token[:, None])
    self.col.add_(1)


_EMIT = DecodeState.emit


def _altered(self, logits, *a, **k):
    """The token altered where it is produced."""
    _EMIT(self, logits, *a, **k)
    V = logits.shape[-1]
    B = self.token.shape[0]
    self.token.copy_((self.token + 1) % V)
    col = (self.col - 1).expand(B)[:, None]
    self.toks.scatter_(1, col, self.token[:, None])


def _half(self, logits, *a, **k):
    """Half of the batch left out: its rows keep their state."""
    keep = self.token.clone(), self.pos.clone()
    _EMIT(self, logits, *a, **k)
    h = self.token.shape[0] // 2
    self.token[h:] = keep[0][h:]
    self.pos[h:] = keep[1][h:]
    col = (self.col - 1).expand(self.token.shape[0])[:, None]
    self.toks.scatter_(1, col, self.token[:, None])


FAULTS = {"unchanged_state": _frozen, "token_altered": _altered, "half_batch": _half}


@pytest.mark.parametrize("cell", ENGINES + GENERATORS)
def test_a_sound_run_is_correct(tiny_root, cell):
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ENGINES + GENERATORS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    if fault == "half_batch" and cell not in ENGINES:
        pytest.skip("the B = 1 Generator has no batch to halve")
    monkeypatch.setattr(DecodeState, "emit", FAULTS[fault])
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False, res["checks"]
