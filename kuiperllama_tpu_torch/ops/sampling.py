"""Token sampling on the device: greedy, temperature, top-k and top-p.

Random draws come from a caller-owned `torch.Generator` on the logits'
device, so a seeded run repeats exactly and nothing syncs with the host.
`DecodeState` holds the tensors a decode step updates in place, and its
`emit` is the step's end: sample, freeze finished rows, record the token.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: [..., vocab] -> int32 token ids [...] (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled fp32 logits with the tokens outside the top-k set
    and outside the top-p nucleus set to -inf."""
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the cumulative probability before them < top_p;
        # the cutoff is the SMALLEST kept logit (the first token always stays)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """General sampler. temperature <= 0 means greedy. logits [B, V] -> [B]."""
    if temperature <= 0.0:
        return sample_greedy(logits)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    # the draw torch.multinomial(probs, 1) makes (the same exponential race
    # on the same generator, so the same token), without its host-side check
    # of the probabilities: a captured decode step must not sync
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


class DecodeState:
    """The fixed tensors a decode step reads and writes in place: token,
    pos and done [B] (int32, int32, bool), the chunk's tokens [B, width]
    int32 with `col`, the int64 column the next step writes, and the stop
    ids. A CUDA graph of the step keeps their pointers, so they are filled,
    never rebound."""

    def __init__(self, token, pos, done, stop_ids, width: int):
        self.token, self.pos, self.done, self.stop = token, pos, done, stop_ids
        self.toks = torch.zeros((token.shape[0], max(width, 1)),
                                dtype=torch.int32, device=token.device)
        self.col = torch.zeros((1,), dtype=torch.int64, device=token.device)

    def tensors(self):
        return (self.token, self.pos, self.done, self.stop, self.toks, self.col)

    def widen(self, width: int):
        """A token block of `width` columns (a graph that held the old one
        must be captured again)."""
        self.toks = torch.zeros((self.toks.shape[0], width), dtype=torch.int32,
                                device=self.toks.device)

    def emit(self, logits, generator=None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0):
        """The end of a decode step: sample the next token from logits
        [B, V], keep finished rows' token and position, mark rows that
        emitted a stop id done, and write the token at column `col`. A
        frozen row keeps overwriting the same cache slot with the same
        token, so its cache content is stable."""
        token, pos, done = self.token, self.pos, self.done
        nxt = sample_token(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, token, nxt)
        new_done = done | (nxt[:, None] == self.stop[None, :]).any(dim=-1)
        pos.copy_(torch.where(done, pos, pos + 1))
        done.copy_(new_done)
        token.copy_(nxt)
        self.toks.scatter_(1, self.col.expand(token.shape[0])[:, None], nxt[:, None])
        self.col.add_(1)
