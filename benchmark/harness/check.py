"""The comparison that decides `correct`, run once the window has closed
and the program is freed.

A sample of the requests the program finished, drawn from the seed with the
one that served the most tokens and the one with the longest prompt in it,
until `check.served_tokens` served tokens and `check.min_requests` requests
are in it (at most `check.max_requests` requests), goes through the plain float32 reference
once, each prompt followed by its served tokens. At every served token the
reference's best logit minus its logit of the served token is a gap; the
widest gap over the sample is compared with the cell's limit. Greedy
decoding serves the program's best token, so on a sound program a gap is
rounding on a near tie. Beside it: answers that are short of the tokens
asked (no stop tokens are set, so each request serves all it asked), and
requests unfinished after the drain, both with limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

LIMITS = ("max_logit_gap", "short_answers", "unfinished")
NO_SAMPLE = 1e9  # the gap when no request finished: beyond every limit


def pick(reqs, seed: int, served_tokens: int, min_requests: int,
         max_requests: int) -> list:
    done = [r for r in reqs if r.finish is not None and r.out]
    if not done:
        return []
    picked = [max(done, key=lambda r: (len(r.out), len(r.prompt)))]
    longest = max(done, key=lambda r: (len(r.prompt), len(r.out)))
    if longest is not picked[0]:
        picked.append(longest)
    rest = [r for r in done if all(r is not p for p in picked)]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    for k in rng.permutation(len(rest)):
        if len(picked) >= max_requests or (
                len(picked) >= min_requests
                and sum(len(r.out) for r in picked) >= served_tokens):
            break
        picked.append(rest[k])
    return picked


def sequences(picked) -> list:
    """(ids, positions) for the reference: the prompt and the served tokens
    but the last; the positions whose logits predict each served token."""
    out = []
    for r in picked:
        P = len(r.prompt)
        out.append((list(r.prompt) + list(r.out[:-1]),
                    list(range(P - 1, P - 1 + len(r.out)))))
    return out


def served_gaps(ref_logits, served) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    served token."""
    idx = torch.as_tensor(served, device=ref_logits.device).long()[:, None]
    return ref_logits.max(dim=-1).values - ref_logits.gather(1, idx)[:, 0]


def widest_gap(ref_logits_list, served_lists) -> float:
    return max(float(served_gaps(lg, s).max())
               for lg, s in zip(ref_logits_list, served_lists))


def reference_logits(reference, config, raw, picked) -> list:
    """The reference's logits over each picked request's prompt and served
    tokens, at the positions that predict the served tokens."""
    return reference.logits(config, raw, sequences(picked)) if picked else []


def judge(ref_logits, served, reqs, unfinished: int, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every compared number; `served` holds,
    for each picked request, the tokens judged at its positions."""
    short = sum(1 for r in reqs if r.finish is not None and len(r.out) != r.max_new)
    gap = widest_gap(ref_logits, served) if served else NO_SAMPLE
    values = {"max_logit_gap": gap, "short_answers": short, "unfinished": unfinished}
    return {k: {"value": values[k], "limit": limits[k]["limit"]} for k in LIMITS}


def compare(reference, config, raw, picked, reqs, unfinished: int,
            limits: dict) -> dict:
    """The program's served tokens judged against the reference."""
    return judge(reference_logits(reference, config, raw, picked),
                 [r.out for r in picked], reqs, unfinished, limits)


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
