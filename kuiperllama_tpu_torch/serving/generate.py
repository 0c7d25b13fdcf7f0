"""Generation loops over a dense KV cache, a port of
kuiperllama_tpu/serving/generate.py.

  * prefill is ONE batched forward over the whole (bucket-padded) prompt;
  * decode runs in chunks of N steps with sampling on the device: tokens
    reach the host once per chunk, never once per token;
  * stop tokens are handled on the device: a `done` flag freezes finished
    rows, the host truncates after fetching the chunk;
  * the prompt is padded to `_bucket` rows and the attention window to
    `_bucket_len` slots, as in the JAX package, so row counts, and with them
    the INT8 kernel routes, are the same on both sides;
  * at B = 1 a model whose layer fits the megakernel's plan (TinyLlama-1.1B,
    Llama-3.2-1B, Qwen2.5-0.5B; not Llama-2-7B) decodes each step through
    ops/kernels/fused_decode.py: one launch for the whole layer stack, then
    the lm_head and the sampling glue, as the JAX Generator does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import decoder
from ..ops.kernels.fused_decode import fits_vmem, fused_decode_step
from ..ops.linear import linear
from ..ops.sampling import sample_token

MAX_STOP_IDS = 8


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_len(n: int, quantum: int = 256) -> int:
    return -(-n // quantum) * quantum


def _stop_array(stop_ids, device) -> torch.Tensor:
    ids = sorted(set(int(i) for i in stop_ids))[:MAX_STOP_IDS]
    arr = np.full((MAX_STOP_IDS,), -1, np.int32)
    arr[: len(ids)] = ids
    return torch.from_numpy(arr).to(device)


def _fused_logits(cfg: ModelConfig, params, token, pos, cache, rope):
    """One B = 1 decode step through the megakernel: the embedding row, one
    launch for the layer stack (the new K/V rows land in the cache in
    place), then the lm_head in fp32 logits."""
    L, _, A, KH, hd = cache["k"].shape
    x0 = params["tok_emb"][token.long()]  # [1, d]
    # views of the (windowed) cache: the kernel writes through them
    kc = cache["k"].view(L, A, KH * hd)
    vc = cache["v"].view(L, A, KH * hd)
    x_fin, _, _ = fused_decode_step(cfg, params, x0, kc, vc, pos, *rope)
    return linear(x_fin, params["lm_head"]).float()


def decode_chunk(cfg: ModelConfig, params, token, pos, kv_cache, done,
                 generator, stop_ids, steps: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, active_len: int = 0,
                 rope=None, fused: bool = False):
    """Run `steps` decode iterations on the device.

    token: int32 [B] current token; pos: int32 [B] its position.
    done:  bool [B] rows already finished (their pos stays frozen).
    active_len: cap on the cache slots attention reads this chunk (0 = all).
      The window is a view of the cache, so the steps' in-place writes land
      in the full cache and need no write-back.
    fused: take the B = 1 decode megakernel; the chunk leaves it for the
      layered path when its window outgrows the plan (as the JAX
      `decode_chunk` does).
    Returns (tokens int32 [B, steps], token, pos, kv_cache, done), all on
    the device. Emitted tokens after a row finishes repeat the stop token.
    """
    S = kv_cache["k"].shape[2]
    cache = kv_cache
    if active_len and active_len < S:
        cache = dict(k=kv_cache["k"][:, :, :active_len],
                     v=kv_cache["v"][:, :, :active_len])
    if fused:
        if rope is None:
            rope = decoder.build_rope(cfg, token.device)
        fused = fits_vmem(params["blocks"], kv_cache["k"].dtype,
                          cache["k"].shape[2])
    toks = torch.empty((token.shape[0], steps), dtype=torch.int32,
                       device=token.device)
    for i in range(steps):
        if fused:
            logits = _fused_logits(cfg, params, token, pos, cache, rope)
        else:
            logits, _ = decoder.decode_step(cfg, params, token, pos, cache,
                                            rope=rope)
        nxt = sample_token(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, token, nxt)
        # a frozen row keeps overwriting the same slot with the same token,
        # so its cache content is stable
        new_done = done | (nxt[:, None] == stop_ids[None, :]).any(dim=-1)
        pos = torch.where(done, pos, pos + 1)
        done, token = new_done, nxt
        toks[:, i] = nxt
    return toks, token, pos, kv_cache, done


@dataclass
class GenerateResult:
    text: str
    tokens: List[int]
    prompt_tokens: int
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 else float("inf")


class Generator:
    """Single- and batched-request generation over a dense KV cache, on the
    device that holds `params`.

    fused_step: the B = 1 decode megakernel. None (auto) takes it when the
    params lie on a CUDA device and the model fits the plan; True forces it
    (on the CPU that runs its plain version, as the tests do); False turns
    it off."""

    def __init__(self, cfg: ModelConfig, params, tokenizer=None,
                 cache_len: Optional[int] = None, cache_dtype=torch.float32,
                 chunk: int = 64, fused_step: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.cache_len = cache_len or cfg.seq_len
        self.cache_dtype = cache_dtype
        self.chunk = chunk
        self.fused_step = fused_step
        self.device = params["tok_emb"].device
        self.rope = decoder.build_rope(cfg, self.device)

    def _fused_ok(self, B: int) -> bool:
        """Whether decode takes the megakernel: B = 1, fused weights and a
        plan that fits at the smallest window (each chunk re-checks its own
        window in `decode_chunk`)."""
        if B != 1 or self.fused_step is False:
            return False
        blocks = self.params["blocks"]
        alen = min(_bucket_len(1), self.cache_len)
        structural = "wqkv" in blocks and fits_vmem(blocks, self.cache_dtype,
                                                    alen)
        if self.fused_step is True:
            return structural
        return structural and self.device.type == "cuda"

    def generate_batch_ids(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        stop_ids=frozenset(),
        on_chunk=None,
    ):
        """Batched generation. Returns (list of id-lists, prefill_s, decode_s).

        on_chunk: optional callback invoked with the raw [B, n] numpy token
        block as each decode chunk lands on the host (tokens after a row's
        stop token repeat; the returned lists are already truncated)."""
        cfg, dev = self.cfg, self.device
        B = len(prompts)
        lens = [len(p) for p in prompts]
        assert min(lens) >= 1
        limit = min(self.cache_len, cfg.seq_len)
        assert max(lens) < limit, (max(lens), limit)

        T = min(_bucket(max(lens)), limit)
        tokens = np.zeros((B, T), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : lens[i]] = p

        cache = decoder.init_kv_cache(cfg, batch=B, max_len=self.cache_len,
                                      dtype=self.cache_dtype, device=dev)
        stop_arr = _stop_array(stop_ids, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        t0 = time.perf_counter()
        last_logits, cache = decoder.prefill(
            cfg, self.params, torch.from_numpy(tokens).to(dev), cache,
            prompt_lens=torch.tensor(lens, dtype=torch.int32, device=dev),
            rope=self.rope,
        )
        token = sample_token(last_logits, gen, temperature, top_k, top_p)
        done = (token[:, None] == stop_arr[None, :]).any(dim=-1)
        first = token.cpu().numpy()  # host copy; also syncs prefill
        t1 = time.perf_counter()
        if on_chunk is not None:
            on_chunk(first[:, None])

        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        budget = min(max_new_tokens, limit - max(lens)) - 1
        out = [[int(first[i])] for i in range(B)]
        max_pos = max(lens)
        fused = self._fused_ok(B)
        while budget > 0 and not bool(done.all()):
            steps = min(self.chunk, budget)
            assert max_pos + steps <= limit, (max_pos, steps, limit)
            active = min(_bucket_len(max_pos + steps + 1), self.cache_len)
            toks, token, pos, cache, done = decode_chunk(
                cfg, self.params, token, pos, cache, done, gen, stop_arr,
                steps=steps, temperature=temperature, top_k=top_k, top_p=top_p,
                active_len=active, rope=self.rope, fused=fused,
            )
            max_pos += steps
            toks_np = toks.cpu().numpy()  # the chunk's one trip to the host
            if on_chunk is not None:
                on_chunk(toks_np)
            for i in range(B):
                out[i].extend(int(t) for t in toks_np[i])
            budget -= steps
        decode_s = time.perf_counter() - t1

        # truncate at (and drop) the first stop token per row
        stops = set(int(i) for i in stop_ids)
        cleaned = []
        for row in out:
            cut = len(row)
            for j, t in enumerate(row):
                if t in stops:
                    cut = j
                    break
            cleaned.append(row[:cut])
        return cleaned, t1 - t0, decode_s

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: int = 128,
                     **kw):
        rows, prefill_s, decode_s = self.generate_batch_ids(
            [prompt_ids], max_new_tokens, **kw
        )
        return rows[0], prefill_s, decode_s

    def generate(self, prompt: str, max_new_tokens: int = 128, **kw) -> GenerateResult:
        assert self.tokenizer is not None, "no tokenizer configured"
        tok = self.tokenizer
        prompt_ids = tok.encode(prompt)
        stop = kw.pop("stop_ids", tok.stop_ids)
        ids, prefill_s, decode_s = self.generate_ids(
            prompt_ids, max_new_tokens, stop_ids=stop, **kw
        )
        return GenerateResult(
            text=tok.decode(ids),
            tokens=ids,
            prompt_tokens=len(prompt_ids),
            prefill_s=prefill_s,
            decode_s=decode_s,
        )
