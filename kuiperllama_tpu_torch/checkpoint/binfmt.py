"""Readers/writers for the llama2.c-style `.bin` checkpoint formats.

A numpy-in, numpy-out copy of the JAX package's `checkpoint/binfmt.py`.

v0 (fp32):
  header: 7 x int32  {dim, hidden_dim, n_layers, n_heads, n_kv_heads,
                      vocab_size, seq_len}
          vocab_size sign encodes the tied-classifier flag: positive = lm_head
          shares the embedding matrix.
  body (fp32, file orientation [out, in], row-major):
      tok_emb [vocab, dim]
      attn_norm x L [dim]
      wq x L [dim, dim]           (Qwen2 v0: each wq followed by bias [dim])
      wk x L [kv_dim, dim]        (Qwen2 v0: + bias [kv_dim])
      wv x L [kv_dim, dim]        (Qwen2 v0: + bias [kv_dim])
      wo x L [dim, dim]
      ffn_norm x L [dim]
      w1 x L [hidden, dim]
      w2 x L [dim, hidden]
      w3 x L [hidden, dim]
      final_norm [dim]
      freqs_cos [seq_len, head_dim//2]   (skipped by the loader)
      freqs_sin [seq_len, head_dim//2]   (skipped)
      [wcls [vocab, dim]]                (only when untied)

v3 (group-wise INT8):
  header: 8 x int32 (v0 header + group_size)
  body:
      {wq,wk,wv,wo,w1,w2,w3} each as: for every layer, int8 payload followed
      immediately by its fp32 group scales (groups of `group_size` consecutive
      elements of the row-major [out, in] tensor); Qwen2 adds an fp32 bias
      after each wq/wk/wv's scales
      [wcls quantized]                   (only when untied)
      tok_emb fp32 [vocab, dim]
      attn_norm x L, ffn_norm x L, final_norm   (all fp32)

All tensors are returned in [in, out] orientation (x @ W) as numpy arrays;
layer weights are stacked along a leading L axis.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..config import ModelConfig
from ..errors import ModelParseError
from ..quant import quantize_q80_np

_HEADER_V0 = struct.Struct("<7i")
_HEADER_V3 = struct.Struct("<8i")


class _Cursor:
    """Offset walker over an mmap'd checkpoint body."""

    def __init__(self, mm: np.memmap, byte_offset: int):
        self.mm = mm
        self.off = byte_offset

    def take(self, dtype, shape) -> np.ndarray:
        n = int(np.prod(shape))
        itemsize = np.dtype(dtype).itemsize
        a = np.frombuffer(self.mm, dtype=dtype, count=n, offset=self.off)
        self.off += n * itemsize
        return a.reshape(shape)

    def skip(self, dtype, shape):
        self.off += int(np.prod(shape)) * np.dtype(dtype).itemsize


def load_bin(
    path: str,
    family: str = "llama2",
    quantized: Optional[bool] = None,
    keep_quant: bool = True,
    **config_overrides,
):
    """Load a v0/v3 `.bin` checkpoint.

    Args:
      path: checkpoint file.
      family: model family for RoPE/eps/bias presets ("llama2"|"llama3"|"qwen2").
      quantized: True for v3, False for v0. None = infer (v3 iff an 8th header
        int in [1, 4096] divides dim and the body size matches the v3 layout).
      keep_quant: if False, dequantize v3 weights to fp32 on load.

    Returns (config, params) with params a numpy dict in [in, out] orientation.
    Quantized tensors are returned as dicts {"q": int8, "s": fp32, "group_size"}
    (converted to QuantTensor by `params.to_device`).
    """
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    if len(mm) < _HEADER_V3.size:
        raise ModelParseError(
            f"{path}: {len(mm)} bytes is too small for a .bin header")
    dim, hidden, n_layers, n_heads, n_kv, vocab_signed, seq_len = _HEADER_V0.unpack(
        bytes(mm[: _HEADER_V0.size])
    )
    tied = vocab_signed > 0
    vocab = abs(vocab_signed)
    hdr = dict(dim=dim, hidden=hidden, layers=n_layers, heads=n_heads,
               kv_heads=n_kv, vocab=vocab_signed, seq_len=seq_len)
    if not (dim > 0 and hidden > 0 and n_layers > 0 and n_heads > 0
            and 0 < n_kv <= n_heads and vocab_signed != 0 and seq_len > 0
            and dim % n_heads == 0 and n_heads % n_kv == 0):
        raise ModelParseError(f"{path}: malformed header {hdr}")
    qkv_bias = config_overrides.get("qkv_bias", family == "qwen2")

    (g8,) = struct.unpack("<i", bytes(mm[28:32]))
    v3_ok = (1 <= g8 <= 4096 and dim % g8 == 0 and _v3_size_matches(
        len(mm), dim, hidden, n_layers, n_heads, n_kv, vocab, tied, g8,
        qkv_bias))
    v0_ok = len(mm) == _v0_size(dim, hidden, n_layers, n_heads, n_kv, vocab,
                                tied, seq_len, qkv_bias)
    if quantized is None:
        quantized = v3_ok
    if not (v3_ok if quantized else v0_ok):
        raise ModelParseError(
            f"{path}: body size {len(mm)} does not match the "
            f"{'v3' if quantized else 'v0'} layout for header {hdr}")
    group_size = None
    body = _HEADER_V0.size
    if quantized:
        group_size = g8
        body = _HEADER_V3.size

    cfg = ModelConfig.from_header(
        family=family,
        dim=dim,
        hidden_dim=hidden,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        vocab_size=vocab,
        seq_len=seq_len,
        tied_embedding=tied,
        group_size=group_size if (quantized and keep_quant) else None,
        **config_overrides,
    )

    cur = _Cursor(mm, body)
    if quantized:
        params = _read_v3(cur, cfg, group_size, keep_quant)
    else:
        params = _read_v0(cur, cfg)
    return cfg, params


def _v0_size(dim, hidden, L, n_heads, n_kv, vocab, tied, seq_len,
             qkv_bias) -> int:
    """Exact v0 body size."""
    head_dim = dim // n_heads
    kv_dim = n_kv * head_dim
    n = vocab * dim                                # tok_emb
    n += 2 * L * dim + dim                         # attn/ffn norms, final norm
    n += L * (2 * dim * dim + 2 * kv_dim * dim + 3 * hidden * dim)
    if qkv_bias:
        n += L * (dim + 2 * kv_dim)                # Qwen2 q/k/v biases
    n += seq_len * head_dim                        # freqs_cos + freqs_sin
    if not tied:
        n += vocab * dim                           # wcls
    return _HEADER_V0.size + n * 4


def _v3_size_matches(nbytes, dim, hidden, L, n_heads, n_kv, vocab, tied, g,
                     qkv_bias=False) -> bool:
    head_dim = dim // n_heads
    kv_dim = n_kv * head_dim
    qmats = L * (2 * dim * dim + 2 * kv_dim * dim + 3 * hidden * dim)
    if not tied:
        qmats += vocab * dim
    fp = vocab * dim + (2 * L + 1) * dim
    if qkv_bias:
        fp += L * (dim + 2 * kv_dim)               # fp32 bias after its scales
    expect = _HEADER_V3.size + qmats + (qmats // g) * 4 + fp * 4
    return nbytes == expect


def _read_mat_stack(cur: _Cursor, L: int, out_dim: int, in_dim: int) -> np.ndarray:
    """Read L file-orientation [out, in] fp32 matrices -> [L, in, out]."""
    ws = [cur.take(np.float32, (out_dim, in_dim)).T for _ in range(L)]
    return np.ascontiguousarray(np.stack(ws))


def _read_v0(cur: _Cursor, cfg: ModelConfig):
    L, dim, hidden = cfg.n_layers, cfg.dim, cfg.hidden_dim
    kv_dim = cfg.kv_dim
    bias = cfg.qkv_bias

    tok_emb = np.array(cur.take(np.float32, (cfg.vocab_size, dim)))
    attn_norm = np.stack([cur.take(np.float32, (dim,)) for _ in range(L)])

    def mat_with_bias(out_dim):
        ws, bs = [], []
        for _ in range(L):
            ws.append(cur.take(np.float32, (out_dim, dim)).T)
            if bias:
                bs.append(cur.take(np.float32, (out_dim,)))
        w = np.ascontiguousarray(np.stack(ws))
        b = np.stack(bs) if bias else None
        return w, b

    wq, bq = mat_with_bias(dim)
    wk, bk = mat_with_bias(kv_dim)
    wv, bv = mat_with_bias(kv_dim)
    wo = _read_mat_stack(cur, L, dim, dim)
    ffn_norm = np.stack([cur.take(np.float32, (dim,)) for _ in range(L)])
    w1 = _read_mat_stack(cur, L, hidden, dim)
    w2 = _read_mat_stack(cur, L, dim, hidden)
    w3 = _read_mat_stack(cur, L, hidden, dim)
    final_norm = np.array(cur.take(np.float32, (dim,)))
    cur.skip(np.float32, (cfg.seq_len, cfg.head_dim // 2))  # freqs_cos
    cur.skip(np.float32, (cfg.seq_len, cfg.head_dim // 2))  # freqs_sin
    if cfg.tied_embedding:
        lm_head = np.ascontiguousarray(tok_emb.T)
    else:
        lm_head = np.ascontiguousarray(
            cur.take(np.float32, (cfg.vocab_size, dim)).T
        )

    blocks = dict(
        attn_norm=attn_norm, ffn_norm=ffn_norm,
        wq=wq, wk=wk, wv=wv, wo=wo, w1=w1, w2=w2, w3=w3,
    )
    if bias:
        blocks.update(bq=bq, bk=bk, bv=bv)
    return dict(tok_emb=tok_emb, blocks=blocks, final_norm=final_norm, lm_head=lm_head)


def _read_quant_stack(cur: _Cursor, L: int, out_dim: int, in_dim: int, g: int,
                      keep: bool, with_bias: bool = False):
    """Read L quantized [out, in] tensors (int8 payload + fp32 scales each;
    with_bias additionally reads an fp32 [out] bias after each).

    Returns transposed stacks: q [L, in, out] int8, s [L, in//g, out] fp32 —
    groups lie along `in` because the file flattens row-major [out, in]
    and in % g == 0. With with_bias, returns (stack, biases [L, out]).
    """
    qs, ss, bs = [], [], []
    for _ in range(L):
        q = cur.take(np.int8, (out_dim, in_dim))
        s = cur.take(np.float32, (out_dim, in_dim // g))
        qs.append(q.T)  # [in, out]
        ss.append(s.T)  # [in//g, out]
        if with_bias:
            bs.append(np.array(cur.take(np.float32, (out_dim,))))
    q = np.ascontiguousarray(np.stack(qs))
    s = np.ascontiguousarray(np.stack(ss))
    if keep:
        out = {"q": q, "s": s, "group_size": g}
    else:
        sg = np.repeat(s, g, axis=1)  # [L, in, out]
        out = (q.astype(np.float32) * sg).astype(np.float32)
    if with_bias:
        return out, np.stack(bs)
    return out


def _read_v3(cur: _Cursor, cfg: ModelConfig, g: int, keep: bool):
    L, dim, hidden, kv_dim = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    bias = cfg.qkv_bias
    if bias:
        wq, bq = _read_quant_stack(cur, L, dim, dim, g, keep, with_bias=True)
        wk, bk = _read_quant_stack(cur, L, kv_dim, dim, g, keep,
                                   with_bias=True)
        wv, bv = _read_quant_stack(cur, L, kv_dim, dim, g, keep,
                                   with_bias=True)
    else:
        wq = _read_quant_stack(cur, L, dim, dim, g, keep)
        wk = _read_quant_stack(cur, L, kv_dim, dim, g, keep)
        wv = _read_quant_stack(cur, L, kv_dim, dim, g, keep)
    wo = _read_quant_stack(cur, L, dim, dim, g, keep)
    w1 = _read_quant_stack(cur, L, hidden, dim, g, keep)
    w2 = _read_quant_stack(cur, L, dim, hidden, g, keep)
    w3 = _read_quant_stack(cur, L, hidden, dim, g, keep)
    if not cfg.tied_embedding:
        lm_head = _read_quant_stack(cur, 1, cfg.vocab_size, dim, g, keep)
        lm_head = (
            {k: (v[0] if isinstance(v, np.ndarray) else v) for k, v in lm_head.items()}
            if keep
            else lm_head[0]
        )
    else:
        lm_head = None
    tok_emb = np.array(cur.take(np.float32, (cfg.vocab_size, dim)))
    attn_norm = np.stack([cur.take(np.float32, (dim,)) for _ in range(L)])
    ffn_norm = np.stack([cur.take(np.float32, (dim,)) for _ in range(L)])
    final_norm = np.array(cur.take(np.float32, (dim,)))
    if lm_head is None:
        lm_head = np.ascontiguousarray(tok_emb.T)

    blocks = dict(
        attn_norm=attn_norm, ffn_norm=ffn_norm,
        wq=wq, wk=wk, wv=wv, wo=wo, w1=w1, w2=w2, w3=w3,
    )
    if bias:
        blocks.update(bq=bq, bk=bk, bv=bv)
    return dict(tok_emb=tok_emb, blocks=blocks, final_norm=final_norm, lm_head=lm_head)


# ---------------------------------------------------------------------------
# Writers (fixtures and exports)


def write_v0(path: str, cfg: ModelConfig, params) -> None:
    """Write a v0 fp32 checkpoint from an [in, out]-orientation numpy dict."""
    L = cfg.n_layers
    b = params["blocks"]
    with open(path, "wb") as f:
        f.write(
            _HEADER_V0.pack(
                cfg.dim, cfg.hidden_dim, L, cfg.n_heads, cfg.n_kv_heads,
                cfg.vocab_size if cfg.tied_embedding else -cfg.vocab_size,
                cfg.seq_len,
            )
        )
        w = lambda a: f.write(np.ascontiguousarray(a, dtype=np.float32).tobytes())
        w(params["tok_emb"])
        for i in range(L):
            w(b["attn_norm"][i])
        for name, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            for i in range(L):
                w(b[name][i].T)
                if cfg.qkv_bias:
                    w(b[bias][i])
        for i in range(L):
            w(b["wo"][i].T)
        for i in range(L):
            w(b["ffn_norm"][i])
        for name in ("w1", "w2", "w3"):
            for i in range(L):
                w(b[name][i].T)
        w(params["final_norm"])
        # freqs caches (recomputed at load; serialized for format fidelity)
        hd = cfg.head_dim
        inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
        t = np.arange(cfg.seq_len, dtype=np.float32)[:, None] * inv[None, :]
        w(np.cos(t))
        w(np.sin(t))
        if not cfg.tied_embedding:
            w(params["lm_head"].T)


def write_v3(path: str, cfg: ModelConfig, params, group_size: int = 64) -> float:
    """Write a v3 group-quant checkpoint from an fp32 [in, out] numpy dict.
    Returns the largest quantization error of any weight element."""
    L = cfg.n_layers
    b = params["blocks"]
    max_err = 0.0
    with open(path, "wb") as f:
        f.write(
            _HEADER_V3.pack(
                cfg.dim, cfg.hidden_dim, L, cfg.n_heads, cfg.n_kv_heads,
                cfg.vocab_size if cfg.tied_embedding else -cfg.vocab_size,
                cfg.seq_len, group_size,
            )
        )

        def wq8(mat_file_orient):
            nonlocal max_err
            q, s, err = quantize_q80_np(mat_file_orient, group_size)
            max_err = max(max_err, err)
            f.write(q.tobytes())
            f.write(s.tobytes())

        for name, bias_name in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"),
                                ("wo", None), ("w1", None), ("w2", None),
                                ("w3", None)):
            for i in range(L):
                wq8(b[name][i].T)
                if bias_name is not None and cfg.qkv_bias:
                    f.write(np.ascontiguousarray(
                        b[bias_name][i], dtype=np.float32).tobytes())
        if not cfg.tied_embedding:
            wq8(params["lm_head"].T)
        w = lambda a: f.write(np.ascontiguousarray(a, dtype=np.float32).tobytes())
        w(params["tok_emb"])
        for i in range(L):
            w(b["attn_norm"][i])
        for i in range(L):
            w(b["ffn_norm"][i])
        w(params["final_norm"])
    return max_err
