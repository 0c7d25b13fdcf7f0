"""High-level model facade, a port of kuiperllama_tpu/api.py.

The surface of the reference's `model::Model` (init / predict / forward /
encode / decode / is_sentence_ending / embedding):

    model = KuiperModel.from_checkpoint("m.q8.bin", "tokenizer.model",
                                        family="llama2")  # or an HF dir
    model.init()                       # weights onto the card (bf16)
    text = model.generate("hi", 128)   # batched prefill, chunked decode
    ids = model.encode("hi"); model.decode(ids)
    logits = model.forward(ids)        # [T, vocab] fp32
    next_id = model.predict(ids)       # argmax over the last position

`init(mesh=...)` runs the Generator tensor-parallel: every rank of the mesh
(parallel/mesh.py) builds the same KuiperModel, keeps its slices of the
weights and calls the same methods with the same arguments.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from .config import ModelConfig
from .errors import InvalidArgument, ModelParseError, PathNotValid, check
from .fuse import fuse_params
from .models import decoder
from .params import to_device
from .serving.generate import GenerateResult, Generator
from .tokenizer import Tokenizer, load_tokenizer


class KuiperModel:
    def __init__(self, cfg: ModelConfig, raw_params,
                 tokenizer: Optional[Tokenizer] = None):
        self.cfg = cfg
        self._raw_params = raw_params
        self.tokenizer = tokenizer
        self.params = None
        self._generator: Optional[Generator] = None
        self._forward_fn = None

    # ---- construction (reference Model ctor + gen_model_from_file)

    @classmethod
    def from_checkpoint(cls, model_path: str, tokenizer_path: Optional[str] = None,
                        family: str = "llama2", quantized: Optional[bool] = None,
                        ) -> "KuiperModel":
        """A llama2.c `.bin` (v0 fp32 or v3 int8) or an HF model directory
        (config.json + *.safetensors; `family` and `quantized` then come
        from config.json), and an optional tokenizer."""
        if not os.path.exists(model_path):
            raise PathNotValid(model_path)
        if os.path.isdir(model_path):
            from .checkpoint.hf import load_hf

            try:
                cfg, params = load_hf(model_path)
            except (FileNotFoundError, KeyError, ValueError) as e:
                raise ModelParseError(
                    f"{model_path}: not an HF checkpoint directory that "
                    f"checkpoint/hf.py loads ({e!r})") from e
        else:
            from .checkpoint.binfmt import load_bin

            cfg, params = load_bin(model_path, family=family, quantized=quantized)
        tok = None
        if tokenizer_path:
            if not os.path.exists(tokenizer_path):
                raise PathNotValid(tokenizer_path)
            tok = load_tokenizer(tokenizer_path, family=cfg.family,
                                 vocab_size=cfg.vocab_size)
            # a tokenizer bigger than the model vocab would encode ids the
            # embedding cannot look up
            check(tok.vocab_size <= cfg.vocab_size,
                  f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
                  f"{cfg.vocab_size}", ModelParseError)
        return cls(cfg, params, tok)

    # ---- init (reference Model::init: device select + weight upload)

    def init(self, dtype=torch.bfloat16, device="cuda",
             cache_len: Optional[int] = None, mesh=None,
             cache_dtype=torch.float32):
        """Place the weights on `device` (float weights in `dtype`, norms in
        fp32, INT8 weights as they are), fuse qkv and gate/up as the demo
        does (the Generator's B = 1 megakernel routes need fused weights)
        and build the dense-cache Generator, its cache in `cache_dtype`
        (fp32 by default, as the JAX facade's Generator keeps it).

        mesh: a tensor-parallel mesh (parallel/mesh.py, dp = 1): this rank
        keeps its slices of the weights (shard_params, then per-rank
        fusion) and the Generator runs ShardedForward, as the JAX facade's
        init(mesh=) does. The continuous-batching path takes its mesh
        through serving.engine.PagedEngine(mesh=...)."""
        params = to_device(self._raw_params, device=device, dtype=dtype)
        self._forward_fn = None
        if mesh is not None:
            from .parallel.sharded import ShardedForward
            from .parallel.shardings import shard_params

            self._forward_fn = ShardedForward(self.cfg, mesh, params)
            params = shard_params(params, mesh, self.cfg)
        params = fuse_params(params)
        self.params = params
        self._generator = Generator(self.cfg, self.params, self.tokenizer,
                                    cache_len=cache_len, cache_dtype=cache_dtype,
                                    forward_fn=self._forward_fn)
        return self

    def _ready(self):
        check(self.params is not None, "call init() first", InvalidArgument)

    # ---- tokenizer passthrough (model.h encode/decode/is_sentence_ending)

    def encode(self, text: str) -> List[int]:
        check(self.tokenizer is not None, "no tokenizer configured")
        return self.tokenizer.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        check(self.tokenizer is not None, "no tokenizer configured")
        return self.tokenizer.decode(ids)

    def is_sentence_ending(self, token_id: int) -> bool:
        check(self.tokenizer is not None, "no tokenizer configured")
        return self.tokenizer.is_stop(token_id)

    # ---- embedding (model.h embedding/fill_input)

    def embedding(self, ids: Sequence[int]):
        """Token embeddings [len(ids), dim] (reference EmbeddingOutput)."""
        self._ready()
        emb = self.params["tok_emb"]
        return emb[torch.tensor(list(ids), dtype=torch.long, device=emb.device)]

    # ---- forward/predict (model.h forward/predict + post_processing)

    @torch.no_grad()
    def forward(self, ids: Sequence[int]):
        """Full-sequence logits [T, vocab] fp32."""
        self._ready()
        ids = list(ids)
        dev = self.params["tok_emb"].device
        cache = decoder.init_kv_cache(self.cfg, 1, max_len=max(len(ids), 8),
                                      device=dev)
        fwd = self._forward_fn or decoder.forward
        if self._forward_fn is not None:
            cache = self._forward_fn.shard_cache(cache)
        tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
        positions = torch.arange(len(ids), dtype=torch.int32, device=dev)[None]
        logits, _ = fwd(self.cfg, self.params, tokens, positions, cache,
                        rope=self._generator.rope)
        return logits[0]

    def predict(self, ids: Sequence[int]) -> int:
        """Greedy next token after the sequence (reference predict +
        ArgmaxSampler)."""
        return int(torch.argmax(self.forward(ids)[-1]))

    # ---- generation (reference demo generate loop)

    def generate(self, prompt: str, max_new_tokens: int = 128,
                 **kw) -> GenerateResult:
        self._ready()
        check(self.tokenizer is not None, "no tokenizer configured")
        return self._generator.generate(prompt, max_new_tokens, **kw)

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: int = 128,
                     **kw):
        self._ready()
        ids, _, _ = self._generator.generate_ids(prompt_ids, max_new_tokens, **kw)
        return ids
