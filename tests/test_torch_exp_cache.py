"""The cache-write experiment (kuiperllama_tpu_torch/tools/exp_cache.py) on
the CPU: its three forms (A in place into a layer's view, B one write into
the full cache, C functional and rebuilt by torch.stack) give equal greedy
tokens, equal to the port's layered `decode_chunk` and to the JAX package's
layered `decode_chunk` on the same params, exactly. The committed tinychar
fixtures (INT8 g 64 and g 256, Qwen2 with q/k/v biases), a bf16 cache of
128 slots as the tool keeps, 12 steps from token 0 at pos 17; the JAX side
runs its Pallas kernels interpreted. Forms B and C also leave the cache
bit-equal to form A's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.serving import generate as jgen
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops.sampling import DecodeState
from kuiperllama_tpu_torch.params import to_device
from kuiperllama_tpu_torch.serving import generate as tgen
from kuiperllama_tpu_torch.serving.generate import _stop_array
from kuiperllama_tpu_torch.tools import exp_cache
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
FIXTURES = [("tinychar/tinychar.q8.bin", "llama2"),
            ("tinychar_g256/tinychar.q8.bin", "llama2"),
            ("tinychar_qwen2/tinychar.q8.bin", "qwen2")]
CPU = torch.device("cpu")
CACHE, STEPS = 128, 12


def _jax_tokens(rel, family):
    jc, jp = jload(os.path.join(ROOT, rel), family=family)
    cache = jdec.init_kv_cache(jc, batch=1, max_len=CACHE, dtype=jnp.bfloat16)
    toks, *_ = jgen.decode_chunk(
        jc, jfuse(jto(jp)), jnp.zeros((1,), jnp.int32),
        jnp.full((1,), exp_cache.POS, jnp.int32), cache, jnp.zeros((1,), bool),
        jax.random.PRNGKey(0), jgen._stop_array(()), steps=STEPS, active_len=CACHE)
    return np.asarray(toks).tolist()


def _port_tokens(cfg, params):
    cache = decoder.init_kv_cache(cfg, 1, CACHE, torch.bfloat16, CPU)
    state = DecodeState(torch.zeros((1,), dtype=torch.int32),
                        torch.full((1,), exp_cache.POS, dtype=torch.int32),
                        torch.zeros((1,), dtype=torch.bool), _stop_array((), CPU), STEPS)
    toks, *_ = tgen.decode_chunk(cfg, params, state, cache, None, STEPS,
                                 active_len=CACHE, rope=decoder.build_rope(cfg, CPU),
                                 drop_past_end=False)
    return toks.tolist()


@pytest.mark.parametrize("rel,family", FIXTURES)
def test_three_forms_equal_the_layered_decode_and_jax(rel, family, capsys):
    cfg, tp = load_bin(os.path.join(ROOT, rel), family=family)
    params = fuse_params(to_device(tp, device="cpu"))
    out = exp_cache.run(CPU, cfg=cfg, params=params, steps=STEPS, cache_len=CACHE)
    printed = capsys.readouterr().out
    assert all(f"mode {f}:" in printed for f in exp_cache.FORMS)
    assert out["tokens_equal"] and set(out["ms_per_token"]) == {"A", "B", "C"}
    assert out["tokens"] == _port_tokens(cfg, params) == _jax_tokens(rel, family)


def test_forms_leave_equal_caches():
    cfg, tp = load_bin(os.path.join(ROOT, FIXTURES[0][0]))
    params = fuse_params(to_device(tp, device="cpu"))
    rope = decoder.build_rope(cfg, CPU)
    caches = {}
    for form in exp_cache.FORMS:
        token = torch.tensor([3], dtype=torch.int32)
        kv = decoder.init_kv_cache(cfg, 1, CACHE, torch.bfloat16, CPU)
        for pos in range(exp_cache.POS, exp_cache.POS + 4):
            logits = exp_cache.step_logits(cfg, params, token, torch.tensor([pos]),
                                           kv["k"], kv["v"], rope, form)
            token = logits.argmax(-1).to(torch.int32)
        caches[form] = kv
    for form in "BC":
        assert torch.equal(caches[form]["k"], caches["A"]["k"])
        assert torch.equal(caches[form]["v"], caches["A"]["v"])
    assert caches["A"]["k"][:, :, exp_cache.POS:exp_cache.POS + 4].abs().sum() > 0
