"""The port's HF checkpoint loader (checkpoint/hf.py) against the JAX
package's and against transformers, on the CPU:
  * load_safetensors on a file written by the `safetensors` package (F32,
    F16, BF16, I8, I64 and a __metadata__ entry): equal arrays;
  * config_from_hf field for field (llama, Llama-3.2 rope_scaling, qwen2);
  * params_from_state_dict: equal arrays (`model.` prefix, tied and untied
    lm_head);
  * fp32 logits of the port's forward on in-memory LlamaForCausalLM and
    Qwen2ForCausalLM models (built as tests/test_model_parity.py builds
    them) within 2e-4 of transformers' (hf_parity's --atol) and of the JAX
    forward's;
  * KuiperModel.from_checkpoint, the demo and tools/hf_parity on a saved
    HF directory; chip_smoke.py's own safetensors writer read back by the
    `safetensors` package and by the port.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from kuiperllama_tpu.checkpoint import hf as jhf
from kuiperllama_tpu.models import decoder as jdecoder
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu_torch.checkpoint import hf
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.params import to_device
from test_model_parity import _hf_llama, _hf_llama32, _hf_qwen2
from torch_threads import one_thread  # noqa: F401

ATOL = 2e-4  # hf_parity's --atol
MAKERS = {"llama": _hf_llama, "llama3.2-rope-scaling": _hf_llama32, "qwen2": _hf_qwen2}


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _same_config(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_params(a, b):
    assert set(a) == set(b) and set(a["blocks"]) == set(b["blocks"])
    for k in ("tok_emb", "final_norm", "lm_head"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for k in a["blocks"]:
        np.testing.assert_array_equal(np.asarray(a["blocks"][k]),
                                      np.asarray(b["blocks"][k]))


@pytest.fixture(scope="module")
def hf_models():
    return {name: make() for name, make in MAKERS.items()}


def test_load_safetensors_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((4,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)
                                 ).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-128, 128, (7, 2)).astype(np.int8)),
        "i64": torch.from_numpy(rng.integers(-2**40, 2**40, (3,))),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = hf.load_safetensors(path), jhf.load_safetensors(path)
    assert set(got) == set(want) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], t.float().numpy() if k == "bf16"
                                      else t.numpy())


@pytest.mark.parametrize("name", list(MAKERS))
def test_config_from_hf_matches_jax(hf_models, name):
    d = hf_models[name].config.to_dict()
    _same_config(hf.config_from_hf(d), jhf.config_from_hf(d))
    cfg = hf.config_from_hf(d)
    assert cfg.qkv_bias == (name == "qwen2")
    assert (cfg.rope_scaling is not None) == (name == "llama3.2-rope-scaling")


def test_config_from_hf_unknown_model_type():
    d = dict(_hf_llama().config.to_dict(), model_type="gpt2")
    with pytest.raises(ValueError, match="model_type"):
        hf.config_from_hf(d)
    with pytest.raises(ValueError, match="model_type"):
        jhf.config_from_hf(d)


@pytest.mark.parametrize("prefix", ["", "model."])
@pytest.mark.parametrize("tied", [False, True])
def test_params_from_state_dict_matches_jax(hf_models, prefix, tied):
    model = hf_models["qwen2"]
    d = dict(model.config.to_dict(), tie_word_embeddings=tied)
    # HF names every tensor but lm_head under `model.`
    sd = {(k if k == "lm_head.weight" else prefix + k.removeprefix("model.")): v
          for k, v in _sd(model).items()}
    if tied:
        del sd["lm_head.weight"]
    cfg = hf.config_from_hf(d)
    got = hf.params_from_state_dict(cfg, sd)
    _same_params(got, jhf.params_from_state_dict(jhf.config_from_hf(d), sd))
    want_head = sd[prefix + "embed_tokens.weight"] if tied else sd["lm_head.weight"]
    np.testing.assert_array_equal(got["lm_head"], want_head.T)
    assert got["blocks"]["wq"].shape == (cfg.n_layers, cfg.dim, cfg.dim)


@pytest.mark.parametrize("name", list(MAKERS))
def test_prefill_logits_match_hf_and_jax(hf_models, name):
    model = hf_models[name]
    d = model.config.to_dict()
    sd = {k.removeprefix("model."): v for k, v in _sd(model).items()}
    cfg = hf.config_from_hf(d)
    params = to_device(hf.params_from_state_dict(cfg, sd), device="cpu")
    B, T = 2, 12
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, T),
                                               dtype=np.int32)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    cache = decoder.init_kv_cache(cfg, B, max_len=32, device="cpu")
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    got, _ = decoder.forward(cfg, params, torch.from_numpy(tokens), pos, cache,
                             drop_past_end=False)
    jcfg = jhf.config_from_hf(d)
    jp = jto(jhf.params_from_state_dict(jcfg, sd), dtype=jnp.float32)
    jlog, _ = jdecoder.forward(jcfg, jp, jnp.asarray(tokens),
                               jnp.asarray(pos.numpy()),
                               jdecoder.init_kv_cache(jcfg, batch=B, max_len=32))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=ATOL, rtol=1e-3)


def _char_tokenizer(path, vocab_size):
    """A word-level HF tokenizer over single characters, saved to `path`."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    chars = ["<unk>", "<s>", "</s>"] + list("abcdefghijklmnopqrstuvwxyz")
    tok = Tokenizer(models.WordLevel({c: i for i, c in enumerate(chars)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    assert len(chars) <= vocab_size
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>").save_pretrained(path)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A saved HF Qwen2 directory (config.json, model.safetensors, a char
    tokenizer) and the spm tokenizer fixture of tests/test_tokenizer.py."""
    from test_tokenizer import _build_spm_model

    d = tmp_path_factory.mktemp("hf")
    model = _hf_qwen2(vocab=64)
    model.save_pretrained(str(d), safe_serialization=True)
    _char_tokenizer(str(d), 64)
    spm = d / "tok.model"
    spm.write_bytes(_build_spm_model())
    return str(d), str(spm), model


def test_load_hf_directory_matches_jax(hf_dir):
    path, _, _ = hf_dir
    cfg, params = hf.load_hf(path)
    jcfg, jparams = jhf.load_hf(path)
    _same_config(cfg, jcfg)
    _same_params(params, jparams)


def test_kuiper_model_and_demo_on_hf_dir(hf_dir, capsys):
    from kuiperllama_tpu.api import KuiperModel as JModel
    from kuiperllama_tpu_torch.api import KuiperModel
    from kuiperllama_tpu_torch.demo import main as demo_main

    path, spm, _ = hf_dir
    tm = KuiperModel.from_checkpoint(path, spm).init(dtype=torch.float32,
                                                     device="cpu", cache_len=64)
    jm = JModel.from_checkpoint(path, spm).init(dtype=jnp.float32, cache_len=64)
    assert tm.cfg.family == "qwen2" and tm.cfg.qkv_bias
    ids = [3, 9, 14, 5]
    assert tm.generate_ids(ids, 10) == jm.generate_ids(ids, 10)
    want = tm.generate("hello", 8)
    demo_main(["--model", path, "--tokenizer", spm, "--prompt", "hello",
               "--steps", "8", "--dtype", "f32", "--device", "cpu",
               "--cache-len", "64"])
    assert capsys.readouterr().out == "hello" + want.text + "\n"


def test_hf_parity_tool_passes(hf_dir, capsys):
    from kuiperllama_tpu_torch.tools import hf_parity

    path, _, _ = hf_dir
    code = hf_parity.main(["--hf", path, "--prompt", "hello", "--steps", "8",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert "PARITY OK" in out


def test_chip_smoke_safetensors_writer(tmp_path):
    """chip_smoke.py writes its full-width HF directory with its own numpy
    writer (the card's machine has no `safetensors`): the package reads
    its files back, and so do both parsers."""
    import chip_smoke

    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    bf = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)
                          ).to(torch.bfloat16)
    bits = bf.view(torch.int16).numpy().view(np.uint16)
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, {"a.weight": ("F32", f32),
                                        "b.weight": ("BF16", bits)})
    back = load_file(path)
    np.testing.assert_array_equal(back["a.weight"].numpy(), f32)
    assert back["b.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["b.weight"].float().numpy(), bf.float().numpy())
    for parse in (hf.load_safetensors, jhf.load_safetensors):
        got = parse(path)
        np.testing.assert_array_equal(got["b.weight"], bf.float().numpy())
        np.testing.assert_array_equal(got["a.weight"], f32)


def test_chip_smoke_hf_config_is_the_preset(tmp_path):
    """The config.json chip_smoke.py writes for Qwen2.5-0.5B loads as the
    port's preset in every field that decides the numerics."""
    import chip_smoke
    from kuiperllama_tpu_torch.config import preset_config

    d = chip_smoke.hf_config_json("qwen2.5-0.5b")
    cfg = hf.config_from_hf(json.loads(json.dumps(d)))
    assert chip_smoke.numerics_mismatch(cfg, preset_config("qwen2.5-0.5b")) == []
    assert d["hidden_size"] == 896 and d["num_hidden_layers"] == 24
    assert chip_smoke.numerics_mismatch(
        cfg.replace(rope_theta=1e4), preset_config("qwen2.5-0.5b")) == ["rope_theta"]
    assert os.path.basename(chip_smoke.__file__) == "chip_smoke.py"


def test_quant_matmul_plain_matches_jax_xla():
    """The --no-kernels matmul against kuiperllama_tpu/ops/linear.py
    `_quant_matmul_xla` (fp32, 1e-5 of max|want|)."""
    from kuiperllama_tpu.ops.linear import _quant_matmul_xla
    from kuiperllama_tpu.quant import QuantArray
    from kuiperllama_tpu_torch.ops.linear import quant_matmul_plain
    from kuiperllama_tpu_torch.quant import QuantTensor

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    q = rng.integers(-127, 128, (256, 96)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (4, 96)).astype(np.float32)
    got = quant_matmul_plain(torch.from_numpy(x), QuantTensor(
        q=torch.from_numpy(q), s=torch.from_numpy(s), group_size=64)).numpy()
    want = np.asarray(_quant_matmul_xla(jnp.asarray(x), QuantArray(
        q=jnp.asarray(q), s=jnp.asarray(s), group_size=64)))
    assert got.shape == (2, 3, 96)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_demo_no_kernels_matches_jax_no_pallas(hf_dir, capsys):
    """The demo's --no-kernels on the INT8 tinychar fixture gives the JAX
    Generator's text with set_use_pallas(False) (fp32), and leaves the
    kernels on for the rest of the process."""
    from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload_bin
    from kuiperllama_tpu.fuse import fuse_params as jfuse
    from kuiperllama_tpu.ops.linear import set_use_pallas
    from kuiperllama_tpu.serving.generate import Generator as JGenerator
    from kuiperllama_tpu.tokenizer import load_tokenizer as jload_tokenizer
    from kuiperllama_tpu_torch.demo import main as demo_main
    from kuiperllama_tpu_torch.ops.linear import kernels_on

    _, spm, _ = hf_dir
    ckpt = "checkpoints/tinychar/tinychar.q8.bin"
    jcfg, jp = jload_bin(ckpt)
    set_use_pallas(False)
    try:
        want = JGenerator(jcfg, jfuse(jto(jp, dtype=jnp.float32)),
                          jload_tokenizer(spm, vocab_size=jcfg.vocab_size),
                          cache_len=64).generate("hello", max_new_tokens=8)
    finally:
        set_use_pallas(True)
    demo_main(["--model", ckpt, "--tokenizer", spm, "--prompt", "hello", "--steps",
               "8", "--dtype", "f32", "--device", "cpu", "--cache-len", "64",
               "--no-kernels"])
    assert capsys.readouterr().out == "hello" + want.text + "\n"
    assert kernels_on()
