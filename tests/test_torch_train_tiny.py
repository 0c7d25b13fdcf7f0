"""The port's tiny trainer (kuiperllama_tpu_torch/tools/train_tiny.py)
against the JAX tool's (tools/train_tiny.py, imported by path) and the JAX
package, fp32 on the CPU.

  * the model and the data: `build_cfg` and `encode_bytes` equal the JAX
    tool's, and the 85/15 split leaves the committed report's 662 held-out
    bytes;
  * from `random_params(cfg, seed)` (the same draws on both sides), the loss
    of one fixed numpy batch and every gradient equal `jax.value_and_grad`
    of the JAX tool's loss over `decoder.forward_inner`: max-abs error
    within 1e-5 of max|JAX| per leaf;
  * three AdamW steps on fixed batches equal three `optax.adamw(lr)` steps
    (its defaults, weight decay 1e-4 on every leaf) given the same
    gradients: every leaf within 1e-5 of max|JAX|; `train_step` is the loss,
    its backward and that step;
  * the exported v0 and v3 files are byte-equal to JAX's `write_v0` /
    `write_v3` of the same params;
  * a 30-step run on the CPU lowers the loss, writes GATE_PPL.json and
    passes the gate through the loaders (the plain INT8 matmul);
  * --out refuses an existing directory under checkpoints/.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kuiperllama_tpu.checkpoint.binfmt import write_v0 as jwrite_v0, write_v3 as jwrite_v3
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.params import random_params
from kuiperllama_tpu_torch.tools import train_tiny as tt
from test_torch_exp_kernel import load_jax_tool
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5
B, T = 3, 16


@pytest.fixture(scope="module")
def jtool():
    return load_jax_tool("train_tiny")


@pytest.fixture(scope="module")
def cfg():
    return tt.build_cfg(seq_len=T)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (B, T + 1)).astype(np.int32) for _ in range(n)]


def _jax_loss(cfg):
    """The JAX tool's loss_fn (tools/train_tiny.py main), over the JAX
    package's forward_inner."""
    def loss_fn(params, tokens):
        Bt, T1 = tokens.shape
        cache = jdec.init_kv_cache(cfg, batch=Bt, max_len=T1, dtype=jnp.float32)
        positions = jnp.broadcast_to(jnp.arange(T1, dtype=jnp.int32), (Bt, T1))
        logits, _ = jdec.forward_inner(cfg, params, tokens, positions, cache)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)[..., 0]
        return jnp.mean(nll)
    return loss_fn


def _jax_cfg(jtool):
    return jtool.build_cfg(seq_len=T)


def _close_tree(got: dict, want: dict):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_tree(got[k], v)
            continue
        w = np.asarray(v, np.float32)
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL, (k, err)


def test_model_and_data_are_the_jax_tools(jtool, cfg):
    for fam in ("llama2", "qwen2"):
        assert (dataclasses.asdict(tt.build_cfg(family=fam))
                == dataclasses.asdict(jtool.build_cfg(family=fam)))
    text = "héllo\x7fworld ~"
    np.testing.assert_array_equal(tt.encode_bytes(text), jtool.encode_bytes(text))
    with open(tt.CORPUS) as f:
        ids = tt.encode_bytes(f.read())
    assert len(ids) - int(len(ids) * 0.85) == 662  # checkpoints/tinychar/GATE_PPL.json


def test_loss_and_gradients_match_jax(jtool, cfg):
    p = random_params(cfg, seed=3)
    tokens = _batches(1)[0]
    jloss, jgrads = jax.value_and_grad(_jax_loss(_jax_cfg(jtool)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(tokens))
    params = tt.trainable(p, CPU)
    loss = tt.loss_fn(cfg, params, torch.from_numpy(tokens), decoder.build_rope(cfg, CPU))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    grads = {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    _close_tree(grads, jax.tree.map(np.asarray, jgrads))


def _set_grads(params, grads):
    for k, v in params.items():
        if isinstance(v, dict):
            _set_grads(v, grads[k])
        else:
            v.grad = torch.from_numpy(np.array(grads[k], np.float32))


def test_adamw_steps_match_optax(jtool, cfg):
    """Three steps on fixed batches, each side's optimizer given the same
    gradients (JAX's at JAX's params): torch AdamW as train_tiny builds it
    is optax.adamw(lr) within 1e-5. Through each side's own gradients the
    parameters part by more: a gradient below Adam's eps (1e-8) takes a
    step of g / (|g| + eps), so the 1e-11 that fp32 summation order moves
    it by becomes a step's difference (test_loss_and_gradients_match_jax
    holds the gradients)."""
    lr = 3e-3
    p = random_params(cfg, seed=4)
    jparams = jax.tree.map(jnp.asarray, p)
    opt = optax.adamw(lr)
    state = opt.init(jparams)
    grad_fn = jax.grad(_jax_loss(_jax_cfg(jtool)))
    params = tt.trainable(p, CPU)
    topt = tt.make_optimizer(params, lr)
    for toks in _batches(3, seed=11):
        grads = grad_fn(jparams, jnp.asarray(toks))
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(params, jax.tree.map(np.asarray, grads))
        topt.step()
    assert topt.defaults["weight_decay"] == 1e-4
    assert len(topt.param_groups[0]["params"]) == len(jax.tree.leaves(jparams)) == 12
    _close_tree(params, jax.tree.map(np.asarray, jparams))


def test_train_step_is_loss_backward_step(cfg):
    """`train_step` returns the loss before its AdamW step and leaves the
    params of loss_fn, backward and step done by hand, bit for bit."""
    p = random_params(cfg, seed=6)
    toks = torch.from_numpy(_batches(1, seed=2)[0])
    rope = decoder.build_rope(cfg, CPU)
    a, b = tt.trainable(p, CPU), tt.trainable(p, CPU)
    oa, ob = tt.make_optimizer(a, 1e-3), tt.make_optimizer(b, 1e-3)
    loss = tt.train_step(cfg, a, oa, toks, rope)
    want = tt.loss_fn(cfg, b, toks, rope)
    want.backward()
    ob.step()
    assert torch.equal(loss, want.detach()) and not loss.requires_grad
    for x, y in zip(tt.leaves(a), tt.leaves(b)):
        assert torch.equal(x, y)


def test_export_is_byte_equal_to_jax(cfg, tmp_path):
    host = tt.to_numpy(tt.trainable(random_params(cfg, seed=5), CPU))
    p0, p3, err = tt.export(str(tmp_path / "port"), cfg, host)
    os.makedirs(tmp_path / "jax")
    jwrite_v0(str(tmp_path / "jax" / "a.bin"), cfg, host)
    jwrite_v3(str(tmp_path / "jax" / "a.q8.bin"), cfg, host, group_size=64)
    assert open(p0, "rb").read() == open(tmp_path / "jax" / "a.bin", "rb").read()
    assert open(p3, "rb").read() == open(tmp_path / "jax" / "a.q8.bin", "rb").read()
    assert 0 < err < 1e-2


def test_thirty_steps_lower_the_loss_and_pass_the_gate(tmp_path, capsys):
    out = tt.run(CPU, str(tmp_path / "run"), steps=30, batch=4, scan_chunk=10)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["final_train_loss"] < out["initial_train_loss"]
    assert out["passes_gate"] and out["kernel_mode"] == "cpu-plain"
    assert out["heldout_tokens"] == 662 and out["device"] == "cpu"
    report = json.loads((tmp_path / "run" / "GATE_PPL.json").read_text())
    for key in ("ppl_fp", "ppl_int8", "delta", "passes_gate", "final_train_loss",
                "quant", "kernel_mode", "max_group_quant_err"):
        assert report[key] == out[key]
    assert {"tinychar.bin", "tinychar.q8.bin"} <= set(os.listdir(tmp_path / "run"))


def test_out_refuses_a_committed_fixture_directory(tmp_path):
    with pytest.raises(SystemExit, match="checkpoints"):
        tt.run(CPU, os.path.join(tt.ROOT, "checkpoints", "tinychar"), steps=1)
    with pytest.raises(SystemExit):
        tt.main(["--device", "cpu"])  # --out is required
    tt.check_out(str(tmp_path / "new"))  # a new directory is fine
