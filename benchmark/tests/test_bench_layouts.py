"""The weights a family's layout draws and the program's params built from
them, held to the bytes they had before layouts/ and adapters/ took them
over from harness/weights.py and harness/program.py: the sha256 of every
tensor, in order, for tiny copies of both configurations on the CPU at one
seed, and on the card at full widths and two layers (marker `cuda`). The
digests were computed once, before that move, and are constants here."""

import hashlib
import json
import os

import pytest
import torch

from benchmark.harness import program, spec, weights

SEED = 2 ** 33 + 5
# the tiny copies: the sizes below, and INT8 groups of 32
SIZES = dict(hidden_size=256, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=4096)
GROUP = 32

# (configuration, "raw" or "params") -> [(path, "dtype [shape] sha256") or
# (path, group size) or (path, None)], in order
PINS = {
    ("qwen2.5-7b-int8", "raw"): [
        ('tok_emb', 'bfloat16 [4096, 256] e3a92e9564e3090065d8b49a41211aaff5007e1330a0920f1322ba946d449d4f'),
        ('final_norm', 'float32 [256] 7f2a664f8f6b8234c3c81a6bb3cf5f43abf39fda0f46dfdcd612de466b4f11f4'),
        ('lm_head.q', 'int8 [256, 4096] 8c91f7e3a0fd8baeac6ece697f221ad79df6a82513cbc816cdfb52b23c0c2cb9'),
        ('lm_head.s', 'bfloat16 [8, 4096] b46ebf6690b89124f1802a09f656e49f34294cfcbab5f0b68d1ce028b81c0336'),
        ('lm_head.g', 32),
        ('layers.attn_norm', 'float32 [2, 256] 392c054be548a1538d247e52e078f7a22e873556f98da4e4526c5ef0805c7926'),
        ('layers.ffn_norm', 'float32 [2, 256] d904c3d23f07bc00a63d505010dc2753087b3278df3a44bc09cb3a7eb2044dea'),
        ('layers.wq.q', 'int8 [2, 256, 256] b6ef9a9b2b9b24db39237d50f58ddc8b8ec7a553bf8bfb17111fb9eb5472749d'),
        ('layers.wq.s', 'bfloat16 [2, 8, 256] 62047d44a83a1edf4ca3d03297461243e4bb0c9917ff2e62694d5510bed8e2de'),
        ('layers.wq.g', 32),
        ('layers.wk.q', 'int8 [2, 256, 128] dda7a9c434cd62198d50d42a331a0e7bd3963b28c3d8805001885f680f8f0c2c'),
        ('layers.wk.s', 'bfloat16 [2, 8, 128] a725ea0a891ddad1c76dfd0b942762a908e834672b33543e27338d6b06976089'),
        ('layers.wk.g', 32),
        ('layers.wv.q', 'int8 [2, 256, 128] 0ac474d1bd7ad21a464a5b3359fa84f0fde709c167897b5caedde1584774ef7d'),
        ('layers.wv.s', 'bfloat16 [2, 8, 128] 0d803faf8f353c491ca87b489e5cf78bbce741f90264bde793446b8b5c6032c7'),
        ('layers.wv.g', 32),
        ('layers.wo.q', 'int8 [2, 256, 256] c4ccc0fc1d5ea20336e6784bfbd3bac6fe2d746ff267f4f38d7bc9881ceb14ea'),
        ('layers.wo.s', 'bfloat16 [2, 8, 256] e6691e386bd3af62ab9f71ebaa5b8454596d51b74c45bbfae097cb1f77dea57d'),
        ('layers.wo.g', 32),
        ('layers.w1.q', 'int8 [2, 256, 1024] 97182e730269673c4e9f51364b40c88c2af70ed32f5d477efa5d464eba69aa96'),
        ('layers.w1.s', 'bfloat16 [2, 8, 1024] 47e31815b629bf8a46c9dea4fa1d3486512a9b9fe07d96fb67bb26a4976936fb'),
        ('layers.w1.g', 32),
        ('layers.w3.q', 'int8 [2, 256, 1024] e060e6d46ed45ecce25576f7d54ebdf6a9c6bd4ad9006f54aad973b58c3e42e4'),
        ('layers.w3.s', 'bfloat16 [2, 8, 1024] 9d2707b5d1f93163d6d33e885e402d17f822dfbc3b9df988e55dd04b8b1348a4'),
        ('layers.w3.g', 32),
        ('layers.w2.q', 'int8 [2, 1024, 256] 05fbf2efed2a21abb353861c7c591f80e4084d51188984f56066a026cfd5d3d1'),
        ('layers.w2.s', 'bfloat16 [2, 32, 256] d050396e84848b9c2883f688a693deb8323a96475fe9962a699052d1dd6f4994'),
        ('layers.w2.g', 32),
        ('layers.bq', 'bfloat16 [2, 256] a8e1015870a25698e133e706e1571242431650729446f1cf96f635f8cd63f84e'),
        ('layers.bk', 'bfloat16 [2, 128] 290e1fcf16d70b93aad591ce23472d8cfb46975468e8cfd9e88f03b51b4cbf3c'),
        ('layers.bv', 'bfloat16 [2, 128] 425fc90d9b93953c93c8c80b88a451681b178338b833acd00d1c08d8c25559f4'),
    ],
    ("qwen2.5-7b-int8", "params"): [
        ('tok_emb', 'bfloat16 [4096, 256] e3a92e9564e3090065d8b49a41211aaff5007e1330a0920f1322ba946d449d4f'),
        ('blocks.attn_norm', 'float32 [2, 256] 392c054be548a1538d247e52e078f7a22e873556f98da4e4526c5ef0805c7926'),
        ('blocks.ffn_norm', 'float32 [2, 256] d904c3d23f07bc00a63d505010dc2753087b3278df3a44bc09cb3a7eb2044dea'),
        ('blocks.wo.q', 'int8 [2, 256, 256] c4ccc0fc1d5ea20336e6784bfbd3bac6fe2d746ff267f4f38d7bc9881ceb14ea'),
        ('blocks.wo.s', 'bfloat16 [2, 8, 256] e6691e386bd3af62ab9f71ebaa5b8454596d51b74c45bbfae097cb1f77dea57d'),
        ('blocks.wo.g', 32),
        ('blocks.w2.q', 'int8 [2, 1024, 256] 05fbf2efed2a21abb353861c7c591f80e4084d51188984f56066a026cfd5d3d1'),
        ('blocks.w2.s', 'bfloat16 [2, 32, 256] d050396e84848b9c2883f688a693deb8323a96475fe9962a699052d1dd6f4994'),
        ('blocks.w2.g', 32),
        ('blocks.wqkv.q', 'int8 [2, 256, 512] a539e72dc1a3b2371e74254a77035d76495ca4a61a57c0d4d250fcfc4caa025e'),
        ('blocks.wqkv.s', 'bfloat16 [2, 8, 512] 28bc0fb8661095257bd330112b28b81d9625448e1cc7f6842520910af8a6765a'),
        ('blocks.wqkv.g', 32),
        ('blocks.w13.q', 'int8 [2, 256, 2048] d95676be1766b4a7bd18227d780795c979a13093d9329a93ec3e26d93d943c58'),
        ('blocks.w13.s', 'bfloat16 [2, 8, 2048] 93b918d5d6d5b51f880d14f1fe36e35c7f27f1f461636fa02133f7caf9144ed0'),
        ('blocks.w13.g', 32),
        ('blocks.bqkv', 'bfloat16 [2, 512] 2dee80c06ada5d23ac67239f1f9019600b7399a00a0ccb02211168e56f23e8af'),
        ('final_norm', 'float32 [256] 7f2a664f8f6b8234c3c81a6bb3cf5f43abf39fda0f46dfdcd612de466b4f11f4'),
        ('lm_head.q', 'int8 [256, 4096] 8c91f7e3a0fd8baeac6ece697f221ad79df6a82513cbc816cdfb52b23c0c2cb9'),
        ('lm_head.s', 'bfloat16 [8, 4096] b46ebf6690b89124f1802a09f656e49f34294cfcbab5f0b68d1ce028b81c0336'),
        ('lm_head.g', 32),
    ],
    ("qwen2.5-0.5b-bf16", "raw"): [
        ('tok_emb', 'bfloat16 [4096, 256] 25f18fecefe4e95f769eed75d78776a363fdf28548d9d148f692af1c87ff0f85'),
        ('final_norm', 'float32 [256] ef0697fbefce1f99688b77cd4c181bbbeb9d830c29359267a6b255faaef8b09b'),
        ('lm_head', None),
        ('layers.attn_norm', 'float32 [2, 256] 392c054be548a1538d247e52e078f7a22e873556f98da4e4526c5ef0805c7926'),
        ('layers.ffn_norm', 'float32 [2, 256] d904c3d23f07bc00a63d505010dc2753087b3278df3a44bc09cb3a7eb2044dea'),
        ('layers.wq', 'bfloat16 [2, 256, 256] c4f53f3a04ac2e1dc223cc2eab70c89b51a9faf313aa8ec90b4c2102d07b0eb8'),
        ('layers.wk', 'bfloat16 [2, 256, 128] 7a2a71c2cf3776865db1913fd00434fc08494965f373a13b9310e3c26fe69f1b'),
        ('layers.wv', 'bfloat16 [2, 256, 128] 3949f3c1dffabc436a72495d7326b13a1ac798395678c981429d55ab62949943'),
        ('layers.wo', 'bfloat16 [2, 256, 256] 54771e78e9f6ebf9e1f1d88c92e93546d7a82a3c1144d756629beae703b12c00'),
        ('layers.w1', 'bfloat16 [2, 256, 1024] 61e92072bb6ca422245ff7b686312ca1608fb4678328c875637f968421828d39'),
        ('layers.w3', 'bfloat16 [2, 256, 1024] bec406e343f9c6c01689c5681fbbb9a36fd0e69060c10a0990e01d97c10d936f'),
        ('layers.w2', 'bfloat16 [2, 1024, 256] 4040c924493544d9e44cda43dfb632926e7633b67e8691b21b7af3896d64c51c'),
        ('layers.bq', 'bfloat16 [2, 256] d777ca6c727cf252bf4537f5b6fd0d1eabb5b7f4d0a10f0aaff3a892116c0e2a'),
        ('layers.bk', 'bfloat16 [2, 128] b1f53219cf5b2f870ef7f3d52cc968b997ac86a431614c226487d690a6ee10ab'),
        ('layers.bv', 'bfloat16 [2, 128] a6162a5ebeffd7338aabcda5b33edf3159ce816f1265f208fc811bd6c9dca4d1'),
    ],
    ("qwen2.5-0.5b-bf16", "params"): [
        ('tok_emb', 'bfloat16 [4096, 256] 25f18fecefe4e95f769eed75d78776a363fdf28548d9d148f692af1c87ff0f85'),
        ('blocks.attn_norm', 'float32 [2, 256] 392c054be548a1538d247e52e078f7a22e873556f98da4e4526c5ef0805c7926'),
        ('blocks.ffn_norm', 'float32 [2, 256] d904c3d23f07bc00a63d505010dc2753087b3278df3a44bc09cb3a7eb2044dea'),
        ('blocks.wo', 'bfloat16 [2, 256, 256] 54771e78e9f6ebf9e1f1d88c92e93546d7a82a3c1144d756629beae703b12c00'),
        ('blocks.w2', 'bfloat16 [2, 1024, 256] 4040c924493544d9e44cda43dfb632926e7633b67e8691b21b7af3896d64c51c'),
        ('blocks.wqkv', 'bfloat16 [2, 256, 512] 95d2b8c0e384b70979e70075bdd0952559b38246853b8da6082747b182d4bca3'),
        ('blocks.w13', 'bfloat16 [2, 256, 2048] c6b19fe717bfeebd6cbdafe6ad46d247e11210be2dd5800cefacab3ae3861ddf'),
        ('blocks.bqkv', 'bfloat16 [2, 512] 651eb6891e23be8e767f21b53d879833edbaa4526b78515b921d1fd18ee9b3d8'),
        ('final_norm', 'float32 [256] ef0697fbefce1f99688b77cd4c181bbbeb9d830c29359267a6b255faaef8b09b'),
        ('lm_head', 'bfloat16 [256, 4096] 99900d7a9a087b88bdf7a6b4ec149d559d5af4816a9dbae153b9cb006e7f3330'),
    ],
}


def _config(name):
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json"))
    cfg.update(SIZES)
    if "group_size" in cfg["benchmark"]:
        cfg["benchmark"] = dict(cfg["benchmark"], group_size=GROUP)
    return cfg


def _digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()


def walk(obj, path="", out=None) -> list:
    """Every tensor (dtype, shape, digest), group size and missing matrix
    of a raw or params tree, in its order."""
    out = [] if out is None else out
    if obj is None:
        out.append((path, None))
    elif isinstance(obj, torch.Tensor):
        dtype = str(obj.dtype).split(".")[-1]
        out.append((path, f"{dtype} {list(obj.shape)} {_digest(obj)}"))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            walk(v, f"{path}.{k}" if path else k, out)
    elif hasattr(obj, "q") and hasattr(obj, "s"):  # the port's QuantTensor
        walk(obj.q, path + ".q", out)
        walk(obj.s, path + ".s", out)
        out.append((path + ".g", obj.group_size))
    else:
        out.append((path, obj))
    return out


def _raw(name):
    raw = weights.make(_config(name), SEED, "cpu")
    assert raw.pop("family") == "qwen2"
    return raw


@pytest.mark.parametrize("name", ["qwen2.5-7b-int8", "qwen2.5-0.5b-bf16"])
def test_raw_weights_are_the_pinned_bytes(name):
    assert walk(_raw(name)) == PINS[(name, "raw")]


@pytest.mark.parametrize("name", ["qwen2.5-7b-int8", "qwen2.5-0.5b-bf16"])
def test_program_params_are_the_pinned_bytes(name):
    raw = weights.make(_config(name), SEED, "cpu")
    assert walk(program.params(raw)) == PINS[(name, "params")]


@pytest.mark.parametrize("name", ["qwen2.5-7b-int8", "qwen2.5-0.5b-bf16"])
def test_the_tiny_copy_is_the_pinned_one(name):
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json"))
    assert weights.layout(cfg).tiny(cfg) == _config(name)


# On the card: both configurations at full widths and 2 layers, seed
# 2**31 + 3. (configuration, "raw" or "params") -> sha256 of the JSON list
# of [path, "torch.<dtype> [shape] sha256"] (or [path, group size] or
# [path, null]) of every tensor in order, the raw tree without "family".
CARD_SEED = 2 ** 31 + 3
CARD_PINS = {
    ("qwen2.5-7b-int8", "raw"): "c13a4de11586728894c3f9d816f8015618a0e37e36904ede71989766f2163bcb",
    ("qwen2.5-7b-int8", "params"): "3b5d180c39e6b81144b0b836e835159ec5271460644bb58e924e0b2f1cc7db4e",
    ("qwen2.5-0.5b-bf16", "raw"): "c2c72c2a7ed1e0c88aa27f63777b0983856afa9575516b3cec7262d8a4bcb06b",
    ("qwen2.5-0.5b-bf16", "params"): "1acd4f229ee8a3ea20ab9dae2932928b2fd288749d1ad0cb75c9f1ffd35dd157",
}


def _card_digest(tree) -> str:
    rows = []
    for path, v in walk(tree):
        if isinstance(v, str):
            dtype, rest = v.split(" ", 1)
            v = f"torch.{dtype} {rest}"
        rows.append([path, v])
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2.5-7b-int8", "qwen2.5-0.5b-bf16"])
def test_the_card_draws_the_pinned_bytes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json"))
    cfg = dict(cfg, num_hidden_layers=2)
    raw = weights.make(cfg, CARD_SEED, dev)
    assert raw.pop("family") == "qwen2"
    assert _card_digest(raw) == CARD_PINS[(name, "raw")]
    del raw
    params = program.params(weights.make(cfg, CARD_SEED, dev))
    assert _card_digest(params) == CARD_PINS[(name, "params")]
