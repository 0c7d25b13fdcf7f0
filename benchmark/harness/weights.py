"""The benchmark's own weights, made on the device from the seed.

One torch.Generator on the device, seeded with the run's seed, draws every
tensor in a fixed order and in a few large calls, in the type it is served
in: INT8 payloads uniform over [-127, 127] with bf16 group scales spread
over [0.5, 1.5) of a base, or bf16 normal weights. Each matrix [K, N] has
a standard deviation of GAIN / sqrt(K) (fan-in scaled) and the embedding
GAIN / sqrt(d). At the models' own initializer range, 0.02 for every
matrix, Qwen2.5-0.5B's 896-wide layers shrink their input and greedy
decoding falls into repetition loops (23 distinct tokens in 1,003 served),
which leaves the comparison little to see; at a gain of 1 short loops
remain at small widths, at 1.5 none are left. bf16 biases; fp32 norm
weights near 1. The same seed on the same device gives
the same bytes, so the reference makes them again after the program is
freed. Nothing here imports the program.

What a model family draws, and in which order, is its layout:
`layouts/<family>.py`, found by the configuration's `benchmark.family`,
with `shapes(config)`, `draw(config, w)` given a `Draw`, and `tiny(config)`
(a CPU-sized copy for the tests). The raw weights it returns carry the
family under "family"; a matrix in them is a bf16 tensor or a dict {"q":
int8, "s": bf16 [.., K/g, N], "g": g}, with any leading axes (layers,
experts).
"""

from __future__ import annotations

import torch

from benchmark.harness import spec

GAIN = 1.5
BIAS_STD = 0.1
NORM_STD = 0.1
# uniform int8 over [-127, 127] has a standard deviation of 127 / sqrt(3)
INT8_STD = 127 / 3 ** 0.5
_SEED_MOD = 2 ** 63


class Draw:
    """The drawing handle a layout is given: one seeded generator on the
    device, and the configuration's matrix form (INT8 with group scales, or
    bf16)."""

    def __init__(self, config: dict, seed: int, device):
        self.device = device
        self.quant = config["benchmark"]["weights"]
        self.g = config["benchmark"].get("group_size")
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % _SEED_MOD)

    def normal(self, shape, std, dtype):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32).mul_(std).to(dtype)

    def matrix(self, shape):
        """A matrix [..., K, N] in the configuration's form, fan-in scaled."""
        shape = tuple(shape)
        K, N = shape[-2], shape[-1]
        std = GAIN * K ** -0.5
        if self.quant == "int8":
            g = self.g
            q = torch.randint(-127, 128, shape, generator=self.gen,
                              device=self.device, dtype=torch.int8)
            sc = torch.rand(shape[:-2] + (K // g, N), generator=self.gen,
                            device=self.device, dtype=torch.float32)
            sc = sc.add_(0.5).mul_(std / INT8_STD).to(torch.bfloat16)
            return {"q": q, "s": sc, "g": g}
        if self.quant == "bfloat16":
            return self.normal(shape, std, torch.bfloat16)
        raise ValueError(f"weights {self.quant!r}")


def layout(config: dict, bench_dir: str = spec.BENCH_DIR):
    """layouts/<family>.py of the configuration's family."""
    return spec.family_module("layouts", config["benchmark"]["family"], bench_dir)


def make(config: dict, seed: int, device, bench_dir: str = spec.BENCH_DIR) -> dict:
    raw = layout(config, bench_dir).draw(config, Draw(config, seed, device))
    raw["family"] = config["benchmark"]["family"]
    return raw


def dequantize(w, layer=None) -> torch.Tensor:
    """A raw matrix (or layer `layer` of a stacked one) in float32; an INT8
    one [..., K, N] with scales [..., K/g, N] keeps its leading axes."""
    if isinstance(w, dict):
        q, sc, g = w["q"], w["s"], w["g"]
        if layer is not None:
            q, sc = q[layer], sc[layer]
        *lead, K, N = q.shape
        return (q.view(*lead, K // g, g, N).float()
                * sc.float()[..., :, None, :]).view(*lead, K, N)
    return (w if layer is None else w[layer]).float()
