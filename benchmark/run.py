#!/usr/bin/env python3
"""The benchmark of kuiperllama_tpu_torch, the PyTorch/CUDA port, on
NVIDIA H100 cards: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device, and with
--trace 1 breakdown; the compared numbers last, under "checks"). Exits
non-zero, with no result line, without the CUDA devices the cell asks for,
or when a JAX module is loaded. The build and kernel caches stay in fixed
directories inside the checkout: the port's nvcc libraries in
kuiperllama_tpu_torch/_build/, the rest under benchmark/_cache/.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "CUDA_CACHE_PATH": "cuda"}

if __name__ == "__main__":
    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"  # keep transformers, if anything loads it, off JAX
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark.harness.main import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
