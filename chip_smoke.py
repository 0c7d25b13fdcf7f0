#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kuiperllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero before the
last line:
  1. device: the card's name, power limit and count; fails without CUDA.
  2. build: the ahead-of-time build, `python -m
     kuiperllama_tpu_torch.ops.kernels.build`, as a child process from the
     checkout's root: nvcc builds every csrc/*.cu (one process per source,
     all at once) and g++ the native runtime's two libraries; it must exit
     0. A second call must report every library `cached`, and afterwards
     `build.build` of every csrc source builds nothing, so no later phase
     runs nvcc. The row: `seconds` (the first call's wall), `per_source_s`
     (nvcc wall per source), `runtime_s` (g++ per library), `flags`,
     `cached_first_call`, `cached_second_call`, `second_call_s`, and the
     card's nvidia-smi line. After the last phase, a `built_nothing` row:
     no library appeared in _build/ since (no phase, nor a child process of
     one, ran a compiler).
  2a. recapture: decode steps replay CUDA graphs on the card (the port's
     default; serving/graphs.py). A Qwen2.5-0.5B Generator decodes 128
     tokens on its graph, a TinyLlama-1.1B Generator (2 layers) grows the
     megakernels' workspace, and the Qwen Generator decodes again: its
     graph is captured once more (n_recaptures 1), same tokens, exact
     launches. Runs first, while the workspaces are Qwen's size.
  2b. tools: the kernel-measurement tools (kuiperllama_tpu_torch/tools): the
     roofline probes (HBM read, decode GEMV weight stream in bf16 and int8,
     bf16 tensor-core matmul) at their default sizes; the three tool kernels
     held against their plain versions and timed beside their bounds:
     exp_stream at the five TinyLlama-1.1B shapes over the JAX tool's tiles
     that divide them (equal; beside the floor of one empty launch),
     exp_outscale and the GEMM (exp_kernel's `current`) there at M = 8
     (within 2^-7; yardsticks bf16 x @ the pre-dequantized weight and the
     GEMM), each probe's device kernels per call (one); exp_int8 in its
     six modes held at L 2 and on the tool's own L 64 stack (1e-5, nodot
     equal) and timed there; the GEMM at bench_kernels' shapes (Llama-2-7B,
     M = 8, g 64, fp32 scales); then
     the tools' entry points (exp_kernel, exp_int8, bench_kernels at
     Llama-2-7B M = 8, kernel and torch variants) with exact launch counts.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the Llama-2-7B main-path shapes, with CUDA-event times (median of 25
     launches) of the kernel, the plain version and one library call
     (x @ w_bf16 with the weight dequantized ahead of time: a yardstick the
     port never calls), beside the least time the card could take; the GEMV
     also at a ragged N, and at the five Llama-2-7B shapes with 4 and 8
     column threads a warp at the plans for 2, 4 and 8 blocks per SM; the
     wgmma kernels' registers and local bytes (none); a `kernel_bits` row
     (two calls of the GEMV at the five shapes and of the GEMM at
     BITS_GEMM_M rows of the four projections give the same bits, with
     the GEMM's reduce_splits launches as data); one `stream_fit` row per
     kernel and M
     (the line t = a + weight bytes / BW through the rows' times at the 7B
     shapes, beside the library's).
  4. fused kernel: the decode megakernel against its plain version on the
     card at TinyLlama-1.1B INT8 g 256, Llama-3.2-1B INT8 g 256,
     Qwen2.5-0.5B bf16 and TinyLlama-1.1B INT8 g 64 (int8 activations), full
     width and 2 layers, one step at pos 100 in a 256-slot window: error,
     CUDA-event times of the kernel and the plain version, the port's
     layered eager step on the same weights, the byte bound, and the
     launch's plan (grid, blocks per SM, each phase's tiling).
  4b. big kernel: the big-model megakernel against its plain version on the
     card (and on the CPU) at Llama-2-7B INT8 g 64 with bf16 scales,
     Llama-2-7B g 256 with fp32 scales and Llama-3-8B g 64 (BIG_CASES), full
     width and 2 layers, one step at pos 100 in a 256-slot window: error,
     CUDA-event times of the kernel and the plain version, the byte bound,
     us per phase per layer from one traced launch beside each phase's
     byte time, the walk's plan (items, splits, column threads, flushes per
     step) and the compiled kernel's registers and local bytes, held to at
     most BIG_REGISTERS and BIG_LOCAL_BYTES.
  4c. chunk kernel: the greedy chunk megakernel against its plain version on
     the card at TinyLlama-1.1B INT8 g 256, Qwen2.5-0.5B bf16 and
     Llama-3.2-1B INT8 g 256 (CHUNK_CASES), 2 layers, CHUNK_STEPS steps from
     pos 100: tokens equal up to an exact logit tie, the chunk's K/V rows,
     ms per step against the per-step bound (layer stack and lm_head), and
     the launch's plan.
  5. fixture: checkpoints/tinychar/tinychar.q8.bin, 24 greedy tokens on the
     card equal to the same run on the CPU (which uses the plain versions);
     the layered route with fp32 params, then the megakernel route
     (fused_step=True) with bf16 params and cache, then the chunk route
     (KT_FUSED_CHUNK=1): one chunk launch for the 23 decode steps.
  6. main path: Llama-2-7B at full width (INT8 group 256, bf16 scales,
     activations and cache, cache length 1024, random weights from a seed),
     Generator.generate_batch_ids on one 32-token prompt, 128 new tokens,
     greedy. Kernel launch counts are zeroed just before and read just after.
     Llama-2-7B does not fit the megakernel's plan and decodes layered. The
     decode steps replay the step's CUDA graph (captured in the 8-token
     warm-up); the same run on the eager route (graphs=False) beside it:
     equal tokens, exact launches on both, each route's decode profile.
     Every Generator and engine main path below runs both routes the same
     way: the row's `eager_*` fields, `first_token_differing` (None) and
     the graph cache's `graphs` counters (decode and prefill) with its
     pool's bytes. The prefill replays a CUDA graph of itself too: each
     Generator path (6, 6b, 7) emits a `prefill` row per PREFILL_LENS prompt
     (32 tokens, the GEMM's bucket; 100, bucket 128, the GEMM at M = 128;
     256, the dequantized matmul's), graph
     route beside eager on the same weights, each on a new Generator: the
     key's first call (eager run and capture) apart from the median of
     PREFILL_WARM warm calls, device busy per prefill and the idle share
     (torch.profiler), captures, recaptures, capture_s and pool bytes;
     first token and last logits bit for bit equal, launches exact.
  6b. big route: Llama-2-7B INT8 g 64 (bf16 scales), the same setup under
     KT_FUSED_BIG=1: one big-kernel launch and one lm_head GEMV per decode
     step, counted exactly; the same weights on the layered route beside it
     and a decode profile of the big route; then the big kernel alone at
     full depth, held against its plain version on the CPU, timed and
     traced.
  7. main paths of the megakernel route: TinyLlama-1.1B INT8 g 256 and
     Qwen2.5-0.5B bf16, full width and depth, the same setup and the auto
     route; each with its decode profile, then the megakernel alone at the
     main path's shapes: held against its plain version (card and CPU),
     timed, and one launch traced for the time of each phase per layer.
  7b. chunk route: TinyLlama-1.1B and Qwen2.5-0.5B as in 7 under
     KT_FUSED_CHUNK=1 (64-step chunks): two chunk launches for the 127
     decode steps, beside the per-step route's numbers, with a profile of
     one chunk; then the chunk kernel alone at full depth (CHUNK_STEPS steps
     from pos 100), held against its plain version on the card and timed.
  8. paged kernel (run after phase 4): the paged flash-decode kernel against
     its plain version on the card at B = 8 ragged rows (1 to 1024 tokens)
     on 128-token pages of a shuffled page table, layer 1 of a stacked pool:
     Llama-2-7B, Llama-3-8B, TinyLlama-1.1B and Qwen2.5-0.5B head geometries
     with bf16 pools, TinyLlama's with fp32 pools; errors at PAGED_SEEDS
     seeds, CUDA-event times of the kernel, the plain version and
     scaled_dot_product_attention on K/V gathered ahead (the yardstick).
  9. engine fixture (after phase 5): Engine, PagedEngine (8-token pages, a
     pool small enough to preempt) and chunked PagedEngine on the tinychar
     fixture, fp32: greedy tokens equal on the card and on the CPU and
     across the three engines; paged attention launched n_layers times per
     decode step.
 10. engine main paths (after phase 7): PagedEngine at 8 slots, cache
     length 1024, 64-step chunks, 128-token pages (the bench.py --engine
     defaults), 16 requests of 32 prompt and 128 new tokens submitted at
     once: Llama-2-7B, then TinyLlama-1.1B with prefill_chunk 256 and a
     768-token prompt on every 4th request, each on the graph route and
     then on the eager one: tokens/s, TTFT, the single-shot prefill's
     wall, equal tokens, exact launch counts on both, peak memory, and a
     profile of one decode chunk (both routes for Llama-2-7B). The warm-up
     opens every prefill key the timed run takes (the packed stream of 8
     32-token prompts, and a long prompt's wave for the chunked engine), so
     its prefills replay.
 10b. packed prefill (after phase 10): the PagedEngine's single-device
     admission prefill, models/paged.py `prefill_packed_paged`, at the 7B
     serve cell's shapes (Qwen2.5-7B, INT8 g 256, bf16 scales, activations
     and pools, random weights from a seed; 32 rows, 128-token pages, rope
     to 3,072), held to the padded `prefill_paged` of the same prompts on
     the [32, bucket] grid the mesh path still takes: for each PACKED_MIXES
     mix (about 100 tokens, whose 128-token stream takes the GEMM; about
     700, bucket 1,024; 2,048, a stream on its bucket) the admitted rows'
     last logits and every slot a prompt token writes, each within
     PACKED_TOL of max|padded|, and the greedy first tokens; then both
     prefills' CUDA-event times (eager, median of PACKED_TIMES calls) and
     peak memory.
 11. server: InferenceServer and its HTTP front end on 127.0.0.1 over a
     PagedEngine of the fixture: concurrent requests answer the CPU
     engine's tokens, an invalid one gets a 400 and serving continues; a
     request that times out is cancelled (the pool's free pages come back).
 12. perplexity gate: kuiperllama_tpu_torch/tools/gate_group.py `gate` on the
     committed fixtures (tinychar .bin + .q8.bin at g 64, tinychar_g256 requantized in
     memory at g 256 and g 128, tinychar_qwen2 .bin + .q8.bin): every INT8
     projection of a 128-token window runs the GEMM kernel, launches counted
     exactly; ppl_fp, ppl_int8 and delta held to the same gate run on the
     CPU with the plain versions (PPL_TOL), delta to the committed
     GATE_PPL*.json within PPL_DELTA_TOL (the one report made on a TPU: to
     the JAX package's CPU reading), and the gate must pass.
 13. HF checkpoint at full width: a Qwen2.5-0.5B directory (config.json with
     the published values, model.safetensors in BF16 and HF naming) written
     from a seed by this script's own writer, loaded through
     api.KuiperModel.from_checkpoint: the config equals the preset in every
     field that decides the numerics, 128 greedy tokens from a 32-token
     prompt at cache length 1024 on the per-step megakernel route (127
     launches); at 2 layers of the same directory the first step's logits
     against the plain version on the CPU (FUSED_TOL) and 128 greedy tokens
     equal up to a logit tie (TIE_TOL).
 14. bench: bench_torch.py in child processes with --selftest, the default
     (Llama-2-7B INT8 g 256, layered), --model tinyllama-1.1b, --engine and
     --engine --arrival-rate (Poisson arrivals: TTFT under load):
     each exits 0 with the one-line contract, every selftest error within
     TOL, PAGED_TOL (fp32 pools) and FUSED_TOL, the megakernel's argmax
     equal, and the selftest launched each kernel it holds.
 15. parallel (kuiperllama_tpu_torch/parallel): first the GEMV, the GEMM
     and the paged kernel at the shard shapes of the parallel paths, held
     against their plain versions (Llama-2-7B INT8 g 64 at tp = 2: each
     projection on the kernel its route takes at one row, the GEMM at 32
     and 8 rows; the paged kernel at tp = 2's 16 kv heads and at seqpar's
     full Qwen2.5-0.5B lanes over one rank's block of pages, with rows it
     does not cover, merged against the unsplit kernel). Then four rows,
     each beside the single-device run on the same weights (seed 0, bf16
     activations and cache, cache length 1024) in this process, whose
     engine admits through the padded prefill the mesh path takes:
     (a) the Generator through KuiperModel.init(mesh=) at tp = 2 on two gloo
     ranks (Llama-2-7B INT8 g 64, bf16 scales, full width and depth; a
     32-token prompt, 128 greedy tokens; then an exact run of 16 tokens at
     fp32 activations and cache with the INT8 kernels in exact mode, whose
     tokens must equal one device's and whose logits must lie within
     PAR_EXACT_TOL); (b) PagedEngine(mesh=) at tp = 2
     on two gloo ranks at phase 10's settings (8 slots, 16 requests of 32 +
     128 tokens, 64-step chunks, 128-token pages); (c) the (b) engine
     through ShardedPagedStep on a world of one NCCL rank in this process,
     graphs on: tokens and prefill logits bit-identical to the
     single-device engine's graph route, the same launches, each decode
     graph's captured collectives equal to the analytic bill, and each
     prefill graph's 2 L all-reduces and 1 all-gather captured; (d)
     PagedEngine(mesh=, seqpar=True) at sp = 2 on two gloo ranks
     (Qwen2.5-0.5B bf16, prefill_chunk 256, a 768-token prompt on every 4th
     request; then an exact run of 4 requests of 16 tokens on fp32 copies
     of the weights and an fp32 pool, tokens equal to one device's and
     prefill logits within PAR_EXACT_TOL). The gloo ranks are torch.multiprocessing spawns, all on
     cuda:0 (NCCL refuses two ranks on one device; gloo takes the CUDA
     tensors and passes them through the host, so their times are those of
     two gloo ranks on one card, not of NVLink). Each row: both ranks'
     tokens identical and equal to the single-device run's up to a logit
     tie at the first difference (PAR_TIE_TOL, fp32 logits), the prefill
     logits' max relative error within the full-depth FUSED_TOL, tokens/s and ms per decode step, the
     seconds inside the collectives wrapper, the counted collectives
     against the analytic bill (2 L all-reduces and 1 all-gather a tp
     decode step; L and 1 + L under seqpar), exact launches per rank of
     quant_gemv, quant_gemm and paged_attention, and peak memory per rank.
 16. server across ranks (inside phase 15, on its engines and its pool of
     two gloo ranks): every rank wraps its PagedEngine(mesh=) in an
     InferenceServer; rank 0 serves HTTP on 127.0.0.1 and broadcasts one
     control message a turn, rank 1 follows. Each server takes SRV_REQUESTS
     concurrent /generate requests of 32 + 32 tokens (queued in order before
     it starts: one wave), an invalid request (400) and a long request whose
     timeout passes (cancelled on every rank, its pages back): (a) phase 15
     (b)'s tp = 2 Llama-2-7B engine, (b) phase 15 (c)'s world of one NCCL
     rank, graphs on (no peer: no message), (c) phase 15 (d)'s seqpar sp = 2
     Qwen2.5-0.5B engine with SRV_SEQPAR_REQUESTS requests. Each beside a
     single-device server on the same weights: both ranks gave the same
     requests the same ids and tokens, equal to one device's up to a logit
     tie (PAR_TIE_TOL; (b) bit-identical), launches per rank exact against
     the steps and prefills it ran; tokens/s, TTFT p50/p99 (rank 0's
     /metrics) and the seconds inside the control broadcasts per rank. Then
     the parallel tools: seqpar_bytes against the committed
     SEQPAR_r05.json, scaling at a world of one NCCL rank (its entry point)
     and on the two gloo ranks, the counted bill verified.
 17. tools (after phase 14, before 15): the remaining tools of
     kuiperllama_tpu_torch/tools, each through its entry point in a child
     process (`python -m kuiperllama_tpu_torch.tools.<name>`; the child
     keeps its patches and KT_FUSED_BIG to itself), every output under
     smoke_out/tools17: profile_decode (TinyLlama-1.1B INT8: eager and
     graph-replay tokens equal, w2 at 88 groups on the GEMM), profile_paged
     (Llama-2-7B INT8, B = 8: the graph route's tokens equal the eager
     route's; from zeroed pools only the full step writes them; the stubbed
     variant launches no paged attention, the others as many as each other;
     stubbed <= no page writes <= full step, each within 5%),
     exp_diag (its three w2 shapes: the GEMV at cap 176, the GEMM at cap
     64), exp_big (Llama-2-7B g 64 at hidden 11008 and 11264 under
     KT_FUSED_BIG=1: the measured route big), bench_matrix (--only
     tinyllama_int8_b1,qwen2.5-0.5b_fp_b1: both rows without an error),
     profile2 (TinyLlama-1.1B with --trace: the trace file exists), exp_step
     (Llama-2-7B, 128 steps: the measured route layered, no megakernel
     launched, the second baseline's tokens
     equal the first's), exp_ablate (TinyLlama-1.1B: every part present),
     train_tiny (200 steps: the gate passes on the GEMM, final train loss
     <= 2.0), exp_cache (TinyLlama-1.1B: forms A, B, C give equal tokens).
     Each run exits 0 and launched every kernel its route needs; its
     launches join the kernels line under `tools17.<run>`.
 native (after phase 11): the native runtime (runtime/native.py), built
     by g++ from the checkout in phase 2 (`build_s` is then its load); the SPM tokenizer's merge_engine is "native" and
     equal to its Python merge on NATIVE_TEXTS random texts; each committed
     fixture's native header equals binfmt's (the v3 Qwen2 file refused, as
     by the JAX copy).
Then one {"kernels": [...]} line (each kernel's launches on every path in
`launches_by_path`, the new phases' and the bench children's included), the
nvidia-smi line of the card, and the last line {"ok": true, "device": {...}}.

Tolerances (max-abs error relative to max|plain|; the rounding is the same
on both sides, only the fp32 summation order differs): fast mode 1e-3 and
exact mode 1e-5 with fp32 outputs; a bf16 output is rounded once on each
side and may land one bf16 ulp apart, 2^-7 of max|plain|. The megakernel:
x_final and the new K/V row of every layer (each layer's rows relative to
their own max) against the plain version run on the card and run on the
CPU, in phase 4 and again at full depth in phase 7. The bf16 roundings carry
a last-bit difference of summation order through the layers, and where a
GEMV requantizes its activation to int8 a last-bit difference before it
flips an int8 rounding, so the limit is keyed on the activation type
(FUSED_TOL; PERF.md records the readings each was set from). Where the
activations stay bf16, layer 0's new K/V rows, made from the same input on
both sides, are also held within one bf16 ulp (a K row at its head's
magnitude: rope sums two products). The big kernel takes int8 activations
in every GEMV (FUSED_TOL's int8 limits); at full depth it is held to the
plain version run on the CPU, since the plain version run on the card sits
about 0.1 from it (cuBLAS summation order through 32 layers of int8
requantization). The chunk kernel's tokens must be equal up to a logit tie
(the plain version's logits of the two tokens within 2e-3 of max(1,
max|logit|) at the first difference at 2 layers, within FUSED_TOL at full
depth, where x_final itself moves by 2-3% between two valid summation
orders; nothing after it compared), its K/V rows up to there within
FUSED_TOL.
"""

import contextlib
import gc
import json
import os
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# dense; fp32 off the tensor cores
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
TOL = {"fast": 1e-3, "exact": 1e-5}
BF16_ULP = 2.0 ** -7
SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = "checkpoints/tinychar/tinychar.q8.bin"

# megakernel limits by depth and by whether any GEMV takes int8 activations
FUSED_TOL = {("2 layers", False): 2e-2, ("2 layers", True): 5e-2,
             ("full depth", False): 5e-2, ("full depth", True): 1e-1}
FUSED_LAYERS, FUSED_POS, FUSED_WINDOW, CACHE_LEN = 2, 100, 256, 1024
# the big megakernel at two blocks an SM: at most 128 registers a thread and
# this many local (spilled) bytes, so that an edit cannot add spills unseen
BIG_REGISTERS, BIG_LOCAL_BYTES = 128, 16
# megakernel geometries: (label, preset, INT8, group size)
FUSED_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", True, 256),
               ("llama3.2-1b", "llama3.2-1b", True, 256),
               ("qwen2.5-0.5b", "qwen2.5-0.5b", False, 0),
               ("tinyllama-1.1b g64", "tinyllama-1.1b", True, 64)]

# big-model megakernel geometries: (label, preset, group size, bf16 scales)
BIG_CASES = [("llama2-7b g64", "llama2-7b", 64, True),
             ("llama2-7b g256 fp32 scales", "llama2-7b", 256, False),
             ("llama3-8b g64", "llama3-8b", 64, True)]
# chunk megakernel geometries: (label, preset, INT8, group size), CHUNK_STEPS
# greedy steps per launch from FUSED_POS
CHUNK_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", True, 256),
               ("qwen2.5-0.5b", "qwen2.5-0.5b", False, 0),
               ("llama3.2-1b", "llama3.2-1b", True, 256)]
CHUNK_STEPS = 16

# paged attention: (label, H, KH, hd) at B = 8 ragged rows on 128-token
# pages of a shuffled page table, read at layer 1 of a stacked pool
PAGED_CASES = [("llama2-7b", 32, 32, 128), ("llama3-8b", 32, 8, 128),
               ("tinyllama-1.1b", 32, 4, 64), ("qwen2.5-0.5b", 14, 2, 64)]
PAGED_LENS = [1, 127, 128, 129, 300, 512, 777, 1024]
PAGED_PS = 128
PAGED_SEEDS = 3
# the normalised output acc / l relative to max|plain|, by pool dtype, and
# m relative to max|m| (PERF.md records the readings they were set from)
PAGED_TOL = {"bf16": 1e-3, "fp32": 1e-6}
PAGED_M_TOL = 1e-6
# engine main paths (the bench.py --engine defaults): slots, cache length,
# decode chunk, page size, requests, prompt and new tokens
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_PS = 8, 64, 128
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW = 16, 32, 128
PROFILE_STEPS = 16
# the packed prefill at the 7B serve cell's shapes: Qwen2.5-7B's published
# config, the serve cell's slots, pages and context; prompt-length mixes of
# about 100, 700 and 2,048 tokens (PACKED_MIXES); the packed and the padded
# prefill differ in bf16 summation order (other GEMM shapes, masked keys),
# so they are held within the full-depth limit of the other bf16 holds
QWEN7B = dict(family="qwen2", dim=3584, hidden_dim=18944, n_layers=28, n_heads=28,
              n_kv_heads=4, vocab_size=152064, tied_embedding=False,
              group_size=256, rope_theta=1e6, norm_eps=1e-6)
SERVE_SLOTS, SERVE_PS, SERVE_MAX_LEN = 32, 128, 3072
PACKED_MIXES = {"n100": [60, 30, 10], "n700": [412, 37, 251],
                "n2048": [1100, 530, 260, 120, 38]}
PACKED_TIMES = 5
PACKED_TOL = FUSED_TOL[("full depth", False)]
# the tinychar engines: (name, engine class, options)
FIXTURE_ENGINES = [("dense", "Engine", {}),
                   ("paged", "PagedEngine", dict(page_size=8, n_pages=13,
                                                 reserve_growth=False)),
                   ("paged_chunked", "PagedEngine", dict(page_size=8,
                                                         prefill_chunk=16))]
FIXTURE_PROMPTS = [[1, 20, 33, 45, 60, 7, 90], [5, 6], list(range(10, 40)),
                   [3] * 12, [100, 2, 7], list(range(50, 70))]
FIXTURE_NEW = 24

# the perplexity gate: (label, fp checkpoint, in-memory group, v3 file,
# family, committed report of the JAX side)
PPL_CASES = [
    ("tinychar g64", "checkpoints/tinychar/tinychar.bin", None,
     "checkpoints/tinychar/tinychar.q8.bin", "llama2", "checkpoints/tinychar/GATE_PPL.json"),
    ("tinychar_g256 g256", "checkpoints/tinychar_g256/tinychar.bin", 256, None, "llama2",
     "checkpoints/tinychar_g256/GATE_PPL_G256_r05.json"),
    ("tinychar_g256 g128", "checkpoints/tinychar_g256/tinychar.bin", 128, None, "llama2",
     "checkpoints/tinychar_g256/GATE_PPL_G128_r05.json"),
    ("tinychar_qwen2 g64", "checkpoints/tinychar_qwen2/tinychar.bin", None,
     "checkpoints/tinychar_qwen2/tinychar.q8.bin", "qwen2",
     "checkpoints/tinychar_qwen2/GATE_PPL.json"),
]
# checkpoints/tinychar/GATE_PPL.json was made on a TPU ("pallas-fast-
# compiled"), where fp32 matmuls ran at the TPU's default precision: its
# ppl_fp reads 11.90694 where an fp32 evaluation reads 11.90418, and its
# delta 0.01282 where the JAX package's own gate on the CPU reads the value
# below (tests/test_torch_evaluate.py computes it). That fixture's delta is
# held to the JAX CPU reading; the other three reports were made on the CPU.
PPL_JAX_CPU_DELTA = {"tinychar g64": 0.0038045353875482135}
PPL_DELTA_TOL = 1e-3
# card against the CPU run of the plain versions: ppl relative, delta
# absolute (readings on an H100 80GB HBM3 at 700 W: ppl up to 2.4e-5, delta
# up to 2.2e-4; PERF.md)
PPL_TOL = {"ppl": 1e-4, "delta": 5e-4}
# a greedy difference is a tie when the two tokens' logits lie within this
# share of max(1, max|logit|) at 2 layers (the CPU tests' limit)
TIE_TOL = 2e-3
# bench_torch.py children: (label, arguments)
BENCH_RUNS = [("selftest", ["--selftest"]), ("default", []),
              ("tinyllama-1.1b", ["--model", "tinyllama-1.1b"]), ("engine", ["--engine"]),
              ("engine arrival", ["--engine", "--arrival-rate", "8"])]

# the parallel phase: two ranks on the one card; Llama-2-7B INT8 at g 64
# (w2's 172 scale groups split 86 a rank at tp 2; g 256 leaves 21.5, which
# validate_tp refuses), its shard shapes (name, K, N), Qwen2.5-0.5B's
# seqpar engine with chunked prefill and a long prompt on every 4th request
PAR_RANKS = 2
PAR_GROUP = 64
PAR_SHAPES = [("wqkv", 4096, 6144), ("wo", 2048, 4096), ("w13", 4096, 11008),
              ("w2", 5504, 4096), ("lm_head", 4096, 16000)]
PAR_PREFILL_CHUNK = 256
PAR_SEQPAR_PROMPT = 768
PAR_TIMEOUT_S = 300
# a first difference from the single-device run is a tie when the two
# tokens' fp32 logits lie within this share of max(1, max|logit|). TIE_TOL
# is the 2-layer limit; at full depth (32 and 24 layers) two valid
# summation orders move the logits further (the tp = 2 prefill logits sat
# 2.1% of max|logit| from the single-device ones on an H100 80GB HBM3 at
# 700 W: PERF.md), so the rows take the full-depth limit of the other
# full-depth comparisons with bf16 activations (FUSED_TOL) and report the
# gap against TIE_TOL beside it
PAR_TIE_TOL = FUSED_TOL[("full depth", False)]
# row (a)'s exact run: PAR_EXACT_NEW greedy tokens at fp32 activations and
# cache with the INT8 kernels in exact mode (fp32 x against the fp32
# dequantized weights: no bf16 rounding left), where two ranks differ from
# one device by fp32 summation order only. Tokens must be equal and every
# step's logits within PAR_EXACT_TOL of max|logit|; a wrong shard or merge
# moves them by the order of the logits themselves
PAR_EXACT_NEW = 16
PAR_EXACT_TOL = 1e-4
# row (d)'s exact run: the first PAR_EXACT_REQUESTS requests (the 768-token
# prompt among them, so decode and chunked prefill merge both shards'
# pages) of PAR_EXACT_NEW tokens on fp32 copies of the bf16 weights with an
# fp32 pool (dense fp32 matmuls, TF32 off): tokens equal, prefill logits
# within PAR_EXACT_TOL
PAR_EXACT_REQUESTS = 4
# phase 16, the server across ranks: SRV_REQUESTS requests of ENGINE_PROMPT
# + SRV_NEW tokens posted at once to rank 0's HTTP front and queued before
# its server starts (one admission wave of the 8 slots: a fixed batch, so
# the single-device server's tokens are comparable), SRV_SEQPAR_REQUESTS on
# the seqpar server; then a request of SRV_LONG_NEW tokens (more than any
# route decodes in its SRV_TIMEOUT_S) times out, in the queue behind the
# wave or mid-decode, and is cancelled
SRV_REQUESTS, SRV_SEQPAR_REQUESTS, SRV_NEW = 8, 4, 32
SRV_TIMEOUT_S = 1.0
SRV_LONG_NEW = CACHE_LEN - ENGINE_PROMPT - 1
# the native runtime's merge against the Python oracle: random texts
NATIVE_TEXTS = 25
# Llama-2-7B main-path projections: (name, K, N, launches per decode token)
GEMV_SHAPES = [("wqkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
               ("w13", 4096, 22016, 32), ("w2", 11008, 4096, 32),
               ("lm_head", 4096, 32000, 1)]
PREFILL_M = 32
# the GEMM's rows past the prefill and engine ones, at the four 7B shapes
GEMM_LARGE_M = (64, 128, 192, 256)
# the GEMM's rows of the bit-equality row (two calls, the same bits), at
# the four 7B shapes
BITS_GEMM_M = (8, 128, 255)
# the prefill rows: a 32-token prompt (the GEMM's bucket), a 100-token one
# (bucket 128: the GEMM at M = 128) and a 256-token one (ops/linear.py
# PREFILL_DEQUANT_ROWS: the dequantized matmul), each key's first call
# apart from the median of PREFILL_WARM warm calls
PREFILL_LENS = (32, 100, 256)
PREFILL_WARM = 5

CARD = ""
T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase rows carry the run's elapsed seconds (t_s)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def knob(name):
    """Set the route knob `name` (a KT_* variable) to "1" for the block;
    None sets nothing."""
    old = os.environ.get(name) if name else None
    if name:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name and old is None:
            del os.environ[name]
        elif name:
            os.environ[name] = old


def bound(M, K, N, g, x_bytes, s_bytes, out_bytes, ops_type):
    """(bytes_ms, ops_ms): the bytes the function must move (each input read
    once, each output written once) over HBM bandwidth, and its operations
    over the peak rate of their type. The least time is the larger."""
    nbytes = M * K * x_bytes + K * N + (K // g) * N * s_bytes + M * N * out_bytes
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * M * K * N / PEAK_OPS_PER_S[ops_type] * 1e3)


def operands(dev, M, K, N, g, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((K // g, N), generator=gen, device=dev) * 0.015 + 0.005
    return x, q, s


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def check_kernel(kind, dev, M, K, N, g, mode, seed, name="", scales="bfloat16"):
    """One shape: correctness at fp32 and at the path's dtypes (bf16 x,
    `scales` scales: bfloat16 on the decode path, float32 in bench_kernels), then
    times at the path's dtypes. Times rotate weight copies past L2, as a
    decode step streams gigabytes between two reads of one weight."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    if kind == "quant_gemv":
        kernel = lambda x, q, s: qm.quant_gemv(x, q, s, g)
        plain = lambda x, q, s: qm.quant_gemv_ref(x, q, s, g)
    else:
        kernel = lambda x, q, s: qm.quant_gemm(x, q, s, g, mode)
        plain = lambda x, q, s: qm.quant_gemm_ref(x, q, s, g, mode)

    x, q, s = operands(dev, M, K, N, g, seed)
    err32 = rel_err(kernel(x, q, s), plain(x, q, s))
    xb, sb = x.to(torch.bfloat16), s.to(getattr(torch, scales))
    got, want = kernel(xb, q, sb), plain(xb, q, sb)
    torch.cuda.synchronize()
    err16 = rel_err(got, want)
    abs16 = (got.float() - want.float()).abs().max().item()
    ok = (err32 <= TOL[mode] and err16 <= BF16_ULP
          and bool(torch.isfinite(got).all()))

    qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
    variants = [(xb, qc, sb) for qc in qs]
    ms = device_time(kernel, variants=variants, device="cuda") * 1e3
    plain_ms = device_time(plain, variants=variants, device="cuda") * 1e3
    wd = qm.dequantize_bf16(q, sb, g)
    lib_variants = [(xb, wd)] + [(xb, wd.clone())
                                 for _ in range(l2_copies(2 * K * N, dev) - 1)]
    library_ms = device_time(torch.matmul, variants=lib_variants, device="cuda") * 1e3
    bytes_ms, ops_ms = bound(M, K, N, g, 2, sb.element_size(), 2,
                             "bf16" if mode == "fast" else "fp32")
    extra = {}
    if kind == "quant_gemm":
        extra = gemm_routes(xb, q, sb, g, mode, want, variants)
        ok = ok and extra["routes_ok"]
    if kind == "quant_gemm" and M >= 256:
        # the route ops/linear.py gives PREFILL_DEQUANT_ROWS rows and more, as
        # data only
        from kuiperllama_tpu_torch.ops.linear import _dequant_dot
        from kuiperllama_tpu_torch.quant import QuantTensor

        extra["dequant_dot_ms"] = device_time(
            lambda x, q, s: _dequant_dot(x, QuantTensor(q=q, s=s, group_size=g)),
            variants=variants, device="cuda") * 1e3
    del qs, variants, wd, lib_variants
    row = dict(phase="kernel", kernel=kind, weight=name, M=M, K=K, N=N, g=g,
               mode=mode, scales=scales,
               rel_err_fp32_out=err32, rel_err_bf16_out=err16,
               max_abs_err=abs16, ok=ok, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, **extra, card=CARD)
    emit(row)
    if not ok:
        raise AssertionError(f"{kind} disagrees with its plain version: {row}")
    return row


def gemm_routes(xb, q, sb, g, mode, want, variants):
    """The GEMM's route at these operands and, where it is the wgmma route,
    both routes through `gemm_launch` in interleaved rounds (mma_sync,
    wgmma, wgmma, mma_sync: us a call), each held against the plain
    version first, and the wgmma kernel's geometry."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.utils.profiling import device_time

    route = qm.gemm_route(xb, q, sb, g, mode)
    out = dict(route=route, routes_ok=True)
    if route != "wgmma":
        return out
    M, (K, N) = xb.shape[0], q.shape
    launch = {r: (lambda x, q, s, r=r: qm.gemm_launch(x, q, s, g, r)) for r in qm.GEMM_ROUTES}
    errs = {r: rel_err(fn(xb, q, sb), want) for r, fn in launch.items()}
    us = {r: [] for r in qm.GEMM_ROUTES}
    for r in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        us[r].append(device_time(launch[r], variants=variants, device="cuda") * 1e6)
    sms = torch.cuda.get_device_properties(xb.device).multi_processor_count
    kps = qm.gemm_wgmma_plan(M, K, N, sms)
    out.update(interleaved_us=us, route_rel_err=errs, routes_ok=all(
        e <= BF16_ULP for e in errs.values()), wgmma_splits=-(-K // kps),
        wgmma_geometry=qm.wgmma_geometry(M, K, g, sb.dtype == torch.bfloat16, kps),
        mma_sync_splits=-(-K // qm.gemm_k_per_split(M, K, N, sms)))
    return out


def gemv_variants(dev, g=256):
    """The GEMV's layout and plan, measured: at each GEMV_SHAPES shape (bf16
    x and scales), CUDA-event times of the kernel with 4 and 8 column
    threads a warp at the plans for 2, 4 and 8 blocks per SM, each launch
    held against the plain version."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES):
        x, q, s = operands(dev, 1, K, N, g, SEED + 90 + i)
        xb, sb = x.to(torch.bfloat16), s.to(torch.bfloat16)
        want = qm.quant_gemv_ref(xb, q, sb, g)
        qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
        ct0 = qm.gemv_col_threads(K, N, g, sms)
        us, ok = {}, True
        for ct in (4, 8):
            for bps in (2, 4, 8):
                gps = qm.gemv_plan(K, N, g, sms, bps, ct)
                launch = lambda x, q, s: qm.gemv_launch(x, q, s, g, gps, ct)
                ok = ok and rel_err(launch(xb, q, sb), want) <= BF16_ULP
                us[f"{ct} column threads, {bps} blocks/SM (gps {gps})"] = device_time(
                    launch, variants=[(xb, qc, sb) for qc in qs], device="cuda") * 1e6
        row = dict(phase="kernel_variants", kernel="quant_gemv", weight=name, K=K,
                   N=N, g=g, plan_col_threads=ct0,
                   plan_gps=qm.gemv_plan(K, N, g, sms, col_threads=ct0), us=us, ok=ok,
                   card=CARD)
        emit(row)
        del qs
        if not ok:
            raise AssertionError(f"quant_gemv variant disagrees: {row}")


def phase_kernels(dev):
    gemv, gemm = [], []
    fit_rows = {}
    for i, (name, K, N, per_token) in enumerate(GEMV_SHAPES):
        row = check_kernel("quant_gemv", dev, 1, K, N, 256, "fast", SEED + i,
                           name)
        gemv.append((row, per_token))
    fit_rows["quant_gemv", 1] = [r for r, _ in gemv]
    check_kernel("quant_gemv", dev, 1, 4096, 4096, 64, "fast", SEED + 10)
    check_kernel("quant_gemv", dev, 1, 1024, 1000, 64, "fast", SEED + 11, "ragged N")
    gemv_variants(dev)
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4]):
        row = check_kernel("quant_gemm", dev, PREFILL_M, K, N, 256, "fast",
                           SEED + 20 + i, name)
        gemm.append((row, 32))
    fit_rows["quant_gemm", PREFILL_M] = [r for r, _ in gemm]
    # the engine's decode route: M = max_batch = 8 rows
    fit_rows["quant_gemm", ENGINE_SLOTS] = [
        check_kernel("quant_gemm", dev, ENGINE_SLOTS, K, N, 256, "fast", SEED + 60 + i, name)
        for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4])]
    for M in (2, 255):
        check_kernel("quant_gemm", dev, M, 4096, 12288, 256, "fast", SEED + 30 + M)
    # the wgmma route's larger M: one block covers every row of its columns
    for M in GEMM_LARGE_M:
        fit_rows["quant_gemm", M] = [
            check_kernel("quant_gemm", dev, M, K, N, 256, "fast", SEED + 70 + M + i, name)
            for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4])]
    for M in (2, 32, 255):
        check_kernel("quant_gemm", dev, M, 4096, 4096, 256, "exact", SEED + 40 + M)
    check_kernel("quant_gemm", dev, 1, 11008, 4096, 64, "fast", SEED + 50)
    wgmma_attributes_row()
    bits_row(dev)
    stream_fit_rows(fit_rows)
    return gemv, gemm


def bits_row(dev):
    """Two calls of each weight-stream kernel on the same inputs give the
    same bits: the GEMV at the five GEMV_SHAPES, the GEMM at BITS_GEMM_M
    rows of the four 7B projections (bf16 x and scales, g 256). The
    reduce_splits launches of the second calls, under torch.profiler, are
    data: the wgmma route sums a split tile in that second launch. Fails
    if any bits differ."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

    cases = [("quant_gemv", name, 1, K, N) for name, K, N, _ in GEMV_SHAPES]
    cases += [("quant_gemm", name, M, K, N) for M in BITS_GEMM_M
              for name, K, N, _ in GEMV_SHAPES[:4]]
    equal, sums = {}, []
    for i, (kind, name, M, K, N) in enumerate(cases):
        x, q, s = operands(dev, M, K, N, 256, SEED + 200 + i)
        xb, sb = x.to(torch.bfloat16), s.to(torch.bfloat16)
        fn = getattr(qm, kind)
        first = fn(xb, q, sb, 256)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = fn(xb, q, sb, 256)
            torch.cuda.synchronize()
        equal[f"{kind} {name} M {M}"] = bool(torch.equal(first, again))
        sums += [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "reduce_splits" in e.name]
    ok = all(equal.values())
    emit(dict(phase="kernel_bits", equal=equal, reduce_splits_launches=len(sums), ok=ok,
              card=CARD))
    if not ok:
        raise AssertionError(f"a weight-stream kernel's bits differ between two calls: "
                             f"{equal}")


def stream_fit_rows(fit_rows):
    """Per kernel and M, the least-squares line ms = a + weight bytes / BW
    over the kernel rows at the 7B shapes (tools/gemm_costs.py `fit_line`):
    the fixed cost a call pays apart from its stream, beside the library's
    line on its bf16 bytes."""
    from kuiperllama_tpu_torch.tools.gemm_costs import fit_line

    for (kind, M), rows in fit_rows.items():
        nbytes = [r["K"] * r["N"] for r in rows]
        a, bw, res = fit_line(nbytes, [r["ms"] * 1e3 for r in rows])
        la, lbw, lres = fit_line([2 * b for b in nbytes], [r["library_ms"] * 1e3 for r in rows])
        emit(dict(phase="stream_fit", kernel=kind, M=M, weights=[r["weight"] for r in rows],
                  intercept_us=a, slope_TBps=bw, residuals_us=res,
                  library_intercept_us=la, library_slope_TBps=lbw, library_residuals_us=lres,
                  card=CARD))


def wgmma_attributes_row():
    """The wgmma kernels' registers and local bytes (cudaFuncGetAttributes),
    one kernel for each wgmma N of 8 to 256: fails on any local memory (a
    spill)."""
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

    attrs = {rows: qm.wgmma_attributes(rows) for rows in range(8, 257, 8)}
    ok = all(a["local_bytes"] == 0 for a in attrs.values())
    emit(dict(phase="kernel_attributes", kernel="quant_gemm wgmma", by_rows=attrs,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError(f"the wgmma kernels use local memory: {attrs}")


def phase_fixture(dev):
    import torch

    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.generate import Generator

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = load_bin(os.path.join(HERE, FIXTURE))
    prompt = [1, 20, 33, 45, 60, 7, 90]
    # (route, dtype, fused_step, knob, expected step and chunk launches)
    for route, dtype, fused, knob_on, expect in (
            ("layered", torch.float32, False, None, (0, 0)),
            ("fused", torch.bfloat16, True, None, (23, 0)),
            ("chunk", torch.bfloat16, True, "KT_FUSED_CHUNK", (0, 1))):
        ids = {}
        step0, chunk0 = fd.fused_decode_step.launches, fd.fused_decode_chunk.launches
        with knob(knob_on):
            for where in ("cpu", dev):
                gen = Generator(cfg, fuse_params(to_device(params, device=where,
                                                           dtype=dtype)),
                                cache_len=128, cache_dtype=dtype, fused_step=fused)
                ids[str(where)] = gen.generate_ids(prompt, max_new_tokens=24)[0]
        torch.cuda.synchronize()
        launches = (fd.fused_decode_step.launches - step0,
                    fd.fused_decode_chunk.launches - chunk0)
        ok = (ids["cpu"] == ids[str(dev)] and len(ids["cpu"]) == 24
              and launches == expect)
        emit(dict(phase="fixture", checkpoint=FIXTURE, route=route,
                  dtype=str(dtype).replace("torch.", ""), knob=knob_on,
                  tokens_gpu=ids[str(dev)], tokens_cpu=ids["cpu"],
                  fused_decode_launches=launches[0],
                  fused_decode_chunk_launches=launches[1], ok=ok, card=CARD))
        if not ok:
            raise AssertionError(f"tinychar greedy tokens ({route} route) "
                                 "differ between GPU and CPU")


def timed_generate(gen, prompt, dev, new=128):
    """A warm-up of 8 tokens (it opens the timed run's 256-slot window, so a
    graph route captures its step there, not in the timed run) and one more
    prefill (the first decode step may grow a megakernel's scratch after the
    prefill's capture: this captures it again), then `new` greedy tokens
    with every launch count zeroed just before and read just after: (ids,
    prefill_s, decode_s, launches, peak memory bytes)."""
    import torch

    gen.generate_batch_ids([prompt], max_new_tokens=8)
    gen.generate_batch_ids([prompt], max_new_tokens=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=new)
    launches = read_launches()
    return rows[0], prefill_s, decode_s, launches, torch.cuda.max_memory_allocated(dev)


def graph_stats(cache):
    """A graph cache's counters and its pool's bytes; None on the eager
    route."""
    if cache is None:
        return None
    return dict(cache.stats(), pool_bytes=cache.pool_bytes())


def first_difference(a, b):
    """The first index where two token lists differ (a length counts), or
    None."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return i if i is not None or len(a) == len(b) else min(len(a), len(b))


def eager_route(gen, prompt, dev, expect):
    """The Generator's settings on the eager route (graphs=False), on the
    same weights, timed as `timed_generate` times the graph route: (ids,
    row fields)."""
    from kuiperllama_tpu_torch.serving.generate import Generator

    eager = Generator(gen.cfg, gen.params, cache_len=gen.cache_len,
                      cache_dtype=gen.cache_dtype, chunk=gen.chunk,
                      fused_step=gen.fused_step, graphs=False)
    ids, _, decode_s, launches, _ = timed_generate(eager, prompt, dev)
    ms = decode_s / (len(ids) - 1) * 1e3
    return ids, dict(eager_decode_ms_per_token=ms,
                     eager_decode_tokens_per_s=1e3 / ms,
                     eager_launches=launches, eager_launches_ok=launches == expect)


def graph_route_ok(gen, graphs, decode_steps):
    """The graph route was taken and captured its step once, in the
    warm-up: the warm-up's first step eager, every other step a replay."""
    return (gen.graphs_on() and graphs["n_captures"] == 1
            and graphs["n_recaptures"] == 0
            and graphs["n_replays"] == 7 - 1 + decode_steps)


def prefill_route(gen, prompt, graphs):
    """`prompt`'s prefill (max_new_tokens=1) on a new Generator with `gen`'s
    weights and settings, on the graph route (graphs None: the card's
    default) or the eager one: the key's first call (on the graph route its
    eager run and capture), the median of PREFILL_WARM warm calls with the
    launches of the last, and the device busy time of one more call under
    torch.profiler. Returns (fields, first token, last logits, whether it
    took graphs)."""
    import statistics

    from kuiperllama_tpu_torch.serving.generate import Generator

    g = Generator(gen.cfg, gen.params, cache_len=gen.cache_len,
                  cache_dtype=gen.cache_dtype, chunk=gen.chunk,
                  fused_step=gen.fused_step, graphs=graphs)
    run = lambda: g.generate_batch_ids([prompt], max_new_tokens=1)
    ms = []
    for _ in range(1 + PREFILL_WARM):
        zero_launches()
        rows, prefill_s, _ = run()
        ms.append(prefill_s * 1e3)
    launches = read_launches()
    wgmma = on_wgmma(launches)
    logits = g.prefill_logits[1].clone()
    by_name, wall_ms = device_profile(run)
    busy = sum(t for t, _ in by_name.values())
    warm = statistics.median(ms[1:])
    fields = dict(first_call_ms=ms[0], warm_median_ms=warm, warm_ms=ms[1:],
                  device_busy_ms=busy if by_name else "not measured",
                  device_idle_share=1 - busy / warm if by_name else "not measured",
                  kernels_profiled=sum(n for _, n in by_name.values()),
                  wall_ms_profiled=wall_ms, top_kernels=top_kernels(by_name, 1),
                  launches=launches, gemm_on_wgmma=wgmma,
                  graphs=graph_stats(g.graph_cache) if g.graphs_on() else None)
    return fields, rows[0][0], logits, g.graphs_on()


def phase_prefill(label, gen):
    """A `prefill` row for each PREFILL_LENS prompt on `gen`'s path: the
    graph route beside the eager one on the same weights (prefill_route).
    Checks: the graph route taken, one capture and every later call a
    replay, first token and last logits bit for bit equal, exact launches on
    both (the GEMV of the B = 1 lm_head row and, below
    PREFILL_DEQUANT_ROWS rows, the GEMM of each INT8 projection)."""
    import torch

    from kuiperllama_tpu_torch.ops.linear import PREFILL_DEQUANT_ROWS
    from kuiperllama_tpu_torch.quant import QuantTensor
    from kuiperllama_tpu_torch.serving.generate import _bucket

    cfg = gen.cfg
    quant = isinstance(gen.params["lm_head"], QuantTensor)
    rows = []
    for n in PREFILL_LENS:
        prompt = [(5 + j) % (cfg.vocab_size - 1) + 1 for j in range(n)]
        T = _bucket(n)
        g, g_tok, g_logits, took = prefill_route(gen, prompt, None)
        e, e_tok, e_logits, _ = prefill_route(gen, prompt, False)
        gemm = 4 * cfg.n_layers if T < PREFILL_DEQUANT_ROWS else 0
        expect = (dict(NO_LAUNCHES, quant_gemv=1, quant_gemm=gemm) if quant
                  else dict(NO_LAUNCHES))
        st = g["graphs"] or {}
        logits_equal = bool(torch.equal(g_logits, e_logits))
        ok = (took and g_tok == e_tok and logits_equal
              and g["launches"] == expect and e["launches"] == expect
              and g["gemm_on_wgmma"] and e["gemm_on_wgmma"]
              and st.get("n_prefill_captures") == 1
              and st.get("n_prefill_recaptures") == 0
              and st.get("n_prefill_replays") == PREFILL_WARM + 1
              and bool(torch.isfinite(g_logits).all()))
        row = dict(phase="prefill", model=label, prompt_len=n, bucket=T,
                   route="graphs" if took else "eager", graph=g, eager=e,
                   first_token=g_tok, first_token_equal=g_tok == e_tok,
                   logits_bit_equal=logits_equal, launches_expected=expect,
                   warm_speedup=e["warm_median_ms"] / g["warm_median_ms"],
                   ok=ok, card=CARD)
        emit(row)
        if not ok:
            raise AssertionError(f"{label}: the {n}-token prefill's graph route "
                                 "differs from its eager route")
        rows.append(row)
    return rows


def idle_share(prof, ms_per_token):
    busy = prof["device_busy_ms_per_step"]
    return 1 - busy / ms_per_token if isinstance(busy, float) else "not measured"


def phase_main_path(dev):
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.params import param_bytes, random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg = preset_config("llama2-7b", seq_len=1024)
    t0 = time.perf_counter()
    params = random_params_device(cfg, device=dev, seed=SEED, quantize=True,
                                  group_size=256)
    params = cast_scales(fuse_params(params), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b["wqkv"], b["wo"], b["w13"], b["w2"], params["lm_head"]]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream)

    gen = Generator(cfg, params, cache_len=1024, cache_dtype=torch.bfloat16,
                    chunk=128)
    prompt = list(range(5, 5 + 32))
    ids, prefill_s, decode_s, launches, peak = timed_generate(gen, prompt, dev)
    graphs = graph_stats(gen.graph_cache)

    steps = len(ids) - 1
    ms_per_token = decode_s / steps * 1e3
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    expect = dict(NO_LAUNCHES, quant_gemv=1 + steps * (4 * cfg.n_layers + 1),
                  quant_gemm=4 * cfg.n_layers)
    eager_ids, eager = eager_route(gen, prompt, dev, expect)
    first_diff = first_difference(ids, eager_ids)

    cache = decoder.init_kv_cache(cfg, 1, 1024, torch.bfloat16, device=dev)
    logits, _ = decoder.prefill(cfg, params, torch.tensor([prompt], device=dev),
                                cache, rope=gen.rope)
    finite = bool(torch.isfinite(logits).all())
    in_vocab = all(0 <= t < cfg.vocab_size for t in ids)
    prof = profile_decode(cfg, params, gen, prompt, dev)
    prof_eager = profile_decode(cfg, params, gen, prompt, dev, graphs=False)
    phase_prefill("llama2-7b g256 layered", gen)
    ok = (len(ids) == 128 and finite and in_vocab
          and logits.shape == (1, cfg.vocab_size)
          and launches == expect and eager["eager_launches_ok"]
          and first_diff is None and graph_route_ok(gen, graphs, steps)
          and not gen._fused_ok(1))
    emit(dict(phase="main_path", model="llama2-7b", group_size=256,
              dtype="bf16", cache_len=1024, prompt_len=32, new_tokens=len(ids),
              route="layered, graphs", prefill_ms=prefill_s * 1e3,
              decode_steps=steps, decode_ms_per_token=ms_per_token,
              decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes,
              weight_bound_ms_per_token=bound_ms,
              share_of_weight_bound=bound_ms / ms_per_token, **eager,
              first_token_differing=first_diff, graphs=graphs,
              launches_per_step_profiled=prof["kernels_per_step"],
              device_busy_ms_per_step=prof["device_busy_ms_per_step"],
              device_idle_share_unprofiled=idle_share(prof, ms_per_token),
              eager_launches_per_step_profiled=prof_eager["kernels_per_step"],
              eager_device_busy_ms_per_step=prof_eager["device_busy_ms_per_step"],
              eager_device_idle_share_unprofiled=idle_share(
                  prof_eager, eager["eager_decode_ms_per_token"]),
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, logits_finite=finite, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("Llama-2-7B main path failed its checks")
    return launches


def profile_decode(cfg, params, gen, prompt, dev, steps=16, fused=False,
                   model="llama2-7b", graphs=None):
    """Where a decode step's time goes: `steps` greedy steps of the main
    path under torch.profiler, summed by kernel name, on the Generator's
    route (graphs None) or the one asked for. Emits the card's busy time
    per step against the step's wall time (the idle share is host time the
    card waits through) and the kernels that take the most. On the graph
    route a first chunk captures the step and the profiled one replays it."""
    import torch

    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.sampling import DecodeState
    from kuiperllama_tpu_torch.serving.generate import _stop_array, decode_chunk
    from kuiperllama_tpu_torch.serving.graphs import GraphCache

    graphs = gen.graphs_on() if graphs is None else graphs
    cache = decoder.init_kv_cache(cfg, 1, gen.cache_len, gen.cache_dtype,
                                  device=dev)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, cache = decoder.prefill(cfg, params, toks, cache, rope=gen.rope)
    state = DecodeState(logits.argmax(-1).to(torch.int32),
                        torch.tensor([len(prompt)], dtype=torch.int32, device=dev),
                        torch.zeros(1, dtype=torch.bool, device=dev),
                        _stop_array((), dev), steps)
    step_graphs = GraphCache(dev) if graphs else None
    run = lambda: decode_chunk(cfg, params, state, cache, None, steps,
                               active_len=256, rope=gen.rope, fused=fused,
                               drop_past_end=False, graphs=step_graphs)
    run()
    torch.cuda.synchronize()
    zero_launches()
    with chunk_kernel_events() as spans:
        by_name, wall_ms = device_profile(run)
    counted = read_launches()
    # The profiler loses launches of the megakernels (the ctypes-launched
    # cooperative kernels): some of the per-step kernels' and every chunk
    # kernel's. A per-step kernel's recorded mean stands for its lost
    # launches (the wrappers count them all); the chunk kernel's launches
    # are timed by CUDA events around its wrapper.
    recorded = {k: 0 for k in ("fused_decode", "fused_decode_big") if counted[k]}
    for key, kname in (("fused_decode", "fused_decode_kernel"),
                       ("fused_decode_big", "fused_big_kernel")):
        for name, (ms, n) in list(by_name.items()):
            if kname in name:
                recorded[key] = n
                by_name[name] = (ms / n * counted[key], counted[key])
    if spans:
        recorded["fused_decode_chunk"] = sum(
            n for name, (_, n) in by_name.items() if "fused_chunk_kernel" in name)
        by_name = {k: v for k, v in by_name.items() if "fused_chunk_kernel" not in k}
        by_name["fused_chunk_kernel (CUDA events)"] = (
            sum(a.elapsed_time(b) for a, b in spans), len(spans))
    busy_ms = sum(ms for ms, _ in by_name.values())
    route = ("chunk kernel" if spans else "fused" if fused else "layered") + (
        ", graphs" if graphs and not spans else ", eager")
    row = dict(phase="decode_profile", model=model, route=route,
               steps=steps, graph_replays=step_graphs.n_replays if graphs else None,
               megakernel_launches_counted_vs_profiled={
                   k: [counted[k], recorded[k]] for k in recorded},
               wall_ms_per_step_profiled=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps if by_name else "not measured",
               device_idle_share=1 - busy_ms / wall_ms if by_name else "not measured",
               kernels_per_step=sum(n for _, n in by_name.values()) / steps,
               top_kernels=top_kernels(by_name, steps), card=CARD)
    emit(row)
    return row


@contextlib.contextmanager
def chunk_kernel_events():
    """CUDA events recorded around every chunk-kernel launch that the
    Generator's decode_chunk makes inside the block: [(start, end)], read
    after a synchronize."""
    import torch

    from kuiperllama_tpu_torch.serving import generate

    real, spans = generate.fused_decode_chunk, []

    def timed(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = real(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    generate.fused_decode_chunk = timed
    try:
        yield spans
    finally:
        generate.fused_decode_chunk = real


def device_profile(run):
    """`run()` under `utils.profiling.trace` (torch.profiler; the Chrome
    trace goes to the temporary directory): ({kernel name: (device ms,
    launches)}, wall ms to the end of its device work)."""
    import torch

    from kuiperllama_tpu_torch.utils.profiling import trace

    with trace() as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name, wall_ms


def top_kernels(by_name, steps):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return [dict(name=k[:80], ms_per_step=ms / steps, launches_per_step=n / steps)
            for k, (ms, n) in top]


def fused_model(dev, preset, quantize, g, layers=None, seed=SEED, s_bf16=True):
    """Random fused params of a preset at full width (INT8 with bf16 scales,
    or fp32 ones when not s_bf16, or dense bf16), drawn on the card from a
    seed."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales

    over = dict(seq_len=CACHE_LEN)
    if layers:
        over["n_layers"] = layers
    cfg = preset_config(preset, **over)
    params = random_params_device(cfg, device=dev, seed=seed,
                                  quantize=quantize, group_size=g or 64)
    if quantize and s_bf16:
        params = cast_scales(params, torch.bfloat16)
    return cfg, fuse_params(params)


def _to_cpu(x):
    from kuiperllama_tpu_torch.quant import QuantTensor

    if isinstance(x, QuantTensor):
        return QuantTensor(x.q.cpu(), x.s.cpu(), x.group_size)
    return x.cpu()


def _clone_blocks(params):
    """A second copy of the per-layer weights, so that timed launches
    alternate between copies and do not find the weights in L2."""
    from kuiperllama_tpu_torch.quant import QuantTensor

    def c(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(x.q.clone(), x.s.clone(), x.group_size)
        return x.clone()

    return dict(params, blocks={k: c(v) for k, v in params["blocks"].items()})


def fused_step_bytes(cfg, params, pos, cache_itemsize):
    """Bytes one megakernel step must move: every layer's weights (int8 and
    scales, or bf16, plus bias and norms) read once, the K/V history of
    slots < pos read once, the new K/V rows written, x0 and x_out."""
    from kuiperllama_tpu_torch.params import param_bytes

    b = params["blocks"]
    names = ("wqkv", "wo", "w13", "w2", "bqkv", "attn_norm", "ffn_norm")
    weights = sum(param_bytes({"w": b[n]}) for n in names if n in b)
    weights += param_bytes({"w": params["final_norm"]})
    kv = cfg.n_layers * cfg.kv_dim * cache_itemsize
    return weights + 2 * kv * pos + 2 * kv + 2 * cfg.dim * 2


def fused_step_ops(cfg, params):
    """Multiply-adds of one step's projections, 2 operations each."""
    b = params["blocks"]
    return 2.0 * sum(b[n].shape[-3] * b[n].shape[-2] * b[n].shape[-1]
                     for n in ("wqkv", "wo", "w13", "w2"))


def fused_inputs(cfg, params, dev, pos=FUSED_POS, window=FUSED_WINDOW):
    """x0, a window view of bf16 caches with random history, pos, rope."""
    import torch

    from kuiperllama_tpu_torch.models import decoder

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    L, KV = cfg.n_layers, cfg.kv_dim
    full_k = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
    full_v = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    return x0, full_k, full_v, window, p, sin, cos


def _bf16_ulp(t):
    import torch

    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos, depth,
               kernel=None, plain=None, flags=None, held=("plain", "plain_cpu")):
    """A per-step megakernel (the small one unless `kernel`, `plain` and the
    GEMVs' activation types `flags` say otherwise) against its plain version
    on the same inputs, each run on its own copy of the caches: the plain
    version on the card and on the CPU (whose summation order the CPU tests
    tie to the JAX package's). Holds x_final and the new K/V rows of every
    layer within the depth's FUSED_TOL against the runs named in `held` (the
    others' errors are reported), and checks that no other slot changed.
    Returns (the errors and checks, the kernel's x_final on the card)."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    kernel = kernel or fd.fused_decode_step
    plain = plain or fd.fused_decode_step_ref
    pos, L, hd = int(p.item()), cfg.n_layers, cfg.head_dim
    cpu = torch.device("cpu")
    cpu_params = dict(blocks={k: _to_cpu(v) for k, v in params["blocks"].items()},
                      final_norm=params["final_norm"].cpu())
    runs = {}
    for name, fn, prm, where in (
            ("kernel", kernel, params, x0.device),
            ("plain", plain, params, x0.device),
            ("plain_cpu", plain, cpu_params, cpu)):
        kc, vc = full_k.to(where, copy=True), full_v.to(where, copy=True)
        x, _, _ = fn(cfg, prm, x0.to(where), kc[:, :A], vc[:, :A], p.to(where),
                     sin.to(where), cos.to(where))
        runs[name] = (x, kc.cpu(), vc.cpu())
    x_dev = runs["kernel"][0]
    xk, kk, vk = x_dev.cpu(), *runs["kernel"][1:]
    k_in, v_in = full_k.cpu(), full_v.cpu()
    untouched = all(torch.equal(a[:, :pos], b[:, :pos])
                    and torch.equal(a[:, pos + 1:], b[:, pos + 1:])
                    for a, b in ((kk, k_in), (vk, v_in)))

    def errors(got, want):  # x_final, and the new rows of the worst layer
        (x, k, v), (xr, kr, vr) = got, want
        return (rel_err(x.cpu(), xr.cpu()),
                max(rel_err(a[li, pos], b[li, pos])
                    for a, b in ((k, kr), (v, vr)) for li in range(L)))

    errs = {ref: errors(runs["kernel"], runs[ref]) for ref in ("plain", "plain_cpu")}
    # not held: the spread of one plain version between two summation orders
    spread = errors(runs["plain"], runs["plain_cpu"])
    xr, kr, vr = runs[held[0]]
    k0, k0r = kk[0, pos].float(), kr[0, pos].float()
    head_mag = k0r.abs().reshape(-1, hd).amax(-1, keepdim=True)
    k_ulp_ok = bool(((k0 - k0r).abs().reshape(-1, hd) <= _bf16_ulp(head_mag)).all())
    v_ulp_ok = bool(((vk[0, pos].float() - vr[0, pos].float()).abs()
                     <= _bf16_ulp(vr[0, pos])).all())
    if flags is None:
        flags = fd.gemv_int8_flags(params["blocks"],
                                   fd.plan_tiles(params["blocks"], full_k.dtype, A))
    # with int8 activations even layer 0's input differs in the last bit
    # (torch's rmsnorm mean sums in another order) and a flipped int8
    # rounding moves the row by more than an ulp: no one-ulp check there
    ulp_checked = not any(flags)
    tol = FUSED_TOL[(depth, any(flags))]
    ok = (all(e <= tol for ref in held for e in errs[ref])
          and (k_ulp_ok and v_ulp_ok or not ulp_checked)
          and untouched and bool(torch.isfinite(xk.float()).all()))
    check = dict(int8_activation=list(flags), tol=tol, held_against=list(held),
                 rel_err_x=errs["plain"][0], rel_err_x_vs_plain_on_cpu=errs["plain_cpu"][0],
                 rel_err_new_rows=errs["plain"][1],
                 rel_err_new_rows_vs_plain_on_cpu=errs["plain_cpu"][1],
                 plain_card_vs_cpu_rel_err_x=spread[0],
                 plain_card_vs_cpu_rel_err_new_rows=spread[1],
                 max_abs_err=(xk.float() - xr.cpu().float()).abs().max().item(),
                 layer0_rows_within_one_ulp=k_ulp_ok and v_ulp_ok,
                 layer0_ulp_check_applies=ulp_checked, other_slots_untouched=untouched,
                 ok=ok)
    return check, x_dev


def phase_fused_kernel(dev):
    """The megakernel against its plain version on the card, at full width
    and FUSED_LAYERS layers of each geometry; times beside the layered
    eager step on the same weights and the byte bound."""
    import torch

    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.linear import linear
    from kuiperllama_tpu_torch.utils.profiling import device_time

    rows = []
    for i, (label, preset, quantize, g) in enumerate(FUSED_CASES):
        cfg, params = fused_model(dev, preset, quantize, g, FUSED_LAYERS,
                                  seed=SEED + 60 + i)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        pos, hd = FUSED_POS, cfg.head_dim
        check, xk = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                               "2 layers")

        variants = [(params,), (_clone_blocks(params),)]
        kc, vc = full_k[:, :A], full_v[:, :A]
        ms = device_time(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                         variants=variants, device="cuda") * 1e3
        p_host = p.cpu()  # the plain version reads pos on the host
        plain_ms = device_time(lambda v: fd.fused_decode_step_ref(
            cfg, v, x0, kc, vc, p_host, sin, cos), variants=variants, iters=5,
            device="cuda") * 1e3
        cache = dict(k=full_k[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd),
                     v=full_v[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd))
        tok = torch.tensor([5], dtype=torch.int32, device=dev)
        layered_ms = device_time(lambda v: decoder.decode_step(
            cfg, v, tok, p, cache, rope=(sin, cos)), variants=variants, iters=10,
            device="cuda") * 1e3
        xf = xk.to(torch.bfloat16)
        lm_head_ms = device_time(lambda w: linear(xf, w), params["lm_head"], iters=10,
                                 device="cuda") * 1e3
        nbytes = fused_step_bytes(cfg, params, pos, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
        row = dict(phase="kernel", kernel="fused_decode", model=label,
                   layers=FUSED_LAYERS, group_size=g, quant="int8" if quantize else "bf16",
                   pos=pos, window=A, **check,
                   ms=ms, plain_ms=plain_ms, layered_step_ms=layered_ms,
                   layered_lm_head_ms=lm_head_ms, library_ms=None,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                   plan=fd.fused_decode_step.plan, card=CARD)
        emit(row)
        rows.append(row)
        del params, variants, cache, full_k, full_v
        if not check["ok"]:
            raise AssertionError(f"fused_decode disagrees with its plain version: {row}")
    return rows


def phase_fused_main_path(dev, label, preset, quantize):
    """One model of the megakernel route at full width and depth through
    Generator.generate_batch_ids (auto route), as the Llama-2-7B main path;
    then the kernel alone on the main path's shapes for the kernels line."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.serving.generate import Generator
    from kuiperllama_tpu_torch.utils.profiling import device_time

    t0 = time.perf_counter()
    cfg, params = fused_model(dev, preset, quantize, 256)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b[n] for n in ("wqkv", "wo", "w13", "w2", "bqkv") if n in b]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream + [params["lm_head"]])
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3

    gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                    chunk=128)
    prompt = list(range(5, 5 + 32))
    ids, prefill_s, decode_s, launches, peak = timed_generate(gen, prompt, dev)
    graphs = graph_stats(gen.graph_cache)

    steps = len(ids) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = dict(NO_LAUNCHES, fused_decode=steps,
                  quant_gemv=1 + steps if quantize else 0,
                  quant_gemm=4 * cfg.n_layers if quantize else 0)
    eager_ids, eager = eager_route(gen, prompt, dev, expect)
    first_diff = first_difference(ids, eager_ids)
    layered = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128, fused_step=False)
    rows_layered, _, layered_decode_s = layered.generate_batch_ids([prompt], 128)
    first_diff_layered = first_difference(ids, rows_layered[0])
    in_vocab = all(0 <= t < cfg.vocab_size for t in ids)
    ok = (len(ids) == 128 and in_vocab and gen._fused_ok(1)
          and launches == expect and eager["eager_launches_ok"]
          and first_diff is None and graph_route_ok(gen, graphs, steps))
    prof = profile_decode(cfg, params, gen, prompt, dev, fused=True, model=label)
    phase_prefill(f"{label} megakernel route", gen)
    main_row = dict(phase="main_path", model=label, quant="int8" if quantize else "bf16",
                    group_size=256 if quantize else None, dtype="bf16", cache_len=CACHE_LEN,
                    prompt_len=32, new_tokens=len(ids), route="fused (auto), graphs",
                    prefill_ms=prefill_s * 1e3, decode_steps=steps,
                    decode_ms_per_token=ms_per_token, decode_tokens_per_s=steps / decode_s,
                    weight_bytes_per_token=weight_bytes, floor_ms_per_token=floor_ms,
                    share_of_floor=floor_ms / ms_per_token, **eager,
                    first_token_differing=first_diff, graphs=graphs,
                    layered_graphs_decode_ms_per_token=layered_decode_s / (len(rows_layered[0]) - 1) * 1e3,
                    first_token_differing_from_layered=first_diff_layered,
                    launches_per_step_profiled=prof["kernels_per_step"],
                    device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                    device_idle_share_unprofiled=idle_share(prof, ms_per_token),
                    peak_memory_bytes=peak, init_s=init_s, launches=launches,
                    launches_expected=expect, ok=ok, card=CARD)
    emit(main_row)
    if not ok:
        raise AssertionError(f"{label} main path failed its checks")

    # the kernel alone at the main path's shapes (full depth, pos 100 of a
    # 256-slot window, one step): held against its plain version, timed,
    # and one launch traced for the time of each phase per layer
    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                          "full depth")
    kc, vc = full_k[:, :A], full_v[:, :A]
    ms = device_time(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                     params, device="cuda") * 1e3
    p_host = p.cpu()
    plain_ms = device_time(lambda v: fd.fused_decode_step_ref(cfg, v, x0, kc, vc, p_host,
                                                              sin, cos),
                           params, iters=3, device="cuda") * 1e3
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
    fd.fused_decode_step(cfg, params, x0, kc, vc, p, sin, cos, trace=trace)
    phases = fd.phase_times(trace, L)
    us_per_layer = {k: phases[k] / L for k in fd.PHASES}
    check["ok"] = check["ok"] and all(t > 0 for t in us_per_layer.values())
    nbytes = fused_step_bytes(cfg, params, FUSED_POS, 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
    step = dict(phase="fused_step", model=label, layers=L, pos=FUSED_POS,
                window=A, **check, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms,
                traced_phase_us_per_layer=us_per_layer,
                traced_final_norm_us=phases["final"], traced_total_us=phases["total"],
                plan=fd.fused_decode_step.plan, card=CARD)
    emit(step)
    if not step["ok"]:
        raise AssertionError(f"fused_decode disagrees with its plain version "
                             f"at full depth ({label})")
    return launches, step, main_row


def paged_inputs(dev, H, KH, hd, dtype, seed, layers):
    """q [B, H, hd] and stacked pools [layers, P, ps, KH*hd] drawn on the
    card, a shuffled page table and its work list for PAGED_LENS."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, ps = len(PAGED_LENS), PAGED_PS
    max_pages = -(-max(PAGED_LENS) // ps)
    P = B * max_pages + 1
    kp = torch.randn((layers, P, ps, KH * hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((layers, P, ps, KH * hd), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm.reshape(B, max_pages).to(torch.int32).cpu().numpy()
    sl = np.asarray(PAGED_LENS, np.int32)
    work = [torch.from_numpy(a).to(dev) for a in pa.build_work_list(pt, sl, ps)]
    return q, kp, vp, work, torch.from_numpy(sl).to(dev), pt


def hold_paged(q, kp, vp, work, sl, layer):
    """The kernel against its plain version on the card, both reading
    `layer`: errors of the normalised output, m and l relative to
    max|plain|, and the output's max-abs error."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    args = (q, kp, vp, *work, sl)
    acc, m, l = pa.paged_attention_flat(*args, page_size=PAGED_PS, layer_idx=layer)
    ra, rm, rl = pa.paged_attention_flat_ref(*args, page_size=PAGED_PS,
                                             layer_idx=layer)
    out, ref = acc / l[..., None], ra / rl[..., None]
    return dict(rel_err_out=rel_err(out, ref), rel_err_m=rel_err(m, rm),
                rel_err_l=rel_err(l, rl),
                max_abs_err=(out - ref).abs().max().item(),
                finite=bool(out.isfinite().all()))


def phase_paged_kernel(dev):
    """The paged flash-decode kernel against its plain version on the card
    at four geometries with bf16 pools and one with fp32 pools, errors at
    PAGED_SEEDS seeds; CUDA-event times of the kernel, the plain version and
    scaled_dot_product_attention on K/V gathered ahead into a dense
    [B, H, S, hd] with a length mask (a yardstick the port never calls),
    beside the least time: the valid tokens' K and V bytes read once."""
    import torch
    import torch.nn.functional as F

    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    cases = [(c, torch.bfloat16) for c in PAGED_CASES]
    cases.append((PAGED_CASES[2], torch.float32))
    rows = {}
    B, ps, tokens = len(PAGED_LENS), PAGED_PS, sum(PAGED_LENS)
    for i, ((label, H, KH, hd), dtype) in enumerate(cases):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        size = dtype.itemsize
        kv_bytes = 2 * tokens * KH * hd * size
        # enough stacked layers that timed launches rotate through more K/V
        # than L2 holds; correctness reads layer 1
        layers = 1 + l2_copies(kv_bytes, dev)
        readings = []
        for seed in range(PAGED_SEEDS):  # seed 0's inputs are the timed ones
            inputs = paged_inputs(dev, H, KH, hd, dtype, SEED + 70 + 10 * i + seed,
                                  2 if seed else layers)
            readings.append(hold_paged(*inputs[:5], 1))
            if not seed:
                q, kp, vp, work, sl, pt = inputs
            del inputs
        ms = device_time(lambda li: pa.paged_attention_flat(
            q, kp, vp, *work, sl, page_size=ps, layer_idx=li),
            variants=[(li,) for li in range(1, layers)], device="cuda") * 1e3
        plain_ms = device_time(lambda: pa.paged_attention_flat_ref(
            q, kp, vp, *work, sl, page_size=ps, layer_idx=1), iters=5,
            device="cuda") * 1e3
        # the library yardstick: K/V gathered into [B, H, S, hd] beforehand
        S = pt.shape[1] * ps
        idx = torch.from_numpy(pt).long().to(dev)
        dense = [p[1][idx].reshape(B, S, KH, hd).transpose(1, 2)
                 .repeat_interleave(H // KH, dim=1).contiguous() for p in (kp, vp)]
        mask = (torch.arange(S, device=dev)[None] < sl[:, None])[:, None, None]
        q4 = q[:, :, None]
        variants = [dense] + [[d.clone() for d in dense]
                              for _ in range(l2_copies(2 * dense[0].nbytes, dev) - 1)]
        library_ms = device_time(lambda k, v: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask), variants=variants, device="cuda") * 1e3
        nbytes = kv_bytes + q.nbytes + B * H * (hd + 2) * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4.0 * H * hd * tokens / PEAK_OPS_PER_S[dname] * 1e3
        worst = {k: max(r[k] for r in readings)
                 for k in ("rel_err_out", "rel_err_m", "rel_err_l", "max_abs_err")}
        tol = PAGED_TOL[dname]
        ok = (worst["rel_err_out"] <= tol and worst["rel_err_m"] <= PAGED_M_TOL
              and all(r["finite"] for r in readings))
        row = dict(phase="kernel", kernel="paged_attention", model=label,
                   pool_dtype=dname, B=B, seq_lens=PAGED_LENS, page_size=ps, H=H,
                   KH=KH, hd=hd, kv_mul=H // KH, layer=1, seeds=PAGED_SEEDS, **worst,
                   rel_err_out_by_seed=[r["rel_err_out"] for r in readings],
                   rel_err_m_by_seed=[r["rel_err_m"] for r in readings],
                   tol=tol, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, kv_bytes=kv_bytes,
                   card=CARD)
        emit(row)
        rows[(label, dname)] = row
        del q, kp, vp, dense, variants
        if not ok:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version: {row}")
    return rows


def run_fixture_engines(where, cfg, params):
    """The tinychar requests through every FIXTURE_ENGINES engine on
    `where`, fp32 params and cache: {name: (token lists, engine)}."""
    import torch

    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving import engine as E

    placed = to_device(params, device=where, dtype=torch.float32)
    out = {}
    for name, cls, kw in FIXTURE_ENGINES:
        eng = getattr(E, cls)(cfg, placed, max_batch=4, max_len=cfg.seq_len,
                              chunk=8, cache_dtype=torch.float32, **kw)
        reqs = [E.Request(prompt_ids=list(p), max_new_tokens=FIXTURE_NEW)
                for p in FIXTURE_PROMPTS]
        eng.run(reqs)
        out[name] = ([r.out_ids for r in reqs], eng)
    return out


def phase_engine_fixture(dev):
    """Engine, PagedEngine on 8-token pages with a pool small enough to
    preempt, and chunked PagedEngine over the tinychar fixture: greedy
    tokens equal on the card and on the CPU, and equal across the engines;
    paged_attention launched n_layers times per decode step on the card."""
    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    cfg, params = load_bin(os.path.join(HERE, FIXTURE))
    cpu = run_fixture_engines("cpu", cfg, params)
    pa.paged_attention_flat.launches = 0
    card = run_fixture_engines(dev, cfg, params)
    launches = pa.paged_attention_flat.launches
    steps = sum(eng.n_decode_steps for name, (_, eng) in card.items()
                if name != "dense")
    tokens = {name: toks for name, (toks, _) in card.items()}
    same = all(card[n][0] == cpu[n][0] for n in card)
    across = all(t == tokens["dense"] for t in tokens.values())
    preempted = (card["paged"][1].n_preemptions, cpu["paged"][1].n_preemptions)
    full = all(len(t) == FIXTURE_NEW for t in tokens["dense"])
    ok = (same and across and full and preempted[0] > 0 and preempted[0] == preempted[1]
          and launches == cfg.n_layers * steps)
    emit(dict(phase="engine_fixture", checkpoint=FIXTURE, dtype="fp32",
              requests=len(FIXTURE_PROMPTS), new_tokens=FIXTURE_NEW,
              engines=[n for n, _, _ in FIXTURE_ENGINES],
              tokens_equal_card_cpu=same, tokens_equal_across_engines=across,
              preemptions_card_cpu=list(preempted), paged_decode_steps=steps,
              paged_attention_launches=launches,
              paged_attention_launches_expected=cfg.n_layers * steps,
              tokens_gpu=tokens["paged"], ok=ok, card=CARD))
    if not ok:
        raise AssertionError("tinychar engines differ between card and CPU, "
                             "between engines, or in launch counts")
    return cfg, params, dict(zip(map(tuple, FIXTURE_PROMPTS), cpu["paged"][0]))


def profile_engine_chunk(eng, model, requests):
    """One decode chunk of PROFILE_STEPS steps with every slot active:
    its wall time unprofiled, then under torch.profiler (launches per step,
    device busy and idle share)."""
    import torch

    eng.chunk = PROFILE_STEPS
    for r in requests:
        eng.submit(r)
    eng.step()  # admission and a first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_name, wall_ms = device_profile(eng.step)
    eng.run([])
    busy_ms = sum(ms for ms, _ in by_name.values())
    row = dict(phase="engine_profile", model=model,
               route="graphs" if eng.graph_cache is not None else "eager",
               slots=eng.max_batch,
               steps=PROFILE_STEPS, decode_ms_per_step_unprofiled=step_ms,
               wall_ms_per_step_profiled=wall_ms / PROFILE_STEPS,
               device_busy_ms_per_step=(busy_ms / PROFILE_STEPS if by_name
                                        else "not measured"),
               device_idle_share_unprofiled=(1 - busy_ms / PROFILE_STEPS / step_ms
                                             if by_name else "not measured"),
               launches_per_step=sum(n for _, n in by_name.values()) / PROFILE_STEPS,
               top_kernels=top_kernels(by_name, PROFILE_STEPS),
               # device kernels, not wrapper calls: read_launches counts calls
               device_kernels_per_call={
                   "paged_attention": "2 (per-page statistics, then the row merge)",
                   "quant_gemm": "2 when K is split (the splits, then their "
                                 "ordered sum), else 1"},
               card=CARD)
    emit(row)
    return row


def phase_engine_main_path(dev, label, preset, prefill_chunk=0, long_prompt=0,
                           profile_eager=False):
    """PagedEngine at full width and depth (INT8 g 256, bf16 scales,
    activations and pools, random weights from a seed): ENGINE_REQUESTS
    requests of ENGINE_PROMPT tokens (every 4th of `long_prompt` tokens when
    it is set) and ENGINE_NEW new tokens, all submitted at t0, on the graph
    route (the card's default), then on the eager route (graphs=False) on
    the same weights: the same tokens. Exact launch counts on both:
    paged_attention n_layers per decode step; the GEMM 4 n_layers + 1 per
    decode step (M = 8) and one lm_head per prefill forward (>= 256 rows
    take the dequantize-then-matmul route). A profile of one decode chunk on
    the graph route (and on the eager one with `profile_eager`)."""
    import torch

    from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request

    cfg, params = fused_model(dev, preset, True, 256)
    vocab, L = cfg.vocab_size, cfg.n_layers

    def prompt(i, n):
        return [(7 * i + j) % (vocab - 1) + 1 for j in range(n)]

    def profile_requests():
        return [Request(prompt_ids=prompt(100 + i, ENGINE_PROMPT),
                        max_new_tokens=3 * PROFILE_STEPS + 8)
                for i in range(ENGINE_SLOTS)]

    def run(graphs):
        eng = PagedEngine(cfg, params, max_batch=ENGINE_SLOTS, max_len=CACHE_LEN,
                          chunk=ENGINE_CHUNK, page_size=ENGINE_PS,
                          cache_dtype=torch.bfloat16, prefill_chunk=prefill_chunk,
                          graphs=graphs)
        # the warm-up opens the decode key and every prefill key of the
        # timed run: the packed stream of ENGINE_SLOTS short prompts (a
        # whole admission's bucket), then the chunked wave's n_hist buckets
        # with a long prompt
        for n, k in ((ENGINE_PROMPT, ENGINE_SLOTS), (long_prompt, 2)):
            if n:
                eng.run([Request(prompt_ids=prompt(i, n), max_new_tokens=4)
                         for i in range(k)])
        torch.cuda.synchronize()
        warm = graph_stats(eng.graph_cache)
        reqs = [Request(prompt_ids=prompt(i, long_prompt if long_prompt and i % 4 == 3
                                          else ENGINE_PROMPT),
                        max_new_tokens=ENGINE_NEW) for i in range(ENGINE_REQUESTS)]
        eng.n_decode_steps = eng.n_prefill_calls = 0
        eng.prefill_wall_s = 0.0
        zero_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run([])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        wgmma = on_wgmma(launches)
        steps, prefills = eng.n_decode_steps, eng.n_prefill_calls
        expect = dict(NO_LAUNCHES, paged_attention=L * steps,
                      quant_gemm=steps * (4 * L + 1) + prefills)
        generated = sum(len(r.out_ids) for r in reqs)
        ttft = sorted(r.ttft_s for r in reqs)
        out = dict(eng=eng, reqs=reqs, wall_s=wall_s, launches=launches,
                   gemm_on_wgmma=wgmma, ttft=ttft, warm_graphs=warm,
                   expect=expect, peak=torch.cuda.max_memory_allocated(dev),
                   steps=steps, prefills=prefills, preemptions=eng.n_preemptions,
                   prefill_wall_s=eng.prefill_wall_s,
                   graphs=graph_stats(eng.graph_cache),
                   ok=(len(done) == ENGINE_REQUESTS and launches == expect and wgmma
                       and generated == ENGINE_REQUESTS * ENGINE_NEW))
        return out

    g = run(None)
    eng, reqs = g["eng"], g["reqs"]
    pool_bytes = eng.k_pages.nbytes + eng.v_pages.nbytes
    prof = profile_engine_chunk(eng, label, profile_requests())
    del eng, g["eng"]
    e = run(False)
    prof_eager = (profile_engine_chunk(e["eng"], label, profile_requests())
                  if profile_eager else None)
    del e["eng"]
    diff = next(((i, first_difference(a.out_ids, b.out_ids))
                 for i, (a, b) in enumerate(zip(reqs, e["reqs"]))
                 if a.out_ids != b.out_ids), None)
    generated = sum(len(r.out_ids) for r in reqs)
    steps = g["steps"]
    ttft, e_ttft = g["ttft"], e["ttft"]
    pct = lambda v, p: v[min(len(v) - 1, int(len(v) * p / 100))]
    in_vocab = all(0 <= t < vocab for r in reqs for t in r.out_ids)
    # the key opened in the warm-up: (B, max_pages) is fixed, so one
    # capture serves every chunk length and admission; every prefill of
    # the timed run replays a graph the warm-up captured
    gr = g["graphs"] or {}
    prefill_captures_timed = (gr.get("n_prefill_captures", 0)
                              - g["warm_graphs"]["n_prefill_captures"])
    ok = (g["ok"] and e["ok"] and in_vocab and diff is None
          and g["graphs"] is not None and g["graphs"]["n_captures"] == 1
          and g["graphs"]["n_recaptures"] == 0
          and gr["n_prefill_replays"] >= 1 and gr["n_prefill_recaptures"] == 0)
    row = dict(phase="engine_main_path", model=label, quant="int8", group_size=256,
               dtype="bf16", slots=ENGINE_SLOTS, max_len=CACHE_LEN, chunk=ENGINE_CHUNK,
               page_size=ENGINE_PS, prefill_chunk=prefill_chunk,
               requests=ENGINE_REQUESTS, prompt_len=ENGINE_PROMPT,
               long_prompt_every_4th=long_prompt or None, new_tokens=ENGINE_NEW,
               route="graphs", generated_tokens=generated, wall_s=g["wall_s"],
               tokens_per_s=generated / g["wall_s"],
               eager_wall_s=e["wall_s"], eager_tokens_per_s=generated / e["wall_s"],
               first_token_differing=diff, graphs=g["graphs"],
               ttft_s_min=ttft[0], ttft_s_p50=pct(ttft, 50), ttft_s_p99=pct(ttft, 99),
               decode_steps=steps, prefill_calls=g["prefills"],
               single_shot_prefill_s=g["prefill_wall_s"],
               eager_single_shot_prefill_s=e["prefill_wall_s"],
               eager_ttft_s_min=e_ttft[0], eager_ttft_s_p50=pct(e_ttft, 50),
               eager_ttft_s_p99=pct(e_ttft, 99),
               prefill_captures_timed=prefill_captures_timed,
               wall_ms_per_decode_step=(g["wall_s"] - g["prefill_wall_s"]) / steps * 1e3,
               eager_wall_ms_per_decode_step=(e["wall_s"] - e["prefill_wall_s"]) / e["steps"] * 1e3,
               profile=dict(decode_ms_per_step=prof["decode_ms_per_step_unprofiled"],
                            launches_per_step=prof["launches_per_step"],
                            device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                            device_idle_share=prof["device_idle_share_unprofiled"]),
               eager_profile=None if prof_eager is None else dict(
                   decode_ms_per_step=prof_eager["decode_ms_per_step_unprofiled"],
                   launches_per_step=prof_eager["launches_per_step"],
                   device_busy_ms_per_step=prof_eager["device_busy_ms_per_step"],
                   device_idle_share=prof_eager["device_idle_share_unprofiled"]),
               preemptions=g["preemptions"],
               peak_memory_bytes=g["peak"], pool_bytes=pool_bytes,
               launches=g["launches"], launches_expected=g["expect"],
               eager_launches=e["launches"], ok=ok, card=CARD)
    emit(row)
    if not ok:
        raise AssertionError(f"{label} engine main path failed its checks")
    del params
    return g["launches"], row, prof


def phase_packed_prefill(dev):
    """Phase 10b: the packed admission prefill against the padded one on
    the same prompts and weights at the 7B serve shapes: last logits and
    written slots within PACKED_TOL, the same greedy first tokens; then
    each prefill's time (CUDA events, eager, median of PACKED_TIMES calls
    after one) and peak memory. One row a mix."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.config import ModelConfig
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder, paged
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales
    from kuiperllama_tpu_torch.serving.generate import _bucket

    cfg = ModelConfig.from_header(seq_len=SERVE_MAX_LEN, **QWEN7B)
    params = fuse_params(cast_scales(random_params_device(
        cfg, device=dev, seed=SEED, quantize=True, group_size=256), torch.bfloat16))
    rope = decoder.build_rope(cfg, dev)
    R, ps = SERVE_SLOTS, SERVE_PS
    rows = []
    for name, lens in PACKED_MIXES.items():
        rng = np.random.default_rng(len(lens))
        prompts = [rng.integers(1, cfg.vocab_size, m).astype(np.int32) for m in lens]
        need = [-(-m // ps) for m in lens]
        P = 1 + sum(need)
        pt = np.zeros((len(lens), SERVE_MAX_LEN // ps), np.int32)
        first_page = 1
        for b, k in enumerate(need):
            pt[b, :k] = np.arange(first_page, first_page + k)
            first_page += k
        N = sum(lens)
        n, T = _bucket(N), _bucket(max(lens))
        # the packed stream, and the padded grid as PagedEngine._prefill_batch
        # builds it (rows past the prompts: length 1, every page the sentinel)
        packed = [torch.from_numpy(a).to(dev)
                  for a in paged.pack_prompts(prompts, pt, n, R, ps)]
        grid = np.zeros((R, T), np.int32)
        grid_lens = np.ones((R,), np.int32)
        grid_pages = np.full((R, T), 2 ** 30, np.int32)
        for b, (p, m) in enumerate(zip(prompts, lens)):
            grid[b, :m], grid_lens[b] = p, m
            grid_pages[b, :m] = pt[b, np.arange(m) // ps]
        padded = [torch.from_numpy(a).to(dev) for a in (grid, grid_lens, grid_pages)]
        shape = (cfg.n_layers, P, ps, cfg.kv_dim)
        pools = {k: [torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                     for _ in range(2)] for k in ("packed", "padded")}

        def run_packed():
            return paged.prefill_packed_paged(cfg, params, *packed, *pools["packed"],
                                              SERVE_MAX_LEN, rope=rope)[0]

        def run_padded():
            return paged.prefill_paged(cfg, params, padded[0], padded[1],
                                       *pools["padded"], padded[2], rope=rope)[0]

        out = {}
        for label, fn in (("packed", run_packed), ("padded", run_padded)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            logits = fn()[:len(lens)].float()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            times = []
            for _ in range(PACKED_TIMES):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            out[label] = dict(logits=logits, ms=float(np.median(times)), peak=peak)
        want = out["padded"]["logits"]
        logit_err = float((out["packed"]["logits"] - want).abs().max()
                          / want.abs().max())
        written = torch.zeros((P, ps), dtype=torch.bool, device=dev)
        for b, m in enumerate(lens):
            pos = np.arange(m)
            written[torch.from_numpy(pt[b, pos // ps]).long(),
                    torch.from_numpy(pos % ps).long()] = True
        pool_err = max(float((g[:, written].float() - w[:, written].float()).abs().max()
                             / w[:, written].float().abs().max())
                       for g, w in zip(pools["packed"], pools["padded"]))
        same_first = bool(torch.equal(out["packed"]["logits"].argmax(-1),
                                      want.argmax(-1)))
        ok = logit_err <= PACKED_TOL and pool_err <= PACKED_TOL and same_first
        row = dict(phase="packed_prefill", model="qwen2.5-7b", quant="int8",
                   group_size=256, dtype="bf16", mix=name, prompt_lens=lens,
                   tokens=N, packed_tokens=n, padded_grid=[R, T],
                   packed_route="gemm" if n < 256 else "dequantize + matmul",
                   logits_max_rel_err=logit_err, pool_max_rel_err=pool_err,
                   limit=PACKED_TOL, first_tokens_equal=same_first,
                   packed_ms=out["packed"]["ms"], padded_ms=out["padded"]["ms"],
                   speedup=out["padded"]["ms"] / out["packed"]["ms"],
                   packed_peak_bytes=out["packed"]["peak"],
                   padded_peak_bytes=out["padded"]["peak"], ok=ok, card=CARD)
        emit(row)
        rows.append(row)
        del pools, out
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"packed prefill {name} differs from the padded one")
    del params
    torch.cuda.empty_cache()
    return rows


def phase_recapture(dev):
    """Graphs whose workspace pointers went stale are captured again: a
    Qwen2.5-0.5B Generator (bf16, full width and depth, per-step megakernel
    on the graph route) decodes 128 tokens, a TinyLlama-1.1B Generator (2
    layers) decodes and grows the megakernels' workspace (its dim 2048 over
    Qwen's 896), and the Qwen Generator decodes again: its graph is dropped
    and captured once more (n_recaptures 1), its tokens unchanged and its
    launches exact. Run first, while the workspaces are Qwen's size."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import workspace
    from kuiperllama_tpu_torch.serving.generate import Generator

    prompt = list(range(5, 5 + 32))
    cfg, params = fused_model(dev, "qwen2.5-0.5b", False, 0)
    qwen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                     chunk=128)
    first = qwen.generate_ids(prompt, max_new_tokens=128)[0]
    before = dict(qwen.graph_cache.stats())
    epoch = workspace.epoch
    tcfg, tparams = fused_model(dev, "tinyllama-1.1b", True, 256, layers=2)
    tiny = Generator(tcfg, tparams, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                     chunk=128)
    tiny.generate_ids(prompt, max_new_tokens=16)
    grown = workspace.epoch - epoch
    del tiny, tparams
    zero_launches()
    again = qwen.generate_ids(prompt, max_new_tokens=128)[0]
    torch.cuda.synchronize()
    launches = read_launches()
    after = qwen.graph_cache.stats()
    ok = (qwen.graphs_on() and qwen._fused_ok(1) and grown > 0
          and before["n_captures"] == 1 and before["n_recaptures"] == 0
          and after["n_captures"] == 2 and after["n_recaptures"] == 1
          and after["n_prefill_recaptures"] >= 1
          and again == first and len(first) == 128
          and launches == dict(NO_LAUNCHES, fused_decode=127))
    emit(dict(phase="recapture", model="qwen2.5-0.5b", grown_by="tinyllama-1.1b (2 layers)",
              workspace_epoch_moves=grown, graphs_before=before, graphs_after=after,
              first_token_differing=first_difference(first, again),
              launches=launches, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the graphs were not captured again after the "
                             "workspace grew, or their tokens changed")


def phase_server(dev, cfg, params, want):
    """InferenceServer and its HTTP front end on 127.0.0.1 over a PagedEngine
    of the fixture on the card: concurrent /generate requests answer the CPU
    engine's tokens, /healthz and /metrics answer, an invalid request gets a
    400 and the next valid one is served; a request that times out is
    cancelled and its pages come back."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.engine import PagedEngine
    from kuiperllama_tpu_torch.serving.server import InferenceServer, make_http_server

    eng = PagedEngine(cfg, to_device(params, device=dev, dtype=torch.float32),
                      max_batch=4, max_len=cfg.seq_len, chunk=8,
                      cache_dtype=torch.float32, page_size=8)
    srv = InferenceServer(eng)
    srv.start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()

    def post(body):
        req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        results = [None] * len(FIXTURE_PROMPTS)

        def client(i):
            results[i] = post({"prompt_ids": FIXTURE_PROMPTS[i],
                               "max_new_tokens": FIXTURE_NEW})

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(FIXTURE_PROMPTS))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        answers_ok = all(r is not None and r[0] == 200
                         and r[1]["ids"] == want[tuple(p)]
                         for r, p in zip(results, FIXTURE_PROMPTS))
        health = get("/healthz")
        bad_code, bad = post({"prompt_ids": [], "max_new_tokens": 4})
        good_code, good = post({"prompt_ids": FIXTURE_PROMPTS[0],
                                "max_new_tokens": FIXTURE_NEW})
        metrics = get("/metrics")
        # a request that times out is cancelled: its slot and pages come back
        free0 = eng.allocator.n_free_pages
        try:
            srv.submit(prompt_ids=FIXTURE_PROMPTS[2], max_new_tokens=FIXTURE_NEW,
                       timeout_s=1e-3)
            timed_out = False
        except TimeoutError:
            timed_out = True
        end = time.perf_counter() + 60
        while (eng.has_work or eng.allocator.n_free_pages != free0) and \
                time.perf_counter() < end:
            time.sleep(0.01)
        freed = not eng.has_work and eng.allocator.n_free_pages == free0
        health_after = get("/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    ok = (answers_ok and health.get("ok") is True and bad_code == 400
          and good_code == 200 and good["ids"] == want[tuple(FIXTURE_PROMPTS[0])]
          and metrics.get("served") == len(FIXTURE_PROMPTS) + 1
          and timed_out and freed and health_after.get("ok") is True)
    emit(dict(phase="server", concurrent_requests=len(FIXTURE_PROMPTS),
              answers_equal_cpu_engine=answers_ok, healthz=health,
              invalid_request_status=bad_code, invalid_request_error=bad.get("error"),
              next_valid_status=good_code, metrics=metrics,
              timeout_raised=timed_out, timed_out_request_freed=freed,
              healthz_after_timeout=health_after, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the HTTP server failed its checks")


def layer_byte_us(params):
    """Microseconds at 3.35 TB/s for one layer's weights of each GEMV phase
    (int8 and scales, or bf16), beside the trace's time per phase."""
    from kuiperllama_tpu_torch.params import param_bytes

    b = params["blocks"]
    L = b["attn_norm"].shape[0]
    return {ph: param_bytes({"w": b[n]}) / L / HBM_BYTES_PER_S * 1e6
            for ph, n in (("qkv", "wqkv"), ("wo", "wo"), ("gate_up", "w13"),
                          ("w2", "w2"))}


def time_big_step(cfg, params, x0, kc, vc, p, sin, cos, variants, plain_n):
    """The big kernel's CUDA-event time over `variants` (one-tuples of
    params), its plain version's,
    the byte bound and one traced launch's us per phase per layer."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.utils.profiling import device_time

    ms = device_time(lambda v: fb.fused_decode_step_big(cfg, v, x0, kc, vc, p, sin, cos),
                     variants=variants, device="cuda") * 1e3
    p_host = p.cpu()  # the plain version reads pos on the host
    plain_ms = device_time(lambda v: fb.fused_decode_step_big_ref(
        cfg, v, x0, kc, vc, p_host, sin, cos), variants=variants[:1], iters=plain_n,
        device="cuda") * 1e3
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=x0.device)
    fb.fused_decode_step_big(cfg, params, x0, kc, vc, p, sin, cos, trace=trace)

    phases = fd.phase_times(trace, L)
    nbytes = fused_step_bytes(cfg, params, int(p.item()), 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms,
                traced_phase_us_per_layer={k: phases[k] / L for k in fd.PHASES},
                phase_byte_us_per_layer=layer_byte_us(params),
                traced_total_us=phases["total"])


def phase_fused_big_kernel(dev):
    """The big-model megakernel against its plain version on the card, at
    full width and FUSED_LAYERS layers of each BIG_CASES geometry, one step
    at pos 100 in a 256-slot window: errors, CUDA-event times of the kernel
    and the plain version, the byte bound, us per phase from the trace, and
    the compiled kernel's registers and local bytes (held to BIG_REGISTERS
    and BIG_LOCAL_BYTES)."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.tuning import BIG_INT8

    rows = []
    for i, (label, preset, g, s_bf16) in enumerate(BIG_CASES):
        cfg, params = fused_model(dev, preset, True, g, FUSED_LAYERS,
                                  seed=SEED + 80 + i, s_bf16=s_bf16)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        plan = fb.plan_big(params["blocks"], full_k.dtype, A)
        check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                              "2 layers", kernel=fb.fused_decode_step_big,
                              plain=fb.fused_decode_step_big_ref,
                              flags=(BIG_INT8,) * 4)
        times = time_big_step(cfg, params, x0, full_k[:, :A], full_v[:, :A], p,
                              sin, cos, [(params,), (_clone_blocks(params),)], 5)
        ptxas = fb.kernel_attributes()
        ptxas_ok = (ptxas["registers"] <= BIG_REGISTERS
                    and ptxas["local_bytes"] <= BIG_LOCAL_BYTES)
        row = dict(phase="kernel", kernel="fused_decode_big", model=label,
                   layers=FUSED_LAYERS, group_size=g,
                   scales="bf16" if s_bf16 else "fp32", plan=plan,
                   walk=fb.fused_decode_step_big.plan, ptxas=ptxas, ptxas_ok=ptxas_ok,
                   pos=FUSED_POS, window=A, **check, **times, card=CARD)
        emit(row)
        rows.append(row)
        del params, full_k, full_v
        if not (check["ok"] and plan is not None and ptxas_ok):
            raise AssertionError(f"fused_decode_big disagrees with its plain "
                                 f"version or exceeds its registers or local "
                                 f"bytes: {row}")
    return rows


def chunk_step_bytes(cfg, params, pos, steps, cache_itemsize):
    """Bytes per step of a `steps`-step chunk from slot `pos`: one
    megakernel step's (the K/V history grows by a row a step) plus the
    lm_head and the next token's embedding row."""
    from kuiperllama_tpu_torch.params import param_bytes

    extra = param_bytes({"w": params["lm_head"]}) + 2 * cfg.dim
    return sum(fused_step_bytes(cfg, params, pos + s, cache_itemsize) + extra
               for s in range(steps)) / steps


def hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos, steps, depth):
    """The chunk kernel against its plain version on the card, each on its
    own copy of the caches: the tokens equal up to a logit tie (at the first
    difference the plain version's logits of the two tokens lie within
    2e-3 of max(1, max|logit|) at 2 layers, within the depth's FUSED_TOL at
    full depth; nothing after it is compared), the K/V rows of the steps up
    to there within the depth's FUSED_TOL per layer, no other slot changed.
    Returns the checks."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    pos, L = int(p.item()), cfg.n_layers
    kk, vk = full_k.clone(), full_v.clone()
    got, _, _ = fd.fused_decode_chunk(cfg, params, x0, kk[:, :A], vk[:, :A], p,
                                      sin, cos, steps)
    got = got.tolist()
    kr, vr = full_k.clone(), full_v.clone()
    logits = []
    want, _, _ = fd.fused_decode_chunk_ref(cfg, params, x0, kr[:, :A], vr[:, :A],
                                           p.cpu(), sin, cos, steps, logits=logits)
    want = want.tolist()
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), steps)
    # tie limit relative to max(1, max|logit|): the CPU tests' 2e-3 at 2
    # layers; at full depth x_final itself moves by 2-3% between two valid
    # summation orders (the fused_step rows), so the rows' limit there
    flags = fd.gemv_int8_flags(params["blocks"],
                               fd.plan_tiles(params["blocks"], full_k.dtype, A))
    lm_int8 = fd.lm_int8_activation(params["lm_head"], cfg.dim)
    tol = FUSED_TOL[(depth, any(flags) or lm_int8)]
    tie_tol = TIE_TOL if depth == "2 layers" else tol
    gap, tie_ok = None, True
    if n < steps:
        row = logits[n]
        gap = abs(float(row[got[n]]) - float(row[want[n]])) / max(1.0, row.abs().max().item())
        tie_ok = gap <= tie_tol
    untouched = all(torch.equal(a[:, :pos], b[:, :pos])
                    and torch.equal(a[:, pos + steps:], b[:, pos + steps:])
                    for a, b in ((kk, full_k), (vk, full_v)))
    rows = [(a[li, pos:pos + n + 1], b[li, pos:pos + n + 1])
            for a, b in ((kk, kr), (vk, vr)) for li in range(L)]
    err = max(rel_err(a, b) for a, b in rows)
    abs_err = max((a.float() - b.float()).abs().max().item() for a, b in rows)
    ok = (tie_ok and err <= tol and untouched and len(got) == steps
          and all(0 <= t < cfg.vocab_size for t in got))
    return dict(steps=steps, int8_activation=list(flags), lm_int8_activation=lm_int8,
                tokens_kernel=got, tokens_plain=want,
                first_differing_step=None if n == steps else n,
                tie_logit_gap_rel=gap, tie_tol=tie_tol, tol=tol, rel_err_new_rows=err, max_abs_err=abs_err,
                other_slots_untouched=untouched, ok=ok)


def time_chunk(cfg, params, x0, kc, vc, p, sin, cos, steps, variants, plain_n):
    """ms per step of the chunk kernel (CUDA events over launches of `steps`
    steps, rotating `variants`, one-tuples of params), of its plain version,
    and the per-step byte bound."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.utils.profiling import device_time

    ms = device_time(lambda v: fd.fused_decode_chunk(cfg, v, x0, kc, vc, p, sin, cos,
                                                     steps),
                     variants=variants, device="cuda") * 1e3 / steps
    p_host = p.cpu()
    plain_ms = device_time(lambda v: fd.fused_decode_chunk_ref(
        cfg, v, x0, kc, vc, p_host, sin, cos, steps), variants=variants[:1],
        iters=plain_n, device="cuda") * 1e3 / steps
    nbytes = chunk_step_bytes(cfg, params, int(p.item()), steps, 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lm = params["lm_head"]
    ops = fused_step_ops(cfg, params) + 2.0 * cfg.dim * lm.shape[-1]
    ops_ms = ops / PEAK_OPS_PER_S["bf16"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms, plan=fd.fused_decode_chunk.plan)


def phase_fused_chunk_kernel(dev):
    """The chunk kernel against its plain version on the card at full width
    and FUSED_LAYERS layers of each CHUNK_CASES geometry, CHUNK_STEPS steps
    from pos 100 in a 256-slot window; ms per step against the per-step
    bound (the layer stack and the lm_head)."""
    rows = []
    for i, (label, preset, quantize, g) in enumerate(CHUNK_CASES):
        cfg, params = fused_model(dev, preset, quantize, g, FUSED_LAYERS,
                                  seed=SEED + 90 + i)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        check = hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                           CHUNK_STEPS, "2 layers")
        times = time_chunk(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin,
                           cos, CHUNK_STEPS, [(params,), (_clone_blocks(params),)], 2)
        row = dict(phase="kernel", kernel="fused_decode_chunk", model=label,
                   layers=FUSED_LAYERS, group_size=g,
                   quant="int8" if quantize else "bf16", pos=FUSED_POS, window=A,
                   **check, **times, card=CARD)
        emit(row)
        rows.append(row)
        del params, full_k, full_v
        if not check["ok"]:
            raise AssertionError(f"fused_decode_chunk disagrees with its plain "
                                 f"version: {row}")
    return rows


INT8_HOLD = (2, 4096, 2048, 64)    # exp_int8 held at L, K, N, g (the tool's K, N, g)
INT8_TOOL = (64, 4096, 2048, 64)   # and timed at the tool's defaults
INT8_TOL = 1e-5


def tool_operands(dev, K, N, seed):
    """q, s (Q8_0 of normal draws, group 64, fp32 scales) and bf16 x [8, K],
    as exp_kernel.main makes them."""
    import torch

    from kuiperllama_tpu_torch.quant import quantize_q80
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = quantize_q80(torch.randn((K, N), generator=gen, device=dev), ek.G)
    x = torch.randn((ek.M_DECODE, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, w.q, w.s


def hold_exp_kernel(dev):
    """exp_stream at every stream tile of the JAX tool that divides each
    TinyLlama-1.1B shape (equal to its plain version; lm_head has none),
    exp_outscale at each shape's sweep tiles and the tool's `current` (the
    GEMM: bf16 x, fp32 scales, g 64) at M = 8 (both within 2^-7), then
    times: kernel, plain version, and the yardsticks (torch.sum of q in
    int32 for the stream, beside the floor: one empty launch through the
    same library; for outscale bf16 x @ the pre-dequantized bf16 weight and
    the port's GEMM on the same operands) beside the bound, on weight copies
    rotated past L2; and the device kernels of one call of each probe
    (torch.profiler over 10 calls: one kernel a call)."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_kernel as ek
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    def ms(fn, variants, iters=25):
        return device_time(fn, variants=variants, iters=iters, device="cuda") * 1e3

    def kernels_per_call(fn, calls=10):
        fn()
        by_name, _ = device_profile(lambda: [fn() for _ in range(calls)])
        return {k[:60]: n / calls for k, (_, n) in by_name.items()}

    floor_ms = ms(lambda: ek.empty_launch(dev), [()])
    stream, outscale = [], []
    for i, (name, (K, N)) in enumerate(ek.SHAPES.items()):
        x, q, s = tool_operands(dev, K, N, SEED + 70 + i)
        M = x.shape[0]
        qs = [(q,)] + [(q.clone(),) for _ in range(l2_copies(K * N, dev) - 1)]
        tiles = [t for t in ek.STREAM_TILES if K % t[0] == 0 and N % t[1] == 0]
        errs = [(ek.exp_stream(q, tk, tn) - ek.stream_ref(q, tk, tn)).abs().item()
                for tk, tn in tiles]
        if tiles:
            tk, tn = tiles[0]
            row = dict(phase="tools", kernel="exp_stream", weight=name, K=K, N=N,
                       tiles_held=tiles, max_abs_err=max(errs), ok=max(errs) == 0,
                       tk=tk, tn=tn,
                       ms=ms(lambda qq: ek.exp_stream(qq, tk, tn), qs),
                       plain_ms=ms(lambda qq: ek.stream_ref(qq, tk, tn), qs, 10),
                       yardstick_ms=ms(lambda qq: torch.sum(qq, dtype=torch.int32), qs),
                       floor_ms=floor_ms,
                       kernels_per_call=kernels_per_call(lambda: ek.exp_stream(q, tk, tn)),
                       bound_ms=K * N / HBM_BYTES_PER_S * 1e3, bound_by="bytes", card=CARD)
            emit(row)
            stream.append(row)
            if not row["ok"]:
                raise AssertionError(f"exp_stream differs from its plain version: {row}")

        got, want = qm.quant_gemm(x, q, s, ek.G), qm.quant_gemm_ref(x, q, s, ek.G)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        row = dict(phase="tools", kernel="quant_gemm", variant="current", weight=name,
                   M=M, K=K, N=N, g=ek.G, scales="float32", rel_err=err,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   ok=err <= BF16_ULP and bool(torch.isfinite(got).all()), card=CARD)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"quant_gemm disagrees with its plain version: {row}")

        tk, tn = ek.sweep_tiles(K, N)
        got, want = ek.exp_outscale(x, q, s, tk, tn), ek.outscale_ref(x, q, s, tk, tn)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        wd = qm.dequantize_bf16(q, s, ek.G)
        wds = [(x, wd)] + [(x, wd.clone()) for _ in range(l2_copies(2 * K * N, dev) - 1)]
        bytes_ms, ops_ms = bound(M, K, N, ek.G, 2, 4, 2, "bf16")
        row = dict(phase="tools", kernel="exp_outscale", weight=name, M=M, K=K, N=N,
                   tk=tk, tn=tn, rel_err=err,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   ok=err <= BF16_ULP and bool(torch.isfinite(got).all()),
                   ms=ms(lambda qq: ek.exp_outscale(x, qq, s, tk, tn), qs),
                   plain_ms=ms(lambda qq: ek.outscale_ref(x, qq, s, tk, tn), qs, 10),
                   library_ms=ms(torch.matmul, wds),
                   gemm_ms=ms(lambda qq: qm.quant_gemm(x, qq, s, ek.G), qs),
                   kernels_per_call=kernels_per_call(lambda: ek.exp_outscale(x, q, s, tk, tn)),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations", card=CARD)
        emit(row)
        outscale.append(row)
        del qs, wd, wds
        if not row["ok"]:
            raise AssertionError(f"exp_outscale disagrees with its plain version: {row}")
    return stream, outscale


def int8_bound(mode, L, K, N, g):
    """(bytes, bound ms, bound_by) of one exp_int8 pass: nodot reads the
    weights alone and adds 16 rows per layer; the GEMV modes read weights,
    fp32 scales and x and do 2 L K N operations at the peak of their type."""
    if mode == "nodot":
        nbytes, ops, kind = L * K * N + 4 * N, 16.0 * L * N, "fp32"
    else:
        nbytes = L * K * N + 4 * L * (K // g) * N + 2 * K + 4 * N
        ops, kind = 2.0 * L * K * N, "int8" if mode.startswith("int8") else "bf16"
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return nbytes, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def hold_exp_int8(dev):
    """Every exp_int8 mode at its tool split, held against its plain version
    at INT8_HOLD and on the tool's own default stack, INT8_TOOL (nodot
    equal, the rest within INT8_TOL), then timed there (ms per pass, GB/s of
    the bytes the mode reads, us per tile) beside its bound and the plain
    version. No single library call sums a GEMV over layers."""
    import torch

    from kuiperllama_tpu_torch.tools import exp_int8 as ei

    def hold(w, s, x, g, mode, nsplit):
        got = ei.exp_int8(w, s, x, g, mode, nsplit)
        want = ei.exp_int8_ref(w, s, x, g, mode, nsplit)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = rel_err(got, want)
        return dict(rel_err=err, max_abs_err=(got - want).abs().max().item(),
                    equal=equal, ok=equal if mode == "nodot" else err <= INT8_TOL)

    w, s, x = ei.make_stack(dev, *INT8_HOLD, seed=SEED + 80)
    small = {m: hold(w, s, x, INT8_HOLD[3], m, ei.default_nsplit(m)) for m in ei.MODES}
    del w, s, x
    L, K, N, g = INT8_TOOL
    w, s, x = ei.make_stack(dev, L, K, N, g)  # exp_int8.main's stack
    rows = []
    for mode in ei.MODES:
        nsplit = ei.default_nsplit(mode)
        full = hold(w, s, x, g, mode, nsplit)
        ms = ei.measure(w, s, x, g, mode, nsplit) * 1e3
        nbytes, bound_ms, bound_by = int8_bound(mode, L, K, N, g)
        row = dict(phase="tools", kernel="exp_int8", mode=mode, nsplit=nsplit,
                   held_at={f"L={INT8_HOLD[0]}": small[mode], f"L={L}": full},
                   max_abs_err=max(small[mode]["max_abs_err"], full["max_abs_err"]),
                   ok=small[mode]["ok"] and full["ok"],
                   L=L, K=K, N=N, g=g, ms=ms, bytes=nbytes,
                   GBps=nbytes / ms / 1e6, us_per_tile=ms / L * 1e3,
                   plain_ms=ei.measure(w, s, x, g, mode, nsplit, 3, ei.exp_int8_ref) * 1e3,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, card=CARD)
        emit(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"exp_int8 ({mode}) disagrees with its plain version: {row}")
    return rows


def phase_tools(dev):
    """The kernel-measurement tools (kuiperllama_tpu_torch/tools): the
    roofline probes at their defaults, the three tool kernels held and
    timed, then the tools' own entry points as a user runs them
    (`exp_kernel` and `exp_int8` with their defaults, `bench_kernels` at
    llama2-7b M = 8, kernel and torch variants), with every launch count
    zeroed just before and read just after: each timed call launches once
    (plus one warm-up per variant), so the counts are exact."""
    from kuiperllama_tpu_torch.tools import ITERS, bench_kernels, roofline
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    emit(dict(phase="tools", tool="roofline", **roofline.run(dev), card=CARD))
    stream, outscale = hold_exp_kernel(dev)
    int8 = hold_exp_int8(dev)
    # bench_kernels' kernel variant at llama2-7b, M = 8: the GEMM at g 64
    # with fp32 scales at each of its five shapes
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES):
        check_kernel("quant_gemm", dev, ENGINE_SLOTS, K, N, 64, "fast", SEED + 100 + i,
                     name, scales="float32")

    zero_launches()
    ek_rows = ek.main(["--device", "cuda"])
    ei_rows = ei.main(["--device", "cuda"])
    bench = {v: bench_kernels.main(["--device", "cuda", "--model", "llama2-7b",
                                    "--m", str(ENGINE_SLOTS),
                                    "--variant", v])
             for v in ("kernel", "torch")}
    launches = read_launches()
    calls = ITERS + 1
    n = {v: sum(r["variant"] == v for r in ek_rows) for v in ("stream", "current", "outscale")}
    expect = dict(NO_LAUNCHES, exp_stream=calls * n["stream"],
                  exp_outscale=calls * n["outscale"], exp_int8=calls * len(ei_rows),
                  quant_gemm=calls * (n["current"] + 5))
    for out in bench.values():
        emit(dict(phase="tools", tool="bench_kernels", **out, card=CARD))
    n_stream = sum(K % tk == 0 and N % tn == 0 for K, N in ek.SHAPES.values()
                   for tk, tn in ek.STREAM_TILES)
    ok = (launches == expect and n == dict(stream=n_stream, current=len(ek.SHAPES),
                                           outscale=len(ek.SHAPES))
          and len(ei_rows) == 5)
    emit(dict(phase="main_path", path="tools", exp_kernel_rows=len(ek_rows),
              exp_int8_rows=len(ei_rows), launches=launches, launches_expected=expect,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the tools' launch counts differ from their rows")
    return dict(exp_stream=stream, exp_outscale=outscale, exp_int8=int8), launches


NO_LAUNCHES = dict.fromkeys(("quant_gemv", "quant_gemm", "fused_decode",
                             "fused_decode_big", "fused_decode_chunk",
                             "paged_attention", "exp_stream", "exp_outscale",
                             "exp_int8"), 0)


def zero_launches():
    """Every kernel wrapper's launch count, set to 0."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    qm.quant_gemv.launches = qm.quant_gemm.launches = 0
    qm.quant_gemm.wgmma_launches = qm.quant_gemm.x_roundings = 0
    fd.fused_decode_step.launches = fd.fused_decode_chunk.launches = 0
    fb.fused_decode_step_big.launches = pa.paged_attention_flat.launches = 0
    ek.exp_stream.launches = ek.exp_outscale.launches = ei.exp_int8.launches = 0


def on_wgmma(launches) -> bool:
    """Whether every GEMM launch since zero_launches took the wgmma route."""
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

    return qm.quant_gemm.wgmma_launches == launches["quant_gemm"]


def read_launches():
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    return {"quant_gemv": qm.quant_gemv.launches, "quant_gemm": qm.quant_gemm.launches,
            "exp_stream": ek.exp_stream.launches,
            "exp_outscale": ek.exp_outscale.launches,
            "exp_int8": ei.exp_int8.launches,
            "fused_decode": fd.fused_decode_step.launches,
            "fused_decode_big": fb.fused_decode_step_big.launches,
            "fused_decode_chunk": fd.fused_decode_chunk.launches,
            "paged_attention": pa.paged_attention_flat.launches}


def phase_big_main_path(dev):
    """The big route at full width and depth: Llama-2-7B INT8 g 64 (bf16
    scales, activations and cache, cache length 1024, random weights from a
    seed) through Generator.generate_batch_ids under KT_FUSED_BIG=1, one
    32-token prompt, 128 new tokens, greedy; launch counts zeroed just
    before and read just after. The same weights on the layered route
    beside it (its decode profile is the g 256 main path's), a decode
    profile of the big route, then the big kernel alone at the main path's
    shapes: held against its plain version on the CPU, timed, one launch
    traced."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.tuning import BIG_INT8
    from kuiperllama_tpu_torch.params import param_bytes, random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg = preset_config("llama2-7b", seq_len=CACHE_LEN)
    t0 = time.perf_counter()
    params = random_params_device(cfg, device=dev, seed=SEED, quantize=True,
                                  group_size=64)
    params = cast_scales(fuse_params(params), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b["wqkv"], b["wo"], b["w13"], b["w2"], params["lm_head"]]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream)
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prompt = list(range(5, 5 + 32))
    expect = dict(NO_LAUNCHES, quant_gemv=1 + 127, quant_gemm=4 * cfg.n_layers,
                  fused_decode_big=127)
    with knob("KT_FUSED_BIG"):
        gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128)
        ids, prefill_s, decode_s, launches, peak = timed_generate(gen, prompt, dev)
        graphs = graph_stats(gen.graph_cache)
        fused_ok = gen._fused_ok(1)
        eager_ids, eager = eager_route(gen, prompt, dev, expect)
        prof = profile_decode(cfg, params, gen, prompt, dev, fused=True,
                              model="llama2-7b g64 big")
        phase_prefill("llama2-7b g64 big route", gen)
    steps = len(ids) - 1
    ms_per_token = decode_s / steps * 1e3
    first_diff = first_difference(ids, eager_ids)
    layered = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128, fused_step=False)
    rows_l, _, layered_s = layered.generate_batch_ids([prompt], 128)
    first_diff_layered = first_difference(ids, rows_l[0])
    in_vocab = all(0 <= t < cfg.vocab_size for t in ids)
    ok = (len(ids) == 128 and in_vocab and fused_ok and launches == expect
          and eager["eager_launches_ok"] and first_diff is None
          and graph_route_ok(gen, graphs, steps))
    emit(dict(phase="main_path", model="llama2-7b", quant="int8", group_size=64,
              dtype="bf16", cache_len=CACHE_LEN, prompt_len=32, new_tokens=len(ids),
              route="big (KT_FUSED_BIG=1), graphs", prefill_ms=prefill_s * 1e3,
              decode_steps=steps, decode_ms_per_token=ms_per_token,
              decode_tokens_per_s=steps / decode_s, weight_bytes_per_token=weight_bytes,
              floor_ms_per_token=floor_ms, share_of_floor=floor_ms / ms_per_token,
              **eager, first_token_differing=first_diff, graphs=graphs,
              layered_graphs_decode_ms_per_token=layered_s / (len(rows_l[0]) - 1) * 1e3,
              layered_graphs_share_of_floor=floor_ms / (layered_s / (len(rows_l[0]) - 1) * 1e3),
              first_token_differing_from_layered=first_diff_layered,
              launches_per_step_profiled=prof["kernels_per_step"],
              device_busy_ms_per_step=prof["device_busy_ms_per_step"],
              device_idle_share_unprofiled=idle_share(prof, ms_per_token),
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, big_walk=fb.fused_decode_step_big.plan,
              big_ptxas=fb.kernel_attributes(), ok=ok, card=CARD))
    if not ok:
        raise AssertionError("Llama-2-7B big-route main path failed its checks")

    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                          "full depth", kernel=fb.fused_decode_step_big,
                          plain=fb.fused_decode_step_big_ref,
                          flags=(BIG_INT8,) * 4, held=("plain_cpu",))
    times = time_big_step(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin,
                          cos, [(params,)], 1)
    step = dict(phase="fused_big_step", model="llama2-7b g64", layers=cfg.n_layers,
                pos=FUSED_POS, window=A, walk=fb.fused_decode_step_big.plan,
                ptxas=fb.kernel_attributes(), **check, **times, card=CARD)
    emit(step)
    if not (check["ok"] and all(t > 0 for t in times["traced_phase_us_per_layer"].values())):
        raise AssertionError("fused_decode_big disagrees with its plain version "
                             "at full depth")
    return launches, step


def phase_chunk_main_path(dev, label, preset, quantize, per_step_row):
    """One model of the chunk route at full width and depth through
    Generator.generate_batch_ids under KT_FUSED_CHUNK=1 (64-step chunks, the
    Generator's default), greedy, as the per-step route's main path
    (`per_step_row`, whose numbers stand beside); then the chunk kernel alone
    at the main path's shapes (CHUNK_STEPS steps from pos 100 of a 256-slot
    window): held against its plain version on the card and timed."""
    import torch

    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg, params = fused_model(dev, preset, quantize, 256)
    b = params["blocks"]
    stream = [b[n] for n in ("wqkv", "wo", "w13", "w2", "bqkv") if n in b]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream + [params["lm_head"]])
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prompt = list(range(5, 5 + 32))
    with knob("KT_FUSED_CHUNK"):
        gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16)
        gen.generate_batch_ids([prompt], max_new_tokens=8)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=128)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profile_decode(cfg, params, gen, prompt, dev, fused=True,
                              model=f"{label} chunk")
    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = dict(NO_LAUNCHES, quant_gemv=1 if quantize else 0,
                  quant_gemm=4 * cfg.n_layers if quantize else 0,
                  fused_decode_chunk=-(-steps // gen.chunk))
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = len(rows[0]) == 128 and in_vocab and launches == expect
    busy = prof["device_busy_ms_per_step"]
    emit(dict(phase="main_path", model=label, quant="int8" if quantize else "bf16",
              group_size=256 if quantize else None, dtype="bf16", cache_len=CACHE_LEN,
              prompt_len=32, new_tokens=len(rows[0]), route="chunk (KT_FUSED_CHUNK=1)",
              chunk=gen.chunk, prefill_ms=prefill_s * 1e3, decode_steps=steps,
              decode_ms_per_token=ms_per_token, decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes, floor_ms_per_token=floor_ms,
              share_of_floor=floor_ms / ms_per_token,
              per_step_route_ms_per_token=per_step_row["decode_ms_per_token"],
              per_step_route_device_idle_share=per_step_row["device_idle_share_unprofiled"],
              launches_per_chunk_profiled=prof["kernels_per_step"] * prof["steps"],
              device_busy_ms_per_step=busy,
              device_idle_share_unprofiled=(1 - busy / ms_per_token
                                            if isinstance(busy, float) else "not measured"),
              peak_memory_bytes=peak, launches=launches, launches_expected=expect,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError(f"{label} chunk-route main path failed its checks")

    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check = hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                       CHUNK_STEPS, "full depth")
    times = time_chunk(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin, cos,
                       CHUNK_STEPS, [(params,)], 1)
    step = dict(phase="fused_chunk_step", model=label, layers=cfg.n_layers,
                pos=FUSED_POS, window=A, **check, **times, card=CARD)
    emit(step)
    if not check["ok"]:
        raise AssertionError(f"fused_decode_chunk disagrees with its plain version "
                             f"at full depth ({label})")
    return launches, step


# ---------------------------------------------------------------------------
# 12-14: the perplexity gate, an HF checkpoint, the bench


def phase_ppl(dev):
    """The perplexity gate (the port's tools/gate_group.py `gate`) on the
    committed tinychar fixtures, on the card and, as the reference, on the CPU with the
    plain versions: every INT8 projection of a 128-token window runs the
    GEMM kernel, launches counted exactly (windows x layers x seven
    projections, plus the lm_head where the v3 file quantizes it); ppl_fp,
    ppl_int8 and delta held to the CPU run, delta to the committed report
    (or, where that report was made on a TPU, to the JAX package's CPU
    reading)."""
    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.params import is_quant_leaf
    from kuiperllama_tpu_torch.tools.gate_group import PROJECTIONS, gate

    launches = dict(NO_LAUNCHES)
    for label, ckpt, group, qfile, family, committed in PPL_CASES:
        with open(os.path.join(HERE, committed)) as f:
            ref = json.load(f)
        want_delta = PPL_JAX_CPU_DELTA.get(label, ref["delta"])
        qpath = qfile and os.path.join(HERE, qfile)
        args = dict(group=group, quant_model=qpath, family=family)
        cpu = gate(os.path.join(HERE, ckpt), device="cpu", **args)
        zero_launches()
        t0 = time.perf_counter()
        card = gate(os.path.join(HERE, ckpt), device=dev, **args)
        seconds = time.perf_counter() - t0
        got = read_launches()
        wgmma = on_wgmma(got)
        cfg, raw = load_bin(qpath or os.path.join(HERE, ckpt), family=family)
        per_window = (len(PROJECTIONS) * cfg.n_layers
                      + bool(qpath and is_quant_leaf(raw["lm_head"])))
        expect = dict(NO_LAUNCHES, quant_gemm=card["heldout_tokens"] // card["window"]
                      * per_window)
        errs = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("ppl_fp", "ppl_int8")}
        errs["delta"] = abs(card["delta"] - cpu["delta"])
        ok = (got == expect and wgmma and card["passes_gate"] and cpu["passes_gate"]
              and card["kernel_mode"] == "cuda-gemm-fast"
              and max(errs["ppl_fp"], errs["ppl_int8"]) <= PPL_TOL["ppl"]
              and errs["delta"] <= PPL_TOL["delta"]
              and abs(card["delta"] - want_delta) <= PPL_DELTA_TOL)
        emit(dict(phase="ppl", fixture=label, checkpoint=ckpt, quant=card["quant"],
                  family=family, window=card["window"], heldout_tokens=card["heldout_tokens"],
                  ppl_fp=card["ppl_fp"], ppl_int8=card["ppl_int8"], delta=card["delta"],
                  passes_gate=card["passes_gate"], kernel_mode=card["kernel_mode"],
                  cpu_ppl_fp=cpu["ppl_fp"], cpu_ppl_int8=cpu["ppl_int8"],
                  cpu_delta=cpu["delta"], card_vs_cpu=errs, limits=PPL_TOL,
                  committed=committed, committed_delta=ref["delta"],
                  committed_kernel_mode=ref["kernel_mode"], held_delta=want_delta,
                  delta_minus_held=card["delta"] - want_delta, seconds=seconds,
                  launches=got, launches_expected=expect, gemm_on_wgmma=wgmma, ok=ok,
                  card=CARD))
        if not ok:
            raise AssertionError(f"perplexity gate failed its checks ({label})")
        for k, v in got.items():
            launches[k] += v
    return launches


def hf_config_json(preset: str) -> dict:
    """An HF config.json for a preset of the port (Qwen2.5-0.5B: the
    published values of Qwen/Qwen2.5-0.5B's config.json)."""
    from kuiperllama_tpu_torch.config import preset_config

    cfg = preset_config(preset)
    assert cfg.family == "qwen2", preset
    return {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
            "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim,
            "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size,
            "max_position_embeddings": 32768, "tie_word_embeddings": cfg.tied_embedding,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "hidden_act": "silu", "torch_dtype": "bfloat16",
            "bos_token_id": 151643, "eos_token_id": 151643,
            "use_sliding_window": False}


# the config fields that decide a forward's numbers (not seq_len: the rope
# table's length)
NUMERICS = ("family", "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
            "vocab_size", "rope_theta", "rope_style", "norm_eps", "qkv_bias",
            "tied_embedding", "group_size", "rope_scaling")


def numerics_mismatch(cfg, ref) -> list:
    return [k for k in NUMERICS if getattr(cfg, k) != getattr(ref, k)]


def write_safetensors(path: str, tensors: dict):
    """A .safetensors file from {name: (dtype tag, ndarray)}: the 8-byte
    little-endian header length, the JSON header, then the raw buffers in
    order (BF16 tensors are given as their uint16 bits)."""
    import struct

    header, offset = {}, 0
    for name, (tag, a) in tensors.items():
        header[name] = {"dtype": tag, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, a in tensors.values():
            f.write(a.tobytes())


def write_hf_dir(path: str, preset: str, dev, seed: int = SEED) -> int:
    """An HF directory of `preset` (config.json, model.safetensors) with
    random BF16 weights in HF naming and [out, in] orientation, drawn on
    the card from `seed` (norms 1). Returns the file's bytes."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config

    cfg = preset_config(preset)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def bf16(*shape, ones=False):
        t = (torch.ones(shape, device=dev) if ones else
             torch.randn(shape, generator=gen, device=dev).mul_(0.02))
        return ("BF16", t.to(torch.bfloat16).view(torch.int16).cpu().numpy().view("<u2"))

    d, h, kv = cfg.dim, cfg.hidden_dim, cfg.kv_dim
    t = {"model.embed_tokens.weight": bf16(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": bf16(d, ones=True),
                  p + "self_attn.q_proj.weight": bf16(d, d),
                  p + "self_attn.q_proj.bias": bf16(d),
                  p + "self_attn.k_proj.weight": bf16(kv, d),
                  p + "self_attn.k_proj.bias": bf16(kv),
                  p + "self_attn.v_proj.weight": bf16(kv, d),
                  p + "self_attn.v_proj.bias": bf16(kv),
                  p + "self_attn.o_proj.weight": bf16(d, d),
                  p + "post_attention_layernorm.weight": bf16(d, ones=True),
                  p + "mlp.gate_proj.weight": bf16(h, d),
                  p + "mlp.up_proj.weight": bf16(h, d),
                  p + "mlp.down_proj.weight": bf16(d, h)})
    t["model.norm.weight"] = bf16(d, ones=True)
    if not cfg.tied_embedding:
        t["lm_head.weight"] = bf16(cfg.vocab_size, d)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(preset), f, indent=2)
    st = os.path.join(path, "model.safetensors")
    write_safetensors(st, t)
    return os.path.getsize(st)


def logit_tie(logits, a: int, b: int, limit: float) -> bool:
    """Whether tokens a and b are within `limit` of max(1, max|logit|) of
    each other in `logits` [V]: a greedy choice either way is valid."""
    scale = max(1.0, float(logits.abs().max()))
    return abs(float(logits[a] - logits[b])) <= limit * scale


def hold_hf_two_layers(path, dev, prompt):
    """At 2 layers of the HF directory: the first decode step's logits of
    the megakernel on the card against its plain version on the CPU
    (FUSED_TOL), then 128 greedy tokens on both, equal up to a logit tie
    at the first difference (the CPU's layered logits there)."""
    import torch

    from kuiperllama_tpu_torch.checkpoint import hf
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.linear import linear
    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.generate import Generator

    with open(os.path.join(path, "config.json")) as f:
        d = dict(json.load(f), num_hidden_layers=FUSED_LAYERS)
    cfg = hf.config_from_hf(d)
    sd = {k.removeprefix("model."): v for k, v in
          hf.load_safetensors(os.path.join(path, "model.safetensors")).items()}
    raw = hf.params_from_state_dict(cfg, sd)
    logits, tokens, gens = {}, {}, {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        params = fuse_params(to_device(raw, device=where, dtype=torch.bfloat16))
        gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        fused_step=True)
        cache = decoder.init_kv_cache(cfg, 1, CACHE_LEN, torch.bfloat16, device=where)
        last, cache = decoder.prefill(cfg, params, torch.tensor([prompt], device=where),
                                      cache, rope=gen.rope)
        token = torch.argmax(last, -1).to(torch.int32)
        A = FUSED_WINDOW
        L, _, _, KH, hd = cache["k"].shape
        k = cache["k"][:, :, :A].contiguous().view(L, A, KH * hd)
        v = cache["v"][:, :, :A].contiguous().view(L, A, KH * hd)
        x_fin, _, _ = fd.fused_decode_step(
            cfg, params, params["tok_emb"][token.long()], k, v,
            torch.tensor([len(prompt)], dtype=torch.int32, device=where), *gen.rope)
        logits[key] = linear(x_fin, params["lm_head"]).float().cpu()[0]
        tokens[key] = gen.generate_ids(prompt, max_new_tokens=128)[0]
        gens[key] = (cfg, params, gen)
    err = rel_err(logits["card"], logits["cpu"])
    a, b = tokens["card"], tokens["cpu"]
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    tie = True
    if first is not None:
        cfg_c, params_c, gen_c = gens["cpu"]
        ids = prompt + b[:first]
        cache = decoder.init_kv_cache(cfg_c, 1, CACHE_LEN, torch.bfloat16, device="cpu")
        lg, _ = decoder.prefill(cfg_c, params_c, torch.tensor([ids]), cache,
                                rope=gen_c.rope)
        tie = logit_tie(lg[0], a[first], b[first], TIE_TOL)
    limit = FUSED_TOL[("2 layers", False)]
    return dict(layers=FUSED_LAYERS, first_step_rel_err=err, limit=limit,
                tokens_equal=a == b, first_difference=first, tie_at_difference=tie,
                tie_limit=TIE_TOL, ok=err <= limit and len(a) == len(b) == 128 and tie)


def phase_hf(dev, preset="qwen2.5-0.5b"):
    """An HF checkpoint at full width: a Qwen2.5-0.5B directory (BF16, the
    published config) written from a seed by this script's own writer,
    loaded through api.KuiperModel.from_checkpoint, 128 greedy tokens from a
    32-token prompt at cache length 1024 on the per-step megakernel route
    (launches counted exactly); at 2 layers of the same directory, held
    against the plain version on the CPU."""
    import tempfile

    import torch

    from kuiperllama_tpu_torch.api import KuiperModel
    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.params import param_bytes

    prompt = list(range(5, 5 + 32))
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        file_bytes = write_hf_dir(path, preset, dev)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = KuiperModel.from_checkpoint(path).init(
            dtype=torch.bfloat16, device=dev, cache_len=CACHE_LEN)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cfg = model.cfg
        mismatch = numerics_mismatch(cfg, preset_config(preset))
        gen = model._generator
        gen.generate_ids(prompt, max_new_tokens=8)  # warm-up
        torch.cuda.synchronize()
        zero_launches()
        ids, prefill_s, decode_s = gen.generate_ids(prompt, max_new_tokens=128)
        launches = read_launches()
        steps = len(ids) - 1
        expect = dict(NO_LAUNCHES, fused_decode=steps)
        b = model.params["blocks"]
        weight_bytes = sum(param_bytes({"w": b[n]}) for n in ("wqkv", "bqkv", "wo", "w13", "w2")) \
            + param_bytes({"w": model.params["lm_head"]})
        ms_per_token = decode_s / steps * 1e3
        two = hold_hf_two_layers(path, dev, prompt)
    ok = (not mismatch and len(ids) == 128 and steps == 127 and launches == expect
          and gen._fused_ok(1) and all(0 <= t < cfg.vocab_size for t in ids) and two["ok"])
    emit(dict(phase="hf_checkpoint", model=preset, format="HF safetensors, BF16",
              file_bytes=file_bytes, write_s=write_s, load_s=load_s,
              numerics_mismatch=mismatch, route="fused (auto)", cache_len=CACHE_LEN,
              prompt_len=len(prompt), new_tokens=len(ids), prefill_ms=prefill_s * 1e3,
              decode_ms_per_token=ms_per_token, decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes,
              floor_ms_per_token=weight_bytes / HBM_BYTES_PER_S * 1e3,
              launches=launches, launches_expected=expect, two_layers=two, ok=ok,
              card=CARD))
    if not ok:
        raise AssertionError("the HF checkpoint phase failed its checks")
    return launches


def _bench_errors_ok(line: dict) -> dict:
    """Each selftest key of a bench line against this script's limits."""
    out = {}
    for k, v in line.items():
        if k.startswith("quant_matmul_") and k.endswith("_rel_err"):
            out[k] = v <= TOL["exact" if "_exact" in k else "fast"]
        elif k.startswith("paged_attention_") and k.endswith("_abs_err"):
            out[k] = v <= PAGED_TOL["fp32"]
        elif k == "fused_step_rel_err":
            out[k] = v <= FUSED_TOL[("2 layers", False)]
        elif k == "fused_step_argmax_match":
            out[k] = v is True
    return out


def phase_bench(dev):
    """bench_torch.py in child processes: --selftest, the default (Llama-2-7B
    INT8 g 256, layered), --model tinyllama-1.1b (megakernel) and --engine.
    Each must exit 0 with the one-line contract; every selftest error within
    this script's limits."""
    import subprocess

    launches = {}
    for label, extra in BENCH_RUNS:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py"), *extra],
                             cwd=HERE, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else {}
        except ValueError:
            line = {}
        contract = all(k in line for k in ("metric", "value", "unit", "vs_baseline"))
        errs = _bench_errors_ok(line)
        # the selftest's 14 errors, in its own line and merged into the
        # default run's; the selftest launched each kernel it holds
        held = len(errs) == 14 if label in ("selftest", "default") else True
        if label == "selftest":
            held = held and all(line.get("launches", {}).get(k, 0) > 0 for k in
                                ("quant_gemv", "quant_gemm", "fused_decode",
                                 "paged_attention"))
        ok = res.returncode == 0 and contract and all(errs.values()) and held
        emit(dict(phase="bench", run=label, args=extra, returncode=res.returncode,
                  seconds=seconds, line=line, errors_within_limits=errs, ok=ok,
                  card=CARD))
        if not ok:
            print(res.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"bench_torch.py {' '.join(extra)} failed its checks")
        if "launches_per_run" in line:
            launches[f"bench {label}"] = dict(NO_LAUNCHES, **line["launches_per_run"])
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the remaining tools, each in a child process


# outputs of phase 17 (gitignored)
TOOLS17_OUT = os.path.join(HERE, "smoke_out", "tools17")
TOOLS17_TIMEOUT_S = 600
# a tool's kernel wrappers by the names of the kernels line
KERNEL_OF = {"fused_decode_step": "fused_decode", "fused_decode_step_big": "fused_decode_big",
             "paged_attention_flat": "paged_attention"}
NOISE = 1.05  # profile_paged's variants, each within 5% of the one it drops a piece from


def tools17_runs():
    """(label, tool, argv, extra environment, kernels its route launches)."""
    big = {"KT_FUSED_BIG": "1"}
    return [
        ("profile_decode", "profile_decode", ["--model", "tinyllama-1.1b"], {},
         ("quant_gemv", "quant_gemm")),
        ("profile_paged", "profile_paged", ["--model", "llama2-7b", "--batch", "8"], {},
         ("quant_gemm", "paged_attention")),
        ("exp_diag", "exp_diag", [], {}, ("quant_gemv", "quant_gemm")),
        ("exp_big 11008", "exp_big", ["--hidden", "11008"], big,
         ("fused_decode_big", "quant_gemv")),
        ("exp_big 11264", "exp_big", ["--hidden", "11264"], big,
         ("fused_decode_big", "quant_gemv")),
        ("bench_matrix", "bench_matrix",
         ["--only", "tinyllama_int8_b1,qwen2.5-0.5b_fp_b1",
          "--out", os.path.join(TOOLS17_OUT, "bench_matrix.json")], {},
         ("fused_decode",)),
        ("profile2", "profile2",
         ["--model", "tinyllama-1.1b", "--trace", os.path.join(TOOLS17_OUT, "trace")], {},
         ("quant_gemv", "quant_gemm")),
        ("exp_step", "exp_step", ["--model", "llama2-7b", "--steps", "128"], {},
         ("quant_gemv",)),
        ("exp_ablate", "exp_ablate", ["--model", "tinyllama-1.1b"], {},
         ("quant_gemv", "quant_gemm")),
        ("train_tiny", "train_tiny",
         ["--steps", "200", "--out", os.path.join(TOOLS17_OUT, "train_tiny")], {},
         ("quant_gemm",)),
        ("exp_cache", "exp_cache", [], {},
         ("quant_gemv", "quant_gemm")),
    ]


def tools17_checks(tool: str, line: dict, argv) -> dict:
    """Each check of a tool's last line by name."""
    if tool == "profile_decode":
        return dict(tokens_equal=line["tokens_equal"] is True,
                    w2_on_gemm=line["shapes"]["w2"]["kernel"] == "gemm")
    if tool == "profile_paged":
        ms = line["ms_per_step"]
        full, no_writes, stub = (ms[k] for k in ("full step", "no KV scatter",
                                                 "no scatter, attention stubbed"))
        attn = {t: n["paged_attention_flat"] for t, n in line["launches_by_variant"].items()}
        return dict(tokens_equal_eager=line["tokens_equal_eager"] is True,
                    graphs=line["graphs"] is True,
                    only_full_step_writes_pools=line["writes_pools"] == {
                        "full step": True, "no KV scatter": False,
                        "no scatter, attention stubbed": False},
                    stub_launches_no_attention=attn == {
                        "full step": attn["full step"], "no KV scatter": attn["full step"],
                        "no scatter, attention stubbed": 0} and attn["full step"] > 0,
                    stub_le_no_writes=stub <= no_writes * NOISE,
                    no_writes_le_full=no_writes <= full * NOISE)
    if tool == "exp_diag":
        out = {}
        for key, row in line.items():
            if key.startswith("K") and isinstance(row, dict):
                gemv, gemm = row["cap176_diag"]["launches"], row["cap64_generic"]["launches"]
                out[f"{key} cap176 gemv"] = gemv["quant_gemv"] > 0 and gemv["quant_gemm"] == 0
                out[f"{key} cap64 gemm"] = gemm["quant_gemm"] > 0 and gemm["quant_gemv"] == 0
        return dict(out, three_shapes=len(out) == 6)
    if tool == "exp_big":
        return dict(route_big=line["route"] == "big", plan=line["plan"] is not None,
                    hidden=line["hidden_dim"] == int(argv[argv.index("--hidden") + 1]))
    if tool == "bench_matrix":
        return dict(rows=line["rows"] == {"tinyllama_int8_b1": True,
                                          "qwen2.5-0.5b_fp_b1": True})
    if tool == "profile2":
        return dict(trace_exists=bool(line["trace"]) and os.path.isfile(line["trace"]),
                    graphs=line["graphs"] is True)
    if tool == "exp_step":
        n = line["launches"]
        return dict(route_layered=line["route"] == "layered",
                    no_megakernel=n["fused_decode_step"] == n["fused_decode_chunk"]
                    == n["fused_decode_step_big"] == 0,
                    baseline_tokens_equal=line["baseline_tokens_equal"] is True,
                    components=len(line["component_cost_ms"]) == 5)
    if tool == "exp_ablate":
        return dict(shapes=len(line["shapes"]) == 5,
                    int8_chunk=sorted(line["int8_chunk"]) == ["1024", "2048", "256"],
                    bf16_chunk="ms_per_token" in line["bf16_chunk"],
                    small_vocab_chunk="ms_per_token" in line["small_vocab_chunk"])
    if tool == "train_tiny":
        return dict(passes_gate=line["passes_gate"] is True,
                    loss_le_2=line["final_train_loss"] <= 2.0,
                    kernel_mode=line["kernel_mode"] == "cuda-gemm")
    if tool == "exp_cache":
        return dict(tokens_equal=line["tokens_equal"] is True, graphs=line["graphs"] is True)
    raise KeyError(tool)


def phase_tools17(dev):
    """The remaining tools (kuiperllama_tpu_torch/tools), each as a user runs
    it, in a child process that keeps its patches and KT_FUSED_BIG to itself:
    its exit code, its last JSON line held to the tool's checks, and its
    launches counted where its route needs each kernel. Returns each run's
    launches under `tools17.<label>`."""
    import shutil
    import subprocess

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TOOLS17_OUT, ignore_errors=True)
    os.makedirs(TOOLS17_OUT)
    launches = {}
    for label, tool, argv, env, needs in tools17_runs():
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"kuiperllama_tpu_torch.tools.{tool}", *argv],
            cwd=HERE, env=dict(os.environ, **env), capture_output=True, text=True,
            timeout=TOOLS17_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else {}
        except ValueError:
            line = {}
        counts = dict(NO_LAUNCHES, **{KERNEL_OF.get(k, k): n
                                      for k, n in line.get("launches", {}).items()})
        try:
            checks = tools17_checks(tool, line, argv) if res.returncode == 0 else {}
        except (KeyError, TypeError, ValueError) as e:
            checks = {"line_readable": False, "error": repr(e)}
        checks.update({f"launched {k}": counts[k] > 0 for k in needs})
        ok = res.returncode == 0 and bool(line) and all(
            v is True for k, v in checks.items() if k != "error")
        emit(dict(phase="tools17", tool=label, args=argv, env=env,
                  returncode=res.returncode, seconds=seconds, checks=checks,
                  line=line, ok=ok, card=CARD))
        if not ok:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"tools17: {label} failed its checks")
        launches[f"tools17.{label}"] = counts
    return launches


# ---------------------------------------------------------------------------
# Phase 15: tensor and sequence parallelism (parallel/*), two ranks on the card


def par_kernels(dev):
    """The three kernels of the parallel paths at shard shapes they run
    nowhere else, held against their plain versions: Llama-2-7B INT8 g 64
    at tp = 2 (each projection on the kernel its route takes at one row,
    the GEMM at the prefill's 32 rows and the engine's 8), and the paged
    kernel at tp = 2's 16 kv heads of 7B and at seqpar's full Qwen2.5-0.5B
    lanes over one rank's block of pages (local ids, rows it does not cover)."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.linear import GEMV_MAX_GROUPS
    from kuiperllama_tpu_torch.parallel.seqpar import build_work_lists_sharded
    from kuiperllama_tpu_torch.utils.profiling import device_time

    g = PAR_GROUP
    for i, (name, K, N) in enumerate(PAR_SHAPES):
        kind = "quant_gemv" if K // g <= GEMV_MAX_GROUPS else "quant_gemm"
        check_kernel(kind, dev, 1, K, N, g, "fast", SEED + 200 + i, f"tp2 {name}")
        if name != "lm_head":
            for M in (PREFILL_M, ENGINE_SLOTS):
                check_kernel("quant_gemm", dev, M, K, N, g, "fast", SEED + 210 + i + M,
                             f"tp2 {name}")
    ok = True
    # tp = 2: each rank's 16 of Llama-2-7B's 32 kv heads (lanes 2048)
    q, kp, vp, work, sl, _ = paged_inputs(dev, 16, 16, 128, torch.bfloat16, SEED + 220, 2)
    held = hold_paged(q, kp, vp, work, sl, 1)
    ms = device_time(lambda: pa.paged_attention_flat(q, kp, vp, *work, sl,
                                                     page_size=PAGED_PS, layer_idx=1),
                     device="cuda") * 1e3
    good = held["rel_err_out"] <= PAGED_TOL["bf16"] and held["finite"]
    emit(dict(phase="kernel", kernel="paged_attention", model="llama2-7b tp2 rank",
              H=16, KH=16, hd=128, seq_lens=PAGED_LENS, **held, ms=ms,
              tol=PAGED_TOL["bf16"], ok=good, card=CARD))
    ok = ok and good
    # seqpar over 2 ranks: Qwen2.5-0.5B's full 128 lanes, each rank's block
    # of the pages with local ids; the partials merge to the unsplit kernel
    q, kp, vp, work, sl, pt = paged_inputs(dev, 14, 2, 64, torch.bfloat16, SEED + 230, 2)
    P = kp.shape[1] - kp.shape[1] % 2
    kp, vp = kp[:, :P].contiguous(), vp[:, :P].contiguous()
    # the shuffled table within the even pool (the dropped page's slot
    # reads page 1, which another row reads too)
    pt = np.where(pt < P, pt, 1)
    full = [torch.from_numpy(a).to(dev) for a in pa.build_work_list(pt, sl.cpu().numpy(),
                                                                   PAGED_PS)]
    ref = pa.paged_attention_flat(q, kp, vp, *full, sl, page_size=PAGED_PS, layer_idx=1)
    fb, fp, ft, ni, cov = build_work_lists_sharded(pt, sl.cpu().numpy(), PAGED_PS, 2, P,
                                                   pad_to=pt.size)
    parts, errs, identity = [], [], True
    for r in range(2):
        lw = [torch.from_numpy(np.ascontiguousarray(a[r])).to(dev) for a in (fb, fp, ft, ni)]
        kr, vr = (p[:, r * P // 2:(r + 1) * P // 2].contiguous() for p in (kp, vp))
        args = (q, kr, vr, *lw, sl)
        acc, m, l = pa.paged_attention_flat(*args, page_size=PAGED_PS, layer_idx=1)
        ra, rm, rl = pa.paged_attention_flat_ref(*args, page_size=PAGED_PS, layer_idx=1)
        c = torch.from_numpy(cov[r]).to(dev)
        errs.append(rel_err(acc[c] / l[c][..., None], ra[c] / rl[c][..., None]))
        # rows this rank does not cover: the flash identity on both sides
        identity = identity and bool((acc[~c] == 0).all() and (l[~c] == 0).all()
                                     and (m[~c] == rm[~c]).all())
        parts.append((acc, m, l))
    merged = pa.merge_flash_many(*(torch.stack([p[j] for p in parts]) for j in range(3)))
    want = ref[0] / ref[2][..., None]
    merge_err = rel_err(merged, want)
    good = (max(errs) <= PAGED_TOL["bf16"] and merge_err <= PAGED_TOL["bf16"]
            and identity and bool(merged.isfinite().all()))
    emit(dict(phase="kernel", kernel="paged_attention", model="qwen2.5-0.5b seqpar rank",
              H=14, KH=2, hd=64, pages=P, seq_lens=PAGED_LENS,
              rows_covered=[int(c.sum()) for c in cov], items=ni[:, 0].tolist(),
              rel_err_by_rank=errs, uncovered_rows_identity=identity,
              merged_vs_unsplit_rel_err=merge_err,
              tol=PAGED_TOL["bf16"], ok=good, card=CARD))
    ok = ok and good
    if not ok:
        raise AssertionError("paged_attention disagrees at the parallel shapes")


def par_device():
    """A rank's device: the pool makes cuda:0 every rank's current one."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def par_prompt(i, n, vocab):
    return [(7 * i + j) % (vocab - 1) + 1 for j in range(n)]


def par_requests(vocab, long_prompt=0):
    """The engine rows' requests (phase 10's): ENGINE_REQUESTS of
    ENGINE_PROMPT tokens, every 4th of `long_prompt` when set."""
    from kuiperllama_tpu_torch.serving.engine import Request

    return [Request(prompt_ids=par_prompt(i, long_prompt if long_prompt and i % 4 == 3
                                          else ENGINE_PROMPT, vocab),
                    max_new_tokens=ENGINE_NEW) for i in range(ENGINE_REQUESTS)]


def par_model(dev, seqpar):
    """The parallel rows' unfused weights from SEED: Llama-2-7B INT8 g 64
    with bf16 scales, or (seqpar) Qwen2.5-0.5B bf16."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales

    if seqpar:
        cfg = preset_config("qwen2.5-0.5b", seq_len=CACHE_LEN)
        return cfg, random_params_device(cfg, device=dev, seed=SEED)
    cfg = preset_config("llama2-7b", seq_len=CACHE_LEN)
    params = random_params_device(cfg, device=dev, seed=SEED, quantize=True,
                                  group_size=PAR_GROUP)
    return cfg, cast_scales(params, torch.bfloat16)


def par_engine_kw(seqpar):
    kw = dict(max_batch=ENGINE_SLOTS, max_len=CACHE_LEN, chunk=ENGINE_CHUNK,
              page_size=ENGINE_PS)
    if seqpar:
        kw["prefill_chunk"] = PAR_PREFILL_CHUNK
    return kw


def par_prefill_logits(eng, ids):
    """The last-token logits [V] of a prefill of `ids` through the engine's
    prefill entry (its step's, on a rank), writing only the garbage page."""
    import torch

    from kuiperllama_tpu_torch.models.paged import prefill_paged

    dev = eng.device
    toks = torch.tensor([ids], dtype=torch.int32, device=dev)
    lens = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
    pages = torch.full((1, len(ids)), 2 ** 30, dtype=torch.int32, device=dev)
    fn = prefill_paged if eng._sharded is None else eng._sharded.prefill
    return fn(eng.cfg, eng.params, toks, lens, eng.k_pages, eng.v_pages, pages,
              rope=eng.rope)[0][0].float().cpu().numpy()


def par_run_engine(eng, vocab, long_prompt, dev):
    """Phase 10's timed engine run: two warm-up requests, then every request
    submitted at t0, counters zeroed just before and read just after; the
    collectives of each decode chunk recorded beside its steps."""
    import torch

    from kuiperllama_tpu_torch.parallel import collectives
    from kuiperllama_tpu_torch.serving.engine import Request

    eng.run([Request(prompt_ids=par_prompt(i, 16, vocab), max_new_tokens=4)
             for i in range(2)])
    torch.cuda.synchronize()
    reqs = par_requests(vocab, long_prompt)
    chunks = []
    if eng._sharded is not None:
        run = eng._sharded.run_chunk

        def counted(*args, **kw):
            before = collectives.bill()
            out = run(*args, **kw)
            after = collectives.bill()
            chunks.append((args[7], {op: {k: after[op][k] - before[op][k]
                                          for k in ("count", "bytes")} for op in after}))
            return out

        eng._sharded.run_chunk = counted
    eng.n_decode_steps = eng.n_prefill_calls = 0
    eng.prefill_wall_s = 0.0
    zero_launches()
    collectives.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(out_ids=[r.out_ids for r in reqs], wall_s=wall,
               steps=eng.n_decode_steps, prefills=eng.n_prefill_calls,
               prefill_wall_s=eng.prefill_wall_s, preemptions=eng.n_preemptions,
               finished=len(done), launches=read_launches(), bill=collectives.bill(),
               chunks=chunks, peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    out["gemm_on_wgmma"] = on_wgmma(out["launches"])
    if eng._sharded is not None:
        eng._sharded.run_chunk = run
    out["prefill_logits"] = par_prefill_logits(eng, reqs[0].prompt_ids)
    return out


def par_exact_run(cfg, params, prompt, dev, forward_fn=None):
    """Row (a)'s exact run: PAR_EXACT_NEW greedy tokens after `prompt` at
    fp32 activations (params placed in fp32) and an fp32 cache, the INT8
    kernels in exact mode, through decoder.prefill and decode_step (with
    `forward_fn`, this rank's share): (ids, logits [1 + new, V] numpy)."""
    import torch

    from kuiperllama_tpu_torch.models import decoder

    cache = (decoder.init_kv_cache(cfg, 1, CACHE_LEN, torch.float32, device=dev)
             if forward_fn is None
             else forward_fn.init_cache(1, CACHE_LEN, torch.float32, device=dev))
    tokens = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, cache = decoder.prefill(cfg, params, tokens, cache, mode="exact",
                                    forward_fn=forward_fn)
    rows, ids = [logits[0]], []
    for i in range(PAR_EXACT_NEW):
        ids.append(int(torch.argmax(rows[-1])))
        tok = torch.tensor([ids[-1]], dtype=torch.int32, device=dev)
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        logits, cache = decoder.decode_step(cfg, params, tok, pos, cache, mode="exact",
                                            drop_past_end=False, forward_fn=forward_fn)
        rows.append(logits[0])
    return ids, torch.stack(rows).float().cpu().numpy()


def par_rank_generator():
    """Row (a) on one rank: KuiperModel.init(mesh=) at tp = 2 over the pool's
    gloo group, bf16 activations and cache; a warm-up of 8 tokens, then 128
    greedy tokens from the 32-token prompt with every count zeroed just
    before and read just after; the prompt's last logits through the
    Generator's prefill (the sharded forward). Then the exact run on
    KuiperModel.init(dtype=fp32, mesh=)."""
    import torch

    from kuiperllama_tpu_torch.api import KuiperModel
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.parallel import collectives
    from kuiperllama_tpu_torch.parallel.mesh import make_mesh

    dev = par_device()
    mesh = make_mesh(1, PAR_RANKS)
    cfg, params = par_model(dev, False)
    model = KuiperModel(cfg, params).init(dtype=torch.bfloat16, device=dev,
                                          cache_len=CACHE_LEN, mesh=mesh,
                                          cache_dtype=torch.bfloat16)
    prompt = par_prompt(0, ENGINE_PROMPT, cfg.vocab_size)
    gen = model._generator
    cache = model._forward_fn.init_cache(1, CACHE_LEN, torch.bfloat16, device=dev)
    logits = decoder.prefill(cfg, model.params, torch.tensor([prompt], device=dev),
                             cache, rope=gen.rope, forward_fn=model._forward_fn)
    logits = logits[0][0].float().cpu().numpy()
    del cache
    gen.generate_batch_ids([prompt], max_new_tokens=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    collectives.reset()
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=ENGINE_NEW)
    out = dict(ids=rows[0], prefill_s=prefill_s, decode_s=decode_s,
               launches=read_launches(), bill=collectives.bill(),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               graphs=gen.graphs_on(), prefill_logits=logits, backend=mesh.backend)
    del model, gen
    model = KuiperModel(cfg, params).init(dtype=torch.float32, device=dev,
                                          cache_len=CACHE_LEN, mesh=mesh)
    del params
    out["exact_ids"], out["exact_logits"] = par_exact_run(
        cfg, model.params, prompt, dev, model._forward_fn)
    del model
    torch.cuda.empty_cache()
    return out


def par_exact_engine(cfg, params, dev, mesh=None):
    """Row (d)'s exact run on a PagedEngine over fp32 copies of `params`
    and an fp32 pool: seqpar over `mesh`, or one device without it.
    Returns (out_ids, the first prompt's last prefill logits)."""
    import torch

    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request

    eng = PagedEngine(cfg, to_device(params, device=dev, dtype=torch.float32),
                      mesh=mesh, seqpar=mesh is not None, cache_dtype=torch.float32,
                      **par_engine_kw(True))
    reqs = [Request(prompt_ids=r.prompt_ids, max_new_tokens=PAR_EXACT_NEW)
            for r in par_requests(cfg.vocab_size, PAR_SEQPAR_PROMPT)[:PAR_EXACT_REQUESTS]]
    eng.run(reqs)
    out = [r.out_ids for r in reqs], par_prefill_logits(eng, reqs[0].prompt_ids)
    del eng
    torch.cuda.empty_cache()
    return out


def par_rank_engine(seqpar):
    """Row (b) (Llama-2-7B, tp = 2) or (d) (Qwen2.5-0.5B, seqpar sp = 2) on
    one rank: PagedEngine(mesh=, seqpar=) at phase 10's settings."""
    import torch

    from kuiperllama_tpu_torch.parallel.mesh import make_mesh
    from kuiperllama_tpu_torch.serving.engine import PagedEngine

    dev = par_device()
    mesh = make_mesh(1, PAR_RANKS)
    cfg, params = par_model(dev, seqpar)
    eng = PagedEngine(cfg, params, mesh=mesh, seqpar=seqpar, cache_dtype=torch.bfloat16,
                      **par_engine_kw(seqpar))
    del params  # the engine keeps this rank's slices only
    out = par_run_engine(eng, cfg.vocab_size, PAR_SEQPAR_PROMPT if seqpar else 0, dev)
    out.update(graphs=eng.graph_cache is not None, n_pages=eng._n_pages,
               free_pages=eng._pool_pages, pool_shape=list(eng.k_pages.shape))
    del eng
    torch.cuda.empty_cache()
    if seqpar:  # the same weights again, from SEED
        out["exact_ids"], out["exact_logits"] = par_exact_engine(
            cfg, par_model(dev, True)[1], dev, mesh)
    return out


def par_tie_check(cfg, params, prompt, a, b, dev):
    """At a first difference: the single-device logits after `prompt` (the
    prompt and the tokens both runs share) and whether tokens a and b are
    within TIE_TOL of a tie there. The logits are taken in fp32: the bf16
    logits the model samples from are a bf16 ulp apart (2^-6 near 3) or
    equal, too coarse to measure a gap against TIE_TOL. The final normed
    hidden state is read out exactly (an identity lm_head in bf16), then
    multiplied by the lm_head's weights in fp32."""
    import torch

    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.quant import QuantTensor, dequantize

    head = params["lm_head"]
    w = dequantize(head) if isinstance(head, QuantTensor) else head.float()
    eye = dict(params, lm_head=torch.eye(cfg.dim, dtype=torch.bfloat16, device=dev))
    cache = decoder.init_kv_cache(cfg, 1, len(prompt) + 1, torch.bfloat16, device=dev)
    h, _ = decoder.prefill(cfg, eye, torch.tensor([prompt], device=dev), cache)
    logits = (h.float() @ w)[0]
    scale = max(1.0, float(logits.abs().max()))
    gap = float(logits[a] - logits[b])
    return dict(tie=logit_tie(logits, a, b, PAR_TIE_TOL), gap=gap, scale=scale,
                gap_share=abs(gap) / scale, within_tie_tol=logit_tie(logits, a, b, TIE_TOL))


def par_agreement(cfg, params, prompts, single, ranks, dev):
    """Per request: the ranks' tokens identical, and equal to the
    single-device run's up to a logit tie at the first difference (nothing
    after it compared)."""
    same = all(r == ranks[0] for r in ranks[1:])
    diffs = []
    for i, (prompt, want, got) in enumerate(zip(prompts, single, ranks[0])):
        j = first_difference(want, got)
        if j is None:
            continue
        if j >= min(len(want), len(got)):
            diffs.append(dict(request=i, at=j, tie=False, lengths=[len(want), len(got)]))
            continue
        diffs.append(dict(request=i, at=j, single=want[j], ranks=got[j],
                          **par_tie_check(cfg, params, prompt + want[:j], want[j],
                                          got[j], dev)))
    return dict(ranks_identical=same, differing=len(diffs), first_differences=diffs[:4],
                max_gap_share=max((d.get("gap_share", 1.0) for d in diffs), default=0.0),
                tie_limit=PAR_TIE_TOL, tokens_ok=same and all(d["tie"] for d in diffs))


def par_bill_ok(bill, expect):
    return all(bill[op]["count"] == expect[op]["count"]
               and bill[op]["bytes"] == expect[op]["bytes"] for op in expect)


def par_chunks_ok(chunks, per_step):
    """Every decode chunk's collectives equal `steps` times the per-step bill."""
    return bool(chunks) and all(
        d[op]["count"] == steps * per_step[op]["count"]
        and d[op]["bytes"] == steps * per_step[op]["bytes"]
        for steps, d in chunks for op in per_step)


def par_rank_fields(outs, prefix=""):
    """The per-rank fields of a row."""
    return {f"{prefix}launches_by_rank": [o["launches"] for o in outs],
            f"{prefix}collectives_by_rank": [o["bill"] for o in outs],
            f"{prefix}collective_seconds_by_rank": [
                sum(e["seconds"] for e in o["bill"].values()) for o in outs],
            f"{prefix}peak_memory_bytes_by_rank": [o["peak_memory_bytes"] for o in outs]}


def par_single_engine(cfg, params, seqpar, dev):
    """The single-device PagedEngine (graph route) on the same (fused)
    weights, admitting through the padded [slots, bucket] prefill that the
    mesh path takes (Engine._admit_now) instead of its own packed one, so
    that the rows compare like with like (row (c) bit for bit)."""
    import types

    import torch

    from kuiperllama_tpu_torch.serving.engine import Engine, PagedEngine

    eng = PagedEngine(cfg, params, cache_dtype=torch.bfloat16, **par_engine_kw(seqpar))
    eng._admit_now = types.MethodType(Engine._admit_now, eng)
    out = par_run_engine(eng, cfg.vocab_size, PAR_SEQPAR_PROMPT if seqpar else 0, dev)
    out.update(graphs=graph_stats(eng.graph_cache), free_pages=eng._pool_pages)
    return out, eng


def phase_parallel(dev):
    """Rows (a)-(d): the port's tensor and sequence parallelism on the one
    card, each beside the single-device run on the same weights in this
    process. (a) and (b) and (d) are two gloo ranks in spawned processes on
    cuda:0 (their collectives pass through the host; NCCL refuses two ranks
    on one device), (c) a world of one NCCL rank in this process, whose
    collectives are captured in the decode graphs."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from kuiperllama_tpu_torch.api import KuiperModel
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.parallel import collectives
    from kuiperllama_tpu_torch.parallel.launch import RankPool
    from kuiperllama_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from kuiperllama_tpu_torch.ops.linear import GEMV_MAX_GROUPS
    from kuiperllama_tpu_torch.serving.engine import PagedEngine
    from kuiperllama_tpu_torch.serving.generate import Generator, _bucket

    par_kernels(dev)
    launches = {}
    tmp = tempfile.mkdtemp(prefix="kt_rdv_")
    cfg, unfused = par_model(dev, False)
    L = cfg.n_layers
    params = fuse_params(unfused)
    prompt = par_prompt(0, ENGINE_PROMPT, cfg.vocab_size)

    # single-device references: the Generator and the engine, graph routes
    gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                    chunk=128)
    single_ids, _, single_decode_s, single_launches, _ = timed_generate(
        gen, prompt, dev, new=ENGINE_NEW)
    cache = decoder.init_kv_cache(cfg, 1, CACHE_LEN, torch.bfloat16, device=dev)
    single_logits = decoder.prefill(cfg, params, torch.tensor([prompt], device=dev),
                                    cache)[0][0].float().cpu().numpy()
    del gen, cache
    exact = KuiperModel(cfg, unfused).init(dtype=torch.float32, device=dev,
                                           cache_len=CACHE_LEN)
    exact_ids, exact_logits = par_exact_run(cfg, exact.params, prompt, dev)
    del exact
    eng_single, eng = par_single_engine(cfg, params, False, dev)
    # phase 16's single-device server, on the same engine
    srv_single = srv_drive(eng, SRV_REQUESTS, dev)
    del eng
    torch.cuda.empty_cache()

    # (c) the (b) engine through ShardedPagedStep on a world of one NCCL rank
    initialize_distributed(f"file://{tmp}/nccl", 1, 0, backend="nccl", device_id=dev)
    try:
        mesh = make_mesh(1, 1)
        eng = PagedEngine(cfg, unfused, mesh=mesh, cache_dtype=torch.bfloat16,
                          **par_engine_kw(False))
        c = par_run_engine(eng, cfg.vocab_size, 0, dev)
        graphs = graph_stats(eng.graph_cache)
        captured = eng.graph_cache.captured()
        captured_prefill = eng.graph_cache.captured(prefill=True)
        # phase 16 (b): the same engine behind the server
        srv_b = srv_drive(eng, SRV_REQUESTS, dev)
        del eng
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    per_step = collectives.analytic_decode_bill(cfg, ENGINE_SLOTS, 2)
    replay_ok = bool(captured) and all(
        g["all_reduce.launches"] == per_step["all-reduce"]["count"]
        and g["all_reduce.bytes"] == per_step["all-reduce"]["bytes"]
        and g["all_gather.launches"] == per_step["all-gather"]["count"]
        and g["all_gather.bytes"] == per_step["all-gather"]["bytes"] for g in captured)
    # each prefill graph: wo and w2 summed per layer, the last logits gathered
    prefill_ok = (bool(captured_prefill) and graphs["n_prefill_replays"] >= 1
                  and all(g["all_reduce.launches"] == 2 * L
                          and g["all_gather.launches"] == 1 for g in captured_prefill))
    same = c["out_ids"] == eng_single["out_ids"]
    ok = (same and replay_ok and prefill_ok and c["launches"] == eng_single["launches"]
          and c["gemm_on_wgmma"] and eng_single["gemm_on_wgmma"]
          and c["steps"] == eng_single["steps"] and graphs["n_captures"] >= 1
          and np.array_equal(c["prefill_logits"], eng_single["prefill_logits"]))
    emit(dict(phase="parallel", row="c", what="PagedEngine through ShardedPagedStep, "
              "world of 1 NCCL rank, graphs", model="llama2-7b", group_size=PAR_GROUP,
              backend="nccl", world=1, tokens_bit_identical=same,
              prefill_logits_bit_identical=bool(np.array_equal(
                  c["prefill_logits"], eng_single["prefill_logits"])),
              launches=c["launches"], single_launches=eng_single["launches"],
              decode_steps=c["steps"], prefill_calls=c["prefills"], graphs=graphs,
              collectives_per_replay=captured, analytic_per_step=per_step,
              replay_collectives_ok=replay_ok,
              collectives_per_prefill_replay=captured_prefill,
              prefill_collectives_ok=prefill_ok, collectives=c["bill"],
              tokens_per_s=ENGINE_REQUESTS * ENGINE_NEW / c["wall_s"],
              single_tokens_per_s=ENGINE_REQUESTS * ENGINE_NEW / eng_single["wall_s"],
              wall_ms_per_decode_step=(c["wall_s"] - c["prefill_wall_s"]) / c["steps"] * 1e3,
              single_wall_ms_per_decode_step=(eng_single["wall_s"]
                                              - eng_single["prefill_wall_s"])
              / eng_single["steps"] * 1e3,
              peak_memory_bytes=c["peak_memory_bytes"], ok=ok, card=CARD))
    if not ok:
        raise AssertionError("row (c): the world-1 NCCL engine differs from the "
                             "single-device engine")
    launches["parallel c nccl world 1"] = c["launches"]
    del unfused
    launches.update(srv_nccl_row(cfg, srv_b, srv_single))

    with RankPool(PAR_RANKS, backend="gloo", init_method=f"file://{tmp}/gloo",
                  timeout_s=PAR_TIMEOUT_S, device=str(dev), threads=2) as pool:
        # (a) the Generator through KuiperModel.init(mesh=)
        outs = pool.run(par_rank_generator)
        steps = len(outs[0]["ids"]) - 1
        T = _bucket(len(prompt))  # the prefill's padded length
        # two ranks exchange the INT8 kernels' fp32 partials
        # (models/decoder.py partial_dtype); the prefill gathers the logits
        # of its last position only
        per_step = collectives.analytic_decode_bill(cfg, 1, 4)
        expect = {"all-reduce": dict(count=2 * L * (steps + 1), bytes=per_step[
            "all-reduce"]["bytes"] * steps + 2 * L * T * cfg.dim * 4),
            "all-gather": dict(count=steps + 1,
                               bytes=per_step["all-gather"]["bytes"] * (steps + 1))}
        agree = par_agreement(cfg, params, [prompt], [single_ids],
                              [[o["ids"]] for o in outs], dev)
        # one row: each projection on the kernel its shard's groups pick; the
        # 32-row prefill's projections on the GEMM, its last position's
        # lm_head as a decode step's
        ks = [cfg.dim, cfg.dim // PAR_RANKS, cfg.dim, cfg.hidden_dim // PAR_RANKS]
        gemv = sum(k // PAR_GROUP <= GEMV_MAX_GROUPS for k in ks)
        head = int(cfg.dim // PAR_GROUP <= GEMV_MAX_GROUPS)
        want_l = dict(NO_LAUNCHES, quant_gemv=steps * (gemv * L + head) + head,
                      quant_gemm=4 * L + 1 - head + steps * ((4 - gemv) * L + 1 - head))
        logit_err = max(float(np.abs(o["prefill_logits"] - single_logits).max())
                        for o in outs) / float(np.abs(single_logits).max())
        exact_same = all(o["exact_ids"] == exact_ids for o in outs)
        exact_err = max(float(np.abs(o["exact_logits"] - exact_logits).max())
                        for o in outs) / float(np.abs(exact_logits).max())
        decode_s = max(o["decode_s"] for o in outs)
        ok = (agree["tokens_ok"] and all(par_bill_ok(o["bill"], expect) for o in outs)
              and logit_err <= FUSED_TOL[("full depth", False)]
              and exact_same and exact_err <= PAR_EXACT_TOL
              and all(o["launches"] == want_l for o in outs)
              and len(outs[0]["ids"]) == ENGINE_NEW
              and not any(o["graphs"] for o in outs))
        emit(dict(phase="parallel", row="a", what="Generator via KuiperModel.init(mesh=)",
                  model="llama2-7b", group_size=PAR_GROUP, scales="bf16", backend="gloo",
                  ranks=PAR_RANKS, device="cuda:0 for every rank", route="layered, eager "
                  "(gloo collectives cannot be captured)", prompt_len=len(prompt),
                  new_tokens=len(outs[0]["ids"]), tokens_rank0=outs[0]["ids"],
                  **agree, prefill_logits_max_rel_err=logit_err,
                  prefill_logits_limit=FUSED_TOL[("full depth", False)],
                  exact_run=dict(new_tokens=PAR_EXACT_NEW, activations="fp32",
                                 cache="fp32", int8_mode="exact",
                                 tokens_equal_single=exact_same,
                                 tokens_rank0=outs[0]["exact_ids"],
                                 logits_max_rel_err=exact_err, limit=PAR_EXACT_TOL),
                  decode_ms_per_token=decode_s / steps * 1e3,
                  decode_tokens_per_s=steps / decode_s,
                  single_decode_ms_per_token=single_decode_s / steps * 1e3,
                  single_launches=single_launches, launches_expected=want_l,
                  collectives_expected=expect, **par_rank_fields(outs), ok=ok, card=CARD))
        if not ok:
            raise AssertionError("row (a): the tp = 2 Generator failed its checks")
        for r, o in enumerate(outs):
            launches[f"parallel a rank {r}"] = o["launches"]

        # (b) the engine at tp = 2
        outs = pool.run(par_rank_engine, False)
        b_ok = par_engine_row(cfg, params, "b", outs, eng_single, dev, False)
        for r, o in enumerate(outs):
            launches[f"parallel b rank {r}"] = o["launches"]
        # phase 16 (a): the (b) engine behind the server on both ranks
        outs = pool.run(srv_rank, False)
        srv_ok = srv_row("a", cfg, params, outs, srv_single, dev, False)
        for r, o in enumerate(outs):
            launches[f"server ranks a rank {r}"] = o["launches"]
        del params
        torch.cuda.empty_cache()

        # (d) seqpar at sp = 2 on Qwen2.5-0.5B bf16, chunked prefill
        qcfg, qparams = par_model(dev, True)
        qparams = fuse_params(qparams)
        q_single, eng = par_single_engine(qcfg, qparams, True, dev)
        q_srv_single = srv_drive(eng, SRV_SEQPAR_REQUESTS, dev)
        del eng
        q_single["exact_ids"], q_single["exact_logits"] = par_exact_engine(
            qcfg, qparams, dev)
        outs = pool.run(par_rank_engine, True)
        d_ok = par_engine_row(qcfg, qparams, "d", outs, q_single, dev, True)
        for r, o in enumerate(outs):
            launches[f"parallel d rank {r}"] = o["launches"]
        # phase 16 (c): the (d) engine behind the server on both ranks
        outs = pool.run(srv_rank, True)
        srv_ok = srv_row("c", qcfg, qparams, outs, q_srv_single, dev, True) and srv_ok
        for r, o in enumerate(outs):
            launches[f"server ranks c rank {r}"] = o["launches"]
        del qparams
        torch.cuda.empty_cache()
        phase_parallel_tools(dev, pool)
    torch.cuda.empty_cache()
    if not (b_ok and d_ok):
        raise AssertionError("a parallel engine row failed its checks")
    if not srv_ok:
        raise AssertionError("a server_ranks row failed its checks")
    return launches


def par_engine_row(cfg, params, row, outs, single, dev, seqpar):
    """Rows (b) and (d): agreement, the collectives of every decode chunk
    against the per-step bill, launches per rank, times."""
    import numpy as np

    from kuiperllama_tpu_torch.ops.linear import PREFILL_DEQUANT_ROWS
    from kuiperllama_tpu_torch.parallel import collectives
    from kuiperllama_tpu_torch.serving.generate import _bucket

    L, o0 = cfg.n_layers, outs[0]
    prompts = [r.prompt_ids for r in par_requests(cfg.vocab_size,
                                                   PAR_SEQPAR_PROMPT if seqpar else 0)]
    agree = par_agreement(cfg, params, prompts, single["out_ids"],
                          [o["out_ids"] for o in outs], dev)
    # the exchanged partials (models/decoder.py partial_dtype): the INT8
    # kernels' fp32 for Llama-2-7B, bf16 for Qwen's dense weights
    per_step = collectives.analytic_decode_bill(cfg, ENGINE_SLOTS, 2 if seqpar else 4,
                                                seqpar_shards=PAR_RANKS if seqpar else 0)
    chunks_ok = all(par_chunks_ok(o["chunks"], per_step) for o in outs)
    steps, prefills = o0["steps"], o0["prefills"]
    if seqpar:  # bf16 weights: no INT8 kernel
        want_l = dict(NO_LAUNCHES, paged_attention=L * steps)
    else:  # a prefill of >= PREFILL_DEQUANT_ROWS rows launches only its lm_head
        rows = ENGINE_SLOTS * _bucket(ENGINE_PROMPT)
        per_prefill = 1 if rows >= PREFILL_DEQUANT_ROWS else 4 * L + 1
        want_l = dict(NO_LAUNCHES, paged_attention=L * steps,
                      quant_gemm=steps * (4 * L + 1) + prefills * per_prefill)
    logit_err = max(float(np.abs(o["prefill_logits"] - single["prefill_logits"]).max())
                    for o in outs) / float(np.abs(single["prefill_logits"]).max())
    generated = sum(len(ids) for ids in o0["out_ids"])
    same_schedule = all((o["steps"], o["prefills"]) == (single["steps"], single["prefills"])
                        for o in outs)
    exact = {}
    if seqpar:
        err = max(float(np.abs(o["exact_logits"] - single["exact_logits"]).max())
                  for o in outs) / float(np.abs(single["exact_logits"]).max())
        exact = dict(exact_run=dict(
            requests=PAR_EXACT_REQUESTS, new_tokens=PAR_EXACT_NEW, weights="fp32",
            pool="fp32", tokens_equal_single=all(o["exact_ids"] == single["exact_ids"]
                                                 for o in outs),
            prefill_logits_max_rel_err=err, limit=PAR_EXACT_TOL))
    ok = (agree["tokens_ok"] and chunks_ok and all(o["launches"] == want_l for o in outs)
          and all(o["gemm_on_wgmma"] for o in outs)
          and logit_err <= FUSED_TOL[("full depth", False)]
          and (not seqpar or (exact["exact_run"]["tokens_equal_single"]
                              and exact["exact_run"]["prefill_logits_max_rel_err"]
                              <= PAR_EXACT_TOL))
          and all(o["finished"] == ENGINE_REQUESTS for o in outs) and same_schedule
          and all(o["free_pages"] == single["free_pages"] for o in outs)
          and not any(o["graphs"] for o in outs))
    wall = max(o["wall_s"] for o in outs)
    prefill_wall = max(o["prefill_wall_s"] for o in outs)
    emit(dict(phase="parallel", row=row,
              what=("PagedEngine(mesh=, seqpar=True), sp = 2, chunked prefill" if seqpar
                    else "PagedEngine(mesh=), tp = 2"),
              model="qwen2.5-0.5b" if seqpar else "llama2-7b",
              weights="bf16" if seqpar else f"int8 g {PAR_GROUP}, bf16 scales",
              backend="gloo", ranks=PAR_RANKS, device="cuda:0 for every rank",
              route="eager (gloo collectives cannot be captured)", slots=ENGINE_SLOTS,
              max_len=CACHE_LEN, chunk=ENGINE_CHUNK, page_size=ENGINE_PS,
              prefill_chunk=PAR_PREFILL_CHUNK if seqpar else 0,
              requests=ENGINE_REQUESTS, prompt_len=ENGINE_PROMPT,
              long_prompt_every_4th=PAR_SEQPAR_PROMPT if seqpar else None,
              new_tokens=ENGINE_NEW, generated_tokens=generated, **agree,
              prefill_logits_max_rel_err=logit_err,
              prefill_logits_limit=FUSED_TOL[("full depth", False)], **exact,
              same_schedule=same_schedule,
              tokens_per_s=generated / wall, wall_s=wall,
              wall_ms_per_decode_step=(wall - prefill_wall) / steps * 1e3,
              single_tokens_per_s=generated / single["wall_s"],
              single_wall_ms_per_decode_step=(single["wall_s"] - single["prefill_wall_s"])
              / single["steps"] * 1e3,
              decode_steps=steps, prefill_calls=prefills,
              free_pages=[o["free_pages"] for o in outs], single_free_pages=single["free_pages"],
              n_pages=o0["n_pages"], pool_shape_per_rank=o0["pool_shape"],
              collectives_per_decode_step_expected=per_step,
              decode_chunks_checked=len(o0["chunks"]), decode_collectives_ok=chunks_ok,
              single_launches=single["launches"], launches_expected=want_l,
              **par_rank_fields(outs), ok=ok, card=CARD))
    return ok


def srv_prompts(vocab, n):
    return [par_prompt(i, ENGINE_PROMPT, vocab) for i in range(n)]


def srv_drive(eng, n, dev):
    """Phase 16 on one rank (or one process): an InferenceServer over `eng`.
    A follower follows until rank 0's stop flag. The leader serves HTTP on
    127.0.0.1: n requests of srv_prompts posted together, queued in order
    before the server starts (one wave), then, while they decode, an invalid
    request (400) and a long one that times out (504; its cancel reaches
    every rank), then /healthz and /metrics once the cancel is applied, and
    stop. Launch counts, collectives and
    the engine's step counters are zeroed just before the server starts and
    read after its loop ends. Returns the requests the engine was given
    (id, tokens, finished), in order, with the counts and times."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from kuiperllama_tpu_torch.parallel import collectives
    from kuiperllama_tpu_torch.serving.server import InferenceServer, make_http_server

    submitted, submit = [], eng.submit

    def record(req):
        submitted.append(req)
        submit(req)

    eng.submit = record
    srv = InferenceServer(eng)
    timeout_s = srv.timeout_s
    free0 = eng.allocator.n_free_pages
    torch.cuda.synchronize()
    eng.n_decode_steps = eng.n_prefill_calls = 0
    zero_launches()
    collectives.reset()
    out = dict(leader=srv.leader)
    if not srv.leader:
        srv.start()
        out["ended"] = srv.join(PAR_TIMEOUT_S)
    else:
        httpd = make_http_server(srv, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def call(path, body=None):
            data = None if body is None else json.dumps(body).encode()
            try:
                with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                            timeout=PAR_TIMEOUT_S) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        prompts = srv_prompts(eng.cfg.vocab_size, n)
        answers, answered = [None] * n, [0.0] * n

        def client(i):
            answers[i] = call("/generate", {"prompt_ids": prompts[i],
                                            "max_new_tokens": SRV_NEW})
            answered[i] = time.perf_counter()

        clients = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        try:
            # in flight together, queued in prompt order: one client starts
            # once the one before it is queued
            for i, c in enumerate(clients):
                c.start()
                end = time.perf_counter() + 60
                while srv._q.qsize() < i + 1 and time.perf_counter() < end:
                    time.sleep(0.001)
            t0 = time.perf_counter()
            srv.start()
            bad = call("/generate", {"prompt_ids": [], "max_new_tokens": SRV_NEW})
            # the wave's requests hold the default timeout; this one waits
            # SRV_TIMEOUT_S (the server's timeout when it is posted)
            srv.timeout_s = SRV_TIMEOUT_S
            late = call("/generate", {"prompt_ids": prompts[0],
                                      "max_new_tokens": SRV_LONG_NEW})
            srv.timeout_s = timeout_s
            for c in clients:
                c.join(PAR_TIMEOUT_S)
            wall = max(answered) - t0  # the wave's: start to its last answer
            end = time.perf_counter() + 60
            while (not srv._q.empty() or not srv._cancel_q.empty() or eng.has_work) \
                    and time.perf_counter() < end:
                time.sleep(0.005)
            health = call("/healthz")
            metrics = call("/metrics")[1]
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.stop()
        out.update(ended=srv.join(0), codes=[a[0] if a else None for a in answers],
                   answers=[a[1].get("ids") if a else None for a in answers],
                   bad=bad, late=late, wall_s=wall, health=health,
                   metrics=metrics)
    torch.cuda.synchronize()
    eng.submit = submit
    out.update(error=None if srv.error is None else repr(srv.error),
               launches=read_launches(), bill=collectives.bill(),
               steps=eng.n_decode_steps, prefills=eng.n_prefill_calls,
               free_start=free0, free_end=eng.allocator.n_free_pages,
               submitted=[(r.request_id, list(r.out_ids), r.finished) for r in submitted],
               control_messages=0 if srv.control is None else srv.control.messages,
               control_s=0.0 if srv.control is None else srv.control.seconds,
               graphs=graph_stats(eng.graph_cache))
    return out


def srv_rank(seqpar):
    """Phase 16 (a) (Llama-2-7B, tp = 2) or (c) (Qwen2.5-0.5B, seqpar sp = 2)
    on one rank: PagedEngine(mesh=, seqpar=) at phase 15's settings behind
    an InferenceServer (srv_drive)."""
    import torch

    from kuiperllama_tpu_torch.parallel.mesh import make_mesh
    from kuiperllama_tpu_torch.serving.engine import PagedEngine

    dev = par_device()
    mesh = make_mesh(1, PAR_RANKS)
    cfg, params = par_model(dev, seqpar)
    eng = PagedEngine(cfg, params, mesh=mesh, seqpar=seqpar, cache_dtype=torch.bfloat16,
                      **par_engine_kw(seqpar))
    del params
    out = srv_drive(eng, SRV_SEQPAR_REQUESTS if seqpar else SRV_REQUESTS, dev)
    del eng
    torch.cuda.empty_cache()
    return out


def srv_launches(cfg, out, seqpar):
    """The launches a server run must count from its steps and prefills:
    paged attention n_layers a decode step; with INT8 weights the GEMM at
    the engine's 8 rows each step (4 L + 1), and a 256-row prefill of
    32-token prompts only its lm_head (the rest dequantized, ops/linear.py)."""
    from kuiperllama_tpu_torch.ops.linear import PREFILL_DEQUANT_ROWS
    from kuiperllama_tpu_torch.serving.generate import _bucket

    L, steps = cfg.n_layers, out["steps"]
    if seqpar:
        return dict(NO_LAUNCHES, paged_attention=L * steps)
    rows = ENGINE_SLOTS * _bucket(ENGINE_PROMPT)
    per_prefill = 1 if rows >= PREFILL_DEQUANT_ROWS else 4 * L + 1
    return dict(NO_LAUNCHES, paged_attention=L * steps,
                quant_gemm=steps * (4 * L + 1) + out["prefills"] * per_prefill)


def srv_served_ok(out, n):
    """The leader's checks: every answer 200 and the tokens its engine
    made, the 400, the 504, the pages back, /healthz ok."""
    given = [ids for _, ids, _ in out["submitted"]]
    return (out["ended"] and out["error"] is None and out["codes"] == [200] * n
            and out["answers"] == given[:n] and len(given) == n + 1
            and not out["submitted"][n][2] and out["bad"][0] == 400
            and out["late"][0] == 504
            and out["free_end"] == out["free_start"] and out["health"][0] == 200
            and out["metrics"]["served"] == n)


def srv_fields(out):
    """A server run's times: tokens/s over the wave, TTFT p50 and p99 (rank
    0's /metrics), the seconds inside the control broadcasts."""
    m = out["metrics"]
    return dict(tokens_per_s=sum(len(a) for a in out["answers"]) / out["wall_s"],
                wave_wall_s=out["wall_s"], ttft_ms_p50=m["ttft_s_p50"] * 1e3,
                ttft_ms_p99=m["ttft_s_p99"] * 1e3)


def phase_parallel_tools(dev, pool):
    """The two parallel tools on the card. seqpar_bytes: its byte and page
    fields equal the committed SEQPAR_r05.json (the JAX tool's). scaling: a
    world of one NCCL rank through its entry point (its own pool; the HBM
    term from roofline.probe_read), then phase 15's two gloo ranks on
    cuda:0 through `run`: the counted bill verified and every row measured.
    Their launches count on no path (plain torch ops at the tiny config)."""
    import io

    from kuiperllama_tpu_torch.tools import scaling, seqpar_bytes

    def exact(out):
        return [{k: v for k, v in r.items() if k != "build_work_lists_host_ms"}
                for r in out["rows"]]

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        sb = seqpar_bytes.main([])
        t0 = time.perf_counter()
        nccl = scaling.main(["--backend", "nccl", "--world", "1", "--device", "cuda"])
        nccl_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gloo = scaling.run(pool, dev, scaling.tiny_cfg(), nccl["hbm_GBps"],
                           nccl["hbm_source"])
        gloo_s = time.perf_counter() - t0
    with open(os.path.join(HERE, "SEQPAR_r05.json")) as f:
        committed = json.load(f)
    sb_ok = exact(sb) == exact(committed)
    emit(dict(phase="tools", tool="seqpar_bytes", equals_committed=sb_ok,
              max_shard_fraction=[r["max_shard_fraction"] for r in sb["rows"]],
              build_work_lists_host_ms=[r["build_work_lists_host_ms"] for r in sb["rows"]],
              ok=sb_ok, card=CARD))
    ok = sb_ok
    for out, sec in ((nccl, nccl_s), (gloo, gloo_s)):
        good = (out["counted_collectives"]["verified"] and bool(out["rows"])
                and all(r["measured_step_ms"] > 0 for r in out["rows"]))
        emit(dict(phase="tools", tool="scaling", backend=out["backend"], world=out["world"],
                  seconds=sec, counted_collectives=out["counted_collectives"],
                  hbm_GBps=out["hbm_GBps"], hbm_source=out["hbm_source"],
                  link_GBps=out["link_GBps"], rows=out["rows"], ok=good, card=CARD))
        ok = ok and good
    if not ok:
        raise AssertionError("a parallel tool failed its checks")


def phase_native(dev):
    """The native runtime (kuiperllama_tpu_torch/runtime): the loader and the
    merge engine, built by g++ in phase 2, load; the SPM tokenizer takes
    the native merge, equal to its Python merge on NATIVE_TEXTS random
    texts; the native header of each committed fixture equals the header
    checkpoint/binfmt.py reads (the v3 Qwen2 file, whose body carries
    biases, is refused by the native loader as by the JAX copy, and read by
    binfmt)."""
    import glob

    import numpy as np

    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.runtime import native
    from kuiperllama_tpu_torch.tokenizer.spm import SentencePieceTokenizer

    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    alphabet = list("abcd\u2581")
    pieces, seen = ["<unk>", "<s>", "</s>"] + alphabet, set(alphabet)
    for n in (2, 3, 4):
        for _ in range(40):
            cand = "".join(rng.choice(alphabet) for _ in range(n))
            if cand not in seen:
                seen.add(cand)
                pieces.append(cand)
    scores = [0.0] * 3 + list(rng.uniform(-10, 0, len(pieces) - 3))
    tok = SentencePieceTokenizer(pieces, scores, [2, 3, 3] + [1] * (len(pieces) - 3))
    merges_equal = True
    for _ in range(NATIVE_TEXTS):
        text = "".join(rng.choice(list("abcd ")) for _ in range(int(rng.integers(1, 60))))
        prep = text.replace(" ", "\u2581")
        prep = prep if prep.startswith("\u2581") else "\u2581" + prep
        merges_equal &= tok.encode(text, bos=False) == tok._merge_py(tok._symbols_of(prep))
    headers = {}
    for path in sorted(glob.glob(os.path.join(HERE, "checkpoints", "*", "*.bin"))):
        rel = os.path.relpath(path, HERE)
        family = "qwen2" if "qwen2" in rel else "llama2"
        cfg, _ = load_bin(path, family=family)
        try:
            h = native.parse_header(path)
        except ValueError:
            headers[rel] = "refused"
            continue
        headers[rel] = (
            (h.dim, h.hidden_dim, h.n_layers, h.n_heads, h.n_kv_heads, h.vocab_size,
             h.seq_len, bool(h.tied), h.group_size or None)
            == (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                cfg.vocab_size, cfg.seq_len, cfg.tied_embedding, cfg.group_size))
    refused = [k for k, v in headers.items() if v == "refused"]
    ok = (built and tok.merge_engine == "native" and merges_equal
          and all(v is True for k, v in headers.items() if k not in refused)
          and refused == ["checkpoints/tinychar_qwen2/tinychar.q8.bin"]
          and len(headers) == 6)
    emit(dict(phase="native", built=built, build_s=build_s,
              libraries=[native.lib_path(native.SRC_DIR / f"{n}.cpp").name
                         for n in ("loader", "spm_bpe")],
              merge_engine=tok.merge_engine, texts=NATIVE_TEXTS,
              native_merge_equals_python=merges_equal, headers_equal_binfmt=headers,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the native runtime failed its checks")


def srv_nccl_row(cfg, srv, single):
    """Phase 16 (b): the server over a world of one NCCL rank (graphs on;
    no peer, so no control message) answers tokens bit-identical to the
    single-device server's; both serve as srv_served_ok says, with exact
    launches. Returns the two paths' launches."""
    n = SRV_REQUESTS
    want = [srv_launches(cfg, o, False) for o in (srv, single)]
    same = srv["answers"] == single["answers"]
    ok = (same and srv_served_ok(srv, n) and srv_served_ok(single, n)
          and srv["launches"] == want[0] and single["launches"] == want[1]
          and srv["control_messages"] == 0 and srv["graphs"]["n_replays"] >= 1)
    emit(dict(phase="server_ranks", row="b",
              what="InferenceServer over PagedEngine(mesh=) on a world of 1 NCCL rank, "
                   "graphs", model="llama2-7b", group_size=PAR_GROUP, backend="nccl",
              world=1, requests=n, tokens_bit_identical_to_single=same,
              invalid_status=srv["bad"][0], timed_out_status=srv["late"][0],
              free_pages_start_end=(srv["free_start"], srv["free_end"]),
              **srv_fields(srv), single=srv_fields(single),
              control_messages=srv["control_messages"], graphs=srv["graphs"],
              decode_steps=srv["steps"], prefill_calls=srv["prefills"],
              launches=srv["launches"], single_launches=single["launches"],
              launches_expected=want[0], ok=ok, card=CARD))
    if not ok:
        raise AssertionError("row (b): the world-1 NCCL server differs from the "
                             "single-device server")
    return {"server ranks b nccl world 1": srv["launches"],
            "server ranks b single device": single["launches"]}


def srv_row(row, cfg, params, outs, single, dev, seqpar):
    """Phase 16 (a) and (c): both ranks gave the same requests the same ids
    and tokens, equal to the single-device server's up to a logit tie at
    the first difference; rank 0 answered as srv_served_ok says; every
    rank's launches exact and its pages back."""
    n = SRV_SEQPAR_REQUESTS if seqpar else SRV_REQUESTS
    lead, follow = outs
    prompts = srv_prompts(cfg.vocab_size, n)
    agree = par_agreement(cfg, params, prompts, single["answers"],
                          [o["answers"] if o["leader"] else
                           [ids for _, ids, _ in o["submitted"][:n]] for o in outs], dev)
    want = [srv_launches(cfg, o, seqpar) for o in outs]
    same = follow["submitted"] == lead["submitted"]
    ok = (agree["tokens_ok"] and same and srv_served_ok(lead, n) and follow["ended"]
          and follow["error"] is None and follow["free_end"] == follow["free_start"]
          and all(o["launches"] == w for o, w in zip(outs, want))
          and (lead["steps"], lead["prefills"]) == (follow["steps"], follow["prefills"]))
    emit(dict(phase="server_ranks", row=row,
              what=("InferenceServer over PagedEngine(mesh=, seqpar=True), sp = 2" if seqpar
                    else "InferenceServer over PagedEngine(mesh=), tp = 2"),
              model="qwen2.5-0.5b" if seqpar else "llama2-7b",
              weights="bf16" if seqpar else f"int8 g {PAR_GROUP}, bf16 scales",
              backend="gloo", ranks=PAR_RANKS, device="cuda:0 for every rank",
              route="eager (gloo collectives cannot be captured)", slots=ENGINE_SLOTS,
              max_len=CACHE_LEN, chunk=ENGINE_CHUNK, page_size=ENGINE_PS, requests=n,
              prompt_len=ENGINE_PROMPT, new_tokens=SRV_NEW, ranks_gave_same_requests=same,
              request_ids=[r for r, _, _ in lead["submitted"]], **agree,
              invalid_status=lead["bad"][0], timed_out_status=lead["late"][0],
              timed_out_request_cancelled_on_every_rank=all(
                  not o["submitted"][n][2] for o in outs),
              free_pages_start_end_by_rank=[(o["free_start"], o["free_end"]) for o in outs],
              healthz=lead["health"][1], **srv_fields(lead),
              single_tokens_per_s=srv_fields(single)["tokens_per_s"],
              single_ttft_ms_p50=srv_fields(single)["ttft_ms_p50"],
              control_messages_by_rank=[o["control_messages"] for o in outs],
              control_seconds_by_rank=[o["control_s"] for o in outs],
              collective_seconds_by_rank=[sum(e["seconds"] for e in o["bill"].values())
                                          for o in outs],
              decode_steps=lead["steps"], prefill_calls=lead["prefills"],
              launches_by_rank=[o["launches"] for o in outs], launches_expected=want,
              ok=ok, card=CARD))
    return ok


def _sum(rows, key):
    return sum(r[key] * n for r, n in rows)


def tool_entries(tool_rows, launches):
    """The kernels line's entries of the tool kernels; `launches` is the
    tools' main path (their entry points run with their defaults)."""
    st, os_ = tool_rows["exp_stream"], tool_rows["exp_outscale"]
    bf16 = next(r for r in tool_rows["exp_int8"] if r["mode"] == "bf16")

    def total(rows, key):
        return sum(r[key] for r in rows)

    def entry(name, source, replaces, **fields):
        return dict(name=name, route="cuda", source=f"kuiperllama_tpu_torch/csrc/{source}.cu",
                    replaces=replaces, launches=launches[name], **fields, card=CARD)

    return [
        entry("exp_stream", "exp_kernel", "tools/exp_kernel.py:57",
              max_abs_err=max(r["max_abs_err"] for r in st), ms=total(st, "ms"),
              plain_ms=total(st, "plain_ms"), bound_ms=total(st, "bound_ms"),
              bound_by="bytes",
              # torch.sum reads the same bytes but computes another value
              library_ms=None, yardstick_ms=total(st, "yardstick_ms"),
              floor_ms=total(st, "floor_ms"),
              per="one sweep of the TinyLlama-1.1B shapes that have a stream tile, "
                  "each at its first: " + ", ".join(
                      f"{r['weight']} {r['tk']}x{r['tn']}" for r in st)),
        entry("exp_outscale", "exp_kernel", "tools/exp_kernel.py:86",
              max_abs_err=max(r["max_abs_err"] for r in os_), ms=total(os_, "ms"),
              plain_ms=total(os_, "plain_ms"), bound_ms=total(os_, "bound_ms"),
              bound_by="bytes", library_ms=total(os_, "library_ms"),
              gemm_ms=total(os_, "gemm_ms"),
              per="one sweep of the five TinyLlama-1.1B shapes at M = 8, bf16 x, "
                  "fp32 scales: " + ", ".join(
                      f"{r['weight']} {r['tk']}x{r['tn']}" for r in os_)),
        entry("exp_int8", "exp_int8", "tools/exp_int8.py:47",
              max_abs_err=max(r["max_abs_err"] for r in tool_rows["exp_int8"]),
              ms=bf16["ms"], plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
              bound_by=bf16["bound_by"],
              # no single PyTorch call sums a GEMV over 64 layers
              library_ms=None,
              per="one bf16-mode pass over the tool's stack: L 64, K 4096, N 2048, "
                  "g 64 (every mode's time is in the tools rows)"),
    ]


def kernels_line(gemv, gemm, fused_rows, fused_step, paged_rows, launches_by_path,
                 big_rows, big_step, chunk_rows, chunk_step, tool_rows):
    """One entry per kernel. `launches` is the count on the kernel's main
    path (Llama-2-7B for the GEMV and GEMM, TinyLlama-1.1B for the
    megakernel, the Llama-2-7B engine for paged attention, the Llama-2-7B
    big route for the big-model megakernel, TinyLlama-1.1B's chunk route for
    the chunk kernel); `launches_by_path` has every path's count."""
    from kuiperllama_tpu_torch.config import preset_config

    main_7b = launches_by_path["llama2-7b"]

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches_by_path.items()}

    def entry(name, rows, replaces, per):
        by_bytes = _sum(rows, "bound_bytes_ms") >= _sum(rows, "bound_ops_ms")
        return dict(
            name=name, route="cuda",
            source=f"kuiperllama_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=main_7b[name],
            max_abs_err=max(r["max_abs_err"] for r, _ in rows),
            ms=_sum(rows, "ms"), plain_ms=_sum(rows, "plain_ms"),
            bound_ms=_sum(rows, "bound_ms"),
            bound_by="bytes" if by_bytes else "operations",
            library_ms=_sum(rows, "library_ms"), per=per,
            launches_by_path=by_path(name), card=CARD)

    fused = dict(
        name="fused_decode", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode.py:241",
        launches=launches_by_path["tinyllama-1.1b"]["fused_decode"],
        max_abs_err=max(r["max_abs_err"] for r in fused_rows),
        ms=fused_step["ms"], plain_ms=fused_step["plain_ms"],
        bound_ms=fused_step["bound_ms"], bound_by=fused_step["bound_by"],
        # no single PyTorch call computes a decode step of the layer stack
        library_ms=None,
        per="one TinyLlama-1.1B decode step: 22 layers, INT8 g 256, bf16 "
            "scales and cache, pos 100 in a 256-slot window",
        plan=fused_step["plan"], launches_by_path=by_path("fused_decode"), card=CARD)
    # per engine decode step of Llama-2-7B: one launch per layer at the
    # kernel phase's 7B shapes
    p7 = paged_rows[("llama2-7b", "bf16")]
    n7 = preset_config("llama2-7b").n_layers
    paged = dict(
        name="paged_attention", route="cuda",
        source="kuiperllama_tpu_torch/csrc/paged_attention.cu",
        replaces="kuiperllama_tpu/ops/pallas/paged_attention.py:71",
        launches=launches_by_path["engine llama2-7b"]["paged_attention"],
        max_abs_err=max(r["max_abs_err"] for r in paged_rows.values()),
        ms=n7 * p7["ms"], plain_ms=n7 * p7["plain_ms"], bound_ms=n7 * p7["bound_ms"],
        bound_by=p7["bound_by"], library_ms=n7 * p7["library_ms"],
        per="one Llama-2-7B B = 8 engine decode step: 32 launches, bf16 pools, "
            f"seq_lens {PAGED_LENS}, 128-token pages",
        launches_by_path=by_path("paged_attention"), card=CARD)
    big = dict(
        name="fused_decode_big", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode_big.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode_big.py:147",
        launches=launches_by_path["llama2-7b big"]["fused_decode_big"],
        max_abs_err=max(r["max_abs_err"] for r in big_rows + [big_step]),
        ms=big_step["ms"], plain_ms=big_step["plain_ms"], bound_ms=big_step["bound_ms"],
        bound_by=big_step["bound_by"],
        # no single PyTorch call computes a decode step of the layer stack
        library_ms=None,
        per="one Llama-2-7B decode step: 32 layers, INT8 g 64, bf16 scales and "
            "cache, pos 100 in a 256-slot window",
        launches_by_path=by_path("fused_decode_big"), card=CARD)
    chunk = dict(
        name="fused_decode_chunk", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode_chunk.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode.py:627",
        launches=launches_by_path["tinyllama-1.1b chunk"]["fused_decode_chunk"],
        max_abs_err=max(r["max_abs_err"] for r in chunk_rows + [chunk_step]),
        ms=chunk_step["ms"], plain_ms=chunk_step["plain_ms"],
        bound_ms=chunk_step["bound_ms"], bound_by=chunk_step["bound_by"],
        # no single PyTorch call computes greedy decode steps
        library_ms=None,
        per=f"one TinyLlama-1.1B greedy step of a {CHUNK_STEPS}-step chunk: 22 "
            "layers and the lm_head, INT8 g 256, bf16 scales and cache, from "
            "pos 100 in a 256-slot window",
        plan=chunk_step["plan"], launches_by_path=by_path("fused_decode_chunk"), card=CARD)
    return {"kernels": [
        entry("quant_gemv", gemv, "kuiperllama_tpu/ops/pallas/quant_matmul.py:202",
              "one Llama-2-7B decode token: 32 x (wqkv, wo, w13, w2) + lm_head, "
              "g 256, bf16"),
        entry("quant_gemm", gemm, "kuiperllama_tpu/ops/pallas/quant_matmul.py:132",
              "one Llama-2-7B prefill of 32 tokens: 32 x (wqkv, wo, w13, w2), "
              "fast, g 256, bf16"),
        fused,
        paged,
        big,
        chunk,
        *tool_entries(tool_rows, launches_by_path["tools"]),
    ]}


def build_command():
    """One run of the ahead-of-time build as a child process from the
    checkout's root: (wall seconds, the command's JSON line); fails unless
    it exits 0."""
    import subprocess

    cmd = [sys.executable, "-m", "kuiperllama_tpu_torch.ops.kernels.build"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    print("".join(res.stdout.splitlines(keepends=True)[:-1]), end="", flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {res.returncode}:\n{res.stderr}")
    return seconds, json.loads(res.stdout.splitlines()[-1])


def phase_build():
    """Phase 2: every kernel and runtime library built ahead of time by the
    build command, which a second call finds all cached."""
    from kuiperllama_tpu_torch.ops.kernels import build
    from kuiperllama_tpu_torch.runtime import native

    seconds, first = build_command()
    second_s, second = build_command()
    libraries = sorted(build.sources() + [src.stem for src in native.sources()])
    cached_second = second["built"] == {} and sorted(second["cached"]) == libraries
    left = build.build(build.sources())
    ok = (sorted([*first["built"], *first["cached"]]) == libraries and cached_second
          and left == {})
    emit(dict(phase="build", seconds=seconds,
              per_source_s={k: v for k, v in first["built"].items() if k in build.sources()},
              runtime_s={k: v for k, v in first["built"].items() if k not in build.sources()},
              flags=first["nvcc_flags"], cached_first_call=first["cached"],
              cached_second_call=cached_second, second_call_s=second_s, ok=ok, card=CARD))
    if not ok:
        raise RuntimeError("build phase failed")
    return set(build.BUILD_DIR.glob("lib*.so"))


def phase_built_nothing(libraries):
    """After the last phase: no library appeared in _build/ since phase 2,
    so no phase (nor a child process of one) ran nvcc or g++."""
    from kuiperllama_tpu_torch.ops.kernels import build

    new = sorted(p.name for p in set(build.BUILD_DIR.glob("lib*.so")) - libraries)
    emit(dict(phase="built_nothing", libraries=len(libraries), new_libraries=new,
              ok=not new, card=CARD))
    if new:
        raise RuntimeError(f"libraries built after phase 2: {new}")


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kuiperllama_tpu_torch.utils.profiling import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    CARD = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=CARD, torch=torch.__version__, cuda=torch.version.cuda))

    libraries = phase_build()
    phase_recapture(dev)
    tool_rows, tool_launches = phase_tools(dev)
    gemv, gemm = phase_kernels(dev)
    fused_rows = phase_fused_kernel(dev)
    big_rows = phase_fused_big_kernel(dev)
    chunk_rows = phase_fused_chunk_kernel(dev)
    paged_rows = phase_paged_kernel(dev)
    phase_fixture(dev)
    fixture_cfg, fixture_params, fixture_tokens = phase_engine_fixture(dev)
    launches = {"tools": tool_launches, "llama2-7b": phase_main_path(dev)}
    launches["llama2-7b big"], big_step = phase_big_main_path(dev)
    launches["tinyllama-1.1b"], fused_step, tl_row = phase_fused_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", True)
    launches["qwen2.5-0.5b"], qwen_step, qw_row = phase_fused_main_path(
        dev, "qwen2.5-0.5b", "qwen2.5-0.5b", False)
    launches["tinyllama-1.1b chunk"], chunk_step = phase_chunk_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", True, tl_row)
    launches["qwen2.5-0.5b chunk"], qwen_chunk_step = phase_chunk_main_path(
        dev, "qwen2.5-0.5b", "qwen2.5-0.5b", False, qw_row)
    launches["engine llama2-7b"], _, _ = phase_engine_main_path(
        dev, "llama2-7b", "llama2-7b", profile_eager=True)
    launches["engine tinyllama-1.1b"], _, _ = phase_engine_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", prefill_chunk=256, long_prompt=768)
    phase_packed_prefill(dev)
    phase_server(dev, fixture_cfg, fixture_params, fixture_tokens)
    phase_native(dev)
    launches["ppl"] = phase_ppl(dev)
    launches["hf qwen2.5-0.5b"] = phase_hf(dev)
    launches.update(phase_bench(dev))
    launches.update(phase_tools17(dev))
    launches.update(phase_parallel(dev))
    phase_built_nothing(libraries)
    emit(kernels_line(gemv, gemm, fused_rows + [fused_step, qwen_step],
                      fused_step, paged_rows, launches, big_rows, big_step,
                      chunk_rows + [qwen_chunk_step], chunk_step, tool_rows))
    print(CARD, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report and fail: no result line after a failed phase
        traceback.print_exc()
        code = 1
    sys.exit(code)
