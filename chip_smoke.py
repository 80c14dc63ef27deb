#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's paths through the entry points a user calls, and holds
each hand-written CUDA kernel against its plain PyTorch version: Heat2D
under the HDOT schedule at a 16384 x 16384 float32 grid (1 GiB a buffer),
phases 2-6; serving at the published widths in bf16 with random weights
from a seeded generator: Qwen3-8B (36 layers, d_model 4096, GQA 32/8, head
dim 128, vocab 151936), phases 7-9; RecurrentGemma-2B (26 layers, d_model
2560, RG-LRU width 2560, local attention 10/1 heads of 256 with a 2048
window, d_ff 7680, vocab 256000, tied), phases 10 and 12-13; Mamba-2 780M
(48 layers, d_model 1536, 48 SSD heads of 64, state 128, chunk 256, vocab
50280), phases 11 and 14-15; the paper's other two applications, RK3 and
HPCCG's CG, phases 16-17; training InternLM2-1.8B (24 layers, d_model 2048,
vocab 92544) under the gradient-bucket schedule, phases 18-19, and under
streaming ZeRO-3, phase 22; serving Qwen3-30B-A3B (48 layers, d_model
2048, 32/4 heads of 128 with qk-norm, 128 experts of width 768, top-8,
vocab 151936; 30.5 B parameters, 3.35 B active), phases 20-21, run after
phase 15; Whisper-base (6 + 6 layers, d_model 512, 8 heads of 64, 1500
frames, vocab 51865, tied) served and trained, phases 23-24; the
recurrent scans' backward kernels, and Mamba-2 780M and RecurrentGemma-2B
trained at their published widths, phases 26-27; Qwen3-8B through the
serving cells (``build_cell``), phase 29; and LLaVA-NeXT-34B (60
layers, d_model 7168, 56/8 heads of 128, d_ff 20480, vocab 64000, 576
patches; 34.4 B parameters) served, phase 25, last:

  1. build    nvcc builds every kernel of all paths from the checkout's
              sources (four: the LRU and SSD sources hold their backward
              kernels too), one process per source, all started together;
              prints the build seconds, ptxas's registers and spills (and
              any wgmma wait or fence it had to inject), and the card's
              name and power limit as nvidia-smi gives them.
  2. kernel   heat2d_sweep's CUDA kernel against its plain version on the
              same inputs: f32 tile (256, 256) with sweeps 1 and 4, tile
              (128, 64) with a random halo ring, and bf16, all on the
              kernel's path "cluster_smem" (a tile held in the shared memory
              of a thread-block cluster), and f32 tile (1024, 1024), too
              large for that, on path "global"; each row names its path and
              cluster size. f32 must be
              bit-equal (same IEEE operations in the same order, no FMA);
              bf16 within one bf16 ulp after the cast. Kernel and plain
              times are CUDA-event means of 10 back-to-back runs, the
              median of 3 such batches, after warm-up;
              bound_ms is the least time for the bytes the sweep must move.
  3-5. main   launch counts set to 0, then: heat2d_solve for 100 iterations
              on a (1,) slab mesh and a (1, 1) grid mesh in both schedules
              (hdot must equal two_phase exactly, the residual must not
              rise); heat2d_sweep_sharded on the (1, 1) mesh (must equal
              heat2d_sweep with a zero ring, and launch the kernel);
              heat2d_solve_rebalanced with a skewed synthetic chunk cost
              (must re-cut, and equal heat2d_solve run segment by segment on
              the same cuts, bit for bit). Counts read right after.
  6. profile  a separate traced run of 5 solver steps per schedule on the
              (1, 1) mesh: device time by CUDA kernel and the device's idle
              share of the traced window.
  7. flash    flash_attention's CUDA kernel against its plain version at
              the serving paths' shapes (Qwen3-8B: an admission prefill, a
              wave prefill, a ragged prompt, a 1024 window at 4096;
              RecurrentGemma-2B at head dim 256, MQA 10/1: a 2048 prefill,
              a 2048 window at 4096, a ragged prompt; Qwen3-30B-A3B's
              admission prefill at GQA group 8, 32/4 heads; Whisper's
              encoder, (8, 1500, 8/8, 64); LLaVA's prefill, (4, 1088,
              56/8, 128), GQA group 7) and an f32 non-causal case; tolerance 2e-2 in bf16, 2e-5 in f32 (the JAX
              suite's). Kernel, plain and library (scaled_dot_product_
              attention, timed here only) times come from CUDA events
              around back-to-back runs;
              bound_ms is the larger of 4·b·hq·d·(visible pairs) flops over
              the tensor-core peak and the bytes of q, k, v and o over HBM.
  8. serve    launch counts set to 0, then Qwen3-8B serves 16 requests
              (prompts uniform in 128-2048 from numpy seed 0, 64 new tokens
              each) on BatchServer(slots=8, max_len=2176), through
              run_continuous and then run_wave, counts read after each:
              flash must launch 36 times per prefill and every request gets
              its 64 tokens; then run_continuous once more with
              decode_step_fn = the TP decode step (models/decode_tp.py) on
              a one-rank ("data", "model") mesh: no ring, but the step's
              fused weight slices and per-row cache writes at full width
              (row "continuous_tp", counted: flash only in the prefills).
              Then: last-token prefill logits under flash and
              under dense attention for one 2048-token prompt, teacher-forced
              decode logits of two requests in the 8-slot layout against a
              1-slot one, the same 8-slot steps through the TP step against
              model.decode_step (within the bf16 bounds; the TP run's tokens
              equal to the continuous run's are reported), and the reduced
              config on the card against the CPU.
  9. serve_profile  a traced admission prefill and a traced window of 5
              decode steps: top device ops and the device's idle share.
 10. lru      lru_scan's CUDA kernel against its plain version: (1, 2048,
              2560) f32 (a RecurrentGemma admission prefill), (8, 1000,
              2560) with a random h0, a width of 100, length 1, bf16 b;
              tolerance 1e-5 (the JAX suite's), bf16 h within one bf16 ulp
              plus 1e-5; bound_ms from the bytes (a, b in, h out);
              kernel_ms times the wrapper, as for every kernel, and
              launch_ms the kernel's C function alone, called with
              arguments prepared once into outputs made once (the kernel
              takes about as long as the wrapper's host work); each row
              names the launch shape (blocks of a cluster along the
              sequence, warps a block, steps a thread).
 11. ssd      ssd_scan's CUDA kernel against its plain version: (1, 2048,
              48, 64, 128) chunk 256 with bf16 x/B/C and f32 dt/A (a
              Mamba-2 admission prefill), a ragged 1000, a small all-f32
              case; y and the final state of ops.ssd within 5e-2 (bf16) or
              1e-4 (f32), the JAX suite's; kernel_ms and plain_ms time the
              within-chunk terms alone; bound_ms is the larger of their
              bytes over HBM and the flops of the causal half over the peak
              for the input type (bf16 tensor cores, or f32 CUDA cores);
              both versions' y_diag error against a float64 computation is
              reported, and with bf16 inputs the kernel's must not exceed
              the plain version's.
 12. serve    RecurrentGemma-2B as phase 8 (same traffic and checks; the
              counts: 18 lru_scan and 8 flash launches per prefill), plus a
              2047-token prefill and one decode step against the
              2048-token prefill, in bf16 and (the model in float32)
              within 1e-3.
 13. serve_profile  as phase 9, for RecurrentGemma-2B.
 14. serve    Mamba-2 780M, scanned layout, as phase 12 (48 ssd_scan
              launches per prefill; no attention, so no flash-vs-dense;
              the teacher-forced decode holds all 8 requests, each row
              reported bit-identical or not).
 15. serve_profile  as phase 9, for Mamba-2 780M.
 16. rk3      rk3_solve (the paper's CREAMS-like RK3, §4.2: periodic
              8th-order direction-split diffusion, width-4 halos) on the
              (1,) slab mesh and the (1, 1) grid mesh, both schedules, f32
              from a numpy-seeded normal grid, at the paper's Sod tube
              (20, 20, 7000) and at (256, 256, 2048), 512 MiB a buffer:
              steps/s per mesh and schedule, the peak memory; hdot must
              equal two_phase bit for bit, the mean stay within 1e-4, and a
              small grid on the card equal the port on the CPU within the
              JAX suite's RK3 tolerance (rtol 1e-5, atol 1e-6). Then one
              traced step per schedule at the large size: top device ops
              and the device's idle share.
 17. hpccg    hpccg_solve (HPCCG's CG on the 27-point operator, §4.3) on
              the (1,), (1, 1) and (1, 1, 1) meshes, both schedules, f32
              b of (256, 256, 256) from a numpy seed, 50 iterations:
              iterations/s; hdot must equal two_phase bit for bit (x and
              the history), the history fall, ||A x - b|| / ||b|| is
              reported, and a small problem on the card must match the CPU
              port within 1e-4 on the history. Then a traced window of 2
              iterations per schedule. Neither solver runs a kernel of the
              port (the JAX package has no Pallas kernel on these paths):
              the four launch counts must not move in phases 16-17.
 18. train    InternLM2-1.8B at its published widths (24 layers, d_model
              2048, 16/8 heads of 128, d_ff 8192, vocab 92544), bf16,
              random weights from seed 0, scanned layers, remat "full",
              global batch 8 x 2048 tokens from SyntheticLMDataset seed 0,
              AdamW with the JAX package's defaults and warm-up
              max(1, steps // 10), as launch/train.py's build_run sets it
              up: a warm-up step and 4 timed steps (host clock around each
              step's read-back) in three setups, no mesh and a one-rank
              ("data",) mesh under two_phase and under hdot (the buckets
              filled and issued during the backward). Per setup: step ms,
              tokens/s, model FLOP utilisation (6·N·tokens, N the
              parameters less the embedding, over 989 TFLOP/s; the dense
              attention's and the remat's FLOPs beside it), peak memory,
              losses and grad norms. Checks: every loss and norm finite;
              the first loss within 0.5 of ln V + 1/2 (the loss of
              unit-variance logits, which rms-normed activations through
              an N(0, 1/d_model) lm_head give at init); the three setups'
              losses, grad norms and final parameters equal bit for bit;
              no kernel of the port launched (the JAX trainer runs dense
              attention, and the fused cross-entropy is plain array code).
              Then the reduced config in f32 on the card against the CPU
              (2 steps from the same parameters, hdot, 2 microbatches,
              rtol 1e-4), and a resume check (4 steps straight against 2,
              a checkpoint under build/, a new Trainer restored, 2 more:
              bit-equal).
 19. train_profile  one traced training step (hdot, one-rank mesh) after a
              warm-up: device time by op family (bf16 GEMMs, the dense
              attention's f32 GEMMs, softmax, the fused cross-entropy's
              logits and gradients, the AdamW pass, copies, other
              elementwise), the top kernels and the device's idle share.
 20. serve    Qwen3-30B-A3B as phase 8 (the dense capacity dispatch of
              the JAX package: capacity factor 1.25; 48 flash launches
              per prefill), after the earlier models are freed; the setup
              row adds the init's seconds and peak memory, each serve row
              the routed assignments of its prefills and how many capacity
              dropped. The checks as phase 8's, with the MoE forms that
              serve_phase's docstring derives (each comparison reports the
              share of routing decisions that differ, and the 2047 + 1
              comparison the last token's drops; the bounds hold where the
              two runs compute the same function), and whether the f32
              router product of a decode row is bit-identical in an 8-row
              and a 1-row GEMM.
 21. serve_profile  as phase 9, for Qwen3-30B-A3B, by op family: the
              MoE dispatch (router, top-k, load statistics, one-hot/cumsum
              tables, the gather into the slots and the combine), the
              expert GEMMs and their elementwise, the other GEMMs, copies
              and cache writes, other elementwise, and the port's kernels
              (flash attention, launched through ctypes, read by name).
 22. train_zero3  InternLM2-1.8B at its published widths as phase 18
              (bf16, seed 0, 8 x 2048 tokens, phase 18's data and AdamW,
              remat "full") under ZeRO-3 on a one-rank ("data",) mesh,
              unrolled, with the unfused log-softmax loss (the reference's
              comparator pair): gathering all on the per-layer layout
              (bucket_order "layer") and streaming (each layer's bucket
              gathered inside its remat region, regathered in the
              backward, its gradient reduce-scattered there), a warm-up
              step and 4 timed steps each. Per setup: step ms, tokens/s,
              MFU as phase 18, peak memory, the parameter-shard bytes
              (layout.shard_bytes()). Checks: the two setups' losses, grad
              norms, flat params and both moments bit-equal; the first
              loss bit-equal to phase 18's trainer setup (one-rank mesh,
              hdot, replicated) run one step with phase 22's model options
              (phase 18's own run is scanned with the fused loss, so it
              draws other values and sums its loss otherwise), the first
              grad norm within rtol 1e-5 of it (summed by flat buffer, not
              by leaf); no kernel of the port launched. Then the reduced
              config in f32, streaming, on the card against the CPU (2
              steps, rtol 1e-4), and a checkpoint of the reduced config
              written under a 2-bucket layout, restored through
              restore_fsdp_checkpoint under the per-layer layout into a
              streaming and a gathering-all trainer (each bit-equal to the
              writer's state re-cut), 2 more steps on each: bit-equal.
 23. serve    Whisper-base at its published widths, bf16, seed 0,
              through model.prefill / model.decode_step (the server
              refuses the family, as the reference's does): 8 requests,
              stub frames (8, 1500, 512) from numpy seed 0 times 0.02,
              4-token prompts, 200 new tokens each, greedy, max_len 448,
              one prefill and 199 decode steps at a shared position
              (counted: flash 12 launches in the prefill, 6 encoder and 6
              decoder layers, none in decode). Encoder and decoder prefill
              ms, decode-step ms, output tokens/s, peak memory; the
              cross-attention caches must be bit-unchanged by decode.
              Checks: the prefill's and 8 teacher-forced decode steps'
              logits under flash against dense attention within the bf16
              bounds; a traced prefill and 5 decode steps.
 24. train    Whisper-base at its published widths as build_run sets it
              up (bf16, seed 0, remat "full", AdamW, the synthetic data
              pipeline, the reference's float32 stub frames, dense
              attention): 16 x 448 text tokens and 16 x 1500 frames a
              step, a warm-up and 4 timed steps, then one traced step by
              op family. MFU on 6·(N_enc·1500 + N_dec·448)·16 (the encoder
              and the cross-attention K/V projections run over the
              frames). Checks: losses finite, the first loss within rtol
              1e-3 of the CPU's (same parameters and batch, forward
              only), no kernel of the port launched.
 25. serve    LLaVA-NeXT-34B as phase 23 (4 requests, stub patches (4,
              576, 7168), 512-token prompts, 64 new tokens, max_len 1152;
              decode positions from 576 + 512; flash 60 launches a
              prefill at GQA group 7; 4 teacher-forced steps), run last,
              after everything before it is freed.
 26. recurrent_bwd  the scans' backward kernels against their plain
              backwards (autograd of the plain versions) on the same
              inputs and random cotangents, at phase 27's shapes:
              lru_scan_bwd at (8, 2048, 2560) f32, without and with h0
              (and a cotangent of h_last), within 1e-5; ssd_chunk_bwd at
              (8, 2048, 48, 64, 128) chunk 256 with bf16 and with f32 x/B/C,
              within 5e-2 and 1e-4 (the forward's tolerances); each
              gradient's error relative to its own largest magnitude, two
              calls bit-equal; kernel_ms (CUDA events), plain_ms (the plain
              backward alone, its forward's graph built once), bound_ms
              (the bytes of inputs, cotangents and gradients over HBM, or
              the causal half's products at the input type's peak).
 27. train    Mamba-2 780M (scanned) and RecurrentGemma-2B at their
              published widths as phase 18 (bf16, seed 0, remat "full",
              AdamW, 8 x 2048 tokens of phase 18's data, no mesh): a
              warm-up and 4 timed steps each, the scans' wrapper counts set
              to 0 just before and read just after. Step ms, tokens/s, MFU
              (6·N·tokens, N less the embedding: it misses the SSD's
              within-chunk products, the scans and a tied head's logits),
              peak memory, losses and grad norms. Checks: losses and norms
              finite, the first loss within 1 of ln V; exactly 2 forward
              launches (the remat recompute runs the layer again) and 1
              backward launch a recurrent layer a step (Mamba-2 96 + 48,
              RecurrentGemma 36 + 18), no flash launch (dense attention),
              no call of a plain scan. Then one traced step by op family,
              with the port's kernels by name (the SSD backward's nine).
 28. tp_scans  the scans forward and backward at the blocks a rank of
              tensor-parallel training over 4 cards gives them: ssd_scan
              and ssd_chunk_bwd at (8, 2048, 12, 64, 128) and (4, 2048,
              24, 64, 128) bf16 chunk 256 (Mamba-2 780M's 48 heads at (1,
              4) and (2, 2)), lru_scan and lru_scan_bwd at (8, 2048, 640)
              and (4, 2048, 1280) f32 (RecurrentGemma-2B's width 2560),
              each against its plain version with phases 10-11's and 26's
              tolerances, times and bounds; run after phase 27.
 29. cells    Qwen3-8B at its published widths through the serving cells
              (``build_cell`` prefill and decode, ``cell_step``) on a
              one-rank ("data", "model") mesh: 4 prompts of 2048 tokens
              into 32768-slot rings (the decode_32k shape's ring at batch
              4, 19.3 GB), then 32 teacher-forced decode steps; counted
              (36 flash launches, nothing else); every logit bit-equal to
              model.prefill / decode_step on the same tree. Prefill
              tokens/s, decode ms at the 32768-slot ring, GiB of
              parameters and rings, the peak; run after phase 28, before
              phase 25. Phase 7 times flash alone at a rank's block of
              Mixtral-8x7B's prefill cell on (1, 4), (8, 3968, 8/2, 128).
 33. lint     the schedule linter (``python -m
              repro_torch.analysis.schedule_lint``'s targets) with every
              target's tensors on the card: each runs once for rank 0 of
              a fake process group of 4 or 8 ranks (the calls recorded,
              not made), its issue-order log linted; every canonical
              target must pass and every broken one trip exactly its own
              rules; the counts on one line; under 60 s. Run after phase
              32, before phase 25.

Each phase prints one JSON line (a serve phase one per scheduler and one of
checks); then the nvidia-smi line, the kernels line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without CUDA, or without the repository beside it, the script
exits non-zero before printing any result.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
N = 16384                   # global grid edge: 16384^2 f32 = 1 GiB
ITERS = 100                 # heat2d_solve iterations per mode
PROFILE_ITERS = 5           # solver steps in each traced window
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
KERNEL_SOURCE = "src/repro_torch/kernels/heat2d/csrc/heat2d.cu"
REPLACES = "src/repro/kernels/heat2d/heat2d.py:72"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:75"
LRU_SOURCE = "src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu"
LRU_REPLACES = "src/repro/kernels/lru_scan/lru_scan.py:44"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:50"
FLASH_CASES = [  # (dtype, b, s_q, s_k, hq, hkv, d, causal, window)
    ("bf16", 1, 2048, 2048, 32, 8, 128, True, None),   # admission prefill
    ("bf16", 8, 2048, 2048, 32, 8, 128, True, None),   # wave prefill
    ("bf16", 1, 1000, 1000, 32, 8, 128, True, None),   # ragged prompt
    ("bf16", 1, 4096, 4096, 32, 8, 128, True, 1024),   # window 1024
    ("f32", 2, 256, 256, 8, 2, 64, False, None),        # f32, no mask
    ("bf16", 1, 2048, 2048, 10, 1, 256, True, 2048),   # RecurrentGemma
    ("bf16", 1, 4096, 4096, 10, 1, 256, True, 2048),   # window 2048
    ("bf16", 1, 1000, 1000, 10, 1, 256, True, 2048),   # ragged prompt
    ("bf16", 1, 2048, 2048, 32, 4, 128, True, None),   # GQA group 8 (MoE)
    ("bf16", 8, 1500, 1500, 8, 8, 64, True, None),     # Whisper encoder
    ("bf16", 4, 1088, 1088, 56, 8, 128, True, None),   # LLaVA, GQA group 7
    # Mixtral-8x7B's prefill cell on a rank of (1, 4): 8 prompts of 3968
    # tokens, its 32/8 heads cut 4 ways, the 4096-token window
    ("bf16", 8, 3968, 3968, 8, 2, 128, True, 4096),
]
LRU_CASES = [  # (b, l, w, b dtype, h0)
    (1, 2048, 2560, "f32", False),     # RecurrentGemma admission prefill
    (8, 1000, 2560, "f32", True),      # ragged, with a carried state
    (2, 300, 100, "f32", True),        # width not a multiple of 32
    (4, 1, 2560, "f32", True),         # length 1
    (1, 2048, 2560, "bf16", False),    # bf16 b (and h)
]
LRU_TOL = 1e-5                          # tests/test_kernels.py's
SSD_CASES = [  # (b, l, h, p, n, chunk, dtype)
    (1, 2048, 48, 64, 128, 256, "bf16"),   # Mamba-2 admission prefill
    (1, 1000, 48, 64, 128, 256, "bf16"),   # ragged: padded with dt = 0
    (2, 256, 4, 32, 16, 64, "f32"),        # small, all f32
]
SSD_TOL = {"bf16": 5e-2, "f32": 1e-4}   # tests/test_kernels.py's
# phase 26: the scans' backward kernels at phase 27's training shapes
LRU_BWD_CASES = [(8, 2048, 2560, False),   # RecurrentGemma-2B's a and b
                 (8, 2048, 2560, True)]    # with h0 and a cotangent of h_last
SSD_BWD_SHAPE = (8, 2048, 48, 64, 128, 256)   # Mamba-2 780M: b, l, h, p, n,
SSD_BWD_DTYPES = ("bf16", "f32")              # chunk; bf16 is the training's
# phase 27: the recurrent families trained at full width
RECURRENT_TRAIN = ("mamba2-780m", "recurrentgemma-2b")
# phase 28: the scans at the rank-local shapes of tensor-parallel training
# over 4 cards (8 x 2048 tokens a step): Mamba-2 780M's 48 SSD heads and
# RecurrentGemma-2B's LRU width 2560 cut 4 ways at (1, 4) ("data", "model")
# and 2 ways, over a DP replica's 4 rows, at (2, 2)
TP_SSD_SHAPES = [(8, 2048, 12, 64, 128, 256), (4, 2048, 24, 64, 128, 256)]
TP_LRU_SHAPES = [(8, 2048, 640), (4, 2048, 1280)]
# phase 29: the serving cells (build_cell) on a one-rank ("data", "model")
# mesh: Qwen3-8B, 4 prompts of 2048 tokens into 32768-slot rings (the
# decode_32k shape's ring at batch 4), 32 decode steps
CELLS = dict(arch="qwen3-8b", batch=4, prompt=2048, ring=32768, steps=32)
# phase 30: Qwen3-30B-A3B trained at its published widths on one card, 4 of
# its 48 layers (the depth cut: all 48 hold ~366 GB of training state),
# unrolled, 8 x 2048 tokens a step, remat "full" then "dots"
MOE_TRAIN = dict(arch="qwen3-moe-30b-a3b", layers=4, steps=4)
MOE_REMATS = ("full", "dots")
# phase 31: Qwen3-8B's prefill_32k cell (build_cell picks blockwise
# attention above 8192 tokens) on a one-rank ("data", "model") mesh, 1
# prompt of the shape's 32 (the batch cut)
BLOCKWISE = dict(arch="qwen3-8b", shape="prefill_32k", batch=1)
# serving phases: (arch, phase number of the serve rows, of the trace)
SERVE_ARCHS = [("qwen3-8b", 8, 9), ("recurrentgemma-2b", 12, 13),
               ("mamba2-780m", 14, 15), ("qwen3-moe-30b-a3b", 20, 21)]
# launches per prefill the published configs must give (block_kinds)
PER_PREFILL = {"qwen3-8b": {"flash_attention": 36},
               "recurrentgemma-2b": {"lru_scan": 18, "flash_attention": 8},
               "mamba2-780m": {"ssd_scan": 48},
               "qwen3-moe-30b-a3b": {"flash_attention": 48},
               "whisper-base": {"flash_attention": 12},   # 6 enc + 6 dec
               "llava-next-34b": {"flash_attention": 60}}
FLASH_TOL = {"bf16": 2e-2, "f32": 2e-5}  # tests/test_kernels.py's
# names of the port's CUDA kernels in a trace (their __global__ functions)
PORT_KERNELS = ("tile_sweep", "half_sweep", "flash_fwd", "lru_scan_kernel",
                "ssd_chunk", "ssd_bwd")
SLOTS, MAX_LEN, REQUESTS, NEW_TOKENS = 8, 2176, 16, 64
# Bounds on |logit difference| between two bf16 runs of a full-width model
# that differ only in where they round (flash vs dense attention; the
# batch-8 vs batch-1 decode GEMMs; a chunked prefill vs the step-by-step
# recurrence of decode). Logits here have a standard deviation of about 1
# (random weights, rms-normed activations). One bf16 rounding is 2^-9
# relative, and 26 to 48 residual layers carry a difference made in the
# first layer forward without damping it, so rounding alone moves a few
# percent of a logit on average and a few tenths at the worst of the
# vocabulary's entries. A broken kernel (a wrong mask, a missed tile, a
# wrong head, a state that is not carried) moves logits by a whole standard
# deviation on average.
LOGIT_MEAN_BOUND = 0.1
LOGIT_MAX_BOUND = 1.0
# In float32 a recurrent model's chunked prefill (the SSD or LRU kernel)
# and its step-by-step decode recurrence must give the same last-token
# logits within the JAX suite's tolerance for the chunked SSD against the
# sequential recurrence (tests/test_kernels.py, 1e-3).
F32_RECURRENCE_TOL = 1e-3


# RK3 grids: the paper's Sod tube (Table 4, benchmarks/table4_creams.py)
# and a grid a one-card user would call real; steps per timed solve
RK3_CASES = [((20, 20, 7000), 20), ((256, 256, 2048), 4)]
RK3_DT = 0.01
RK3_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_stencil_apps.py's
HPCCG_N, HPCCG_ITERS = 256, 50
HPCCG_RTOL = 1e-4                       # tests/test_stencil_apps.py's


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2, batches: int = 3) -> float:
    """CUDA-event time of one call of `fn`: `reps` calls back to back
    between two events (so the host's launch work overlaps the device's),
    divided by `reps`; the median of `batches` such runs after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def sweep_bound_ms(nx: int, ny: int, itemsize: int, sweeps: int,
                   halo: bool):
    """Least time for one sweep call: read u once and write out once (plus
    the halo strips), against 5 f32 flops per cell per sweep."""
    nbytes = 2 * nx * ny * itemsize + (4 * (nx + ny) if halo else 0)
    ops = 5 * nx * ny * sweeps
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def short_name(key: str) -> str:
    """A demangled kernel name without its return type, anonymous
    namespace and parameter list: ``ssd_bwd::bwd_rows<float, 64>``."""
    key = key.replace("(anonymous namespace)::", "")
    key = key[5:] if key.startswith("void ") else key
    return key.split("(")[0][:80]


def dev_us(e):
    """A profiler entry's own device time, in microseconds."""
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


def traced(fn) -> dict:
    """Run `fn` once under torch.profiler (after the caller's warm-up):
    device time per CUDA kernel (the 8 largest, and every kernel of the
    port's sources), and the device's busy time against the wall clock of
    the traced window (which the tracing itself lengthens, so the idle
    share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    ours = [e for e in kernels if any(k in e.key for k in PORT_KERNELS)]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": e.key[:100], "count": e.count,
                             "ms": dev_us(e) / 1e3} for e in top],
            "port_kernels": [{"name": e.key[:100], "count": e.count,
                              "ms": dev_us(e) / 1e3} for e in ours]}


def profile_solve(solve, u0, mesh, mode: str, card: str) -> dict:
    """A separate traced run of PROFILE_ITERS solver steps on the (1, 1)
    mesh (the timed runs above are untraced)."""
    solve(u0, mesh, ("rows", "cols"), 1, mode)
    row = {"phase": "profile", "mesh": "1x1", "mode": mode,
           "iters": PROFILE_ITERS}
    row.update(traced(lambda: solve(u0, mesh, ("rows", "cols"),
                                    PROFILE_ITERS, mode)))
    row["gpu"] = card
    return row


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       (e - 8).to(torch.int32))


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible (positions arange)."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_case(flash_ops, dev, card, dtype_name, b, sq, sk, hq, hkv, d,
               causal, window) -> dict:
    """The flash kernel against its plain version (and SDPA's time) at one
    shape: CUDA-event times (time_ms); bound from the visible pairs."""
    import torch.nn.functional as F

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(sq + 7 * b)
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype)
    got = flash_ops.flash_attention(q, k, v, causal, window, "kernel")
    want = flash_ops.flash_attention(q, k, v, causal, window, "plain")
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err, tol = float(diff.max()), FLASH_TOL[dtype_name]
    check(bool(torch.isfinite(got).all()), f"flash: non-finite output {sq}")
    check(bool((diff <= tol + tol * want.float().abs()).all()),
          f"flash kernel off plain by {err} at {(b, sq, sk, hq, hkv, d)}")
    del diff
    del got, want
    k_ms = time_ms(lambda: flash_ops.flash_attention(q, k, v, causal, window,
                                                     "kernel"))
    p_ms = time_ms(lambda: flash_ops.flash_attention(q, k, v, causal, window,
                                                     "plain"), reps=3)
    # the library's attention on the same inputs, (b, h, s, d) views; a
    # window that hides a key needs an explicit mask (True = attend)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window is not None and window < max(sq, sk):
        qp = torch.arange(sq, device=dev)[:, None]
        kp = torch.arange(sk, device=dev)[None, :]
        mask = (kp > qp - window) & ((kp <= qp) if causal else True)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True))
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * q.element_size()
    t_ops = flops / (BF16_FLOPS if dtype_name == "bf16" else F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "flash", "dtype": dtype_name,
           "shape": [b, sq, sk, hq, hkv, d], "causal": causal,
           "window": window, "max_abs_err": err, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "kernel_tflops": flops / k_ms / 1e9,
           "gpu": card}
    emit(row)
    return row


class StepTimer:
    """Times each call of a model entry point on the host clock, ending in a
    synchronize (the server reads the chosen ids back every step anyway)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.calls.append(time.perf_counter() - t0)
        return out


def counted_wrappers():
    """{name: the kernel wrapper whose ``launches`` counts its kernel}."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"flash_attention": flash_ops.flash_attention,
            "lru_scan": lru_ops.lru_scan, "ssd_scan": ssd_ops.ssd}


def per_prefill(cfg) -> dict:
    """Kernel launches one prefill makes: one a layer of each kind (and
    one an encoder layer)."""
    from repro_torch.models.transformer import ATTN_KINDS, block_kinds

    kinds = block_kinds(cfg)
    enc = cfg.encdec.enc_layers if cfg.family == "encdec" else 0
    got = {"flash_attention": sum(k in ATTN_KINDS for k in kinds) + enc,
           "lru_scan": kinds.count("rglru"), "ssd_scan": kinds.count("ssm")}
    return {k: v for k, v in got.items() if v}


class MoeProbe:
    """While entered, wraps ``repro_torch.models.moe``'s ``_route`` and
    ``_dispatch_tables``: counts, on the device, the routed assignments of
    every prefill and those that capacity dropped (decode never drops: a
    decode group is one token, with capacity k), and, while ``record`` is
    set, keeps each call's expert ids (B, S, k) and capacity mask."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, (moe._route, moe._dispatch_tables)
        self.record, self.assign, self.keep = False, [], []
        self.dropped, self.routed = 0, 0

    def __enter__(self):
        route, tables = self.orig

        def _route(x, router, k):
            out = route(x, router, k)
            if self.record:
                self.assign.append(out[2])
            return out

        def _tables(assign, e, c):
            out = tables(assign, e, c)
            if assign.shape[1] > 1:
                self.dropped = self.dropped + (~out[2]).sum()
                self.routed += out[2].numel()
            if self.record:
                self.keep.append(out[2])
            return out

        self.moe._route, self.moe._dispatch_tables = _route, _tables
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._dispatch_tables = self.orig

    def take(self):
        """The recorded (expert ids, masks) since the last take."""
        out = (self.assign, self.keep)
        self.assign, self.keep = [], []
        return out


def routing_differs(a: list, b: list, layers: int) -> dict:
    """How many of the (token, layer, k) routing decisions of two runs
    differ (equal-length lists of expert ids, `layers` a forward), and
    the share that differs in each layer (over all forwards)."""
    check(len(a) == len(b), f"routing: {len(a)} vs {len(b)} calls")
    n = sum(x.numel() for x in a)
    per = [int((x != y).sum()) for x, y in zip(a, b)]
    by_layer = [0.0] * layers
    for i, (d, x) in enumerate(zip(per, a)):
        by_layer[i % layers] += d / x.numel() / (len(a) // layers)
    first = next((i for i, v in enumerate(by_layer) if v > 0), None)
    return {"decisions": n, "differ": sum(per), "share": sum(per) / max(n, 1),
            "first_layer_differing": first,
            "share_by_layer": [round(v, 4) for v in by_layer]}


def serve_run(model, params, prompts, scheduler: str, dev, card,
              phase: int, decode_step_fn=None) -> dict:
    """One counted run of a main serving path: every kernel count is set to
    0 just before and read just after. `scheduler` "wave" runs run_all,
    any other run_continuous, which decodes through `decode_step_fn` (the
    TP step) where one is given."""
    from repro_torch.runtime.server import BatchServer, Request

    prefill = StepTimer(model.prefill)
    decode = StepTimer(decode_step_fn or model.decode_step)
    server = BatchServer(model, params, slots=SLOTS, max_len=MAX_LEN,
                         decode_step_fn=decode if decode_step_fn else None)
    for pr in prompts:
        server.submit(Request(prompt=pr, max_new_tokens=NEW_TOKENS))
    model.prefill = prefill
    if decode_step_fn is None:
        model.decode_step = decode
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in wrappers.values():
        fn.launches = 0
    moe = model.cfg.family == "moe"
    with MoeProbe() if moe else contextlib.nullcontext() as probe:
        t0 = time.perf_counter()
        served = (server.run_all() if scheduler == "wave"
                  else server.run_continuous())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    del model.prefill                         # back to the class's methods
    if decode_step_fn is None:
        del model.decode_step
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_prefills = server.stats["prefills"]
    check(len(served) == len(prompts), f"{scheduler}: served {len(served)}")
    check(all(len(r.output) == NEW_TOKENS for r in served),
          f"{scheduler}: a request missed its {NEW_TOKENS} tokens")
    check(all(0 <= t < model.cfg.vocab_size for r in served
              for t in r.output), f"{scheduler}: token id out of range")
    per = per_prefill(model.cfg)
    for name in wrappers:
        want = per.get(name, 0) * n_prefills
        check(launches[name] == want,
              f"{model.cfg.name} {scheduler}: {launches[name]} {name} "
              f"launches for {n_prefills} prefills, expected {want}")
    prompt_tokens = sum(len(p) for p in prompts)
    out_tokens = sum(len(r.output) for r in served)
    row = {"phase": "serve", "n": phase, "arch": model.cfg.name,
           "scheduler": scheduler,
           "requests": len(served), "prefills": n_prefills,
           "decode_steps": server.stats["decode_steps"],
           "prompt_tokens": prompt_tokens, "output_tokens": out_tokens,
           "wall_s": wall, "prefill_s": sum(prefill.calls),
           "decode_s": sum(decode.calls),
           "prefill_tokens_per_s": prompt_tokens / sum(prefill.calls),
           "output_tokens_per_s": out_tokens / wall,
           "decode_step_ms_median": 1e3 * statistics.median(decode.calls),
           "peak_mem_gib": peak,
           "launches": {k: v for k, v in launches.items() if k in per},
           "gpu": card}
    if moe:   # over the run's prefills (every layer's assignments)
        row["routed_assignments"] = probe.routed
        row["capacity_dropped"] = int(probe.dropped)
        row["dropped_share"] = int(probe.dropped) / max(probe.routed, 1)
    emit(row)
    return {"row": row, "served": {r.rid: r.output for r in served}}


def teacher_forced(model, params, prompts, forced, slots: int, rows, dev,
                   decode=None):
    """Decode logits of slots `rows` when every slot of a `slots`-slot cache
    is admitted from `prompts` (batch-1 prefills) and fed `forced` tokens,
    through `decode` (default ``model.decode_step``)."""
    from repro_torch.runtime.server import (
        _mark_prefill_tail,
        _scatter_slot,
        make_slot_caches,
    )

    caches = make_slot_caches(model, slots, MAX_LEN, dev)
    for i, pr in enumerate(prompts):
        _, pc = model.prefill(params, {"tokens": torch.tensor([pr],
                                                              device=dev)},
                              max_len=MAX_LEN)
        _scatter_slot(caches, _mark_prefill_tail(pc, len(pr)), i, slots)
    pos = torch.tensor([len(p) for p in prompts], device=dev)
    steps = min(len(f) for f in forced) - 1
    out = []
    for n in range(steps):
        tok = torch.tensor([[f[n]] for f in forced], device=dev)
        logits, caches = (decode or model.decode_step)(params, tok, caches,
                                                       pos + n)
        out.append(logits[rows, -1].float())
    return torch.stack(out, 1)          # (len(rows), steps, vocab)


def logit_diff(a, b) -> dict:
    d = (a.float() - b.float()).abs()
    return {"mean_abs": float(d.mean()), "max_abs": float(d.max())}


def within_bounds(diff: dict, what: str) -> None:
    check(diff["mean_abs"] <= LOGIT_MEAN_BOUND
          and diff["max_abs"] <= LOGIT_MAX_BOUND, f"{what}: {diff}")


def serve_phase(arch: str, phase: int, dev, card) -> dict:
    """Serve `arch` at its published widths, bf16, random weights from seed
    0, under both schedulers (counted); then the checks.

    For a mixture of experts (capacity dispatch) two of the checks compare
    runs that may compute different functions, and each is held to the
    logit bounds only where they do not:
    - a 2047-token prefill plus one decode step against the 2048-token
      prefill: both prefills have capacity C = ceil(2048·8/128·1.25) = 160
      = ceil(2047·8/128·1.25), and ranks within an expert are token-major,
      so the prefix is routed and dropped alike in both; decode has C = k
      and never drops. They differ in function only where the 2048-token
      prefill drops one of the LAST token's assignments, or where rounding
      sends a token to another expert. The phase reports both (the last
      token's drops; the share of (token, layer, k) decisions that differ)
      and holds the bounds only where both are 0;
    - flash against dense attention, and the teacher-forced 8-slot against
      1-slot decode: rounding (a bf16 activation into the f32 router; an
      8-row against a 1-row GEMM) can flip a routing decision. The share
      of decisions that differ is reported beside the logit difference;
      the bounds hold where it is 0.
    It also reports whether the f32 router product of one decode row is
    bit-identical in an 8-row and a 1-row GEMM, and the routed
    assignments capacity dropped in the serving runs' prefills."""
    import numpy as np

    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import _mark_prefill_tail

    cfg = get_arch(arch)
    moe = cfg.family == "moe"
    check(per_prefill(cfg) == PER_PREFILL[arch],
          f"{arch}: launches per prefill {per_prefill(cfg)}")
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.bfloat16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 2049, REQUESTS)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    emit({"phase": "serve_setup", "n": phase, "arch": cfg.name,
          "family": cfg.family, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
          "per_prefill": per_prefill(cfg), "params": n_params,
          "param_gib": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 2**30,
          "init_s": init_s, "init_peak_gib": init_peak,
          "prompt_lens": lens.tolist(), "gpu": card})
    # warm-up (kernel build is done; cuBLAS handles, allocator)
    model.prefill(params, {"tokens": torch.tensor([prompts[0][:128]],
                                                  device=dev)})
    runs = {sch: serve_run(model, params, prompts, sch, dev, card, phase)
            for sch in ("continuous", "wave")}
    tp_step = None
    if cfg.family == "dense":
        # the TP decode step on a one-rank ("data", "model") mesh: no ring,
        # but the restructured step (fused slices, per-row cache writes)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.decode_tp import build_decode_step

        tp_step = build_decode_step(model, make_mesh((1, 1),
                                                     ("data", "model"), dev))
        runs["continuous_tp"] = serve_run(model, params, prompts,
                                          "continuous_tp", dev, card, phase,
                                          decode_step_fn=tp_step)

    probe = MoeProbe() if moe else contextlib.nullcontext()
    with probe:
        if moe:
            probe.record = True
        # one 2048-token prompt: last-token logits of the prefill, under
        # dense attention where the model has attention, and from a
        # 2047-token prefill and one decode step
        toks = torch.tensor([rng.integers(1, cfg.vocab_size, 2048).tolist()],
                            device=dev)
        lf, _ = model.prefill(params, {"tokens": toks})
        check(bool(torch.isfinite(lf).all())
              and lf.shape == (1, 1, cfg.vocab_size),
              f"{arch} prefill logits: non-finite or wrong shape")
        route = {}
        if moe:
            route["prefill_2048"], keep_2048 = probe.take()
        checks, holds = {}, {}
        if "flash_attention" in per_prefill(cfg):
            dense = build_model(cfg, ModelOptions(attn_impl="dense",
                                                  dtype=torch.bfloat16))
            ld, _ = dense.prefill(params, {"tokens": toks})
            checks["flash_vs_dense_logits"] = logit_diff(lf, ld)
            del ld
            if moe:
                r = routing_differs(route["prefill_2048"], probe.take()[0],
                                    cfg.num_layers)
                checks["flash_vs_dense_logits"]["routing"] = r
                holds["flash_vs_dense_logits"] = r["differ"] == 0
        last = toks.shape[1] - 1
        _, pc = model.prefill(params, {"tokens": toks[:, :last]},
                              max_len=last + 1)
        lp, _ = model.decode_step(params, toks[:, last:],
                                  _mark_prefill_tail(pc, last), last)
        key = "prefill_2047_plus_decode_vs_prefill_2048"
        checks[key] = logit_diff(lp, lf)
        del pc, lp
        if moe:
            got, _ = probe.take()               # 48 prefill, 48 decode
            n = cfg.num_layers
            both = [torch.cat([a, b], dim=1)
                    for a, b in zip(got[:n], got[n:])]
            r = routing_differs(route["prefill_2048"], both, n)
            drops = int(sum(int((~k[:, -1]).sum()) for k in keep_2048))
            checks[key].update(routing=r, last_token_dropped=drops)
            holds[key] = r["differ"] == 0 and drops == 0
        f32_diff = None
        if set(per_prefill(cfg)) & {"lru_scan", "ssd_scan"}:
            # the same in float32: the chunked prefill against the
            # recurrence
            m32 = build_model(cfg, ModelOptions(attn_impl="flash",
                                                dtype=torch.float32))
            p32 = m32.init(0, dev)
            l32, _ = m32.prefill(p32, {"tokens": toks})
            _, pc = m32.prefill(p32, {"tokens": toks[:, :last]},
                                max_len=last + 1)
            lp, _ = m32.decode_step(p32, toks[:, last:],
                                    _mark_prefill_tail(pc, last), last)
            f32_diff = logit_diff(lp, l32)
            del m32, p32, l32, pc, lp
            torch.cuda.empty_cache()

        # teacher-forced decode: requests 0 and 1 (Mamba-2: all 8) in the
        # 8-slot layout (with the first 8 requests) against each alone in a
        # 1-slot layout
        rows = list(range(SLOTS)) if cfg.family == "ssm" else [0, 1]
        forced = [runs["continuous"]["served"][i][:17] for i in range(SLOTS)]
        eight = teacher_forced(model, params, prompts[:SLOTS], forced, SLOTS,
                               rows, dev)
        decode_ids = []
        if moe:    # the decode steps' expert ids (prefills have S > 1)
            decode_ids.append([a for a in probe.take()[0] if a.shape[1] == 1])
        ones = []
        for i in rows:
            ones.append(teacher_forced(model, params, [prompts[i]],
                                       [forced[i]], 1, [0], dev))
            if moe:
                decode_ids.append([a for a in probe.take()[0]
                                   if a.shape[1] == 1])
        one = torch.cat(ones)
        tp_agree = None
        if tp_step is not None:
            # the same 8-slot teacher-forced steps through the TP step
            tp8 = teacher_forced(model, params, prompts[:SLOTS], forced,
                                 SLOTS, rows, dev, decode=tp_step)
            checks["tp_step_vs_decode_step_teacher_forced"] = dict(
                logit_diff(tp8, eight),
                bit_identical=bool(torch.equal(tp8, eight)))
            a, b = runs["continuous_tp"]["served"], runs["continuous"]["served"]
            same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
            tp_agree = {"tokens_equal": same,
                        "tokens": sum(len(a[r]) for r in a),
                        "requests_equal": sum(a[r] == b[r] for r in a)}
            del tp8, tp_step
            torch.cuda.empty_cache()
        key = "teacher_forced_8_vs_1_slot"
        checks[key] = dict(
            logit_diff(eight, one),
            bit_identical=bool(torch.equal(eight, one)),
            requests=len(rows), requests_bit_identical=sum(
                bool(torch.equal(eight[i], one[i]))
                for i in range(len(rows))),
            steps=len(forced[0]) - 1)
        if moe:
            r = routing_differs([a[rows] for a in decode_ids[0]],
                                [torch.cat(c) for c in zip(*decode_ids[1:])],
                                cfg.num_layers)
            checks[key]["routing"] = r
            holds[key] = r["differ"] == 0
        del eight, one
    router_rows = None
    if moe:
        # the f32 router product of one decode row in an 8-row and a 1-row
        # GEMM (the question Mamba-2's dt projection raised, ROADMAP.md
        # Queue 3)
        h = torch.randn((SLOTS, 1, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1)
                        ).to(torch.bfloat16)
        w = params["layers"]["moe"]["router"][0]
        l8 = h.float() @ w
        l1 = torch.cat([h[i:i + 1].float() @ w for i in range(SLOTS)])
        router_rows = {"bit_identical": bool(torch.equal(l8, l1)),
                       "max_abs_diff": float((l8 - l1).abs().max())}

    # the reduced config on the card against the CPU (float32, plain
    # versions on the CPU), on a small input
    small = cfg.reduced()
    sm = build_model(small, ModelOptions(attn_impl="flash",
                                         dtype=torch.float32))
    sp = sm.init(0, "cpu")
    st = torch.tensor([rng.integers(1, small.vocab_size, 100).tolist()])
    want, _ = sm.prefill(sp, {"tokens": st})
    got, _ = sm.prefill(sp.to(dev), {"tokens": st.to(dev)})
    small_err = float((got.cpu() - want).abs().max())

    row = {"phase": "serve_checks", "n": phase, "arch": cfg.name, **checks,
           "bounds": {"mean_abs": LOGIT_MEAN_BOUND,
                      "max_abs": LOGIT_MAX_BOUND},
           "tp_continuous_vs_continuous_tokens": tp_agree,
           "f32_prefill_plus_decode_vs_prefill": f32_diff,
           "f32_bound_max_abs": F32_RECURRENCE_TOL,
           "reduced_card_vs_cpu_f32_max_abs": small_err, "gpu": card}
    if moe:
        row["bounds_held"] = {k: holds.get(k, True) for k in checks}
        row["router_f32_8_vs_1_rows"] = router_rows
    emit(row)
    for what, diff in checks.items():
        if holds.get(what, True):
            within_bounds(diff, f"{arch} {what}")
    check(f32_diff is None or f32_diff["max_abs"] <= F32_RECURRENCE_TOL,
          f"{arch} f32 prefill + decode vs prefill: {f32_diff}")
    check(small_err <= 1e-4, f"{arch} reduced model card vs CPU: {small_err}")
    return {"model": model, "params": params, "prompts": prompts,
            "launches": {k: sum(r["row"]["launches"].get(k, 0)
                                for r in runs.values())
                         for k in per_prefill(cfg)}}


@contextlib.contextmanager
def moe_ranges():
    """Runs the MoE block's pieces under profiler ranges: "moe" around
    moe_apply_dense, "moe_dispatch" around the router and top-k
    (``_route``), the load statistics of the aux loss (``_load``), the
    one-hot/cumsum tables (``_dispatch_tables``), the gather into the
    expert slots (``_slots_gather``) and the combine (``_combine``)."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    names = ("_route", "_load", "_dispatch_tables", "_slots_gather",
             "_combine", "moe_apply_dense")
    orig = {n: getattr(moe, n) for n in names}

    def wrap(n, fn):
        tag = "moe" if n == "moe_apply_dense" else "moe_dispatch"

        def f(*a, **kw):
            with record_function(tag):
                return fn(*a, **kw)
        return f

    for n, fn in orig.items():
        setattr(moe, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(moe, n, fn)


def serve_family(name: str, ranges) -> str:
    """The op family of one CUDA kernel of a MoE model's serving step,
    from its name and the profiler ranges it was launched under."""
    low = name.lower()
    if "moe_dispatch" in ranges:
        return "moe_dispatch"
    gemm = any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet"))
    if "moe" in ranges:
        return "expert gemm" if gemm else "expert elementwise"
    if gemm:
        return "gemm (attention projections, lm_head)"
    if "copy" in low or "cat" in low or "index" in low or "scatter" in low:
        return "copies and cache writes"
    return "other elementwise"


def traced_families(fn, family_of) -> dict:
    """Run `fn` once under torch.profiler: device time by op family (each
    kernel's family from its name and the ranges above it), the largest
    kernels, and the device's busy time against the traced window's wall
    clock. The port's CUDA kernels are launched through ctypes, outside
    any aten op (in a backward, inside an autograd node's range), so their
    family, "port kernels", is read from the kernel table by name, and
    they are left out of the event walk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams, kernels, total, launches = {}, {}, 0.0, 0
    for ev in prof.events():
        if not ev.kernels:
            continue
        ranges, up = set(), ev
        while up is not None:
            ranges.add(up.name)
            up = up.cpu_parent
        for k in ev.kernels:
            if any(p in k.name for p in PORT_KERNELS):
                continue    # read from the kernel table below, once
            ms = k.duration / 1e3
            fam = family_of(k.name, ranges)
            fams[fam] = fams.get(fam, 0.0) + ms
            kernels[k.name] = kernels.get(k.name, 0.0) + ms
            total += ms
            launches += 1
    fams["port kernels"] = sum(
        dev_us(e) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and any(k in e.key for k in PORT_KERNELS)) / 1e3
    busy = total + fams["port kernels"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    ours = [{"name": short_name(e.key), "count": e.count,
             "ms": dev_us(e) / 1e3} for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(k in e.key for k in PORT_KERNELS)]
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (1e3 * wall),
            "kernel_launches": launches,
            "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:100], "ms": ms} for n, ms in top],
            "port_kernels": sorted(ours, key=lambda k: -k["ms"])}


def serve_profile(serve, phase: int, dev, card) -> dict:
    """A traced admission prefill (the longest prompt) and a traced window
    of 5 decode steps over all 8 slots."""
    from repro_torch.runtime.server import (
        _mark_prefill_tail,
        _scatter_slot,
        make_slot_caches,
    )

    model, params = serve["model"], serve["params"]
    prompt = max(serve["prompts"], key=len)
    tokens = torch.tensor([prompt], device=dev)
    caches = make_slot_caches(model, SLOTS, MAX_LEN, dev)

    def admit():
        _, pc = model.prefill(params, {"tokens": tokens}, max_len=MAX_LEN)
        for i in range(SLOTS):
            _scatter_slot(caches, _mark_prefill_tail(pc, len(prompt)), i,
                          SLOTS)

    pos = torch.full((SLOTS,), len(prompt), device=dev)
    tok = torch.ones((SLOTS, 1), dtype=torch.int64, device=dev)

    def decode():
        for n in range(5):
            model.decode_step(params, tok, caches, pos + n)

    admit()
    decode()  # warm
    row = {"phase": "serve_profile", "n": phase, "arch": model.cfg.name,
           "prompt_len": len(prompt)}
    if model.cfg.family == "moe":
        with moe_ranges():
            row["prefill"] = traced_families(lambda: model.prefill(
                params, {"tokens": tokens}, max_len=MAX_LEN), serve_family)
            row["decode_5_steps"] = traced_families(decode, serve_family)
    else:
        row["prefill"] = traced(lambda: model.prefill(
            params, {"tokens": tokens}, max_len=MAX_LEN))
        row["decode_5_steps"] = traced(decode)
    row["gpu"] = card
    return row


def lru_launch_only(lru_ops, a, x, h0):
    """A callable that launches the lru_scan kernel's C function on `a`,
    `x`, `h0` (contiguous; h0 f32 or None) with arguments prepared once,
    into outputs made once: the kernel's time without the wrapper's host
    work. These launches are not counted."""
    fn = lru_ops._library().lru_scan_fwd
    h = torch.empty_like(x)
    h_last = torch.empty((a.shape[0], a.shape[2]), dtype=torch.float32,
                         device=a.device)
    args = (a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), *a.shape,
            lru_ops._DTYPES[a.dtype], lru_ops._DTYPES[x.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)

    def run(outputs=(h, h_last)):   # the outputs live as long as `run`
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    return run


def lru_case(lru_ops, dev, card, b, l, w, b_dtype, with_h0,
             tag=None) -> dict:
    """The lru_scan kernel against its plain version at one shape:
    CUDA-event times (time_ms); bound from the bytes (a and b read, h
    written, h0 read and h_last written once). `tag` adds keys to the
    row (a later phase's name and number)."""
    dtype = torch.bfloat16 if b_dtype == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(l + w + b)
    a = 0.5 + 0.49 * torch.rand((b, l, w), generator=gen, device=dev)
    x = torch.randn((b, l, w), generator=gen, device=dev).to(dtype)
    h0 = (torch.randn((b, w), generator=gen, device=dev) if with_h0
          else None)
    gh, gl = lru_ops.lru_scan(a, x, h0, "kernel")
    plan = lru_ops.lru_scan.last_plan
    wh, wl = lru_ops.lru_scan(a, x, h0, "plain")
    torch.cuda.synchronize()
    dh = (gh.float() - wh.float()).abs()
    dl = (gl - wl).abs()
    err = max(float(dh.max()), float(dl.max()))
    slack = bf16_ulp(wh) if dtype == torch.bfloat16 else 0.0
    check(bool(torch.isfinite(gh).all()) and gh.dtype == dtype,
          f"lru: non-finite or wrong dtype at {(b, l, w)}")
    check(bool((dh <= slack + LRU_TOL + LRU_TOL * wh.float().abs()).all())
          and bool((dl <= LRU_TOL + LRU_TOL * wl.abs()).all()),
          f"lru kernel off plain by {err} at {(b, l, w, b_dtype)}")
    del gh, gl, wh, wl, dh, dl
    k_ms = time_ms(lambda: lru_ops.lru_scan(a, x, h0, "kernel"))
    l_ms = time_ms(lru_launch_only(lru_ops, a, x, h0))
    p_ms = time_ms(lambda: lru_ops.lru_scan(a, x, h0, "plain"), reps=3)
    nbytes = (a.numel() * a.element_size() + 2 * x.numel() * x.element_size()
              + (2 if with_h0 else 1) * b * w * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * l * w / F32_FLOPS * 1e3
    row = {"phase": "lru", "shape": [b, l, w], "b_dtype": b_dtype,
           "h0": with_h0, "cluster": plan["cluster"], "warps": plan["warps"],
           "steps": plan["steps"], "max_abs_err": err, "kernel_ms": k_ms,
           "launch_ms": l_ms, "plain_ms": p_ms, "library_ms": None,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "mbytes": nbytes / 1e6, "kernel_gb_per_s": nbytes / k_ms / 1e6,
           "gpu": card, **(tag or {})}
    emit(row)
    return row


def y_diag_f64(xc, dtc, A, Bc, Cc):
    """The SSD within-chunk output (C B^T o L) @ (x dt) in float64."""
    xc, dtc, A, Bc, Cc = (t.double() for t in (xc, dtc, A, Bc, Cc))
    cs = torch.cumsum(dtc * A, dim=2).transpose(-1, -2)        # (b,c,h,q)
    q = cs.shape[-1]
    lower = torch.ones(q, q, dtype=torch.bool, device=cs.device).tril()
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(
        ~lower, float("-inf")))
    att = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)
    return torch.matmul(att[:, :, None] * L, xdt).permute(0, 1, 3, 2, 4)


def ssd_case(ssd_ops, ssd_ref, dev, card, b, l, h, p, n, chunk,
             dtype_name, tag=None) -> dict:
    """ops.ssd through the kernel against the plain version (y and the
    final state), and the within-chunk terms alone timed both ways. `tag`
    adds keys to the row."""
    import torch.nn.functional as F

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(l + h + p)
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=dev))
    A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    yk, sk = ssd_ops.ssd(x, dt, A, B, C, chunk, impl="kernel")
    yp, sp = ssd_ops.ssd(x, dt, A, B, C, chunk, impl="plain")
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype_name]
    dy = (yk.float() - yp.float()).abs()
    ds = (sk - sp).abs()
    err = max(float(dy.max()), float(ds.max()))
    check(bool(torch.isfinite(yk).all()) and bool(torch.isfinite(sk).all()),
          f"ssd: non-finite output at {(b, l, h, p, n)}")
    check(bool((dy <= tol + tol * yp.float().abs()).all())
          and bool((ds <= tol + tol * sp.abs()).all()),
          f"ssd kernel off plain by {err} at {(b, l, h, p, n, dtype_name)}")
    del yk, sk, yp, sp, dy, ds
    # the within-chunk terms alone, on the chunk-padded inputs
    pad = (-l) % chunk
    lp = l + pad
    xq, dq, Bq, Cq = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
                      for t in (x, dt, B, C))
    c = lp // chunk
    k_ms = time_ms(lambda: ssd_ops.chunk_terms_kernel(xq, dq, A, Bq, Cq,
                                                      chunk))
    parts = (xq.reshape(b, c, chunk, h, p), dq.reshape(b, c, chunk, h), A,
             Bq.reshape(b, c, chunk, n), Cq.reshape(b, c, chunk, n))
    p_ms = time_ms(lambda: ssd_ref.ssd_chunk_terms(*parts), reps=3)
    exact = y_diag_f64(*parts)
    vs_f64 = {name: float((y.double() - exact).abs().mean()) for name, y in (
        ("kernel", ssd_ops.chunk_terms_kernel(xq, dq, A, Bq, Cq, chunk)[0]),
        ("plain", ssd_ref.ssd_chunk_terms(*parts)[0]))}
    del exact
    if dtype_name == "bf16":
        # the tensor-core path's split-bf16 products must not cost accuracy
        check(vs_f64["kernel"] <= vs_f64["plain"],
              f"ssd kernel's y_diag further from float64 than the plain "
              f"version's: {vs_f64} at {(b, l, h, p, n)}")
    path_ms = time_ms(lambda: ssd_ops.ssd(x, dt, A, B, C, chunk,
                                          impl="kernel"))
    q = chunk
    # flops of the causal half: C B^T once per chunk (j <= i), then per head
    # (C B^T o L) @ (x dt) over j <= i and the (n x p) states product
    flops = b * c * (q * (q + 1) * n + h * (q * (q + 1) * p + 2 * q * n * p))
    nbytes = ((xq.numel() + Bq.numel() + Cq.numel()) * x.element_size()
              + 4 * (dq.numel() + h)
              + 4 * (b * lp * h * p + b * c * h * n * p + b * lp * h))
    peak = BF16_FLOPS if dtype_name == "bf16" else F32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "ssd", "shape": [b, l, h, p, n], "chunk": chunk,
           "dtype": dtype_name, "max_abs_err": err, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": None, "ssd_path_ms": path_ms,
           "y_diag_mean_abs_err_vs_f64": vs_f64,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "kernel_tflops": flops / k_ms / 1e9, "gpu": card, **(tag or {})}
    emit(row)
    return row


def launch_counts(ops_modules) -> int:
    """Kernel launches of the wrappers, forward and backward."""
    return sum(m.launches + getattr(m, "bwd_launches", 0)
               for m in ops_modules)


def timed(fn):
    """(result, seconds) of `fn()` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solver_meshes(n_axes):
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh

    out = [(make_mesh((1,), ("data",)), ("data",), "1"),
           (make_grid_mesh(1, 1), ("rows", "cols"), "1x1")]
    if n_axes == 3:
        out.append((make_grid_mesh(1, 1, 1), ("planes", "rows", "cols"),
                    "1x1x1"))
    return out


def rk3_phase(dev, card) -> None:
    """Phase 16 (see the module docstring)."""
    import numpy as np

    from repro_torch.core.stencil import rk3_solve
    from repro_torch.launch.mesh import make_mesh

    meshes = solver_meshes(2)
    # a small grid on the card against the port on the CPU
    g = np.random.default_rng(1).standard_normal((8, 20, 32)).astype(
        np.float32)
    small_err = 0.0
    for mesh, axes, _ in meshes:
        cpu = make_mesh(mesh.sizes, mesh.axis_names, "cpu")
        for mode in ("two_phase", "hdot"):
            got = rk3_solve(torch.from_numpy(g).to(dev), mesh, axes, 3,
                            RK3_DT, mode).cpu()
            want = rk3_solve(torch.from_numpy(g), cpu, axes, 3, RK3_DT, mode)
            check(torch.allclose(got, want, **RK3_TOL),
                  f"rk3 card != cpu on {axes} {mode}")
            small_err = max(small_err, float((got - want).abs().max()))
    emit({"phase": "rk3_vs_cpu", "n": 16, "shape": [8, 20, 32], "steps": 3,
          "max_abs_diff": small_err, "tol": RK3_TOL})

    for shape, steps in RK3_CASES:
        v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
            shape).astype(np.float32)).to(dev)
        mean0 = float(v0.double().mean())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = {}
        for mesh, axes, label in meshes:
            for mode in ("two_phase", "hdot"):
                rk3_solve(v0, mesh, axes, 1, RK3_DT, mode)     # warm-up
                v, dt = timed(lambda: rk3_solve(v0, mesh, axes, steps,
                                                RK3_DT, mode))
                check(tuple(v.shape) == shape
                      and bool(torch.isfinite(v).all()),
                      f"rk3 {shape} {label} {mode}: shape or non-finite")
                drift = abs(float(v.double().mean()) - mean0)
                check(drift <= 1e-4, f"rk3 mean drifted by {drift}")
                out[(label, mode)] = v
                emit({"phase": "rk3", "n": 16, "shape": list(shape),
                      "mesh": label, "mode": mode, "steps": steps,
                      "seconds": dt, "steps_per_s": steps / dt,
                      "mean_drift": drift, "std": float(v.std()),
                      "std0": float(v0.std()), "gpu": card})
            check(torch.equal(out[(label, "hdot")], out[(label, "two_phase")]),
                  f"rk3 hdot != two_phase on {shape} mesh {label}")
        check(torch.equal(out[("1", "hdot")], out[("1x1", "hdot")]),
              f"rk3 slab != grid on {shape}")
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        emit({"phase": "rk3_memory", "n": 16, "shape": list(shape),
              "grid_gib": v0.numel() * 4 / 2**30, "peak_gib_above_grid": peak})
        del out, v
        if shape == RK3_CASES[-1][0]:
            mesh, axes, label = meshes[0]
            for mode in ("two_phase", "hdot"):
                row = {"phase": "rk3_profile", "n": 16, "shape": list(shape),
                       "mesh": label, "mode": mode, "steps": 1}
                row.update(traced(lambda: rk3_solve(v0, mesh, axes, 1,
                                                    RK3_DT, mode)))
                row["gpu"] = card
                emit(row)
        del v0
        torch.cuda.empty_cache()


def hpccg_phase(dev, card) -> None:
    """Phase 17 (see the module docstring)."""
    import numpy as np

    from repro_torch.core.stencil import _stencil27_matvec, hpccg_solve
    from repro_torch.launch.mesh import make_mesh

    meshes = solver_meshes(3)
    g = np.random.default_rng(2).standard_normal((16, 16, 16)).astype(
        np.float32)
    small_err = 0.0
    for mesh, axes, _ in meshes:
        cpu = make_mesh(mesh.sizes, mesh.axis_names, "cpu")
        for mode in ("two_phase", "hdot"):
            _, got = hpccg_solve(torch.from_numpy(g).to(dev), mesh, axes, 20,
                                 mode)
            _, want = hpccg_solve(torch.from_numpy(g), cpu, axes, 20, mode)
            rel = float(((got.cpu() - want).abs() / want.abs()).max())
            check(rel <= HPCCG_RTOL, f"hpccg card != cpu on {axes} {mode}")
            small_err = max(small_err, rel)
    emit({"phase": "hpccg_vs_cpu", "n": 17, "shape": [16, 16, 16],
          "iters": 20, "max_rel_diff_history": small_err,
          "rtol": HPCCG_RTOL})

    shape = (HPCCG_N,) * 3
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(dev)
    bnorm = float(torch.linalg.norm(b))
    for mesh, axes, label in meshes:
        out = {}
        for mode in ("two_phase", "hdot"):
            hpccg_solve(b, mesh, axes, 2, mode)                # warm-up
            (x, h), dt = timed(lambda: hpccg_solve(b, mesh, axes,
                                                   HPCCG_ITERS, mode))
            hist = h.cpu()
            check(tuple(x.shape) == shape and tuple(hist.shape)
                  == (HPCCG_ITERS,) and bool(torch.isfinite(x).all()),
                  f"hpccg {label} {mode}: shapes or non-finite")
            check(bool(hist[-1] < hist[0]), f"hpccg history rose: {label}")
            ax = _stencil27_matvec(x, None, (), "hdot")
            out[mode] = (x, h)
            emit({"phase": "hpccg", "n": 17, "shape": list(shape),
                  "mesh": label, "mode": mode, "iters": HPCCG_ITERS,
                  "seconds": dt, "iters_per_s": HPCCG_ITERS / dt,
                  "residual_first": float(hist[0]),
                  "residual_last": float(hist[-1]),
                  "rel_residual": float(torch.linalg.norm(ax - b)) / bnorm,
                  "gpu": card})
            del ax
        check(all(torch.equal(a, c) for a, c in zip(out["hdot"],
                                                    out["two_phase"])),
              f"hpccg hdot != two_phase on mesh {label}")
        del out, x, h
    mesh, axes, label = meshes[-1]
    for mode in ("two_phase", "hdot"):
        row = {"phase": "hpccg_profile", "n": 17, "shape": list(shape),
               "mesh": label, "mode": mode, "iters": 2}
        row.update(traced(lambda: hpccg_solve(b, mesh, axes, 2, mode)))
        row["gpu"] = card
        emit(row)
    del b
    torch.cuda.empty_cache()


# ---------------------------------------------------------- 18-19. training
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048         # 16,384 tokens a step
TRAIN_STEPS = 5                          # 1 warm-up + 4 timed
TRAIN_RTOL = 1e-4                        # the f32 trainer tolerance of the
                                         # CPU tests (port vs JAX Trainer)
# phase 22: ZeRO-3 on the per-layer layout, gathering all and streaming
# (the reference's comparator pair, tests/test_fsdp.py); both remat "full"
ZERO3_SETUPS = {
    "gather": dict(param_shard=True, bucket_order="layer", remat="full"),
    "stream": dict(param_shard=True, fsdp_streaming=True, remat="full"),
}
ZERO3_NORM_RTOL = 1e-5                   # the grad norm is summed by flat
                                         # buffer, not by leaf (1 ulp)


def train_run(overlap: str, mesh_axes, accum=1, seq=TRAIN_SEQ, dev=None,
              arch=TRAIN_ARCH, reduced=False, dtype=None, scan=True,
              steps=TRAIN_STEPS, ckpt=None, every=10 ** 9, zero3=None,
              fused=True, layers=None, **parallel):
    """A Trainer as ``launch/train.py``'s ``build_run`` sets one up (AdamW
    with the JAX defaults, warmup max(1, steps // 10), remat "full" at full
    width), on a one-rank mesh of `mesh_axes` (None: no mesh). `zero3`
    names a setup of ZERO3_SETUPS (phase 22: unrolled, remat "full", the
    unfused loss); `layers` cuts the depth; `parallel` sets other
    ParallelConfig fields."""
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if zero3 is not None:
        parallel = dict(ZERO3_SETUPS[zero3], **parallel)
        scan, fused = False, False
    remat = parallel.pop("remat", "none" if reduced else "full")
    run = RunConfig(
        model=cfg,
        parallel=ParallelConfig(overlap=overlap, accum_steps=accum,
                                remat=remat, scan_layers=scan, **parallel),
        train=TrainConfig(global_batch=TRAIN_BATCH, seq_len=seq,
                          total_steps=steps,
                          warmup_steps=max(1, steps // 10),
                          checkpoint_every=every,
                          checkpoint_dir=ckpt or str(ROOT / "build"
                                                     / "chip_smoke_ckpt")))
    mesh = (None if mesh_axes is None else
            make_mesh((1,) * len(mesh_axes), mesh_axes, dev))
    options = ModelOptions(scan_layers=scan, remat=run.parallel.remat,
                           dtype=dtype or torch.bfloat16, fused_xent=fused)
    return Trainer(run, mesh=mesh, options=options, device=dev)


def train_flops(cfg, tokens: int) -> dict:
    """Model FLOPs of one step, 6·N_matmul·tokens (N_matmul: the parameters
    less the embedding lookup), and beside it what the step also computes:
    the dense attention's einsums (QK^T and PV over the whole (s, s) square,
    float32; forward, two backward products each, and the remat
    recompute), and the remat recompute of the layers' matmuls and of the
    logits (linear_xent's backward)."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    hd = cfg.resolved_head_dim
    b, s = TRAIN_BATCH, tokens // TRAIN_BATCH
    attn_fwd = 2 * 2 * b * cfg.num_heads * s * s * hd * cfg.num_layers
    head = cfg.d_model * cfg.vocab_size
    return {"n_matmul": n_matmul, "model_flops": 6 * n_matmul * tokens,
            "attention_flops": 4 * attn_fwd,
            "remat_flops": 2 * (n_matmul - head) * tokens + 2 * head * tokens}


def train_timed(overlap, mesh_axes, dev, card, kernel_ops) -> tuple:
    """Phase 18's run of one setup: init from seed 0, a warm-up step, 4
    timed steps (host clock, each ending in the metrics' read-back); the
    metrics line and the final parameters (a host copy)."""
    from repro_torch.models.layers import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = train_run(overlap, mesh_axes, dev=dev)
    t.init_state(seed=0)
    before = launch_counts(kernel_ops)
    times = []
    for _ in range(TRAIN_STEPS):
        _, dt = timed(lambda: t.train(1))
        times.append(dt)
    launches = launch_counts(kernel_ops) - before
    log = t.metrics_log
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    flops = train_flops(t.run.model, tokens)
    label = ("no mesh" if mesh_axes is None
             else f"{'x'.join(mesh_axes)}=1 {overlap}")
    row = {"phase": "train", "n": 18, "arch": t.run.model.name,
           "vocab": t.run.model.vocab_size, "setup": label, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "remat": t.run.parallel.remat, "scan_layers": True,
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * x for x in times[1:]],
           "warmup_step_ms": 1e3 * times[0],
           "tokens_per_s": tokens / step_s,
           "mfu": flops["model_flops"] / step_s / BF16_FLOPS,
           **flops,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "lrs": [m["lr"] for m in log], "kernel_launches": launches,
           "gpu": card}
    emit(row)
    final = [p.detach().cpu() for p in tree_leaves(t.params)]
    buckets = t._step_fn.buckets
    if buckets is not None:
        check(buckets.issued == list(range(len(buckets.buckets))),
              f"hdot issued {buckets.issued}")
    del t
    torch.cuda.empty_cache()
    return row, final


def train_vs_cpu(dev, card) -> None:
    """The reduced config in f32 on the card against the CPU, 2 steps
    from the same parameters (a one-rank ("data",) mesh under hdot,
    unrolled, 2 microbatches: the backward-time buckets on the card)."""
    from repro_torch.models.layers import tree_leaves

    runs = {}
    for where in (dev, torch.device("cpu")):
        t = train_run("hdot", ("data",), accum=2, seq=64, dev=where,
                      reduced=True, dtype=torch.float32, scan=False, steps=2)
        params = t.model.init(0, "cpu")
        t.init_state(params=params.to(where))
        t.train(2)
        runs[where.type] = t
    a, b = runs["cuda"], runs["cpu"]
    worst = 0.0
    for key in ("loss", "grad_norm"):
        got = torch.tensor([m[key] for m in a.metrics_log])
        want = torch.tensor([m[key] for m in b.metrics_log])
        check(torch.allclose(got, want, rtol=TRAIN_RTOL, atol=0),
              f"train card != cpu: {key} {got.tolist()} {want.tolist()}")
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        p, q = p.detach().cpu(), q.detach()
        err = float((p - q).abs().max())
        check(err <= TRAIN_RTOL * (float(q.abs().max()) + 1e-30),
              f"train card != cpu: a parameter off by {err}")
        worst = max(worst, err / float(q.abs().max()))
    emit({"phase": "train_vs_cpu", "n": 18, "arch": a.run.model.name,
          "dtype": "f32", "steps": 2, "losses": [m["loss"] for m in
                                                  a.metrics_log],
          "max_param_err_rel_to_leaf_max": worst, "rtol": TRAIN_RTOL,
          "gpu": card})


def train_resume(dev, card) -> None:
    """The reduced config (bf16) trained 4 steps straight against 2 steps,
    a checkpoint, a new Trainer restored from it and 2 more: equal
    parameters and losses."""
    import shutil

    from repro_torch.models.layers import tree_leaves

    base = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    runs = []
    for name, plan in (("straight", (4,)), ("resumed", (2, 2))):
        ckpt = str(base / name)
        t = train_run("hdot", ("data",), dev=dev, reduced=True, seq=64,
                      steps=4, ckpt=ckpt, every=2)
        t.init_state(seed=0)
        t.train(plan[0])
        losses = [m["loss"] for m in t.metrics_log]
        if len(plan) == 2:
            t = train_run("hdot", ("data",), dev=dev, reduced=True, seq=64,
                          steps=4, ckpt=ckpt, every=2)
            check(t.restore_if_available() and t.step == 2,
                  "resume: no step-2 checkpoint")
            t.train(plan[1])
            losses += [m["loss"] for m in t.metrics_log]
        runs.append((losses, [p.detach().clone() for p in
                              tree_leaves(t.params)]))
    (la, pa), (lb, pb) = runs
    check(la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb)),
          f"resumed != straight: {la} {lb}")
    shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "train_resume", "n": 18, "losses": la, "equal": True,
          "gpu": card})


def train_phase(dev, card, kernel_ops) -> list:
    """Phase 18 (see the module docstring)."""
    rows, finals = [], {}
    for overlap, axes in (("hdot", None), ("two_phase", ("data",)),
                          ("hdot", ("data",))):
        row, final = train_timed(overlap, axes, dev, card, kernel_ops)
        rows.append(row)
        finals[row["setup"]] = final
    for row in rows:
        check(all(math.isfinite(x) for x in row["losses"]
                  + row["grad_norms"]), f"{row['setup']}: non-finite")
        check(row["kernel_launches"] == 0,
              f"{row['setup']}: a kernel of the port launched in training")
        # at init the rms-normed activations through lm_head ~ N(0, 1/d)
        # give logits of unit variance: E[loss] = ln V + 1/2
        expect = math.log(row["vocab"]) + 0.5
        check(abs(row["losses"][0] - expect) <= 0.5,
              f"{row['setup']}: first loss {row['losses'][0]}")
    two, hdot = rows[1], rows[2]
    same = (two["losses"] == hdot["losses"]
            and two["grad_norms"] == hdot["grad_norms"]
            and all(torch.equal(a, b) for a, b in zip(
                finals[two["setup"]], finals[hdot["setup"]])))
    check(same, "train: hdot != two_phase on one rank")
    emit({"phase": "train_checks", "n": 18,
          "hdot_equals_two_phase": same,
          "first_loss": rows[0]["losses"][0],
          "first_loss_minus_ln_vocab": rows[0]["losses"][0]
          - math.log(rows[0]["vocab"]), "gpu": card})
    del finals
    train_vs_cpu(dev, card)
    train_resume(dev, card)
    return rows


def family(name: str, ranges) -> str:
    """The op family of one CUDA kernel of the training step, from its
    name (cuBLAS names its float32 products "sgemm" or "gemm_f32f32"; its
    bf16 ones carry no type) and the profiler ranges it was launched
    under."""
    low = name.lower()
    if "adamw_update" in ranges:
        return "adamw"
    if any(r.startswith("linear_xent") for r in ranges):
        return "xent (logits, dlogits, dx, dw)"
    if "sgemm" in low or "gemm_f32f32" in low:
        return "f32 gemm (attention)"     # the only f32 products of a step
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "bf16 gemm"
    if "softmax" in low:
        return "softmax"
    if "copy" in low or "cat" in low:
        return "copies"
    return "other elementwise"


def train_profile(dev, card) -> dict:
    """Phase 19: one traced training step (full width, hdot on the one-rank
    mesh) after a warm-up step: device time by op family, the top kernels,
    and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    t = train_run("hdot", ("data",), dev=dev)
    t.init_state(seed=0)
    t.train(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.train(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams, kernels, total = {}, {}, 0.0
    for ev in prof.events():
        if not ev.kernels:
            continue
        ranges, up = set(), ev
        while up is not None:
            ranges.add(up.name)
            up = up.cpu_parent
        for k in ev.kernels:
            ms = k.duration / 1e3
            fam = family(k.name, ranges)
            fams[fam] = fams.get(fam, 0.0) + ms
            kernels[k.name] = kernels.get(k.name, 0.0) + ms
            total += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = [n for n in kernels if any(k in n for k in PORT_KERNELS)]
    check(not ours, f"a kernel of the port ran in training: {ours}")
    row = {"phase": "train_profile", "n": 19, "setup": "data=1 hdot",
           "wall_ms": 1e3 * wall, "device_busy_ms": total,
           "idle_share": 1.0 - total / (1e3 * wall),
           "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"name": n[:100], "ms": ms} for n, ms in top],
           "gpu": card}
    emit(row)
    del t
    torch.cuda.empty_cache()
    return row


def zero3_flat(t) -> dict:
    """Host copies of a ZeRO-3 trainer's flat shards: params, m, v."""
    return {name: {k: v.detach().cpu() for k, v in flat.items()}
            for name, flat in (("params", t.params),
                               ("m", t.opt_state["m"]),
                               ("v", t.opt_state["v"]))}


def same_flat(t, host) -> bool:
    """A trainer's flat shards equal `host` (zero3_flat's) bit for bit."""
    return all(torch.equal(v.detach().cpu(), host[name][k])
               for name, flat in (("params", t.params),
                                  ("m", t.opt_state["m"]),
                                  ("v", t.opt_state["v"]))
               for k, v in flat.items())


def zero3_timed(setup, dev, card, kernel_ops) -> tuple:
    """Phase 22's run of one setup at full width, as train_timed: init
    from seed 0 (bucket by bucket), a warm-up step, 4 timed steps; the
    metrics line and the flat state (host copies)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = train_run("hdot", ("data",), dev=dev, zero3=setup)
    t.init_state(seed=0)
    before = launch_counts(kernel_ops)
    times = []
    for _ in range(TRAIN_STEPS):
        _, dt = timed(lambda: t.train(1))
        times.append(dt)
    launches = launch_counts(kernel_ops) - before
    log = t.metrics_log
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    flops = train_flops(t.run.model, tokens)
    layout = t._fsdp_layout
    row = {"phase": "train_zero3", "n": 22, "arch": t.run.model.name,
           "vocab": t.run.model.vocab_size,
           "setup": f"data=1 zero3 {setup}", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": "full", "scan_layers": False,
           "loss_impl": "unfused log-softmax", "buffers": len(layout.groups),
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * x for x in times[1:]],
           "warmup_step_ms": 1e3 * times[0],
           "tokens_per_s": tokens / step_s,
           "mfu": flops["model_flops"] / step_s / BF16_FLOPS, **flops,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "param_shard_bytes": layout.shard_bytes(),
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "lrs": [m["lr"] for m in log], "kernel_launches": launches,
           "gpu": card}
    emit(row)
    flat = zero3_flat(t)
    del t
    torch.cuda.empty_cache()
    return row, flat


def zero3_vs_cpu(dev, card) -> None:
    """The reduced config in f32, streaming ZeRO-3 on a one-rank mesh, 2
    steps from the same parameters on the card and on the CPU."""
    from repro_torch.models.layers import tree_leaves

    runs = {}
    for where in (dev, torch.device("cpu")):
        t = train_run("hdot", ("data",), seq=64, dev=where, reduced=True,
                      dtype=torch.float32, steps=2, zero3="stream")
        t.init_state(params=t.model.init(0, "cpu"))
        t.train(2)
        runs[where.type] = t
    a, b = runs["cuda"], runs["cpu"]
    for key in ("loss", "grad_norm"):
        got = torch.tensor([m[key] for m in a.metrics_log])
        want = torch.tensor([m[key] for m in b.metrics_log])
        check(torch.allclose(got, want, rtol=TRAIN_RTOL, atol=0),
              f"zero3 card != cpu: {key} {got.tolist()} {want.tolist()}")
    worst = 0.0
    for p, q in zip(tree_leaves(a.full_params()),
                    tree_leaves(b.full_params())):
        p, q = p.detach().cpu(), q.detach()
        err = float((p - q).abs().max()) / (float(q.abs().max()) + 1e-30)
        check(err <= TRAIN_RTOL, f"zero3 card != cpu: a leaf off by {err}")
        worst = max(worst, err)
    emit({"phase": "zero3_vs_cpu", "n": 22, "arch": a.run.model.name,
          "dtype": "f32", "steps": 2,
          "losses": [m["loss"] for m in a.metrics_log],
          "max_param_err_rel_to_leaf_max": worst, "rtol": TRAIN_RTOL,
          "gpu": card})


def zero3_relayout(dev, card) -> None:
    """The reduced config (bf16) trained 2 steps under ZeRO-3 on a
    2-bucket reverse_topo layout, gathering all (8 buckets over the
    reduced config's 6 depths would cut one a depth: the per-layer layout
    itself); its checkpoint restored
    through restore_fsdp_checkpoint under the per-layer layout into a
    streaming and a gathering-all trainer: their state is the writer's
    re-cut bit for bit, and 2 more steps on each are bit-equal."""
    import shutil

    from repro_torch.checkpoint import restore_fsdp_checkpoint
    from repro_torch.core.overlap import fsdp_relayout

    base = ROOT / "build" / "chip_smoke_zero3_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    w = train_run("hdot", ("data",), dev=dev, reduced=True, seq=64, steps=4,
                  ckpt=str(base), every=2, fused=False, scan=False,
                  param_shard=True, remat="full", grad_buckets=2)
    w.init_state(seed=0)
    w.train(2)
    w.ckpt.wait()
    sides = {}
    for setup in ("stream", "gather"):
        t = train_run("hdot", ("data",), dev=dev, reduced=True, seq=64,
                      steps=4, ckpt=str(base / setup), zero3=setup)
        t.init_state(seed=1)
        step, state, _ = restore_fsdp_checkpoint(str(base), w._fsdp_layout,
                                                 t._fsdp_layout)
        with torch.no_grad():
            for name, flat in (("params", t.params),
                               ("m", t.opt_state["m"]),
                               ("v", t.opt_state["v"])):
                src = state["params"] if name == "params" else \
                    state["opt"][name]
                for k, v in flat.items():
                    v.copy_(src[k])
            t.opt_state["step"].copy_(state["opt"]["step"])
        t.step = step
        for name, flat in (("params", w.params), ("m", w.opt_state["m"]),
                           ("v", w.opt_state["v"])):
            want = fsdp_relayout({k: v.detach() for k, v in flat.items()},
                                 w._fsdp_layout, t._fsdp_layout)
            mine = t.params if name == "params" else t.opt_state[name]
            check(all(torch.equal(mine[k], want[k]) for k in want),
                  f"zero3 relayout: restored {name} != the writer's re-cut")
        t.train(2)
        sides[setup] = t
    s, g = sides["stream"], sides["gather"]
    same = ([m["loss"] for m in s.metrics_log]
            == [m["loss"] for m in g.metrics_log]
            and same_flat(s, zero3_flat(g)))
    check(same, "zero3 relayout: streaming != gathering all after restore")
    check(w._fsdp_layout.groups != s._fsdp_layout.groups,
          "zero3 relayout: the two layouts are the same")
    shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "zero3_relayout", "n": 22,
          "from_buffers": len(w._fsdp_layout.groups),
          "to_buffers": len(s._fsdp_layout.groups), "restored_step": 2,
          "losses_after": [m["loss"] for m in s.metrics_log],
          "stream_equals_gather": same, "gpu": card})


def zero3_phase(dev, card, kernel_ops) -> list:
    """Phase 22 (see the module docstring)."""
    rows, flats = [], {}
    for setup in ("gather", "stream"):
        row, flat = zero3_timed(setup, dev, card, kernel_ops)
        rows.append(row)
        flats[setup] = flat
    g, s = rows
    for row in rows:
        check(all(math.isfinite(x) for x in row["losses"]
                  + row["grad_norms"]), f"{row['setup']}: non-finite")
        check(row["kernel_launches"] == 0,
              f"{row['setup']}: a kernel of the port launched in training")
    same = (g["losses"] == s["losses"] and g["grad_norms"] == s["grad_norms"]
            and all(torch.equal(flats["gather"][n][k], flats["stream"][n][k])
                    for n in flats["gather"] for k in flats["gather"][n]))
    check(same, "zero3: streaming != gathering all")
    del flats
    # the replicated one-rank hdot trainer (phase 18's setup) with phase
    # 22's model options, one step from the same seed
    torch.cuda.synchronize()
    t = train_run("hdot", ("data",), dev=dev, scan=False, fused=False)
    t.init_state(seed=0)
    t.train(1)
    repl = t.metrics_log[0]
    del t
    torch.cuda.empty_cache()
    check(repl["loss"] == s["losses"][0],
          f"zero3 first loss {s['losses'][0]} != replicated {repl['loss']}")
    norm_rel = abs(s["grad_norms"][0] / repl["grad_norm"] - 1.0)
    check(norm_rel <= ZERO3_NORM_RTOL,
          f"zero3 first grad norm off the replicated one by {norm_rel}")
    emit({"phase": "zero3_checks", "n": 22, "stream_equals_gather": same,
          "replicated_first_loss": repl["loss"],
          "first_loss_equal": True, "first_grad_norm_rel_diff": norm_rel,
          "gpu": card})
    zero3_vs_cpu(dev, card)
    zero3_relayout(dev, card)
    return rows


# ------------------------------------- 23-25. encoder-decoder and VLM serving
# arch: (requests, prompt tokens, new tokens, max_len, teacher-forced steps
# of the check). Both serve the unrolled layout: Whisper's stack is never
# uniform; LLaVA's scanned draw takes fan_in = 60 layers for its stacked
# weights (the reference's init, ROADMAP.md Queue 3), 10.9x too large
# without qk-norm, and rounding alone then moves its bf16 logits past the
# bounds (scanned_draw_check reports by how much).
FRONTEND_SERVE = {
    "whisper-base": (8, 4, 200, 448, 8),      # Whisper's 4-token SOT prefix
    "llava-next-34b": (4, 512, 64, 1152, 4),  # 576 patches before the text
}
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 16, 448
TRAIN_LOSS_RTOL = 1e-3                   # bf16 card vs CPU, a mean over
                                         # 7,168 tokens of O(10) losses


def frontend_batch(cfg, requests: int, prompt_len: int, dev) -> dict:
    """Prompts and stub frontend embeddings (Whisper's frames, LLaVA's
    patches) from numpy seed 0, the stubs times 0.02, in bf16."""
    import numpy as np

    rng = np.random.default_rng(0)
    key, n = (("frames", cfg.encdec.enc_seq) if cfg.family == "encdec"
              else ("patches", cfg.num_vision_patches))
    stub = rng.standard_normal((requests, n, cfg.d_model)) * 0.02
    toks = rng.integers(1, cfg.vocab_size, (requests, prompt_len))
    return {"tokens": torch.from_numpy(toks).to(dev),
            key: torch.from_numpy(stub.astype(np.float32)).to(
                dev, torch.bfloat16)}


def first_decode_pos(cfg, prompt_len: int) -> int:
    """The position of the first decode token: a VLM's patches come
    first."""
    return prompt_len + (cfg.num_vision_patches if cfg.family == "vlm"
                         else 0)


def forced_logits(model, params, batch, forced, max_len: int, start: int):
    """The prefill's last logits and those of decode steps fed `forced`
    (b, k) tokens one at a time: (b, k + 1, vocab) f32."""
    logits, caches = model.prefill(params, batch, max_len=max_len)
    out = [logits[:, -1].float()]
    for n in range(forced.shape[1]):
        logits, caches = model.decode_step(params, forced[:, n:n + 1],
                                           caches, start + n)
        out.append(logits[:, -1].float())
    del caches
    return torch.stack(out, 1)


def frontend_serve_phase(arch: str, phase: int, dev, card) -> dict:
    """Phases 23 and 25: `arch` at its published widths through
    ``model.prefill`` / ``model.decode_step`` with the stub frontend
    inputs in the batch (``BatchServer`` admits by token-only prefill and
    refuses these families, as the reference's does), greedy, all
    requests of one prompt length: one prefill, then decode steps at one
    shared position. Counted: every kernel count set to 0 just before,
    read after the prefill and after the last step. Then the checks (the
    flash prefill and teacher-forced decode steps against dense attention,
    the plain function; Whisper's cross-attention caches unchanged by
    decode) and a traced prefill and 5 decode steps."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.models.transformer import uniform_stack

    cfg = get_arch(arch)
    requests, plen, new, max_len, n_forced = FRONTEND_SERVE[arch]
    check(per_prefill(cfg) == PER_PREFILL[arch],
          f"{arch}: launches per prefill {per_prefill(cfg)}")
    start = first_decode_pos(cfg, plen)
    check(start + new <= max_len, f"{arch}: {start} + {new} > {max_len}")
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.bfloat16,
                                          scan_layers=False))
    torch.cuda.synchronize()
    free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
    held_gib = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gib = sum(p.numel() * p.element_size()
                    for p in params.parameters()) / 2**30
    emit({"phase": "serve_setup", "n": phase, "arch": cfg.name,
          "family": cfg.family, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
          "enc_layers": cfg.encdec.enc_layers if cfg.encdec else None,
          "frontend_positions": (cfg.encdec.enc_seq if cfg.encdec
                                 else cfg.num_vision_patches),
          "per_prefill": per_prefill(cfg),
          "params": sum(p.numel() for p in params.parameters()),
          "param_gib": param_gib, "free_gib_before": free_gib,
          "allocated_gib_before": held_gib,
          "init_s": init_s, "layout": "unrolled",
          "requests": requests, "prompt_len": plen,
          "new_tokens": new, "max_len": max_len, "gpu": card})
    batch = frontend_batch(cfg, requests, plen, dev)
    model.prefill(params, {k: v[:1] for k, v in batch.items()},
                  max_len=max_len)                       # warm-up
    prefill = StepTimer(model.prefill)
    decode = StepTimer(model.decode_step)
    encode = StepTimer(model._encode) if cfg.family == "encdec" else None
    if encode is not None:
        model._encode = encode
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch, max_len=max_len)
    after_prefill = {k: fn.launches for k, fn in wrappers.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]
    cross = None
    if cfg.family == "encdec":
        cross = [{k: c[k].clone() for k in ("cross_k", "cross_v")}
                 for c in caches]
    for n in range(new - 1):
        logits, caches = decode(params, tok, caches, start + n)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if encode is not None:
        del model._encode
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = torch.cat(out, 1)
    check(tokens.shape == (requests, new), f"{arch}: tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{arch}: token id out of range")
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    for name, fn in wrappers.items():
        want = per_prefill(cfg).get(name, 0)
        check(after_prefill[name] == want and launches[name] == want,
              f"{arch}: {name} launched {after_prefill[name]} in the "
              f"prefill and {launches[name]} in all, expected {want} and "
              f"none in decode")
    cross_same = None
    if cross is not None:
        cross_same = all(torch.equal(c[k], kept[k]) for c, kept in
                         zip(caches, cross) for k in kept)
        check(cross_same, f"{arch}: decode changed cross_k/cross_v")
    del caches, cross, logits
    torch.cuda.empty_cache()
    prefill_s = prefill.calls[0]
    row = {"phase": "serve", "n": phase, "arch": cfg.name,
           "path": "model.prefill + model.decode_step",
           "requests": requests, "prompt_tokens": requests * plen,
           "output_tokens": requests * new, "decode_steps": len(decode.calls),
           "wall_s": wall, "prefill_ms": 1e3 * prefill_s,
           "decode_s": sum(decode.calls),
           "decode_step_ms_median": 1e3 * statistics.median(decode.calls),
           "output_tokens_per_s": requests * new / wall,
           "peak_mem_gib": peak,
           "launches": {k: v for k, v in launches.items()
                        if k in per_prefill(cfg)},
           "launches_in_prefill": {k: v for k, v in after_prefill.items()
                                   if k in per_prefill(cfg)},
           "cross_kv_unchanged_by_decode": cross_same, "gpu": card}
    if encode is not None:
        row["encoder_ms"] = 1e3 * encode.calls[0]
        row["decoder_prefill_ms"] = 1e3 * (prefill_s - encode.calls[0])
    emit(row)

    # checks: kernel against the plain function (dense attention) on the
    # prefill and teacher-forced decode steps fed the greedy tokens
    forced = tokens[:, 1:1 + n_forced]
    got = forced_logits(model, params, batch, forced, max_len, start)
    dense = build_model(cfg, ModelOptions(attn_impl="dense",
                                          dtype=torch.bfloat16,
                                          scan_layers=False))
    want = forced_logits(dense, params, batch, forced, max_len, start)
    diff = logit_diff(got, want)
    greedy_same = bool(torch.equal(got[:, 0].argmax(-1), tokens[:, 0]))
    del got, want
    torch.cuda.empty_cache()
    emit({"phase": "serve_checks", "n": phase, "arch": cfg.name,
          "flash_vs_dense_prefill_and_teacher_forced": dict(
              diff, steps=n_forced),
          "bounds": {"mean_abs": LOGIT_MEAN_BOUND,
                     "max_abs": LOGIT_MAX_BOUND},
          "first_token_equals_served": greedy_same, "gpu": card})
    within_bounds(diff, f"{arch} flash vs dense, prefill + {n_forced} steps")
    check(greedy_same, f"{arch}: the check's prefill chose other tokens")

    # where the time goes: a traced prefill and 5 decode steps
    logits, caches = model.prefill(params, batch, max_len=max_len)
    tok = logits[:, -1].argmax(-1, keepdim=True)

    def five():
        for n in range(5):
            model.decode_step(params, tok, caches, start + n)

    five()   # warm (the positions are rewritten by the traced steps)
    emit({"phase": "serve_profile", "n": phase, "arch": cfg.name,
          "prefill": traced(lambda: model.prefill(params, batch,
                                                  max_len=max_len)),
          "decode_5_steps": traced(five), "gpu": card})
    del caches, logits, params, model, dense
    torch.cuda.empty_cache()
    if uniform_stack(cfg):
        scanned_draw_check(cfg, batch, max_len, phase, dev, card)
    return {"launches": launches, "row": row}


def scanned_draw_check(cfg, batch, max_len: int, phase: int, dev,
                       card) -> None:
    """The scanned layout's draw of `cfg` (stacked leaves, fan_in = the
    layer count, as the reference's init takes it): the prefill's logits
    under flash against dense attention, reported and not held. Its
    weights are sqrt(d_model / layers) larger than the unrolled draw's, so
    without qk-norm its attention scores and activations amplify every
    rounding (ROADMAP.md Queue 3)."""
    from repro_torch.models.model import ModelOptions, build_model

    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.bfloat16))
    dense = build_model(cfg, ModelOptions(attn_impl="dense",
                                          dtype=torch.bfloat16))
    params = model.init(0, dev)
    got, _ = model.prefill(params, batch, max_len=max_len)
    want, _ = dense.prefill(params, batch, max_len=max_len)
    emit({"phase": "serve_checks", "n": phase, "arch": cfg.name,
          "layout": "scanned (fan_in = layers)",
          "flash_vs_dense_prefill": logit_diff(got, want),
          "wq_std_scanned_over_unrolled": float(
              params["layers"]["attn"]["wq"][0].float().std())
          * cfg.d_model ** 0.5, "held": False, "gpu": card})
    del got, want, params, model, dense
    torch.cuda.empty_cache()


def encdec_train_flops(cfg, batch: int, seq: int) -> dict:
    """FLOPs of one encoder-decoder training step. Model FLOPs
    6·(N_enc·enc_seq + N_dec·seq)·batch: the encoder's layers, the frame
    projection and every decoder layer's cross-attention K/V projections
    run over the enc_seq frames (N_enc), the rest of the decoder's layers
    over the text (N_dec); the tied head's product (6·V·d a token) and the
    dense attention's einsums (QK^T and PV over the whole squares, three
    times the forward: the forward and two backward products) beside
    them."""
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    enc, layers = cfg.encdec.enc_layers, cfg.num_layers
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    kv = 2 * d * cfg.num_kv_heads * hd
    ffn = 3 * d * cfg.d_ff
    n_enc = (attn + ffn) * enc + d * d + kv * layers
    n_dec = (2 * attn - kv + ffn) * layers
    check(n_enc + n_dec + cfg.vocab_size * d == cfg.num_params() + d * d,
          "encdec_train_flops: the counts miss a weight")
    es = cfg.encdec.enc_seq
    attn_fwd = 4 * batch * h * hd * (enc * es * es
                                     + layers * (seq * seq + seq * es))
    return {"n_enc": n_enc, "n_dec": n_dec,
            "model_flops": 6 * (n_enc * es + n_dec * seq) * batch,
            "head_flops": 6 * cfg.vocab_size * d * seq * batch,
            "attention_flops": 3 * attn_fwd}


def whisper_train_phase(dev, card, kernel_ops) -> dict:
    """Phase 24: Whisper-base trained at its published widths as
    ``launch/train.py``'s ``build_run`` sets it up (remat "full", AdamW,
    the synthetic data pipeline, the reference's float32 stub frames),
    16 x 448 text tokens and 16 x 1500 frames a step, no mesh: the first
    loss on the CPU (the same parameters and batch, forward only), then a
    warm-up step and 4 timed steps (host clock, each ending in the
    metrics' read-back) and one traced step."""
    import dataclasses

    from repro_torch.launch.train import build_run
    from repro_torch.models.layers import tree_map
    from repro_torch.runtime.trainer import Trainer

    run = build_run("whisper-base", reduced=False, steps=TRAIN_STEPS + 1,
                    global_batch=WHISPER_TRAIN_BATCH,
                    seq_len=WHISPER_TRAIN_SEQ,
                    checkpoint_dir=str(ROOT / "build" / "chip_smoke_ckpt"))
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_every=10 ** 9))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = Trainer(run, device=dev)
    t.init_state(seed=0)
    cfg = t.run.model
    # the first step's loss on the CPU: forward only, same inputs
    host = tree_map(lambda p: p.detach().cpu(), t.params)
    batch = {k: v.cpu() for k, v in t._place_batch(0).items()}
    check(batch["frames"].dtype == torch.float32, "stub frames not f32")

    def cpu_first_loss():
        with torch.no_grad():
            return float(t.model.train_loss(host, batch))

    cpu_loss, cpu_s = timed(cpu_first_loss)
    del host, batch
    before = launch_counts(kernel_ops)
    times = []
    for _ in range(TRAIN_STEPS):
        _, dt = timed(lambda: t.train(1))
        times.append(dt)
    launches = launch_counts(kernel_ops) - before
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log = t.metrics_log
    tokens = WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ
    step_s = statistics.median(times[1:])
    flops = encdec_train_flops(cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ)
    first = log[0]["loss"]
    row = {"phase": "train", "n": 24, "arch": cfg.name,
           "batch": WHISPER_TRAIN_BATCH, "seq": WHISPER_TRAIN_SEQ,
           "enc_seq": cfg.encdec.enc_seq, "frames_dtype": "float32",
           "remat": t.run.parallel.remat, "attn_impl": t.options.attn_impl,
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * x for x in times[1:]],
           "warmup_step_ms": 1e3 * times[0],
           "tokens_per_s": tokens / step_s,
           "frames_per_s": WHISPER_TRAIN_BATCH * cfg.encdec.enc_seq / step_s,
           "mfu": flops["model_flops"] / step_s / BF16_FLOPS, **flops,
           "peak_mem_gib": peak,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "first_loss_cpu": cpu_loss, "cpu_forward_s": cpu_s,
           "first_loss_rel_diff": abs(first - cpu_loss) / abs(cpu_loss),
           "first_loss_rtol": TRAIN_LOSS_RTOL,
           "kernel_launches": launches, "gpu": card}
    emit(row)
    check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]),
          "whisper train: non-finite loss or norm")
    check(launches == 0, "whisper train: a kernel of the port launched")
    check(row["first_loss_rel_diff"] <= TRAIN_LOSS_RTOL,
          f"whisper train: first loss {first} vs CPU {cpu_loss}")
    prof = traced_families(lambda: t.train(1), family)
    check(launch_counts(kernel_ops) - before == 0,
          "whisper train: a kernel of the port launched in the traced step")
    emit({"phase": "train_profile", "n": 24, "arch": cfg.name, **prof,
          "gpu": card})
    del t
    torch.cuda.empty_cache()
    return row


# ------------------------------------------- 26-27. the recurrent training
def rel_errs(names, got, want) -> dict:
    """Each gradient's max |error| over its own largest magnitude."""
    return {name: float((g.float() - w.float()).abs().max()
                        / w.float().abs().max().clamp_min(1e-30))
            for name, g, w in zip(names, got, want)}


def plain_bwd_ms(forward, leaves, cots) -> float:
    """CUDA-event time of the plain backward alone: the plain forward's
    graph built once, then autograd.grad through it (retain_graph)."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        outs = forward(*leaves)
    ms = time_ms(lambda: torch.autograd.grad(outs, leaves, cots,
                                             retain_graph=True), reps=3)
    del outs
    return ms


def lru_bwd_case(lru_ops, lru_ref, dev, card, b, l, w, with_h0,
                 tag=None) -> dict:
    """Phase 26: lru_scan_bwd against the plain backward (autograd of the
    plain version) on the same inputs and cotangents: each gradient within
    LRU_TOL of its largest magnitude, two calls bit-equal; CUDA-event
    times; bound from the bytes (a, h, dh read, da, db written, and with
    h0: h0, dh_last read, dh0 written)."""
    gen = torch.Generator(device=dev).manual_seed(l + w + b + with_h0)
    a = 0.5 + 0.49 * torch.rand((b, l, w), generator=gen, device=dev)
    x = torch.randn((b, l, w), generator=gen, device=dev)
    h0 = torch.randn((b, w), generator=gen, device=dev) if with_h0 else None
    dh = torch.randn((b, l, w), generator=gen, device=dev)
    dl = torch.randn((b, w), generator=gen, device=dev) if with_h0 else None
    h, _ = lru_ops._launch(a, x, h0)
    names = ("da", "db", "dh0") if with_h0 else ("da", "db")
    got = lru_ops._launch_bwd(a, h, h0, dh, dl)[:len(names)]
    again = lru_ops._launch_bwd(a, h, h0, dh, dl)[:len(names)]
    want = lru_ref.lru_scan_vjp_ref(a, x, h0, dh, dl)[:len(names)]
    torch.cuda.synchronize()
    errs = rel_errs(names, got, want)
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    bit_equal = all(torch.equal(g, g2) for g, g2 in zip(got, again))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"lru bwd: non-finite gradient at {(b, l, w)}")
    check(bit_equal, "lru bwd: two calls differ")
    check(max(errs.values()) <= LRU_TOL,
          f"lru bwd off the plain backward: {errs} at {(b, l, w, with_h0)}")
    del got, again, want
    k_ms = time_ms(lambda: lru_ops._launch_bwd(a, h, h0, dh, dl))
    leaves = [a, x] + ([h0] if with_h0 else [])
    p_ms = plain_bwd_ms(
        lambda *t: lru_ref.lru_scan_ref(t[0], t[1],
                                        t[2] if with_h0 else None)[
            :2 if with_h0 else 1],
        leaves, [dh, dl] if with_h0 else [dh])
    nbytes = 5 * a.numel() * 4 + (3 * b * w * 4 if with_h0 else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * a.numel() / F32_FLOPS * 1e3   # a fma and a product a step
    row = {"phase": "recurrent_bwd", "n": 26, "kernel": "lru_scan_bwd",
           "shape": [b, l, w], "dtype": "f32", "h0": with_h0,
           "rel_err": errs, "tol": LRU_TOL, "max_abs_err": abs_err,
           "bit_equal": bit_equal, "kernel_ms": k_ms, "plain_ms": p_ms,
           "library_ms": None, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "mbytes": nbytes / 1e6, "kernel_gb_per_s": nbytes / k_ms / 1e6,
           "gpu": card, **(tag or {})}
    emit(row)
    return row


def ssd_bwd_flops(b, c, q, h, p, n) -> int:
    """The products of ssd_chunk_bwd's causal half: per (b, c) S = C B^T,
    dC and dB's q x q part (each q(q+1)/2 dot products of n); per head dM
    and M^T dY (q(q+1)/2 dot products of p each), V = dSt^T B_j and the
    states' dSt u_j (q n p each)."""
    qq = q * (q + 1)
    return b * c * (3 * qq * n + h * (2 * qq * p + 4 * q * n * p))


def ssd_bwd_inputs(dev, dtype_name, shape):
    """(x, dt, A, B, C, dy, dst, ddi): the SSD backward's inputs and
    random cotangents at `shape` (b, l, h, p, n, chunk), seeded by it."""
    import torch.nn.functional as F

    b, l, h, p, n, chunk = shape
    c = l // chunk
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(l + h + p + n)
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=dev))
    A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    dy = torch.randn((b, c, chunk, h, p), generator=gen, device=dev)
    dst = torch.randn((b, c, h, n, p), generator=gen, device=dev)
    ddi = torch.randn((b, c, chunk, h), generator=gen, device=dev)
    return x, dt, A, B, C, dy, dst, ddi


def ssd_bwd_device_kernels(ssd_ops, dev, dtype_name, shape) -> list:
    """The device time of each kernel of ssd_chunk_bwd (``ssd_bwd::``
    names) in one traced backward under autograd, as training runs it (the
    profiler ties the ctypes launches to the backward node's range)."""
    x, dt, A, B, C, dy, dst, ddi = ssd_bwd_inputs(dev, dtype_name, shape)
    xg = x.detach().requires_grad_(True)
    outs = ssd_ops.chunk_terms_kernel(xg, dt, A, B, C, shape[-1])
    torch.autograd.grad(outs, xg, (dy, dst, ddi), retain_graph=True)
    return [k for k in traced_families(
        lambda: torch.autograd.grad(outs, xg, (dy, dst, ddi),
                                    retain_graph=True),
        recurrent_family)["port_kernels"] if "ssd_bwd" in k["name"]]


def fresh_ssd_bwd_kernels(cases) -> dict:
    """:func:`ssd_bwd_device_kernels` for each (dtype name, shape) of
    `cases`, all traced in one fresh Python process (the kernels it loads
    are the ones phase 1 built). In a process that has run many profiler
    windows the profiler loses the earliest CUDA records of a window:
    traced inside a whole run, this phase's backward came back with no
    kernel, and one window of five backwards kept only the last one's
    later kernels, while a fresh process keeps them all. One process for
    all the cases (a window each) starts the card once, not once a
    case; :func:`ssd_bwd_case` still fails on a row that names no
    kernel."""
    listed = [(d, list(s)) for d, s in cases]
    code = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import chip_smoke as cs\n"
        "from repro_torch.kernels.ssd_scan import ops\n"
        "dev = torch.device('cuda', 0)\n"
        "print(json.dumps([cs.ssd_bwd_device_kernels(ops, dev, d, tuple(s))\n"
        f"                  for d, s in {listed!r}]))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    check(run.returncode == 0, f"ssd bwd traces: {run.stderr[-2000:]}")
    rows = json.loads(run.stdout.strip().splitlines()[-1])
    return {(d, tuple(shape)): row for (d, shape), row in zip(cases, rows)}


def ssd_bwd_case(ssd_ops, ssd_ref, dev, card, dtype_name,
                 shape=SSD_BWD_SHAPE, tag=None, device_kernels=None) -> dict:
    """Phase 26: ssd_chunk_bwd against the plain backward (autograd of
    ssd_chunk_terms) at Mamba-2 780M's training shape (or `shape`: b, l,
    h, p, n, chunk), random cotangents
    of y_diag, states and decay_in: each gradient within SSD_TOL of its
    largest magnitude, two calls bit-equal; CUDA-event times; bound the
    larger of the bytes (inputs, cotangents, gradients once each) and the
    causal half's products at the input type's peak; `device_kernels`, the
    device time of each of its kernels (:func:`fresh_ssd_bwd_kernels`),
    must name some. `tag` adds keys to the row."""
    b, l, h, p, n, chunk = shape
    c = l // chunk
    x, dt, A, B, C, dy, dst, ddi = ssd_bwd_inputs(dev, dtype_name, shape)
    names = ("dx", "ddt", "dA", "dB", "dC")

    def kernel():
        return ssd_ops._launch_bwd(x, dt, A, B, C, chunk, dy, dst, ddi)

    got, again = kernel(), kernel()
    parts = (x.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h), A,
             B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n))
    cots = (dy, dst.transpose(-1, -2), ddi)
    want = ssd_ref.ssd_chunk_terms_vjp_ref(*parts, *cots)
    torch.cuda.synchronize()
    got = [g.reshape(w_.shape) for g, w_ in zip(got, want)]
    again = [g.reshape(w_.shape) for g, w_ in zip(again, want)]
    errs = rel_errs(names, got, want)
    abs_err = max(float((g.float() - w_.float()).abs().max())
                  for g, w_ in zip(got, want))
    bit_equal = all(torch.equal(g, g2) for g, g2 in zip(got, again))
    tol = SSD_TOL[dtype_name]
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"ssd bwd: non-finite gradient ({dtype_name})")
    check(bit_equal, f"ssd bwd: two calls differ ({dtype_name})")
    check(max(errs.values()) <= tol,
          f"ssd bwd off the plain backward: {errs} ({dtype_name})")
    del got, again, want
    k_ms = time_ms(kernel)
    check(bool(device_kernels), f"ssd bwd: no kernel in the trace "
          f"({dtype_name}, {shape})")
    p_ms = plain_bwd_ms(
        lambda *t: [o for i, o in enumerate(ssd_ref.ssd_chunk_terms(*t))
                    if i != 2], parts, cots)
    flops = ssd_bwd_flops(b, c, chunk, h, p, n)
    item = x.element_size()
    nbytes = (2 * (x.numel() + B.numel() + C.numel()) * item
              + 4 * (2 * dt.numel() + 2 * h + dy.numel() + dst.numel()
                     + ddi.numel()))
    peak = BF16_FLOPS if dtype_name == "bf16" else F32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "recurrent_bwd", "n": 26, "kernel": "ssd_chunk_bwd",
           "shape": [b, l, h, p, n], "chunk": chunk, "dtype": dtype_name,
           "rel_err": errs, "tol": tol, "max_abs_err": abs_err,
           "bit_equal": bit_equal, "kernel_ms": k_ms, "plain_ms": p_ms,
           "library_ms": None, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "kernel_tflops": flops / k_ms / 1e9,
           "device_kernels": device_kernels, "gpu": card, **(tag or {})}
    emit(row)
    return row


@contextlib.contextmanager
def plain_scans_counted():
    """While entered, counts the calls of the scans' plain versions (the
    LRU scan and the SSD chunk terms): the training path on the card must
    make none."""
    from repro_torch.kernels.lru_scan import ref as lru_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    calls = {"lru_scan_ref": 0, "ssd_chunk_terms": 0}
    saved = [(mod, name, getattr(mod, name))
             for mod, name in ((lru_ref, "lru_scan_ref"),
                               (ssd_ref, "ssd_chunk_terms"))]
    for mod, name, fn in saved:
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def recurrent_family(name: str, ranges) -> str:
    """Phase 19's op families, with the f32 and f64 products of the
    recurrent blocks named (the RG-LRU's gates and Mamba-2's dt; the dense
    attention's scores in RecurrentGemma's 8 attention layers)."""
    low = name.lower()
    if "dgemm" in low or "gemm_f64" in low:
        return "f64 gemm (Mamba-2 dt)"
    fam = family(name, ranges)
    return ("f32 gemm (RG-LRU gates, attention)"
            if fam == "f32 gemm (attention)" else fam)


def recurrent_train_flops(cfg, tokens: int) -> dict:
    """6·N·tokens, N the parameters less the embedding (as phase 18);
    beside it the tied head's logits (RecurrentGemma reads the embedding
    as its head, so N leaves them out)."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.d_model
    head = cfg.vocab_size * cfg.d_model if cfg.tie_embeddings else 0
    return {"n_matmul": n_matmul, "model_flops": 6 * n_matmul * tokens,
            "tied_head_flops": 6 * head * tokens}


def recurrent_train_phase(arch: str, dev, card) -> dict:
    """Phase 27 for one arch: the full-width model trained as phase 18
    (bf16, seed 0, scanned where the stack is uniform, remat "full",
    AdamW, 8 x 2048 tokens of phase 18's data, no mesh), the counts of the
    scans' wrappers set to 0 just before the steps and read just after,
    with the plain scans counted; then one traced step by op family."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = train_run("hdot", None, dev=dev, arch=arch)
    t.init_state(seed=0)
    cfg = t.run.model
    wrappers = {"ssd_scan": ssd_ops.ssd, "lru_scan": lru_ops.lru_scan,
                "flash_attention": flash_ops.flash_attention}
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "bwd_launches"):
            w.bwd_launches = 0
    times = []
    with plain_scans_counted() as plain:
        for _ in range(TRAIN_STEPS):
            _, s = timed(lambda: t.train(1))
            times.append(s)
    counts = {k: {"fwd": w.launches, "bwd": getattr(w, "bwd_launches", 0)}
              for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    plain = dict(plain)
    log = t.metrics_log
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    flops = recurrent_train_flops(cfg, tokens)
    scan = "ssd_scan" if cfg.family == "ssm" else "lru_scan"
    layers = per_prefill(cfg)[scan]
    # remat "full": each recurrent layer's forward runs again in the
    # backward's recompute, then its backward once
    want = {"fwd": 2 * layers * TRAIN_STEPS, "bwd": layers * TRAIN_STEPS}
    row = {"phase": "train", "n": 27, "arch": cfg.name,
           "vocab": cfg.vocab_size, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "remat": t.run.parallel.remat, "scan_layers": True,
           "attn_impl": t.options.attn_impl,
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * x for x in times[1:]],
           "warmup_step_ms": 1e3 * times[0],
           "tokens_per_s": tokens / step_s,
           "mfu": flops["model_flops"] / step_s / BF16_FLOPS, **flops,
           "mfu_note": "6·N·tokens over 989 TFLOP/s, N the parameters "
                       "less the embedding; misses the SSD's within-chunk "
                       "products, the scans, the dense attention's scores, "
                       "the remat recompute and a tied head's logits",
           "peak_mem_gib": peak,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "ln_vocab": math.log(cfg.vocab_size),
           "launches": counts, "launches_expected": {scan: want},
           "recurrent_layers": layers, "plain_scan_calls": plain,
           "gpu": card}
    emit(row)
    check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]),
          f"{arch} train: non-finite loss or norm")
    check(abs(row["losses"][0] - row["ln_vocab"]) <= 1.0,
          f"{arch} train: first loss {row['losses'][0]}")
    check(counts[scan] == want,
          f"{arch} train: {scan} launched {counts[scan]}, want {want}")
    check(all(v == {"fwd": 0, "bwd": 0} for k, v in counts.items()
              if k != scan),
          f"{arch} train: another kernel launched: {counts}")
    check(not any(plain.values()), f"{arch} train: a plain scan ran: {plain}")
    prof = traced_families(lambda: t.train(1), recurrent_family)
    emit({"phase": "train_profile", "n": 27, "arch": cfg.name, **prof,
          "gpu": card})
    check(prof["families_ms"]["port kernels"] > 0,
          f"{arch} train: no kernel of the port in the traced step")
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts}


def tp_scans_phase(lru_ops, lru_ref, ssd_ops, ssd_ref, dev, card,
                   device_kernels) -> None:
    """Phase 28: each scan kernel, forward and backward, at the blocks a
    rank of tensor-parallel training over 4 cards gives it
    (TP_SSD_SHAPES, bf16; TP_LRU_SHAPES, f32), held against its plain
    version as in phases 10-11 and 26, each row with its time and bound
    (tagged ``"n": 28`` and the mesh it stands for). The launches made
    here are comparisons, not the main path's."""
    for shape, mesh in zip(TP_SSD_SHAPES, ("1x4", "2x2")):
        tag = {"n": 28, "tp_mesh": mesh}
        ssd_case(ssd_ops, ssd_ref, dev, card, *shape, "bf16",
                 tag=dict(tag, phase="tp_ssd"))
        ssd_bwd_case(ssd_ops, ssd_ref, dev, card, "bf16", shape,
                     tag=dict(tag, phase="tp_ssd_bwd"),
                     device_kernels=device_kernels[("bf16", shape)])
    for (b, l, w), mesh in zip(TP_LRU_SHAPES, ("1x4", "2x2")):
        tag = {"n": 28, "tp_mesh": mesh}
        lru_case(lru_ops, dev, card, b, l, w, "f32", False,
                 tag=dict(tag, phase="tp_lru"))
        lru_bwd_case(lru_ops, lru_ref, dev, card, b, l, w, False,
                     tag=dict(tag, phase="tp_lru_bwd"))
    gc.collect()
    torch.cuda.empty_cache()


def cells_phase(flash_ops, dev, card) -> dict:
    """Phase 29: Qwen3-8B at its published widths (bf16, seed 0, scanned)
    through the prefill and decode cells of ``build_cell`` on a one-rank
    ("data", "model") mesh (``cell_step``; the cut's collectives are
    no-ops on one rank, the blocks are the whole leaves): 4 prompts of
    2048 tokens (numpy seed 29) into 32768-slot rings, then 32
    teacher-forced decode steps at a scalar position. Counted: every
    kernel count set to 0 just before the cells run, read after (36
    flash launches for the prefill, nothing else). Then the same tokens
    through ``model.prefill`` / ``decode_step`` on the same tree: every
    logit bit-equal. Prefill tokens/s and decode ms (host clock, each
    call ending in a synchronize), GiB of parameters and rings at rest,
    the peak."""
    import numpy as np

    from repro_torch.config.registry import get_arch
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell, cell_step, relayout
    from repro_torch.models.model import ModelOptions

    cfg = get_arch(CELLS["arch"])
    b, plen, ring, steps = (CELLS["batch"], CELLS["prompt"], CELLS["ring"],
                            CELLS["steps"])
    opts = ModelOptions(attn_impl="flash", dtype=torch.bfloat16)
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    pre = build_cell(cfg, ShapeConfig("prefill_2k", plen, b, "prefill"),
                     opts)
    dec = build_cell(cfg, ShapeConfig("decode_32k", ring, b, "decode"), opts)
    prefill, decode = cell_step(pre, mesh), cell_step(dec, mesh)
    model = pre.model
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, dev)
    blocks = prefill.plan.init_params(params=params, device=dev)
    check(all(x.data_ptr() == y.data_ptr() for x, y in zip(
        blocks.parameters(), params.parameters())),
          "cells: a one-rank block is a copy, not the leaf itself")
    param_gib = (torch.cuda.memory_allocated(dev) - base) / 2**30
    toks = torch.tensor(np.random.default_rng(29).integers(
        1, cfg.vocab_size, (b, plen + steps)), device=dev)
    model.prefill(params, {"tokens": toks[:1, :128]})          # warm-up
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, caches = prefill(blocks, {"tokens": toks[:, :plen]},
                             max_len=ring)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    caches = relayout(caches, prefill.plan.cache_shardings(ring),
                      dec.in_shardings(mesh)[1], mesh)
    cache_gib = sum(x.numel() * x.element_size()
                    for x in _leaves(caches)) / 2**30
    got, times = [logits], []
    for t in range(steps):
        t1 = time.perf_counter()
        lg, caches = decode(blocks, caches, toks[:, plen + t:plen + t + 1],
                            plen + t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        got.append(lg)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "cells: non-finite logits")
    check(launches == {"flash_attention": 36, "lru_scan": 0, "ssd_scan": 0},
          f"cells: launches {launches}")
    del caches
    torch.cuda.empty_cache()
    with torch.no_grad():
        want, wc = model.prefill(params, {"tokens": toks[:, :plen]},
                                 max_len=ring)
        equal = [torch.equal(got[0], want)]
        for t in range(steps):
            want, wc = model.decode_step(params,
                                         toks[:, plen + t:plen + t + 1], wc,
                                         plen + t)
            equal.append(torch.equal(got[t + 1], want))
    check(all(equal), f"cells != model.prefill/decode_step: {equal}")
    row = {"phase": "cells", "n": 29, "arch": cfg.name, "mesh": [1, 1],
           "batch": b, "prompt_len": plen, "ring": ring, "steps": steps,
           "prefill_s": prefill_s, "prefill_tokens_per_s": b * plen
           / prefill_s, "decode_ms_median": 1e3 * statistics.median(times),
           "decode_ms_first": 1e3 * times[0], "param_gib": param_gib,
           "ring_gib": cache_gib, "peak_gib": peak, "launches": launches,
           "bit_equal_steps": sum(equal), "gpu": card}
    emit(row)
    del params, blocks, wc, got, want
    return row


def moe_active_params(cfg) -> int:
    """N_active of a MoE config: the parameters a token's forward
    multiplies, top-k of the experts counted, the embedding lookup left
    out (the untied head counted)."""
    return cfg.active_params() - cfg.vocab_size * cfg.d_model


def step_memory(run, dev, base: int, what) -> dict:
    """The bytes held over `base` just before one more call of `run` (a
    step) and the most allocated over `base` during it (the peak counter
    reset just before), for phase 32; `what` is kept beside them."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize()
    return {"held": held, "peak": torch.cuda.max_memory_allocated(dev) - base,
            "what": what}


def moe_train_phase(dev, card, kernel_ops, measured) -> dict:
    """Phase 30: Qwen3-30B-A3B at its published widths (d_model 2048, 32/4
    heads of 128, 128 experts of 768, top-8, capacity 1.25, vocab 151936)
    with 4 of its 48 layers, bf16, seed 0, unrolled, AdamW, 8 x 2048
    tokens of phase 18's data a step, no mesh (one rank: the dense
    capacity dispatch, as the reference takes on one device), trained
    through the Trainer under remat "full" and then "dots": a warm-up and
    3 timed steps each (host clock around each step's read-back). Step
    ms, tokens/s, MFU on N_active, peak GiB, the share of routed
    assignments capacity dropped in the warm-up step (:class:`MoeProbe`;
    the recompute routes again and counts again, the share is the same),
    and whether the two remats' losses are bit-equal (the
    first step's must be: the same forward; later ones follow gradients
    whose scatter-adds sum in no fixed order on the card). No kernel of
    the port is on the path (dense attention): the launch counts must
    not move. Under "full", one more step's memory goes into
    `measured["moe_train"]` (:func:`step_memory`) for phase 32."""
    rows = {}
    for remat in MOE_REMATS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts(kernel_ops)
        t = train_run("hdot", None, dev=dev, arch=MOE_TRAIN["arch"],
                      scan=False, steps=MOE_TRAIN["steps"],
                      layers=MOE_TRAIN["layers"], remat=remat)
        t.init_state(seed=0)
        cfg = t.run.model
        with MoeProbe() as probe:
            times = [timed(lambda: t.train(1))[1]]
        times += [timed(lambda: t.train(1))[1]
                  for _ in range(MOE_TRAIN["steps"] - 1)]
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        launches = launch_counts(kernel_ops) - before
        tokens = TRAIN_BATCH * TRAIN_SEQ
        step_s = statistics.median(times[1:])
        n_active = moe_active_params(cfg)
        log = t.metrics_log
        row = {"phase": "moe_train", "n": 30, "arch": cfg.name,
               "layers": cfg.num_layers, "layers_published": 48,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": remat,
               "scan_layers": False, "attn_impl": t.options.attn_impl,
               "dispatch": "dense (one rank)",
               "step_ms_median": 1e3 * step_s,
               "step_ms": [1e3 * x for x in times[1:]],
               "warmup_step_ms": 1e3 * times[0],
               "tokens_per_s": tokens / step_s, "n_active": n_active,
               "mfu": 6 * n_active * tokens / step_s / BF16_FLOPS,
               "mfu_note": "6·N_active·tokens over 989 TFLOP/s: 8 of the "
                           "128 experts a token, the embedding left out, "
                           "the head counted; misses capacity padding, "
                           "dense attention's scores and the recompute",
               "peak_mem_gib": peak,
               "losses": [m["loss"] for m in log],
               "grad_norms": [m["grad_norm"] for m in log],
               "ln_vocab": math.log(cfg.vocab_size),
               "dropped_share_warmup": int(probe.dropped)
               / max(probe.routed, 1),
               "kernel_launches": launches, "gpu": card}
        emit(row)
        check(all(math.isfinite(x) for x in row["losses"]
                  + row["grad_norms"]), f"moe train {remat}: non-finite")
        check(abs(row["losses"][0] - row["ln_vocab"]) <= 1.0,
              f"moe train {remat}: first loss {row['losses'][0]}")
        check(launches == 0, f"moe train {remat}: a kernel of the port "
              f"launched ({launches})")
        rows[remat] = row
        if remat == "full":
            measured["moe_train"] = step_memory(
                lambda: t.train(1), dev, base,
                (cfg, t.options, t.run.parallel))
        del t
    full, dots = (rows[r]["losses"] for r in MOE_REMATS)
    check(full[0] == dots[0], f"moe train: first losses differ {full[0]} "
          f"{dots[0]}")
    out = {"phase": "moe_train_remats", "n": 30,
           "losses_bit_equal": full == dots,
           "first_loss_bit_equal": full[0] == dots[0],
           "peak_gib": {r: rows[r]["peak_mem_gib"] for r in MOE_REMATS},
           "step_ms": {r: rows[r]["step_ms_median"] for r in MOE_REMATS},
           "gpu": card}
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def blockwise_cell_phase(flash_ops, dev, card, measured) -> dict:
    """Phase 31: Qwen3-8B at its published widths (bf16, seed 0) through
    its ``prefill_32k`` cell as ``build_cell`` makes it (blockwise
    attention: chunks of 1024 query rows against every key, dense f32
    scores) on a one-rank ("data", "model") mesh, with 1 prompt of the
    shape's 32 (numpy seed 31; 32768 tokens into a 32768-slot ring);
    every kernel count set to 0 just before, read after (none: blockwise
    runs no kernel). Prefill tokens/s (host clock around the call and a
    synchronize) and the peak GiB over the parameters. Then
    ``model.prefill`` with ``attn_impl="flash"`` on the same tree and
    prompt (36 flash launches): the logits within the bf16 bounds of two
    full-width runs. The cell step's memory (held before it, its peak,
    both over the bytes allocated before the parameters) goes into
    `measured["blockwise_cell"]` for phase 32."""
    import numpy as np

    from repro_torch.config.registry import get_arch
    from repro_torch.config.shapes import SHAPES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell, cell_step
    from repro_torch.models.model import build_model

    cfg = get_arch(BLOCKWISE["arch"])
    shape = dataclasses.replace(SHAPES[BLOCKWISE["shape"]],
                                global_batch=BLOCKWISE["batch"])
    cell = build_cell(cfg, shape)
    model = cell.model
    check(model.opt.attn_impl == "blockwise",
          f"blockwise: build_cell chose {model.opt.attn_impl!r}")
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    step = cell_step(cell, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    params = model.init(0, dev)
    blocks = step.plan.init_params(params=params, device=dev)
    param_gib = (torch.cuda.memory_allocated(dev) - base) / 2**30
    s = shape.seq_len
    toks = torch.tensor(np.random.default_rng(31).integers(
        1, cfg.vocab_size, (shape.global_batch, s)), device=dev)
    wrappers = counted_wrappers()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, caches = step(blocks, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    measured["blockwise_cell"] = {
        "held": held, "peak": torch.cuda.max_memory_allocated(dev) - base,
        "what": cell}
    del caches
    torch.cuda.empty_cache()
    flash = build_model(cfg, dataclasses.replace(model.opt,
                                                 attn_impl="flash"))
    for fn in wrappers.values():
        fn.launches = 0
    with torch.no_grad():
        t1 = time.perf_counter()
        want, wc = flash.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - t1
    flash_launches = {k: fn.launches for k, fn in wrappers.items()}
    del wc
    diff = logit_diff(logits, want)
    row = {"phase": "blockwise_cell", "n": 31, "arch": cfg.name,
           "shape": shape.name, "batch": shape.global_batch,
           "batch_published": SHAPES[BLOCKWISE["shape"]].global_batch,
           "prompt_len": s, "attn_impl": model.opt.attn_impl,
           "scan_layers": model.opt.scan_layers, "mesh": [1, 1],
           "prefill_s": prefill_s, "prefill_tokens_per_s":
           shape.global_batch * s / prefill_s, "param_gib": param_gib,
           "peak_gib_over_params": peak - param_gib, "peak_gib": peak,
           "launches": launches, "flash_prefill_s": flash_s,
           "flash_launches": flash_launches, "vs_flash": diff,
           "bounds": {"mean_abs": LOGIT_MEAN_BOUND,
                      "max_abs": LOGIT_MAX_BOUND}, "gpu": card}
    emit(row)
    check(bool(torch.isfinite(logits).all()), "blockwise: non-finite logits")
    check(tuple(logits.shape) == (shape.global_batch, 1, cfg.vocab_size),
          f"blockwise: logits {tuple(logits.shape)}")
    check(not any(launches.values()),
          f"blockwise: a kernel launched in the cell: {launches}")
    check(flash_launches["flash_attention"] == cfg.num_layers,
          f"blockwise: flash prefill launches {flash_launches}")
    within_bounds(diff, "blockwise cell vs flash prefill")
    del params, blocks, logits, want, flash
    gc.collect()
    torch.cuda.empty_cache()
    return row


def dryrun_phase(dev, card, measured) -> list:
    """Phase 32: the dry run's estimate (``Cell.lower(mesh).compile()``:
    one pass of the cell's step under fake CPU tensors, the bytes of live
    storages tracked, no card) of phase 30's remat "full" step
    (Qwen3-30B-A3B, 4 layers, 8 x 2048 tokens, no mesh) and phase 31's
    ``prefill_32k`` cell at batch 1 (Qwen3-8B, a one-rank mesh), each
    against what the card allocated in that phase's measured step
    (:func:`step_memory`): the estimate (arguments + temp) beside
    ``torch.cuda.max_memory_allocated`` over the bytes held before the
    phase, the arguments beside the bytes held before the step (the
    batch is placed inside the step), and the dry run's FLOPs beside
    6·N_active·tokens. Fails where the estimate misses the measured peak
    by more than 15%."""
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell

    mesh = make_mesh((1, 1), ("data", "model"), dev)
    cfg, options, parallel = measured["moe_train"]["what"]
    cells = {"moe_train": build_cell(
        cfg, ShapeConfig("train_4layers", TRAIN_SEQ, TRAIN_BATCH, "train"),
        options, parallel), "blockwise_cell": measured["blockwise_cell"][
            "what"]}
    rows = []
    for name, cell in cells.items():
        m = measured[name]
        t0 = time.perf_counter()
        compiled = cell.lower(mesh).compile()
        seconds = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        est = mem.argument_size_in_bytes + mem.temp_size_in_bytes
        shape = cell.shape
        tokens = shape.global_batch * shape.seq_len
        n_active = moe_active_params(cell.model.cfg)
        model_flops = (6 if cell.kind == "train" else 2) * n_active * tokens
        flops = compiled.cost_analysis()["flops"]
        row = {"phase": "dryrun_estimate", "n": 32, "cell": name,
               "arch": cell.model.cfg.name,
               "layers": cell.model.cfg.num_layers, "kind": cell.kind,
               "tokens": tokens, "impl": compiled.notes,
               "argument_gib": mem.argument_size_in_bytes / 2**30,
               "temp_gib": mem.temp_size_in_bytes / 2**30,
               "estimate_gib": est / 2**30,
               "measured_peak_gib": m["peak"] / 2**30,
               "held_before_step_gib": m["held"] / 2**30,
               "rel_err": est / m["peak"] - 1.0,
               "flops": flops, "model_flops": model_flops,
               "model_flops_note": f"{6 if cell.kind == 'train' else 2}"
                                   "·N_active·tokens (N_active: the "
                                   "embedding lookup left out)",
               "flops_over_model_flops": flops / model_flops,
               "collectives": len(compiled.collectives().ops),
               "seconds": seconds, "gpu": card}
        emit(row)
        check(abs(row["rel_err"]) <= 0.15,
              f"dry run {name}: estimate {row['estimate_gib']:.2f} GiB vs "
              f"measured {row['measured_peak_gib']:.2f} GiB")
        rows.append(row)
    return rows


def lint_phase(card) -> dict:
    """Phase 33: the schedule linter over every target, the targets'
    tensors on the card (``analysis.lint_targets``, ``analysis.
    schedule_lint``). Fails where a canonical target does not pass, a
    broken one does not trip exactly its own rules, or the phase takes
    60 s or more."""
    from repro_torch.analysis import lint_targets
    from repro_torch.analysis.schedule_lint import lint_target

    t0 = time.perf_counter()
    canonical, broken = {}, {}
    for name in lint_targets.all_targets():
        rep = lint_target(name, device="cuda")
        check(rep.ok, f"lint target {name} failed:\n{rep.render()[:3000]}")
        canonical[name] = [rep.n_collectives, rep.n_events]
    for name in lint_targets.broken_targets():
        rep = lint_target(name, device="cuda")
        got = sorted({f.rule for f in rep.errors})
        want = sorted(lint_targets.TRIPS[name])
        check(got == want, f"broken lint target {name} tripped {got}, "
                           f"not {want}")
        broken[name] = got
    seconds = time.perf_counter() - t0
    row = {"phase": "schedule_lint", "n": 33,
           "canonical_passed": len(canonical),
           "canonical": len(lint_targets.all_targets()),
           "broken_tripped": len(broken),
           "broken": len(lint_targets.broken_targets()),
           "collectives_events": canonical, "tripped": broken,
           "seconds": seconds, "torch": torch.__version__, "gpu": card}
    emit(row)
    check(seconds < 60, f"phase 33 took {seconds:.1f} s")
    return row


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def kernel_entry(name, source, replaces, launches, row) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core.stencil import heat2d_init, heat2d_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.heat2d import ops as heat_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh
    from repro_torch.runtime.rebalance import heat2d_solve_rebalanced

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    card = gpu_line()

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    sources = [heat_ops.SOURCE, flash_ops.SOURCE, lru_ops.SOURCE,
               ssd_ops.SOURCE]
    built = _build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = {Path(src).name: [ln.strip() for ln in log.splitlines()
                              if "Compiling entry" in ln
                              or "registers" in ln or "spill" in ln
                              or "injected" in ln]
             for src, (_, log) in built.items()}
    emit({"phase": "build", "seconds": build_s,
          "sources": [KERNEL_SOURCE, FLASH_SOURCE, LRU_SOURCE, SSD_SOURCE],
          "ptxas": ptxas, "gpu": card})

    # ------------------------------------------- 2. kernel vs plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((N, N), generator=gen, device=dev)
    ring = (torch.randn((1, N), generator=gen, device=dev),
            torch.randn((1, N), generator=gen, device=dev),
            torch.randn((N, 1), generator=gen, device=dev),
            torch.randn((N, 1), generator=gen, device=dev))
    cases = [("f32", (256, 256), 1, None), ("f32", (256, 256), 4, None),
             ("f32", (128, 64), 1, ring), ("bf16", (256, 256), 1, None),
             ("f32", (1024, 1024), 1, None)]   # too large: path "global"
    kernel_rows = []
    for dtype_name, tile, sweeps, halo in cases:
        x = u if dtype_name == "f32" else u.to(torch.bfloat16)
        launched = heat_ops.heat2d_sweep.launches
        got = heat_ops.heat2d_sweep(x, tile, sweeps, "kernel", halo)
        path = heat_ops.heat2d_sweep.last_path
        cluster = heat_ops.heat2d_sweep.last_cluster
        want = heat_ops.heat2d_sweep(x, tile, sweeps, "plain", halo)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype_name == "f32":
            # same IEEE operations in the same order on both sides
            check(err == 0.0, f"f32 kernel != plain {tile} x{sweeps}: {err}")
        else:
            check(bool((diff <= bf16_ulp(want)).all()),
                  f"bf16 kernel off plain by more than one ulp: {err}")
        del got, want, diff
        k_ms = time_ms(lambda: heat_ops.heat2d_sweep(
            x, tile, sweeps, "kernel", halo))
        p_ms = time_ms(lambda: heat_ops.heat2d_sweep(
            x, tile, sweeps, "plain", halo))
        bound, bound_by = sweep_bound_ms(N, N, x.element_size(), sweeps,
                                         halo is not None)
        row = {"phase": "kernel", "dtype": dtype_name, "shape": [N, N],
               "tile": list(tile), "sweeps": sweeps,
               "halo": halo is not None, "path": path, "cluster": cluster,
               "max_abs_err": err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
               "bound_by": bound_by,
               "launches": heat_ops.heat2d_sweep.launches - launched,
               "gpu": card}
        emit(row)
        kernel_rows.append(row)
        del x
    check([r["path"] for r in kernel_rows] == ["cluster_smem"] * 4
          + ["global"], "a tile took the wrong kernel path")
    # reference for the sharded sweep: the kernel with a zero ring
    zeros = (torch.zeros((1, N), device=dev), torch.zeros((1, N), device=dev),
             torch.zeros((N, 1), device=dev), torch.zeros((N, 1), device=dev))
    want_sharded = heat_ops.heat2d_sweep(u, (256, 256), 1, "kernel", zeros)
    check(torch.equal(want_sharded,
                      heat_ops.heat2d_sweep(u, (256, 256), 1, "plain")),
          "zero ring != no ring")

    # -------------------------------------------- 3-5. the main path, counted
    heat_ops.heat2d_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)

    u0 = heat2d_init(N, N, device=dev)
    meshes = [(make_mesh((1,), ("data",)), ("data",), "1"),
              (make_grid_mesh(1, 1), ("rows", "cols"), "1x1")]
    solved = {}
    for mesh, axes, label in meshes:
        for mode in ("two_phase", "hdot"):
            heat2d_solve(u0, mesh, axes, 2, mode)      # warm the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uf, res = heat2d_solve(u0, mesh, axes, ITERS, mode)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = res.cpu()
            check(tuple(uf.shape) == (N, N) and tuple(r.shape) == (ITERS,),
                  f"solve shapes {tuple(uf.shape)} {tuple(r.shape)}")
            check(bool(torch.isfinite(uf).all()), "non-finite grid")
            # Jacobi on Laplace is monotone; 1e-7 is the JAX suite's own
            # rounding slack (tests/test_stencil_apps.py)
            check(bool((r[1:] - r[:-1] <= 1e-7).all()) and r[-1] < r[0],
                  f"residual rose on {label} {mode}")
            solved[(label, mode)] = (uf, res)
            emit({"phase": "solve", "mesh": label, "mode": mode,
                  "shape": [N, N], "iters": ITERS, "seconds": dt,
                  "sweeps_per_s": ITERS / dt, "residual_first": float(r[0]),
                  "residual_last": float(r[-1]), "gpu": card})
        a, b = solved[(label, "two_phase")], solved[(label, "hdot")]
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"hdot != two_phase on mesh {label}")
    check(torch.equal(solved[("1", "hdot")][0], solved[("1x1", "hdot")][0]),
          "slab mesh != grid mesh")
    del solved

    grid = make_grid_mesh(1, 1)
    got = heat_ops.heat2d_sweep_sharded(u, grid, ("rows", "cols"),
                                        (256, 256), 1)
    torch.cuda.synchronize()
    sharded_ok = torch.equal(got, want_sharded)
    del got, want_sharded

    slab = make_mesh((1,), ("data",))
    reb_iters, every = 24, 8

    def skewed(idx, shape):  # chunk 0 along dim 0 costs 4x per cell
        return (4.0 if idx[0] == 0 else 1.0) * math.prod(shape) * 1e-9

    t0 = time.perf_counter()
    ur, rr, info = heat2d_solve_rebalanced(
        u0, slab, ("data",), reb_iters, "hdot", 4, rebalance_every=every,
        chunk_cost_fn=skewed)
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    launches = heat_ops.heat2d_sweep.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    check(sharded_ok, "heat2d_sweep_sharded != heat2d_sweep with zero ring")
    check(launches > 0, "the main path never launched the heat2d kernel")
    check(len(info["cut_history"]) > 1, "the skewed cost never re-cut")
    check(all(c in info["cut_history"] for c in info["segment_cuts"]),
          "a segment ran on a cut outside cut_history")
    x, parts = u0, []
    for cut in info["segment_cuts"]:
        x, r = heat2d_solve(x, slab, ("data",), every, "hdot", 4,
                            chunk_weights=cut)
        parts.append(r)
    check(torch.equal(x, ur) and torch.equal(torch.cat(parts), rr),
          "rebalanced != heat2d_solve segment by segment")
    emit({"phase": "sharded", "mesh": "1x1", "equal": sharded_ok,
          "launches": launches})
    emit({"phase": "rebalance", "iters": reb_iters, "every": every,
          "cut_history": info["cut_history"], "seconds": reb_s,
          "peak_mem_gib_main_path": peak_gib})

    # ------------------------------ 6. where a solve step goes (traced run)
    for mode in ("two_phase", "hdot"):
        emit(profile_solve(heat2d_solve, u0, grid, mode, card))

    # the serving phases need room (a, b, uf and res hold the last mesh's
    # two 1 GiB grids)
    del u, u0, ur, rr, x, parts, ring, zeros, a, b, uf, res, r
    torch.cuda.empty_cache()

    # -------------------------------------------- 7. flash kernel vs plain
    flash_rows = [flash_case(flash_ops, dev, card, *c) for c in FLASH_CASES]

    served = {}

    def serve_and_trace(arch, phase, profile_phase):
        serve = serve_phase(arch, phase, dev, card)
        emit(serve_profile(serve, profile_phase, dev, card))
        served[arch] = serve["launches"]
        del serve                      # the next model needs the room
        torch.cuda.empty_cache()

    # ------------------------- 8-9. serve Qwen3-8B, counted, then traced
    serve_and_trace(*SERVE_ARCHS[0])

    # --------------------------------------- 10-11. lru, ssd kernel vs plain
    lru_rows = [lru_case(lru_ops, dev, card, *c) for c in LRU_CASES]
    ssd_rows = [ssd_case(ssd_ops, ssd_ref, dev, card, *c) for c in SSD_CASES]

    # ---------- 12-15. serve RecurrentGemma-2B and Mamba-2 780M, likewise
    for arch_phases in SERVE_ARCHS[1:]:
        serve_and_trace(*arch_phases)

    # ---------------- 16-17. RK3 and HPCCG: no kernel of the port on the path
    kernel_ops = (heat_ops.heat2d_sweep, *counted_wrappers().values())
    before = launch_counts(kernel_ops)
    _, rk3_s = timed(lambda: rk3_phase(dev, card))
    _, hpccg_s = timed(lambda: hpccg_phase(dev, card))
    app_launches = launch_counts(kernel_ops) - before
    check(app_launches == 0,
          "a kernel of the port launched during RK3 or HPCCG")
    emit({"phase": "apps", "n": [16, 17], "rk3_phase_seconds": rk3_s,
          "hpccg_phase_seconds": hpccg_s, "kernel_launches": app_launches})

    # ------------ 18-19. train InternLM2-1.8B: no kernel of the port either
    before = launch_counts(kernel_ops)
    _, train_s = timed(lambda: train_phase(dev, card, kernel_ops))
    _, trace_s = timed(lambda: train_profile(dev, card))
    train_launches = launch_counts(kernel_ops) - before
    check(train_launches == 0, "a kernel of the port launched in training")
    emit({"phase": "train_seconds", "n": [18, 19], "phase18_s": train_s,
          "phase19_s": trace_s, "kernel_launches": train_launches})

    # --------------------- 22. ZeRO-3 training: no kernel of the port either
    before = launch_counts(kernel_ops)
    _, zero3_s = timed(lambda: zero3_phase(dev, card, kernel_ops))
    zero3_launches = launch_counts(kernel_ops) - before
    check(zero3_launches == 0, "a kernel of the port launched in ZeRO-3")
    emit({"phase": "zero3_seconds", "n": 22, "phase22_s": zero3_s,
          "kernel_launches": zero3_launches})

    # ----------- 23-24. Whisper-base served and trained at full width
    whisper, whisper_s = timed(lambda: frontend_serve_phase(
        "whisper-base", 23, dev, card))
    served["whisper-base"] = whisper["launches"]
    before = launch_counts(kernel_ops)
    _, wtrain_s = timed(lambda: whisper_train_phase(dev, card, kernel_ops))
    check(launch_counts(kernel_ops) == before,
          "a kernel of the port launched in Whisper's training")

    # -------- 26. the scans' backward kernels against the plain backwards
    from repro_torch.kernels.lru_scan import ref as lru_ref

    bwd_s0 = time.perf_counter()
    lru_bwd_rows = [lru_bwd_case(lru_ops, lru_ref, dev, card, *c)
                    for c in LRU_BWD_CASES]
    traced_bwd = fresh_ssd_bwd_kernels(
        [(d, SSD_BWD_SHAPE) for d in SSD_BWD_DTYPES]
        + [("bf16", s) for s in TP_SSD_SHAPES])
    ssd_bwd_rows = {d: ssd_bwd_case(
        ssd_ops, ssd_ref, dev, card, d,
        device_kernels=traced_bwd[(d, SSD_BWD_SHAPE)])
        for d in SSD_BWD_DTYPES}
    bwd_s = time.perf_counter() - bwd_s0
    gc.collect()
    torch.cuda.empty_cache()

    # --- 27. Mamba-2 780M and RecurrentGemma-2B trained at full width,
    # forward and backward through the scan kernels (counted)
    trained, rtrain_s = timed(lambda: {
        arch: recurrent_train_phase(arch, dev, card)
        for arch in RECURRENT_TRAIN})
    emit({"phase": "recurrent_seconds", "n": [26, 27], "phase26_s": bwd_s,
          "phase27_s": rtrain_s})

    # --- 28. the scans forward and backward at the rank-local shapes of
    # tensor-parallel training over 4 cards
    gc.collect()
    torch.cuda.empty_cache()
    _, tp_scans_s = timed(lambda: tp_scans_phase(
        lru_ops, lru_ref, ssd_ops, ssd_ref, dev, card, traced_bwd))

    # ---- 29. the serving cells (build_cell) on a one-rank mesh, Qwen3-8B
    gc.collect()
    torch.cuda.empty_cache()
    cells, cells_s = timed(lambda: cells_phase(flash_ops, dev, card))
    served["cells"] = cells["launches"]

    # ---- 30. Qwen3-30B-A3B trained at full width, 4 layers, one card
    measured = {}
    _, moe_train_s = timed(lambda: moe_train_phase(dev, card, kernel_ops,
                                                   measured))

    # ---- 31. Qwen3-8B's prefill_32k cell: blockwise attention
    blockwise, blockwise_s = timed(lambda: blockwise_cell_phase(
        flash_ops, dev, card, measured))
    served["blockwise_flash"] = blockwise["flash_launches"]

    # ---- 32. the dry run's estimate of phases 30 and 31 (no card)
    _, dryrun_s = timed(lambda: dryrun_phase(dev, card, measured))
    del measured

    # ---- 33. the schedule linter's targets, their tensors on the card
    gc.collect()
    torch.cuda.empty_cache()
    _, lint_s = timed(lambda: lint_phase(card))

    # ---- 25. LLaVA-NeXT-34B (64 GiB of weights): last, on a freed card
    gc.collect()
    torch.cuda.empty_cache()
    llava, llava_s = timed(lambda: frontend_serve_phase(
        "llava-next-34b", 25, dev, card))
    served["llava-next-34b"] = llava["launches"]
    emit({"phase": "frontend_seconds",
          "n": [23, 24, 25, 28, 29, 30, 31, 32, 33],
          "phase23_s": whisper_s, "phase24_s": wtrain_s,
          "phase25_s": llava_s, "phase28_s": tp_scans_s,
          "phase29_s": cells_s, "phase30_s": moe_train_s,
          "phase31_s": blockwise_s, "phase32_s": dryrun_s,
          "phase33_s": lint_s})

    # -------------------------------------------------------------- results
    flash_launches = sum(v.get("flash_attention", 0) for v in served.values())
    print(f"nvidia-smi: {card}", flush=True)
    emit({"kernels": [
        kernel_entry("heat2d_sweep", KERNEL_SOURCE, REPLACES, launches,
                     dict(kernel_rows[0], library_ms=None)),
        kernel_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                     flash_launches, flash_rows[0]),
        kernel_entry("lru_scan", LRU_SOURCE, LRU_REPLACES,
                     served["recurrentgemma-2b"]["lru_scan"], lru_rows[0]),
        kernel_entry("ssd_scan", SSD_SOURCE, SSD_REPLACES,
                     served["mamba2-780m"]["ssd_scan"], ssd_rows[0]),
        kernel_entry("lru_scan_bwd", LRU_SOURCE, LRU_REPLACES,
                     trained["recurrentgemma-2b"]["launches"]["lru_scan"][
                         "bwd"], lru_bwd_rows[0]),
        kernel_entry("ssd_chunk_bwd", SSD_SOURCE, SSD_REPLACES,
                     trained["mamba2-780m"]["launches"]["ssd_scan"]["bwd"],
                     ssd_bwd_rows["bf16"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
