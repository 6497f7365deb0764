#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's merge, service, shard-worker, serve,
MoE / MLA serve, hybrid (RG-LRU) serve, SSM (Mamba-2), encoder–decoder
(Whisper) and vision (Llama-3.2-Vision) serve, training (dense, MoE /
MLA, hybrid, SSM and encoder–decoder) and store paths, and its
quickstart and budget-sweep examples, once on one NVIDIA card, and its
lint beside them on the host.

    python3 chip_smoke.py            # needs one CUDA card; exits 2 without

Configuration: Qwen2-1.5B at its published widths (d_model 1536, 12 heads
/ 2 KV heads, head_dim 128, d_ff 8960, vocab 151936, QKV bias, tied
embedding, rope_theta 1e6), stored in bfloat16, depth cut to 1 of 28
decoder layers (``--layers``; 4 until the smoke passed 1,100 s with
serve_mla beside it, 2 until it passed 1,200 s with serve_griffin beside
it) plus the embedding and the final norm, in the model's own
layout: the port's ``flatten_tree`` of ``DecoderLM`` (layer-stacked
tensors named as the JAX package names them, e.g. ``attn/wq`` of shape
(L, 1536, 12, 128)).  A base model (``DecoderLM`` init) and K = 4 "full"
experts (expert = base + 0.02 * N(0, 1) per tensor) are made on the card
from ``--seed``; nothing is downloaded.  Default 128 KiB blocks.  The
serve_mla phase serves DeepSeek-V2-Lite at its published widths (d_model
2048, 16 heads, MLA with kv_lora 512 and qk 192 / v 128 head dims, 64
routed experts top-6 + 2 shared of d_ff 1408, vocab 102400), depth cut
to MLA["layers"] of 27, its bf16 weights drawn on the card from
``--seed``.  The serve_griffin phase serves RecurrentGemma-9B at its
published widths (38 layers in the pattern recurrent, recurrent, local
attention; d_model 4096, RG-LRU width 4096, 16 query heads over one kv
head at head dim 256, window 2,048, d_ff 12288, vocab 256000), depth
GRIFFIN["layers"], its bf16 weights drawn on the card from ``--seed``.
The train_mla and train_griffin phases train the same two models at
their published widths (float32 params, bf16 compute, remat), depth cut
to TRAIN_MLA["layers"] and TRAIN_GRIFFIN["layers"].  The serve_mamba
phase serves Mamba-2 2.7B at its published widths and all 64 layers
(d_model 2560, SSD with d_inner 5120, 80 heads of 64, state 128, chunk
128, conv 4, vocab 50280); serve_whisper whisper-tiny (4 + 4 layers,
d_model 384, 6 heads at hd 64, 1,500 frames, vocab 51865); serve_vlm
Llama-3.2-Vision-90B at its published widths (d_model 8192, 64 / 8 heads
at hd 128, d_ff 28672, 1,024 vision tokens, vocab 128256), depth
VLM["layers"]; each drawn on the card from ``--seed`` with its
zero-initialised norms and cross-attention gates redrawn (DRAWN_NORMS;
the conv and vision frontends are stubs, as in the reference:
random frame and patch embeddings).  train_mamba and train_whisper train
Mamba-2 at TRAIN_MAMBA["layers"] and whisper-tiny whole.

Phases, one JSON line each:

  build    nvcc builds src/repro_torch/csrc/merge_block.cu (merge,
           fused TIES, the TIES pair's threshold and apply, and sketch
           kernels), flash_attention.cu (the forward) and
           flash_attention_bwd.cu (the backward) for sm_90a, all three at
           once; then each kernel's registers, spills and static shared
           memory from ptxas -v (the tensor-core backward's kernels at
           every pair, the MLA forwards and the (256, 256) tensor-core
           forward must not spill)
  kernels  each Hopper kernel against its plain PyTorch version: the
           merge kernels at the merge path's largest window group (NB =
           32, K = 4, W = 65,536 float32; rtol = atol = 1e-5), the
           linear kernel also at the whole-shard AVG's shape with its
           per-row divisor (WHOLE_SHARD, bit for bit), TIES's
           pair route at PAIR_CASES (the merge's group and median
           launch (5, 3, 65,536), the parity phase's 2 MiB-block median
           (1, 4, 1,048,576), K = 16, the loop's most common pair
           launch): the threshold (a radix select, one CTA a row from 16
           rows, else sliced over the whole card) against torch.kthvalue
           and the apply against its plain version, bit for bit, each
           with its profiler device time; the fused TIES
           kernel (one cluster launch: threshold and
           apply) at both shapes against its plain version and its
           thresholds against torch.kthvalue (bit for bit), with the
           pair's time (threshold kernel + apply kernel) and its cluster
           launch plan; both routes timed at (NB, K) on each side of
           ties_route's rows limit (ROUTE_CASES),
           the ANALYZE sketch kernel at ANALYZE's largest launch (NB =
           1,024, W = 65,536 float32) and a ragged (3, 1,001) (max|x|
           bit-equal; Σx² rtol 2e-4, Σx rtol 1e-3 / atol 1e-6·W: the
           l2 and mean bars of tests/test_kernels.py), flash attention
           at the prefill shape (B, Sq, Sk, H, Hkv, hd) = (1, 2048, 2048,
           12, 2, 128) bf16 causal through both kernels (the tensor-core
           route, "tc", and the float32-FMA route, "fma"), the tensor-core
           route with window 512 and at Sq = Sk = 256 and 1,000, the FMA
           route in float32 with window 512, a decode-style (1, 1,
           2048, ...) with q_offset 2047, DeepSeek-V2-Lite's prefill
           (1, 2048, 2048, 16, 16) at qk 192 / v 128 and RecurrentGemma-
           9B's (1, 3072, 3072, 16, 1) at (256, 256) with window 2,048,
           each bf16 on the tensor cores and float32 on the FMA route,
           whisper-tiny's encoder (1, 1500, 1500, 6, 6) at hd 64 and
           Llama-3.2-Vision's cross-attention (1, 2048, 1024, 64, 8) at
           hd 128, both without a mask, on the tensor cores,
           each with its profiler device time (tolerance 2e-5 float32, 2e-2 bf16; the elements
           that differ from the plain version counted); the flash backward (dq, dk, dv) against autograd
           through the plain version at (B, S, H, Hkv, hd) = (2, 1024,
           12, 2, 128) bf16 causal, the same with window 256, at hd 64,
           at the ragged length 1,000, and float32 hd 8 and 16, the
           training phases' attention (DeepSeek-V2-Lite's (2, 2048, 16,
           16) at qk 192 / v 128; RecurrentGemma-9B's (1, 3072, 16, 1) at
           (256, 256) with window 2,048), each bf16 and float32,
           (24, 16) at a small shape and train_whisper's encoder (8,
           1500, 6, 6) at hd 64 without a mask (BWD_TOL),
           bf16 on both routes (tensor cores, then float32 FMAs; timed in
           turns, and the tensor cores must win at the first case: the
           route gate), two runs bit-equal, SDPA's backward as the
           library call (by profiler device time, and by CUDA events)
           with its errors against the same reference, the
           tensor-core route's device time by kernel, and the forward
           timed with and without its lse output: max abs error, median
           CUDA-event times
           of kernel, plain version, a device copy of the same bytes
           (merge, threshold and sketch kernels) and one PyTorch library
           call where one computes the same function, and the bound
  parity   one full-width decoder layer: ANALYZE on the card against
           ANALYZE on the CPU into a second catalog (bytes, hashes, sign
           signatures and max|x| equal; l2, l2_delta, mean within rtol
           1e-5 / atol 1e-6; the same plan selection and c_expert_hat for
           every operator at a 50% budget); then MergePipe.merge on the
           card (pipelined engine, torch kernels) against the numpy
           stream engine, for avg / ta / ties / dare: bf16 outputs within
           one ulp, equal per-category I/O bytes; then TIES again at 2 MiB
           blocks, where ties_route sends the large blocks to the pair
           (threshold kernel, then apply kernel) and the small ones to
           the fused kernel: every launch on the route ties_route names,
           outputs and bytes against the stream engine as above, and the
           pair's and the fused kernel's device time; then a
           bf16 merge_blocks of every operator with NaN inputs (both
           signs, payloads) against the numpy operator, bit for bit
  merge    the whole configuration: ANALYZE on the card (sketch kernel),
           then 50% budget, all four operators through MergePipe.merge
           (the v2 Session shim) on the card: ANALYZE's wall, bytes,
           sketch launches and device time; each merge's wall time, I/O
           bytes, budget soundness, windows, kernel launches, the route
           and shape of every TIES launch (each the one ties_route names),
           and from torch.profiler the kernels' device time (TIES's by
           kernel: fused, threshold, apply; no kthvalue kernel may run),
           the device's busy time by activity and its idle share
  service  merge_cli --spec on the merge workspace, in process, on the
           card: a JSON spec of TIES and DARE over the four experts and a
           nested job (AVG of a TA child with expert-0), under a shared
           budget: every job commits and verifies, c_expert_run <=
           c_expert_hat <= budget, the level's union of expert bytes
           below the per-job sum; wall, bytes by category, launches
  shards   shard workers on the merge workspace: TIES and DARE
           (SHARDS["pipelined"]) at 50% through
           Session.run_all(n_workers=2) (one python -m
           repro_torch.launch.worker process a shard, kernel "torch" on
           the card), each snapshot bit-equal (tensor hashes) to the
           merge phase's local one with equal base, expert and output
           bytes, each worker's expert bytes within ceil(C_hat / 2) +
           K blocks, each worker's result doc naming the card and
           counting launches of the operator's kernel; shard walls, the
           splice's wall and each worker's start (launch to first
           block); TIES with shard 1 killed halfway through its blocks
           (exit 3), re-issued and resumed from its journal, bit-equal,
           the survivors' reads plus the dead attempt's journaled reads
           in [C_hat, 2 C_hat); whole-shard merges (kernel "mesh") of
           SHARDS["whole_shard"]: within one bf16 ulp of the local merge
           outside TIES's tail blocks, TIES's differing elements within
           the tail-block bound, equal base and expert bytes; one inline
           TIES window in this process under the profiler (device time
           by kernel, idle share)
  serve    the TIES snapshot of ``merge``, loaded into the port's
           DecoderLM (``load_flat``) and served by ServeEngine(batch_slots
           = 4, max_len = 4096): 8 requests, prompts of 256-2048 tokens
           drawn from ``--seed``, 32 greedy tokens each.  First a parity
           check in float32 compute, flash-attention kernel against its
           plain version on the card (prefill logits within tolerance,
           identical tokens; float32 runs the FMA kernel); then the bf16
           run: prefill and decode rates, flash-attention launches (every
           one on the tensor-core route), and from torch.profiler the
           kernel's device time, busy time by activity and idle share
  serve_mla  DeepSeek-V2-Lite (MLA + MoE) drawn on the card, served by
           ServeEngine(batch_slots = 4, max_len = 2,560): 4 requests of
           512-2,048 prompt tokens from ``--seed``, 32 greedy tokens
           each.  First float32 compute on the bf16 weights, the kernels
           (the FMA route at (192, 128)) against the plain attention:
           prefill logits within LOGIT_TOL and identical greedy tokens;
           then bf16: one tensor-core launch a layer a request, the
           profile showing flash_attention_ws_kernel and no FMA kernel;
           load, prefill and decode rates, the MoE's dropped-pair share
           at prefill, device busy time, idle share, top device ops,
           peak memory
  serve_griffin  RecurrentGemma-9B (RG-LRU + local attention, hd 256)
           drawn on the card, served by ServeEngine(batch_slots = 4,
           max_len = 3,200): one prompt of 3,072 tokens (past the 2,048
           window) and 3 of 512-2,048 from ``--seed``, 32 greedy tokens
           each.  First float32 compute on the bf16 weights, the kernels
           (the FMA route at (256, 256), one launch an attention layer a
           request) against the plain attention: prefill logits within
           LOGIT_TOL and identical greedy tokens; then bf16: one
           tensor-core launch an attention layer a request, the profile
           showing flash_attention_ws_kernel and no FMA kernel; load,
           prefill and decode rates, device busy time, idle share, top
           device ops, the RG-LRU scan's device time (its calls replayed)
           and share, peak memory
  train    Qwen2-1.5B as published (28 layers, float32 params, bf16
           compute, remat), batch 4 x
           1,024 tokens from DataPipeline: the first step's loss and a
           sample of gradients through the kernels against the same step
           through the plain attention (TRAIN_TOL), then 1 + 5
           make_train_step steps: median step ms, tokens/s, MFU and HFU
           (with remat) at the bf16 peak, peak memory, flash forward and
           backward launches (two and one a layer a step; the backward on
           the tensor-core route for bf16), and one profiled step's
           device time by kernel and idle share
  train_mla  the same for DeepSeek-V2-Lite (MLA + MoE: the flash
           kernels at qk 192 / v 128, 64 routed experts top-6 + 2 shared),
           TRAIN_MLA["layers"] of 27 layers, 2 x 2,048 tokens, 1 + 3
           steps; its first step's plain pass replays the kernel pass's
           expert choices (forward and remat's recompute, call by call)
           and reports the flips; MFU over the active parameters
  train_griffin  the same for RecurrentGemma-9B (RG-LRU + local
           attention at (256, 256), 16 query heads over one kv head),
           TRAIN_GRIFFIN["layers"] of 38 layers (one attention layer), 1 x
           3,072 tokens (the window of 2,048 masks keys), 1 + 3 steps
  serve_mamba  Mamba-2 2.7B through ServeEngine (MAMBA: 4 requests of
           1,024-2,048 prompt tokens, 16 greedy tokens each, 4 slots):
           first, on the bf16 weights, the float32 engine's greedy tokens
           against the argmax of ``forward`` over each extended sequence,
           and each request's chunked-SSD prefill plus recurrent decode
           steps (teacher-forced on those tokens) against that forward's
           logits in float64 compute (LOGIT_TOL; float32's own rounding
           through 64 layers exceeds it, its share reported); then bf16:
           no flash
           launch (attention-free), prefill and decode rates, device busy
           time, idle share, the chunked SSD's device time (its calls
           replayed) and share, peak memory
  serve_whisper  whisper-tiny request by request through its own prefill
           (the encoder over 1,500 frames, the decoder's 4-token prefix,
           the cross k / v computed once) and decode_step: float32
           compute, the kernels (the FMA route at hd 64) against the plain
           attention (prefill logits within LOGIT_TOL, identical greedy
           tokens); then bf16: every flash launch on the tensor cores,
           counted by shape (the encoder's at FA_CASES' whisper_encoder),
           prefill and decode times, device busy time, idle share
  serve_vlm  Llama-3.2-Vision-90B at VLM["layers"] the same way over
           1,024 vision tokens (the cross-attention's launches at
           FA_CASES' vlm_cross)
  train_mamba  Mamba-2 at TRAIN_MAMBA["layers"] of 64 (4 x 2,048 tokens,
           1 + 3 steps): the first step's loss and every sampled gradient
           finite (no attention to hold against a plain version), no
           flash launch, step ms, tokens/s, MFU, peak memory
  train_whisper  whisper-tiny whole, 8 clips of 1,500 frames and 448
           decoder tokens, as train (the backward at hd 64 on the tensor
           cores: the encoder's, the decoder's and the cross-attention's)
  loop     at LOOP["layers"] layers: two experts (skills 0 and 1) from one
           seeded base with TrainLoop, checkpoints in a SnapshotStore;
           expert 0 crashed before step 3 and resumed from its step-2
           checkpoint, its final TrainState bit-identical to an
           uninterrupted run (torch.use_deterministic_algorithms); then
           base and experts in the port's Session on the card: ANALYZE,
           TIES at a 50% budget (the route and shape of every TIES
           launch, the pair's and the fused kernel's device time); every
           model's loss on each skill; the merge served by ServeEngine
           (4 requests)
  store    the store layer at the merge path's widths, STORE["layers"]
           decoder layers: K = 4 experts shaped like partial fine-tunes
           (the embedding and the final norm byte-equal to the base,
           the decoder layers base + 0.02 * N(0, 1), experts 0 and 1
           sharing the attention tensors byte for byte);
           Session.repack into a lossless zlib layout (extents,
           elided and deduped blocks, logical and physical bytes); the
           four operators at full budget from the layout and from the
           flat checkpoints (one Session batch each), bit-equal; each at
           50% and at STORE["tight"] (below the layout's physical bytes,
           so selection binds) from the layout (costed at physical
           bytes), bit-equal to the numpy stream engine on the same plan
           with equal bytes by category (a half-budget plan that selects
           the full-budget flat plan's blocks: bit-equal to that merge
           instead), c_expert_run <= c_expert_hat <= B, and the blocks
           the packed and the flat plan select; the experts pushed to a
           bucket (merge_cli remote push; STORE's latency and MB/s); a
           cold TIES merge at the tight budget, then a tier-billed one
           over that partly warm tier (its coalesced runs mix the tiers):
           remote bytes within the plan, disk bytes beside them,
           bit-equal to the stream engine on its plan; a cold
           TIES merge (remote + content-shared disk bytes equal to the
           flat merge's expert bytes, bit-equal), the same cold merge
           through two shard workers over an emptied disk cache
           (bit-equal; wall, remote and disk bytes), a warm one (no remote
           bytes), a tier-billed one at 50% and, for each operator, one
           at the tight budget (bit-equal to the stream engine with equal
           bytes); merge_cli fsck
           clean, then a disk-cache extent corrupted at fill
           (cache:extent) and a packed extent read corrupted
           (packed:extent) found by --check, repaired by --repair, and a
           packed TIES merge bit-equal again.  Every merge: its kernels
           in its profile, each TIES launch on ties_route's route, wall,
           bytes, device busy time and idle share

  mesh     training under launch/train.py's path on the (1, 1) mesh
           (MESH: Qwen2-1.5B at 4 of 28 layers, 4 x 1,024 tokens, 3
           steps; DeepSeek-V2-Lite at 2 of 27, 2 x 2,048, 2 steps;
           published widths, float32 params, bf16 compute, remat): each
           model meshless, then through ``build_on_mesh`` under
           ``make_debug_mesh()`` and ``train_rules`` (DTensor parameters,
           moments and batches; the flash kernels and the MoE's routing
           through ``local_map``), from the same seed's weights and
           batches: losses bit-equal (Qwen2) or within TRAIN_TOL's
           loss_rtol (DeepSeek), the same non-zero tensor-core flash
           forward and backward launches both ways, step ms both ways,
           and the card's peak memory against the dry-run's accounting
           of the same step on the same mesh (not below it by more than
           MESH_MEMORY_SLACK)
  dryrun   python -m repro_torch.launch.dryrun, host only, in processes
           of its own beside every card phase: DRYRUN's archs x every
           shape x both production meshes; every applicable cell ok
  examples the JAX package's quickstart and budget-sweep examples as
           ported (``repro_torch.launch.quickstart`` / ``budget_sweep``,
           at their own sizes: nothing cut), each through its main() with
           --device cuda, then --device cpu: every committed snapshot
           bit-equal (content hashes), every IOStats category equal
           (``meta`` within META_SLACK bytes: the catalog's JSON carries
           timestamps), the budget held (realized expert bytes <= planned
           <= B), the sweep's shared-read batch below the sequential
           bytes, and the card runs' TIES (on ties_route's route) and
           DARE launches, each example's wall both ways
  lint     python -m repro_torch.analysis --format json (mergelint: the
           guarded-by, accounting, except-discipline and durability
           passes over src/repro_torch), host only, in a process of its
           own beside the card phases, with no JAX on the machine: exit
           0, no unwaived finding, each pass's findings and waivers

The loop phase runs in a spawned process of its own beside the store
phase (both host-bound, on workspaces of their own; the kernel timing,
serve and train phases run before them, alone on the card), so their
walls are taken side by side.  Then the total seconds, the kernels'
contract line, and last {"ok": true, "device": ...}.
Any failure raises and exits non-zero.  The workspace lives under
build/ (gitignored) and is removed at the end.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]
# H100 data sheet (SXM): HBM bytes/s, float32 and float64 vector FLOP/s,
# bf16 dense tensor-core FLOP/s
PEAK = {"bytes": 3.35e12, "f32": 67e12, "f64": 34e12, "bf16": 989e12}
TOL = 1e-5
# tests/test_kernels.py:133,149: float32 sums in another order; bf16
# outputs one rounding apart
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (label, (B, Sq, Sk, H, Hkv, hd, hdv), dtype, causal, window, q_offset,
# route); the first is the serving path's prefill shape and the contract
# line's row; "tc" is the tensor-core kernel, "fma" the float32-FMA
# kernel.  The "mla" rows are DeepSeek-V2-Lite's prefill (qk 192 / v 128,
# 16 heads): the serve_mla phase's tensor-core launches, and the FMA
# route in float32 that its float32 parity run takes; the "rg" rows the
# same for RecurrentGemma-9B's local attention (qk / v 256, 16 heads over
# one kv head, window 2,048) at the serve_griffin phase's longest prompt;
# all four go into the contract line (FA_ROWS) with their profiler device
# time
FA_CASES = [
    ("prefill", (1, 2048, 2048, 12, 2, 128, 128), "bfloat16", True, 0, 0,
     "tc"),
    ("prefill", (1, 2048, 2048, 12, 2, 128, 128), "bfloat16", True, 0, 0,
     "fma"),
    ("prefill_window", (1, 2048, 2048, 12, 2, 128, 128), "bfloat16", True,
     512, 0, "tc"),
    ("prefill_256", (1, 256, 256, 12, 2, 128, 128), "bfloat16", True, 0, 0,
     "tc"),
    ("prefill_1000", (1, 1000, 1000, 12, 2, 128, 128), "bfloat16", True, 0,
     0, "tc"),
    ("prefill_window_f32", (1, 2048, 2048, 12, 2, 128, 128), "float32", True,
     512, 0, "fma"),
    ("decode", (1, 1, 2048, 12, 2, 128, 128), "bfloat16", True, 0, 2047,
     "tc"),
    ("mla_prefill", (1, 2048, 2048, 16, 16, 192, 128), "bfloat16", True, 0,
     0, "tc"),
    ("mla_prefill_f32", (1, 2048, 2048, 16, 16, 192, 128), "float32", True,
     0, 0, "fma"),
    ("rg_prefill", (1, 3072, 3072, 16, 1, 256, 256), "bfloat16", True, 2048,
     0, "tc"),
    ("rg_prefill_f32", (1, 3072, 3072, 16, 1, 256, 256), "float32", True,
     2048, 0, "fma"),
    # DeepSeek-V2-Lite's smoke config at (24, 16), at the backward's
    # mla_smoke shape
    ("mla_smoke", (2, 256, 256, 4, 4, 24, 16), "bfloat16", True, 0, 0, "tc"),
    # whisper-tiny's encoder (1,500 frames, 6 heads at hd 64, no mask): the
    # serve_whisper phase's bf16 prefill launches at this shape
    ("whisper_encoder", (1, 1500, 1500, 6, 6, 64, 64), "bfloat16", False, 0,
     0, "tc"),
    # llama-3.2-vision-90b's gated cross-attention: the serve_vlm phase's
    # longest prompt over 1,024 vision tokens, GQA 64 / 8 at hd 128
    ("vlm_cross", (1, 2048, 1024, 64, 8, 128, 128), "bfloat16", False, 0, 0,
     "tc"),
]
# the served models' rows of the contract line: case label -> launch
# counter (the serve_mla and serve_griffin phases' counts: bf16 prefill on
# the tensor cores, the float32 run on the FMA kernel)
FA_ROWS = {"mla_prefill": "flash_attention_mla",
           "mla_prefill_f32": "flash_attention_mla_fma",
           "rg_prefill": "flash_attention_rg",
           "rg_prefill_f32": "flash_attention_rg_fma",
           "whisper_encoder": "flash_attention_whisper",
           "vlm_cross": "flash_attention_vlm_cross"}
# (label, (NB, K, W)) float32 TIES launches: the merge path's largest
# window group and its median launch by rows (the merge phase reports the
# launches' shapes: 15 rows of 128 KiB blocks, 1 to 46)
MERGE_CASES = [("group", (32, 4, 65536)), ("median", (5, 3, 65536))]
# the pair route's shapes (threshold kernel, then apply kernel): the merge
# path's, the parity phase's median 2 MiB-block launch (ties_2mib_blocks.
# pair_shapes), K past the fused kernel, and the loop phase's most common
# pair launch (float32 128 KiB blocks of two experts)
PAIR_CASES = MERGE_CASES + [("parity_median", (1, 4, 1 << 20)),
                            ("k16", (4, 16, 65536)),
                            ("loop", (32, 2, 32768))]
# the fused TIES kernel's cases: the merge path's two shapes
FUSED_CASES = MERGE_CASES
# (NB, K) at W = 65,536 on each side of ties_route's rows and experts
# limits, where the fused kernel and the pair are timed against each
# other (the merge phase's most common launches among them)
ROUTE_CASES = [(1, 13), (1, 8), (2, 8), (2, 7), (2, 6), (8, 6), (4, 5),
               (1, 4), (4, 4), (5, 4), (8, 4), (10, 4), (12, 4), (16, 4), (2, 3),
               (5, 3), (8, 3), (10, 3), (16, 3), (20, 3), (24, 3), (2, 2),
               (8, 2), (13, 2), (15, 2), (20, 2), (23, 2), (30, 2), (40, 2),
               (2, 1), (6, 1), (16, 1), (22, 1), (30, 1), (46, 1), (60, 1)]
TRIM = 0.3
# the parity phase's second TIES merge: 2 MiB blocks (1,048,576 bf16
# elements) do not fit the fused kernel's shared memory
PAIR_BLOCK_SIZE = 2 << 20
SERVE = {"requests": 8, "min_prompt": 256, "max_prompt": 2048,
         "new_tokens": 32, "batch_slots": 4, "max_len": 4096}
# (NB, W) float32 sketch launches: ANALYZE's largest (core/sketch.py
# LAUNCH_BYTES of full 128 KiB bf16 blocks) and a ragged one
SKETCH_CASES = [("analyze", (1024, 65536)), ("ragged", (3, 1001))]
# ANALYZE on the card against the CPU: sums in another order
ANALYZE_TOL = {"rtol": 1e-5, "atol": 1e-6}
# the service phase's spec file: two jobs over all four experts and a
# nested job whose child snapshot the service ANALYZEs itself
EXPERTS = [f"expert-{e}" for e in range(4)]
SERVICE_SPEC = {"jobs": [
    {"name": "svc-ties", "base": "base", "experts": EXPERTS, "op": "ties",
     "theta": {"trim_frac": 0.3}, "budget": "50%"},
    {"name": "svc-dare", "base": "base", "experts": EXPERTS, "op": "dare",
     "theta": {"density": 0.5, "seed": 3}, "budget": "50%"},
    {"name": "svc-nested", "base": "base", "op": "avg", "budget": "50%",
     "experts": [{"base": "base", "experts": EXPERTS[1:3], "op": "ta",
                  "theta": {"lam": 0.5}, "budget": "50%"}, "expert-0"]},
]}
# float32 serve parity, kernel against plain version: prefill logits of
# std ~40 (vocab 151,936, d 1536) with attention sums in another order
LOGIT_TOL = {"rtol": 1e-4, "atol": 2e-3}
# (label, (B, S, H, Hkv, hd, hdv), dtype, causal, window): the flash
# backward (q_offset 0) at the training phase's heads, bf16 (the
# tensor-core forward's lse; both backward routes) and float32 (the FMA
# forward's lse; the FMA route), at hd 64, and at a ragged length; the
# first is the contract line's row and the route gate's shape.  The "mla"
# rows are the train_mla phase's attention (DeepSeek-V2-Lite: 16 heads,
# qk 192 / v 128, 2 x 2,048 tokens), the "rg" rows the train_griffin
# phase's (RecurrentGemma-9B: 16 query heads over one kv head at 256,
# window 2,048 over 3,072 tokens), each bf16 on both routes (BWD_ROWS: in
# the contract line) and float32 on the FMA route; "mla_smoke" is
# DeepSeek's smoke config's (24, 16)
BWD_CASES = [
    ("train", (2, 1024, 12, 2, 128, 128), "bfloat16", True, 0),
    ("train_window", (2, 1024, 12, 2, 128, 128), "bfloat16", True, 256),
    ("hd64", (2, 1024, 8, 2, 64, 64), "bfloat16", True, 0),
    ("ragged", (2, 1000, 12, 2, 128, 128), "bfloat16", True, 0),
    ("f32_hd8", (1, 512, 4, 2, 8, 8), "float32", True, 0),
    ("f32_hd16", (1, 512, 4, 2, 16, 16), "float32", True, 0),
    ("mla_train", (2, 2048, 16, 16, 192, 128), "bfloat16", True, 0),
    ("mla_train_f32", (2, 2048, 16, 16, 192, 128), "float32", True, 0),
    ("rg_train", (1, 3072, 16, 1, 256, 256), "bfloat16", True, 2048),
    ("rg_train_f32", (1, 3072, 16, 1, 256, 256), "float32", True, 2048),
    ("mla_smoke", (2, 256, 4, 4, 24, 16), "bfloat16", True, 0),
    # the train_whisper phase's encoder: 8 clips of 1,500 frames, 6 heads
    # at hd 64, no mask
    ("whisper_train", (8, 1500, 6, 6, 64, 64), "bfloat16", False, 0),
]
# the training phases' backward rows of the contract line: case label ->
# launch counter (the train_mla, train_griffin and train_whisper phases'
# tensor-core backward launches)
BWD_ROWS = {"mla_train": "flash_attention_bwd_mla",
            "rg_train": "flash_attention_bwd_rg",
            "whisper_train": "flash_attention_bwd_whisper"}
# the backward against autograd through flash_attention_ref: float32 sums
# in another order; bf16 gradients one bf16 rounding apart (the
# tensor-core forward rounds P to bf16)
BWD_TOL = {"bfloat16": {"rtol": 2e-2, "atol": 2e-2},
           "float32": {"rtol": 1e-4, "atol": 1e-5}}
# the serve_mla phase: DeepSeek-V2-Lite at its published widths, depth
# cut to "layers" of 27 (at all 27, 16.0 B bf16 parameters, the phase took
# 53.7 s and the whole smoke 1,144.7 s on an H100 80GB HBM3 at 700 W,
# past its 1,100 s aim; 6 until the training phases came beside it),
# requests of
# min-max prompt tokens and new greedy tokens on batch_slots slots of
# max_len positions
MLA = {"layers": 3, "requests": 4, "min_prompt": 512, "max_prompt": 2048,
       "new_tokens": 32, "batch_slots": 4, "max_len": 2560}
# the serve_griffin phase: RecurrentGemma-9B at its published widths, all
# 38 layers unless the whole smoke passes 1,080 s (then a depth = 2 mod 3,
# so the two trailing recurrent layers still run): at 38 the smoke took
# 1,084.2 s on an H100 80GB HBM3 at 700 W (the phase 65.4 s), at 32
# 1,243.5 s on a slower host (the phase 48.5 s; the store phase 516.7 s
# against 394.0), so 11 layers, where the phase's runs take ~1.3 s a
# layer less, and 5 (one super-block and the two trailing recurrent
# layers) since the training phases came; one prompt of "long" tokens
# (past the 2,048 window: the
# kernel masks keys and the prefill's ring roll is not trivial) and
# requests - 1 of min-max, new greedy tokens each, on batch_slots slots
# of max_len
GRIFFIN = {"layers": 5,
           "cut_by": "at 38 the whole smoke took 1,084.2 s, at 32 "
                     "1,243.5 s on a slower host, at 11 976.5 s before "
                     "the training phases of DeepSeek-V2-Lite and "
                     "RecurrentGemma-9B came",
           "requests": 4, "long_prompt": 3072,
           "min_prompt": 512, "max_prompt": 2048, "new_tokens": 32,
           "batch_slots": 4, "max_len": 3200}
# the train phase: Qwen2-1.5B as published (float32 params, bf16
# compute, remat; all its layers), batch x seq tokens a step, warm-up
# steps then timed; its gradient sample
TRAIN = {"config": "qwen2-1.5b", "layers": None, "batch": 4, "seq": 1024,
         "warmup": 1, "steps": 5, "lr": 3e-4,
         "grad_sample": ("embed/embedding", "attn/wq", "attn/bk", "attn/wo",
                         "ln1", "ffn/w_down")}
# the first step through the kernels against the same step through the
# plain attention: bf16 compute over 28 layers, sums in another order
TRAIN_TOL = {"loss_rtol": 1e-2, "grad_rel_l2": 5e-2}
# the train_mla phase: DeepSeek-V2-Lite at its published widths (float32
# params, bf16 compute, remat), depth cut to 2 of 27 (1.38 B parameters,
# ~22 GB with AdamW's moments and the gradients; 27 layers would need ~256
# GB), 2 x 2,048 tokens a step, 1 + 3 AdamW steps; its gradient sample:
# the MLA projections, a router and a routed expert's weight
TRAIN_MLA = {"config": "deepseek-v2-lite-16b", "layers": 2, "batch": 2,
             "seq": 2048, "warmup": 1, "steps": 3, "lr": 3e-4,
             "grad_sample": ("attn/wq", "attn/w_dkv", "attn/w_uk",
                             "attn/w_uv", "attn/wo", "ffn/router",
                             "ffn/w_down"),
             "counter": "flash_attention_bwd_mla",
             "cut_by": "27 layers need ~256 GB with AdamW"}
# the train_griffin phase: RecurrentGemma-9B at its published widths,
# depth 5 of 38 (one super-block of two recurrent layers and a local
# attention layer, then the two trailing recurrent layers: 5 = 2 mod 3;
# 2.17 B parameters, ~35 GB with AdamW, a step's peak ~65 GB of an 80 GB
# H100 with the float32 logits over 256,000 tokens; 38 layers would need
# ~150 GB), 1 x 3,072 tokens (the 2,048 window masks keys in the
# backward), 1 + 3 steps; its gradient sample: the attention projections
# and the RG-LRU's gates
TRAIN_GRIFFIN = {"config": "recurrentgemma-9b", "layers": 5, "batch": 1,
                 "seq": 3072, "warmup": 1, "steps": 3, "lr": 3e-4,
                 "grad_sample": ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                 "rec/w_r", "rec/w_i", "rec/lam"),
                 "counter": "flash_attention_bwd_rg",
                 "cut_by": "38 layers need ~150 GB with AdamW"}
# the serve_mamba phase: Mamba-2 2.7B at its published widths and all 64
# layers (bf16, ~5.4 GB), requests of min-max prompt tokens, new greedy
# tokens each (16: an eager decode step of 64 layers took 124 ms of host
# time on an H100 80GB HBM3 at 700 W, and at 32 tokens the phase took
# 68.3 s), on batch_slots slots (the state cache is O(1) in max_len)
MAMBA = {"layers": None, "requests": 4, "min_prompt": 1024,
         "max_prompt": 2048, "new_tokens": 16, "batch_slots": 4,
         "max_len": 2560}
# the serve_whisper phase: whisper-tiny at full depth (4 + 4 layers),
# requests of the decoder's 4-token task prefix over 1,500 stub frames
# each, new greedy tokens, one request at a time through prefill and
# decode_step
WHISPER = {"requests": 4, "prompt": 4, "new_tokens": 32}
# the serve_vlm phase: llama-3.2-vision-90b at its published widths, depth
# 5 of 100 (one super-block: the gated cross-attention layer and 5 self
# layers, ~5.5 B bf16 parameters with the tied 128,256 x 8,192 embedding),
# prompts of these lengths over 1,024 stub vision tokens each, new greedy
# tokens, one request at a time through prefill and decode_step
VLM = {"layers": 5, "prompts": (2048, 1536, 768), "new_tokens": 32}
# the zero-initialised leaves the served and trained new families redraw
# (norms as 0.2 * N(0, 1), the tanh gates uniform in [0.5, 1]): at init the
# cross-attention gates are zero and its layers contribute nothing
DRAWN_NORMS = ("ln", "ln1", "ln2", "lnx", "ln_x", "ln_f", "out_norm",
               "enc_ln1", "enc_ln2", "enc_ln_f", "dec_ln1", "dec_lnx",
               "dec_ln2")
# the train_mamba phase: Mamba-2 2.7B at its published widths (float32
# params, bf16 compute, the SSD in float32, remat), depth cut to 16 of 64
# (0.77 B parameters, ~12 GB with AdamW; all 64 would need ~43 GB before
# activations, and the smoke's time), 4 x 2,048 tokens, 1 + 3 steps; its
# gradient sample: the SSD's decay rate (A_log, where the reference's
# gradient is NaN), step bias, skip, and the projections
TRAIN_MAMBA = {"config": "mamba2-2.7b", "layers": 16, "batch": 4,
               "seq": 2048, "warmup": 1, "steps": 3, "lr": 3e-4,
               "grad_sample": ("mixer/A_log", "mixer/dt_bias", "mixer/D",
                               "mixer/in_proj", "mixer/conv_w",
                               "mixer/out_proj", "embed/embedding"),
               "draw": True,
               "cut_by": "the smoke's time; all 64 need ~43 GB with "
                         "AdamW before activations"}
# the train_whisper phase: whisper-tiny as published (4 + 4 layers),
# 8 clips of 1,500 stub frames and 448 decoder tokens (Whisper's longest
# text), 1 + 3 steps, the gates and norms redrawn so the cross-attention's
# gradients are not zero; its gradient sample: the encoder's, the
# decoder's and the cross-attention's projections and gate
TRAIN_WHISPER = {"config": "whisper-tiny", "layers": None, "batch": 8,
                 "seq": 448, "warmup": 1, "steps": 3, "lr": 3e-4,
                 "context": "audio_embeds", "draw": True,
                 "grad_sample": ("enc_attn/wq", "enc_attn/wo", "dec_attn/wq",
                                 "dec_xattn/wq", "dec_xattn/wk",
                                 "dec_xattn/wv", "dec_xattn/gate",
                                 "dec_mlp/w_down"),
                 "counter": "flash_attention_bwd_whisper"}
# the loop phase: two experts from one base, a crash of expert 0 before
# step CRASH_AT, then ANALYZE, TIES at 50%, and serving the merge, at
# LOOP["layers"] decoder layers (cut from the merge depth of 4 when the
# shards phase came: its float32 checkpoints, ~5 GB at depth 4, are
# most of the phase's time)
LOOP = {"layers": 1, "batch": 2, "seq": 512, "steps": 4, "ckpt_every": 2,
        "crash_at": 3,
        "lr": 1e-3, "eval_batches": 2, "requests": 4, "min_prompt": 64,
        "max_prompt": 256, "new_tokens": 16}
# the store phase: the merge path's widths at STORE["layers"] decoder
# layers (the zlib repack runs on the host at ~9 MB/s: at depth 4 the
# phase alone took 892 s), K experts shaped like partial fine-tunes (the
# frozen tensors byte-equal to the base, experts 0 and 1 sharing the
# attention tensors), a lossless zlib layout, a shared-read cache that
# holds a batch's expert blocks, and a bucket behind an emulated endpoint
# (per-request latency, MB/s); fsck's check pass reads one packed extent
# corrupted (the skip-th read); "tight" is a budget below the layout's
# physical bytes and the warm tier's billed bytes, so selection binds
STORE = {"layers": 1, "k": 4, "frozen": ("embed/embedding", "ln_f"),
         "shared": ("attn/", "ln1"), "layout": "store-zlib",
         "latency_s": 0.002, "mbps": 4000.0, "corrupt_skip": 3,
         "cache_bytes": 16 << 30, "tight": "2%"}
# the bytes a store-phase merge moves by category: packed extents,
# remote GETs and disk-cache hits are expert bytes of their own
STORE_IO = ("base_read", "expert_read", "expert_packed_read",
            "expert_remote_read", "expert_disk_read", "expert_repair_read",
            "out_written")
# the shards phase: shard workers on the merge workspace (process
# transport, one python -m repro_torch.launch.worker per shard); the
# crash kills shard 1 after "crash_at" of its blocks; the whole-shard
# ("mesh") merges run these operators (TIES alone since the whole smoke
# passed 1,000 s with AVG beside it; the card tests and the kernels
# phase's whole-shard row hold AVG's per-row divisor); the pipelined
# windows run these (TIES and DARE since the training phases came: each
# window is ~15 s of worker start and splice; AVG and TA stay in the
# merge, service and inline paths)
SHARDS = {"workers": 2, "crash_at": 0.5, "whole_shard": ("ties",),
          "pipelined": ("ties", "dare")}
# the mesh phase: launch/train.py's path under the (1, 1) mesh over the
# card (DTensor parameters, moments and batches under train_rules, the
# kernels on each rank's shard through local_map) against the same steps
# meshless, from the same seed's weights and batches; published widths
# and configs (float32 params, bf16 compute, remat), depth cut.  Qwen2's
# losses must be bit-equal (no atomics on its path; deterministic cuBLAS,
# as the loop phase has it); DeepSeek's within TRAIN_TOL's loss_rtol
# (its MoE dispatch adds rows with index_add_'s atomics, and autograd
# sums a tensor's gradients in another order around local_map)
MESH = ({"config": "qwen2-1.5b", "layers": 4, "batch": 4, "seq": 1024,
         "steps": 3, "lr": 3e-4, "exact": True,
         "counters": {"flash_attention": "flash_attention",
                      "flash_attention_bwd": "flash_attention_bwd",
                      "flash_attention_bwd_tc": "flash_attention_bwd_tc"}},
        {"config": "deepseek-v2-lite-16b", "layers": 2, "batch": 2,
         "seq": 2048, "steps": 2, "lr": 3e-4, "exact": False,
         "counters": {"flash_attention_tc": "flash_attention_mla",
                      "flash_attention_bwd_tc": "flash_attention_bwd_mla"}})
# the predicted peak may fall below the card's by this share at most
MESH_MEMORY_SLACK = 0.10
# the dryrun phase: python -m repro_torch.launch.dryrun in processes of
# its own (no card: CUDA_VISIBLE_DEVICES empty), each of these archs x
# every shape x both production meshes, beside the card's phases
DRYRUN = {"archs": ("qwen2-1.5b", "deepseek-v2-lite-16b"), "timeout_s": 900}
#: the examples phase: a run's ``meta`` bytes (catalog and manifest JSON,
#: which carry timestamps) move by a byte or two between any two runs of
#: one device; every other IOStats category must be equal
META_SLACK = 64
#: the lint phase's process limit (seconds; it takes a few)
LINT_TIMEOUT_S = 300
# the linear kernel's whole-shard launch with a per-row divisor: about
# the rows a shard stacks at a merge depth of 4 (6,418 blocks of the
# 4-layer model over 2 workers), K = 4, 128 KiB bf16 blocks as float32
WHOLE_SHARD = (3200, 4, 65536)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def qwen2_config(layers: int, compute_dtype: str = "bfloat16"):
    """Qwen2-1.5B at published widths, ``layers`` deep, bf16 params."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers,
                               param_dtype="bfloat16",
                               compute_dtype=compute_dtype)


def populate(mp, layers, k, seed, device, layer_only=False):
    """Register base (``DecoderLM`` init, in the port's flat layout) and
    k full experts, made on ``device`` in bf16.  ``layer_only`` keeps the
    decoder layers and drops the embedding and the final norm."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.store.checkpoint import flatten_tree

    g = torch.Generator(device=device).manual_seed(seed)
    model = build_model(qwen2_config(layers), device=device, generator=g)
    base = {n: t for n, t in flatten_tree(model).items()
            if not (layer_only and n in ("embed/embedding", "ln_f"))}
    mp.register_model("base", base)
    params = {n.replace(".", "/"): p.detach()
              for n, p in model.state_dict(keep_vars=True).items()}
    ids = []
    for e in range(k):
        mp.register_model(f"expert-{e}", {
            n: (params[n].float() + 0.02 * torch.randn(
                params[n].shape, generator=g, device=device)
                ).to(torch.bfloat16)
            for n in base
        })
        ids.append(f"expert-{e}")
    shapes = {n: a.shape for n, a in base.items()}
    return ids, sum(a.size for a in base.values()), shapes


class Timer:
    """Median per-call time: CUDA events on a card (L2 flushed before
    every call, as the merge path meets fresh inputs), else the host
    clock (rehearsal only — not a device time).  The flush writes 1 GiB
    (~0.3 ms of card time), longer than a wrapper's Python before its
    launch, so the card reaches the start event after the launch is
    queued and the events time the kernel, not the host (with 256 MiB,
    kernels under ~0.1 ms read 30-90 us of host delay)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.flush = (torch.empty(1 << 30, dtype=torch.uint8, device=device)
                      if self.cuda else None)

    def __call__(self, fn, reps=25, warm=3):
        import torch

        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            if self.cuda:
                self.flush.zero_()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def wall(self, fn, reps=25, warm=3):
        """Median host-clock ms of one call of ``fn`` from an idle card
        (L2 flushed, then synchronized): ``wall`` to its end on the card
        (the wrapper's host time, its launches and the kernels' time, as
        the merge path pays them call by call) and ``host`` to its return
        (the host's part)."""
        import torch

        for _ in range(warm):
            fn()
        walls, hosts = [], []
        for _ in range(reps):
            if self.cuda:
                self.flush.zero_()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            hosts.append((time.perf_counter() - t0) * 1e3)
            if self.cuda:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return {"wall": statistics.median(walls),
                "host": statistics.median(hosts)}


def phase_kernels(device, seed, nb=32, k=4, w=65536):
    """Kernel vs plain version at the merge path's largest group."""
    import numpy as np
    import torch

    from repro_torch.core.operators import dare_mask_batch
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 1)
    x0 = torch.randn((nb, w), generator=g, device=device)
    D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
    thresh = ref.ties_thresholds(D, 0.3).contiguous()
    masks = torch.from_numpy(np.stack([
        dare_mask_batch(seed, list(range(k)), "model.layers.0.mlp.up_proj.weight",
                        b, w, 0.5)
        for b in range(nb)])).to(device).view(torch.uint8)
    timer = Timer(device)
    f32 = 4
    n_out = nb * w
    base_bytes = (nb * w + nb * k * w + nb * w) * f32
    ones = torch.ones((nb, 1, k), device=device)
    cases = [
        ("linear_merge", "src/repro/kernels/merge_block.py:48",
         lambda: mb.linear_merge(x0, D, 0.7, 1.0),
         lambda: ref.linear_ref(x0, D, 0.7, 1.0),
         # one library call computing x0 + 0.7 * sum_k D_k
         lambda: torch.baddbmm(x0.unsqueeze(1), ones, D, alpha=0.7),
         base_bytes, {"f32": n_out * (k + 1)}),
        ("ties_merge", "src/repro/kernels/merge_block.py:84",
         lambda: mb.ties_merge(x0, D, thresh, 1.0),
         lambda: ref.ties_apply_ref(x0, D, thresh, 1.0),
         None, base_bytes + nb * k * f32,
         {"f32": n_out * k * 6, "f64": n_out * 3}),
        ("dare_merge", "src/repro/kernels/merge_block.py:116",
         lambda: mb.dare_merge(x0, D, masks, 0.5, 1.0),
         lambda: ref.dare_ref(x0, D, masks, 0.5, 1.0),
         None, base_bytes + nb * k * w, {"f32": n_out * (2 * k + 2)}),
    ]
    rows = []
    for name, replaces, kern, plain, library, nbytes, ops in cases:
        kernel_name = name.replace("_merge", "") + "_kernel"
        got, want = kern(), plain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"{name}: kernel disagrees, max abs err {err}")
        # a copy of nbytes / 2 reads and writes nbytes in all, as the kernel
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = sum(n / PEAK[t] for t, n in ops.items()) * 1e3
        rows.append({
            "name": name, "route": "cuda", "kernel": kernel_name,
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": replaces,
            "shape": [nb, k, w], "max_abs_err": err, "bits_differ": n_diff,
            "ms": timer(kern), "plain_ms": timer(plain),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": timer(library) if library is not None else None,
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del src, dst
    del x0, D, thresh, masks
    rows.append(whole_shard_linear_row(device, seed, timer))
    rows += fused_rows(device, seed, timer)
    rows += threshold_rows(device, seed, timer)
    rows += apply_rows(device, seed, timer)
    route_sweep = route_rows(device, seed, timer)
    rows += sketch_rows(device, seed, timer)
    rows += flash_rows(device, seed, timer)
    rows += flash_bwd_rows(device, seed, timer)
    emit({"phase": "kernels", "tolerance": TOL, "kernels": rows,
          "ties_route_sweep": route_sweep})
    return rows


def whole_shard_linear_row(device, seed, timer, shape=WHOLE_SHARD):
    """The linear kernel at the whole-shard AVG's shape with its per-row
    divisor (k_sel + 1 for rows of 0..K selected experts) against its
    plain version, bit for bit; the library call is one baddbmm by the
    rows' reciprocal divisors."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    nb, k, w = shape
    g = torch.Generator(device=device).manual_seed(seed + 5)
    x0 = torch.randn((nb, w), generator=g, device=device)
    D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
    div_rows = (torch.arange(nb, device=device) % (k + 1) + 1).float()
    got = mb.linear_merge(x0, D, 1.0, 1.0, div_rows=div_rows)
    want = ref.linear_ref(x0, D, 1.0, 1.0, div_rows)
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if n_diff:
        raise AssertionError(f"linear_merge (per-row divisor): {n_diff} "
                             f"elements differ from the plain version")
    err = float((got - want).abs().max())
    del got, want
    nbytes = (nb * w + nb * k * w + nb * w) * 4 + nb * 4
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    recip = (1.0 / div_rows)[:, None, None].expand(nb, 1, k).contiguous()
    bytes_ms = nbytes / PEAK["bytes"] * 1e3
    ops_ms = nb * w * (k + 1) / PEAK["f32"] * 1e3
    row = {
        "name": "linear_merge", "route": "cuda", "kernel": "linear_kernel",
        "case": "whole_shard_div_rows",
        "source": "src/repro_torch/csrc/merge_block.cu",
        "replaces": "src/repro/kernels/merge_block.py:48",
        "shape": list(shape), "max_abs_err": err, "bits_differ": n_diff,
        "ms": timer(lambda: mb.linear_merge(x0, D, 1.0, 1.0,
                                            div_rows=div_rows), reps=10),
        "plain_ms": timer(lambda: ref.linear_ref(x0, D, 1.0, 1.0, div_rows),
                          reps=5),
        "copy_ms": timer(lambda: dst.copy_(src), reps=10),
        "library_ms": timer(lambda: torch.baddbmm(x0.unsqueeze(1), recip, D),
                            reps=10),
        "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    del x0, D, src, dst, recip
    return row


def route_rows(device, seed, timer, w=65536, cases=ROUTE_CASES, reps=25):
    """The fused kernel and the pair timed in turns (fused, pair, pair,
    fused) on the same inputs at ROUTE_CASES, beside the route ties_route
    names (bit-equal outputs): CUDA-event ms (the card's time) and wall
    ms (Timer.wall: the host's time too, which sets the route, since the
    merge path waits on each call's host work), and host ms."""
    import torch

    from repro_torch.kernels import merge_block as mb

    g = torch.Generator(device=device).manual_seed(seed + 6)
    out = []
    for nb, k in cases:
        x0 = torch.randn((nb, w), generator=g, device=device)
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)

        def fused():
            return mb.ties_fused(x0, D, TRIM, 1.0)

        def pair():
            return mb.ties_merge(x0, D, mb.ties_thresholds(D, TRIM), 1.0)

        if not torch.equal(fused().view(torch.int32), pair().view(torch.int32)):
            raise AssertionError(f"ties route sweep {(nb, k, w)}: the routes "
                                 f"disagree")
        turns = {f"{r}{m}": [] for r in ("fused", "pair")
                 for m in ("", "_wall", "_host")}
        for name, fn in (("fused", fused), ("pair", pair), ("pair", pair),
                         ("fused", fused)):
            turns[name].append(timer(fn, reps=reps))
            wall = timer.wall(fn, reps=reps)
            turns[name + "_wall"].append(wall["wall"])
            turns[name + "_host"].append(wall["host"])
        mean = {n: statistics.mean(v) for n, v in turns.items()}
        out.append({"shape": [nb, k, w], "rows": nb * k,
                    "ties_route": mb.ties_route(nb, k, w),
                    "fused_ms": mean["fused"], "pair_ms": mean["pair"],
                    "fused_wall_ms": mean["fused_wall"],
                    "pair_wall_ms": mean["pair_wall"],
                    "fused_host_ms": mean["fused_host"],
                    "pair_host_ms": mean["pair_host"],
                    "faster_wall": ("fused" if mean["fused_wall"]
                                    <= mean["pair_wall"] else "pair"),
                    "turns": turns})
        del x0, D
    return out


def fused_rows(device, seed, timer):
    """Fused TIES kernel vs its plain version (torch.kthvalue thresholds,
    then the plain apply) at FUSED_CASES, bit for bit, beside the pair
    (threshold kernel, then apply kernel) on the same inputs."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 5)
    rows = []
    for label, (nb, k, w) in FUSED_CASES:
        x0 = torch.randn((nb, w), generator=g, device=device)
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
        got, thresh = mb.ties_fused(x0, D, TRIM, 1.0, thresholds=True)
        want_t = ref.ties_thresholds(D, TRIM)
        want = ref.ties_apply_ref(x0, D, want_t, 1.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if n_diff or not torch.equal(thresh.view(torch.int32),
                                     want_t.view(torch.int32)):
            raise AssertionError(f"ties_fused {label}: kernel disagrees in "
                                 f"{n_diff} elements or in its thresholds")
        plan = (mb.ties_fused_occupancy(k, w) if device.type == "cuda"
                else mb.ties_fused_plan(k, w))
        nbytes = (2 * nb * w + nb * k * w) * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        # the threshold's |x| and compare per element and radix pass, the
        # apply's float32 trim / elect / sum and its float64 epilogue
        ops_ms = (2 * 4 * nb * k * w / PEAK["f32"]
                  + nb * w * k * 6 / PEAK["f32"] + nb * w * 3 / PEAK["f64"]) * 1e3
        rows.append({
            "name": "ties_fused", "route": "cuda", "case": label,
            "kernel": "ties_fused_kernel", "ties_route": mb.ties_route(nb, k, w),
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/merge_block.py:84",
            "also_replaces": "src/repro/kernels/ref.py:19",
            "shape": [nb, k, w], "trim_frac": TRIM,
            "max_abs_err": float((got - want).abs().max()),
            "bits_differ": n_diff, "thresholds_bit_equal": True,
            "cluster": plan["cluster"], "ctas": nb * plan["cluster"],
            "smem_per_cta": plan["smem"],
            "clusters_resident": plan.get("clusters"),
            "ms": timer(lambda: mb.ties_fused(x0, D, TRIM, 1.0)),
            "plain_ms": timer(lambda: ref.ties_ref(x0, D, TRIM, 1.0)),
            "pair_ms": timer(lambda: mb.ties_merge(
                x0, D, mb.ties_thresholds(D, TRIM), 1.0)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": None,  # no one PyTorch call computes TIES
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del x0, D, got, thresh, want, want_t, src, dst
    return rows


#: the pair route's kernels in a profile: the threshold's (one CTA a row;
#: or the clear kernel and three passes) and the apply
PAIR_KERNELS = r"\bties_(threshold_\w*)?kernel\b"


def pair_device_ms(fn, timer):
    """Profiler device ms of the pair's kernels per call of ``fn``."""
    return kernel_device_ms(fn, PAIR_KERNELS, timer)


def threshold_rows(device, seed, timer):
    """TIES threshold kernel vs torch.kthvalue (its plain version) at
    PAIR_CASES, bit for bit."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 4)
    rows = []
    for label, (nb, k, w) in PAIR_CASES:
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
        got, want = mb.ties_thresholds(D, TRIM), ref.ties_thresholds(D, TRIM)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"ties_threshold {label}: kernel disagrees "
                                 f"with kthvalue")
        absd = D.abs()
        kth = w - ref.ties_keep(TRIM, w) + 1
        nbytes = nb * k * w * 4 + nb * k * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        # one |x|, a compare and a histogram add per element and full pass
        # (two passes), counted as float32 operations
        ops_ms = 2 * 3 * nb * k * w / PEAK["f32"] * 1e3
        fn = lambda: mb.ties_thresholds(D, TRIM)  # noqa: E731
        plan = mb.ties_threshold_plan(nb * k, w)
        kernels = (["ties_threshold_row_kernel"] if plan["variant"] == "row"
                   else ["ties_threshold_clear_kernel", "ties_threshold_kernel",
                         "ties_threshold_compact_kernel",
                         "ties_threshold_finish_kernel"])
        rows.append({
            "name": "ties_threshold", "route": "cuda", "case": label,
            "kernel": kernels[-1 if plan["variant"] == "row" else 1],
            "kernels": kernels,
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/ref.py:19",
            "shape": [nb, k, w], "trim_frac": TRIM, "max_abs_err": 0.0,
            "bits_differ": 0, "plan": plan,
            "ms": timer(fn),
            "device_ms": (pair_device_ms(fn, timer)
                          if device.type == "cuda" else None),
            "plain_ms": timer(lambda: ref.ties_thresholds(D, TRIM)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            # one library call given |D|: torch.kthvalue
            "library_ms": timer(lambda: torch.kthvalue(absd, kth, dim=-1)),
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del D, absd, got, want, src, dst
    return rows


def apply_rows(device, seed, timer):
    """The pair's apply kernel vs its plain version at PAIR_CASES beyond
    the first (phase_kernels times that one with the other merge
    kernels), bit for bit, given torch.kthvalue thresholds."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 7)
    rows = []
    for label, (nb, k, w) in PAIR_CASES[1:]:
        x0 = torch.randn((nb, w), generator=g, device=device)
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
        thresh = ref.ties_thresholds(D, TRIM).contiguous()
        got = mb.ties_merge(x0, D, thresh, 1.0)
        want = ref.ties_apply_ref(x0, D, thresh, 1.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if n_diff:
            raise AssertionError(f"ties_merge {label}: kernel disagrees in "
                                 f"{n_diff} elements")
        nbytes = (2 * nb * w + nb * k * w + nb * k) * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = (nb * w * k * 6 / PEAK["f32"] + nb * w * 3 / PEAK["f64"]) * 1e3
        fn = lambda: mb.ties_merge(x0, D, thresh, 1.0)  # noqa: E731
        rows.append({
            "name": "ties_merge", "route": "cuda", "case": label,
            "kernel": "ties_kernel",
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/merge_block.py:84",
            "shape": [nb, k, w], "max_abs_err": float((got - want).abs().max()),
            "bits_differ": 0, "plan": mb.ties_apply_plan(nb, k, w),
            "ms": timer(fn),
            "device_ms": (pair_device_ms(fn, timer)
                          if device.type == "cuda" else None),
            "plain_ms": timer(lambda: ref.ties_apply_ref(x0, D, thresh, 1.0)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": None,  # no one PyTorch call computes the apply
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del x0, D, thresh, got, want, src, dst
    return rows


def sketch_close(got, want, w):
    """The l2 and mean bars of tests/test_kernels.py on the raw sums,
    max|x| bit for bit; returns the largest relative error of each."""
    import torch

    rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).amax(dim=0)
    ok = (torch.allclose(got[:, 0], want[:, 0], rtol=2e-4, atol=0)
          and torch.equal(got[:, 1], want[:, 1])
          and torch.allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=1e-6 * w))
    return ok, [float(r) for r in rel]


def sketch_rows(device, seed, timer):
    """ANALYZE sketch kernel vs its plain version at SKETCH_CASES."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 3)
    rows = []
    for label, (nb, w) in SKETCH_CASES:
        x = 0.03 * torch.randn((nb, w), generator=g, device=device)
        got, want = mb.sketch_blocks(x), ref.sketch_ref(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ok, rel = sketch_close(got, want, w)
        err = float((got - want).abs().max())
        if not ok:
            raise AssertionError(f"sketch_blocks {label}: kernel disagrees, "
                                 f"relative errors {rel}")
        nbytes = nb * w * 4 + nb * 3 * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = 3 * nb * w / PEAK["f32"] * 1e3  # x*x+s, max|x|, s+x
        rows.append({
            "name": "sketch_blocks", "route": "cuda", "case": label,
            "kernel": "sketch_kernel",
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/merge_block.py:161",
            "shape": [nb, w], "max_abs_err": err, "max_rel_err": rel,
            "absmax_bit_equal": True,
            "ms": timer(lambda: mb.sketch_blocks(x)),
            "plain_ms": timer(lambda: ref.sketch_ref(x)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": None,  # no one PyTorch call gives all three
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del x, got, want, src, dst
    return rows


def attention_mask(sq, sk, causal, window, q_offset, device):
    """(Sq, Sk) bool: which keys each query attends."""
    import torch

    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= qpos >= kpos
    if window > 0:
        valid &= qpos - kpos < window
    return valid


def flash_rows(device, seed, timer):
    """Flash-attention kernel vs its plain version at FA_CASES."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 2)
    rows = []
    for (label, (b, sq, sk, h, hkv, hd, hdv), dt, causal, window, qoff,
         route) in FA_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, hd), generator=g, device=device).to(dtype)
        k = torch.randn((b, sk, hkv, hd), generator=g, device=device).to(dtype)
        v = torch.randn((b, sk, hkv, hdv), generator=g, device=device).to(dtype)

        def kern():
            return fa.launch(q, k, v, causal, window, qoff, route)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal, window, qoff,
                                           skip_masked_chunks=True)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != (b, sq, h, hdv):
            raise AssertionError(f"flash_attention {label}: output "
                                 f"{tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        tol = FA_TOL[dt]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {label}: kernel disagrees, "
                                 f"max abs err {err}")
        n_diff = int((got != want).sum())
        # yardstick only: one PyTorch call computing the same function
        mask = attention_mask(sq, sk, causal, window, qoff, device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        full_causal = causal and window == 0 and qoff == 0 and sq == sk
        lib_mask = None if full_causal or bool(mask.all()) else mask

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=lib_mask, is_causal=full_causal,
                enable_gqa=True)

        # live work: 2 FLOP per (q, k) pair and q.k head dim, 2 per pair
        # and v head dim for p.v
        flops = 2 * (hd + hdv) * int(mask.sum()) * b * h
        nbytes = (q.numel() + k.numel() + v.numel()
                  + got.numel()) * q.element_size()
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = flops / PEAK["bf16" if dt == "bfloat16" else "f32"] * 1e3
        plan = fa.forward_plan(b, sq, sk, h, hkv, hd, dtype, route, hdv=hdv)
        kernel = plan["kernel"]
        row = {
            "name": "flash_attention", "route": "cuda", "case": label,
            "fa_route": route, "kernel": kernel,
            "routed_by_rule": route == fa._route(dtype, hd, hdv),
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "shape": [b, sq, sk, h, hkv, hd, hdv], "dtype": dt,
            "causal": causal, "window": window, "q_offset": qoff,
            "tolerance": tol, "max_abs_err": err, "elements_differ": n_diff,
            "ms": timer(kern), "plain_ms": timer(plain),
            "copy_ms": None, "library_ms": timer(library),
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        if label in FA_ROWS:
            row.update(counter=FA_ROWS[label], device_ms=kernel_device_ms(
                kern, rf"\b{kernel}\b", timer))
        if route == "tc" and hd > 128:
            # the warp-specialised layout, beside its time
            row.update(layout=fa.forward_tile_work(hd, hdv),
                       smem_bytes=plan["smem_bytes"], stages=plan["stages"])
        rows.append(row)
        del q, k, v, got, want, mask
    return rows


def kernel_device_ms(fn, pattern, timer, reps=20):
    """Mean device time (torch.profiler) of the kernels matching
    ``pattern`` per call of ``fn``, L2 flushed before each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if timer.flush is not None:
                timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(t for n, t in device_time_ms(prof).items()
               if re.search(pattern, n)) / reps


def grad_errors(got, want, tol):
    """Max abs and max relative error of each of dq, dk, dv against
    ``want``, and whether each meets ``tol`` (torch.allclose)."""
    import torch

    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        d = (a.float() - w.float()).abs()
        errs[name] = {
            "max_abs_err": float(d.max()),
            "max_rel_err": float((d / w.float().abs().clamp(
                min=tol["atol"])).max()),
            "ok": bool(torch.allclose(a.float(), w.float(), **tol))}
    return errs


def flash_bwd_rows(device, seed, timer):
    """Flash backward kernels against autograd through the plain version
    at BWD_CASES, on every route the dtype takes (bf16: the tensor-core
    route and the FMA route; float32: the FMA route): errors of dq, dk,
    dv, determinism (two runs, equal bits), times of both routes in turns
    (tc, fma, fma, tc), the plain backward and SDPA's backward with SDPA's
    errors against the same reference, the tensor-core route's device
    time by kernel (the GQA reduction's own), the bound and the share of
    it, and the forward timed with and without its lse output.  The route
    gate: where the rule routes the train case to the tensor cores, they
    must beat the FMA route there."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 7)
    rows = []
    for label, (b, s, h, hkv, hd, hdv), dt, causal, window in BWD_CASES:
        dtype = getattr(torch, dt)
        # the training phases' shapes: FMA-route and plain calls of tens of
        # ms, so fewer timed calls
        reps, warm = ((7, 1) if b * s * s * h > 2 * 1024 * 1024 * 12
                      else (25, 3))

        def rand(*shape):
            return torch.randn(shape, generator=g, device=device).to(dtype)

        q, k, v = rand(b, s, h, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hdv)
        do = rand(b, s, h, hdv)
        route = fa._route(dtype, hd, hdv)
        o, lse = fa._forward(q, k, v, causal, window, 0, route, with_lse=True)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_out = ref.flash_attention_ref(*qkv, causal, window, 0)

        def plain():
            return torch.autograd.grad(ref_out, qkv, do, retain_graph=True)

        want = plain()
        tol = BWD_TOL[dt]
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        routes = [route] + (["fma"] if route == "tc" else [])
        kerns, errs = {}, {}
        for r in routes:
            kerns[r] = (lambda r=r: fa.backward(do, q, k, v, o, lse, causal,
                                                window, route=r))
            got, again = kerns[r](), kerns[r]()
            torch.cuda.synchronize()
            errs[r] = grad_errors(got, want, tol)
            for name, e in errs[r].items():
                if not e["ok"]:
                    raise AssertionError(f"flash backward {label} ({r}): "
                                         f"{name} disagrees: {e}")
            if not all(torch.equal(x.view(view), y.view(view))
                       for x, y in zip(got, again)):
                raise AssertionError(f"flash backward {label} ({r}): two "
                                     f"runs differ")
            del got, again
        # yardstick only: SDPA's backward on the same inputs
        mask = attention_mask(s, s, causal, window, 0, device)
        lib_q, lib_k, lib_v = (t.transpose(1, 2).detach().clone()
                               .requires_grad_() for t in (q, k, v))
        full_causal = causal and window == 0
        lib_mask = None if full_causal or bool(mask.all()) else mask
        lib_out = F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=lib_mask, is_causal=full_causal,
            enable_gqa=True)
        lib_do = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (lib_q, lib_k, lib_v), lib_do,
                                       retain_graph=True)

        sdpa_errs = grad_errors([t.transpose(1, 2) for t in library()], want,
                                tol)
        # SDPA's backward by device time: its autograd call can stay on the
        # host longer than the Timer's L2 flush runs, and then CUDA events
        # read host delay; every kernel of the profile but the flush's fill
        library_dev = kernel_device_ms(library, r"^(?!.*FillFunctor<unsign)",
                                       timer, reps=min(reps * 3, 20))
        # both routes in turns: route, fma, fma, route
        turns = {r: [] for r in routes}
        for r in routes + routes[::-1]:
            turns[r].append(timer(kerns[r], reps=reps, warm=warm))
        ms = {r: statistics.median(t) for r, t in turns.items()}
        if label == "train" and route == "tc" and ms["tc"] >= ms["fma"]:
            raise AssertionError(f"route gate: the tensor-core backward "
                                 f"({ms['tc']} ms) is not faster than the "
                                 f"FMA backward ({ms['fma']} ms)")
        kernels = [n for n, _ in fa.backward_plan(b, s, s, h, hkv, hd,
                                                  dtype, hdv=hdv)["kernels"]]
        by_kernel = None
        if route == "tc":  # device time of each kernel of the route
            by_kernel = {n: kernel_device_ms(kerns["tc"], n, timer)
                         for n in kernels}

        pairs = int(mask.sum())
        # the five products: S, dK and dQ over hd, dP and dV over hdv
        flops = 2 * (3 * hd + 2 * hdv) * pairs * b * h
        el = q.element_size()
        # q, dq, k, dk at hd; o, dO, v, dv at hdv; lse
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + do.numel()) * el
                  + lse.numel() * 4)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = flops / PEAK["bf16" if dt == "bfloat16" else "f32"] * 1e3
        bound = max(bytes_ms, ops_ms)
        # the forward with and without lse, in turns (null, lse, lse,
        # null), by the flash kernel's device time
        fwd = {"lse_null": [], "lse": []}
        for with_lse in (False, True, True, False):
            fwd["lse" if with_lse else "lse_null"].append(kernel_device_ms(
                lambda: fa._forward(q, k, v, causal, window, 0, route,
                                    with_lse=with_lse),
                r"flash_attention(_tc|_ws)?_kernel", timer))
        rows.append({
            "name": "flash_attention_bwd", "route": "cuda", "case": label,
            "fa_route": route,
            "counter": BWD_ROWS.get(label, "flash_attention_bwd_tc"
                                    if route == "tc"
                                    else "flash_attention_bwd"),
            "kernel": " + ".join(kernels),
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:92",
            "replaces_note": "XLA autodiff of the jnp chunked attention; the "
                             "JAX package has no backward kernel",
            "shape": [b, s, s, h, hkv, hd, hdv], "dtype": dt,
            "causal": causal,
            "window": window, "forward_route": route, "tolerance": tol,
            "errors": errs[route], "fma_errors": errs.get("fma"),
            "sdpa_errors": sdpa_errs,
            "max_abs_err": max(e["max_abs_err"]
                               for e in errs[route].values()),
            "deterministic": True,
            "ms": ms[route], "fma_ms": ms["fma"], "route_turns_ms": turns,
            "device_ms_by_kernel": by_kernel,
            "device_ms": sum(by_kernel.values()) if by_kernel else None,
            # the route's products a (64 x 64) tile and each warpgroup's
            # share of them, in hd-units
            "tile_work": (fa.backward_tile_work(hd, hdv) if route == "tc"
                          else None),
            "plain_ms": timer(plain, reps=reps, warm=warm),
            "library_ms": library_dev,
            "library_event_ms": timer(library, reps=reps, warm=warm),
            "copy_ms": None, "forward_ms": fwd, "flops": flops,
            "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound / ms[route],
        })
        del q, k, v, do, o, lse, qkv, ref_out, want, lib_out
        del lib_q, lib_k, lib_v, mask, kerns
    return rows


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between two uint16 word arrays."""
    import numpy as np

    def ordered(u):
        u = u.astype(np.int32)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def analyze_parity(mp, ids, cpu_catalog, block_size):
    """ANALYZE on ``mp``'s device against the CPU into ``cpu_catalog``:
    catalog rows, then plan selections for every operator."""
    import math

    from repro_torch.core.planner import plan_merge
    from repro_torch.core.sketch import analyze_model

    models = ["base", *ids]
    for m in models:
        analyze_model(cpu_catalog, mp.snapshots.models, m, block_size,
                      base_id=None if m == "base" else "base", device="cpu")
    rows = 0
    worst = {"l2": 0.0, "mean": 0.0, "l2_delta": 0.0}
    for m in models:
        a = mp.catalog.block_metas(m, block_size)
        b = cpu_catalog.block_metas(m, block_size)
        if len(a) != len(b) or not a:
            raise AssertionError(f"analyze parity {m}: {len(a)} vs {len(b)} rows")
        for ra, rb in zip(a, b):
            # tensor, block, bytes, hash; absmax; sign signature
            if ra[:4] != rb[:4] or ra[5] != rb[5] or ra[7] != rb[7]:
                raise AssertionError(f"analyze parity {m}: {ra} vs {rb}")
            for i, key in ((4, "l2"), (6, "mean"), (8, "l2_delta")):
                if (ra[i] is None) != (rb[i] is None):
                    raise AssertionError(f"analyze parity {m} {key}: {ra} vs {rb}")
                if ra[i] is None:
                    continue
                if not math.isclose(ra[i], rb[i], rel_tol=ANALYZE_TOL["rtol"],
                                    abs_tol=ANALYZE_TOL["atol"]):
                    raise AssertionError(f"analyze parity {m} {key}: "
                                         f"{ra[i]} vs {rb[i]}")
                worst[key] = max(worst[key], abs(ra[i] - rb[i]))
        rows += len(a)
    plans = {}
    budget_b = mp.resolve_budget(ids, 0.5)
    for op, theta in OPS:
        pa, pb = (plan_merge(cat, "base", ids, op, theta=theta,
                             budget_b=budget_b, block_size=block_size,
                             reuse=False).plan
                  for cat in (mp.catalog, cpu_catalog))
        same = (pa.selection == pb.selection
                and pa.c_expert_hat == pb.c_expert_hat)
        if not same:
            raise AssertionError(f"analyze parity: {op} plans differ")
        plans[op] = {"c_expert_hat": pa.c_expert_hat, "identical": True}
    return {"rows": rows, "tolerance": ANALYZE_TOL, "max_abs_err": worst,
            "plans": plans}


def ties_device_ms(prof):
    """Device ms of a profiled run's TIES kernels by route: the pair's
    (PAIR_KERNELS) and the fused one."""
    ms = device_time_ms(prof)
    return {"pair_device_ms": sum(t for n, t in ms.items()
                                  if re.search(PAIR_KERNELS, n)),
            "fused_device_ms": sum(t for n, t in ms.items()
                                   if re.search(r"\bties_fused_kernel\b", n))}


def phase_parity(root, device, seed, block_size):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.core.catalog import Catalog
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "parity"), block_size=block_size,
                   device=device)
    ids, n_params, _ = populate(mp, 1, 4, seed, device, layer_only=True)
    out = {"phase": "parity", "layers": 1, "params": n_params, "ops": {}}
    mp.ensure_analyzed("base", ids)
    cpu_catalog = Catalog(os.path.join(root, "parity-cpu.sqlite"))
    out["analyze"] = analyze_parity(mp, ids, cpu_catalog, block_size)
    cpu_catalog.close()
    for op, theta in OPS:
        with measure(mp.stats) as io_k:
            rk = mp.merge("base", ids, op, theta=theta, budget=0.5)
        with measure(mp.stats) as io_s:
            rs = mp.merge("base", ids, op, theta=theta, budget=0.5,
                          compute="stream")
        out["ops"][op] = snapshot_parity(mp, rk.sid, rs.sid, io_k, io_s)
        if out["ops"][op]["max_ulp"] > 1 or not out["ops"][op]["iostats_equal"]:
            raise AssertionError(f"parity {op}: {out['ops'][op]}")
    mp.close()

    # the pair route through the merge path: TIES at 2 MiB blocks, where
    # ties_route sends what the fused kernel cannot stage to the pair; the
    # launch counts start at 0 here and are read after
    theta = dict(OPS)["ties"]
    mp = MergePipe(os.path.join(root, "parity"), block_size=PAIR_BLOCK_SIZE,
                   device=device)
    mp.ensure_analyzed("base", ids)
    mb.reset_launches()
    with (measure(mp.stats) as io_k, ties_routes() as seen,
          profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                              else ProfilerActivity.CPU]) as prof):
        rk = mp.merge("base", ids, "ties", theta=theta, budget=0.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
    launches = dict(mb.LAUNCHES)
    routes = check_ties_routes(seen, launches, "parity ties (2 MiB blocks)")
    if routes["pair"] == 0:
        raise AssertionError(f"parity ties (2 MiB blocks): no launch on the "
                             f"pair route: {routes}")
    with measure(mp.stats) as io_s:
        rs = mp.merge("base", ids, "ties", theta=theta, budget=0.5,
                      compute="stream")
    pair = snapshot_parity(mp, rk.sid, rs.sid, io_k, io_s)
    if pair["max_ulp"] > 1 or not pair["iostats_equal"]:
        raise AssertionError(f"parity ties (2 MiB blocks): {pair}")
    out["ties_2mib_blocks"] = {"block_size": PAIR_BLOCK_SIZE, **pair,
                               "routes": routes, "launches": launches,
                               "pair_shapes": launch_shapes(
                                   [sh for r, sh in seen if r == "pair"]),
                               **ties_device_ms(prof)}
    mp.close()
    out["nan_bits"] = nan_parity(device, seed)
    emit(out)
    return launches


def nan_parity(device, seed, w=65536):
    """A bf16 merge on the card with NaN inputs (base words -NaN, +NaN,
    payload NaNs of each sign, ±inf; NaN deltas of each sign) against the
    numpy operator, bit for bit, every operator: NaN outputs carry
    from_float32's bits (sign | 0x7FC0)."""
    import numpy as np

    from repro_torch.core.operators import apply_operator
    from repro_torch.kernels import ops
    from repro_torch.store import dtypes

    rng = np.random.default_rng(seed + 11)
    nb, k = 4, 3
    x0 = rng.normal(size=(nb, w)).astype(np.float32)
    D = (0.02 * rng.normal(size=(nb, k, w))).astype(np.float32)
    masks = rng.random((nb, k, w)) < 0.5
    words = dtypes.from_float32(x0, dtypes.BFLOAT16)
    words[:, 3:10] = [0xFFC0, 0x7FC0, 0x7FC1, 0xFFA5, 0x7F81, 0xFF80, 0x7F80]
    out = {}
    for op, theta in OPS:
        d, m = D.copy(), masks.copy()
        if op != "ties":  # TIES with a NaN delta: a documented divergence
            d[:, 1, 50:54] = np.array([0x7FC00000, 0xFFC00000, 0x7FA00001,
                                       0xFF812345], np.uint32).view(np.float32)
            m[:, 1, 50:54] = True
        kw = {"masks": m} if op == "dare" else {}
        got = ops.merge_blocks(op, words, d, theta, device=device,
                               out_dtype=dtypes.BFLOAT16, **kw)
        n_diff = n_nan = 0
        for b in range(nb):
            th = dict(theta, _masks=m[b]) if op == "dare" else theta
            want = apply_operator(words[b], d[b], op, th)
            n_diff += int(np.count_nonzero(got[b] != want))
            n_nan += int(np.count_nonzero((want & 0x7FFF) > 0x7F80))
        if n_diff or n_nan < 5 * nb:
            raise AssertionError(f"parity nan {op}: {n_diff} words differ "
                                 f"({n_nan} NaN outputs)")
        out[op] = {"elements": nb * w, "nan_outputs": n_nan,
                   "elements_differ": 0}
    return out


def snapshot_parity(mp, sid_kernel, sid_stream, io_k, io_s):
    """bf16 ulps between two snapshots of ``mp`` and whether their
    per-category I/O bytes are equal."""
    import numpy as np

    a, b = mp.load(sid_kernel), mp.load(sid_stream)
    n_diff = max_ulp = n = 0
    for t in a:
        ulps = bf16_ulps(a[t], b[t])
        n_diff += int(np.count_nonzero(ulps))
        max_ulp = max(max_ulp, int(ulps.max()))
        n += ulps.size
    io_same = all(io_k[c] == io_s[c]
                  for c in ("base_read", "expert_read", "out_written"))
    return {"elements": n, "elements_differ": n_diff, "max_ulp": max_ulp,
            "iostats_equal": io_same}


@contextlib.contextmanager
def ties_routes():
    """Record the route and shape of every TIES merge that reaches the
    kernels' wrappers: a list of ("fused" | "pair", (NB, K, W))."""
    from repro_torch.kernels import merge_block as mb

    seen = []
    fused, thresholds = mb.ties_fused, mb.ties_thresholds

    def rec_fused(x0, D, *a, **kw):
        seen.append(("fused", tuple(D.shape)))
        return fused(x0, D, *a, **kw)

    def rec_thresholds(D, *a, **kw):
        seen.append(("pair", tuple(D.shape)))
        return thresholds(D, *a, **kw)

    mb.ties_fused, mb.ties_thresholds = rec_fused, rec_thresholds
    try:
        yield seen
    finally:
        mb.ties_fused, mb.ties_thresholds = fused, thresholds


def check_ties_routes(seen, launches, where):
    """Every TIES merge took the route ties_route names for its shape, and
    the kernels' launch counts agree; returns the launches per route."""
    from repro_torch.kernels import merge_block as mb

    wrong = [(r, sh) for r, sh in seen if r != mb.ties_route(*sh)]
    if wrong:
        raise AssertionError(f"{where}: TIES launches off their route: "
                             f"{wrong[:4]}")
    n = collections.Counter(r for r, _ in seen)
    if (launches["ties_fused"] != n["fused"]
            or launches["ties_merge"] != n["pair"]):
        raise AssertionError(f"{where}: routes {dict(n)} but launches "
                             f"{launches}")
    return {"fused": n["fused"], "pair": n["pair"]}


def launch_shapes(shapes):
    """Rows, median and most common (NB, K, W) of a list of launches."""
    by_rows = sorted(shapes, key=lambda sh: (sh[0] * sh[1], sh))
    return {"rows_min": by_rows[0][0] * by_rows[0][1],
            "rows_max": by_rows[-1][0] * by_rows[-1][1],
            "median_shape": list(by_rows[len(by_rows) // 2]),
            "most_common": [[list(sh), n] for sh, n in
                            collections.Counter(shapes).most_common(4)]}


def analyze_bytes(stats, before):
    """Bytes read under the ``analyze`` I/O category since ``before``."""
    def read(snap):
        return snap["read"].get("analyze", {}).get("bytes", 0)

    return read(stats.snapshot()) - read(before)


def device_time_ms(prof):
    """Device time per activity (kernels, copies) of a profiled run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key[:80]] = us / 1e3
    return out


def phase_merge(root, device, seed, block_size, layers):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sketch
    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ops
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "merge"), block_size=block_size,
                   device=device)
    t0 = time.perf_counter()
    ids, n_params, shapes = populate(mp, layers, 4, seed, device)
    t_reg = time.perf_counter() - t0
    activities = [ProfilerActivity.CUDA if device.type == "cuda"
                  else ProfilerActivity.CPU]
    # host time of ANALYZE's sketch stage (stack, staging, kernels, copy
    # back); the rest of ANALYZE is reads, hashes and signatures
    real_sketch_rows = sketch._sketch_rows
    sketch_s = [0.0]

    def timed_sketch_rows(*a, **kw):
        t = time.perf_counter()
        try:
            return real_sketch_rows(*a, **kw)
        finally:
            sketch_s[0] += time.perf_counter() - t

    sketch._sketch_rows = timed_sketch_rows
    # the main path: launch counts start at 0 here and are read at the end
    mb.reset_launches()
    before = mp.stats.snapshot()
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof:
            mp.ensure_analyzed("base", ids)
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        sketch._sketch_rows = real_sketch_rows
    t_analyze = time.perf_counter() - t0
    sketches = mb.LAUNCHES["sketch_blocks"]
    if sketches == 0:
        raise AssertionError("analyze: sketch_blocks never launched")
    device_ms = device_time_ms(prof)
    sketch_ms = sum(t for n, t in device_ms.items() if "sketch_kernel" in n)
    busy = sum(device_ms.values())
    out = {"phase": "merge", "layers": layers, "params_per_model": n_params,
           "k": len(ids), "budget": 0.5, "register_s": t_reg,
           "analyze": {"wall_s": t_analyze, "sketch_stage_s": sketch_s[0],
                       "analyze_bytes": analyze_bytes(mp.stats, before),
                       "sketch_launches": sketches,
                       "sketch_kernel_ms": sketch_ms,
                       "device_busy_ms": busy,
                       "device_idle_share": 1 - busy / 1e3 / t_analyze,
                       "device_top_ms": dict(sorted(
                           device_ms.items(), key=lambda kv: -kv[1])[:6])},
           "ops": {}}
    # host time of the engine's compute stage (staging, kernels, copy back)
    real_merge_blocks = ops.merge_blocks
    stage_s = [0.0]

    def timed_merge_blocks(*a, **kw):
        t = time.perf_counter()
        try:
            return real_merge_blocks(*a, **kw)
        finally:
            stage_s[0] += time.perf_counter() - t

    ops.merge_blocks = timed_merge_blocks
    local = {}
    for op, theta in OPS:
        before = dict(mb.LAUNCHES)
        stage_s[0] = 0.0
        t0 = time.perf_counter()
        with (measure(mp.stats) as io, profile(activities=activities) as prof,
              ties_routes() as seen):
            res = mp.merge("base", ids, op, theta=theta, budget=0.5)
        wall = time.perf_counter() - t0
        device_ms = device_time_ms(prof)

        def kernel_time(pattern):
            return sum(t for n, t in device_ms.items() if re.search(pattern, n))

        kernel_ms = kernel_time(r"\b(linear|ties|dare)_kernel\b")
        threshold_ms = kernel_time(r"\bties_threshold_\w*kernel\b")
        fused_ms = kernel_time(r"\bties_fused_kernel\b")
        kth = [n for n in device_ms if re.search("kth", n, re.I)]
        if kth:
            raise AssertionError(f"merge {op}: a kthvalue kernel ran: {kth}")
        launches = {n: mb.LAUNCHES[n] - before[n] for n in mb.LAUNCHES}
        wants = (["dare_merge"] if op == "dare" else
                 [] if op == "ties" else ["linear_merge"])
        for want in wants:
            if launches[want] == 0:
                raise AssertionError(f"merge {op}: {want} never launched")
        routes = check_ties_routes(seen, launches, f"merge {op}")
        if op == "ties":
            if not seen:
                raise AssertionError("merge ties: no TIES kernel launched")
            # the profile holds the pair's kernels only where it ran
            pair_ms = kernel_time(PAIR_KERNELS)
            if (routes["pair"] == 0) != (pair_ms == 0) or (
                    (routes["fused"] == 0) != (fused_ms == 0)):
                raise AssertionError(f"merge ties: routes {routes}, profile "
                                     f"{fused_ms} ms fused, {pair_ms} ms pair")
        run, hat = res.stats["c_expert_run"], res.stats["c_expert_hat"]
        if run > hat:
            raise AssertionError(f"merge {op}: c_expert_run {run} > hat {hat}")
        merged = mp.load(res.sid)
        for name, shape in shapes.items():
            u = merged[name]
            if u.shape != shape or np.any((u & 0x7F80) == 0x7F80):
                raise AssertionError(f"merge {op}: {name} not finite / wrong shape")
        if not mp.verify(res.sid):
            raise AssertionError(f"merge {op}: snapshot hashes do not verify")
        out["ops"][op] = {
            "wall_s": wall, "out_mb_per_s": io["out_written"] / wall / 1e6,
            "base_read": io["base_read"], "expert_read": io["expert_read"],
            "out_written": io["out_written"], "c_expert_run": run,
            "c_expert_hat": hat, "windows": res.stats["pipeline"]["windows"],
            "launches": launches, "kernel_ms": kernel_ms,
            "threshold_kernel_ms": threshold_ms, "fused_kernel_ms": fused_ms,
            "compute_stage_s": stage_s[0],
            "device_busy_ms": sum(device_ms.values()),
            "device_idle_share": 1 - sum(device_ms.values()) / 1e3 / wall,
            "device_top_ms": dict(sorted(device_ms.items(),
                                         key=lambda kv: -kv[1])[:6]),
        }
        local[op] = {"sid": res.sid, "io": {
            c: io[c] for c in ("base_read", "expert_read", "out_written")}}
        if op == "ties":
            ties_sid, ties_flat = res.sid, merged
            # TIES device time: the fused kernel, or the threshold kernel
            # and the apply kernel, by route
            out["ops"][op]["ties_device_ms"] = fused_ms + kernel_ms + threshold_ms
            out["ops"][op]["ties_launches"] = {
                "routes": routes, **launch_shapes([sh for _, sh in seen]),
                "pair_shapes": launch_shapes([sh for r, sh in seen
                                              if r == "pair"])
                if routes["pair"] else None}
        del merged
    ops.merge_blocks = real_merge_blocks
    out["launches"] = dict(mb.LAUNCHES)
    out["ties_sid"] = ties_sid
    mp.close()
    emit(out)
    return out["launches"], ties_flat, local


def phase_service(root, device, block_size):
    """merge_cli --spec, in process, on the merge workspace."""
    import torch

    from repro_torch.api import Session
    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.launch import merge_cli
    from repro_torch.store.iostats import measure

    ws = os.path.join(root, "merge")
    spec_path = os.path.join(root, "service-spec.json")
    with open(spec_path, "w") as f:
        json.dump(SERVICE_SPEC, f)
    seen = {}

    class RecordingSession(Session):
        """The CLI's Session, keeping run_all's results and I/O bytes."""

        def run_all(self, **kw):
            before = self.stats.snapshot()
            with measure(self.stats) as io:
                seen["results"] = super().run_all(**kw)
            seen["io"] = dict(io, analyze=analyze_bytes(self.stats, before))
            return seen["results"]

    argv = ["--workspace", ws, "--spec", spec_path,
            "--block-size", str(block_size), "--shared-budget", "60%",
            "--cache-max-bytes", "4GiB", "--device", str(device)]
    cli_session = merge_cli.Session
    merge_cli.Session = RecordingSession
    # the service path: launch counts start at 0 here and are read after
    mb.reset_launches()
    t0 = time.perf_counter()
    try:
        with ties_routes() as ties_seen:
            merge_cli.main(argv)
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        merge_cli.Session = cli_session
    wall = time.perf_counter() - t0
    launches = dict(mb.LAUNCHES)
    # AVG and TA (the nested job), DARE, ANALYZE of the child snapshot;
    # TIES by the routes ties_route names
    for name in ("linear_merge", "dare_merge", "sketch_blocks"):
        if launches[name] == 0:
            raise AssertionError(f"service: {name} never launched")
    routes = check_ties_routes(ties_seen, launches, "service")
    if not ties_seen:
        raise AssertionError("service: no TIES kernel launched")
    results = seen["results"]
    jobs = {}
    mp = MergePipe(ws, block_size=block_size, device=device)
    for res in results:
        rec = mp.explain(res.sid)
        run, hat, budget = (rec["c_expert_run"], rec["c_expert_hat"],
                            rec["budget_b"])
        if run > hat or (budget >= 0 and hat > budget):
            raise AssertionError(f"service {res.sid}: run {run}, hat {hat}, "
                                 f"budget {budget}")
        if not mp.verify(res.sid):
            raise AssertionError(f"service {res.sid}: snapshot does not verify")
        jobs[res.sid] = {"op": rec["op"], "c_expert_run": run,
                         "c_expert_hat": hat, "budget_b": budget}
    mp.close()
    if len(jobs) != len(SERVICE_SPEC["jobs"]):
        raise AssertionError(f"service: {len(jobs)} jobs committed")
    # the first level's shared window: its planned union below the
    # per-job sum, and the expert bytes read in all below the jobs' hats
    batch = results[0].stats["batch"]
    per_job = sum(j["c_expert_hat"] for j in jobs.values())
    if not (batch["c_expert_hat_union"] < batch["c_expert_hat_sum"]
            and seen["io"]["expert_read"] < per_job):
        raise AssertionError(f"service: no sharing: {batch}, "
                             f"{seen['io']['expert_read']} of {per_job}")
    emit({"phase": "service", "argv": argv[2:], "wall_s": wall, "jobs": jobs,
          "window": {k: batch[k] for k in (
              "jobs", "c_expert_hat_union", "c_expert_hat_sum",
              "sharing_factor", "shared_budget_b", "pool_respected")},
          "io": seen["io"], "per_job_expert_hat_sum": per_job,
          "launches": launches, "ties_routes": routes})
    return launches


def tail_ulps(sess, sid, ref_sid, w):
    """bf16 ulps between two snapshots of ``sess``, with the tail block
    of each tensor that a W-element block grid leaves ragged apart: the
    most ulps anywhere and outside those tail blocks, the elements that
    differ in all and in the ragged tensors, and the TIES tail-block
    bound sum(min(W, size)) over the ragged tensors
    (tests/test_distributed.py).  Tensors with equal content hashes are
    equal bytes and are not read."""
    import numpy as np

    out = {"max_ulp": 0, "max_ulp_outside_tails": 0, "elements_differ": 0,
           "ragged_elements_differ": 0, "ragged_bound": 0,
           "tensors_differ": 0}
    hashes = snapshot_hashes(sess, sid)
    ref_hashes = snapshot_hashes(sess, ref_sid)
    if set(hashes) != set(ref_hashes):
        raise AssertionError(f"{sid}: tensors differ from {ref_sid}'s")
    models = sess.snapshots.models
    with models.open_model(sid) as got, models.open_model(ref_sid) as want:
        for t, (_h, shape, _dt) in sorted(ref_hashes.items()):
            size = int(np.prod(shape))
            if size % w:
                out["ragged_bound"] += min(w, size)
            if hashes[t] == ref_hashes[t]:
                continue
            out["tensors_differ"] += 1
            ulps = bf16_ulps(got.read_tensor(t, "other").reshape(-1),
                             want.read_tensor(t, "other").reshape(-1))
            head = size - size % w
            out["max_ulp"] = max(out["max_ulp"], int(ulps.max()))
            if head:
                out["max_ulp_outside_tails"] = max(
                    out["max_ulp_outside_tails"], int(ulps[:head].max()))
            out["elements_differ"] += int(np.count_nonzero(ulps))
            if size % w:
                out["ragged_elements_differ"] += int(np.count_nonzero(ulps))
    return out


def phase_shards(root, device, block_size, merged):
    """Shard workers on the merge workspace: SHARDS["pipelined"] through
    Session.run_all(n_workers=2) (process transport, kernel "torch" on
    the card) against the merge phase's local snapshots; a TIES window
    whose shard 1 is killed mid-region and re-issued; whole-shard
    ("mesh") merges; one inline TIES window under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import MergeSpec, Session
    from repro_torch.core.plan import MergePlan
    from repro_torch.dist import DistOptions, partition_plan, transport
    from repro_torch.kernels import merge_block as mb
    from repro_torch.store.iostats import measure

    n, k = SHARDS["workers"], len(EXPERTS)
    wants = {"avg": ("linear_merge",), "ta": ("linear_merge",),
             "dare": ("dare_merge",), "ties": ("ties_fused", "ties_merge")}
    io_keys = ("base_read", "expert_read", "out_written")
    out = {"phase": "shards", "workers": n, "pipelined": {},
           "whole_shard": {}}
    worker_launches = collections.Counter()
    # each worker process's launch time and exit, as the coordinator sees
    # them (the result docs carry the workers' own clocks)
    launched_at, exits = {}, []
    real_launch = transport.LocalProcessTransport.launch
    real_poll = transport._ProcessHandle.poll

    def launch(self, workspace, lease, ctl_dir):
        launched_at[lease.shard, lease.attempt] = time.time()
        return real_launch(self, workspace, lease, ctl_dir)

    def poll(self):
        ex = real_poll(self)
        if ex is not None:
            exits.append({"shard": ex.shard, "attempt": ex.attempt,
                          "ok": ex.ok, "crashed": ex.crashed,
                          "exit_code": self.proc.returncode})
        return ex

    def shard_run(sid, op, dist):
        """One sharded window of ``op`` at 50%: result, bytes, walls."""
        h = sess.submit(MergeSpec.build("base", EXPERTS, op=op,
                                        theta=dict(OPS)[op], budget="50%"),
                        sid=sid)
        t0 = time.time()
        with measure(sess.stats) as io:
            sess.run_all(dist=dist)
            if device.type == "cuda":
                torch.cuda.synchronize()
        t_end = time.time()
        res = h.result
        shards = res.stats["shards"]
        for sh in shards:
            if not sh["device"].startswith(device.type):
                raise AssertionError(f"shards {sid}: worker {sh['shard']} "
                                     f"ran on {sh['device']}")
            if not any(sh["launches"].get(name, 0) for name in wants[op]):
                raise AssertionError(f"shards {sid}: worker {sh['shard']} "
                                     f"launched none of {wants[op]}: "
                                     f"{sh['launches']}")
            if dist.transport == "process":
                worker_launches.update(sh["launches"])
        last_end = max(sh["started_at"] + sh["seconds"] for sh in shards)
        walls = {"wall_s": t_end - t0,
                 "shard_walls_s": [sh["seconds"] for sh in shards],
                 # after the last worker's end: splice, commit, lineage
                 "splice_s": t_end - last_end}
        if dist.transport == "process":
            # the coordinator's launch to the worker's first staged block
            walls["worker_start_s"] = [
                sh["first_block_at"] - launched_at[sh["shard"], sh["attempts"]]
                for sh in shards]
        return res, {c: io[c] for c in io_keys}, walls

    transport.LocalProcessTransport.launch = launch
    transport._ProcessHandle.poll = poll
    # the shards path: launch counts start at 0 here and are read at its
    # end (in this process: the inline window; the workers' own counts
    # come back in their result docs)
    mb.reset_launches()
    t_phase = time.perf_counter()
    sess = Session(os.path.join(root, "merge"), block_size=block_size,
                   device=device)
    try:
        # 1. pipelined workers, SHARDS["pipelined"], against the local merge
        for op in SHARDS["pipelined"]:
            sid = f"shards-{op}"
            res, io, walls = shard_run(sid, op, DistOptions(n_workers=n))
            local = merged[op]
            if snapshot_hashes(sess, sid) != snapshot_hashes(sess,
                                                             local["sid"]):
                raise AssertionError(f"shards {op}: differs from the local "
                                     f"merge {local['sid']}")
            if io != local["io"]:
                raise AssertionError(f"shards {op}: bytes {io}, local "
                                     f"{local['io']}")
            total = res.stats["partition"]["total_expert_bytes"]
            cap = -(-total // n) + k * block_size
            realized = [sh["realized_expert_bytes"]
                        for sh in res.stats["shards"]]
            if max(realized) > cap or sum(realized) != res.stats[
                    "c_expert_run"]:
                raise AssertionError(f"shards {op}: worker bytes {realized}, "
                                     f"cap {cap}")
            out["pipelined"][op] = {
                **walls, "io": io, "worker_expert_bytes": realized,
                "cap": cap, "c_expert_hat": res.stats["c_expert_hat"],
                "partition": res.stats["partition"]["shards"],
                "worker_launches": [sh["launches"]
                                    for sh in res.stats["shards"]]}
            if op == "ties":
                plan = MergePlan.from_payload(sess.catalog.get_plan(
                    res.manifest["plan_id"])["payload"])
            drop_snapshots(sess, sid)

        # 2. shard 1 killed mid-region (exit 3), re-issued, resumed
        part = partition_plan(plan, sess.catalog, n)
        skip = int(part.shards[1].n_blocks * SHARDS["crash_at"])
        mark, before = len(exits), sess.stats.snapshot()
        res, io, walls = shard_run("shards-ties-crash", "ties", DistOptions(
            n_workers=n, chaos={"point": "worker:block", "skip": skip,
                                "shard": 1}))
        dead = [e for e in exits[mark:] if not e["ok"]]
        sh1 = next(sh for sh in res.stats["shards"] if sh["shard"] == 1)
        if not (len(dead) == 1 and dead[0]["shard"] == 1
                and dead[0]["attempt"] == 1 and dead[0]["exit_code"] == 3
                and res.stats["reissued"] == 1 and sh1["attempts"] == 2
                and sh1["resumed_blocks"] > 0):
            raise AssertionError(f"shards crash: exits {exits[mark:]}, "
                                 f"shard 1 {sh1}")
        if snapshot_hashes(sess, "shards-ties-crash") != snapshot_hashes(
                sess, merged["ties"]["sid"]):
            raise AssertionError("shards crash: differs from the local merge")
        # the dead process's counters die with it: its journaled prefix,
        # which the successor skips, is the least it read
        skipped = (sess.stats.snapshot()["skipped"].get("expert", {}).get(
            "bytes", 0) - before["skipped"].get("expert", {}).get("bytes", 0))
        hat = res.stats["c_expert_hat"]
        spend = res.stats["c_expert_run"] + skipped
        if not hat <= spend < 2 * hat:
            raise AssertionError(f"shards crash: spend {spend} outside "
                                 f"[{hat}, {2 * hat})")
        out["crash"] = {**walls, "skip_blocks": skip,
                        "shard_blocks": part.shards[1].n_blocks,
                        "exits": exits[mark:],
                        "resumed_blocks": sh1["resumed_blocks"],
                        "c_expert_run": res.stats["c_expert_run"],
                        "skipped_expert_bytes": skipped, "spend": spend,
                        "c_expert_hat": hat}
        drop_snapshots(sess, "shards-ties-crash")

        # 3. whole-shard merges (kernel "mesh"), within one bf16 ulp of
        # the local merge but for TIES's tail blocks
        w = block_size // 2
        for op in SHARDS["whole_shard"]:
            sid = f"shards-{op}-mesh"
            res, io, walls = shard_run(sid, op, DistOptions(n_workers=n,
                                                            kernel="mesh"))
            diff = tail_ulps(sess, sid, merged[op]["sid"], w)
            if (diff["max_ulp_outside_tails"] > 1
                    or (op == "ties" and diff["ragged_elements_differ"]
                        > diff["ragged_bound"])
                    or (op != "ties" and diff["max_ulp"] > 1)):
                raise AssertionError(f"shards mesh {op}: {diff}")
            if any(io[c] != merged[op]["io"][c]
                   for c in ("base_read", "expert_read")):
                raise AssertionError(f"shards mesh {op}: bytes {io}, local "
                                     f"{merged[op]['io']}")
            out["whole_shard"][op] = {
                **walls, "io": io, **diff,
                "worker_launches": [sh["launches"]
                                    for sh in res.stats["shards"]]}
            drop_snapshots(sess, sid)

        # 4. one inline TIES window in this process, under the profiler
        activities = [ProfilerActivity.CUDA if device.type == "cuda"
                      else ProfilerActivity.CPU]
        before = dict(mb.LAUNCHES)
        with profile(activities=activities) as prof:
            res, io, walls = shard_run(
                "shards-ties-inline", "ties",
                DistOptions(n_workers=n, transport="inline"))
        device_ms = device_time_ms(prof)
        launches = {name: mb.LAUNCHES[name] - before[name]
                    for name in mb.LAUNCHES}
        ties_ms = {name: t for name, t in device_ms.items()
                   if re.search(r"\bties_(fused_|threshold_\w*)?kernel\b",
                                name)}
        if not ties_ms or not (launches["ties_fused"]
                               + launches["ties_merge"]):
            raise AssertionError(f"shards inline: no TIES kernel in the "
                                 f"profile ({launches})")
        if snapshot_hashes(sess, "shards-ties-inline") != snapshot_hashes(
                sess, merged["ties"]["sid"]):
            raise AssertionError("shards inline: differs from the local merge")
        busy = sum(device_ms.values())
        out["inline"] = {**walls, "io": io, "launches": launches,
                         "kernel_ms": ties_ms, "device_busy_ms": busy,
                         "device_idle_share": 1 - busy / 1e3 / walls["wall_s"],
                         "device_top_ms": dict(sorted(
                             device_ms.items(), key=lambda kv: -kv[1])[:6])}
        drop_snapshots(sess, "shards-ties-inline")
    finally:
        transport.LocalProcessTransport.launch = real_launch
        transport._ProcessHandle.poll = real_poll
        sess.close()
    out["launches"] = dict(mb.LAUNCHES)
    out["worker_launches"] = dict(worker_launches)
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out["launches"], out["worker_launches"]


@contextlib.contextmanager
def plain_attention():
    """Route the model's flash attention to its plain version (on the
    card too), for the kernel-against-plain serve and train parity: the
    forward and, by autograd through it, the backward."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    kernel = attention.flash_attention
    attention.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        attention.flash_attention = kernel


def phase_serve(device, seed, layers, merged):
    """Serve the merged TIES snapshot through the port's ServeEngine."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import from_jax_flat
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = qwen2_config(layers)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1,
                           size=SERVE["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = SERVE["new_tokens"]

    def engine_and_requests(model):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        return ServeEngine(model, batch_slots=SERVE["batch_slots"],
                           max_len=SERVE["max_len"]), reqs

    def run(model):
        engine, reqs = engine_and_requests(model)
        engine.run(reqs)
        if not all(r.done and len(r.out_tokens) == new for r in reqs):
            raise AssertionError("serve: a request did not finish")
        return engine, reqs

    # parity: float32 compute on the merged bf16 weights, kernel vs plain
    t0 = time.perf_counter()
    m32 = from_jax_flat(dataclasses.replace(cfg, compute_dtype="float32"),
                        merged, device=device)
    load_s = time.perf_counter() - t0
    worst = 0.0
    for p in prompts:
        toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
        with torch.inference_mode():
            lk = m32.prefill(toks)[0]
            with plain_attention():
                lp = m32.prefill(toks)[0]
        worst = max(worst, float((lk - lp).abs().max()))
        if not torch.isfinite(lk).all() or not torch.allclose(lk, lp,
                                                              **LOGIT_TOL):
            raise AssertionError(f"serve parity: prefill logits differ by "
                                 f"{worst} at prompt length {len(p)}")
    _, k_reqs = run(m32)
    with plain_attention():
        _, p_reqs = run(m32)
    same = [a.out_tokens == b.out_tokens for a, b in zip(k_reqs, p_reqs)]
    if not all(same):
        raise AssertionError(f"serve parity: greedy tokens differ for "
                             f"requests {[i for i, s in enumerate(same) if not s]}")
    del m32

    model = from_jax_flat(cfg, merged, device=device)
    run(model)  # warm-up: bf16 GEMM and kernel first launches

    # the main path: the launch count starts at 0 here and is read after
    engine, reqs = engine_and_requests(model)
    fa.reset_launches()
    rates = timed_serve(engine, reqs)
    wall = rates["wall_s"]
    launches = fa.LAUNCHES["flash_attention"]
    if launches == 0:
        raise AssertionError("serve: flash_attention never launched")
    tc_launches = fa.LAUNCHES["flash_attention_tc"]
    if tc_launches != launches:
        raise AssertionError(f"serve: {fa.LAUNCHES} — a bf16 prefill launch "
                             f"missed the tensor-core route")
    if not all(r.done and len(r.out_tokens) == new for r in reqs):
        raise AssertionError("serve: a request did not finish")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("serve: token out of the vocabulary")

    emit({
        "phase": "serve", "layers": layers, "requests": len(prompts),
        "prompt_lengths": [int(n) for n in lengths], "new_tokens": new,
        "batch_slots": SERVE["batch_slots"], "max_len": SERVE["max_len"],
        "load_s": load_s,
        "parity": {"compute_dtype": "float32", "max_logit_diff": worst,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True},
        **rates,
        "launches": {"flash_attention": launches,
                     "flash_attention_tc": tc_launches},
        **profiled_serve(lambda: run(model), wall, "serve"),
    })
    return {"flash_attention": launches}


def timed_serve(engine, reqs):
    """Run ``reqs`` through ``engine`` with each prefill and decode step
    timed on the host clock (each ends in a host sync: sampling): the
    wall, prefill tokens/s and ms per decode step."""
    import torch

    timing = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
              "decode_steps": 0, "decode_tokens": 0}
    prefill_slot, step = engine._prefill_slot, engine.step

    def timed_prefill(slot, req):
        t = time.perf_counter()
        n = prefill_slot(slot, req)
        timing["prefill_s"] += time.perf_counter() - t
        timing["prefill_tokens"] += len(req.prompt)
        return n

    def timed_step():
        active = sum(r is not None for r in engine._slot_req)
        t = time.perf_counter()
        step()
        timing["decode_s"] += time.perf_counter() - t
        timing["decode_steps"] += active > 0
        timing["decode_tokens"] += active

    engine._prefill_slot, engine.step = timed_prefill, timed_step
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    return {
        "wall_s": time.perf_counter() - t0, **timing,
        "prefill_tokens_per_s": timing["prefill_tokens"] / timing["prefill_s"],
        "decode_tokens_per_s": timing["decode_tokens"] / timing["decode_s"],
        "ms_per_decode_step": timing["decode_s"] / timing["decode_steps"] * 1e3,
    }


def profiled_serve(run, wall, what, flash=True):
    """``run()`` again under the profiler (device activity only, as in
    ``merge``): device time by activity, the flash kernel's, and the idle
    share against the timed run's ``wall``, which the profiler does not
    stretch.  With ``flash`` the prefill must show a tensor-core kernel
    (the one-warpgroup kernel up to hd 128, the warp-specialised one past
    it) and no FMA one (bf16); without (an attention-free model) no flash
    kernel at all.  Either way the card must have done work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    device_ms = device_time_ms(prof)
    kernel_ms = sum(t for n, t in device_ms.items()
                    if re.search(r"\bflash_attention_(tc|ws)_kernel\b", n))
    fma_ms = sum(t for n, t in device_ms.items()
                 if re.search(r"\bflash_attention_kernel\b", n))
    if (kernel_ms == 0) == flash or fma_ms != 0:
        raise AssertionError(f"{what}: profile shows {kernel_ms} ms of the "
                             f"tensor-core kernel, {fma_ms} ms of the FMA one")
    busy = sum(device_ms.values())
    if busy == 0:
        raise AssertionError(f"{what}: the profile shows no device work")
    return {"profiled_wall_s": prof_wall, "flash_kernel_ms": kernel_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / 1e3 / wall,
            "device_top_ms": dict(sorted(device_ms.items(),
                                         key=lambda kv: -kv[1])[:8])}


@contextlib.contextmanager
def compute_in(model, dtype: str):
    """The model computing in ``dtype`` on its own weights (an engine made
    inside reads the config too): the serve_mla phase's float32 parity
    on the bf16 weights, without a second copy of them."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    try:
        yield model
    finally:
        model.cfg = cfg


@contextlib.contextmanager
def moe_drops():
    """Count the MoE's token-expert pairs and the dropped ones (past an
    expert's capacity) of every prefill dispatch, as device sums."""
    from repro_torch.models import moe

    dispatch = moe.dispatch
    seen = {"pairs": 0, "dropped": None}

    def counting(x, idx, n_experts, cap):
        buf, state = dispatch(x, idx, n_experts, cap)
        if x.shape[1] > 1:                   # prefill: a whole prompt
            keep = state[2]
            seen["pairs"] += keep.numel()
            dropped = (~keep).sum()
            seen["dropped"] = (dropped if seen["dropped"] is None
                               else seen["dropped"] + dropped)
        return buf, state

    moe.dispatch = counting
    try:
        yield seen
    finally:
        moe.dispatch = dispatch


@contextlib.contextmanager
def moe_routing(replay=None):
    """Record every MoE routing's expert choices (``replay`` None), or
    replay the choices a recording holds, call by call: the replaying
    pass computes its own router softmax and top-k, counts the tokens
    whose experts it would have chosen otherwise (flips: near-ties of the
    k-th and (k+1)-th probability that float32 rounding tips), and takes
    the recorded experts with its own weights for them.  The MoE's top-k
    is discontinuous: one flip moves a token's output by a whole expert,
    so a kernel-against-plain comparison replays the kernel pass's
    choices to compare what attention computes."""
    import torch

    from repro_torch.models import moe

    route = moe.route
    state = {"calls": [], "flips": 0}
    calls = iter(replay["calls"]) if replay is not None else None

    def recording(x, router, k):
        w, idx = route(x, router, k)
        state["calls"].append(idx)
        return w, idx

    def replaying(x, router, k):
        want = next(calls)
        probs = torch.softmax(torch.einsum("...td,de->...te", x.float(),
                                           router.float()), dim=-1)
        own = torch.topk(probs, k, dim=-1)[1]
        state["flips"] += int((torch.sort(own, -1)[0]
                               != torch.sort(want, -1)[0]).any(-1).sum())
        w = torch.gather(probs, -1, want)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want

    moe.route = recording if replay is None else replaying
    try:
        yield state
    finally:
        moe.route = route


def phase_serve_mla(device, seed):
    """Serve DeepSeek-V2-Lite (MLA attention, qk 192 / v 128; MoE, 64
    experts top-6 + 2 shared) at its published widths, its bf16 weights
    drawn on the card from ``seed``, through build_model and ServeEngine:
    float32 compute against the plain attention (prefill logits, greedy
    tokens), then the bf16 run timed (its prefills on the tensor-core
    kernel at (192, 128): one launch a layer a request) and profiled."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=MLA["layers"], param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rng = np.random.default_rng(seed + 21)
    lengths = rng.integers(MLA["min_prompt"], MLA["max_prompt"] + 1,
                           size=MLA["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = MLA["new_tokens"]

    def run(model):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        engine = ServeEngine(model, batch_slots=MLA["batch_slots"],
                             max_len=MLA["max_len"])
        return engine, reqs

    def finished(reqs):
        if not all(r.done and len(r.out_tokens) == new for r in reqs):
            raise AssertionError("serve_mla: a request did not finish")
        if any(not 0 <= t < cfg.vocab_size for r in reqs
               for t in r.out_tokens):
            raise AssertionError("serve_mla: token out of the vocabulary")
        return reqs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 21)
    model = build_model(cfg, device=device, generator=g)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # parity: float32 compute on the bf16 weights, the kernels (the FMA
    # route) against the plain attention, the plain pass replaying the
    # kernel pass's expert choices (moe_routing: the flips it would have
    # made, and its logits without the replay, are reported); the engine
    # run through the kernels is this phase's float32 serving, counted
    # for the FMA row
    worst, unpinned, flips = 0.0, 0.0, 0
    t0 = time.perf_counter()
    with compute_in(model, "float32"), torch.inference_mode():
        for p in prompts:
            toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
            with moe_routing() as rec:
                lk = model.prefill(toks)[0]
            with plain_attention():
                with moe_routing(rec) as rep:
                    lp = model.prefill(toks)[0]
                unpinned = max(unpinned, float(
                    (model.prefill(toks)[0] - lk).abs().max()))
            flips += rep["flips"]
            worst = max(worst, float((lk - lp).abs().max()))
            if not torch.isfinite(lk).all() or not torch.allclose(
                    lk, lp, **LOGIT_TOL):
                raise AssertionError(f"serve_mla parity: prefill logits "
                                     f"differ by {worst} at prompt length "
                                     f"{len(p)}")
        engine, k_reqs = run(model)
        fa.reset_launches()
        with moe_routing() as rec:
            engine.run(k_reqs)
        fma_launches = (fa.LAUNCHES["flash_attention"]
                        - fa.LAUNCHES["flash_attention_tc"])
        if fma_launches != len(prompts) * cfg.n_layers:
            raise AssertionError(f"serve_mla float32: {fa.LAUNCHES}")
        with plain_attention(), moe_routing(rec) as rep:
            engine, p_reqs = run(model)
            engine.run(p_reqs)
        engine_flips = rep["flips"]
    parity_s = time.perf_counter() - t0
    same = [a.out_tokens == b.out_tokens
            for a, b in zip(finished(k_reqs), finished(p_reqs))]
    if not all(same):
        raise AssertionError(f"serve_mla parity: greedy tokens differ for "
                             f"requests {[i for i, s in enumerate(same) if not s]}")

    # warm-up (bf16 GEMMs, the kernel's first launch), counting the MoE's
    # dropped pairs at prefill
    t0 = time.perf_counter()
    with moe_drops() as drops:
        engine, reqs = run(model)
        engine.run(reqs)
        dropped = int(drops["dropped"])
    finished(reqs)
    warmup_s = time.perf_counter() - t0

    # the main path: the launch count starts at 0 here and is read after
    engine, reqs = run(model)
    fa.reset_launches()
    rates = timed_serve(engine, reqs)
    launches = dict(fa.LAUNCHES)
    finished(reqs)
    if not (launches["flash_attention_tc"] == launches["flash_attention"]
            == len(prompts) * cfg.n_layers):
        raise AssertionError(f"serve_mla: {launches}, want one tensor-core "
                             f"launch a layer a request")

    def again():
        engine, reqs = run(model)
        engine.run(reqs)
        finished(reqs)

    out = {
        "phase": "serve_mla", "config": cfg.name, "layers": cfg.n_layers,
        "params": n_params, "param_bytes": 2 * n_params,
        "head_dims": {"qk": cfg.nope_head_dim + cfg.rope_head_dim,
                      "v": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank},
        "experts": {"routed": cfg.n_experts, "top_k": cfg.experts_per_token,
                    "shared": cfg.n_shared_experts, "d_ff": cfg.moe_d_ff},
        "requests": len(prompts), "prompt_lengths": [int(n) for n in lengths],
        "new_tokens": new, "batch_slots": MLA["batch_slots"],
        "max_len": MLA["max_len"], "load_s": load_s, "parity_s": parity_s,
        "warmup_s": warmup_s,
        "parity": {"compute_dtype": "float32", "max_logit_diff": worst,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True,
                   "fma_launches": fma_launches,
                   "routing": "the plain pass replays the kernel pass's "
                              "expert choices",
                   "prefill_routing_flips": flips,
                   "engine_routing_flips": engine_flips,
                   "max_logit_diff_without_replay": unpinned},
        "moe_prefill_pairs": drops["pairs"], "moe_prefill_dropped": dropped,
        "moe_prefill_dropped_share": dropped / drops["pairs"],
        **rates,
        "launches": {"flash_attention": launches["flash_attention"],
                     "flash_attention_tc": launches["flash_attention_tc"]},
        **profiled_serve(again, rates["wall_s"], "serve_mla"),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    del model, engine
    torch.cuda.empty_cache()
    return {"flash_attention_mla": launches["flash_attention_tc"],
            "flash_attention_mla_fma": fma_launches}


@contextlib.contextmanager
def calls_by_shape(module, name, key):
    """Count the calls of ``module.<name>`` that run inside (callers reach
    it through the module) by ``key(*args, **kwargs)``: the RG-LRU scan's
    shapes (``scan_shape``), the chunked SSD's (``ssd_shape``), the flash
    attention's (``attention_shape``)."""
    fn = getattr(module, name)
    shapes = collections.Counter()

    def recording(*args, **kwargs):
        shapes[key(*args, **kwargs)] += 1
        return fn(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield shapes
    finally:
        setattr(module, name, fn)


def scan_shape(a, b, h0=None):
    return tuple(a.shape)


def ssd_shape(xh, la, Bm, Cm, chunk, s0=None):
    """(xh's (B, T, H, P), N, chunk)."""
    return tuple(xh.shape), Bm.shape[-1], chunk


def attention_shape(q, k, v, causal=True, **kw):
    """(B, Sq, Sk, H, Hkv, hd, hdv, causal), the order of FA_CASES'
    shapes."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], v.shape[3], causal)


def scan_device_ms(shapes, device):
    """Device time (torch.profiler, all of its kernels) of the RG-LRU scans
    ``shapes`` counts, each replayed as often on float32 inputs of its
    shape, in one profiled window: the scan's part of a served run, which
    its plain tensor ops leave nameless in the run's own profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rglru

    inputs = [(torch.rand(shape, device=device) * 0.9 + 0.05,
               torch.randn(shape, device=device), n)
              for shape, n in shapes.items()]
    for a, b, _ in inputs:
        rglru.rglru_scan(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a, b, n in inputs:
            for _ in range(n):
                rglru.rglru_scan(a, b)
        torch.cuda.synchronize()
    return sum(device_time_ms(prof).values())


def phase_serve_griffin(device, seed):
    """Serve RecurrentGemma-9B (RG-LRU and local attention at qk / v 256,
    16 query heads over one kv head, window 2,048) at its published widths,
    its bf16 weights drawn on the card from ``seed``, through build_model
    and ServeEngine: float32 compute against the plain attention (prefill
    logits, greedy tokens; the FMA kernel at (256, 256)), then the bf16
    run timed (its prefills on the tensor-core kernel: one launch an
    attention layer a request) and profiled, with the RG-LRU scan's share
    of the device time."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, rglru
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=GRIFFIN["layers"],
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    n_super = cfg.n_layers // 3
    rng = np.random.default_rng(seed + 22)
    lengths = [GRIFFIN["long_prompt"], *rng.integers(
        GRIFFIN["min_prompt"], GRIFFIN["max_prompt"] + 1,
        size=GRIFFIN["requests"] - 1)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = GRIFFIN["new_tokens"]
    want_launches = len(prompts) * n_super

    def run(model):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        engine = ServeEngine(model, batch_slots=GRIFFIN["batch_slots"],
                             max_len=GRIFFIN["max_len"])
        return engine, reqs

    def finished(reqs):
        if not all(r.done and len(r.out_tokens) == new for r in reqs):
            raise AssertionError("serve_griffin: a request did not finish")
        if any(not 0 <= t < cfg.vocab_size for r in reqs
               for t in r.out_tokens):
            raise AssertionError("serve_griffin: token out of the "
                                 "vocabulary")
        return reqs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 22)
    model = build_model(cfg, device=device, generator=g)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # parity: float32 compute on the bf16 weights, the kernels (the FMA
    # route at (256, 256)) against the plain attention; the engine run
    # through the kernels is this phase's float32 serving, counted for
    # the FMA row
    worst = 0.0
    t0 = time.perf_counter()
    with compute_in(model, "float32"), torch.inference_mode():
        for p in prompts:
            toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
            lk = model.prefill(toks)[0]
            with plain_attention():
                lp = model.prefill(toks)[0]
            worst = max(worst, float((lk - lp).abs().max()))
            if not torch.isfinite(lk).all() or not torch.allclose(
                    lk, lp, **LOGIT_TOL):
                raise AssertionError(f"serve_griffin parity: prefill logits "
                                     f"differ by {worst} at prompt length "
                                     f"{len(p)}")
        engine, k_reqs = run(model)
        fa.reset_launches()
        engine.run(k_reqs)
        fma_launches = (fa.LAUNCHES["flash_attention"]
                        - fa.LAUNCHES["flash_attention_tc"])
        if fma_launches != want_launches or fa.LAUNCHES["flash_attention_tc"]:
            raise AssertionError(f"serve_griffin float32: {fa.LAUNCHES}, want "
                                 f"{want_launches} FMA launches")
        with plain_attention():
            engine, p_reqs = run(model)
            engine.run(p_reqs)
    parity_s = time.perf_counter() - t0
    same = [a.out_tokens == b.out_tokens
            for a, b in zip(finished(k_reqs), finished(p_reqs))]
    if not all(same):
        raise AssertionError(f"serve_griffin parity: greedy tokens differ for "
                             f"requests {[i for i, s in enumerate(same) if not s]}")

    # warm-up (bf16 GEMMs, the kernel's first launch)
    t0 = time.perf_counter()
    engine, reqs = run(model)
    engine.run(reqs)
    finished(reqs)
    warmup_s = time.perf_counter() - t0

    # the main path: the launch count starts at 0 here and is read after
    engine, reqs = run(model)
    fa.reset_launches()
    rates = timed_serve(engine, reqs)
    launches = dict(fa.LAUNCHES)
    finished(reqs)
    if not (launches["flash_attention_tc"] == launches["flash_attention"]
            == want_launches):
        raise AssertionError(f"serve_griffin: {launches}, want one "
                             f"tensor-core launch an attention layer a "
                             f"request ({want_launches})")

    def again():
        engine, reqs = run(model)
        engine.run(reqs)
        finished(reqs)

    with calls_by_shape(rglru, "rglru_scan", scan_shape) as scans:
        profiled = profiled_serve(again, rates["wall_s"], "serve_griffin")
    scan_ms = scan_device_ms(scans, device)
    out = {
        "phase": "serve_griffin", "config": cfg.name,
        "layers": cfg.n_layers,
        "layer_pattern": {"super_blocks": n_super, "rest_recurrent":
                          cfg.n_layers % 3},
        "params": n_params, "param_bytes": 2 * n_params,
        "head_dims": {"qk": cfg.resolved_head_dim,
                      "v": cfg.resolved_head_dim},
        "heads": {"q": cfg.n_heads, "kv": cfg.n_kv_heads},
        "local_window": cfg.local_window, "rglru_width": cfg.rglru_width,
        "requests": len(prompts), "prompt_lengths": [int(n) for n in lengths],
        "new_tokens": new, "batch_slots": GRIFFIN["batch_slots"],
        "max_len": GRIFFIN["max_len"], "load_s": load_s,
        "parity_s": parity_s, "warmup_s": warmup_s,
        "parity": {"compute_dtype": "float32", "max_logit_diff": worst,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True,
                   "fma_launches": fma_launches},
        **rates,
        "launches": {"flash_attention": launches["flash_attention"],
                     "flash_attention_tc": launches["flash_attention_tc"]},
        **profiled,
        "rglru_scan": {"calls": sum(scans.values()),
                       "shapes": {"x".join(map(str, k)): n
                                  for k, n in scans.items()},
                       "device_ms": scan_ms,
                       "device_share": scan_ms / profiled["device_busy_ms"]},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    del model, engine
    torch.cuda.empty_cache()
    return {"flash_attention_rg": launches["flash_attention_tc"],
            "flash_attention_rg_fma": fma_launches}


def draw_zero_leaves(model, g):
    """Redraw, in place, the parameters that start at zero and would hide
    a layer's terms: the norms (DRAWN_NORMS, 0.2 * N(0, 1) under the 1 + w
    convention) and the cross-attention's tanh gates (uniform in [0.5,
    1]: tanh(0) = 0 hides the whole cross-attention at init)."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.split(".")[-1]
            if leaf == "gate":
                p.copy_(torch.rand(p.shape, generator=g, device=p.device)
                        * 0.5 + 0.5)
            elif leaf in DRAWN_NORMS:
                p.copy_(0.2 * torch.randn(p.shape, generator=g,
                                          device=p.device))


def ssd_device_ms(shapes, device, reps=2):
    """Device time (torch.profiler, all of its kernels) of the chunked
    SSDs ``shapes`` counts: each shape replayed ``reps`` times on float32
    inputs of its shape (log-decay in [-1, -0.01]) in one profiled window,
    its mean time a call times its count.  The SSD's part of a served
    run, which its plain tensor ops leave nameless in the run's own
    profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    total = 0.0
    for ((b, t, h, p), n, chunk), count in shapes.items():
        args = (torch.randn((b, t, h, p), device=device),
                -torch.rand((b, t, h), device=device) * 0.99 - 0.01,
                torch.randn((b, t, n), device=device),
                torch.randn((b, t, n), device=device), chunk)
        ssm.ssd_chunked(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ssm.ssd_chunked(*args)
            torch.cuda.synchronize()
        total += sum(device_time_ms(prof).values()) / reps * count
    return total


def phase_serve_mamba(device, seed):
    """Serve Mamba-2 2.7B (attention-free: the chunked SSD at prefill, its
    O(1) recurrence at decode) at its published widths and depth, its bf16
    weights drawn on the card from ``seed``, through build_model and
    ServeEngine.  First, on the bf16 weights: the float32 engine's greedy
    tokens against the argmax of ``forward`` over each extended sequence,
    and in float64 compute each request's prefill plus decode steps
    (teacher-forced on those tokens) against that forward's logits (float32
    rounding through 64 layers exceeds LOGIT_TOL; its share is reported);
    then the bf16 run timed and profiled, with the SSD's share of the
    device time."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, ssm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    if MAMBA["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=MAMBA["layers"])
    rng = np.random.default_rng(seed + 26)
    lengths = rng.integers(MAMBA["min_prompt"], MAMBA["max_prompt"] + 1,
                           size=MAMBA["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = MAMBA["new_tokens"]

    def run(model, prompts=prompts):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        engine = ServeEngine(model, batch_slots=MAMBA["batch_slots"],
                             max_len=MAMBA["max_len"])
        engine.run(reqs)
        if not all(r.done and len(r.out_tokens) == new for r in reqs):
            raise AssertionError("serve_mamba: a request did not finish")
        if any(not 0 <= t < cfg.vocab_size for r in reqs
               for t in r.out_tokens):
            raise AssertionError("serve_mamba: token out of the vocabulary")
        return reqs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 26)
    model = build_model(cfg, device=device, generator=g)
    draw_zero_leaves(model, g)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # parity on the bf16 weights.  float32 compute: the engine's greedy
    # tokens against the argmax of the chunked forward over each extended
    # sequence.  float64 compute: the chunked prefill plus the recurrent
    # decode steps (teacher-forced on those tokens) against that forward's
    # logits within LOGIT_TOL.  float32's own rounding through 64 layers
    # exceeds LOGIT_TOL (the float32 forward misses the float64 one by ~6x
    # the tolerance), so the float32 logits are reported against the
    # float64 forward, not held
    def teacher_forced(ext, n, toks):
        logits, cache = model.prefill(ext[:, :n])
        got = [logits[0, 0]]
        for t in toks[:-1]:
            logits, cache = model.decode_step(
                torch.tensor([[t]], device=device), cache)
            got.append(logits[0, 0])
        return torch.stack(got)

    def tol_used(diff, want):
        """The largest share of its LOGIT_TOL an element uses."""
        return float((diff / (LOGIT_TOL["atol"] + LOGIT_TOL["rtol"]
                              * want.abs())).max())

    t0 = time.perf_counter()
    f32 = {"forward_vs_float64": 0.0, "decode_vs_float64": 0.0,
           "decode_vs_forward": 0.0}
    worst = used = 0.0
    with torch.inference_mode():
        with compute_in(model, "float32"):
            reqs = run(model)
            exts, fwd32, dec32 = [], [], []
            for p, r in zip(prompts, reqs):
                ext = torch.as_tensor(np.concatenate([p, r.out_tokens[:-1]]),
                                      dtype=torch.long, device=device)[None]
                want = model(ext)[0, len(p) - 1:]        # (new, V)
                greedy = torch.argmax(want, dim=-1).tolist()
                if greedy != r.out_tokens:
                    raise AssertionError(f"serve_mamba parity: engine tokens "
                                         f"{r.out_tokens} against the "
                                         f"forward's greedy {greedy}")
                exts.append(ext)
                fwd32.append(want)
            # the float32 decode of the first request, for its report
            dec32 = teacher_forced(exts[0], len(prompts[0]),
                                   reqs[0].out_tokens)
        with compute_in(model, "float64"):
            for p, r, ext, a in zip(prompts, reqs, exts, fwd32):
                want = model(ext)[0, len(p) - 1:]
                got = teacher_forced(ext, len(p), r.out_tokens)
                diff = (got - want).abs()
                worst = max(worst, float(diff.max()))
                used = max(used, tol_used(diff, want))
                if not torch.isfinite(got).all() or not torch.allclose(
                        got, want, **LOGIT_TOL):
                    raise AssertionError(f"serve_mamba parity (float64): "
                                         f"prefill + decode logits differ "
                                         f"from the forward's by {worst} at "
                                         f"prompt length {len(p)}")
                pairs = [("forward_vs_float64", a, want)]
                if ext is exts[0]:
                    pairs += [("decode_vs_float64", dec32, want),
                              ("decode_vs_forward", dec32, a)]
                for key, x, w in pairs:
                    f32[key] = max(f32[key], tol_used((x.double() - w)
                                                      .abs(), w))
                del want, got, diff
    del exts, fwd32, dec32
    parity_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    run(model)  # warm-up: bf16 GEMMs
    warmup_s = time.perf_counter() - t0

    # the main path: no flash attention may launch (attention-free)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    engine = ServeEngine(model, batch_slots=MAMBA["batch_slots"],
                         max_len=MAMBA["max_len"])
    fa.reset_launches()
    rates = timed_serve(engine, reqs)
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"serve_mamba: {fa.LAUNCHES}")
    if not all(r.done and len(r.out_tokens) == new for r in reqs):
        raise AssertionError("serve_mamba: a request did not finish")

    # the profile: the first request alone (the profiler stretches its
    # thousands of small launches many times over), its idle share against
    # its own unprofiled wall
    def one():
        with torch.inference_mode():
            run(model, prompts[:1])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    with calls_by_shape(ssm, "ssd_chunked", ssd_shape) as ssds:
        profiled = profiled_serve(one, one_wall, "serve_mamba", flash=False)
    ssd_ms = ssd_device_ms(ssds, device)
    d_in = cfg.ssm_expand * cfg.d_model
    out = {
        "phase": "serve_mamba", "config": cfg.name, "layers": cfg.n_layers,
        "params": n_params, "param_bytes": 2 * n_params,
        "ssm": {"d_inner": d_in, "heads": d_in // cfg.ssm_head_dim,
                "head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
                "chunk": cfg.ssm_chunk, "conv": cfg.conv_kernel},
        "requests": len(prompts), "prompt_lengths": [int(n) for n in lengths],
        "new_tokens": new, "batch_slots": MAMBA["batch_slots"],
        "load_s": load_s, "parity_s": parity_s, "warmup_s": warmup_s,
        "parity": {"against": "the chunked forward over each extended "
                              "sequence",
                   "tokens": "float32 engine tokens equal its argmax",
                   "logits": "float64 prefill + decode within LOGIT_TOL",
                   "max_logit_diff": worst, "tolerance_used": used,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True,
                   "float32_tolerance_used": f32,
                   "float32_decode": "the first request"},
        **rates,
        "launches": {"flash_attention": 0},
        "profiled_request_wall_s": one_wall,
        **profiled,
        "ssd": {"calls": sum(ssds.values()),
                "shapes": {f"{'x'.join(map(str, k[0]))}/N{k[1]}/Q{k[2]}": n
                           for k, n in ssds.items()},
                "device_ms": ssd_ms,
                "device_share": ssd_ms / profiled["device_busy_ms"]},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    del model, engine
    torch.cuda.empty_cache()


def greedy_context(model, prompt, context, new):
    """One request through a context model's own entry points: prefill
    over ``prompt`` (1, S) with ``context`` (1, S_ctx, D), the cache
    copied into one of S + new positions, then ``new - 1`` greedy decode
    steps.  Returns (prefill logits (V,), the greedy tokens, prefill
    seconds, decode seconds), each time ending in a host sync."""
    import torch

    t0 = time.perf_counter()
    logits, small = model.prefill(prompt, context)
    first = int(torch.argmax(logits[0, 0]))
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = model.init_cache(1, prompt.shape[1] + new)
    for name in model.cache_batch_axes():
        part = small[name]
        cache[name][tuple(slice(0, n) for n in part.shape)] = part
    cache["len"] = small["len"]
    toks = [first]
    for _ in range(new - 1):
        step, cache = model.decode_step(
            torch.tensor([[toks[-1]]], device=prompt.device), cache)
        toks.append(int(torch.argmax(step[0, 0])))
    return logits[0, 0], toks, prefill_s, time.perf_counter() - t0


def serve_context(phase, model, prompts, contexts, new, want):
    """A context model (encoder-decoder, vision) served request by request
    through ``greedy_context``: float32 compute against the plain
    attention first (prefill logits within LOGIT_TOL, identical greedy
    tokens; the kernels on the FMA route), then bf16: a warm-up, the
    main path timed with every flash launch counted by shape (each on the
    tensor-core route; ``want`` the calls a request makes), and the first
    request once more, timed and then profiled.  Returns the phase's line (without its header) and the
    launch shapes of the main path."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    def serve_all():
        return [greedy_context(model, p, c, new)
                for p, c in zip(prompts, contexts)]

    worst, t0 = 0.0, time.perf_counter()
    with compute_in(model, "float32"), torch.inference_mode():
        fa.reset_launches()
        kern = serve_all()
        fma = dict(fa.LAUNCHES)
        with plain_attention():
            plain = serve_all()
    for (lk, tk, *_), (lp, tp, *_), p in zip(kern, plain, prompts):
        worst = max(worst, float((lk - lp).abs().max()))
        if not torch.isfinite(lk).all() or not torch.allclose(lk, lp,
                                                              **LOGIT_TOL):
            raise AssertionError(f"{phase} parity: prefill logits differ by "
                                 f"{worst} at prompt length {p.shape[1]}")
        if tk != tp:
            raise AssertionError(f"{phase} parity: greedy tokens {tk} "
                                 f"against the plain attention's {tp}")
    if (fma["flash_attention"] != want * len(prompts)
            or fma["flash_attention_tc"]):
        raise AssertionError(f"{phase} float32: {fma}, want "
                             f"{want * len(prompts)} FMA launches")
    parity_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with torch.inference_mode():
        serve_all()  # warm-up: bf16 GEMMs, the kernels' first launches
    warmup_s = time.perf_counter() - t0

    # the main path: the launch count starts at 0 here and is read after
    with torch.inference_mode(), calls_by_shape(
            attention, "flash_attention", attention_shape) as shapes:
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
    if not (launches["flash_attention_tc"] == launches["flash_attention"]
            == sum(shapes.values()) == want * len(prompts)):
        raise AssertionError(f"{phase}: {launches}, {dict(shapes)}, want "
                             f"{want} tensor-core launches a request")
    tokens = [toks for _, toks, *_ in out]
    if any(len(t) != new or not all(0 <= x < model.cfg.vocab_size
                                    for x in t) for t in tokens):
        raise AssertionError(f"{phase}: bad tokens {tokens}")
    prefill_s = sum(o[2] for o in out)
    decode_s = sum(o[3] for o in out)

    # the profile: the first request again (the profiler stretches a run
    # of thousands of small launches many times over), its idle share
    # against its own unprofiled wall
    def again():
        with torch.inference_mode():
            greedy_context(model, prompts[0], contexts[0], new)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0

    line = {
        "requests": len(prompts),
        "prompt_lengths": [int(p.shape[1]) for p in prompts],
        "context_tokens": int(contexts[0].shape[1]), "new_tokens": new,
        "parity_s": parity_s, "warmup_s": warmup_s,
        "parity": {"compute_dtype": "float32", "max_logit_diff": worst,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True,
                   "fma_launches": fma["flash_attention"]},
        "wall_s": wall, "prefill_s": prefill_s,
        "prefill_tokens": sum(int(p.shape[1]) for p in prompts),
        "prefill_ms_per_request": prefill_s / len(prompts) * 1e3,
        "decode_s": decode_s, "decode_steps": len(prompts) * (new - 1),
        "ms_per_decode_step": decode_s / (len(prompts) * (new - 1)) * 1e3,
        "launches": {"flash_attention": launches["flash_attention"],
                     "flash_attention_tc": launches["flash_attention_tc"],
                     "by_shape": {"x".join(map(str, k)): n
                                  for k, n in shapes.items()}},
        "profiled_request_wall_s": one_wall,
        **profiled_serve(again, one_wall, phase),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return line, shapes


def phase_serve_whisper(device, seed):
    """Serve whisper-tiny (the encoder–decoder: a non-causal encoder over
    1,500 stub frames, causal decoder self-attention, cross-attention with
    Sq != Sk, all at hd 64) at its published widths and depth, its bf16
    weights drawn on the card from ``seed`` with nonzero gates and norms,
    through its own prefill and decode_step (serve_context).  Returns the
    encoder's tensor-core launches at FA_CASES' whisper_encoder shape and
    the float32 run's FMA launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("whisper-tiny"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rng = np.random.default_rng(seed + 27)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            size=(1, WHISPER["prompt"])),
                               dtype=torch.long, device=device)
               for _ in range(WHISPER["requests"])]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 27)
    model = build_model(cfg, device=device, generator=g)
    draw_zero_leaves(model, g)
    frames = [torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g,
                          device=device) for _ in prompts]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want = attention_layers(cfg)   # the encoder's, and self + cross a layer
    line, shapes = serve_context("serve_whisper", model, prompts, frames,
                                 WHISPER["new_tokens"], want)
    enc = next(c for c in FA_CASES if c[0] == "whisper_encoder")
    enc_shape = enc[1] + (enc[3],)
    encoder = shapes[enc_shape]
    if encoder != len(prompts) * cfg.n_encoder_layers:
        raise AssertionError(f"serve_whisper: {dict(shapes)}, want "
                             f"{cfg.n_encoder_layers} encoder launches at "
                             f"{enc_shape} a request")
    emit({"phase": "serve_whisper", "config": cfg.name,
          "layers": {"encoder": cfg.n_encoder_layers,
                     "decoder": cfg.n_layers},
          "params": n_params, "param_bytes": 2 * n_params,
          "head_dim": cfg.resolved_head_dim,
          "heads": {"q": cfg.n_heads, "kv": cfg.n_kv_heads},
          "frames": cfg.encoder_seq, "load_s": load_s, **line,
          "encoder_frames_per_s": len(prompts) * cfg.encoder_seq
          / line["prefill_s"]})
    fma = line["parity"]["fma_launches"]
    del model
    torch.cuda.empty_cache()
    return {"flash_attention_whisper": encoder,
            "flash_attention_whisper_fma": fma}


def phase_serve_vlm(device, seed):
    """Serve llama-3.2-vision-90b (gated cross-attention over 1,024 stub
    vision tokens at hd 128, GQA 64 / 8) at its published widths, depth
    VLM["layers"] (one super-block), its bf16 weights drawn on the card
    from ``seed`` with nonzero gates and norms, through its own prefill and
    decode_step (serve_context).  Returns the cross-attention's
    tensor-core launches at FA_CASES' vlm_cross shape."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                              n_layers=VLM["layers"], param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rng = np.random.default_rng(seed + 28)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n)),
                               dtype=torch.long, device=device)
               for n in VLM["prompts"]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 28)
    model = build_model(cfg, device=device, generator=g)
    draw_zero_leaves(model, g)
    vision = [torch.randn((1, cfg.vision_tokens, cfg.d_model), generator=g,
                          device=device) for _ in prompts]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_super = cfg.n_layers // cfg.cross_attn_every
    line, shapes = serve_context("serve_vlm", model, prompts, vision,
                                 VLM["new_tokens"], cfg.n_layers + n_super)
    row = next(c for c in FA_CASES if c[0] == "vlm_cross")
    cross = shapes[row[1] + (row[3],)]
    if cross != n_super:
        raise AssertionError(f"serve_vlm: {dict(shapes)}, want {n_super} "
                             f"cross-attention launches at {row[1]}")
    emit({"phase": "serve_vlm", "config": cfg.name, "layers": cfg.n_layers,
          "super_blocks": n_super,
          "layer_pattern": "a gated cross-attention sub-layer, then "
                           f"{cfg.cross_attn_every} self layers, a block",
          "params": n_params, "param_bytes": 2 * n_params,
          "head_dim": cfg.resolved_head_dim,
          "heads": {"q": cfg.n_heads, "kv": cfg.n_kv_heads},
          "vision_tokens": cfg.vision_tokens, "load_s": load_s, **line,
          "prefill_tokens_per_s": line["prefill_tokens"]
          / line["prefill_s"]})
    del model
    torch.cuda.empty_cache()
    return {"flash_attention_vlm_cross": cross}


def attention_layers(cfg):
    """The attention calls of one forward: one a layer, but for a hybrid
    the non-recurrent entries of its block pattern (Griffin: one in
    three), none for an attention-free model (Mamba-2), and for an
    encoder-decoder the encoder's layers and two a decoder layer (self and
    cross)."""
    if cfg.attention_free:
        return 0
    if cfg.encoder_decoder:
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    if not cfg.block_pattern:
        return cfg.n_layers
    pat = cfg.block_pattern
    return sum(pat[i % len(pat)] != "rec" for i in range(cfg.n_layers))


def attention_pairs(cfg, seq):
    """Live (query, key) pairs a head of one forward over ``seq`` tokens,
    summed over its attention calls: causal (or windowed) self-attention
    a layer; an encoder-decoder's encoder over its frames (no mask), and
    a decoder layer's causal self-attention and cross-attention over
    the frames."""
    pairs = seq * (seq + 1) // 2 if cfg.local_window == 0 else sum(
        min(i + 1, cfg.local_window) for i in range(seq))
    if cfg.encoder_decoder:
        frames = cfg.encoder_seq
        return (cfg.n_encoder_layers * frames * frames
                + cfg.n_layers * (pairs + seq * frames))
    return pairs * attention_layers(cfg)


def attention_head_dims(cfg):
    """(hd, hdv): q.k's head dim and v's (MLA: nope + rope, and v)."""
    if cfg.mla:
        return cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def active_params(cfg, params):
    """The parameters a token multiplies by: all of them, but of an MoE's
    routed experts only the top-k of n_experts (the shared ones always)."""
    n = sum(p.numel() for p in params.values())
    if cfg.moe:
        routed = sum(params[name].numel() for name in
                     ("ffn/w_gate", "ffn/w_up", "ffn/w_down"))
        n -= routed * (cfg.n_experts - cfg.experts_per_token) // cfg.n_experts
    return n


def train_flops(cfg, n_params, n_layer_params, batch, seq, n_encoder=0):
    """FLOPs of one training step: the model's (6·N·tokens over the active
    parameters ``n_params``, an encoder's ``n_encoder`` of them over its
    frames instead, plus attention's 2·(hd + hdv) FLOP per live pair and
    head forward and 2·(3·hd + 2·hdv) backward, over the attention calls)
    and remat's recomputed layer forward (2·N_layers·tokens + attention's
    forward).  Mamba-2's SSD contractions (float32, outside the
    parameter count) are not counted."""
    tokens = batch * seq
    frames = batch * cfg.encoder_seq if n_encoder else 0
    hd, hdv = attention_head_dims(cfg)
    per_pair = attention_pairs(cfg, seq) * batch * cfg.n_heads
    fwd = 2 * (hd + hdv) * per_pair
    model = (6 * (n_params - n_encoder) * tokens + 6 * n_encoder * frames
             + fwd + 2 * (3 * hd + 2 * hdv) * per_pair)
    remat = (2 * (n_layer_params - n_encoder) * tokens
             + 2 * n_encoder * frames + fwd) if cfg.remat else 0
    return model, remat


def grad_sample(model, names):
    import torch

    from repro_torch.train.train_state import model_params

    params = model_params(model)
    out = {n: params[n].grad.detach().clone() for n in names}
    for p in params.values():
        p.grad = None
    return out


def phase_train(device, seed, spec=TRAIN, phase="train"):
    """Train ``spec["config"]`` at its published widths (``spec["layers"]``
    deep, or all its layers) for a few steps through make_train_step: the
    flash forward and backward kernels on every attention layer, remat
    on.  First the first step's loss and ``spec["grad_sample"]`` through
    the kernels against the same step through the plain attention (an
    MoE's plain pass replaying the kernel pass's expert choices, forward
    and remat's recompute in the same order, its flips counted), then
    warm-up and timed steps with their launch counts, then one step under
    the profiler.  Returns the launch counts, with the tensor-core
    backward's also under ``spec["counter"]`` where the spec names one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import merge_block as mb
    from repro_torch.models import build_model
    from repro_torch.train.data import DataPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step, model_params)

    cfg = get_config(spec["config"])
    published = cfg.n_layers
    if spec.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    attn = attention_layers(cfg)
    batch_n, seq = spec["batch"], spec["seq"]
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(model, g)
    if spec.get("draw"):  # nonzero gates and norms (in place: the params)
        draw_zero_leaves(model, g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model_params(model)
    n_params = sum(p.numel() for p in params.values())
    n_active = active_params(cfg, params)
    n_layer = n_active - model.embed["embedding"].numel() - model.ln_f.numel()
    n_encoder = sum(p.numel() for n, p in params.items()
                    if n.startswith("enc_"))
    steps = spec["warmup"] + spec["steps"]
    # an encoder-decoder's stub frontend output, the same every batch
    extra = ({spec["context"]: torch.randn(
        (batch_n, cfg.encoder_seq, cfg.d_model), generator=g,
        device=device)} if spec.get("context") else None)
    pipe = DataPipeline(cfg.vocab_size, batch=batch_n, seq=seq, seed=seed,
                        extra=extra, device=device)

    def routing(replay=None):
        return (moe_routing(replay) if cfg.moe
                else contextlib.nullcontext())

    try:
        # the first step's loss and gradients: kernels, then plain (an
        # MoE's plain pass replays the kernel pass's expert choices, call
        # by call: the forward's, then remat's recompute in the backward)
        t0 = time.perf_counter()
        batch0 = next(pipe)
        with routing() as rec:
            loss_k = model.loss_fn(batch0)
            loss_k.backward()
        loss_k = float(loss_k.detach())
        grads_k = grad_sample(model, spec["grad_sample"])
        finite = {n: bool(torch.isfinite(t).all()) for n, t in grads_k.items()}
        if not np.isfinite(loss_k) or not all(finite.values()):
            raise AssertionError(f"{phase}: loss {loss_k}, finite gradients "
                                 f"{finite}")
        # an attention-free model has no kernel to hold against the plain
        # attention: its first step is held to finite values alone
        loss_p, rel = None, {}
        if attn:
            with plain_attention(), routing(rec) as rep:
                loss_p = model.loss_fn(batch0)
                loss_p.backward()
            loss_p = float(loss_p.detach())
            grads_p = grad_sample(model, spec["grad_sample"])
            rel = {n: float((grads_k[n] - grads_p[n]).norm()
                            / grads_p[n].norm().clamp(min=1e-30))
                   for n in spec["grad_sample"]}
            del grads_p
        del grads_k, rec
        parity_s = time.perf_counter() - t0
        if attn and (abs(loss_k - loss_p) >
                     TRAIN_TOL["loss_rtol"] * abs(loss_p)
                     or max(rel.values()) > TRAIN_TOL["grad_rel_l2"]):
            raise AssertionError(f"{phase} parity: loss {loss_k} vs plain "
                                 f"{loss_p}, gradient errors {rel}")

        opt = AdamWConfig(lr=spec["lr"], warmup_steps=1, total_steps=steps)
        step_fn = make_train_step(model, opt)
        # the main path: the launch counts start at 0 here, read after
        fa.reset_launches()
        mb.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        walls, losses = [], []
        for _ in range(steps):
            batch = next(pipe)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            losses.append(float(metrics["loss"]))
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device)
        # one more step under the profiler: device time by kernel
        batch = next(pipe)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    finally:
        pipe.close()
    # the backward's route for the model's compute dtype and head dims:
    # the tensor cores for bf16 (where the kernels phase's route gate held)
    hd, hdv = attention_head_dims(cfg)
    bwd_plan = (fa.backward_plan(batch_n, seq, seq, cfg.n_heads,
                                 cfg.n_kv_heads, hd,
                                 getattr(torch, cfg.compute_dtype), hdv=hdv)
                if attn else {"route": None, "kernels": []})
    per = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
           "flash_attention_bwd_tc":
               attn if bwd_plan["route"] == "tc" else 0}
    for name, n in per.items():  # remat: forward and its recompute
        if launches[name] != n * steps:
            raise AssertionError(f"{phase}: {launches} over {steps} steps, "
                                 f"want {n} {name} launches a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    device_ms = device_time_ms(prof)

    def kernel_time(pattern):
        return sum(t for n, t in device_ms.items() if re.search(pattern, n))

    busy = sum(device_ms.values())
    step_s = statistics.median(walls[spec["warmup"]:])
    tokens = batch_n * seq
    model_flops, remat_flops = train_flops(cfg, n_active, n_layer, batch_n,
                                           seq, n_encoder)
    emit({
        "phase": phase, "config": cfg.name, "layers": cfg.n_layers,
        "published_layers": published, "attention_layers": attn,
        "head_dims": [hd, hdv], "params": n_params,
        "active_params": n_active, "param_dtype": cfg.param_dtype,
        "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
        "batch": batch_n, "seq": seq, "window": cfg.local_window,
        "init_s": init_s, "parity_s": parity_s,
        "frames": cfg.encoder_seq if extra else None,
        "parity": {"loss": loss_k, "loss_plain": loss_p,
                   "grad_rel_l2": rel, "grads_finite": finite,
                   "tolerance": TRAIN_TOL if attn else None,
                   **({"routing": "the plain pass replays the kernel "
                                  "pass's expert choices",
                       "routing_flips": rep["flips"]} if cfg.moe else {})},
        "step_walls_s": walls, "losses": losses,
        "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "model_flops": model_flops, "remat_flops": remat_flops,
        "mfu": model_flops / step_s / PEAK["bf16"],
        "hfu": (model_flops + remat_flops) / step_s / PEAK["bf16"],
        "peak_memory_gb": peak / 1e9, "launches": launches,
        "backward_route": bwd_plan["route"],
        "profiled_step_s": prof_wall, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / 1e3 / prof_wall,
        "flash_forward_ms": kernel_time(r"flash_attention(_tc|_ws)?_kernel"),
        "flash_backward_ms": kernel_time(r"fa_bwd_\w+_kernel"),
        "flash_backward_by_kernel_ms": {
            n: kernel_time(n) for n, _ in bwd_plan["kernels"]},
        "gemm_ms": kernel_time(r"gemm|xmma|cutlass|nvjet"),
        "device_top_ms": dict(sorted(device_ms.items(),
                                     key=lambda kv: -kv[1])[:12]),
    })
    del model, state, step_fn, batch, batch0, params
    torch.cuda.empty_cache()
    if spec.get("counter"):
        launches[spec["counter"]] = launches["flash_attention_bwd_tc"]
    return launches


def phase_mesh(device, seed):
    """Train MESH's configs twice each, meshless (as phase_train does) and
    through launch/train.py's ``build_on_mesh`` under ``make_debug_mesh()``
    (the (1, 1) mesh over the card, in a one-rank NCCL group) and
    ``train_rules``, from the same seed's weights and the same batches:
    equal losses (bit-equal where MESH says so, else within TRAIN_TOL's
    loss_rtol), equal and non-zero tensor-core flash forward and backward
    launches (nothing falls back to the plain attention under DTensor),
    step ms both ways, and the card's peak memory beside the dry-run's
    accounting of the same step on the same mesh (meta tensors).
    Returns the mesh runs' launches under the kernels line's counters."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh
    from repro_torch.launch.train import build_on_mesh
    from repro_torch.models import build_model, shardctx
    from repro_torch.train.data import DataPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)

    counted = collections.Counter()
    opened = ensure_process_group("cuda")
    try:
        mesh = make_debug_mesh(device_type="cuda")
        rules = shardctx.train_rules(False)
        for spec in MESH:
            cfg = dataclasses.replace(get_config(spec["config"]),
                                      n_layers=spec["layers"])
            opt = AdamWConfig(lr=spec["lr"], warmup_steps=1,
                              total_steps=spec["steps"])
            runs = {}
            for way in ("meshless", "mesh"):
                t0 = time.perf_counter()
                scope = (shardctx.use_mesh(mesh, rules) if way == "mesh"
                         else contextlib.nullcontext())
                with scope:
                    if way == "mesh":
                        model, step_fn, state = build_on_mesh(
                            cfg, device, mesh, rules, opt, seed)
                    else:
                        model = build_model(cfg, device=device)
                        state = init_train_state(model, torch.Generator(
                            device=device).manual_seed(seed))
                        step_fn = make_train_step(model, opt)
                    torch.cuda.synchronize()
                    init_s = time.perf_counter() - t0
                    pipe = DataPipeline(cfg.vocab_size, batch=spec["batch"],
                                        seq=spec["seq"], seed=seed,
                                        device=device)
                    # the main path: the launch counts start at 0 here
                    fa.reset_launches()
                    torch.cuda.reset_peak_memory_stats(device)
                    walls, losses = [], []
                    try:
                        for _ in range(spec["steps"]):
                            batch = next(pipe)
                            torch.cuda.synchronize()
                            t = time.perf_counter()
                            state, metrics = step_fn(state, batch)
                            torch.cuda.synchronize()
                            walls.append(time.perf_counter() - t)
                            losses.append(float(metrics["loss"]))
                    finally:
                        pipe.close()
                    runs[way] = {
                        "init_s": init_s, "step_walls_s": walls,
                        "median_step_ms": 1e3 * statistics.median(
                            walls[1:]),
                        "losses": losses, "launches": dict(fa.LAUNCHES),
                        "peak_memory_bytes":
                            torch.cuda.max_memory_allocated(device),
                        "batch": type(batch["tokens"]).__name__,
                        "params": type(next(model.parameters())).__name__,
                    }
                    del model, state, step_fn, batch, metrics
                    torch.cuda.empty_cache()
            a, b = runs["meshless"], runs["mesh"]
            if (b["batch"], b["params"]) != ("DTensor", "DTensor") or (
                    a["batch"], a["params"]) != ("Tensor", "Parameter"):
                raise AssertionError(f"mesh: {spec['config']} ran "
                                     f"meshless {a['batch']} / {a['params']}"
                                     f", meshed {b['batch']} / "
                                     f"{b['params']}")
            if spec["exact"]:
                equal = a["losses"] == b["losses"]
            else:
                equal = all(abs(x - y) <= TRAIN_TOL["loss_rtol"] * abs(x)
                            for x, y in zip(a["losses"], b["losses"]))
            if not equal or not all(np.isfinite(a["losses"])):
                raise AssertionError(f"mesh: {spec['config']} losses "
                                     f"{b['losses']} under the mesh, "
                                     f"{a['losses']} meshless")
            for name in ("flash_attention_tc", "flash_attention_bwd_tc"):
                if not a["launches"][name] == b["launches"][name] > 0:
                    raise AssertionError(
                        f"mesh: {spec['config']} {name} launches "
                        f"{b['launches'][name]} under the mesh, "
                        f"{a['launches'][name]} meshless")
            t0 = time.perf_counter()
            predicted = dryrun.train_memory(cfg, spec["batch"], spec["seq"],
                                            mesh, rules)
            predict_s = time.perf_counter() - t0
            if predicted["peak_bytes"] < (1 - MESH_MEMORY_SLACK) * b[
                    "peak_memory_bytes"]:
                raise AssertionError(f"mesh: {spec['config']} predicted "
                                     f"{predicted} under the card's peak "
                                     f"{b['peak_memory_bytes']}")
            for name, counter in spec["counters"].items():
                counted[counter] += b["launches"][name]
            emit({"phase": "mesh", "config": cfg.name, "layers": cfg.n_layers,
                  "published_layers": get_config(spec["config"]).n_layers,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "rules": "train_rules", "batch": spec["batch"],
                  "seq": spec["seq"], "steps": spec["steps"],
                  "losses": "bit-equal" if spec["exact"]
                            else f"within loss_rtol {TRAIN_TOL['loss_rtol']}",
                  "meshless": a, "mesh_run": b,
                  "step_ms_ratio": b["median_step_ms"] / a["median_step_ms"],
                  "predicted_memory": predicted,
                  "predicted_over_measured": predicted["peak_bytes"]
                  / b["peak_memory_bytes"], "predict_s": predict_s})
    finally:
        if opened:
            dist.destroy_process_group()
    return dict(counted)


def start_dryrun(out_dir):
    """Start the dryrun phase: one ``python -m repro_torch.launch.dryrun
    --both-meshes`` process at a time for each DRYRUN arch x shape, on the
    host only, in a thread; returns (future, stop) — stop() kills a
    running process."""
    from repro_torch.models import SHAPES

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []

    def run():
        t0 = time.perf_counter()
        records = []
        for arch in DRYRUN["archs"]:
            for shape in SHAPES:
                out = os.path.join(out_dir, f"{arch}.{shape}.jsonl")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--both-meshes",
                     "--out", out], cwd=HERE, env=env,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)
                procs.append(proc)
                _, err = proc.communicate(timeout=DRYRUN["timeout_s"])
                if proc.returncode:
                    raise AssertionError(f"dryrun {arch} {shape}: exit "
                                         f"{proc.returncode}: {err[-2000:]}")
                with open(out) as f:
                    records += [json.loads(line) for line in f]
        return records, time.perf_counter() - t0

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    ex = ThreadPoolExecutor(1)
    future = ex.submit(run)
    ex.shutdown(wait=False)
    return future, stop


def phase_dryrun(records, wall_s):
    """Hold the dry-run's records: every applicable cell ``ok`` on both
    production meshes, the others the reference's skip; one line."""
    from repro_torch.configs import get_config
    from repro_torch.models import SHAPES, shape_applicable

    cells = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    want = {(a, s, m) for a in DRYRUN["archs"] for s in SHAPES
            for m in ("16x16", "2x16x16")}
    if set(cells) != want:
        raise AssertionError(f"dryrun: cells {sorted(cells)}")
    bad = {k: r["status"] for k, r in cells.items()
           if r["status"] != (shape_applicable(get_config(k[0]), k[1])
                              or "ok")}
    if bad:
        raise AssertionError(f"dryrun: {bad}")
    emit({"phase": "dryrun", "wall_s": wall_s, "hardware": "host only "
          "(no card: meta tensors on a fake process group of 256 / 512 "
          "ranks)", "cells": [
              {k: r.get(k) for k in ("arch", "shape", "mesh", "status",
                                     "build_s", "step_s")}
              | ({"peak_gb": r["memory"]["peak_bytes"] / 1e9,
                  "flops": r["cost"]["flops"],
                  "collective_bytes": r["collectives"]["bytes_by_kind"],
                  "dominant_term": r["dominant_term"],
                  "useful_fraction": (r["model_flops"] or {}).get(
                      "useful_fraction")} if r["status"] == "ok" else {})
              for r in records]})


def phase_examples(device):
    """The ported quickstart and budget-sweep examples on the card and on
    the CPU (see the module doc); returns the card runs' merge-kernel
    launches, counted from 0 before each card run."""
    import io as _io

    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.launch import budget_sweep, quickstart

    out = {"phase": "examples", "examples": {}}
    launched = collections.Counter()
    for name, example in (("quickstart", quickstart),
                          ("budget_sweep", budget_sweep)):
        runs = {}
        for dev in ("cuda", "cpu"):
            mb.reset_launches()
            t = time.perf_counter()
            # the example's report stays off the smoke's JSON lines
            with ties_routes() as seen, contextlib.redirect_stdout(
                    _io.StringIO()):
                got = example.main(["--device", dev])
                if dev == "cuda":
                    torch.cuda.synchronize(device)
            runs[dev] = {"result": got, "wall_s": time.perf_counter() - t,
                         "launches": dict(mb.LAUNCHES), "seen": seen}
        card, cpu = runs["cuda"], runs["cpu"]
        a, b = card["result"], cpu["result"]
        if a["snapshots"] != b["snapshots"]:
            differ = sorted((s, t) for s in b["snapshots"]
                            for t in b["snapshots"][s]
                            if a["snapshots"].get(s, {}).get(t)
                            != b["snapshots"][s][t])
            raise AssertionError(f"examples {name}: card and CPU snapshots "
                                 f"differ at {differ}")
        io_card, io_cpu = a["iostats"], b["iostats"]
        for kind in sorted(set(io_card) | set(io_cpu)):
            for cat in sorted(set(io_card.get(kind, {}))
                              | set(io_cpu.get(kind, {}))):
                x = io_card.get(kind, {}).get(cat, 0)
                y = io_cpu.get(kind, {}).get(cat, 0)
                if x != y and not (cat == "meta" and abs(x - y) <= META_SLACK):
                    raise AssertionError(f"examples {name}: IOStats "
                                         f"{kind}/{cat}: card {x}, CPU {y}")
        if sum(cpu["launches"].values()):
            raise AssertionError(f"examples {name}: the CPU run launched "
                                 f"{cpu['launches']}")
        routes = check_ties_routes(card["seen"], card["launches"],
                                   f"examples {name}")
        if not card["seen"]:
            raise AssertionError(f"examples {name}: no TIES kernel launched")
        if name == "quickstart":
            if card["launches"]["dare_merge"] == 0:
                raise AssertionError("examples quickstart: the DARE "
                                     "sub-merge launched no DARE kernel")
            if not a["expert_read"] <= a["planned"] <= a["budget_b"]:
                raise AssertionError(f"examples quickstart: realized "
                                     f"{a['expert_read']}, planned "
                                     f"{a['planned']}, B {a['budget_b']}")
            summary = {k: a[k] for k in ("expert_read", "base_read",
                                         "out_written", "naive", "planned",
                                         "budget_b")}
        else:
            over = [r for r in a["rows"] if r["planned"] > r["budget_b"]]
            if over or not a["expert_mb"] < a["sequential_mb"]:
                raise AssertionError(f"examples budget_sweep: planned past "
                                     f"B at {over}; expert MB "
                                     f"{a['expert_mb']} of sequential "
                                     f"{a['sequential_mb']}")
            summary = {k: a[k] for k in ("rows", "expert_mb", "sequential_mb",
                                         "sharing_factor",
                                         "cached_block_reads")}
            summary["batch_wall_s"] = {"cuda": a["batch_wall_s"],
                                       "cpu": b["batch_wall_s"]}
        launched.update(card["launches"])
        out["examples"][name] = {
            **summary, "snapshots_bit_equal": len(a["snapshots"]),
            "iostats": io_card, "cpu_meta": {
                k: io_cpu[k]["meta"] for k in io_cpu if "meta" in io_cpu[k]},
            "wall_s": {"cuda": card["wall_s"], "cpu": cpu["wall_s"]},
            "launches": card["launches"], "ties_routes": routes}
    out["launches"] = dict(launched)
    emit(out)
    return out["launches"]


def start_lint():
    """Start the lint phase: ``python -m repro_torch.analysis --format
    json`` over this checkout, host only, in a thread; returns (future,
    stop) as start_dryrun does.  The future gives (the report, the exit
    code, the wall)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []

    def run():
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--format", "json",
             "--root", HERE], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        stdout, err = proc.communicate(timeout=LINT_TIMEOUT_S)
        if proc.returncode not in (0, 1):
            raise AssertionError(f"lint: exit {proc.returncode}: "
                                 f"{err[-2000:]}")
        return json.loads(stdout), proc.returncode, time.perf_counter() - t0

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    ex = ThreadPoolExecutor(1)
    future = ex.submit(run)
    ex.shutdown(wait=False)
    return future, stop


def phase_lint(doc, code, wall_s):
    """Hold the lint's report: exit 0 and no unwaived finding; one line
    with each pass's findings and waivers."""
    from repro_torch.analysis.runner import ALL_PASSES

    per_pass = {p: {"findings": 0, "waived": 0} for p in ALL_PASSES}
    for kind in ("findings", "waived"):
        for f in doc[kind]:
            per_pass.setdefault(f["pass"], {"findings": 0, "waived": 0})
            per_pass[f["pass"]][kind] += 1
    if code != 0 or doc["findings"]:
        raise AssertionError(f"lint: exit {code}, unwaived findings "
                             f"{doc['findings'][:8]}")
    emit({"phase": "lint", "wall_s": wall_s, "exit_code": code,
          "hardware": "host only (no card, no JAX)",
          "passes": per_pass,
          "findings": len(doc["findings"]), "waived": len(doc["waived"])})


def eval_loss(model, vocab, skill):
    """Mean loss over LOOP["eval_batches"] held-out batches of a skill."""
    import torch

    from repro_torch.train.data import synth_batch, to_device

    tot = 0.0
    with torch.no_grad():
        for s in range(LOOP["eval_batches"]):
            b = synth_batch(1234, s, LOOP["batch"], LOOP["seq"], vocab, skill)
            tot += float(model.loss_fn(to_device(b, model.device)))
    return tot / LOOP["eval_batches"]


def phase_loop(root, device, seed, layers, block_size):
    """Train two experts from one base with TrainLoop (checkpoints through
    a SnapshotStore), crash expert 0 and resume it bit for bit, then
    ANALYZE and TIES at 50% in the port's Session on the card, and serve
    the merge through ServeEngine."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import merge_block as mb
    from repro_torch.models import build_model, load_flat
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.store.checkpoint import flatten_tree, tree_leaves
    from repro_torch.store.snapshot import SnapshotStore
    from repro_torch.train.data import DataPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainLoop
    from repro_torch.train.train_state import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers)
    steps = LOOP["steps"]
    opt = AdamWConfig(lr=LOOP["lr"], warmup_steps=1, total_steps=steps)
    log = []
    out = {"phase": "loop", "config": cfg.name, "layers": layers,
           "batch": LOOP["batch"], "seq": LOOP["seq"], "steps": steps}
    # the loop's path: the launch counts start at 0 here, read at its end
    fa.reset_launches()
    mb.reset_launches()
    model = build_model(cfg, device=device)

    def fresh():
        """The base: every run starts from the same seeded draw."""
        return init_train_state(model, torch.Generator(device=device)
                                .manual_seed(seed))

    def pipe(skill, start=0):
        return DataPipeline(cfg.vocab_size, batch=LOOP["batch"],
                            seq=LOOP["seq"], seed=seed, skill=skill,
                            start_step=start, device=device)

    walls = {}

    def run(loop, state, skill, start=0, crash_at=None):
        p = pipe(skill, start)
        t = time.perf_counter()
        try:
            return loop.run(state, p, steps, start_step=start,
                            crash_at_step=crash_at)
        finally:
            p.close()
            torch.cuda.synchronize()
            walls.setdefault(loop.run_id, []).append(time.perf_counter() - t)

    def new_loop(run_id, ckpt_every):
        snaps = SnapshotStore(os.path.join(root, "loop-" + run_id))
        return TrainLoop(model, make_train_step(model, opt), snaps,
                         run_id=run_id, ckpt_every=ckpt_every,
                         log_fn=log.append)

    base = flatten_tree(fresh().params)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        # expert 0, crashed at a mid step and resumed from its checkpoint
        loop = new_loop("expert-0-crash", LOOP["ckpt_every"])
        try:
            run(loop, fresh(), 0, crash_at=LOOP["crash_at"])
            raise AssertionError("loop: the injected crash did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        state, start = loop.restore_or_init(fresh())
        state = run(loop, state, 0, start=start)
        resumed = {n: t.clone() for n, t in tree_leaves(state).items()}
        shutil.rmtree(loop.snapshots.workspace, ignore_errors=True)
        # expert 0 uninterrupted: the same state, bit for bit
        loop = new_loop("expert-0", steps)
        state = run(loop, fresh(), 0)
        final = tree_leaves(state)
        differ = [n for n in final if not torch.equal(final[n], resumed[n])]
        if differ or final.keys() != resumed.keys():
            raise AssertionError(f"loop: resumed expert 0 differs from the "
                                 f"uninterrupted run in {differ[:4]}")
        experts = [flatten_tree(state.params)]
        del resumed, final
        shutil.rmtree(loop.snapshots.workspace, ignore_errors=True)
        loop = new_loop("expert-1", steps)
        experts.append(flatten_tree(run(loop, fresh(), 1).params))
        shutil.rmtree(loop.snapshots.workspace, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    out["train_s"] = time.perf_counter() - t0
    # each TrainLoop.run: its steps and checkpoints (params, m and v)
    out["run_walls_s"] = walls
    out["crash"] = {"crash_at_step": LOOP["crash_at"], "resumed_from": start,
                    "bit_identical": True, "tensors": len(tree_leaves(state))}
    out["log"] = log

    t0 = time.perf_counter()
    with Session(os.path.join(root, "loop-ws"), block_size=block_size,
                 device=device) as sess:
        sess.register_model("base", base)
        ids = []
        for e, flat in enumerate(experts):
            ids.append(sess.register_model(f"skill-{e}", flat))
        sess.ensure_analyzed("base", ids)
        before = dict(mb.LAUNCHES)
        with (ties_routes() as seen,
              profile(activities=[ProfilerActivity.CUDA]) as prof):
            res = sess.run({"base": "base", "experts": ids, "op": "ties",
                            "theta": {"trim_frac": 0.3}, "budget": "50%"})
            torch.cuda.synchronize()
        routes = check_ties_routes(
            seen, {n: mb.LAUNCHES[n] - before[n] for n in mb.LAUNCHES}, "loop")
        if not sess.verify(res.sid):
            raise AssertionError("loop: the merged snapshot does not verify")
        merged = sess.load(res.sid)
    out["merge"] = {"sid": res.sid, "wall_s": time.perf_counter() - t0,
                    "c_expert_run": res.stats["c_expert_run"],
                    "c_expert_hat": res.stats["c_expert_hat"],
                    "ties_routes": routes, **ties_device_ms(prof),
                    "ties_shapes": launch_shapes([sh for _, sh in seen]),
                    "pair_shapes": launch_shapes([sh for r, sh in seen
                                                  if r == "pair"])
                    if routes["pair"] else None}

    # each model on each skill, as examples/train_and_merge.py prints
    losses = {}
    for name, flat in [("base", base), *zip(ids, experts), ("merged", merged)]:
        load_flat(model, flat)
        losses[name] = [eval_loss(model, cfg.vocab_size, k) for k in (0, 1)]
    if not np.all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"loop: losses {losses}")
    out["losses"] = losses
    for name, row in losses.items():
        print(f"[loop] {name:10s} " + " ".join(
            f"skill{k} {x:.4f}" for k, x in enumerate(row)), flush=True)

    # serve the merge (loaded in ``model`` last)
    rng = np.random.default_rng(seed + 3)
    lengths = rng.integers(LOOP["min_prompt"], LOOP["max_prompt"] + 1,
                           size=LOOP["requests"])
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=LOOP["new_tokens"])
            for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    ServeEngine(model, batch_slots=2, max_len=512).run(reqs)
    torch.cuda.synchronize()
    if not all(r.done and len(r.out_tokens) == LOOP["new_tokens"]
               and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
               for r in reqs):
        raise AssertionError("loop: a served request did not finish")
    out["serve"] = {"requests": len(reqs),
                    "prompt_lengths": [int(n) for n in lengths],
                    "wall_s": time.perf_counter() - t0}
    launches = {**fa.LAUNCHES, **mb.LAUNCHES}
    for name in ("flash_attention", "flash_attention_bwd", "sketch_blocks"):
        if launches[name] == 0:
            raise AssertionError(f"loop: {name} never launched")
    hd = cfg.resolved_head_dim
    if (fa._route(getattr(torch, cfg.compute_dtype), hd, hd) == "tc"
            and launches["flash_attention_bwd_tc"] == 0):
        raise AssertionError("loop: the tensor-core backward never launched")
    if launches["ties_fused"] + launches["ties_merge"] == 0:
        raise AssertionError("loop: no TIES kernel launched")
    out["launches"] = launches
    emit(out)
    del model
    torch.cuda.empty_cache()
    return launches


def loop_process(root, seed, layers, block_size):
    """phase_loop in a spawned process of its own (it runs beside the
    store phase): the card and the float settings as ``main`` sets them;
    returns the loop path's launches, counted in this process."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return phase_loop(root, torch.device("cuda", 0), seed, layers,
                      block_size)


# ------------------------------------------------------------------ store
def populate_store(sess, layers, k, seed, device):
    """Register base (``DecoderLM`` init) and k experts shaped like a
    fleet of partial fine-tunes: the embedding and the final norm
    byte-equal to the base, the decoder layers base + 0.02 * N(0, 1), and
    experts 0 and 1 sharing the tensors STORE["shared"] names byte for
    byte (branched from one checkpoint, fine-tuned apart elsewhere)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.store.checkpoint import flatten_tree

    g = torch.Generator(device=device).manual_seed(seed + 1)
    model = build_model(qwen2_config(layers), device=device, generator=g)
    base = flatten_tree(model)
    sess.register_model("base", base)
    params = {n.replace(".", "/"): p.detach()
              for n, p in model.state_dict(keep_vars=True).items()}
    ids, first = [], {}
    for e in range(k):
        ex = {}
        for n in base:
            if n in STORE["frozen"]:
                ex[n] = base[n]
            elif e == 1 and n.startswith(STORE["shared"]):
                ex[n] = first[n]
            else:
                ex[n] = (params[n].float() + 0.02 * torch.randn(
                    params[n].shape, generator=g, device=device)
                         ).to(torch.bfloat16)
        sess.register_model(f"expert-{e}", ex)
        if e == 0:
            first = ex
        ids.append(f"expert-{e}")
    del model, params, first
    return ids, {n: a.shape for n, a in base.items()}


def snapshot_hashes(sess, sid):
    """Each tensor's (content hash, shape, dtype) of a snapshot: equal
    hashes are equal bytes (blake2b over the whole tensor, re-validated
    at commit)."""
    with sess.snapshots.models.open_model(sid) as r:
        return {t: (r.spec(t)["hash"], tuple(r.spec(t)["shape"]),
                    r.spec(t)["dtype"]) for t in r.tensor_names()}


def drop_snapshots(sess, *sids):
    """Delete compared snapshots (their tensors and published manifests),
    so the workspace that fsck scrubs holds what the phase still reads."""
    for sid in sids:
        sess.snapshots.models.delete_model(sid, force=True)
        os.remove(os.path.join(sess.snapshots.manifest_root, f"{sid}.json"))


def store_repack(ws, block_size, ids):
    """Session.repack of the store phase's experts into its zlib layout,
    in a process of its own (it runs on the host while the flat merges
    run on the card); returns the repack report and its wall."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.api import Session
    from repro_torch.store.packed import RepackOptions

    with Session(ws, block_size=block_size, device="cpu",
                 recover=False) as sess:
        t = time.perf_counter()
        rep = sess.repack(ids, "base", layout_id=STORE["layout"],
                          options=RepackOptions(compress="zlib"))
        return rep, time.perf_counter() - t


def store_stream_reference(ws, block_size, plan_id, sid):
    """The numpy stream engine on one plan of the store phase's
    workspace, in a process of its own: its bytes by category and wall
    (the store phase runs the four operators' references at once)."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.api import Session
    from repro_torch.core.executor import execute_merge
    from repro_torch.core.plan import MergePlan
    from repro_torch.store.iostats import measure

    # no recovery pass: the other references' journals are in flight
    with Session(ws, block_size=block_size, device="cpu",
                 recover=False) as sess:
        plan = MergePlan.from_payload(
            sess.catalog.get_plan(plan_id)["payload"])
        t = time.perf_counter()
        with measure(sess.stats) as io:
            execute_merge(plan, sess.snapshots, sess.catalog, sid=sid,
                          txn=sess.txn, compute="stream", device="cpu")
        return {c: io[c] for c in STORE_IO}, time.perf_counter() - t


def phase_store(root, device, seed, block_size):
    """Packed layouts, the tiered / remote store and mergefsck on the
    merge path's widths at STORE["layers"] layers: repack, merges from
    the layout at full budget against flat reads and at half and a tight
    budget against the numpy stream engine, a tier-billed merge over a
    partly warm tier within its plan, a cold, warm and tier-billed
    merge from a remote bucket (the tight ones against the stream
    engine), then fsck finding and repairing a corrupt packed extent and
    a corrupt cache extent."""
    import io as _io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import MergeSpec, Session
    from repro_torch.core.plan import MergePlan
    from repro_torch.core.planner import plan_merge
    from repro_torch.kernels import merge_block as mb
    from repro_torch.launch import merge_cli
    from repro_torch.store.iostats import measure
    from repro_torch.testing.chaos import inject_corruption

    layers, layout = STORE["layers"], STORE["layout"]
    spawn = multiprocessing.get_context("spawn")
    ws = os.path.join(root, "store")
    bucket = os.path.join(root, "store-bucket")
    activities = [ProfilerActivity.CUDA if device.type == "cuda"
                  else ProfilerActivity.CPU]
    out = {"phase": "store", "layers": layers, "k": STORE["k"],
           "block_size": block_size, "frozen": list(STORE["frozen"]),
           "shared": list(STORE["shared"]), "merges": {}}
    # the store path: the launch counts start at 0 here, read at its end
    mb.reset_launches()
    t_phase = time.perf_counter()
    sess = Session(ws, block_size=block_size, device=device)
    t0 = time.perf_counter()
    ids, shapes = populate_store(sess, layers, STORE["k"], seed, device)
    out["register_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.ensure_analyzed("base", ids)
    out["analyze_s"] = time.perf_counter() - t0
    with sess.snapshots.models.open_model("base") as r:
        out["model_bytes"] = sum(r.spec(t)["nbytes"] for t in shapes)

    def spec(op, budget):
        return MergeSpec.build("base", ids, op=op, theta=dict(OPS)[op],
                               budget=budget, reuse_plan=False)

    def run(label, jobs, want_layout, **run_kw):
        """Run ``jobs`` ({sid: (op, budget)}) as one Session batch on the
        card under the profiler: wall, bytes, launches (every merge
        kernel of the batch's operators in the profile, each TIES launch
        on the route ties_route names), budget soundness of each job,
        device busy time and idle share."""
        handles = {sid: sess.submit(spec(op, b), sid=sid)
                   for sid, (op, b) in jobs.items()}
        before = dict(mb.LAUNCHES)
        t = time.perf_counter()
        with (measure(sess.stats) as io, profile(activities=activities) as prof,
              ties_routes() as seen):
            sess.run_all(**run_kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {n: mb.LAUNCHES[n] - before[n] for n in mb.LAUNCHES}
        device_ms = device_time_ms(prof)
        ops = {op for op, _b in jobs.values()}
        wants = {"avg": r"\blinear_kernel\b", "ta": r"\blinear_kernel\b",
                 "dare": r"\bdare_kernel\b",
                 "ties": r"\bties_(fused_|threshold_\w*)?kernel\b"}
        missing = [op for op in ops
                   if not any(re.search(wants[op], n) for n in device_ms)]
        if missing:
            raise AssertionError(f"store {label}: no merge kernel of "
                                 f"{missing} in the profile ({launches})")
        routes = check_ties_routes(seen, launches, f"store {label}")
        if "ties" in ops and not seen:
            raise AssertionError(f"store {label}: no TIES kernel launched")
        results = {}
        for sid, h in handles.items():
            res = h.result
            rec = sess.explain(res.sid)
            if rec["layout_id"] != want_layout:
                raise AssertionError(f"store {label} {sid}: read layout "
                                     f"{rec['layout_id']}, not {want_layout}")
            r_, hat, b = (res.stats["c_expert_run"],
                          res.stats["c_expert_hat"], rec["budget_b"])
            # read-repair (a quarantined extent read from its flat
            # source) is the one traffic a plan cannot price: the
            # executor's slack
            repair = res.stats.get("verify", {}).get("repair_bytes", 0)
            if r_ > hat + repair or (b >= 0 and hat > b):
                raise AssertionError(f"store {label} {sid}: run {r_}, hat "
                                     f"{hat}, budget {b}")
            results[sid] = res
            out["merges"].setdefault(label, {"jobs": {}})["jobs"][sid] = {
                "c_expert_run": r_, "c_expert_hat": hat, "budget_b": b,
                "repair_bytes": repair}
        busy = sum(device_ms.values())
        out["merges"][label].update({
            "wall_s": wall, "io": {c: io[c] for c in STORE_IO},
            "launches": {n: v for n, v in launches.items() if v},
            "ties_routes": routes, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / 1e3 / wall})
        return results, io

    def same(sid_a, sid_b, what):
        a = snapshot_hashes(sess, sid_a)
        b = sid_b if isinstance(sid_b, dict) else snapshot_hashes(sess, sid_b)
        if a != b or set(a) != set(shapes):
            differ = sorted(t for t in a if a[t] != b.get(t))
            raise AssertionError(f"store {what}: {sid_a} differs from its "
                                 f"reference in {differ[:4]}")

    def plan_of(res):
        return MergePlan.from_payload(sess.catalog.get_plan(
            res.manifest["plan_id"])["payload"])

    def hold_to_stream(sid, io, ref, what):
        """A merge against the numpy stream engine on its plan: the same
        bytes, and the same bytes moved by category."""
        io_s, _wall = ref
        same(sid, f"{sid}-stream", what)
        if any(io[c] != io_s[c] for c in STORE_IO):
            raise AssertionError(f"store {what}: bytes differ from the "
                                 f"stream engine: {dict(io)} / {io_s}")
        drop_snapshots(sess, f"{sid}-stream")

    def selected(plan):
        return {(e, t, b) for e, per_t in plan.selection.items()
                for t, bs in per_t.items() for b in bs}

    opnames = [op for op, _ in OPS]
    tight = STORE["tight"]
    # the repack, then the stream references of the tight plans (and of a
    # half-budget plan that selects other blocks than the full-budget
    # flat one), each started as soon as its merge has run
    with ProcessPoolExecutor(2 * len(opnames), mp_context=spawn) as pool:
        # 1. repack: a lossless zlib layout of the experts, on the host,
        # while the flat full-budget merges of step 2 run on the card
        repacking = pool.submit(store_repack, ws, block_size, ids)
        # 2. full budget: every operator from the flat checkpoints (one
        # batch; its shared-read cache holds every expert block, so each
        # is read once for the four jobs)
        full_flat = run("full-flat", {f"full-{op}-flat": (op, "100%")
                                      for op in opnames},
                        None, prefer_packed=False,
                        cache_max_bytes=STORE["cache_bytes"])[0]
        rep, repack_s = repacking.result()
        out["repack"] = {k: rep[k] for k in (
            "layout_id", "lossless", "extents", "elided_blocks",
            "dedup_blocks", "logical_bytes", "physical_bytes")}
        out["repack"]["wall_s"] = repack_s
        if not (rep["lossless"] and rep["elided_blocks"]
                and rep["dedup_blocks"]
                and rep["physical_bytes"] < rep["logical_bytes"]):
            raise AssertionError(f"store: repack elided or deduped "
                                 f"nothing: {rep}")
        # 3. half budget and a tight one (below the layout's physical
        # bytes, so selection binds), costed at physical bytes (the
        # auto-preferred layout): each merge on the card, then the numpy
        # stream engine on the same plan in a worker process while the
        # card runs the next merges.  A half-budget plan that selects the
        # full-budget flat plan's blocks (at this layout: every block) is
        # held to that merge's snapshot instead, which step 2 already
        # holds to the layout's merge
        plans, ios, refs = {}, {}, {}
        t = time.perf_counter()
        for tag, budget in (("half", "50%"), ("tight", tight)):
            for op in opnames:
                sid = f"{tag}-{op}"
                res, ios[sid] = run(sid, {sid: (op, budget)}, layout)
                plans[sid] = plan_of(res[sid])
                if tag == "half" and selected(plans[sid]) == selected(
                        plan_of(full_flat[f"full-{op}-flat"])):
                    refs[sid] = None
                    continue
                refs[sid] = pool.submit(store_stream_reference, ws,
                                        block_size, plans[sid].plan_id,
                                        f"{sid}-stream")
        # 2. full budget from the layout (one batch), each bit-equal to
        # the flat merge
        res = run("full-packed", {f"full-{op}-packed": (op, "100%")
                                  for op in opnames},
                  layout, prefer_packed=layout,
                  cache_max_bytes=STORE["cache_bytes"])[0]
        refs = {sid: f.result() if f is not None else None
                for sid, f in refs.items()}
        out["stream_refs_wall_s"] = time.perf_counter() - t
        out["stream_refs"] = sorted(sid for sid, f in refs.items() if f)
    # every block of the model, the count a plan selects at full budget
    all_blocks = plan_of(res["full-ties-packed"]).total_selected_blocks()
    out["all_blocks"] = all_blocks
    for op in opnames:
        same(f"full-{op}-packed", f"full-{op}-flat", f"full {op}")
        drop_snapshots(sess, f"full-{op}-packed")
    out["half"], out["tight"] = {}, {}
    for sid, plan in plans.items():
        tag, op = sid.split("-")
        if refs[sid] is None:   # the full-budget flat plan's blocks
            same(sid, f"full-{op}-flat", f"{tag} {op}")
        else:
            hold_to_stream(sid, ios[sid], refs[sid], f"{tag} {op}")
        flat = plan_merge(sess.catalog, "base", ids, op, theta=dict(OPS)[op],
                          budget_b=plan.budget_b, block_size=block_size,
                          reuse=False)
        out[tag][op] = {
            "budget_b": plan.budget_b,
            "held_to": "stream" if refs[sid] else f"full-{op}-flat",
            "stream_wall_s": refs[sid][1] if refs[sid] else None,
            "selected_blocks_packed": plan.total_selected_blocks(),
            "selected_blocks_flat": flat.plan.total_selected_blocks(),
            "c_expert_hat_packed": plan.c_expert_hat,
            "c_expert_logical_hat_packed": plan.c_expert_logical_hat,
            "c_expert_hat_flat": flat.plan.c_expert_hat}
        # under a budget below the layout's physical bytes the packed
        # plan must leave blocks out
        if tag == "tight" and not (
                plan.budget_b < rep["physical_bytes"]
                and plan.total_selected_blocks() < all_blocks):
            raise AssertionError(f"store tight {op}: B {plan.budget_b} of "
                                 f"{rep['physical_bytes']} physical B "
                                 f"selected {plan.total_selected_blocks()} "
                                 f"of {all_blocks} blocks")
        if sid != "half-ties":
            drop_snapshots(sess, sid)
    for op in opnames:
        if op != "ties":
            drop_snapshots(sess, f"full-{op}-flat")
    # the TIES merge's bytes, for the one after fsck
    half_ties = snapshot_hashes(sess, "half-ties")
    drop_snapshots(sess, "half-ties")
    sess.close()

    # 4. the tiered store: the experts pushed to a bucket behind an
    # emulated endpoint (merge_cli remote push)
    t0 = time.perf_counter()
    for e in ids:
        merge_cli.main(["remote", "push", e, "--workspace", ws,
                        "--remote-root", bucket, "--device", str(device),
                        "--latency-s", str(STORE["latency_s"]),
                        "--mbps", str(STORE["mbps"])])
    out["push_s"] = time.perf_counter() - t0
    # tier billing over a partly warm tier (ROADMAP C3): a cold merge at
    # the tight budget warms the blocks it selects; tier billing under the
    # same budget then bills those at the disk tier's weight and adds
    # cold ones beside them.  A coalesced run that mixes the two tiers is
    # read piece by piece (the reference fetches it whole from remote and
    # refuses the merge): the realized remote bytes stay within the plan,
    # and the merge is bit-equal to the stream engine on its plan
    sess = Session(ws, block_size=block_size, device=device)
    sess.evict_disk_cache(0)
    run("ties-cold-tight", {"ties-cold-tight": ("ties", tight)}, None,
        prefer_packed=False)
    res, io = run("ties-mixed", {"ties-mixed": ("ties", tight)}, None,
                  prefer_packed=False, tier_billing=True)
    plan = plan_of(res["ties-mixed"])
    out["mixed"] = {"c_expert_hat": plan.c_expert_hat,
                    "c_expert_run": res["ties-mixed"].stats["c_expert_run"],
                    "expert_remote_read": io["expert_remote_read"],
                    "expert_disk_read": io["expert_disk_read"],
                    "selected_blocks": plan.total_selected_blocks()}
    if not (0 < io["expert_remote_read"] <= plan.c_expert_hat
            and io["expert_disk_read"] > 0):
        raise AssertionError(f"store mixed tier: {out['mixed']}")
    _io_s, out["mixed"]["stream_wall_s"] = store_stream_reference(
        ws, block_size, plan.plan_id, "ties-mixed-stream")
    same("ties-mixed", "ties-mixed-stream", "mixed tier")
    drop_snapshots(sess, "ties-mixed", "ties-mixed-stream")
    sess.close()
    # a cold TIES merge (the disk tier empty), a warm one from a new
    # session (the RAM tier empty), a tier-billed one at half budget and
    # one per operator at the tight budget, each held to the stream
    # engine on its plan
    sess = Session(ws, block_size=block_size, device=device)
    drop_snapshots(sess, "ties-cold-tight")
    sess.evict_disk_cache(0)
    _, io = run("ties-cold", {"ties-cold": ("ties", "100%")}, None,
                prefer_packed=False)
    # the disk tier is keyed by content: a range whose bytes another
    # expert already fetched (the frozen tensors) is a disk hit
    cold = io["expert_remote_read"] + io["expert_disk_read"]
    flat = out["merges"]["full-flat"]["jobs"]["full-ties-flat"]["c_expert_hat"]
    if not (cold == flat and io["expert_remote_read"] > 0
            and io["expert_repair_read"] == 0):
        raise AssertionError(f"store cold: {dict(io)}, flat {flat}")
    same("ties-cold", "full-ties-flat", "cold")
    # the same cold merge through SHARDS["workers"] shard workers (one
    # process each, the card) over an emptied disk cache: the shared
    # storage regime sharding is for (docs/DISTRIBUTED.md)
    sess.evict_disk_cache(0)
    h = sess.submit(spec("ties", "100%"), sid="ties-cold-sharded")
    t0 = time.perf_counter()
    with measure(sess.stats) as io_sh:
        sess.run_all(prefer_packed=False, n_workers=SHARDS["workers"])
        if device.type == "cuda":
            torch.cuda.synchronize()
    shards = h.result.stats["shards"]
    for sh in shards:
        if not (sh["device"].startswith(device.type) and
                sh["launches"]["ties_fused"] + sh["launches"]["ties_merge"]):
            raise AssertionError(f"store cold sharded: worker {sh}")
    same("ties-cold-sharded", "full-ties-flat", "cold sharded")
    out["cold_sharded"] = {
        "wall_s": time.perf_counter() - t0,
        "local_cold_wall_s": out["merges"]["ties-cold"]["wall_s"],
        "io": {c: io_sh[c] for c in STORE_IO},
        "local_cold_io": out["merges"]["ties-cold"]["io"],
        "shard_walls_s": [sh["seconds"] for sh in shards],
        "worker_launches": [sh["launches"] for sh in shards]}
    drop_snapshots(sess, "ties-cold-sharded")
    sess.close()
    sess = Session(ws, block_size=block_size, device=device)
    _, io = run("ties-warm", {"ties-warm": ("ties", "100%")}, None,
                prefer_packed=False)
    if not (io["expert_remote_read"] == 0 and io["expert_disk_read"] == cold):
        raise AssertionError(f"store warm: {dict(io)}, cold {cold}")
    same("ties-warm", "full-ties-flat", "warm")
    res, io = run("ties-billed", {"ties-billed": ("ties", "50%")}, None,
                  prefer_packed=False, tier_billing=True)
    plan = plan_of(res["ties-billed"])
    out["billed"] = {"selected_blocks": plan.total_selected_blocks(),
                     "c_expert_hat": plan.c_expert_hat,
                     "budget_b": plan.budget_b,
                     "c_expert_run": res["ties-billed"].stats["c_expert_run"]}
    out["billed_tight"] = {}
    with ProcessPoolExecutor(len(opnames), mp_context=spawn) as pool:
        for op in opnames:
            sid = f"billed-tight-{op}"
            res, ios[sid] = run(sid, {sid: (op, tight)}, None,
                                prefer_packed=False, tier_billing=True)
            plan = plan_of(res[sid])
            refs[sid] = pool.submit(store_stream_reference, ws, block_size,
                                    plan.plan_id, f"{sid}-stream")
            out["billed_tight"][op] = {
                "budget_b": plan.budget_b,
                "selected_blocks": plan.total_selected_blocks(),
                "c_expert_hat": plan.c_expert_hat,
                "c_expert_run": res[sid].stats["c_expert_run"]}
            if plan.total_selected_blocks() >= all_blocks:
                raise AssertionError(f"store billed tight {op}: selected "
                                     f"every block under B {plan.budget_b}")
        for op in opnames:
            sid = f"billed-tight-{op}"
            refs[sid] = refs[sid].result()
            out["billed_tight"][op]["stream_wall_s"] = refs[sid][1]
    for op in opnames:
        sid = f"billed-tight-{op}"
        hold_to_stream(sid, ios[sid], refs[sid], f"billed tight {op}")
        drop_snapshots(sess, sid)
    out["cache"] = sess.disk_cache_stats()
    drop_snapshots(sess, "ties-cold", "ties-warm", "ties-billed",
                   "full-ties-flat")

    # 5. mergefsck: clean; then a corrupt disk-cache extent (written at
    # fill) and a corrupt packed extent (read at rest by the check) are
    # found, repaired, and a packed merge is still bit-equal
    sess.evict_disk_cache(0)
    sess.close()
    fsck = {}

    def run_fsck(label, *flags, point=None):
        buf = _io.StringIO()
        ctx = (inject_corruption(point, skip=STORE["corrupt_skip"]) if point
               else contextlib.nullcontext())
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf), ctx:
            try:
                merge_cli.main(["fsck", "--workspace", ws, "--json",
                                "--device", str(device), *flags])
                code = 0
            except SystemExit as e:
                code = e.code
        doc = json.loads(buf.getvalue())
        fsck[label] = {"exit_code": code, "wall_s": time.perf_counter() - t,
                       "scrubbed_bytes": doc["scrubbed_bytes"],
                       "stores": doc["stores"],
                       "problems": sorted((p["store"], p["kind"],
                                           p["repaired"])
                                          for p in doc["problems"])}
        return doc

    run_fsck("clean", "--check")
    if fsck["clean"]["exit_code"] != 0 or fsck["clean"]["problems"]:
        raise AssertionError(f"store fsck: the clean workspace: {fsck}")
    sess = Session(ws, block_size=block_size, device=device)
    reader = sess.snapshots.models.open_model(ids[-1])
    with inject_corruption("cache:extent") as inj:
        reader.read_range("attn/wq", 0, block_size, "other")
    reader.close()
    sess.close()
    if not inj.fired:
        raise AssertionError("store fsck: no cache extent was corrupted")
    run_fsck("check", "--check", point="packed:extent")
    found = {(s, k) for s, k, _r in fsck["check"]["problems"]}
    if (fsck["check"]["exit_code"] != 1
            or found != {("packed", "corrupt-extent"),
                         ("cache", "corrupt-extent")}):
        raise AssertionError(f"store fsck --check: {fsck['check']}")
    doc = run_fsck("repair", "--repair")
    packed = doc["stores"]["packed"]
    if (fsck["repair"]["exit_code"] != 0
            or doc["stores"]["cache"]["repaired"] != 1
            or packed["repaired"] + packed["quarantined"] < 1):
        raise AssertionError(f"store fsck --repair: {fsck['repair']}")
    sess = Session(ws, block_size=block_size, device=device)
    _, io = run("ties-after-fsck", {"ties-after-fsck": ("ties", "50%")},
                layout)
    same("ties-after-fsck", half_ties, "after fsck")
    out["after_fsck"] = {"expert_repair_read": io["expert_repair_read"],
                         "expert_remote_read": io["expert_remote_read"]}
    out["fsck"] = fsck
    out["launches"] = dict(mb.LAUNCHES)
    out["worker_launches"] = dict(sum(
        (collections.Counter(sh) for sh in
         out["cold_sharded"]["worker_launches"]), collections.Counter()))
    sess.close()
    out["wall_s"] = time.perf_counter() - t_phase
    shutil.rmtree(ws, ignore_errors=True)
    shutil.rmtree(bucket, ignore_errors=True)
    emit(out)
    return out["launches"], out["worker_launches"]


def ptxas_report(log_path):
    """Per kernel of one build: registers, spills, stack and static shared
    memory, from nvcc's ``-Xptxas -v`` output, and ``serialised``: each
    note of ptxas that serialises the kernel's wgmma, as "code: reason":
    C7520 (a wgmma in a divergent path) and C7515 (an accumulator written
    between a wgmma's issue and its wait), or any other code ptxas gives
    in the same form ("(C7520) Potential Performance Loss:
    wgmma.mma_async instructions are serialized due to ... in the function
    '...'")."""
    from repro_torch.kernels.build import nvcc

    cufilt = os.path.join(os.path.dirname(nvcc()), "cu++filt")  # demangler
    out, cur = {}, None
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"\((C\d+)\)\s*(?:Potential Performance Loss:"
                          r"\s*)?(.*?) in the function '(\S+?)'", ln)
            if m:
                out.setdefault(m.group(3), {}).setdefault(
                    "serialised", []).append(f"{m.group(1)}: {m.group(2)}")
                continue
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
                out.setdefault(cur, {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                out[cur].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                out[cur]["smem_static"] = int(sm.group(1)) if sm else 0
    if os.path.exists(cufilt) and out:
        names = subprocess.run([cufilt], input="\n".join(out), text=True,
                               capture_output=True).stdout.split("\n")
        if len(names) >= len(out):
            out = {n: v for n, v in zip(names, out.values())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # the merge path's depth: 1, since at 4 the whole smoke took 1,177.9
    # s on an H100 80GB HBM3 at 700 W (serve_mla already at depth 6), and
    # at 2 (serve_griffin at 32 beside it) 1,243.5 s on a slower host,
    # past the 1,200 s the smoke is given
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # the loop phase's deterministic cuBLAS needs this before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import merge_block as mb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"config": "qwen2-1.5b", "dtype": "bfloat16", "experts": 4,
          "block_size": args.block_size, "seed": args.seed,
          "reduced": f"depth {args.layers} of "
                     f"{get_config('qwen2-1.5b').n_layers} decoder layers "
                     f"(+ embedding, final norm) for merge, service, shards "
                     f"and serve; the train-merge-serve loop: depth "
                     f"{LOOP['layers']}; store: depth "
                     f"{STORE['layers']} (its zlib repack runs on the "
                     f"host at ~9 MB/s); shards: pipelined windows of "
                     f"{', '.join(SHARDS['pipelined'])} only, whole-shard "
                     f"merges of {', '.join(SHARDS['whole_shard'])} only; "
                     f"train: all layers; train_mla (deepseek-v2-lite-16b): "
                     f"depth {TRAIN_MLA['layers']} of "
                     f"{get_config('deepseek-v2-lite-16b').n_layers} "
                     f"({TRAIN_MLA['cut_by']}); train_griffin "
                     f"(recurrentgemma-9b): depth {TRAIN_GRIFFIN['layers']} "
                     f"of {get_config('recurrentgemma-9b').n_layers} "
                     f"({TRAIN_GRIFFIN['cut_by']}); "
                     f"serve_mla (deepseek-v2-lite-16b): depth "
                     f"{MLA['layers']} of "
                     f"{get_config('deepseek-v2-lite-16b').n_layers}; "
                     f"serve_griffin (recurrentgemma-9b): depth "
                     f"{GRIFFIN['layers']} of "
                     f"{get_config('recurrentgemma-9b').n_layers} "
                     f"({GRIFFIN['cut_by']}); "
                     f"serve_mamba (mamba2-2.7b): all "
                     f"{get_config('mamba2-2.7b').n_layers} layers; "
                     f"serve_whisper and train_whisper (whisper-tiny): full "
                     f"depth, the conv frontend a stub (random frames, as "
                     f"in the reference); serve_vlm (llama-3.2-vision-90b): "
                     f"depth {VLM['layers']} of "
                     f"{get_config('llama-3.2-vision-90b').n_layers} (one "
                     f"super-block), the vision encoder a stub (random "
                     f"patch embeddings, as in the reference); "
                     f"train_mamba: depth {TRAIN_MAMBA['layers']} of "
                     f"{get_config('mamba2-2.7b').n_layers} "
                     f"({TRAIN_MAMBA['cut_by']}); llama-3.2-vision-90b is "
                     f"not trained: one super-block with float32 AdamW "
                     f"needs ~88 GB before activations, past the card's "
                     f"80 GB; mesh: "
                     + "; ".join(f"{m['config']} depth {m['layers']} of "
                                 f"{get_config(m['config']).n_layers}, "
                                 f"{m['batch']} x {m['seq']} tokens, "
                                 f"{m['steps']} steps, meshless and under "
                                 f"the (1, 1) mesh" for m in MESH)
                     + f"; dryrun: {' and '.join(DRYRUN['archs'])} only "
                       f"(every shape, both production meshes; the other "
                       f"archs' cells run off the card, PERF.md); "
                       f"examples: quickstart and budget_sweep at their "
                       f"own sizes, nothing cut; lint: all of "
                       f"src/repro_torch, nothing cut; "
                       f"widths as published"})

    t0 = time.perf_counter()
    libraries = (mb.LIBRARY, fa.LIBRARY, fa.BWD_LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as ex:  # one nvcc per source
        paths = list(ex.map(lambda lib: lib.build(), libraries))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, HERE) for p in paths]})
    # each kernel's registers, spills and static shared memory (ptxas -v)
    ptxas = {os.path.basename(lib.source): ptxas_report(lib.log_path())
             for lib in libraries}
    emit({"ptxas": ptxas})
    # demangled names spell template arguments "(int)192"
    watched = [(src, n) for src in ("flash_attention.cu",
                                    "flash_attention_bwd.cu")
               for n in ptxas[src]
               if re.search(r"fa_bwd_\w*(tc|reduce)_kernel|flash_attention_"
                            r"(tc_|ws_)?kernel(<\w*,? ?(192, 128|24, 16|"
                            r"256, 256)>|I\w*Li(192ELi128|24ELi16|256ELi256)"
                            r"E)", n.replace("(int)", ""))]
    spills = [n for src, n in watched
              if ptxas[src][n].get("spill_stores")
              or ptxas[src][n].get("spill_loads")]
    if spills:
        raise AssertionError(f"ptxas: a tensor-core backward, an MLA "
                             f"forward or a (256, 256) forward spills in "
                             f"{spills}")
    # the warp-specialised forwards past hd 128: found, their wgmma not
    # serialised (C7520, C7515), and their shared memory as the source
    # and forward_plan state it, as ptxas and the launch's attribute see
    # it
    ws = {n: pair for n in ptxas["flash_attention.cu"]
          for pair in ((192, 128), (256, 256))
          if re.search(rf"flash_attention_ws_kernel(<{pair[0]}, {pair[1]}>|"
                       rf"ILi{pair[0]}ELi{pair[1]}E)", n.replace("(int)", ""))}
    if sorted(ws.values()) != [(192, 128), (256, 256)]:
        raise AssertionError(f"ptxas: want the warp-specialised forwards at "
                             f"(192, 128) and (256, 256), found {ws}")
    serialised = {n: ptxas["flash_attention.cu"][n]["serialised"]
                  for n in ws if ptxas["flash_attention.cu"][n].get(
                      "serialised")}
    if serialised:
        raise AssertionError(f"ptxas serialises the wgmma of the "
                             f"warp-specialised forward: {serialised}")
    smem = {}
    for n, (hd, hdv) in ws.items():
        plan = fa.forward_plan(1, 1, 1, 1, 1, hd, torch.bfloat16, "tc",
                               hdv=hdv)
        attrs = fa.tc_attributes(hd, hdv)
        info = ptxas["flash_attention.cu"][n]
        smem[f"{hd}x{hdv}"] = {"plan": plan, "attributes": attrs,
                               "ptxas_static": info["smem_static"],
                               "ptxas_registers": info["registers"]}
        if not (plan["smem_bytes"] == attrs["smem_bytes"]
                == attrs["max_dynamic_smem_bytes"]
                and plan["static_smem_bytes"] == attrs["static_smem_bytes"]
                == info["smem_static"]
                and plan["threads"] == attrs["threads"]
                and plan["rows"] == attrs["rows"]
                and attrs["registers"] == info["registers"]):
            raise AssertionError(f"forward_plan, the source and ptxas "
                                 f"disagree at ({hd}, {hdv}): "
                                 f"{smem[f'{hd}x{hdv}']}")
    emit({"ws_forward": smem})
    # the two-warpgroup dK / dV and dQ CTAs past hd 128 run one instruction
    # stream, so ptxas must not serialise their wgmma (its C7520 note);
    # a note on any other kernel stands in the ptxas line above
    wide = [n for n in ptxas["flash_attention_bwd.cu"]
            if re.search(r"fa_bwd_(dkdv|dq)_tc_kernel(<192, 128>|<256, 256>|"
                         r"ILi192ELi128E|ILi256ELi256E)",
                         n.replace("(int)", ""))]
    if len(wide) != 4:
        raise AssertionError(f"ptxas: want the 4 two-warpgroup backward "
                             f"kernels, found {wide}")
    serialised = [n for n in wide
                  if ptxas["flash_attention_bwd.cu"][n].get("serialised")]
    if serialised:
        raise AssertionError(f"ptxas serialises the wgmma of the "
                             f"tensor-core backward past hd 128 in "
                             f"{serialised}")
    # 21 backward kernels (the tensor cores' preprocess at 5 hdv, dK / dV
    # and dQ at 7 pairs; the GQA reduction into bf16 and into float32), 6
    # MLA forwards (the FMA kernel in float32 and bf16 at (192, 128) and
    # (24, 16), the one-warpgroup tensor-core kernel at (24, 16), the
    # warp-specialised one at (192, 128)), 3 forwards at (256, 256) (the
    # FMA kernel in float32 and bf16, the warp-specialised one)
    if len(watched) != 30:
        raise AssertionError(f"ptxas: want the 30 spill-checked kernels, "
                             f"found {watched}")

    walls = {}
    # the dryrun phase: host-only processes, beside every card phase
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    dry_dir = tempfile.mkdtemp(prefix="smoke-dryrun-",
                               dir=os.path.join(HERE, "build"))
    dry, stop_dry = start_dryrun(dry_dir)
    # the lint phase: one host-only process, beside the card phases too
    lint, stop_lint = start_lint()

    def timed(name, phase, *a):
        t = time.perf_counter()
        try:
            return phase(*a)
        finally:
            walls[name] = time.perf_counter() - t

    root = tempfile.mkdtemp(prefix="smoke-ws-", dir=os.path.join(HERE, "build"))
    seed, bs, layers = args.seed, args.block_size, args.layers
    try:
        rows = timed("kernels", phase_kernels, device, args.seed)
        pair = timed("parity", phase_parity, root, device, seed, bs)
        launches, merged, local = timed("merge", phase_merge, root, device,
                                        seed, bs, layers)
        service = timed("service", phase_service, root, device, bs)
        shards, worker = timed("shards", phase_shards, root, device, bs,
                               local)
        served = timed("serve", phase_serve, device, seed, layers, merged)
        del merged
        served_mla = timed("serve_mla", phase_serve_mla, device, seed)
        served_griffin = timed("serve_griffin", phase_serve_griffin, device,
                               seed)
        trained = timed("train", phase_train, device, seed)
        trained_mla = timed("train_mla", phase_train, device, seed,
                            TRAIN_MLA, "train_mla")
        trained_griffin = timed("train_griffin", phase_train, device, seed,
                                TRAIN_GRIFFIN, "train_griffin")
        timed("serve_mamba", phase_serve_mamba, device, seed)
        served_whisper = timed("serve_whisper", phase_serve_whisper, device,
                               seed)
        served_vlm = timed("serve_vlm", phase_serve_vlm, device, seed)
        # attention-free: phase_train holds its flash launches to 0
        timed("train_mamba", phase_train, device, seed, TRAIN_MAMBA,
              "train_mamba")
        trained_whisper = timed("train_whisper", phase_train, device, seed,
                                TRAIN_WHISPER, "train_whisper")
        meshed = timed("mesh", phase_mesh, device, seed)
        examples = timed("examples", phase_examples, device)
        shutil.rmtree(os.path.join(root, "merge"), ignore_errors=True)
        # the loop phase in a process of its own beside the store phase:
        # both are host-bound (checkpoint and snapshot I/O, hashing, zlib,
        # the numpy stream engine) on workspaces of their own
        # (root/loop-*, root/store*), and the card has room for both
        t_loop = time.perf_counter()
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as side:
            looping = side.submit(loop_process, root, seed, LOOP["layers"],
                                  bs)
            looping.add_done_callback(lambda _f: walls.__setitem__(
                "loop", time.perf_counter() - t_loop))
            store, store_worker = timed("store", phase_store, root, device,
                                        seed, bs)
            loop = looping.result()
        records, walls["dryrun"] = dry.result()
        phase_dryrun(records, walls["dryrun"])
        doc, code, walls["lint"] = lint.result()
        phase_lint(doc, code, walls["lint"])
    finally:
        stop_dry()
        stop_lint()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(dry_dir, ignore_errors=True)
    # each kernel's launches over the paths that run it: the merge, the
    # service, the parity phase's TIES merge at 2 MiB blocks (the pair
    # route), the shards phase's inline window, the loop's merge and the
    # store phase's merges and ANALYZE, the examples' card runs (their
    # ANALYZE, TIES and DARE merges); flash attention: serving, training
    # and the loop.  The shard worker processes' launches (their result
    # docs: the shards phase and the store phase's sharded merge) are a
    # column of their own
    launches = {n: launches[n] + service[n] + pair[n] + shards[n] + loop[n]
                + store[n] + examples.get(n, 0) for n in launches}
    worker = collections.Counter(worker) + collections.Counter(store_worker)
    for name in ("flash_attention", "flash_attention_bwd",
                 "flash_attention_bwd_tc"):
        launches[name] = served.get(name, 0) + trained[name] + loop[name]
    # DeepSeek-V2-Lite's prefill at (192, 128): the serve_mla phase's bf16
    # run (tensor cores) and its float32 run (FMA kernel)
    launches.update(served_mla)
    # RecurrentGemma-9B's prefill at (256, 256): the serve_griffin phase's
    # bf16 run (tensor cores) and its float32 run (FMA kernel)
    launches.update(served_griffin)
    # the training phases of DeepSeek-V2-Lite and RecurrentGemma-9B: their
    # tensor-core backward launches (BWD_ROWS) and their tensor-core
    # forwards at (192, 128) and (256, 256) beside the served ones
    launches["flash_attention_bwd_mla"] = trained_mla[TRAIN_MLA["counter"]]
    launches["flash_attention_bwd_rg"] = trained_griffin[
        TRAIN_GRIFFIN["counter"]]
    launches["flash_attention_mla"] += trained_mla["flash_attention_tc"]
    launches["flash_attention_rg"] += trained_griffin["flash_attention_tc"]
    # whisper-tiny's encoder at (1, 1,500, 1,500, 6, 6) hd 64 and Llama-3.2-
    # Vision's cross-attention over 1,024 vision tokens at hd 128: the
    # serve_whisper and serve_vlm phases' bf16 launches at those shapes;
    # whisper's backward: the train_whisper phase's tensor-core backward
    # launches (encoder, decoder self and cross, all at hd 64)
    launches.update(served_whisper)
    launches.update(served_vlm)
    launches["flash_attention_bwd_whisper"] = trained_whisper[
        TRAIN_WHISPER["counter"]]
    # the mesh phase's runs under the (1, 1) mesh: Qwen2's at hd 128 with
    # the served and trained ones, DeepSeek's tensor-core forwards and
    # backwards at (192, 128) with train_mla's
    for counter, n in meshed.items():
        launches[counter] += n
    keys = ("name", "kernel", "route", "source", "replaces", "launches",
            "worker_launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "copy_ms")
    # one row per kernel of the main path: the fused TIES kernel and the
    # threshold at the largest group, the sketch at ANALYZE's launch,
    # flash attention at the prefill shape through the tensor-core kernel
    # (the serve phase checked that every bf16 prefill launch took that
    # route), the forward at DeepSeek-V2-Lite's (192, 128) on both routes
    # (FA_ROWS: the serve_mla phase's launches of each), RecurrentGemma's
    # (256, 256) with window 2,048 on both routes (the serve_griffin
    # phase's launches), the flash
    # backward at the training shape through the tensor-core route (its
    # launches: that route's counter)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_walls_s": walls})
    firsts = {}
    for r in rows:
        if r.get("case") in FA_ROWS or (r.get("case") in BWD_ROWS
                                        and r.get("fa_route") == "tc"):
            firsts[r["case"]] = r
        elif r.get("fa_route", "tc") == "tc":
            firsts.setdefault(r["name"], r)
    line = []
    for r in firsts.values():
        counter = r.get("counter", r["name"])
        r = {**r, "launches": launches[counter],
             "worker_launches": worker.get(counter, 0)}
        line.append({k: r[k] for k in keys + ("case", "device_ms")
                     if k in keys or k in r})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
