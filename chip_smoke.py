#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel under src/repro_torch/kernels/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes ResNet-18 (width 1.0, img 224, batch 8) gives it, with
     its median time (CUDA events), the plain version's time, one PyTorch
     library call's time where one computes the same function, and the
     bound (the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s fp32):
     at each conv view the conv detection sums (the main path's launch),
     on O and on O rounded to bf16, beside the tile-partials entry point
     and the two PyTorch calls of the plain detection pass; the fc's
     abft_matmul and abft_matmul_detect; torch.profiler's count of device
     kernels in one conv-sums call and one f32 detect call (one each);
  3b. the serving path's kernels at every GEMM shape of a SmolLM-360M
     decode step (8 rows) and of every prefill bucket (16, 32, 64, 128
     rows), in bf16 (the tied head's weight read in place as the
     transposed embedding table), with the tiling the CUDA source chose:
     abft_matmul_detect against its plain version (flags exact, clear on
     exact checksums, exactly one chunk on a c5, c6 or c7 shifted by 10
     tau), its O bitwise equal to abft_matmul's, abft_matmul on bf16
     against its plain version; at 8 and 128 rows times beside
     torch.matmul and the bound (bf16 peak 989 TFLOP/s; the fp32-FMA
     bound beside it); the host us of one call of each wrapper at the
     decode wq shape;
  3c. the same two bf16 kernels at Mamba2-1.3B's GEMM shapes (in_proj
     2048 x 8512, out_proj 4096 x 2048, the untied head 2048 x 50280) at
     8, 97 and 128 rows: flags equal to the plain version's and clear, O
     within one bf16 ulp plus the fp32 summation noise and bitwise equal
     between the two kernels, the partials finished into chunk sums on the
     card, checksums predicting +1e4 at one element flagging exactly its
     chunk; device ms of both kernels, their plain versions and
     torch.matmul beside the bound, the detect pass's row segment and the
     partial tiles used;
  3d. the same at RecurrentGemma-2B's GEMM shapes (2560 x 2560: the five
     rec sites and attn wq/wo; wk/wv 2560 x 256 on one KV head; the gelu
     FFN's 2560 x 7680 and 7680 x 2560; the tied head 2560 x 256000 read
     in place as the transposed table) at 8, 97 and 128 rows, with the
     sums over one forward's 201 launches;
  3e. the same at MusicGen-large's GEMM shapes (attention 2048 x 2048 on
     32 heads of 64, the gelu FFN's 2048 x 8192 and 8192 x 2048, the
     untied 4-codebook head 2048 x 8192) at a decode step's 8 rows and
     the prefill buckets' 16, 32, 64 and 128, with the sums over one
     forward's 337 launches;
  4. the slice: build_plan + forward_cnn on that ResNet-18 in per_layer
     and deferred mode with the kernels pinned (use_fused_kernel=True):
     zero clean flags, bitwise clean-path contracts, allclose to the
     port's own CPU run, 17 checksum_reduce + 1 abft_matmul launches and
     18 / 1 host reads per forward, median forward times (taken in
     turns), the host time of each layer of the kernel route (timing
     spans around the port's functions) and a torch.profiler trace;
  5. injected faults (conv5: one element; conv13: a burst over channels
     of one image at one payload position): detected, corrected, no
     residual, logits back to the clean ones, in both modes;
  5b. the paper's error-injected overhead: a `burst` fault drawn by the
     port's registry (up to 100 elements of one block-row or column,
     +-2^e) injected at each of the 17 convs in turn, with the plan as
     built and with RC/ClC off (Fig. 10b), each in per_layer and deferred
     mode: detected, no residual, no other layer flagged, logits back
     within rtol 1e-4; 17 conv-sums launches per faulted forward; the
     median faulted forward per layer timed in turns with the unprotected
     and the clean protected one, the error-injected overhead (mean over
     layers of the faulted medians / the unprotected median - 1) and the
     scheme histogram;
  6. the serving slice: SmolLM-360M at full width in bf16 (random params
     from a seed), a ProtectedSession of 8 slots and 256 positions in
     deferred mode with the kernels pinned, serving 16 requests (prompts
     of 16-128 tokens, 32 new tokens each): every request completes, zero
     flags, 225 abft_matmul_detect launches and 1 host read per forward;
     per_layer serves the first 8 requests' first 8 tokens bitwise alike;
     a teacher-forced check against the unprotected forward (every
     served token's reference logit within 0.1 of the reference's top);
     median decode-step ms and TTFT p50 of the unprotected session and
     the protected one with the kernels off and on, two rounds in
     turns, and a torch.profiler trace of one decode step of each;
  7. serving drills: +1e4 at one logit of slot 3 at every decode step
     (the tied head) and +1e3 at one element of a stage's wq in every
     prefill and repeat: detected, corrected, attributed to the right
     requests, no residual, tokens equal to the clean run's;
  7b. the serving weight audit: sessions with audit_every=1 and a
     restore_fn; one column of one repeat of a stage's wq overwritten
     between two steps is repaired in place (verdict `repaired`, no
     restore, the leaf bitwise clean), two corrupted blocks are restored;
     tokens equal to the clean run's; the audit's and the repair's ms;
  8. the campaign on the card, in five child processes started before
     phase 6 and collected after phase 7b (its trial loops wait on the
     host): matmul and conv, scheme full, every registered fault arm,
     1000 trials per cell (the paper's grid), and every layer x scheme x
     arm at 100: every gate of repro_torch.campaign.run.check, deferred
     == full per arm, and one cell per layer (64 trials per arm) against
     the port's own CPU run (no detected or residual mismatch;
     corrected_by may differ only between two correcting verdicts, in at
     most 1% of the trials); CSV rows and us per trial;
  9. the calibrated plan on phase 4's ResNet-18: the card's peaks measured
     (an IEEE-fp32 8192^3 GEMM and a 256 MiB-per-array triad; each within
     105% of the datasheet), the measured-roofline plan
     (MeasuredCostModel, profile_kernels=True: each site's intensity,
     bound, execution membership, profiled or pruned) and the analytic
     plan with every shape profiled (plain and kernel-route us, the
     winner, the tiling the CUDA source chose); the measured plan in
     deferred mode: zero clean flags, logits bitwise the unprotected
     ones, one host read per per_layer member plus one, a registry burst
     at a per_layer and at a deferred member detected and corrected; the
     new plans' launches per forward, their forwards timed in turns with
     the unprotected one and phase 4's pinned plan (error-free overhead);
     the profile's decisions for SmolLM-360M at batch 8 x seq 128;
  10. the async ServingDriver on phase 6's model cut to its first 2 layers
     at full width (a plan of its own) and phase 6's 16 requests: every
     request completes with the synchronous session's tokens, 15 detect
     launches and 1 host read per forward; backpressure (capacity 4: 12 of 16
     rejected, the 4 accepted served) and a lapsed deadline (timeout,
     never a slot); phase 7's head drill under a fault_scope around
     submit/drain, attributed to slot 3's request only; phase 7b's
     one-column corruption repaired in place by the controller's audit
     while requests are admitted; the driver and the session timed in
     turns, two rounds (decode step period, TTFT p50);
  11. training: (a) abft_matmul_vjp with the kernel pinned at 2048 rows
     (batch 8 x seq 256) and the five GEMM shapes of phase 3b, in bf16 and
     f32: O, dD and dW against autograd of the plain product (one bf16
     ulp plus the fp32 summation noise; fp32 rtol 1e-5), 3 abft_matmul
     launches per call (1 with protect_backward off, 4 where a burst's
     ladder recomputes through the kernel), clean reports, a registry burst in dW's and
     in dD's output (fp32: detected, corrected with residual 0, the
     gradients back within tolerance; bf16: verdicts recorded, the
     reference's bf16 thresholds do not promise them, ROADMAP 3.5), and
     the device ms of the backward's two launches, the D^T copy,
     torch.matmul and the plain version beside the bound; (b) the train
     step on SmolLM-360M at full width and 4 of its 32 layers (bf16
     params, fp32 AdamW, batch 8 x 256 in 2 microbatches,
     warmup 1, lr 1e-3) over three cycled batches for 12 steps: every
     report clean, the loss falling, one step bitwise its abft=False
     twin, no kernel launched (the plain route, as in the JAX package);
     step ms, host reads, peak memory and a profile of one step; (c) the
     training driver (launch.train.train) at full width and 4 layers: a
     restart from the step-3 checkpoint bitwise the uninterrupted run
     (bf16 leaves through '<V2' files), a flipped byte refused by
     restore, and one element of the head's output corrupted (+1e4, as in
     phase 7) in one step corrected and counted by StepRunner, the loss
     within rtol 1e-4;
  12. Mamba2-1.3B at full width and its first 4 of 48 layers in bf16
     (random params drawn on the card from a seed, a plan of its own),
     served as phase 6 serves SmolLM-360M (8 slots, deferred, the kernels
     pinned, 16 requests of 16-128 tokens, each prefilled at its own
     length, 32 new tokens each): every request finishes by length, zero
     flags, none echoing its prompt's last token, 9 abft_matmul_detect
     launches and 1 host read per forward; per_layer serves the first 8
     requests' 8 tokens alike with 9 reads and 9 abft_matmul launches per
     forward; teacher-forced through the uncached
     forward, every served token's bf16 margin below the unprotected
     forward's top logit within twice the routes' logit gap plus 0.1, and
     a float32 twin's within 0.1; the unprotected and the kernels-on
     sessions timed in turns (median decode-step ms, TTFT p50) and one
     decode step of each profiled; drills: +1e4 at the head on slot 3 in
     every decode step, +1e3 at one repeat's in_proj in every prefill, and
     +1e4 at one repeat's out_proj on slot 3 in one mid-stream decode step
     after which every token equals the clean run's (the corrective rerun
     starts from the step's input state); init and build_plan seconds and
     peak device memory;
  13. RecurrentGemma-2B at full width and its first 3 of 26 layers in
     bf16 (one repeat of its pattern: 2 RG-LRU blocks, a sliding-window
     attention block on one KV head, 3 gelu FFNs, the tied 256,000-token
     head; random params drawn on the card from a seed, the table scaled
     by 1/16), served and checked as phase 12 with 24 launches and reads
     per forward; the prefill drill at one repeat's attn_swa wk (the
     KV-cache write), the decode drill at one repeat's rec in_x (it feeds
     both the conv tail and h);
  14. MusicGen-large at full width and 3 of its 48 layers in bf16
     (attention and gelu FFN, 4 codebooks of 2048 tokens summed on input,
     the untied 2048 x 8192 head; random params drawn on the card from a
     seed), served as phase 12 with prompts of (16-128, 4) tokens and
     K-list tokens out (its sessions timed in LATE_TIMED_ROUNDS rounds): 22
     launches and reads per forward, every
     codebook's served token teacher-forced within the bounds of phase
     12; the prefill drill at one repeat's attention wk, the decode drill
     at one repeat's FFN up;
  3f. (after 3e) the group-axis launches of abft_matmul_detect and
     abft_matmul, one launch for all 384 experts of Kimi-K2 at
     its expert shapes (gate/up 7168 x 2048, down 2048 x 7168) in bf16,
     at 1, 2 and 3 rows per expert (a decode step's capacity, the prefill
     buckets'): flags equal to the plain version's and clear on exact
     per-expert checksums, +1e4 at one element of one expert flagging
     exactly its chunk, O bitwise equal to 384 2-D launches and between
     the two kernels, within one bf16 ulp plus the fp32 summation noise
     (eps32 sqrt(K) sum |d w|) of the plain version; device ms
     of the launch, of the 384 2-D launches, of torch.bmm and of the plain
     versions beside the bound (11.3 GB of experts a launch);
  3g. (after 3f) abft_matmul_detect and abft_matmul at Kimi-K2's 16
     plain-matmul sites per forward (KIMI_SITES, the fp32 router 7168 x
     384 on the fp32 route, the 7168 x 163840 head) at 8-128 rows,
     checked as phase 3c;
  15. Kimi-K2 at full width and 2 of its 61 layers in bf16 (the dense
     prefix layer, then attention and a moe block of 384 experts, top-8,
     with a shared expert; 19.58 G params drawn on the card from a seed),
     served as phase 6 serves SmolLM-360M with the grouped expert GEMMs on
     their plain route: 16 detect launches and 1 host read per deferred
     forward, per_layer's same tokens with 19 reads (16 sites and 3
     grouped), zero flags, no echo; teacher-forced with the session's
     batch composition (the same slots, buckets and admissions), the
     routed expert sets of the two routes compared and, over the forwards
     where they agree, every served token within twice the routes' logit
     gap there plus 0.1 of the unprotected top (a differing forward's
     margins printed apart);
     decode steps timed against the unprotected session over one wave of
     the 8 slots (the first 8 requests, 32 tokens each), a profile of
     one, the per-call expert re-encode's device ms; drills at the
     repeat's attention wk (prefill), the fp32 router (decode: the
     corrected routing is the clean run's) and the shared expert's down;
     then a prefill with the grouped entries pinned to the group-axis
     kernels in both modes (3 grouped launches, flags clear); peak memory
     under 70 GiB;
  16. training through the ssm, rec and moe blocks at full width, bf16
     params, remat on, warmup 1, lr 1e-3 (1e-4 for Kimi-K2), 6 steps
     over three cycled batches (train_cell): Mamba2-1.3B at 16 of its 48
     layers with AdamW, batch 8 x 256 in 2 microbatches;
     RecurrentGemma-2B at 3 of 26 layers the same;
     Kimi-K2 at 2 of 61 layers with 64 of its 384 experts and Adafactor,
     batch 4 x 128: every report clean, the loss falling, no kernel
     launched; one step's new params bitwise its abft=False twin's; +1e4
     drills in one step at one repeat's in_proj,
     rec in_x, the fp32 router and the experts' gate, under remat:
     detected, corrected with residual 0, counted by StepRunner, the loss
     within rtol 1e-4 of the clean step's, the new params bitwise the
     clean ones or their largest difference printed; remat on against off
     bitwise (Mamba2-1.3B at 4 layers), peak memory of each; step ms, host
     reads (the recompute's apart), peak memory under 70 GiB and a
     profile of one step;
  3h. (after 3g) both bf16 kernels at one rank's local GEMMs of Yi-9B on
     model 2 (wq 4096 x 2048, wk/wv 4096 x 256 re-encoded from the
     shard, the row-parallel wo and down halves, gate/up's 5504 columns
     in 688-wide chunks, the head's 32,000 vocabulary columns) at 8 and
     128 rows, checked as 3c;
  3i. (after 3h) both bf16 kernels at one rank's local GEMMs of the ssm
     and rec blocks on model 2 (Mamba2-1.3B's in_proj 2048 x 4256 and
     out_proj 2048 x 2048, RecurrentGemma-2B's gate_a 2560 x 1280, the
     shape of in_x, in_gate, gate_i and wq too) at 8 and 128 rows,
     checked and timed as 3c;
  17. (after 3i, before 4) the (data, model) mesh: Yi-9B at full width
     (d 4096, 32 query heads on 4 KV heads of 128, d_ff 11008, untied
     64,000 head, bf16) on a (2, 2) mesh of four ranks, child processes
     that share the card through gloo on CUDA tensors (launch.mesh
     .run_ranks; no number of it is a multi-card speed). 17a serves 4 of
     its 48 layers (params drawn on the card from a seed, each rank
     keeping its shard; the plan sharded by ProtectionPlan.shard) with
     phase 6's traffic, deferred, the kernels pinned: 29 detect launches
     and 1 host read per forward per rank, per_layer's same tokens, the
     served tokens within DELTA of the unsharded unprotected forward's
     top, +1e3 at rank 1's row-parallel wo partial detected, corrected
     and attributed to slot 3's request with the clean tokens; the decode
     step against the unsharded session's. 17b trains 2 layers (fp32
     AdamW, lr 1e-3, warmup 0, 8 x 256 in 2 microbatches, remat on, 3
     steps) against the unsharded steps, which run after the mesh's ranks
     have left the card: each step's loss within YI_LOSS_TOL, each leaf's
     update within YI_UPDATE_TOL of the unsharded update, and each param
     within the JAX test's 2e-2, with a half-batch and an unchanged-state
     control read beside them; replicated leaves bitwise across ranks;
     +1e3 at rank 1's ffn/up shard corrected, its loss and new params
     bitwise the clean step's; the card's memory in use by every process
     under MESH_PEAK_GIB. 17c: a (1, 1) NCCL mesh serving yi-9b-smoke's
     widths in bf16 bitwise the unsharded session (tokens, counters,
     launches, logits; the mesh's collectives are no-ops on axes of one
     rank, so it checks NCCL's set-up, plus one all_reduce by hand), in
     the process that then runs the unsharded training references;
  18. (in 17's ranks, after 17a/b) the ssm and rec families and
     context-parallel decode on the same mesh. 18a serves RecurrentGemma-
     2B at full width (d 2560, 10 query heads on 1 KV head of 256, lru
     width 2560, d_ff 7680, window 2048, the tied 256,000 head scaled as
     phase 13's, bf16) at 6 of its 26 layers with phase 6's traffic,
     deferred, the kernels pinned: 47 detect launches and 1 read per
     forward per rank, per_layer's same tokens, +1e3 at rank 1's gate_a
     row and at its wo partial corrected at slot 3 only with the clean
     tokens, the bf16 tokens within twice the routes' gap plus DELTA of
     the unsharded unprotected top and a float32 twin served on the mesh
     within DELTA. 18b decodes one 2,600-token prompt with 32 new tokens
     on 1 slot of 4,096 positions: the slots do not divide the data
     axis, so each data rank holds its (1, 2048, 1, 256) block of every
     KV cache, writes only its own positions and merges its softmax
     partials over 'data'; 47 launches and 1 read per forward, the
     tokens' teacher-forced margin within DELTA of the unsharded
     session's on the same prompt, the decode step against the
     unsharded one. 18c serves Mamba2-1.3B at full width (d 2048, state
     128, 64 heads of 64) at 4 of 48 layers, as 18a with a drill at rank
     1's in_proj shard. 18d trains RecurrentGemma-2B at 3 layers and
     Mamba2-1.3B at 2 as 17b trains Yi-9B (each cell its loss limit,
     both controls caught). The card's memory in use stays under
     MESH_PEAK_GIB through 17 and 18.
It then prints the card's name and power limit, one {"kernels": [...]}
line, and as the last line {"ok": true, "device": {...}}. `--json PATH`
also writes the run's details (per-shape kernel times, per-layer scores,
profiles, serving counters and timings) to PATH. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
SEED = 0
BATCH, IMG = 8, 224
# the serving slice: SmolLM-360M at full width, bf16
SERVE_ARCH = "smollm-360m"
SLOTS, MAX_LEN = 8, 256
N_REQ, GEN, PROMPT_LENS = 16, 32, (16, 128)
# trials per cell of the campaign's whole grid (3 layers x 5 schemes x
# every arm; 100 leaves the training phase room in the call's time) and
# of the paper grid
GRID_TRIALS = 100
PAPER_TRIALS = 1000
# card vs CPU: trials per arm of each layer under scheme full
CMP_TRIALS = 64
# phase 8's parts, one child process each (start_campaign): a layer of
# the paper grid, layers of the whole grid, the card-vs-CPU replay
CAMPAIGN_PARTS = ("paper:matmul", "paper:conv", "grid:matmul,conv",
                  "grid:transformer_gemm", "vs_cpu")
# seconds from their start after which a part still running fails the
# phase (the slowest took 197 s beside phases 6-7b)
CAMPAIGN_LIMIT_S = 600
# rounds in turns of phase 6's three timed sessions and phase 10's driver
# against the session, and samples per forward in phase 5b's turns: cut
# from 3 and 5 so that the run with phase 11 stays within its time on a
# card whose host is slow (PERF.md §6)
TIMED_ROUNDS = 2
# the same for the timed sessions of phases 12-15, cut to one round to
# keep the whole run near 600 s with phases 15 and 18 in it
LATE_TIMED_ROUNDS = 1
FAULTED_REPS = 3
# card vs CPU, the campaign's 64 trials per arm and layer: the share of
# trials whose corrected_by may differ (which rung first verifies a fix
# hangs on the order of a sum, ROADMAP 3.4); 9 of 1,728 were seen
RUNG_MISMATCH_SHARE = 0.01
DELTA = 0.1                    # teacher-forced logit margin
DEVICE = "cuda"
# (label, K, M, W read transposed, launches per forward) of the distinct
# GEMM shapes of one SmolLM-360M forward: 32 layers of wq/wo, wk/wv,
# gate/up and down, then the tied head read in place
SERVE_SITES = (("wq/wo", 960, 960, False, 64), ("wk/wv", 960, 320, False, 64),
               ("gate/up", 960, 2560, False, 64),
               ("down", 2560, 960, False, 32),
               ("head", 960, 49152, True, 1))
# the row counts the session gives them: a decode step's slots and the
# prefill buckets; all are checked, the first and last also timed
SERVE_ROWS = (SLOTS, 16, 32, 64, 128)
TIMED_ROWS = (SLOTS, 128)
# the training slice: SmolLM-360M at full width, bf16 params and fp32
# AdamW state, batch 8 x seq 256 in two microbatches
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS, TRAIN_LR = 8, 256, 2, 12, 1e-3
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ   # rows of a training GEMM (11a)
DRIVER_LAYERS = 4                      # depth of the driver's runs (11c)
# depth of phase 10's driver and of phase 11b's train step: SmolLM-360M's
# first layers at full width (cut from 32 to 4 and 8 to make room for
# phase 12, then to 2 and 4 for phase 14)
DRIVER_PHASE_LAYERS = 2
TRAIN_LAYERS = 4
# the Mamba-2 slice: Mamba2-1.3B at full width and depth, bf16, served as
# phase 6 serves SmolLM-360M; (label, K, M, launches per forward) of its
# GEMM sites (48 layers of in_proj and out_proj, the untied head) and the
# row counts phase 3c holds them at: a decode step's slots, an odd exact
# prefill (the scheduler does not bucket recurrent models) and 128
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_SITES = (("in_proj", 2048, 8512, False, 48),
               ("out_proj", 4096, 2048, False, 48),
               ("head", 2048, 50280, False, 1))
MAMBA_ROWS = (SLOTS, 97, 128)
# depth of phase 12's Mamba2-1.3B: its first layers at full width (cut
# from 48 to 8 to make room for phase 13, then to 4 for phase 14); phase
# 3c keeps the full-depth counts
MAMBA_LAYERS = 4
# the RG-LRU slice: RecurrentGemma-2B at full width and depth, bf16, served
# as phase 12 serves Mamba2-1.3B; its distinct GEMM shapes with their
# launches per forward (26 layers: 18 rec blocks of in_x, in_gate, gate_a,
# gate_i and out beside 8 attn_swa blocks' wq and wo at 2560 x 2560, their
# wk and wv on one KV head of 256, 26 gelu FFNs, the tied head read in
# place) and the row counts phase 3d holds them at
RG_ARCH = "recurrentgemma-2b"
RG_SITES = (("rec/*, wq/wo", 2560, 2560, False, 106),
            ("wk/wv", 2560, 256, False, 16),
            ("gate/up", 2560, 7680, False, 52),
            ("down", 7680, 2560, False, 26),
            ("head", 2560, 256000, True, 1))
RG_ROWS = (SLOTS, 97, 128)
# the tied table of phase 13's random RecurrentGemma-2B is scaled by this:
# at its drawn scale the embedding (times sqrt(d_model)) can outweigh the
# blocks' outputs, and greedy decoding then echoes the last prompt token
# whatever the recurrent state holds (as the reduced model does on the
# CPU); scaled, the served tokens depend on the state
RG_TABLE_SCALE = 1 / 16
# depth of phase 13's RecurrentGemma-2B: one repeat of its pattern (rec,
# ffn, rec, ffn, attn_swa, ffn) at full width (cut from 26 to two repeats
# to make room for phase 14, then to one for phase 16); phase 3d keeps
# the full-depth counts
RG_LAYERS = 3
# the multi-codebook slice: MusicGen-large at full width and depth, bf16,
# served as phase 12 serves Mamba2-1.3B; its distinct GEMM shapes with
# their launches per forward (48 layers of wq, wk, wv and wo on 32 heads
# of 64, 48 gelu FFNs, the untied head over 4 codebooks of 2048) and the
# row counts phase 3e holds them at: a decode step's slots and the
# session's prefill buckets (attention-only: prompts are padded)
MUSICGEN_ARCH = "musicgen-large"
MUSICGEN_SITES = (("wq/wk/wv/wo", 2048, 2048, False, 192),
                  ("gate/up", 2048, 8192, False, 96),
                  ("down", 8192, 2048, False, 48),
                  ("head", 2048, 8192, False, 1))
MUSICGEN_ROWS = SERVE_ROWS
# depth of phase 14's MusicGen-large: its first 3 layers at full width
# (cut from 48 to 24, then to 12 to make room for phase 16, to 6 for
# phase 17 and to 3 for phase 18, keeping the whole run near ten
# minutes); phase 3e keeps the full-depth counts
MUSICGEN_LAYERS = 3
# the MoE slice: Kimi-K2 at full width and 2 of its 61 layers (the dense
# prefix layer, then one repeat of attention and a moe block of 384
# experts, top-8, and a shared expert), bf16, served as phase 6 serves
# SmolLM-360M; its plain-matmul sites per forward (prefix attention and
# FFN 7, the repeat's attention 4, fp32 router 1, shared expert 3, the
# untied head) and its grouped ones (the experts' gate, up and down)
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_LAYERS = 2
MOE_MATMUL_SITES = 16
MOE_GROUPED_SITES = 3
# phase 3f: the group-axis kernels at its expert GEMMs, (label, K, M,
# launches per forward), G = 384, at the rows per expert the session's
# capacity gives: 1 in a decode step (round(1.25 x 8 x 8 / 384) -> 1), 1,
# 1, 2 and 3 in the prefill buckets of 16, 32, 64 and 128 tokens
MOE_EXPERTS = 384
# phase 3g: the distinct shapes of its 16 plain-matmul sites per forward
# (label, K, M, W read transposed, launches per forward[, operand type]):
# the prefix's and the repeat's attention (64 heads and 8 KV heads of
# 112), the prefix FFN's and the shared expert's gate/up and down (d_ff
# 2048 both), the router in fp32 and the untied head
KIMI_SITES = (("wq/wo", 7168, 7168, False, 4),
              ("wk/wv", 7168, 896, False, 4),
              ("ffn, shared: gate/up", 7168, 2048, False, 4),
              ("ffn, shared: down", 2048, 7168, False, 2),
              ("router", 7168, 384, False, 1, "float32"),
              ("head", 7168, 163840, False, 1))
MOE_SHAPES = (("gate/up", 7168, 2048, 2), ("down", 2048, 7168, 1))
MOE_ROWS = (1, 2, 3)
MOE_TIMED_ROWS = (1, 3)
# phase 16: training through the ssm, rec and moe blocks, bf16 params,
# remat on, warmup 1, lr TRAIN_LR, TRAIN16_STEPS steps over three cycled
# batches. 16a Mamba2-1.3B at full width and MAMBA_TRAIN_LAYERS, AdamW, batch
# TRAIN_BATCH x TRAIN_SEQ in TRAIN_MB microbatches (remat on and off held
# bitwise at REMAT_CHECK_LAYERS layers); 16b RecurrentGemma-2B at full
# width and RG_TRAIN_LAYERS layers, as 16a; 16c Kimi-K2 at full width,
# MOE_LAYERS layers and MOE_TRAIN_EXPERTS of its 384 experts (params plus
# gradients of all 384 come to 78 GB in bf16), Adafactor, batch
# MOE_TRAIN_BATCH x MOE_TRAIN_SEQ in one microbatch
TRAIN16_STEPS = 6
REMAT_CHECK_LAYERS = 4
RG_TRAIN_LAYERS = 3                    # one repeat of its pattern
# 16a's depth: cut from 48 to 16 (and 16b from 6 to 3, phase 14 from 6 to
# 3 layers, phases 12 and 13 to one timed round) to make room for phase 18
MAMBA_TRAIN_LAYERS = 16
MOE_TRAIN_EXPERTS = 64
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 128
# 16c's learning rate: at 1e-3 the first Adafactor steps (about sign(g)
# for the unfactored 7168 x 64 fp32 router) move each router logit by ~6
# at d 7168, the routing collapsed (aux 1.2 -> 17) and the loss rose
MOE_TRAIN_LR = 1e-4
TRAIN16_PEAK_GIB = 70.0
# phase 17: the (data, model) mesh. Yi-9B at full width (d 4096, 32 query
# heads on 4 KV heads of 128, d_ff 11008, an untied 64000 head, bf16) on
# a (data 2, model 2) mesh of four ranks: four processes that share the
# one card, their collectives on gloo over CUDA tensors (NCCL refuses two
# ranks on one device). 17a serves it at YI_LAYERS of its 48 layers, 17b
# trains it at YI_TRAIN_LAYERS; 17c serves yi-9b-smoke's widths in bf16 on
# a (1, 1) NCCL mesh
YI_ARCH = "yi-9b"
YI_MESH = (2, 2)
YI_LAYERS = 4                  # cut from 8 to make room for phase 18
YI_TRAIN_LAYERS = 2
YI_TRAIN_BATCH, YI_TRAIN_SEQ, YI_TRAIN_MB = 8, 256, 2
YI_TRAIN_STEPS = 3
YI_TRAIN_LR = 1e-3
YI_TRAIN_TOL = 2e-2            # the JAX package's sharded-step tolerance
# 17b's tighter gates, each set between the sound runs' largest reading
# and the controls' (yi_train_reference; PERF.md gives both): the loss of
# each step within YI_LOSS_TOL of the unsharded step's, and each leaf's
# update within YI_UPDATE_TOL of the unsharded update (Frobenius, relative)
YI_LOSS_TOL = 2.5e-3
YI_UPDATE_TOL = 0.4
MESH_TIMEOUT_S = 900
# the card's memory in use by every process during 17a/b, the unsharded
# reference apart: four ranks' training at ~12.2 GiB allocated each
# (AdamW's fp32 moments are held whole on both data ranks, twice while
# the functional update runs): 54.7-57.3 GiB in all when measured, and
# the limit leaves room for the run-to-run spread of that reading
MESH_PEAK_GIB = 64.0
# phase 3h: one rank's local GEMMs of Yi-9B at model 2 (label, K, M, W read
# transposed, launches per forward at YI_LAYERS layers): wq's 16 heads,
# wk/wv's 2 KV heads (256 columns: the full leaf's one 512-wide chunk
# does not divide, so the rank's plan encodes its own), wo's and down's
# row-parallel halves, gate/up's 5504 columns in 8 of the leaf's 688-wide
# chunks, the head's 32000 vocabulary columns
YI_SHARD_SITES = (("wq", 4096, 2048, False, YI_LAYERS),
                  ("wk/wv", 4096, 256, False, 2 * YI_LAYERS),
                  ("wo", 2048, 4096, False, YI_LAYERS),
                  ("gate/up", 4096, 5504, False, 2 * YI_LAYERS),
                  ("down", 5504, 4096, False, YI_LAYERS),
                  ("head", 4096, 32000, False, 1))
YI_SHARD_ROWS = (8, 128)
# phase 18: the ssm and rec families and context-parallel decode on the
# same (2, 2) mesh, in the ranks of phase 17. 18a serves RecurrentGemma-2B
# at full width (d 2560, 10 query heads on 1 KV head of 256, lru width
# 2560, d_ff 7680, window 2048, the tied 256,000 head scaled by
# RG_TABLE_SCALE, bf16) at RG_MESH_LAYERS of its 26 layers with phase 6's
# traffic; 18b decodes one CP_PROMPT-token prompt with CP_GEN new tokens
# on 1 slot of CP_MAX_LEN positions, context-parallel (each data rank
# holds 2048 of them, so every decode window crosses the boundary); 18c
# serves Mamba2-1.3B (d 2048, state 128, 64 heads of 64) at
# MAMBA_MESH_LAYERS of its 48 layers; 18d trains both as 17b trains Yi-9B
RG_MESH_LAYERS = 6
MAMBA_MESH_LAYERS = 4
CP_MAX_LEN, CP_PROMPT, CP_GEN = 4096, 2600, 32
# (name, arch, layers, drill site, loss limit): RecurrentGemma-2B's loss
# at the drawn tied table is ~20-31, and its sound loss gap read up to
# 1.9e-3 in the first run (PR 25), its half-batch control 2.9e-3 at step
# 0 and 0.075-2.2 after: its limit sits at 2.6x the sound reading, under
# every control's largest; Mamba2-1.3B's read 1.35e-3 sound, 5.4e-3 and
# more for the controls, so 17b's limit holds it
REC_TRAIN_CELLS = (("rg", RG_ARCH, 3, "stages/b0_rec/rec/in_x", 5e-3),
                   ("mamba", MAMBA_ARCH, 2, "stages/b0_ssm/ssm/in_proj",
                    YI_LOSS_TOL))
# phase 3i: one rank's local GEMMs of the ssm and rec blocks at model 2
# (label, K, M, W read transposed, launches per forward at phase 18's
# depths): Mamba2-1.3B's in_proj (4256 of its 8512 columns) and out_proj
# (2048 of its 4096 rows), RecurrentGemma-2B's gate_a (1280 of 2560
# columns, the whole conv output in; in_x, in_gate, gate_i and wq's 5
# heads of 256 take the same shape)
REC_SHARD_SITES = (("ssm/in_proj", 2048, 4256, False, MAMBA_MESH_LAYERS),
                   ("ssm/out_proj", 2048, 2048, False, MAMBA_MESH_LAYERS),
                   ("rec/gate_a (in_x, in_gate, gate_i, wq)", 2560, 1280,
                    False, 4 * 2 * RG_MESH_LAYERS // 3 + RG_MESH_LAYERS // 3))
REC_SHARD_ROWS = (8, 128)


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def copies(tensors, min_bytes: float = 128e6, most: int = 256):
    """Enough copies of the input tensors that a round over them reads
    from device memory, not from the 50 MB L2."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    k = int(min(most, max(2, -(-min_bytes // size))))
    return [tuple(t.clone() for t in tensors) for _ in range(k)]


def time_device(fn, args_list, rounds: int = 5) -> float:
    """Device milliseconds per call of fn(*args): one call per entry of
    args_list, captured into one CUDA graph so that no host overhead sits
    between the launches; median over `rounds` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in args_list[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / len(args_list))
    del graph
    return statistics.median(per_call)


def time_turns(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Milliseconds of each fn() + synchronize on the host clock, `reps`
    samples each. The functions take turns within each round, in an
    order rotated from round to round, so that a drift of the shared host
    falls on all of them alike."""
    import torch
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    keys, times = list(fns), {k: [] for k in fns}
    for r in range(reps):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def time_host(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Median milliseconds of each fn() + synchronize (time_turns)."""
    return {k: statistics.median(v)
            for k, v in time_turns(fns, reps, warmup).items()}


def bound_ms(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def conv_output_shapes(cfg):
    """(N, M, E, E) of every conv output of the forward, in order."""
    shapes, img = [], cfg.img
    for spec in cfg.convs:
        e = (img + 2 * spec.pad - spec.kernel) // spec.stride + 1
        shapes.append((BATCH, cfg.scaled(spec.out_ch), e, e))
        img = e // spec.pool if spec.pool else e
    return shapes


# a trace that records the host side but none of the card's activity
# measures nothing: CUPTI now and then hands the profiler no record of a
# kernel that ran, so such a trace is taken again
TRACE_TRIES = 3
# the host calls by which a kernel, a copy or a fill reaches the card, as
# the profiler names them (runtime API and driver API)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemsetAsync",
                "cudaMemcpyAsync", "cudaMemset", "cudaMemcpy")


def device_trace(fn):
    """One call of fn under torch.profiler (CPU and CUDA activity), after a
    warm-up call: (the device-side events - a kernel's own record, not the
    aten op that launched it -, the host's launch calls by name with their
    counts, the call's wall ms). A trace that holds no device event is
    taken again, up to TRACE_TRIES times; the last one is returned
    whatever it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")]
        calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
        if dev or attempt == TRACE_TRIES:
            return dev, calls, wall
        log(f"  (trace {attempt} of {TRACE_TRIES} held no device event, "
            f"launch calls {calls}; tracing again)")


def device_kernels(fn) -> dict:
    """The device kernels one call of fn launches, by name, with their
    counts (device_trace). Where no trace recorded the card's side, the
    host's launch calls of the last one stand in for them, under their
    own names (each is one kernel, copy or fill on the card)."""
    dev, calls, _ = device_trace(fn)
    if dev:
        return {e.key: e.count for e in dev}
    log(f"  ({TRACE_TRIES} traces held no device event: counting the host's "
        f"launch calls {calls})")
    return calls


def check_checksum_reduce(cfg, gen, report):
    """At each conv view: the conv detection sums (one launch, what the
    main path runs) on O and on O rounded to bf16 against their plain
    version, and, through ops.conv_detect_sums, against the plain
    detection pass; the tile-partials entry point on both against its
    plain version. Times per view and per forward: the conv sums, the tile
    partials alone and finished by PyTorch ops as PR 13's main path did,
    the conv sums' plain version, and the two PyTorch calls of the plain
    detection pass (enc @ O, torch.dot)."""
    import torch
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.kernels import ops
    from repro_torch.core import checksums as C
    shapes = conv_output_shapes(cfg)
    names = ("s5", "s6", "s7", "sumsq")
    rows, err_all = [], 0.0
    tot = {k: 0.0 for k in ("ms", "partials_ms", "route_ms", "plain_ms",
                            "library_ms", "bytes", "flops")}
    for shape in sorted(set(shapes), key=shapes.index):
        count = shapes.count(shape)
        layer = shapes.index(shape)
        n, m, e1, e2 = shape
        p = e1 * e2
        o4 = torch.randn(shape, generator=gen, device="cuda")
        o2 = o4.reshape(n * m, p)
        bm, bn = ops.conv_tiles(m, p, on_card=True)
        errs = {}
        for dt, x in (("f32", o4), ("bf16", o4.to(torch.bfloat16))):
            # the tile partials: fp32 reassociation over at most bm*bn terms
            got = CR.checksum_reduce(x.reshape(n * m, p), bm, bn, segments=n)
            want = CR.checksum_reduce_plain(x.reshape(n * m, p), bm, bn,
                                            segments=n)
            torch.cuda.synchronize()
            for name, g, w in zip(("colsum", "rowsum", "sumsq", "wcolsum"),
                                  got, want):
                err = max_err(g, w) if g.shape == w.shape else float("inf")
                tol = 1e-5 * (float(w.abs().max()) + 1.0)
                if not err <= tol:
                    fail(f"checksum_reduce {dt} {shape} {name}: max |err| "
                         f"{err:.3g} > {tol:.3g} (shape {tuple(g.shape)} vs "
                         f"plain {tuple(w.shape)})")
                errs[f"partials_{dt}_{name}"] = err
            # the conv sums: reassociation over up to N*M terms per payload
            # position and N*M*P for the sum of squares
            got = CR.conv_sums(x)
            want = CR.conv_sums_plain(x, bm, bn)
            torch.cuda.synchronize()
            for name, g, w in zip(names, got, want):
                err = max_err(g, w) if g.shape == w.shape else float("inf")
                tol = 1e-4 * (float(w.abs().max()) + 1.0)
                if not err <= tol:
                    fail(f"conv_sums {dt} {shape} {name}: max |err| "
                         f"{err:.3g} > {tol:.3g}")
                errs[f"conv_sums_{dt}_{name}"] = err
        # the main path's route against the plain detection pass it replaces
        for name, g, w in zip(names, ops.conv_detect_sums(o4),
                              C.detect_sums(o4)):
            err = max_err(g, w)
            tol = 1e-4 * (float(w.abs().max()) + 1.0)
            if not err <= tol:
                fail(f"conv_detect_sums {shape} {name}: max |err| {err:.3g} "
                     f"> {tol:.3g}")
            errs["detect_" + name] = err
        err_all = max(err_all, *(v for k, v in errs.items()
                                 if not k.startswith("detect")))
        # inputs cold in L2
        args = copies([o4])
        dev = o4.device
        enc = torch.stack([torch.ones(n * m, device=dev),
                           torch.arange(n, device=dev).float()
                           .repeat_interleave(m),
                           torch.arange(m, device=dev).float().repeat(n)])

        def library(t):
            flat = t.reshape(-1)
            return enc @ t.reshape(n * m, p), torch.dot(flat, flat)

        ms = time_device(CR.conv_sums, args)
        partials_ms = time_device(lambda t: CR.checksum_reduce(
            t.reshape(n * m, p), bm, bn, segments=n, rowsum=False), args)

        def partials_route(t):
            # PR 13's main path: the tile partials, finished by PyTorch ops
            c, _, sq, w = CR.checksum_reduce(t.reshape(n * m, p), bm, bn,
                                             segments=n, rowsum=False)
            return CR.finish_conv_sums(c, sq, w, m, bm)

        route_ms = time_device(partials_route, args)
        plain_ms = time_device(lambda t: CR.conv_sums_plain(t, bm, bn), args)
        lib_ms = time_device(library, args)
        del args
        nbytes = 4.0 * (n * m * p + 3 * p + 1)
        flops = 7.0 * n * m * p
        b, by = bound_ms(nbytes, flops)
        rows.append({"shape": list(shape), "first_layer": f"conv{layer}",
                     "count": count, "ms": ms, "partials_ms": partials_ms,
                     "partials_tiles": [bm, bn],
                     "partials_route_ms": route_ms, "plain_ms": plain_ms,
                     "library_two_calls_ms": lib_ms, "bound_ms": b,
                     "bound_by": by, "max_abs_err": errs})
        log(f"  conv{layer} O{shape} x{count}: conv_sums ms {ms:.4f} "
            f"(tile partials ({bm},{bn}) {partials_ms:.4f}, finished by "
            f"PyTorch ops {route_ms:.4f}) plain "
            f"{plain_ms:.4f} enc@O + torch.dot (two calls) {lib_ms:.4f} "
            f"bound {b:.4f} ({by}); max|err| conv_sums "
            f"{max(v for k, v in errs.items() if k.startswith('conv')):.3g}"
            f" partials "
            f"{max(v for k, v in errs.items() if k.startswith('partials')):.3g}"
            f" vs plain pass "
            f"{max(v for k, v in errs.items() if k.startswith('detect')):.3g}")
        for k, v in (("ms", ms), ("partials_ms", partials_ms),
                     ("route_ms", route_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bytes", nbytes), ("flops", flops)):
            tot[k] += count * v
    b, by = bound_ms(tot["bytes"], tot["flops"])
    # one device kernel per call, at conv0's view
    o4 = torch.randn(shapes[0], generator=gen, device="cuda")
    kernels = device_kernels(lambda: CR.conv_sums(o4))
    if sum(kernels.values()) != 1:
        fail(f"one conv_sums call launched {kernels}")
    report["checksum_reduce"] = {
        "per_shape": rows, "forward_ms": tot["ms"],
        "forward_partials_ms": tot["partials_ms"],
        "forward_partials_route_ms": tot["route_ms"],
        "forward_plain_ms": tot["plain_ms"],
        "forward_library_two_calls_ms": tot["library_ms"],
        "forward_bound_ms": b, "bytes_per_forward": tot["bytes"],
        "device_kernels_per_call": kernels}
    log(f"  per forward (17 launches): conv_sums ms {tot['ms']:.4f} (tile "
        f"partials {tot['partials_ms']:.4f}, finished by PyTorch ops "
        f"{tot['route_ms']:.4f}) plain {tot['plain_ms']:.4f} "
        f"enc@O + torch.dot (two calls) {tot['library_ms']:.4f} bound "
        f"{b:.4f} ({by}), {tot['bytes'] / 1e6:.1f} MB; device kernels per "
        f"call {kernels}")
    return {"name": "checksum_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/checksum_reduce.cu",
            "replaces": "src/repro/kernels/checksum_reduce.py:37",
            "max_abs_err": err_all, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
            # the plain detection pass takes two PyTorch calls (timed above
            # as library_two_calls_ms); no one call gives these sums
            "library_ms": None}


def check_abft_matmul(cfg, gen, report):
    import torch
    from repro_torch.core.protected import pick_chunk
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_detect_ref, abft_matmul_ref
    fc_k = cfg.scaled(cfg.convs[-1].out_ch)
    shapes = {"fc": (BATCH, fc_k, cfg.num_classes),
              "ragged": (37, 520, 1000)}
    out = {}
    for label, (n, k, m) in shapes.items():
        d = torch.randn((n, k), generator=gen, device="cuda")
        w = torch.randn((k, m), generator=gen, device="cuda") * k ** -0.5
        if label == "fc":
            # the partial tiles protected_matmul asks for at this site
            rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
            gm = ops._tile(n, ops._tile(rb, 256))
            gn = ops._tile(m, ops._tile(cb, 256))
        else:
            gm, gn = ops._granularity(n, k, m, 256, 256, 256)
        o, parts = AM.abft_matmul(d, w, gm, gn)
        o_ref, parts_ref = abft_matmul_ref(d, w, gm, gn)
        torch.cuda.synchronize()
        errs = {"o": max_err(o, o_ref)}
        # fp32 reassociation: K-step order differs from cuBLAS
        if not torch.allclose(o, o_ref, rtol=1e-5, atol=1e-4 * k ** 0.5):
            fail(f"abft_matmul {label} O: max |err| {errs['o']:.3g}")
        for name, g, r in zip(("colsum", "rowsum", "sumsq"), parts[:3],
                              parts_ref[:3]):
            if g.shape != r.shape:
                fail(f"abft_matmul {label} {name}: shape {tuple(g.shape)} "
                     f"vs plain {tuple(r.shape)}")
            errs[name] = max_err(g, r)
            if not torch.allclose(g, r, rtol=1e-5, atol=1e-3 * k ** 0.5):
                fail(f"abft_matmul {label} {name}: max |err| "
                     f"{errs[name]:.3g}")
        if label == "fc":
            # the partial granularity must divide the fc's detection
            # chunking, so the partials recombine without the element path
            if rb % gm or cb % gn:
                fail(f"fc partial tiles {(gm, gn)} do not divide the chunk "
                     f"{(rb, cb)}")
            ops.chunk_sums_from_partials(parts, rb, cb)   # raises if not
            # the detect entry point on the same mainloop: one kernel, O
            # bitwise abft_matmul's, flags the plain version's (clear on
            # exact checksums)
            cs, _ = exact_chunk_checksums(d, w, rb, cb)
            o_d, flag, _ = AM.abft_matmul_detect(d, w, *cs, rb, cb, 1e-3,
                                                 1e-3)
            flag_r = abft_matmul_detect_ref(d, w, *cs, rb, cb, 1e-3, 1e-3)[1]
            torch.cuda.synchronize()
            if not torch.equal(o_d, o):
                fail(f"fc: abft_matmul_detect and abft_matmul round O "
                     f"differently (max |diff| {max_err(o_d, o):.3g})")
            if not torch.equal(flag, flag_r) or int(flag.sum()):
                fail(f"fc detect flags {flag.tolist()} vs plain "
                     f"{flag_r.tolist()}")
            kernels = device_kernels(lambda: AM.abft_matmul_detect(
                d, w, *cs, rb, cb, 1e-3, 1e-3))
            if sum(kernels.values()) != 1:
                fail(f"one f32 abft_matmul_detect call launched {kernels}")
            report["fc_detect_device_kernels_per_call"] = kernels
            t = AM.kernel_tiling(n, k, m, torch.float32, cb)
            log(f"  fc tiling: tile {t.tm}x{t.tn}, {t.splits} splits, "
                f"{t.tiles(n, m) * t.splits} blocks; abft_matmul_detect: one "
                f"device kernel per call {kernels}")
        args = copies([d, w])
        ms = time_device(lambda a, b: AM.abft_matmul(a, b, gm, gn), args)
        plain_ms = time_device(lambda a, b: abft_matmul_ref(a, b, gm, gn),
                               args)
        lib_ms = time_device(torch.matmul, args)
        del args
        nbytes = 4.0 * (n * k + k * m + n * m + -(-n // gm) * m
                        + n * -(-m // gn) + -(-n // gm) * -(-m // gn))
        flops = 2.0 * n * k * m + 4.0 * n * m
        b, by = bound_ms(nbytes, flops)
        out[label] = {"shape": [n, k, m], "tiles": [gm, gn], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b, "bound_by": by, "max_abs_err": errs}
        log(f"  abft_matmul {label} ({n}x{k})@({k}x{m}) tiles ({gm},{gn}): "
            f"ms {ms:.4f} plain {plain_ms:.4f} torch.matmul {lib_ms:.4f} "
            f"bound {b:.4f} ({by}) max|err| "
            f"{max(errs.values()):.3g}")
    report["abft_matmul"] = out
    fc = out["fc"]
    return {"name": "abft_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/abft_matmul.cu",
            "replaces": "src/repro/kernels/abft_matmul.py:54",
            "max_abs_err": max(max(v["max_abs_err"].values())
                               for v in out.values()),
            "ms": fc["ms"], "plain_ms": fc["plain_ms"],
            "bound_ms": fc["bound_ms"], "bound_by": fc["bound_by"],
            "library_ms": fc["library_ms"]}


# --------------------------------------------------------------------------
# phase 3b: the serving path's kernels at its own shapes (bf16)
# --------------------------------------------------------------------------

def exact_chunk_checksums(d, w, rb, cb):
    """c5/c6/c7/absdot per (rb x cb) chunk of the fp32 product (the
    offline-exact predictions a clean chunk must meet), and the chunks'
    sums of squares."""
    from repro_torch.kernels.ref import chunk_sums_ref
    d32, w32 = d.float(), w.float()
    c5, c6, c7, sq = chunk_sums_ref(d32 @ w32, rb, cb)
    absdot = chunk_sums_ref(d32.abs() @ w32.abs(), rb, cb)[0]
    return [c5, c6, c7, absdot], sq


def within_bf16_ulp(a, b) -> bool:
    """Every element of a within one bf16 ulp of b (two roundings of fp32
    sums that differ by reassociation only)."""
    a32, b32 = a.float(), b.float()
    return bool(((a32 - b32).abs() <= b32.abs() * 2.0 ** -7 + 1e-6).all())


def wrapper_host_us(AM, reps: int = 200, rounds: int = 5) -> dict:
    """Host microseconds of one call of each bf16 wrapper of the kernel
    module AM at the decode wq shape, (8 x 960) @ (960 x 960): `reps`
    calls back to back without a synchronize (issue time: checks,
    allocations, the ctypes launch), median over `rounds`."""
    import torch
    from repro_torch import fp32_ieee
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    d = torch.randn((8, 960), generator=gen, device="cuda").to(bf16)
    w = (torch.randn((960, 960), generator=gen, device="cuda")
         * 960 ** -0.5).to(bf16)
    cs = [torch.randn((1, 1), generator=gen, device="cuda") for _ in range(4)]
    fns = {"abft_matmul_detect": lambda: AM.abft_matmul_detect(
               d, w, *cs, 8, 960, 1e-3, 1e-3),
           "abft_matmul": lambda: AM.abft_matmul(d, w, 8, 256)}
    out = {}
    with torch.no_grad(), fp32_ieee():
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                per.append((time.perf_counter() - t0) * 1e6 / reps)
                torch.cuda.synchronize()
            out[name] = statistics.median(per)
    return out


def check_serving_kernels(gen, report):
    """abft_matmul_detect against its plain version, and abft_matmul on
    bf16 operands, at every GEMM shape of a decode step (8 rows) and a
    128-row prefill of SmolLM-360M: flags exact, scores and O allclose, O
    bitwise equal between the two kernels, exact checksums clear and a c5
    shifted by 10 tau flagging exactly its chunk. Times per decode step
    and per prefill sum the shapes by their launch counts."""
    import torch
    from repro_torch import fp32_ieee
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core.thresholds import tau_scalar_coeffs
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_detect_ref, abft_matmul_ref
    bf16 = torch.bfloat16
    rows, err_det, err_mm = [], 0.0, 0.0
    tot = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
               "flops": 0.0, "mm_ms": 0.0, "mm_plain_ms": 0.0,
               "mm_bytes": 0.0, "mm_flops": 0.0}
           for n in TIMED_ROWS}
    with torch.no_grad(), fp32_ieee():
        for n in SERVE_ROWS:
            for label, k, m, transposed, count in SERVE_SITES:
                d = torch.randn((n, k), generator=gen, device="cuda").to(bf16)
                store = (torch.randn((m, k) if transposed else (k, m),
                                     generator=gen, device="cuda")
                         * k ** -0.5).to(bf16)
                view = (lambda t: t.T) if transposed else (lambda t: t)
                w = view(store)
                rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
                bm, bn = ops._tile(rb, 256), ops._tile(cb, 256)
                tiling = AM.kernel_tiling(n, k, m, bf16, cb)
                blocks = tiling.tiles(n, m) * tiling.splits
                cs, sq = exact_chunk_checksums(d, w, rb, cb)
                ta, tb = tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
                o, flag, score = AM.abft_matmul_detect(d, w, *cs, rb, cb, ta, tb)
                o_r, flag_r, score_r = abft_matmul_detect_ref(d, w, *cs, rb, cb,
                                                              ta, tb)
                o_mm, parts = AM.abft_matmul(d, w, bm, bn)
                o_mr, parts_r = abft_matmul_ref(d, w, bm, bn)
                torch.cuda.synchronize()
                what = f"{label} ({n}x{k})@({k}x{m})"
                if not torch.equal(flag, flag_r) or int(flag.sum()):
                    fail(f"abft_matmul_detect {what}: flags {flag.tolist()} vs "
                         f"plain {flag_r.tolist()}")
                # a score is |c - s| / tau; the kernel's s and the plain
                # version's differ by fp32 reassociation over K products and
                # rb*cb terms, whose random-walk size in units of tau (at
                # least tau_a * sqrt(sumsq)) is eps32 (sqrt K + sqrt(rb cb))
                # / tau_a
                noise = 2.0 ** -24 * (k ** 0.5 + (rb * cb) ** 0.5) / ta
                e_s = max_err(score, score_r)
                if not torch.allclose(score, score_r, rtol=1e-3, atol=noise):
                    fail(f"abft_matmul_detect {what}: clean scores differ by "
                         f"{e_s:.3g} (limit {noise:.3g})")
                if not within_bf16_ulp(o, o_r):
                    fail(f"abft_matmul_detect {what}: O beyond one bf16 ulp of "
                         f"the plain version (max |err| {max_err(o, o_r):.3g})")
                if not torch.equal(o, o_mm):
                    fail(f"{what}: abft_matmul_detect and abft_matmul round O "
                         f"differently (max |diff| {max_err(o, o_mm):.3g})")
                if not within_bf16_ulp(o_mm, o_mr):
                    fail(f"abft_matmul bf16 {what}: O beyond one bf16 ulp")
                e_p = 0.0
                for g_, r_, nm in zip(parts[:3], parts_r[:3],
                                      ("colsum", "rowsum", "sumsq")):
                    if g_.shape != r_.shape or not torch.allclose(
                            g_, r_, rtol=1e-5, atol=1e-3 * k ** 0.5):
                        fail(f"abft_matmul bf16 {what} {nm}: max |err| "
                             f"{max_err(g_, r_):.3g}")
                    e_p = max(e_p, max_err(g_, r_))
                # c5, c6 or c7 of the last chunk shifted by 10 of its taus:
                # that chunk alone flags, with the plain version's score
                # (about 10, so rtol 1e-3 holds the threshold and the
                # division to the plain version's)
                tau5 = ta * float(sq[-1, -1].sqrt()) + tb * float(cs[3][-1, -1])
                e_t = 0.0
                for q, wq in enumerate((1, max(rb - 1, 1), max(cb - 1, 1))):
                    ct = [c.clone() for c in cs]
                    ct[q][-1, -1] += 10.0 * tau5 * wq
                    _, flag_t, score_t = AM.abft_matmul_detect(d, w, *ct, rb,
                                                               cb, ta, tb)
                    _, flag_tr, score_tr = abft_matmul_detect_ref(
                        d, w, *ct, rb, cb, ta, tb)
                    want = torch.zeros_like(flag_t)
                    want[-1, -1] = 1
                    e_t = max(e_t, max_err(score_t, score_tr))
                    if not (torch.equal(flag_t, want)
                            and torch.equal(flag_tr, want)
                            and torch.allclose(score_t, score_tr, rtol=1e-3,
                                               atol=noise)
                            and 9.9 < float(score_tr[-1, -1]) < 10.1):
                        fail(f"abft_matmul_detect {what}: c{q + 5} shifted by "
                             f"10 tau flags {flag_t.tolist()} (plain "
                             f"{flag_tr.tolist()}), score "
                             f"{float(score_t[-1, -1]):.6g} vs plain "
                             f"{float(score_tr[-1, -1]):.6g}")
                err_det = max(err_det, e_s, e_t, max_err(o, o_r))
                err_mm = max(err_mm, max_err(o_mm, o_mr), e_p)
                tile_txt = (f"tile {tiling.tm}x{tiling.tn}, {tiling.splits} "
                            f"splits, {blocks} blocks")
                row = {"site": label, "shape": [n, k, m], "chunks": [rb, cb],
                       "w_transposed": transposed, "per_forward": count,
                       "tiling": {**tiling._asdict(), "blocks": blocks},
                       "clean_score": float(score.max()),
                       "max_abs_err": {"score": e_s, "tampered_score": e_t,
                                       "o": max_err(o, o_r)}}
                rows.append(row)
                if n not in TIMED_ROWS:
                    log(f"  {what} chunks ({rb},{cb}): {tile_txt}; clean "
                        f"score {float(score.max()):.3g} (err {e_s:.3g}, "
                        f"limit {noise:.3g}); shifted c5/c6/c7 score err "
                        f"{e_t:.3g}")
                    continue
                args = copies([d, store] + cs)
                ms = time_device(lambda a, b, *c: AM.abft_matmul_detect(
                    a, view(b), *c, rb, cb, ta, tb), args)
                plain_ms = time_device(lambda a, b, *c: abft_matmul_detect_ref(
                    a, view(b), *c, rb, cb, ta, tb), args)
                lib_ms = time_device(lambda a, b, *c: torch.matmul(a, view(b)),
                                     args)
                mm_ms = time_device(lambda a, b, *c: AM.abft_matmul(
                    a, view(b), bm, bn), args)
                mm_plain = time_device(lambda a, b, *c: abft_matmul_ref(
                    a, view(b), bm, bn), args)
                del args
                nb, mb = n // rb, m // cb
                nbytes = 2.0 * (n * k + k * m + n * m) + 4.0 * 6 * nb * mb
                flops = 2.0 * n * k * m + 5.0 * n * m
                b, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
                b32, _ = bound_ms(nbytes, flops, FP32_FLOPS_PER_S)
                pm, pn = -(-n // bm), -(-m // bn)
                mm_bytes = (2.0 * (n * k + k * m + n * m)
                            + 4.0 * (pm * m + n * pn + pm * pn))
                mm_flops = 2.0 * n * k * m + 4.0 * n * m
                mm_b, mm_by = bound_ms(mm_bytes, mm_flops, BF16_FLOPS_PER_S)
                row.update({"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "abft_matmul_ms": mm_ms,
                            "abft_matmul_plain_ms": mm_plain,
                            "abft_matmul_bound_ms": mm_b,
                            "abft_matmul_bound_by": mm_by,
                            "bound_ms": b, "bound_by": by,
                            "bound_fp32_fma_ms": b32})
                log(f"  {what} chunks ({rb},{cb}) x{count}: {tile_txt}; "
                    f"detect ms {ms:.4f} "
                    f"plain {plain_ms:.4f} torch.matmul {lib_ms:.4f} "
                    f"bound {b:.4f} ({by}; fp32-FMA {b32:.4f}); abft_matmul "
                    f"{mm_ms:.4f} plain {mm_plain:.4f} bound {mm_b:.4f} "
                    f"({mm_by}); clean score {float(score.max()):.3g} (err "
                    f"{e_s:.3g}, limit {noise:.3g}); shifted c5/c6/c7 score "
                    f"err {e_t:.3g}")
                t = tot[n]
                t["ms"] += count * ms
                t["plain_ms"] += count * plain_ms
                t["library_ms"] += count * lib_ms
                t["mm_ms"] += count * mm_ms
                t["mm_plain_ms"] += count * mm_plain
                t["bytes"] += count * nbytes
                t["flops"] += count * flops
                t["mm_bytes"] += count * mm_bytes
                t["mm_flops"] += count * mm_flops
    for n, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"],
                                                BF16_FLOPS_PER_S)
        t["bound_fp32_fma_ms"] = bound_ms(t["bytes"], t["flops"])[0]
        t["mm_bound_ms"], t["mm_bound_by"] = bound_ms(
            t["mm_bytes"], t["mm_flops"], BF16_FLOPS_PER_S)
        log(f"  per {'decode step' if n == SLOTS else 'prefill of 128'} "
            f"(225 launches): detect ms {t['ms']:.4f} plain {t['plain_ms']:.4f}"
            f" torch.matmul {t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}; fp32-FMA {t['bound_fp32_fma_ms']:.4f}), "
            f"{t['bytes'] / 1e6:.1f} MB; abft_matmul {t['mm_ms']:.4f} plain "
            f"{t['mm_plain_ms']:.4f} bound {t['mm_bound_ms']:.4f} "
            f"({t['mm_bound_by']})")
    host = wrapper_host_us(AM)
    log(f"  host us per wrapper call at the decode wq shape (8x960)@(960x960):"
        f" abft_matmul_detect {host['abft_matmul_detect']:.1f}, abft_matmul "
        f"{host['abft_matmul']:.1f}")
    report["serving_kernels"] = {"per_shape": rows, "decode_step": tot[SLOTS],
                                 "prefill_128": tot[128],
                                 "wrapper_host_us": host}
    dec = tot[SLOTS]
    src = "src/repro_torch/kernels/csrc/abft_matmul.cu"
    # both rows' times are per decode step (225 launches over its shapes)
    detect = {"name": "abft_matmul_detect", "route": "cuda", "source": src,
              "replaces": "src/repro/kernels/abft_matmul.py:131",
              "max_abs_err": err_det, "ms": dec["ms"],
              "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
              "bound_by": dec["bound_by"], "library_ms": dec["library_ms"]}
    mm = {"name": "abft_matmul/serving_bf16", "route": "cuda", "source": src,
          "replaces": "src/repro/kernels/abft_matmul.py:54",
          "max_abs_err": err_mm, "ms": dec["mm_ms"],
          "plain_ms": dec["mm_plain_ms"], "bound_ms": dec["mm_bound_ms"],
          "bound_by": dec["mm_bound_by"], "library_ms": dec["library_ms"]}
    return detect, mm


# --------------------------------------------------------------------------
# phases 3c and 3d: the kernels at Mamba2-1.3B's and RecurrentGemma-2B's
# shapes (bf16)
# --------------------------------------------------------------------------

def check_model_kernels(gen, report, key: str, sites, row_counts):
    """abft_matmul_detect and abft_matmul at one model's distinct GEMM
    shapes (`sites`: label, K, M, W read transposed, launches per forward
    and, optionally, the operands' type name, bf16 otherwise) and at each of `row_counts` (a decode step's 8 rows, an odd
    exact prefill, 128): flags equal to the plain version's and clear, O
    within one bf16 ulp plus the fp32 summation noise of the plain
    version and bitwise equal between the two kernels, the partials
    allclose and finished into chunk sums on the card, and checksums
    predicting +1e4 at one element flag exactly its chunk. Per shape the
    device ms of both kernels, their plain versions and torch.matmul
    beside the bound, the detect pass's row segment and the partial
    tiles; per row count the sums over one forward's launches (their
    operations priced at the bf16 rate, an fp32 site's scaled by the two
    rates' ratio). Written to report[key]."""
    import torch
    from repro_torch import fp32_ieee
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core.thresholds import tau_scalar_coeffs
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (abft_matmul_detect_ref,
                                         abft_matmul_ref, chunk_sums_ref)
    bf16 = torch.bfloat16
    launches = sum(site[4] for site in sites)
    rows, tot = [], {}
    with torch.no_grad(), fp32_ieee():
        for n in row_counts:
            for label, k, m, transposed, count, *dt in sites:
                dtype = getattr(torch, dt[0]) if dt else bf16
                rate = (BF16_FLOPS_PER_S if dtype == bf16
                        else FP32_FLOPS_PER_S)
                eb = torch.empty((), dtype=dtype).element_size()
                d = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
                store = (torch.randn((m, k) if transposed else (k, m),
                                     generator=gen, device="cuda")
                         * k ** -0.5).to(dtype)
                view = (lambda t: t.T) if transposed else (lambda t: t)
                w = view(store)
                rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
                bm, bn = ops._tile(rb, 256), ops._tile(cb, 256)
                tiling = AM.kernel_tiling(n, k, m, dtype, cb)
                cs, sq = exact_chunk_checksums(d, w, rb, cb)
                ta, tb = tau_scalar_coeffs(k, dtype, calibrate_tau_factor(k))
                o, flag, score = AM.abft_matmul_detect(d, w, *cs, rb, cb,
                                                       ta, tb)
                o_r, flag_r, score_r = abft_matmul_detect_ref(
                    d, w, *cs, rb, cb, ta, tb)
                o_mm, parts = AM.abft_matmul(d, w, bm, bn)
                _, parts_r = abft_matmul_ref(d, w, bm, bn)
                sums = ops.chunk_sums_from_partials(parts, rb, cb)
                sums_r = ops.chunk_sums_from_partials(parts_r, rb, cb)
                absdot = d.float().abs() @ w.float().abs()
                # +1e4 at one element of the last chunk, as the checksums
                # of the faulted product would predict it
                r_, c_ = n - 2, m - 3
                p32 = d.float() @ w.float()
                p32[r_, c_] += 1e4
                bad = [*chunk_sums_ref(p32, rb, cb)[:3], cs[3]]
                _, flag_t, _ = AM.abft_matmul_detect(d, w, *bad, rb, cb, ta,
                                                     tb)
                torch.cuda.synchronize()
                what = f"{label} ({n}x{k})@({k}x{m})"
                if dtype != bf16:
                    what += f" {dt[0]}"
                if not torch.equal(flag, flag_r) or int(flag.sum()):
                    fail(f"abft_matmul_detect {what}: flags {flag.tolist()} "
                         f"vs plain {flag_r.tolist()}")
                if not grads_within(o, o_r, dtype, absdot, k):
                    fail(f"abft_matmul_detect {what}: O beyond the rounding "
                         f"of its type plus the summation noise (max |err| "
                         f"{max_err(o, o_r):.3g})")
                if not torch.equal(o, o_mm):
                    fail(f"{what}: abft_matmul_detect and abft_matmul round O "
                         f"differently (max |diff| {max_err(o, o_mm):.3g})")
                noise = 2.0 ** -24 * (k ** 0.5 + (rb * cb) ** 0.5) / ta
                e_s = max_err(score, score_r)
                if not torch.allclose(score, score_r, rtol=1e-3, atol=noise):
                    fail(f"abft_matmul_detect {what}: clean scores differ by "
                         f"{e_s:.3g} (limit {noise:.3g})")
                e_p = 0.0
                for g_, r2, nm in zip(list(parts[:3]) + list(sums),
                                      list(parts_r[:3]) + list(sums_r),
                                      ("colsum", "rowsum", "sumsq", "s5",
                                       "s6", "s7", "chunk sumsq")):
                    # the chunk sums (s*) add up to 1e5 partials, weighted
                    # up to 1024: held to their scale
                    lim = (1e-4 * float(r2.abs().max()) if nm[0] == "s"
                           else 1e-3 * k ** 0.5)
                    if g_.shape != r2.shape or not torch.allclose(
                            g_, r2, rtol=1e-5, atol=lim):
                        fail(f"abft_matmul {what} {nm}: max |err| "
                             f"{max_err(g_, r2):.3g}")
                    e_p = max(e_p, max_err(g_, r2))
                want = torch.zeros_like(flag_t)
                want[r_ // rb, c_ // cb] = 1
                if not torch.equal(flag_t, want):
                    fail(f"abft_matmul_detect {what}: +1e4 at ({r_}, {c_}) "
                         f"flags {flag_t.nonzero().tolist()}")
                pbm, pbn = min(bm, tiling.tm), min(bn, tiling.tn)
                row = {"site": label, "shape": [n, k, m], "chunks": [rb, cb],
                       "dtype": str(dtype).split(".")[-1],
                       "w_transposed": transposed, "per_forward": count,
                       "tiling": {**tiling._asdict(),
                                  "blocks": tiling.tiles(n, m)
                                  * tiling.splits},
                       "partials": [bm, bn], "kernel_partials": [pbm, pbn],
                       "clean_score": float(score.max()),
                       "max_abs_err": {"o": max_err(o, o_r), "score": e_s,
                                       "partials": e_p}}
                args = copies([d, store] + cs)
                row["ms"] = time_device(lambda a, b, *c: AM.abft_matmul_detect(
                    a, view(b), *c, rb, cb, ta, tb), args)
                row["abft_matmul_ms"] = time_device(
                    lambda a, b, *c: AM.abft_matmul(a, view(b), bm, bn), args)
                row["library_ms"] = time_device(
                    lambda a, b, *c: torch.matmul(a, view(b)), args)
                row["plain_ms"] = time_device(
                    lambda a, b, *c: abft_matmul_detect_ref(
                        a, view(b), *c, rb, cb, ta, tb), args)
                row["abft_matmul_plain_ms"] = time_device(
                    lambda a, b, *c: abft_matmul_ref(a, view(b), bm, bn),
                    args)
                del args
                nb, mb = n // rb, m // cb
                nbytes = eb * (n * k + k * m + n * m) + 4.0 * 6 * nb * mb
                flops = 2.0 * n * k * m + 5.0 * n * m
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                            rate)
                pm, pn = -(-n // bm), -(-m // bn)
                mm_bytes = (eb * (n * k + k * m + n * m)
                            + 4.0 * (pm * m + n * pn + pm * pn))
                row["abft_matmul_bound_ms"], row["abft_matmul_bound_by"] = \
                    bound_ms(mm_bytes, 2.0 * n * k * m + 4.0 * n * m, rate)
                rows.append(row)
                times = ("ms", "abft_matmul_ms", "library_ms", "plain_ms",
                         "abft_matmul_plain_ms")
                t = tot.setdefault(n, dict.fromkeys(times + ("bytes",
                                                             "flops"), 0.0))
                for key_ in times:
                    t[key_] += count * row[key_]
                t["bytes"] += count * nbytes
                t["flops"] += count * flops * BF16_FLOPS_PER_S / rate
                log(f"  {what} chunks ({rb},{cb}) x{count}: tile "
                    f"{tiling.tm}x{tiling.tn}, {tiling.splits} splits, seg "
                    f"{tiling.seg}, partial tiles ({bm},{bn}) from the "
                    f"kernel's ({pbm},{pbn}); detect ms {row['ms']:.4f} "
                    f"(plain {row['plain_ms']:.4f}) abft_matmul "
                    f"{row['abft_matmul_ms']:.4f} (plain "
                    f"{row['abft_matmul_plain_ms']:.4f}) torch.matmul "
                    f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
                    f"({row['bound_by']}; abft_matmul's "
                    f"{row['abft_matmul_bound_ms']:.4f}); O err "
                    f"{row['max_abs_err']['o']:.3g}, clean score "
                    f"{float(score.max()):.3g}; +1e4 flagged chunk "
                    f"{[r_ // rb, c_ // cb]}")
    for n, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"],
                                                BF16_FLOPS_PER_S)
        log(f"  per forward at {n} rows ({launches} launches): detect ms "
            f"{t['ms']:.4f} (plain {t['plain_ms']:.4f}) abft_matmul "
            f"{t['abft_matmul_ms']:.4f} (plain {t['abft_matmul_plain_ms']:.4f})"
            f" torch.matmul {t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}), {t['bytes'] / 1e6:.1f} MB")
    report[key] = {"per_shape": rows, "per_forward": tot,
                   "launches_per_forward": launches}
    return tot


def check_mamba_kernels(gen, report):
    """Phase 3c: the bf16 kernels at Mamba2-1.3B's full-depth shapes."""
    return check_model_kernels(gen, report, "mamba_kernels", MAMBA_SITES,
                               MAMBA_ROWS)


def check_rg_kernels(gen, report):
    """Phase 3d: the bf16 kernels at RecurrentGemma-2B's shapes."""
    return check_model_kernels(gen, report, "rg_kernels", RG_SITES, RG_ROWS)


def check_musicgen_kernels(gen, report):
    """Phase 3e: the bf16 kernels at MusicGen-large's shapes."""
    return check_model_kernels(gen, report, "musicgen_kernels",
                               MUSICGEN_SITES, MUSICGEN_ROWS)


def check_kimi_kernels(gen, report):
    """Phase 3g: the kernels at Kimi-K2's plain-matmul sites (phase 15's
    16 detect launches per forward), the fp32 router on the fp32 route."""
    return check_model_kernels(gen, report, "kimi_kernels", KIMI_SITES,
                               SERVE_ROWS)


# --------------------------------------------------------------------------
# phases 4 and 5: the slice
# --------------------------------------------------------------------------

def profile_forward(fn) -> dict:
    """One call of fn under torch.profiler (device_trace): wall time,
    device busy time (the sum of the kernels' own device times), the idle
    share of the wall, and the kernels that take the most device time."""
    events, _, wall = device_trace(fn)
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # the device-side events only: an aten op's own device time repeats
    # the time of the kernels it launched
    kern = [e for e in events if dev(e) > 0]
    busy = sum(dev(e) for e in kern) / 1e3
    top = sorted(kern, key=dev, reverse=True)[:12]
    return {"wall_ms": wall, "device_ms": busy,
            "kernels": sum(e.count for e in kern),
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"name": e.key, "calls": e.count, "ms": dev(e) / 1e3}
                    for e in top]}


def host_split(fwds: dict, reps: int = 5) -> dict:
    """Host microseconds per forward spent inside the detection route's
    layers, from timing spans wrapped around the port's own functions for
    the length of `reps` forwards of each fwds entry. The spans nest:
    detect_sums > conv_detect_sums > the conv-sums wrapper > (its counter
    lookup, then its ctypes launch), so each layer's own cost is its span
    less the ones inside it. Issue time only: nothing inside the spans
    synchronizes."""
    import torch
    from repro_torch.core import checksums as C
    from repro_torch.kernels import _build, _counters, ops
    spans = {"detect_sums": (C, "detect_sums"),
             "conv_detect_sums": (ops, "conv_detect_sums"),
             "conv_sums": (ops, "_conv_sums_kernel"),
             "counters": (_counters, "counters"),
             "abft_matmul": (ops, "_abft_matmul_kernel"),
             "chunk_sums_from_partials": (ops, "chunk_sums_from_partials"),
             "launch": (_build, "launch")}
    acc = {}

    def timed(key, f):
        def g(*a, **kw):
            k = f"launch {a[0].__name__}" if key == "launch" else key
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                v = acc.setdefault(k, [0.0, 0])
                v[0] += time.perf_counter() - t0
                v[1] += 1
        return g

    saved = {k: getattr(mod, name) for k, (mod, name) in spans.items()}
    out = {}
    try:
        for k, (mod, name) in spans.items():
            setattr(mod, name, timed(k, saved[k]))
        for label, fwd in fwds.items():
            fwd()
            torch.cuda.synchronize()
            acc.clear()
            t0 = time.perf_counter()
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()
            out[label] = {"forward_ms": (time.perf_counter() - t0) * 1e3 / reps,
                          "spans": {k: {"calls": c / reps,
                                        "us_per_forward": t * 1e6 / reps,
                                        "us_per_call": t * 1e6 / c}
                                    for k, (t, c) in sorted(acc.items())}}
    finally:
        for k, (mod, name) in spans.items():
            setattr(mod, name, saved[k])
    return out


def pin_fused(plan):
    from repro_torch.core import ProtectionPlan
    return ProtectionPlan(
        {n: dataclasses.replace(e, cfg=e.cfg.replace(use_fused_kernel=True))
         if e.cfg.enabled else e for n, e in plan.entries.items()},
        dict(plan.meta))


def run_slice(report):
    import torch
    from repro_torch.core import plan_scope, workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn
    from repro_torch import core, fp32_ieee

    if torch.backends.cudnn.benchmark:
        fail("cudnn.benchmark is on: two forwards may pick different "
             "algorithms and the bitwise contracts would not hold")
    cfg = cnn.resnet18(1.0)
    params = cnn.init_cnn(cfg, generator=torch.Generator().manual_seed(SEED),
                          device="cuda")
    x = torch.randn((BATCH, 3, IMG, IMG),
                    generator=torch.Generator().manual_seed(SEED + 1)
                    ).to("cuda")
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=BATCH, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = pin_fused(plan)
    n_conv = len(cfg.convs)
    names = list(fused.names())
    log(f"  ResNet-18 width 1.0 img {IMG} batch {BATCH}: {len(names)} "
        f"protected sites, build_plan {plan_s:.2f} s")

    off = dataclasses.replace(cfg, abft=False)
    unprot = lambda: cnn.forward_cnn(params, x, off)[0]
    l0 = unprot()

    # clean flags and scores: the detect-only pass, site by site
    with torch.no_grad(), fp32_ieee(), plan_scope(fused, mode="detect_only"):
        _, det_names, evs = cnn._forward_pass(params, x, cfg, None, -1, None)
    scores = {n: float(e.score) for n, e in zip(det_names, evs)}
    flags = {n: int(e.flag) for n, e in zip(det_names, evs)}
    log("  clean detection scores |c-s|/tau: " + " ".join(
        f"{n}={s:.3g}" for n, s in scores.items()))
    if any(flags.values()):
        fail(f"clean forward flagged: {flags} scores {scores}")

    res = {"scores": scores}
    logits = {}
    for mode in ("per_layer", "deferred"):
        CR.LAUNCHES = AM.LAUNCHES = workflow.HOST_READS = 0
        lg, rep = cnn.forward_cnn(params, x, cfg, plan=fused, correction=mode)
        torch.cuda.synchronize()
        launches = {"checksum_reduce": CR.LAUNCHES,
                    "abft_matmul": AM.LAUNCHES}
        reads = workflow.HOST_READS
        summ = rep.summary()
        bad = {n: v for n, v in summ.items()
               if v["detected"] or v["residual"]}
        if bad:
            fail(f"{mode}: clean forward reported {bad}")
        want_reads = len(names) if mode == "per_layer" else 1
        if launches != {"checksum_reduce": n_conv, "abft_matmul": 1}:
            fail(f"{mode}: launches {launches}, want {n_conv} + 1")
        if reads != want_reads:
            fail(f"{mode}: {reads} host reads, want {want_reads}")
        if not torch.isfinite(lg).all() or tuple(lg.shape) != (BATCH, 1000):
            fail(f"{mode}: logits {tuple(lg.shape)} not finite/shaped")
        logits[mode] = lg
        res[mode] = {"launches": launches, "host_reads": reads}
        log(f"  {mode}: launches {launches}, host reads {reads}, "
            f"flags 0/{len(summ)}")
    if not torch.equal(logits["per_layer"], logits["deferred"]):
        fail("per_layer and deferred clean logits differ")
    # the protected clean path leaves every conv output untouched: with
    # the fc left unprotected, the logits are bitwise the unprotected ones
    convs_only = core.ProtectionPlan(
        {n: e for n, e in fused.entries.items() if n != "fc"}, fused.meta)
    for mode in ("per_layer", "deferred"):
        lc, _ = cnn.forward_cnn(params, x, cfg, plan=convs_only,
                                correction=mode)
        if not torch.equal(lc, l0):
            fail(f"{mode}: protected convs changed the logits "
                 f"(max |diff| {max_err(lc, l0):.3g})")
    # the unfused plan: every layer's output, the fc's too, is bitwise
    # the unprotected forward's
    for mode in ("per_layer", "deferred"):
        lu, _ = cnn.forward_cnn(params, x, cfg, plan=plan, correction=mode)
        if not torch.equal(lu, l0):
            fail(f"{mode}: unfused protected logits differ from the "
                 "unprotected forward")
    # with the fc's product taken by the kernel, the logits differ from
    # cuBLAS's only by fp32 reassociation
    d_fc = max_err(logits["per_layer"], l0)
    scale = float(l0.abs().max()) + 1.0
    if not d_fc <= 1e-5 * scale:
        fail(f"fused logits vs unprotected: max |diff| {d_fc:.3g}")
    log(f"  bitwise: per_layer == deferred; convs-only protected == "
        f"unprotected; unfused plan == unprotected; fused fc vs cuBLAS "
        f"max |diff| {d_fc:.3g}")

    # the port's own CPU run of the same params and input
    params_cpu = {k: {kk: vv.cpu() for kk, vv in v.items()}
                  for k, v in params.items()}
    plan_cpu = pin_fused(core.build_plan(params_cpu, cfg, batch=BATCH,
                                         device="cpu"))
    t0 = time.perf_counter()
    l_cpu, rep_cpu = cnn.forward_cnn(params_cpu, x.cpu(), cfg, plan=plan_cpu,
                                     device="cpu")
    cpu_s = time.perf_counter() - t0
    d_cpu = max_err(logits["per_layer"].cpu(), l_cpu)
    # cuDNN vs the CPU's convs: fp32 reassociation through 17 layers
    if not torch.allclose(logits["per_layer"].cpu(), l_cpu, rtol=1e-4,
                          atol=1e-4 * scale) or int(rep_cpu.detected):
        fail(f"card vs CPU logits: max |diff| {d_cpu:.3g}")
    log(f"  card vs CPU run: max |diff| {d_cpu:.3g} (CPU forward "
        f"{cpu_s:.1f} s)")
    res.update({"fused_fc_vs_cublas_max_diff": d_fc,
                "card_vs_cpu_max_diff": d_cpu})

    # median forward times
    times = time_host({
        "unprotected": unprot,
        "per_layer": lambda: cnn.forward_cnn(params, x, cfg, plan=fused),
        "deferred": lambda: cnn.forward_cnn(params, x, cfg, plan=fused,
                                            correction="deferred"),
        "per_layer_unfused": lambda: cnn.forward_cnn(params, x, cfg,
                                                     plan=plan),
        "deferred_unfused": lambda: cnn.forward_cnn(
            params, x, cfg, plan=plan, correction="deferred"),
    })
    res["forward_ms"] = times
    log("  median forward ms: " + " ".join(f"{k}={v:.3f}"
                                            for k, v in times.items()))
    for k in ("per_layer", "deferred"):
        log(f"  error-free overhead {k}: "
            f"{(times[k] / times['unprotected'] - 1) * 100:.1f}%")

    split = host_split({
        "per_layer": lambda: cnn.forward_cnn(params, x, cfg, plan=fused),
        "per_layer_unfused": lambda: cnn.forward_cnn(params, x, cfg,
                                                     plan=plan)})
    res["host_split"] = split
    for k, v in split.items():
        log(f"  host us per forward, {k} (forward {v['forward_ms']:.3f} ms): "
            + ", ".join(f"{n} {d['us_per_forward']:.1f} ({d['calls']:g} "
                        f"calls, {d['us_per_call']:.1f}/call)"
                        for n, d in v["spans"].items()))
    sp = split["per_layer"]["spans"]
    us = lambda k: sp[k]["us_per_call"]
    launch = us("launch repro_conv_detect_sums_f32")
    log("  conv sums route, host us per call: detect_sums "
        f"{us('detect_sums'):.1f} = own "
        f"{us('detect_sums') - us('conv_detect_sums'):.1f} + dispatch "
        f"{us('conv_detect_sums') - us('conv_sums'):.1f} + checks, "
        "allocation and views "
        f"{us('conv_sums') - us('counters') - launch:.1f} + counters "
        f"{us('counters'):.1f} + ctypes launch {launch:.1f}; the plain pass "
        f"{split['per_layer_unfused']['spans']['detect_sums']['us_per_call']:.1f}")

    res["profile"] = {
        "unprotected": profile_forward(unprot),
        "per_layer": profile_forward(lambda: cnn.forward_cnn(
            params, x, cfg, plan=fused)),
        "deferred": profile_forward(lambda: cnn.forward_cnn(
            params, x, cfg, plan=fused, correction="deferred")),
    }
    for k, v in res["profile"].items():
        log(f"  profile {k}: wall {v['wall_ms']:.3f} ms, device busy "
            f"{v['device_ms']:.3f} ms ({v['kernels']} kernels), idle share "
            f"{v['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in v["top"][:4]))

    # phase 5: injected faults
    log("phase 5: injected faults")
    rng = __import__("numpy").random.default_rng(SEED + 2)
    faults = {}
    for layer in (5, 13):
        _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
        n_, m_, e1, e2 = o_clean.shape
        delta = torch.zeros(o_clean.shape, dtype=torch.float32)
        if layer == 5:
            idx = (int(rng.integers(n_)), int(rng.integers(m_)),
                   int(rng.integers(e1)), int(rng.integers(e2)))
            delta[idx] = float(rng.uniform(5.0, 50.0))
            what = f"one element at {idx}"
        else:
            img, yy, xx = (int(rng.integers(n_)), int(rng.integers(e1)),
                           int(rng.integers(e2)))
            chans = rng.choice(m_, size=6, replace=False)
            for c in chans:
                delta[img, int(c), yy, xx] = float(rng.uniform(5.0, 50.0))
            what = (f"burst: image {img}, channels {sorted(map(int, chans))}"
                    f", position ({yy},{xx})")
        o_bad = o_clean + delta.to("cuda")
        for mode in ("per_layer", "deferred"):
            lg, rep = cnn.forward_cnn(params, x, cfg, plan=fused,
                                      correction=mode, inject_layer=layer,
                                      inject_o=o_bad)
            summ = rep.summary()
            site = summ[f"conv{layer}"]
            others = {n: v for n, v in summ.items()
                      if n != f"conv{layer}" and v["detected"]}
            d_l = max_err(lg, logits["per_layer"])
            ok = (site["detected"] == 1 and site["residual"] == 0
                  and site["corrected_by"] != "none" and not others
                  and torch.allclose(lg, logits["per_layer"], rtol=1e-4,
                                     atol=1e-4 * scale))
            log(f"  conv{layer} {what} [{mode}]: detected "
                f"{site['detected']} corrected_by {site['corrected_by']} "
                f"residual {site['residual']}, logits max |diff| {d_l:.3g}")
            if not ok:
                fail(f"conv{layer} {mode}: {site} others {others} "
                     f"logit diff {d_l:.3g}")
            faults[f"conv{layer}/{mode}"] = {**site, "what": what,
                                             "logit_max_diff": d_l}
    res["faults"] = faults
    res["erroneous"] = run_erroneous(params, x, cfg, fused, logits, scale,
                                     unprot, times)
    report["slice"] = res
    return res, {"params": params, "x": x, "cfg": cfg, "fused": fused,
                 "unprot": unprot, "l0": l0}


def run_erroneous(params, x, cfg, fused, logits, scale, unprot,
                  clean_times) -> dict:
    """Phase 5b: the paper's error-injected overhead at full width, after
    benchmarks/bench_erroneous.py. The port's registry draws a `burst`
    spec (up to 100 elements in one block-row or block-column, +-2^e) for
    each of the 17 convs in turn, injected through forward_cnn's
    inject_layer/inject_o into the clean output conv_output_at gives.
    Two plan variants (as built, with the layerwise RC/ClC choice; RC/ClC
    off, the paper's Fig. 10b), each in per_layer and deferred mode: the
    injected layer detected with no residual, no other layer flagged,
    logits back to the clean ones (rtol 1e-4). Each faulted forward is
    timed in turns with the unprotected and the clean protected forward;
    the error-injected overhead is the mean over layers of the median
    faulted forward over the median unprotected forward, minus 1."""
    import torch
    from repro_torch.core import ProtectionPlan
    from repro_torch.core import injection as inj
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn

    log("phase 5b: the error-injected overhead")
    model = inj.FAULT_MODELS["burst"]
    gen = torch.Generator().manual_seed(SEED + 5)
    n_conv = len(cfg.convs)
    o_bad, specs = [], []
    for layer in range(n_conv):
        _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
        n_, m_ = o_clean.shape[0], o_clean.shape[1]
        spec = model.plan(gen, n_, m_, o_clean.shape[2] * o_clean.shape[3],
                          100)
        o_bad.append(inj.inject(o_clean, spec.to(o_clean.device), model))
        specs.append({"axis": int(spec.axis), "index": int(spec.index),
                      "nelem": int(spec.nelem), "scale": float(spec.scale)})
    variants = {
        "layerwise": fused,
        "no_rcclc": ProtectionPlan(
            {n: dataclasses.replace(e, cfg=e.cfg.replace(
                rc_enabled=False, clc_enabled=False))
             for n, e in fused.entries.items()}, dict(fused.meta)),
    }
    out = {"specs": specs}
    for vname, vplan in variants.items():
        for mode in ("per_layer", "deferred"):
            fwd = lambda i=-1: cnn.forward_cnn(
                params, x, cfg, plan=vplan, correction=mode,
                inject_layer=i, inject_o=o_bad[i] if i >= 0 else None)
            by, launches, diffs = [], [], []
            for i in range(n_conv):
                CR.LAUNCHES = AM.LAUNCHES = 0
                lg, rep = fwd(i)
                torch.cuda.synchronize()
                launches.append((CR.LAUNCHES, AM.LAUNCHES))
                summ = rep.summary()
                site = summ[f"conv{i}"]
                others = {k: v for k, v in summ.items()
                          if k != f"conv{i}" and v["detected"]}
                d_l = max_err(lg, logits["per_layer"])
                diffs.append(d_l)
                by.append(site["corrected_by"])
                if not (site["detected"] == 1 and site["residual"] == 0
                        and site["corrected_by"] != "none"
                        and not others and torch.isfinite(lg).all()
                        and torch.allclose(lg, logits["per_layer"],
                                           rtol=1e-4, atol=1e-4 * scale)):
                    fail(f"5b {vname}/{mode} conv{i} {specs[i]}: {site}, "
                         f"others {others}, logits max |diff| {d_l:.3g}")
                if CR.LAUNCHES != n_conv or AM.LAUNCHES < 1:
                    fail(f"5b {vname}/{mode} conv{i}: launches "
                         f"{launches[-1]}, want {n_conv} conv sums and "
                         "the fc's abft_matmul")
            faulted, unp, clean = [], [], []
            for i in range(n_conv):
                t = time_turns({"unprotected": unprot,
                                "clean": lambda: fwd(),
                                "faulted": lambda i=i: fwd(i)},
                               reps=FAULTED_REPS, warmup=1)
                faulted.append(statistics.median(t["faulted"]))
                unp += t["unprotected"]
                clean += t["clean"]
            u, c = statistics.median(unp), statistics.median(clean)
            overhead = statistics.mean(faulted) / u - 1
            hist = dict(collections.Counter(by))
            key = f"{vname}/{mode}"
            out[key] = {"corrected_by": by, "histogram": hist,
                        "launches_per_forward": launches,
                        "logit_max_diff": diffs,
                        "faulted_ms": faulted, "unprotected_ms": u,
                        "clean_ms": c, "error_injected_overhead": overhead,
                        "error_free_overhead": c / u - 1}
            log(f"  {key}: 17/17 detected, residual 0, logits within "
                f"rtol 1e-4 (max |diff| {max(diffs):.3g}); schemes {hist}; "
                f"launches per faulted forward (conv sums, abft_matmul) "
                f"{sorted(set(launches))}")
            log(f"  {key}: median ms unprotected {u:.3f}, clean protected "
                f"{c:.3f}, faulted per layer "
                + " ".join(f"{f:.2f}" for f in faulted))
            log(f"  {key}: error-injected overhead {overhead * 100:.1f}% "
                f"(error-free in the same turns {(c / u - 1) * 100:.1f}%; "
                f"phase 4: {(clean_times[mode] / clean_times['unprotected'] - 1) * 100:.1f}%)")
    return out


# --------------------------------------------------------------------------
# phases 6 and 7: the serving slice
# --------------------------------------------------------------------------

def serve_prompts(cfg, n: int, seed: int):
    """`n` prompts of PROMPT_LENS tokens, (S, K) arrays for a model with K
    codebooks."""
    rng = __import__("numpy").random.default_rng(seed)
    lo, hi = PROMPT_LENS
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return [rng.integers(0, cfg.vocab_size, (int(k),) + cb)
            for k in rng.integers(lo, hi + 1, n)]


def token_key(tok):
    """A served token (an int, or a K-list of a multi-codebook model) as a
    hashable value."""
    return tuple(tok) if isinstance(tok, list) else tok


def serve(params, cfg, plan, prompts, gen: int, correction="auto",
          hook=None):
    """One ProtectedSession over `prompts`: (session, request ids,
    report, per-step records). The records are the session's decode log:
    each decode step's host milliseconds (they end in the read of the
    next tokens, which synchronizes) and its localizer hit vector;
    `hook` is (path, fn) of a fault_scope."""
    import contextlib
    from repro_torch.core import injection
    from repro_torch.serving import ProtectedSession
    sess = ProtectedSession(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                            correction=correction, device=DEVICE)
    rids = [sess.submit(p, max_new_tokens=gen) for p in prompts]
    scope = injection.fault_scope(*hook) if hook else contextlib.nullcontext()
    with scope:
        report = sess.run()
    log_ = sess.stats.decode_log
    steps = {"ms": [e["dispatch_s"] * 1e3 for e in log_],
             "hits": [e["hit"] for e in log_]}
    return sess, rids, report, steps


def teacher_forced(params, cfg, fused, prompts, served):
    """Each prompt with its served tokens through the uncached forward,
    unprotected and under the plan's detect-only routes: (the largest
    logit gap between the two, the largest margin of a served token's
    unprotected logit below the unprotected top logit at its position;
    with K codebooks, every codebook's token against its own K-th logits)."""
    import numpy as np
    import torch
    from repro_torch import core, fp32_ieee
    from repro_torch.models import transformer as M
    ucfg = cfg.replace(abft=False)
    gap, worst = 0.0, 0.0
    with torch.no_grad(), fp32_ieee():
        for p, toks in zip(prompts, served):
            seq = torch.as_tensor(np.concatenate([np.asarray(p),
                                                  np.asarray(toks)]),
                                  device=DEVICE)[None]
            ref, _, _, _ = M._forward(params, seq, ucfg)
            with core.plan_scope(fused, mode="detect_only"):
                kern, _, _, _ = M._forward(params, seq, cfg)
            plen = len(p)
            pos = torch.arange(plen - 1, seq.shape[1] - 1, device=DEVICE)
            ref_p = ref[0, pos]
            if not bool(torch.isfinite(kern).all()):
                fail(f"non-finite logits teacher-forcing {cfg.name}")
            gap = max(gap, max_err(kern[0, pos], ref_p))
            margin = ref_p.max(dim=-1).values - ref_p.gather(
                -1, seq[0, plen:, ..., None])[..., 0]
            worst = max(worst, float(margin.max()))
    return gap, worst


def run_serving(report):
    """Phase 6: full-width bf16 SmolLM-360M served in deferred mode
    through the kernels, checked for zero flags, 225 detect launches and
    one host read per forward, per_layer parity, a teacher-forced check
    against the unprotected forward, timings of three sessions and a
    profile. Phase 7: a decode fault at the tied head and a prefill fault
    at a stage site, detected, corrected and attributed."""
    import torch
    from repro_torch import configs, core
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as M

    cfg = configs.get(SERVE_ARCH)
    t0 = time.perf_counter()
    # drawn on the card: seconds for a model of billions of params, where
    # the host's generator takes most of a minute
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                           device=DEVICE)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = core.force_fused_matmul(plan)
    n_sites = cfg.stages()[1] * 7 + 1
    if len(fused) != 8:
        fail(f"plan has {len(fused)} entries, want 8")
    log(f"  {SERVE_ARCH}: {M.count_params(cfg) / 1e6:.1f} M params bf16, "
        f"{n_sites} protected GEMMs per forward; init {init_s:.1f} s, "
        f"build_plan {plan_s:.1f} s")
    res = {"init_s": init_s, "build_plan_s": plan_s}
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)

    # -- the main path: deferred, kernels pinned -----------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    sess, rids, rep, steps = serve(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES}
    reads = workflow.HOST_READS
    tokens = {r: sess.tokens_for(r) for r in rids}
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  deferred, kernels on: {rep['completed']} requests, {c['prefills']} "
        f"prefills + {c['decode_steps']} decode steps, launches {launches}, "
        f"host reads {reads}, faults {c['faults_detected']}")
    if reasons != ["length"] * N_REQ or rep["completed"] != N_REQ:
        fail(f"requests finished with {reasons}")
    if c["faults_detected"] or c["dropped"] or c["faults_unattributed"]:
        fail(f"clean serving counted {c}")
    if any(any(h) for h in steps["hits"]):
        fail("the slot localizer hit on a clean step")
    if launches != {"abft_matmul_detect": n_sites * forwards,
                    "abft_matmul": 0} or reads != forwards:
        fail(f"{forwards} clean forwards launched {launches} with {reads} host "
             f"reads; want {n_sites} detect launches and 1 read each")
    res["deferred"] = {"counters": c, "launches": launches, "host_reads": reads,
                       "forwards": forwards}

    # -- per_layer serves the same tokens ------------------------------------
    workflow.HOST_READS = 0
    AM.LAUNCHES = AM.DETECT_LAUNCHES = 0
    s_pl, r_pl, rep_pl, _ = serve(params, cfg, fused, prompts[:8], 8,
                                  correction="per_layer")
    f_pl = rep_pl["counters"]["prefills"] + rep_pl["counters"]["decode_steps"]
    got = [s_pl.tokens_for(r) for r in r_pl]
    want = [tokens[r][:8] for r in rids[:8]]
    log(f"  per_layer, first 8 requests x 8 tokens: host reads "
        f"{workflow.HOST_READS} over {f_pl} forwards, abft_matmul launches "
        f"{AM.LAUNCHES}; tokens == deferred: {got == want}")
    if got != want:
        fail(f"per_layer tokens {got} differ from deferred's {want}")
    if workflow.HOST_READS != n_sites * f_pl or AM.LAUNCHES != n_sites * f_pl:
        fail(f"per_layer: {workflow.HOST_READS} reads, {AM.LAUNCHES} launches")
    res["per_layer"] = {"host_reads": workflow.HOST_READS, "forwards": f_pl,
                        "launches": AM.LAUNCHES}

    # -- teacher-forced check against the unprotected forward ----------------
    ucfg = cfg.replace(abft=False)
    gap, worst = teacher_forced(params, cfg, fused, prompts,
                                [tokens[r] for r in rids])
    log(f"  teacher-forced vs the unprotected forward: largest logit gap "
        f"{gap:.4g}; served tokens at most {worst:.4g} below the reference's "
        f"top logit (limit {DELTA})")
    if not worst <= DELTA:
        fail(f"a served token's reference logit is {worst:.4g} below the top")
    res["teacher_forced"] = {"max_logit_gap": gap, "max_margin": worst}

    # -- timings: three sessions in turns, TIMED_ROUNDS rounds ---------------
    sessions = {"unprotected": (ucfg, None), "kernels_off": (cfg, plan),
                "kernels_on": (cfg, fused)}
    times = {k: {"decode_ms": [], "ttft_ms": []} for k in sessions}
    for rnd in range(TIMED_ROUNDS):
        keys = list(sessions)
        for k in keys[rnd:] + keys[:rnd]:
            kcfg, kplan = sessions[k]
            _, _, rp, st = serve(params, kcfg, kplan, prompts, GEN)
            times[k]["decode_ms"].append(statistics.median(st["ms"]))
            times[k]["ttft_ms"].append(rp["ttft_p50_s"] * 1e3)
    for k, v in times.items():
        log(f"  {k}: median decode step ms {v['decode_ms']}, TTFT p50 ms "
            f"{v['ttft_ms']}")
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    over = {k: {m: med[k][m] / med["unprotected"][m] - 1 for m in med[k]}
            for k in ("kernels_off", "kernels_on")}
    for k, v in over.items():
        log(f"  error-free overhead, {k}: decode step "
            f"{v['decode_ms'] * 100:.1f}%, TTFT p50 {v['ttft_ms'] * 100:.1f}%")
    res["times"], res["overhead"] = times, over

    # -- profile of one decode step of each session ---------------------------
    res["profile"] = {}
    for k, (kcfg, kplan) in sessions.items():
        from repro_torch.serving import ProtectedSession
        ps = ProtectedSession(params, kcfg, kplan, slots=SLOTS,
                              max_len=MAX_LEN, device=DEVICE)
        for p in prompts[:SLOTS]:
            ps.submit(p, max_new_tokens=GEN)
        ps.step()                     # admits all 8, one decode step
        prof = profile_forward(ps.step)
        res["profile"][k] = prof
        log(f"  profile, one decode step {k}: wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['device_ms']:.3f} ms ({prof['kernels']} "
            f"kernels), idle share {prof['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in prof["top"][:4]))

    # -- phase 7: injected faults ---------------------------------------------
    log("phase 7: serving drills")
    drill_prompts, drill_ids = prompts[:SLOTS], rids[:SLOTS]
    clean = [tokens[r][:8] for r in drill_ids]
    target = 3

    def decode_hook(o):
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 1234 % o.shape[-1]] += 1e4
        return o

    s_d, r_d, rep_d, st_d = serve(params, cfg, fused, drill_prompts, 8,
                                  hook=("embed/table", decode_hook))
    recs = {r["id"]: r for r in rep_d["requests"]}
    by_slot = {recs[r]["slot"]: recs[r] for r in r_d}
    cd = rep_d["counters"]
    hit_slots = sorted({i for h in st_d["hits"] for i, x in enumerate(h) if x})
    ok = (by_slot[target]["faults_detected"] == cd["decode_steps"]
          and by_slot[target]["corrections_applied"] == cd["decode_steps"]
          and by_slot[target]["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and cd["faults_unattributed"] == 0 and cd["residual_steps"] == 0
          and hit_slots == [target])
    same = [s_d.tokens_for(r) for r in r_d] == clean
    log(f"  decode fault at embed/table, slot {target}: {cd['faults_detected']} "
        f"detected / {cd['faults_corrected']} corrected over "
        f"{cd['decode_steps']} steps, localizer hit slots {hit_slots}, "
        f"unattributed {cd['faults_unattributed']}, residual steps "
        f"{cd['residual_steps']}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"decode drill: {by_slot} counters {cd} tokens equal {same}")

    def prefill_hook(o):
        if o.shape[0] == 1 and o.shape[1] > 1:
            o = o.clone()
            o[0, 5, 17] += 1e3
        return o

    s_p, r_p, rep_p, _ = serve(params, cfg, fused, drill_prompts, 8,
                               hook=("stages/b0_attn_full/attn/wq",
                                     prefill_hook))
    recs = {r["id"]: r for r in rep_p["requests"]}
    cp_ = rep_p["counters"]
    ok = all(recs[r]["prefill_detected"] == 1 and recs[r]["residuals"] == 0
             for r in r_p) and cp_["residual_steps"] == 0
    same = [s_p.tokens_for(r) for r in r_p] == clean
    log(f"  prefill fault at stages/b0_attn_full/attn/wq (every repeat): "
        f"prefill_detected {[recs[r]['prefill_detected'] for r in r_p]}, "
        f"residuals {[recs[r]['residuals'] for r in r_p]}, corrected "
        f"{cp_['faults_corrected']}/{cp_['faults_detected']}; tokens == clean: "
        f"{same}")
    if not (ok and same):
        fail(f"prefill drill: {recs} counters {cp_} tokens equal {same}")
    res["drills"] = {"decode": {"counters": cd, "target": by_slot[target],
                                "hit_slots": hit_slots},
                     "prefill": {"counters": cp_}}
    res["audit"] = run_audit_drills(params, cfg, fused, drill_prompts,
                                    clean)
    report["serving"] = res
    return res, {"params": params, "cfg": cfg, "fused": fused,
                 "prompts": prompts, "tokens": [tokens[r] for r in rids]}


AUDIT_ENTRY = "stages/b0_attn_full/attn/wq"


def corrupt_one_column(w, gen) -> str:
    """The weight_corrupt_correctable damage class, drawn by the
    registry: 1..100 elements of one column of the middle repeat of a
    stacked (reps, K, M) leaf overwritten in place."""
    from repro_torch.core import injection as inj
    model = inj.FAULT_MODELS["weight_corrupt_correctable"]
    r = int(w.shape[0]) // 2
    k, m = int(w.shape[1]), int(w.shape[2])
    spec = model.plan(gen, k, m, 1, 100)
    w[r].copy_(inj.inject(w[r], spec.to(w.device), model))
    return (f"repeat {r}, column {int(spec.index)}: {int(spec.nelem)} "
            f"elements set to {float(spec.add):g}")


def run_audit_drills(params, cfg, plan, prompts, clean) -> dict:
    """Phase 7b: the plan-trusted weight audit of a serving session at
    full width. Sessions with audit_every=1 and a restore_fn that returns
    a saved copy of the clean params serve `prompts` (8 new tokens each).
    Drill 1 overwrites 1..K elements of one column of one repeat of a
    stage's wq in place between two steps (the weight_corrupt_correctable
    damage class, drawn by the registry): the next audit repairs it in
    place - verdict `repaired`, no restore, the leaf bitwise the clean
    one. Drill 2 corrupts two blocks: the ladder restores. Both serve the
    clean run's tokens; the deferred detect kernel carries every forward."""
    import torch
    from repro_torch.core import weight_leaf, workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.runtime import ft
    from repro_torch.serving import ProtectedSession

    log("phase 7b: the serving weight audit")
    name = AUDIT_ENTRY
    if name not in plan:
        fail(f"the plan has no entry {name}")
    clone = lambda t: ({k: clone(v) for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    saved = clone(params)
    bits = lambda t: t.contiguous().view(torch.int16)
    n_sites = cfg.stages()[1] * 7 + 1
    # the audit alone on clean weights, and the repair rung on a flagged
    # leaf, timed on the host (each reads its verdicts back)
    aud_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        ok, bad = ft.audit_weights_against_plan(params, plan)
        aud_ms.append((time.perf_counter() - t0) * 1e3)
        if not ok:
            fail(f"clean weights fail the audit: {bad[:3]}")
    gen = torch.Generator().manual_seed(SEED + 7)
    out = {"audit_ms": aud_ms, "entry": name}

    def drill(label, corrupt):
        sp = clone(params)
        sess = ProtectedSession(sp, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                                audit_every=1, restore_fn=lambda: saved,
                                device=DEVICE)
        rids = [sess.submit(p, max_new_tokens=8) for p in prompts]
        AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
        for _ in range(2):
            sess.step()
        what = corrupt(weight_leaf(sess.params, name))
        while sess.step():
            pass
        torch.cuda.synchronize()
        rep = sess.stats.report()
        c = rep["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        verdicts = sorted({v for r in rep["requests"]
                           for v in r["audit_verdicts"]})
        same = [sess.tokens_for(r) for r in rids] == clean
        leaf_ok = torch.equal(bits(weight_leaf(sess.params, name)),
                              bits(weight_leaf(saved, name)))
        res = {"what": what, "counters": {k: c[k] for k in (
                   "weight_audits", "weight_repairs", "weight_restores",
                   "faults_detected", "dropped")},
               "verdicts": verdicts, "tokens_equal": same,
               "leaf_bitwise_clean": leaf_ok,
               "repair_ms": [r * 1e3 for r in sess.stats.repair_s],
               "detect_launches": AM.DETECT_LAUNCHES, "forwards": forwards}
        log(f"  {label}: {what}; audits {c['weight_audits']}, repairs "
            f"{c['weight_repairs']}, restores {c['weight_restores']}, "
            f"verdicts {verdicts}; leaf bitwise clean {leaf_ok}; tokens == "
            f"clean: {same}; detect launches {AM.DETECT_LAUNCHES} over "
            f"{forwards} forwards")
        if AM.DETECT_LAUNCHES != n_sites * forwards or c["faults_detected"]:
            fail(f"{label}: {AM.DETECT_LAUNCHES} detect launches over "
                 f"{forwards} forwards, faults {c['faults_detected']}")
        if not same or not leaf_ok or c["dropped"]:
            fail(f"{label}: {res}")
        return res

    one_column = lambda w: corrupt_one_column(w, gen)

    def two_blocks(w):
        reps, k, m = (int(d) for d in w.shape)
        w[0, 11, 40] += 977.0
        w[reps - 1, k - 5, m - 7] -= 977.0
        return (f"repeat 0 (11, 40) and repeat {reps - 1} ({k - 5}, "
                f"{m - 7}) moved by 977")

    r1 = drill("drill 1, one column", one_column)
    if not (r1["counters"]["weight_repairs"] == 1
            and r1["counters"]["weight_restores"] == 0
            and "repaired" in r1["verdicts"]):
        fail(f"drill 1 did not repair in place: {r1}")
    r2 = drill("drill 2, two blocks", two_blocks)
    if not (r2["counters"]["weight_restores"] == 1
            and r2["counters"]["weight_repairs"] == 0
            and "restored" in r2["verdicts"]):
        fail(f"drill 2 did not restore: {r2}")
    # the repair alone, warm: the float64 solve of the flagged stacked
    # leaf and the write-back of the repaired one, on a fresh one-column
    # damage of drill 1's class
    bad = clone(params)
    one_column(weight_leaf(bad, name))
    ok, flagged = ft.audit_weights_against_plan(bad, plan)
    rep_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fixed, repaired = ft.repair_weights_against_plan(bad, plan, flagged)
        torch.cuda.synchronize()
        rep_ms.append((time.perf_counter() - t0) * 1e3)
        if ok or repaired != [name] or not torch.equal(
                bits(weight_leaf(fixed, name)), bits(weight_leaf(saved, name))):
            fail(f"warm repair: flagged {flagged}, repaired {repaired}")
    log(f"  audit ms (clean, 8 entries): median "
        f"{statistics.median(aud_ms):.2f} of {[round(a, 2) for a in aud_ms]}; "
        f"repair rung ms in drill 1 (repair + re-audit, first float64 "
        f"solve of the process) {r1['repair_ms']}; the repair alone, warm: "
        f"median {statistics.median(rep_ms):.2f} of "
        f"{[round(a, 2) for a in rep_ms]}")
    out.update({"repair": r1, "restore": r2, "warm_repair_ms": rep_ms})
    return out


# --------------------------------------------------------------------------
# phase 9: the calibrated plan
# --------------------------------------------------------------------------

def conv_sums_tiling(n: int, m: int, p: int):
    """(column tiles, row groups) of a conv-sums launch over fp32
    O[n, m, p] as the CUDA source tiles it, read back from its layout
    (counters: one per column tile and one more; scratch: rg * (3p +
    column tiles) floats when rg > 1, one per column tile otherwise)."""
    import torch
    from repro_torch.kernels import checksum_reduce as CR
    floats, counters = CR.conv_sums_layout(n, m, p, torch.float32)
    ct, scratch = counters - 1, floats - 3 * p - 1
    return ct, (1 if scratch == ct else scratch // (3 * p + ct))


def fmt_us(v) -> str:
    """A profile's microseconds; None where the kernel route cannot run."""
    return "no kernel route" if v is None else f"{v:.1f} us"


def profile_key(site):
    """build_plan's memo key of a site's kernel profile: a conv's output
    view (n, m, e), a GEMM's (n, k, m)."""
    s = site.shape
    return ("conv", s.n, s.m, s.h) if site.op.kind == "conv" \
        else ("mm", s.n, s.ch, s.m)


def log_profiles(plan, spec) -> list:
    """One line per distinct profile key of a profiled plan: the sites,
    plain and kernel-route us, the winner, and the tiling the CUDA source
    chose for the kernel route (f32, as profiled)."""
    import torch
    from repro_torch.kernels import abft_matmul as AM
    kp = plan.meta["kernel_profile"]
    groups = {}
    for site in spec.sites:
        if site.path in kp:
            groups.setdefault(profile_key(site), []).append(site.path)
    rows = []
    for key, paths in groups.items():
        d = kp[paths[0]]
        if d.get("skipped"):
            continue
        if key[0] == "conv":
            _, n, m, e = key
            ct, rg = conv_sums_tiling(n, m, e * e)
            tiling = f"conv sums {ct} column tiles x {rg} row groups"
        else:
            _, n, k, m = key
            t = AM.kernel_tiling(n, k, m, torch.float32)
            tiling = f"abft_matmul tile {t.tm}x{t.tn}, {t.splits} splits"
        winner = "kernel" if d["use_fused"] else "plain"
        names = [q.split("/")[-1] for q in paths]
        log(f"    {key}: {', '.join(dict.fromkeys(names))} ({len(paths)} "
            f"sites): plain {fmt_us(d['plain_us'])}, kernel route "
            f"{fmt_us(d['fused_us'])} -> {winner}; {tiling}")
        rows.append({"key": list(key), "sites": paths, **d,
                     "winner": winner, "tiling": tiling})
    return rows


def run_calibrated_plan(report, slice_ctx) -> dict:
    """Phase 9: the paper's offline profiling step on full-width
    ResNet-18. The card's peaks measured (refresh, cache under build/);
    the measured-roofline plan (MeasuredCostModel, profile_kernels=True:
    per-site roofline verdict, execution membership, the prune) and the
    analytic plan with every shape profiled, each printed; the measured
    plan checked in deferred mode (clean: no flag, logits bitwise the
    unprotected ones, one host read per per_layer member plus one; a
    registry burst at a per_layer member and at a deferred member:
    detected, residual 0, logits back within rtol 1e-4); the new plans'
    launches per forward, their forwards timed in turns with the
    unprotected one and phase 4's pinned plan; and the decisions of
    build_plan(profile_kernels=True) for SmolLM-360M (policy only)."""
    import torch
    from repro_torch import configs, core
    from repro_torch.core import injection as inj
    from repro_torch.core import workflow
    from repro_torch.core.cost_model import MeasuredCostModel, measure_peaks
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn

    log("phase 9: the calibrated plan")
    params, x, cfg = slice_ctx["params"], slice_ctx["x"], slice_ctx["cfg"]
    fused, unprot, l0 = (slice_ctx["fused"], slice_ctx["unprot"],
                         slice_ctx["l0"])
    cache = str(ROOT / "build" / "roofline_cache.json")
    t0 = time.perf_counter()
    peaks = measure_peaks(cache_path=cache, refresh=True, device=DEVICE)
    peaks_s = time.perf_counter() - t0
    log(f"  measured peaks ({peaks_s:.1f} s): IEEE-fp32 GEMM "
        f"{peaks.peak_flops / 1e12:.2f} TFLOP/s ({peaks.peak_flops / FP32_FLOPS_PER_S * 100:.1f}% "
        f"of the datasheet's 67), triad {peaks.hbm_bw / 1e12:.3f} TB/s "
        f"({peaks.hbm_bw / HBM_BYTES_PER_S * 100:.1f}% of 3.35); ridge "
        f"{peaks.ridge:.2f} FLOP/B (datasheet "
        f"{FP32_FLOPS_PER_S / HBM_BYTES_PER_S:.2f})")
    if peaks.source != "measured":
        fail(f"peaks not measured: source {peaks.source}")
    if (peaks.peak_flops > 1.05 * FP32_FLOPS_PER_S
            or peaks.hbm_bw > 1.05 * HBM_BYTES_PER_S):
        fail(f"peaks above 105% of the datasheet: {peaks.doc()}")
    mcm = MeasuredCostModel.from_host(cache_path=cache, device=DEVICE)
    res = {"peaks": peaks.doc(), "peaks_s": peaks_s,
           "detect_chunk": mcm.detect_chunk(1024)}

    spec = core.protection_spec(cfg, batch=BATCH)
    t0 = time.perf_counter()
    measured = core.build_plan(params, cfg, cost_model=mcm, batch=BATCH,
                               profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["measured_build_s"] = time.perf_counter() - t0
    roof, kpm = measured.meta["roofline"], measured.meta["kernel_profile"]
    inline = [n for n in measured.names()
              if measured[n].execution == "per_layer"]
    deferred = [n for n in measured.names()
                if measured[n].execution == "deferred"]
    log(f"  measured plan ({res['measured_build_s']:.1f} s): "
        f"{len(inline)} per_layer + {len(deferred)} deferred members, "
        f"detection chunk {res['detect_chunk']}")
    sites = []
    for site in spec.sites:
        n, r, d = site.path, roof[site.path], kpm[site.path]
        what = ("pruned" if d.get("skipped") else
                f"profiled: plain {fmt_us(d['plain_us'])}, kernel route "
                f"{fmt_us(d['fused_us'])} -> "
                f"{'kernel' if d['use_fused'] else 'plain'}")
        log(f"    {n}: intensity {r['intensity']:.1f} FLOP/B, "
            f"{r['bound']}-bound, {measured[n].execution}, {what}")
        sites.append({"site": n, "intensity": r["intensity"],
                      "bound": r["bound"],
                      "execution": measured[n].execution, **d})
    res["measured"] = {"sites": sites, "inline": inline,
                       "deferred": deferred}

    t0 = time.perf_counter()
    profiled = core.build_plan(params, cfg, batch=BATCH,
                               profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["profiled_build_s"] = time.perf_counter() - t0
    log(f"  analytic plan, every shape profiled "
        f"({res['profiled_build_s']:.1f} s; {len(spec.sites)} sites):")
    res["profiled"] = log_profiles(profiled, spec)
    pruned_wins = [n for n in measured.names()
                   if kpm[n].get("skipped")
                   and profiled.meta["kernel_profile"][n]["use_fused"]]
    res["pruned_where_kernel_wins"] = pruned_wins
    log(f"  sites the roofline prune keeps on the plain route where the "
        f"analytic profile picks the kernel: {pruned_wins or 'none'}")

    # -- the measured plan in deferred mode: clean ---------------------------
    CR.LAUNCHES = AM.LAUNCHES = workflow.HOST_READS = 0
    lm, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                              correction="deferred")
    torch.cuda.synchronize()
    launches = {"measured/deferred": (CR.LAUNCHES, AM.LAUNCHES)}
    reads = workflow.HOST_READS
    bad = {n: v for n, v in rep.summary().items()
           if v["detected"] or v["residual"]}
    want_reads = len(inline) + (1 if deferred else 0)
    scale = float(l0.abs().max()) + 1.0
    fc_kernel = measured["fc"].cfg.use_fused_kernel
    same = torch.equal(lm, l0)
    log(f"  measured plan, deferred, clean: flags "
        f"{sum(v['detected'] for v in rep.summary().values())}/"
        f"{len(measured)}, host reads {reads} (want {want_reads}), "
        f"launches (conv sums, abft_matmul) {launches['measured/deferred']}, "
        f"logits bitwise the unprotected ones: {same}")
    if bad:
        fail(f"measured plan: clean forward reported {bad}")
    if reads != want_reads:
        fail(f"measured plan: {reads} host reads, want {want_reads}")
    if not (same or (fc_kernel and max_err(lm, l0) <= 1e-5 * scale)):
        fail(f"measured plan: logits differ from the unprotected forward "
             f"(max |diff| {max_err(lm, l0):.3g})")

    # -- a registry burst at a per_layer member and at a deferred member -----
    model = inj.FAULT_MODELS["burst"]
    gen = torch.Generator().manual_seed(SEED + 9)
    drills = {}
    targets = [("per_layer", inline), ("deferred", deferred)]
    for membership, members in targets:
        if not members:
            fail(f"the measured plan has no {membership} member")
        site = members[len(members) // 2]
        if site.startswith("conv"):
            layer = int(site[len("conv"):])
            _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
            sp = model.plan(gen, o_clean.shape[0], o_clean.shape[1],
                            o_clean.shape[2] * o_clean.shape[3], 100)
            o_bad = inj.inject(o_clean, sp.to(o_clean.device), model)
            lg, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                                      correction="deferred",
                                      inject_layer=layer, inject_o=o_bad)
        else:
            sp = model.plan(gen, BATCH, cfg.num_classes, 1, 100)
            hook = lambda o, sp=sp: inj.inject(o, sp.to(o.device), model)
            with inj.fault_scope(site, hook):
                lg, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                                          correction="deferred")
        summ = rep.summary()
        v = summ[site]
        others = {k: w for k, w in summ.items()
                  if k != site and w["detected"]}
        d_l = max_err(lg, lm)
        log(f"  burst at {site} ({membership}; axis {int(sp.axis)}, "
            f"{int(sp.nelem)} elements, scale {float(sp.scale):g}): "
            f"detected {v['detected']}, corrected_by {v['corrected_by']}, "
            f"residual {v['residual']}, logits max |diff| {d_l:.3g}")
        if not (v["detected"] == 1 and v["residual"] == 0
                and v["corrected_by"] != "none" and not others
                and torch.allclose(lg, lm, rtol=1e-4, atol=1e-4 * scale)):
            fail(f"measured plan, burst at {site}: {v}, others {others}, "
                 f"logit diff {d_l:.3g}")
        drills[site] = {**v, "membership": membership,
                        "logit_max_diff": d_l}
    res["drills"] = drills

    # -- launches per forward and times in turns ------------------------------
    for mode in ("per_layer", "deferred"):
        CR.LAUNCHES = AM.LAUNCHES = 0
        cnn.forward_cnn(params, x, cfg, plan=profiled, correction=mode)
        torch.cuda.synchronize()
        launches[f"profiled/{mode}"] = (CR.LAUNCHES, AM.LAUNCHES)
    res["launches"] = launches
    log("  launches per clean forward (conv sums, abft_matmul): " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    fwd = lambda plan, mode: (lambda: cnn.forward_cnn(params, x, cfg,
                                                      plan=plan,
                                                      correction=mode))
    times = time_host({
        "unprotected": unprot,
        "pinned/per_layer": fwd(fused, "per_layer"),
        "pinned/deferred": fwd(fused, "deferred"),
        "measured/deferred": fwd(measured, "deferred"),
        "profiled/per_layer": fwd(profiled, "per_layer"),
        "profiled/deferred": fwd(profiled, "deferred"),
    })
    res["forward_ms"] = times
    log("  median forward ms in turns: " + " ".join(
        f"{k}={v:.3f}" for k, v in times.items()))
    log("  error-free overhead: " + ", ".join(
        f"{k} {(v / times['unprotected'] - 1) * 100:.1f}%"
        for k, v in times.items() if k != "unprotected"))

    # -- SmolLM-360M: the profile's decisions ---------------------------------
    scfg = configs.get(SERVE_ARCH)
    sspec = core.protection_spec(scfg, batch=SLOTS, seq=128)
    t0 = time.perf_counter()
    splan = core.build_plan(None, scfg, batch=SLOTS, seq=128,
                            profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["smollm_build_s"] = time.perf_counter() - t0
    log(f"  {SERVE_ARCH} at batch {SLOTS} x seq 128, every GEMM profiled "
        f"in float32 as the reference does ({res['smollm_build_s']:.1f} s; "
        f"{len(sspec.sites)} sites):")
    res["smollm"] = log_profiles(splan, sspec)
    report["calibrated"] = res
    return res


# --------------------------------------------------------------------------
# phase 10: the async serving driver
# --------------------------------------------------------------------------

def step_period_ms(decode_log) -> float:
    """Median milliseconds between consecutive decode launches."""
    at = [e["launched_at"] for e in decode_log]
    return statistics.median((b - a) * 1e3 for a, b in zip(at, at[1:]))


def drive(params, cfg, plan, prompts, gen: int, paused=False, hook=None,
          **kw):
    """One ServingDriver over `prompts`: (driver, verdicts, report). The
    requests are submitted from this thread (inside `paused()` when
    `paused`, so they are admitted together) under `hook`'s fault_scope,
    which the driver's threads inherit; drain, then close."""
    import contextlib
    from repro_torch.core import injection
    from repro_torch.serving import ServingDriver
    d = ServingDriver(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                      device=DEVICE, **kw)
    scope = injection.fault_scope(*hook) if hook else contextlib.nullcontext()
    try:
        with scope:
            with d.paused() if paused else contextlib.nullcontext():
                verdicts = [d.submit(p, max_new_tokens=gen) for p in prompts]
            report = d.drain(timeout=900)
    finally:
        d.close()
    return d, verdicts, report


def run_driver_phase(report, serve_ctx) -> dict:
    """Phase 10: phase 6's SmolLM-360M, cut to its first DRIVER_PHASE_LAYERS
    layers at full width (the params are views of phase 6's, the plan is
    built for them), served by the async ServingDriver (8 slots, 256
    positions, deferred, the kernels pinned) on phase 6's 16 requests:
    every request completes with the synchronous session's tokens, 7 detect
    launches per layer plus the head's and one host read per forward;
    backpressure (capacity 4, 16 submitted at once: the rest rejected, the
    accepted served) and a lapsed deadline (timeout, never a slot); phase
    7's head drill under a fault_scope around submit/drain, attributed to
    the requests of slot 3 only; phase 7b's one-column corruption repaired
    in place by the controller's audit while requests are admitted; and
    the driver timed against the synchronous session in turns (step
    period, TTFT p50)."""
    import torch
    from repro_torch import core
    from repro_torch._tree import tree_map
    from repro_torch.core import weight_leaf, workflow
    from repro_torch.kernels import abft_matmul as AM

    log(f"phase 10: the async serving driver ({DRIVER_PHASE_LAYERS} layers)")
    cfg = serve_ctx["cfg"].replace(num_layers=DRIVER_PHASE_LAYERS)
    full = serve_ctx["params"]
    params = {**full, "stages": tree_map(lambda t: t[:DRIVER_PHASE_LAYERS],
                                         full["stages"])}
    fused = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    prompts = serve_ctx["prompts"]
    sess, rids, _, _ = serve(params, cfg, fused, prompts, GEN)
    tokens = [sess.tokens_for(r) for r in rids]
    del sess
    n_sites = cfg.stages()[1] * 7 + 1
    res = {"layers": DRIVER_PHASE_LAYERS}

    # -- the main path ---------------------------------------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    d, vs, rep = drive(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES}
    reads = workflow.HOST_READS
    same = [d.tokens_for(v.rid) for v in vs] == tokens
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  driver: {rep['completed']} requests, {c['prefills']} prefills + "
        f"{c['decode_steps']} decode steps, launches {launches}, host reads "
        f"{reads}, faults {c['faults_detected']}; tokens == the session's: "
        f"{same}")
    if not all(v.accepted for v in vs) or reasons != ["length"] * N_REQ:
        fail(f"driver: verdicts {vs}, finished {reasons}")
    if c["faults_detected"] or c["dropped"] or not same:
        fail(f"driver: counters {c}, tokens equal {same}")
    if launches != {"abft_matmul_detect": n_sites * forwards,
                    "abft_matmul": 0} or reads != forwards:
        fail(f"driver: {forwards} forwards launched {launches} with {reads} "
             f"host reads; want {n_sites} detect launches and 1 read each")
    res["main"] = {"counters": c, "launches": launches, "host_reads": reads,
                   "forwards": forwards}

    # -- backpressure and a lapsed deadline ----------------------------------------
    from repro_torch.serving import ServingDriver
    d = ServingDriver(params, cfg, fused, slots=SLOTS, max_len=MAX_LEN,
                      queue_capacity=4, device=DEVICE)
    try:
        with d.paused():
            dead = d.submit(prompts[0], max_new_tokens=8, deadline_s=1e-3)
            t0 = time.monotonic()
            while d.stats.record(dead.rid).finish_reason != "timeout":
                if time.monotonic() - t0 > 30:
                    fail("the lapsed request was not swept")
                time.sleep(0.01)
            vs = [d.submit(p, max_new_tokens=8) for p in prompts]
        rep = d.drain(timeout=900)
    finally:
        d.close()
    acc = [i for i, v in enumerate(vs) if v.accepted]
    rej = [v.reason for v in vs if not v.accepted]
    recs = {r["id"]: r for r in rep["requests"]}
    dr = recs[dead.rid]
    ok = (len(acc) == 4 and rej == ["queue_full"] * (N_REQ - 4)
          and rep["completed"] == 4
          and all(d.tokens_for(vs[i].rid) == tokens[i][:8] for i in acc)
          and dr["finish_reason"] == "timeout" and dr["slot"] is None
          and dr["admitted_at"] is None
          and rep["counters"]["timeouts"] == 1)
    log(f"  capacity 4, {N_REQ} submitted at once: accepted {len(acc)}, "
        f"rejected {len(rej)} ({set(rej)}), completed {rep['completed']} "
        f"with the session's tokens; lapsed deadline: {dr['finish_reason']}, "
        f"slot {dr['slot']}")
    if not ok:
        fail(f"backpressure/deadline: accepted {acc}, rejected {rej}, "
             f"lapsed {dr}, counters {rep['counters']}")
    res["backpressure"] = {"accepted": len(acc), "rejected": len(rej),
                           "lapsed": dr["finish_reason"]}

    # -- phase 7's head drill under a fault_scope around submit/drain -------------
    target = 3
    drill_prompts, clean = prompts[:SLOTS], [t[:8] for t in tokens[:SLOTS]]

    def decode_hook(o):
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 1234 % o.shape[-1]] += 1e4
        return o

    d, vs, rep = drive(params, cfg, fused, drill_prompts, 8, paused=True,
                       hook=("embed/table", decode_hook))
    recs = {r["id"]: r for r in rep["requests"]}
    by_slot = {recs[v.rid]["slot"]: recs[v.rid] for v in vs}
    cd = rep["counters"]
    hit_slots = sorted({i for e in d.stats.decode_log
                        for i, h in enumerate(e["hit"]) if h})
    t_rec = by_slot[target]
    ok = (t_rec["faults_detected"] >= 1
          and t_rec["corrections_applied"] == t_rec["faults_detected"]
          and t_rec["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and cd["residual_steps"] == 0 and hit_slots == [target])
    same = [d.tokens_for(v.rid) for v in vs] == clean
    log(f"  decode fault at embed/table, slot {target}, scope around "
        f"submit/drain: {cd['faults_detected']} detected / "
        f"{cd['faults_corrected']} corrected over {cd['decode_steps']} "
        f"steps; slot {target}'s request {t_rec['faults_detected']} "
        f"detected, the others 0; localizer hit slots {hit_slots}, "
        f"unattributed {cd['faults_unattributed']} (steps launched after "
        f"the last request finished), residual steps "
        f"{cd['residual_steps']}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"driver decode drill: {by_slot} counters {cd} tokens {same}")
    res["drill"] = {"counters": cd, "target": t_rec, "hit_slots": hit_slots}

    # -- phase 7b's one-column corruption, repaired by the controller's audit --
    clone = lambda t: ({k: clone(v) for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    bits = lambda t: t.contiguous().view(torch.int16)
    sp = clone(params)
    d = ServingDriver(sp, cfg, fused, slots=SLOTS, max_len=MAX_LEN,
                      audit_every=1, restore_fn=lambda: params,
                      device=DEVICE)
    try:
        first = [d.submit(p, max_new_tokens=8) for p in drill_prompts[:4]]
        t0 = time.monotonic()
        while d.tokens_generated(first[0].rid) < 2:
            if time.monotonic() - t0 > 300:
                fail("the audit drill made no progress")
            time.sleep(0.01)
        with d.paused():
            what = corrupt_one_column(weight_leaf(d.params, AUDIT_ENTRY),
                                      torch.Generator().manual_seed(SEED + 7))
            later = [d.submit(p, max_new_tokens=8)
                     for p in drill_prompts[4:]]
        rep = d.drain(timeout=900)
    finally:
        d.close()
    c = rep["counters"]
    vs = first + later
    verdicts = sorted({v for r in rep["requests"] for v in r["audit_verdicts"]})
    same = [d.tokens_for(v.rid) for v in vs] == clean
    leaf_ok = torch.equal(bits(weight_leaf(d.params, AUDIT_ENTRY)),
                          bits(weight_leaf(params, AUDIT_ENTRY)))
    log(f"  audit drill ({what}, corrupted between two steps, 4 requests "
        f"submitted meanwhile): audits {c['weight_audits']}, repairs "
        f"{c['weight_repairs']}, restores {c['weight_restores']}, verdicts "
        f"{verdicts}, repair ms {[round(r * 1e3, 2) for r in d.stats.repair_s]}; "
        f"leaf bitwise clean {leaf_ok}; {rep['completed']} completed, "
        f"tokens == clean: {same}")
    if not (c["weight_repairs"] == 1 and c["weight_restores"] == 0
            and "repaired" in verdicts and leaf_ok and same
            and all(v.accepted for v in later) and rep["completed"] == 8
            and not c["faults_detected"]):
        fail(f"driver audit drill: counters {c}, verdicts {verdicts}, leaf "
             f"{leaf_ok}, tokens {same}")
    res["audit"] = {"what": what, "counters": c, "verdicts": verdicts,
                    "repair_ms": [r * 1e3 for r in d.stats.repair_s]}
    del sp

    # -- the driver against the synchronous session, in turns --------------------
    times = {k: {"step_ms": [], "ttft_ms": []} for k in ("session", "driver")}
    for rnd in range(TIMED_ROUNDS):
        for k in (("session", "driver") if rnd % 2 == 0
                  else ("driver", "session")):
            if k == "session":
                sess, _, rp, _ = serve(params, cfg, fused, prompts, GEN)
                dlog = sess.stats.decode_log
            else:
                dd, _, rp = drive(params, cfg, fused, prompts, GEN)
                dlog = dd.stats.decode_log
            times[k]["step_ms"].append(step_period_ms(dlog))
            times[k]["ttft_ms"].append(rp["ttft_p50_s"] * 1e3)
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    for k, v in times.items():
        log(f"  {k}: decode step period ms {[round(t, 3) for t in v['step_ms']]}, "
            f"TTFT p50 ms {[round(t, 2) for t in v['ttft_ms']]}")
    log(f"  driver / session: step period "
        f"{med['driver']['step_ms'] / med['session']['step_ms']:.3f}, TTFT "
        f"p50 {med['driver']['ttft_ms'] / med['session']['ttft_ms']:.3f}")
    res["times"], res["medians"] = times, med
    report["driver"] = res
    return res


# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------

def grads_within(x, ref, dtype, absdot, k: int) -> bool:
    """A product of the kernel route (O, dD or dW) against autograd of the
    plain product. bf16: one bf16 ulp of the result plus the fp32
    summation noise of the K-term dot products on either side, 2^-21
    sqrt(K) |A| @ |B| (Higham and Mary's probabilistic bound, 4 sqrt(K) u
    per side): two fp32 sums that differ by reassociation, each rounded
    once, where a cancelled element's noise exceeds a relative ulp. fp32:
    rtol 1e-5 with an atol of 1e-5 of the scale."""
    import torch
    if dtype == torch.bfloat16:
        tol = ref.float().abs() * 2.0 ** -7 + 2.0 ** -21 * k ** 0.5 * absdot
        return bool(((x.float() - ref.float()).abs() <= tol).all())
    return torch.allclose(x, ref, rtol=1e-5,
                          atol=1e-5 * float(ref.abs().max()))


def check_training_gemms(report) -> dict:
    """Phase 11a: abft_matmul_vjp at SmolLM-360M's training GEMM shapes
    (TRAIN_ROWS rows, the five distinct (K, M) of SERVE_SITES) in bf16 and
    f32 with the kernel pinned: O, dD and dW against autograd of
    matmul_raw; 3 abft_matmul launches per call (1 with protect_backward
    off, 4 where a burst's ladder recomputes through the kernel); clean
    reports; a registry burst in dW's and in dD's output,
    in fp32 detected, corrected with residual 0 and the gradients back
    within the clean tolerance plus the fix's rounding (in bf16 the
    verdicts are recorded: ROADMAP 3.5); and per shape the device ms of
    the backward's two kernel launches, the D^T copy, torch.matmul and
    the plain version for each product, beside the bound."""
    import torch
    from repro_torch import fp32_ieee
    from repro_torch.core import (DEFAULT_CONFIG, abft_matmul_vjp,
                                  plan_scope)
    from repro_torch.core import injection as inj
    from repro_torch.core import types as T
    from repro_torch.core.protected import matmul_raw, pick_chunk
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_ref

    n = TRAIN_ROWS
    cfg = DEFAULT_CONFIG.replace(use_fused_kernel=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    model = inj.FAULT_MODELS["burst"]
    cpu_gen = torch.Generator().manual_seed(SEED + 11)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        elt = 2 if dtype == torch.bfloat16 else 4
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else FP32_FLOPS_PER_S
        for label, k, m, transposed, _ in SERVE_SITES:
            what = f"{label} ({n}x{k})@({k}x{m}) {str(dtype)[6:]}"
            d = torch.randn((n, k), generator=gen, device=DEVICE).to(dtype)
            store = (torch.randn((m, k) if transposed else (k, m),
                                 generator=gen, device=DEVICE)
                     * k ** -0.5).to(dtype)
            view = (lambda t: t.T) if transposed else (lambda t: t)
            g = torch.randn((n, m), generator=gen, device=DEVICE).to(dtype)

            def run(fn, hook=None):
                a = d.clone().requires_grad_(True)
                b = store.clone().requires_grad_(True)
                scope = inj.fault_scope(*hook) if hook else \
                    contextlib.nullcontext()
                with fp32_ieee(), plan_scope(), scope:
                    o = fn(a, view(b))
                with fp32_ieee():
                    da, db = torch.autograd.grad(o, (a, b), g)
                torch.cuda.synchronize()
                return o.detach(), da, (db.T if transposed else db)

            ref = run(matmul_raw)
            # |A| @ |B| of each product (O, dD, dW), and its contraction
            da, sa, ga = d.float().abs(), view(store).float().abs(), \
                g.float().abs()
            absdot = (da @ sa, ga @ sa.T, da.T @ ga)
            ks = (k, m, n)
            del da, sa, ga
            row = {"site": label, "dtype": str(dtype)[6:], "shape": [n, k, m],
                   "w_transposed": transposed}
            for protect, want in ((True, 3), (False, 1)):
                reports = []
                AM.LAUNCHES = 0
                got = run(lambda a, b: abft_matmul_vjp(
                    a, b, cfg.replace(protect_backward=protect), reports))
                if AM.LAUNCHES != want:
                    fail(f"abft_matmul_vjp {what} protect_backward="
                         f"{protect}: {AM.LAUNCHES} abft_matmul launches, "
                         f"want {want}")
                v = [tuple(int(x) for x in r) for r in reports]
                if v != [(0, 0, 0)] * (2 if protect else 0):
                    fail(f"abft_matmul_vjp {what}: clean reports {v}")
                for x, y, a_, k_, nm in zip(got, ref, absdot, ks,
                                            ("O", "dD", "dW")):
                    if not grads_within(x, y, dtype, a_, k_):
                        fail(f"abft_matmul_vjp {what} protect_backward="
                             f"{protect}: {nm} max |err| {max_err(x, y):.3g}")
                if protect:
                    row["max_abs_err"] = {nm: max_err(x, y) for x, y, nm in
                                          zip(got, ref, ("O", "dD", "dW"))}
            # a registry burst in each backward product's output. In fp32:
            # detected, corrected, residual 0, the gradient back within the
            # clean tolerance plus the located fix's rounding, 8 eps32 of the
            # largest corrupted value (ROADMAP 3.4). In bf16 the verdicts are
            # recorded, not gated: the reference's bf16 thresholds let bursts
            # through or accept wrong fixes (ROADMAP 3.5)
            drills = {}
            for product, (po, pm) in (("dW", (k, m)), ("dD", (n, k))):
                sp = model.plan(cpu_gen, po, pm, 1, 100)
                worst = []

                def hook(o, sp=sp, worst=worst):
                    bad = inj.inject(o, sp.to(o.device), model)
                    worst.append(float(bad.float().abs().max()))
                    return bad

                reports = []
                AM.LAUNCHES = 0
                got = run(lambda a, b: abft_matmul_vjp(a, b, cfg, reports),
                          hook=(product, hook))
                v = [tuple(int(x) for x in r) for r in reports]
                hit = v[0 if product == "dD" else 1]
                other = v[1 if product == "dD" else 0]
                errs = {nm: max_err(x, y) for x, y, nm in
                        zip(got, ref, ("O", "dD", "dW"))}
                scale = {nm: float(y.abs().max()) for y, nm in
                         zip(ref, ("O", "dD", "dW"))}
                fix = 8 * 2.0 ** -23 * worst[0]
                ok = all(torch.allclose(x.float(), y.float(), rtol=1e-5,
                                        atol=1e-5 * scale[nm] + fix)
                         for x, y, nm in zip(got, ref, ("O", "dD", "dW")))
                del got
                drills[product] = {"axis": int(sp.axis),
                                   "elements": int(sp.nelem),
                                   "scale": float(sp.scale),
                                   "verdict": hit, "other": other,
                                   "launches": AM.LAUNCHES,
                                   "max_abs_err": errs,
                                   "err_over_scale": errs[product] /
                                   scale[product],
                                   "gated": dtype == torch.float32,
                                   "within": ok}
                # the ladder recomputes through the site's route, one
                # launch more, where it fell back to a recompute or took a
                # sub-fp32 scheme fix's elements from the route's product
                recomputed = hit[1] == T.RECOMPUTE or (
                    dtype != torch.float32
                    and hit[1] in (T.COC, T.RC, T.CLC, T.FC))
                if AM.LAUNCHES != 3 + recomputed or other != (0, 0, 0):
                    fail(f"abft_matmul_vjp {what}: burst in {product}: "
                         f"launches {AM.LAUNCHES}, verdict {hit}, the other "
                         f"product's verdict {other}")
                if dtype == torch.float32 and not (
                        hit[0] == 1 and hit[1] != 0 and hit[2] == 0 and ok):
                    fail(f"abft_matmul_vjp {what}: burst in {product} "
                         f"(axis {int(sp.axis)}, {int(sp.nelem)} elements, "
                         f"scale {float(sp.scale):g}): verdict {hit}, errors "
                         f"{errs}, fix allowance {fix:.3g}")
            row["bursts"] = drills
            del absdot, ref
            # device times of the backward's products, inputs cold in L2:
            # dD reads W^T in place, dW a copy of D^T made beforehand
            with torch.no_grad(), fp32_ieee():
                args = copies([d, store, g, d.T.contiguous()])
                tile = lambda r, c: (ops._tile(pick_chunk(r, 1024), 256),
                                     ops._tile(pick_chunk(c, 1024), 256))
                (bmd, bnd), (bmw, bnw) = tile(n, k), tile(k, m)
                t = {
                    "dD": time_device(lambda a, b, c, e: AM.abft_matmul(
                        c, view(b).T, bmd, bnd), args),
                    "dW": time_device(lambda a, b, c, e: AM.abft_matmul(
                        e, c, bmw, bnw), args),
                    "dT_copy": time_device(
                        lambda a, b, c, e: a.T.contiguous(), args),
                    "dD_plain": time_device(lambda a, b, c, e: abft_matmul_ref(
                        c, view(b).T, bmd, bnd), args),
                    "dW_plain": time_device(lambda a, b, c, e: abft_matmul_ref(
                        e, c, bmw, bnw), args),
                    "dD_torch_matmul": time_device(
                        lambda a, b, c, e: torch.matmul(c, view(b).T), args),
                    "dW_torch_matmul": time_device(
                        lambda a, b, c, e: torch.matmul(a.T, c), args)}
                del args
            flops = 2.0 * n * k * m
            part = lambda r, c, bm, bn: 4.0 * (-(-r // bm) * c + r * -(-c // bn)
                                               + -(-r // bm) * -(-c // bn))
            t["dD_bound"], t["dD_bound_by"] = bound_ms(
                elt * (n * m + m * k + n * k) + part(n, k, bmd, bnd), flops,
                peak)
            t["dW_bound"], t["dW_bound_by"] = bound_ms(
                elt * (k * n + n * m + k * m) + part(k, m, bmw, bnw), flops,
                peak)
            t["dT_copy_bound"], _ = bound_ms(2.0 * elt * n * k, 0.0)
            row["ms"] = t
            rows.append(row)
            log(f"  {what}: 3 launches, clean; O/dD/dW max |err| "
                + "/".join(f"{row['max_abs_err'][x]:.3g}"
                           for x in ("O", "dD", "dW"))
                + "; bursts " + ", ".join(
                    f"{p} {r['verdict']} (axis {r['axis']}, {r['elements']} "
                    f"el. x{r['scale']:g}; |err|/scale "
                    f"{r['err_over_scale']:.3g}"
                    + ("" if r["gated"] else ", not gated") + ")"
                    for p, r in drills.items()))
            log(f"    backward ms: dD kernel {t['dD']:.4f} (torch.matmul "
                f"{t['dD_torch_matmul']:.4f}, plain {t['dD_plain']:.4f}, "
                f"bound {t['dD_bound']:.4f} {t['dD_bound_by']}); D^T copy "
                f"{t['dT_copy']:.4f} (bound {t['dT_copy_bound']:.4f}); dW "
                f"kernel {t['dW']:.4f} (torch.matmul "
                f"{t['dW_torch_matmul']:.4f}, plain {t['dW_plain']:.4f}, "
                f"bound {t['dW_bound']:.4f} {t['dW_bound_by']})")
    report["training_gemms"] = rows
    return rows


def run_training(report) -> dict:
    """Phase 11b: the train step (launch.steps.make_train_step) at
    SmolLM-360M's full width and TRAIN_LAYERS of its 32 layers, bf16
    params and fp32 AdamW state,
    batch TRAIN_BATCH x TRAIN_SEQ in TRAIN_MB microbatches, warmup 1, lr
    TRAIN_LR, over three cycled host_batch batches for TRAIN_STEPS steps:
    every report clean and every loss finite, the last loss below the
    first, one step bitwise its abft=False twin from the same state (and
    its own rerun), no kernel launched (the step runs the plain route, as
    the JAX package's does); per step ms, host reads, peak memory, and a
    profile of one step."""
    import torch
    from repro_torch import configs
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.core import workflow
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    from repro_torch.optim import OptConfig

    log(f"phase 11b: the train step at full width, {TRAIN_LAYERS} layers")
    cfg = configs.get(SERVE_ARCH).replace(num_layers=TRAIN_LAYERS)
    opt = OptConfig(lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = S.init_train_state(torch.Generator().manual_seed(SEED), cfg, opt,
                               device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in
                   tree_flatten_with_path(state["params"]))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = []
    for i in range(3):
        tk, lb = host_batch(dcfg, i)
        batches.append({"tokens": tk.to(DEVICE), "labels": lb.to(DEVICE)})
    step = S.make_train_step(cfg, opt, microbatches=TRAIN_MB, warmup=1)
    log(f"  {SERVE_ARCH}: {n_params / 1e6:.1f} M params bf16, AdamW state "
        f"fp32; batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches;"
        f" init {init_s:.1f} s")
    losses, ms, reads, launches = [], [], [], 0
    mid = None
    AM.LAUNCHES = AM.DETECT_LAUNCHES = 0
    for i in range(TRAIN_STEPS):
        if i == 2:
            mid = state
        workflow.HOST_READS = 0
        t0 = time.perf_counter()
        state, m = step(state, batches[i % 3])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(workflow.HOST_READS)
        loss = float(m["loss"])
        v = tuple(int(x) for x in m["report"])
        losses.append(loss)
        if v != (0, 0, 0) or not math.isfinite(loss):
            fail(f"train step {i}: report {v}, loss {loss}")
    launches = AM.LAUNCHES + AM.DETECT_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    log("  losses " + " ".join(f"{x:.4f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches:
        fail(f"{launches} kernel launches in the train steps, want 0 (the "
             "step runs the plain protected route)")
    # -- one protected step bitwise its abft=False twin ---------------------
    batch = batches[2]
    twin = S.make_train_step(cfg.replace(abft=False), opt,
                             microbatches=TRAIN_MB, warmup=1)
    a, ma = step(mid, batch)
    b, mb = twin(mid, batch)
    c, mc = step(mid, batch)
    torch.cuda.synchronize()
    fa, fb, fc = (tree_flatten_with_path(x) for x in (a, b, c))
    diff = [n for (n, x), (_, y) in zip(fa, fb) if not torch.equal(x, y)]
    rerun = [n for (n, x), (_, y) in zip(fa, fc) if not torch.equal(x, y)]
    same = (not diff and torch.equal(ma["loss"], mb["loss"])
            and torch.equal(ma["gnorm"], mb["gnorm"]))
    log(f"  step 2 from the same state: protected == abft=False bitwise: "
        f"{same} (leaves differing: {diff[:4]}); rerun bitwise: "
        f"{not rerun}")
    if not same:
        fail(f"the protected step differs from its abft=False twin in "
             f"{diff} (rerun differs in {rerun}); loss {float(ma['loss'])} "
             f"vs {float(mb['loss'])}")
    del a, b, c, fa, fb, fc, mid
    prof = profile_forward(lambda: step(state, batch))
    steady = ms[1:]
    res = {"params_m": n_params / 1e6, "init_s": init_s, "losses": losses,
           "step_ms": ms, "median_step_ms": statistics.median(steady),
           "host_reads_per_step": reads,
           "peak_mem_gb": peak / 2 ** 30, "kernel_launches": launches,
           "bitwise_twin": same, "profile": prof}
    log(f"  median step {res['median_step_ms']:.1f} ms (steps 1-"
        f"{TRAIN_STEPS - 1}; step 0 {ms[0]:.1f}); host reads per step "
        f"{reads[1]}; peak memory {res['peak_mem_gb']:.2f} GiB; profile of "
        f"one step: {prof['kernels']} device kernels, device busy "
        f"{prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    for e in prof["top"][:6]:
        log(f"    {e['ms']:.3f} ms  x{e['calls']}  {e['name'][:90]}")
    report["training"] = res
    return res


def run_train_driver(report) -> dict:
    """Phase 11c: repro_torch.launch.train.train on SmolLM-360M at full
    width and DRIVER_LAYERS layers (a registry entry for the run), with
    checkpoints under build/: 6 steps uninterrupted; 3 steps, then a fresh
    train() that restores the step-3 checkpoint and runs to step 6,
    bitwise the uninterrupted run (params and AdamW state, the bf16
    leaves through their '<V2' files); one byte of a saved leaf flipped
    makes restore raise IOError; one element of the tied head's output
    corrupted in one step (fault_scope at "embed/table" inside an empty
    plan_scope, which makes the paths live and changes nothing else):
    corrected, counted by StepRunner, that step's loss within rtol 1e-4
    of the clean run's."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import archs
    from repro_torch.core import injection as inj
    from repro_torch.core import plan_scope
    from repro_torch.launch.train import train

    log("phase 11c: the training driver and its fault tolerance")
    arch = f"{SERVE_ARCH}-{DRIVER_LAYERS}-layers"
    archs.ARCH_BUILDERS[arch] = lambda: configs.get(SERVE_ARCH).replace(
        num_layers=DRIVER_LAYERS)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MB,
              lr=TRAIN_LR, ckpt_every=3, seed=SEED, device=DEVICE)
    res = {}
    try:
        t0 = time.perf_counter()
        full, hist, stats = train(arch, 6, ckpt_dir=str(root / "a"), **kw)
        res["uninterrupted_s"] = time.perf_counter() - t0
        _, h1, _ = train(arch, 3, ckpt_dir=str(root / "b"), **kw)
        resumed, h2, _ = train(arch, 6, ckpt_dir=str(root / "b"), **kw)
        fa, fb = tree_flatten_with_path(full), tree_flatten_with_path(resumed)
        diff = [n for (n, x), (_, y) in zip(fa, fb)
                if not (x.dtype == y.dtype and torch.equal(x, y))]
        step3 = root / "b" / "step_00000003"
        man = json.loads((step3 / "manifest.json").read_text())
        bf16 = [n for n, e in man["leaves"].items() if e["dtype"] == "bfloat16"]
        heads = {(step3 / man["leaves"][n]["file"]).read_bytes()[10:30]
                 for n in bf16}
        log(f"  restart: losses {' '.join(f'{x:.4f}' for x in hist)}; "
            f"resumed {' '.join(f'{x:.4f}' for x in h1 + h2)}; final state "
            f"bitwise: {not diff} ({len(fa)} leaves, {len(bf16)} bf16 leaves "
            f"saved as {sorted(heads)})")
        if diff or h1 + h2 != hist:
            fail(f"restart from step 3 differs in {diff}; losses {hist} vs "
                 f"{h1 + h2}")
        if not bf16 or any(b"'<V2'" not in h for h in heads):
            fail(f"bf16 leaves not saved as '<V2' files: {heads}")
        # -- one byte flipped -------------------------------------------------
        mgr = CheckpointManager(str(root / "b"))
        victim = step3 / man["leaves"][bf16[0]]["file"]
        raw = bytearray(victim.read_bytes())
        raw[-7] ^= 0xFF
        victim.write_bytes(bytes(raw))
        try:
            mgr.restore(3, full)
        except IOError as e:
            log(f"  one byte of {bf16[0]} flipped: restore refused ({e})")
        else:
            fail("a checkpoint with a flipped byte restored without error")
        # -- a forward fault in one step ----------------------------------------
        calls = {"n": 0}
        fault_call = 3 * TRAIN_MB      # step 3's first microbatch

        def hook(o):
            calls["n"] += 1
            if calls["n"] - 1 != fault_call:
                return o
            o = o.clone()
            o[1, 7, 123] += 1e4           # phase 7's head drill
            return o

        with plan_scope(), inj.fault_scope("embed/table", hook):
            _, hf, sf = train(arch, 6, **kw)
        d_loss = abs(hf[3] - hist[3])
        log(f"  one element of the head's output corrupted in step 3: "
            f"StepRunner stats {sf}; loss {hf[3]:.6f} vs clean "
            f"{hist[3]:.6f} (|diff| {d_loss:.3g})")
        if not (sf["faults_detected"] == 1 and sf["faults_corrected"] == 1
                and sf["retries"] == 0 and calls["n"] == 6 * TRAIN_MB
                and d_loss <= 1e-4 * abs(hist[3])):
            fail(f"forward fault in a train step: stats {sf}, hook calls "
                 f"{calls['n']}, loss {hf[3]} vs {hist[3]}")
        res.update({"losses": hist, "resumed_losses": h1 + h2,
                    "bf16_leaves": len(bf16), "fault_stats": sf,
                    "fault_loss": hf[3], "clean_loss": hist[3]})
    finally:
        archs.ARCH_BUILDERS.pop(arch, None)
        shutil.rmtree(root, ignore_errors=True)
    report["train_driver"] = res
    return res


def run_training_phase(report) -> dict:
    """Phase 11: 11a, 11b and 11c, timed."""
    log("phase 11: training")
    t0 = time.perf_counter()
    log("phase 11a: abft_matmul_vjp at the training GEMM shapes")
    check_training_gemms(report)
    run_training(report)
    run_train_driver(report)
    secs = time.perf_counter() - t0
    log(f"  phase 11: {secs:.1f} s")
    report["training_s"] = secs
    return report


# --------------------------------------------------------------------------
# phases 12, 13 and 14: serving a model of its own (Mamba2-1.3B,
# RecurrentGemma-2B, MusicGen-large)
# --------------------------------------------------------------------------

def run_recurrent_serving(report, key: str, arch: str, layers: int,
                          n_sites: int, prefill_site: str, decode_site: str,
                          table_scale: float = 1.0,
                          rounds: int = TIMED_ROUNDS) -> dict:
    """`arch` at full width and `layers` layers (0: its full depth) in bf16
    (random params drawn on the card from a seed; the embedding table
    times `table_scale`)
    served as phase 6 serves SmolLM-360M: deferred, the kernels pinned, 8
    slots, 16 requests (prompts of 16-128 tokens, (S, K) arrays for a
    model with K codebooks, each prefilled at its own length when the
    model is recurrent, in its bucket otherwise), 32 new tokens each
    (K-lists with K codebooks). Checks: every request finishes by length,
    zero flags, no slot hit, `n_sites` detect launches and 1 host read per
    forward; no request whose every served token is its prompt's last
    one (an echo); per_layer serves the first 8 requests' 8 tokens
    alike with `n_sites` reads and abft_matmul launches per forward;
    teacher-forced through the uncached forward, every served token's bf16
    margin below the unprotected forward's top logit within twice the
    routes' logit gap plus DELTA, and a float32 twin of the same weights
    within DELTA. Timing: the unprotected and the kernels-on sessions in
    turns; a profile of one decode step of each. Drills: +1e4 at the head
    on slot 3 in every decode step, +1e3 in every prefill at one repeat's
    `prefill_site`, and +1e4 at one repeat's `decode_site` on slot 3 in
    one mid-stream decode step (the corrective rerun must start from the
    step's input state: every later token equals the clean run's).
    `rounds` rounds of the timed sessions. Written to report[key]."""
    import torch
    from repro_torch import configs, core
    from repro_torch._tree import tree_map
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as M
    from repro_torch.serving import ProtectedSession

    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    # drawn on the card: seconds for a model of billions of params, where
    # the host's generator takes most of a minute
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    if table_scale != 1.0:
        params["embed"]["table"].mul_(table_scale)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                           device=DEVICE)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = core.force_fused_matmul(plan)
    reps = cfg.stages()[1]
    calls = sum(reps if e.stack else 1 for e in fused.entries.values())
    if calls != n_sites:
        fail(f"the plan's {len(fused)} entries make {calls} protected GEMMs "
             f"per forward, want {n_sites}")
    head = "embed/table" if cfg.tie_embeddings else "embed/head"
    log(f"  {cfg.name}: {cfg.num_layers} layers, "
        f"{M.count_params(cfg) / 1e6:.1f} M params bf16, {n_sites} "
        f"protected GEMMs per forward; init {init_s:.1f} s, build_plan "
        f"{plan_s:.1f} s")
    res = {"init_s": init_s, "build_plan_s": plan_s}
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)

    # -- the main path: deferred, kernels pinned -----------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    sess, rids, rep, steps = serve(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES}
    reads = workflow.HOST_READS
    tokens = {r: sess.tokens_for(r) for r in rids}
    distinct = [len({token_key(x) for x in t}) for t in tokens.values()]
    echoes = [r for r, p in zip(rids, prompts)
              if all(token_key(x) == token_key(p[-1].tolist())
                     for x in tokens[r])]
    log(f"  distinct tokens per request: {distinct}; requests echoing the "
        f"prompt's last token: {len(echoes)}")
    if echoes:
        fail(f"requests {echoes} echo their prompt's last token")
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  deferred, kernels on: {rep['completed']} requests (prompts "
        f"{sorted(len(p) for p in prompts)}), {c['prefills']} prefills + "
        f"{c['decode_steps']} decode steps, launches {launches}, host reads "
        f"{reads}, faults {c['faults_detected']}")
    if reasons != ["length"] * N_REQ or rep["completed"] != N_REQ:
        fail(f"requests finished with {reasons}")
    if c["faults_detected"] or c["dropped"] or c["faults_unattributed"]:
        fail(f"clean serving counted {c}")
    if any(any(h) for h in steps["hits"]):
        fail("the slot localizer hit on a clean step")
    if launches != {"abft_matmul_detect": n_sites * forwards,
                    "abft_matmul": 0} or reads != forwards:
        fail(f"{forwards} clean forwards launched {launches} with {reads} host "
             f"reads; want {n_sites} detect launches and 1 read each")
    res["deferred"] = {"counters": c, "launches": launches,
                       "host_reads": reads, "forwards": forwards,
                       "distinct_tokens": distinct}

    # -- per_layer serves the same tokens ------------------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    s_pl, r_pl, rep_pl, _ = serve(params, cfg, fused, prompts[:8], 8,
                                  correction="per_layer")
    f_pl = rep_pl["counters"]["prefills"] + rep_pl["counters"]["decode_steps"]
    got = [s_pl.tokens_for(r) for r in r_pl]
    want = [tokens[r][:8] for r in rids[:8]]
    log(f"  per_layer, first 8 requests x 8 tokens: host reads "
        f"{workflow.HOST_READS} over {f_pl} forwards, abft_matmul launches "
        f"{AM.LAUNCHES}; tokens == deferred: {got == want}")
    if got != want:
        fail(f"per_layer tokens {got} differ from deferred's {want}")
    if workflow.HOST_READS != n_sites * f_pl or AM.LAUNCHES != n_sites * f_pl:
        fail(f"per_layer: {workflow.HOST_READS} reads, {AM.LAUNCHES} launches")
    res["per_layer"] = {"host_reads": workflow.HOST_READS, "forwards": f_pl,
                        "launches": AM.LAUNCHES}

    # -- teacher-forced through the uncached forward -------------------------
    # In bf16 the two routes of one uncached forward (the kernels, cuBLAS)
    # differ by rounding only, and deep models carry that to logit gaps far
    # above DELTA: the gap is this model's noise floor. A served token was
    # the top of logits that lie within about that gap of the unprotected
    # ones, so its margin below their top is held to twice the gap (plus
    # DELTA for the cached against the uncached forward). The DELTA gate
    # holds the same weights in float32, served through the same session
    # and kernels.
    ucfg = cfg.replace(abft=False)
    gap, worst = teacher_forced(params, cfg, fused, prompts,
                                [tokens[r] for r in rids])
    log(f"  teacher-forced, bf16: the kernel route and cuBLAS differ by up to "
        f"{gap:.4g} in a logit on the same uncached forwards (the noise "
        f"floor); served tokens at most {worst:.4g} below the unprotected "
        f"top logit (limit 2 x gap + {DELTA} = {2 * gap + DELTA:.4g})")
    if not worst <= 2 * gap + DELTA:
        fail(f"bf16: a served token's unprotected logit is {worst:.4g} below "
             f"the top, beyond twice the routes' gap {gap:.4g} plus {DELTA}")
    res["teacher_forced_bf16"] = {"max_logit_gap": gap, "max_margin": worst}
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    fused32 = core.force_fused_matmul(core.build_plan(
        p32, cfg32, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    s32, r32, rep32, _ = serve(p32, cfg32, fused32, prompts[:SLOTS], 8)
    c32 = rep32["counters"]
    if c32["faults_detected"] or rep32["completed"] != SLOTS:
        fail(f"float32 twin: counters {c32}")
    gap32, worst32 = teacher_forced(p32, cfg32, fused32, prompts[:SLOTS],
                                    [s32.tokens_for(r) for r in r32])
    log(f"  teacher-forced, float32 twin (the same weights, first 8 requests "
        f"x 8 tokens through the session and kernels): largest logit gap "
        f"{gap32:.4g}; served tokens at most {worst32:.4g} below the "
        f"unprotected uncached forward's top logit (limit {DELTA})")
    if not worst32 <= DELTA:
        fail(f"float32 twin: a served token's reference logit is "
             f"{worst32:.4g} below the top")
    res["teacher_forced_f32"] = {"max_logit_gap": gap32,
                                 "max_margin": worst32}
    del p32, fused32, s32

    # -- timings: two sessions in turns --------------------------------------
    sessions = {"unprotected": (ucfg, None), "kernels_on": (cfg, fused)}
    times = {k: {"decode_ms": [], "ttft_ms": []} for k in sessions}
    for rnd in range(rounds):
        keys = list(sessions)
        for k in keys[rnd % 2:] + keys[:rnd % 2]:
            kcfg, kplan = sessions[k]
            _, _, rp, st = serve(params, kcfg, kplan, prompts, GEN)
            times[k]["decode_ms"].append(statistics.median(st["ms"]))
            times[k]["ttft_ms"].append(rp["ttft_p50_s"] * 1e3)
    for k, v in times.items():
        log(f"  {k}: median decode step ms {v['decode_ms']}, TTFT p50 ms "
            f"{v['ttft_ms']}")
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    over = {m: med["kernels_on"][m] / med["unprotected"][m] - 1
            for m in med["kernels_on"]}
    log(f"  error-free overhead, kernels on: decode step "
        f"{over['decode_ms'] * 100:.1f}%, TTFT p50 {over['ttft_ms'] * 100:.1f}%")
    res["times"], res["overhead"] = times, over

    # -- profile of one decode step of each ------------------------------------
    res["profile"] = {}
    for k, (kcfg, kplan) in sessions.items():
        ps = ProtectedSession(params, kcfg, kplan, slots=SLOTS,
                              max_len=MAX_LEN, device=DEVICE)
        for p in prompts[:SLOTS]:
            ps.submit(p, max_new_tokens=GEN)
        ps.step()                     # admits all 8, one decode step
        prof = profile_forward(ps.step)
        res["profile"][k] = prof
        log(f"  profile, one decode step {k}: wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['device_ms']:.3f} ms ({prof['kernels']} "
            f"kernels), idle share {prof['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in prof["top"][:5]))
        del ps

    # -- drills ------------------------------------------------------------------
    drill_prompts, drill_ids = prompts[:SLOTS], rids[:SLOTS]
    clean = [tokens[r][:8] for r in drill_ids]
    target, rep_hit = 3, reps // 2

    def by_slot_of(rp, ids):
        recs = {r["id"]: r for r in rp["requests"]}
        return {recs[r]["slot"]: recs[r] for r in ids}

    def head_hook(o):
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 1234 % o.shape[-1]] += 1e4
        return o

    s_d, r_d, rep_d, st_d = serve(params, cfg, fused, drill_prompts, 8,
                                  hook=(head, head_hook))
    by_slot, cd = by_slot_of(rep_d, r_d), rep_d["counters"]
    hit_slots = sorted({i for h in st_d["hits"] for i, x in enumerate(h) if x})
    same = [s_d.tokens_for(r) for r in r_d] == clean
    ok = (by_slot[target]["faults_detected"] == cd["decode_steps"]
          and by_slot[target]["corrections_applied"] == cd["decode_steps"]
          and by_slot[target]["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and cd["faults_unattributed"] == 0 and cd["residual_steps"] == 0
          and hit_slots == [target])
    log(f"  decode fault at {head}, slot {target}: {cd['faults_detected']} "
        f"detected / {cd['faults_corrected']} corrected over "
        f"{cd['decode_steps']} steps, localizer hit slots {hit_slots}, "
        f"residual steps {cd['residual_steps']}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"head drill: {by_slot} counters {cd} tokens equal {same}")
    res["drills"] = {"head": {"counters": cd, "hit_slots": hit_slots}}

    calls = [0]

    def prefill_hook(o):
        # every prefill pass calls the site once per repeat, in order
        if o.shape[0] == 1 and o.shape[1] > 1:
            calls[0] += 1
            if (calls[0] - 1) % reps == rep_hit:
                o = o.clone()
                o[0, 5, 17 % o.shape[-1]] += 1e3
        return o

    site = prefill_site
    s_p, r_p, rep_p, _ = serve(params, cfg, fused, drill_prompts, 8,
                               hook=(site, prefill_hook))
    recs = {r["id"]: r for r in rep_p["requests"]}
    cp_ = rep_p["counters"]
    same = [s_p.tokens_for(r) for r in r_p] == clean
    ok = (all(recs[r]["prefill_detected"] == 1
              and recs[r]["faults_detected"] == 1
              and recs[r]["corrections_applied"] == 1
              and recs[r]["residuals"] == 0 for r in r_p)
          and cp_["residual_steps"] == 0 and cp_["faults_unattributed"] == 0)
    log(f"  prefill fault at {site}, repeat {rep_hit}: prefill_detected "
        f"{[recs[r]['prefill_detected'] for r in r_p]}, corrected "
        f"{cp_['faults_corrected']}/{cp_['faults_detected']}, residuals "
        f"{[recs[r]['residuals'] for r in r_p]}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"{site} drill: {recs} counters {cp_} tokens equal {same}")
    res["drills"]["prefill"] = {"site": site, "counters": cp_}

    calls[0] = 0
    step_hit = 3

    def decode_hook(o):
        # decode step s's detect pass makes calls reps*s .. reps*s + reps-1
        # (no earlier step reruns), its corrective rerun the next reps
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            calls[0] += 1
            if calls[0] - 1 in (reps * step_hit + rep_hit,
                                reps * (step_hit + 1) + rep_hit):
                o = o.clone()
                o[target, 0, 7] += 1e4
        return o

    site = decode_site
    s_o, r_o, rep_o, st_o = serve(params, cfg, fused, drill_prompts, 8,
                                  hook=(site, decode_hook))
    by_slot, co = by_slot_of(rep_o, r_o), rep_o["counters"]
    hit_steps = [i for i, h in enumerate(st_o["hits"]) if any(h)]
    hit_slots = sorted({i for h in st_o["hits"] for i, x in enumerate(h) if x})
    same = [s_o.tokens_for(r) for r in r_o] == clean
    ok = (co["faults_detected"] == 1 and co["faults_corrected"] == 1
          and by_slot[target]["faults_detected"] == 1
          and by_slot[target]["corrections_applied"] == 1
          and by_slot[target]["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and co["residual_steps"] == 0 and co["faults_unattributed"] == 0
          and hit_steps == [step_hit] and hit_slots == [target])
    log(f"  decode fault at {site}, repeat {rep_hit}, slot {target}, decode "
        f"step {step_hit}: {co['faults_detected']} detected / "
        f"{co['faults_corrected']} corrected, localizer hit steps "
        f"{hit_steps} slots {hit_slots}; every later token == clean: {same}")
    if not (ok and same):
        fail(f"{site} drill: {by_slot} counters {co} hits {hit_steps} "
             f"tokens equal {same}")
    res["drills"]["decode"] = {"site": site, "counters": co,
                               "hit_steps": hit_steps}
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {res['peak_memory_gib']:.2f} GiB")
    report[key] = res
    return res


def run_mamba_serving(report) -> dict:
    """Phase 12: Mamba2-1.3B at full width and its first MAMBA_LAYERS
    layers (a plan of its own): 2 sites a layer and the untied head per
    forward; the drills at in_proj (prefill) and out_proj (decode)."""
    log(f"phase 12: Mamba2-1.3B serving ({MAMBA_LAYERS} layers)")
    return run_recurrent_serving(
        report, "mamba_serving", MAMBA_ARCH, MAMBA_LAYERS,
        2 * MAMBA_LAYERS + 1, "stages/b0_ssm/ssm/in_proj",
        "stages/b0_ssm/ssm/out_proj", rounds=LATE_TIMED_ROUNDS)


def run_rg_serving(report) -> dict:
    """Phase 13: RecurrentGemma-2B at full width and its first RG_LAYERS
    layers (repeats of its pattern, a plan of its own): 23 sites a
    repeat (2 rec blocks of 5, one attn_swa of 4, 3 ffns of 3) and the
    tied head per forward; the prefill drill at one repeat's attn_swa wk
    (the KV-cache write), the decode drill at one repeat's rec in_x (it
    feeds both the conv tail and h)."""
    log(f"phase 13: RecurrentGemma-2B serving ({RG_LAYERS} layers)")
    return run_recurrent_serving(
        report, "rg_serving", RG_ARCH, RG_LAYERS, 23 * RG_LAYERS // 3 + 1,
        "stages/b4_attn_swa/attn/wk", "stages/b0_rec/rec/in_x",
        RG_TABLE_SCALE, rounds=LATE_TIMED_ROUNDS)


def run_musicgen_serving(report) -> dict:
    """Phase 14: MusicGen-large at full width and MUSICGEN_LAYERS layers,
    7 sites a layer and the head per forward, (S, 4) prompts and K-list
    tokens; the prefill drill at one repeat's attention wk (the KV-cache
    write), the decode drill at one repeat's FFN up. Its sessions are
    timed in LATE_TIMED_ROUNDS rounds."""
    log(f"phase 14: MusicGen-large serving ({MUSICGEN_LAYERS} layers)")
    return run_recurrent_serving(
        report, "musicgen_serving", MUSICGEN_ARCH, MUSICGEN_LAYERS,
        7 * MUSICGEN_LAYERS + 1,
        "stages/b0_attn_full/attn/wk", "stages/b1_ffn/ffn/up",
        rounds=LATE_TIMED_ROUNDS)




# --------------------------------------------------------------------------
# phase 3f: the group-axis kernels at Kimi-K2's expert shapes (bf16)
# --------------------------------------------------------------------------

def time_events(fn, rounds: int = 3) -> float:
    """Device milliseconds of one fn() between two CUDA events, median
    over `rounds` after one warm-up: for calls too large to capture in a
    graph (an fp32 copy of an expert stack)."""
    import torch
    fn()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b))
    return statistics.median(per)


def within_bf16_ulp_noise(a, b, noise) -> bool:
    """Every element of a within one bf16 ulp of b plus `noise`, the fp32
    summation noise of its sum (elementwise): two roundings of fp32 sums
    that differ by reassociation, where a sum that nearly cancels carries
    more rounding than an ulp of its result."""
    a32, b32 = a.float(), b.float()
    return bool(((a32 - b32).abs() <= b32.abs() * 2.0 ** -7 + noise).all())


def grouped_f32(d, w, absval: bool = False):
    """The fp32 product of every group, (G, n, k) @ (G, k, m) (of |D| and
    |W| with absval), a slab of groups at a time: no fp32 copy of the
    whole stack."""
    import torch
    g, n, k = d.shape
    m = w.shape[-1]
    out = torch.empty((g, n, m), dtype=torch.float32, device=d.device)
    per = max(1, (1 << 28) // (k * m))
    for s0 in range(0, g, per):
        a, b = d[s0:s0 + per].float(), w[s0:s0 + per].float()
        if absval:
            a, b = a.abs(), b.abs()
        out[s0:s0 + per] = torch.bmm(a, b)
    return out


def check_moe_kernels(gen, report):
    """Phase 3f: abft_matmul_detect and abft_matmul with a group axis, one
    launch for all 384 experts, at Kimi-K2's expert shapes (gate/up 7168 x
    2048, down 2048 x 7168) and the rows per expert a decode step and the
    prefill buckets give (1, 2, 3), in bf16: flags equal to the plain
    version's and clear on exact per-expert checksums; +1e4 at one element
    of one expert flagging exactly that expert's chunk; O bitwise equal to
    384 launches of the 2-D kernel and between the two grouped kernels,
    within one bf16 ulp plus the fp32 summation noise (eps32 sqrt(K) sum
    |d w| per element: near-cancelling sums of 7168 terms carry more
    rounding than an ulp of their result) of the plain version.
    Device ms of the one launch, of the 384 2-D launches, of torch.bmm and
    the plain versions beside the bound (each launch reads the 11.3 GB
    stack). Returns the two kernels' rows for their group-axis launches."""
    import torch
    from repro_torch import fp32_ieee
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core.thresholds import tau_scalar_coeffs
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (abft_matmul_detect_ref,
                                         abft_matmul_ref, chunk_sums_ref)
    bf16, g = torch.bfloat16, MOE_EXPERTS
    rows, err_det, err_mm = [], 0.0, 0.0
    keys = ("ms", "singles_ms", "plain_ms", "library_ms", "mm_ms",
            "mm_plain_ms", "bytes", "flops", "mm_bytes", "mm_flops")
    tot = {n: dict.fromkeys(keys, 0.0) for n in MOE_TIMED_ROWS}
    with torch.no_grad(), fp32_ieee():
        for label, k, m, count in MOE_SHAPES:
            # drawn a slab of experts at a time (an fp32 stack is 22.5 GB)
            w = torch.empty((g, k, m), dtype=bf16, device="cuda")
            for s0 in range(0, g, 32):
                w[s0:s0 + 32] = (torch.randn((32, k, m), generator=gen,
                                             device="cuda") * k ** -0.5)
            for n in MOE_ROWS:
                d = torch.randn((g, n, k), generator=gen,
                                device="cuda").to(bf16)
                rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
                bm, bn = ops._tile(rb, 256), ops._tile(cb, 256)
                tiling = AM.kernel_tiling(n, k, m, bf16, cb)
                prod = grouped_f32(d, w)
                c5, c6, c7, sq = chunk_sums_ref(prod, rb, cb)
                absprod = grouped_f32(d, w, True)
                absdot = chunk_sums_ref(absprod, rb, cb)[0]
                # an element's fp32 summation noise, priced as the
                # thresholds price it: eps32 sqrt(K) sum_i |d_i w_i|
                noise_o = 2.0 ** -24 * k ** 0.5 * absprod
                del absprod
                cs = [c5, c6, c7, absdot]
                ta, tb = tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
                before = (AM.GROUPED_DETECT_LAUNCHES, AM.GROUPED_LAUNCHES)
                o, flag, score = AM.abft_matmul_detect(
                    d, w, *cs, rb, cb, ta, tb)
                o_mm, parts = AM.abft_matmul(d, w, bm, bn)
                if (AM.GROUPED_DETECT_LAUNCHES - before[0],
                        AM.GROUPED_LAUNCHES - before[1]) != (1, 1):
                    fail("a group-axis call launched other than once")
                singles = torch.stack([AM.abft_matmul_detect(
                    d[i], w[i], *(c[i] for c in cs), rb, cb, ta, tb)[0]
                    for i in range(g)])
                o_r, flag_r, score_r = abft_matmul_detect_ref(
                    d, w, *cs, rb, cb, ta, tb)
                torch.cuda.synchronize()
                what = f"{label} {g} x ({n}x{k})@({k}x{m})"
                if not torch.equal(flag, flag_r) or int(flag.sum()):
                    fail(f"abft_matmul_detect {what}: {int(flag.sum())}"
                         f" flags, plain {int(flag_r.sum())}")
                noise = 2.0 ** -24 * (k ** 0.5 + (rb * cb) ** 0.5) / ta
                e_s = max_err(score, score_r)
                if not torch.allclose(score, score_r, rtol=1e-3, atol=noise):
                    fail(f"abft_matmul_detect {what}: clean scores "
                         f"differ by {e_s:.3g} (limit {noise:.3g})")
                if not torch.equal(o, singles):
                    fail(f"{what}: the grouped launch's O differs from 384 "
                         f"2-D launches' (max |diff| {max_err(o, singles):.3g})")
                if not torch.equal(o, o_mm):
                    fail(f"{what}: the two grouped kernels round O differently")
                e_o = max_err(o, o_r)
                if not within_bf16_ulp_noise(o, o_r, noise_o):
                    fail(f"{what}: O beyond one bf16 ulp plus the fp32 "
                         f"summation noise of the plain version (max |err| "
                         f"{e_o:.3g})")
                del o_r, singles
                o_mr, parts_r = abft_matmul_ref(d, w, bm, bn)
                e_p = 0.0
                for a_, r_, nm in zip(parts[:3], parts_r[:3],
                                      ("colsum", "rowsum", "sumsq")):
                    if a_.shape != r_.shape or not torch.allclose(
                            a_, r_, rtol=1e-5, atol=1e-3 * k ** 0.5):
                        fail(f"abft_matmul {what} {nm}: max |err| "
                             f"{max_err(a_, r_):.3g}")
                    e_p = max(e_p, max_err(a_, r_))
                if not within_bf16_ulp_noise(o_mm, o_mr, noise_o):
                    fail(f"abft_matmul {what}: O beyond one bf16 ulp "
                         "plus the summation noise")
                err_mm = max(err_mm, e_p, max_err(o_mm, o_mr))
                del o_mr, parts_r
                # +1e4 at one element of one expert, in the checksums'
                # prediction: that expert's chunk alone flags
                hit, r, c = g // 2 + 1, n - 1, m - 5
                p = prod[hit].clone()
                p[r, c] += 1e4
                bad = [x.clone() for x in cs]
                for j, x in enumerate(chunk_sums_ref(p, rb, cb)[:3]):
                    bad[j][hit] = x
                _, flag_t, _ = AM.abft_matmul_detect(
                    d, w, *bad, rb, cb, ta, tb)
                want = torch.zeros_like(flag_t)
                want[hit, r // rb, c // cb] = 1
                if not torch.equal(flag_t, want):
                    fail(f"{what}: +1e4 in expert {hit} flags "
                         f"{torch.nonzero(flag_t).tolist()}")
                err_det = max(err_det, e_s, e_o)
                row = {"site": label, "groups": g, "shape": [n, k, m],
                       "chunks": [rb, cb], "per_forward": count,
                       "tiling": tiling._asdict(),
                       "clean_score": float(score.max()),
                       "max_abs_err": {"score": e_s, "partials": e_p}}
                rows.append(row)
                txt = (f"  {what} chunks ({rb},{cb}): tile {tiling.tm}x"
                       f"{tiling.tn}, {tiling.splits} splits; flags clear, "
                       f"+1e4 in expert {hit} flagged its chunk alone, O == "
                       f"384 single launches")
                if n not in MOE_TIMED_ROWS:
                    log(txt)
                    continue
                ms = time_device(lambda *a: AM.abft_matmul_detect(
                    *a, rb, cb, ta, tb), [(d, w, *cs)])
                singles_ms = time_device(lambda dd, ww, *cc: [
                    AM.abft_matmul_detect(dd[i], ww[i], *(x[i] for x in cc),
                                          rb, cb, ta, tb) for i in range(g)],
                    [(d, w, *cs)], rounds=3)
                lib_ms = time_device(torch.bmm, [(d, w)])
                mm_ms = time_device(lambda dd, ww: AM.abft_matmul(
                    dd, ww, bm, bn), [(d, w)])
                plain_ms = time_events(lambda: abft_matmul_detect_ref(
                    d, w, *cs, rb, cb, ta, tb))
                mm_plain = time_events(lambda: abft_matmul_ref(
                    d, w, bm, bn))
                nb, mb = n // rb, m // cb
                nbytes = (2.0 * g * (n * k + k * m + n * m)
                          + 4.0 * 6 * g * nb * mb)
                flops = 2.0 * g * n * k * m + 5.0 * g * n * m
                b, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
                pm, pn = -(-n // bm), -(-m // bn)
                mm_bytes = (2.0 * g * (n * k + k * m + n * m)
                            + 4.0 * g * (pm * m + n * pn + pm * pn))
                mm_b, mm_by = bound_ms(mm_bytes, flops, BF16_FLOPS_PER_S)
                row.update({"ms": ms, "singles_ms": singles_ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": b, "bound_by": by,
                            "abft_matmul_ms": mm_ms,
                            "abft_matmul_plain_ms": mm_plain,
                            "abft_matmul_bound_ms": mm_b})
                log(f"{txt}; detect ms {ms:.4f}, 384 2-D launches "
                    f"{singles_ms:.4f}, torch.bmm {lib_ms:.4f}, plain "
                    f"{plain_ms:.4f}, bound {b:.4f} ({by}); abft_matmul"
                    f" {mm_ms:.4f} plain {mm_plain:.4f} bound {mm_b:.4f}")
                t = tot[n]
                for key, v in (("ms", ms), ("singles_ms", singles_ms),
                               ("plain_ms", plain_ms), ("library_ms", lib_ms),
                               ("mm_ms", mm_ms), ("mm_plain_ms", mm_plain),
                               ("bytes", nbytes), ("flops", flops),
                               ("mm_bytes", mm_bytes), ("mm_flops", flops)):
                    t[key] += count * v
                del d, prod, noise_o
            del w
    torch.cuda.empty_cache()
    for n, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"],
                                                BF16_FLOPS_PER_S)
        t["mm_bound_ms"], t["mm_bound_by"] = bound_ms(
            t["mm_bytes"], t["mm_flops"], BF16_FLOPS_PER_S)
        log(f"  per moe block at {n} row(s) per expert (gate, up, down: 3 "
            f"launches): detect ms {t['ms']:.4f}, as 1,152 2-D launches "
            f"{t['singles_ms']:.4f}, torch.bmm {t['library_ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}, {t['bytes'] / 1e9:.2f} GB); abft_matmul"
            f" {t['mm_ms']:.4f} plain {t['mm_plain_ms']:.4f} bound "
            f"{t['mm_bound_ms']:.4f}")
    report["moe_kernels"] = {"per_shape": rows,
                             "per_block": {str(n): t for n, t in tot.items()}}
    dec = tot[MOE_TIMED_ROWS[0]]
    src = "src/repro_torch/kernels/csrc/abft_matmul.cu"
    # times per moe block of a decode step (3 grouped launches, 1 row per
    # expert)
    detect = {"name": "abft_matmul_detect/grouped", "route": "cuda",
              "source": src,
              "replaces": "src/repro/kernels/abft_matmul.py:184",
              "max_abs_err": err_det, "ms": dec["ms"],
              "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
              "bound_by": dec["bound_by"], "library_ms": dec["library_ms"]}
    mm = {"name": "abft_matmul/grouped", "route": "cuda", "source": src,
          "replaces": "src/repro/kernels/abft_matmul.py:78",
          "max_abs_err": err_mm, "ms": dec["mm_ms"],
          "plain_ms": dec["mm_plain_ms"], "bound_ms": dec["mm_bound_ms"],
          "bound_by": dec["mm_bound_by"], "library_ms": dec["library_ms"]}
    return detect, mm


# --------------------------------------------------------------------------
# phase 15: Kimi-K2 at full width (2 of 61 layers)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def record_routing(log_):
    """Append (top_e (T, k), kept (T, k)) of every moe dispatch made in the
    scope to log_: each token's experts and which of its assignments kept
    a capacity slot."""
    import torch
    from repro_torch.layers import moe
    dispatch = moe.dispatch

    def recording(top_e, e, cap):
        out = dispatch(top_e, e, cap)
        order, _, valid, _ = out
        kept = torch.empty_like(valid)
        kept[order] = valid
        log_.append((top_e.clone(), kept.reshape(top_e.shape)))
        return out

    moe.dispatch = recording
    try:
        yield log_
    finally:
        moe.dispatch = dispatch


def forced_session(params, cfg, plan, prompts, forced, correction="auto"):
    """A ProtectedSession over `prompts` (32 new tokens each) that feeds
    back `forced[i]`, request i's tokens of another run, instead of its
    own argmax: the teacher-forced replay with that run's batch
    composition (the same slots, buckets and admission steps). Returns the
    session after its run: `rows[(i, j)]`, the fp32 logits row that gave
    request i's token j, and `forward_of[(i, j)]`, the index of that
    forward among the session's."""
    import torch
    from repro_torch.serving import ProtectedSession

    class Forced(ProtectedSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows, self.forward_of, self.forwards = {}, {}, 0
            self._seen = []
            for attr in ("_decode_pm", "_prefill_pm"):
                setattr(self, attr, self._recording(getattr(self, attr)))

        def _recording(self, pm):
            def call(*a, **kw):
                out = pm(*a, **kw)
                self._seen.append(out[0][0])
                return out
            return call

        def _apply_prefill_outputs(self, nxt, s, slot, req):
            li = self._seen.pop()
            self.rows[(req.id, 0)] = li[0, 0].float()
            self.forward_of[(req.id, 0)] = self.forwards
            self.forwards += 1
            nxt = nxt.copy()
            nxt[0, 0] = forced[req.id][0]
            return super()._apply_prefill_outputs(nxt, s, slot, req)

        def _host_decode(self, out):
            nxt, hit = super()._host_decode(out)
            logits = self._seen.pop()
            for slot, req in self.scheduler.active.items():
                j = len(self.stats.record(req.id).tokens)
                self.rows[(req.id, j)] = logits[slot, 0].float()
                self.forward_of[(req.id, j)] = self.forwards
                nxt[slot, 0] = forced[req.id][j]
            self.forwards += 1
            return nxt, hit

    sess = Forced(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                  correction=correction, device=DEVICE)
    for p in prompts:
        sess.submit(p, max_new_tokens=GEN)
    with torch.no_grad():
        sess.run()
    return sess


def run_moe_serving(report) -> dict:
    """Phase 15: Kimi-K2 at full width and 2 of 61 layers in bf16 (random
    params drawn on the card from a seed), served as phase 6 serves
    SmolLM-360M (8 slots, deferred, the plain-matmul sites on the detect
    kernel, the grouped expert GEMMs on their plain route as
    force_fused_matmul leaves them, 16 requests of 16-128 tokens, 32 new
    tokens each). Checks: every request finishes by length, zero flags,
    no echo, 16 detect launches and 1 host read per deferred forward;
    per_layer serves the first 8 requests' 8 tokens alike with 16
    abft_matmul launches and 19 host reads per forward (16 sites and 3
    grouped ones); teacher-forced with the session's batch composition
    (forced_session): the routed expert sets of the two routes compared
    row by row; over the forwards where they agree, every served token's
    unprotected logit within twice the two routes' largest logit gap
    there plus DELTA of the unprotected top (the margins in forwards with
    a differing set reported apart). Timing:
    the unprotected and the protected session in turns over the first 8
    requests (one wave of the slots), a profile of one
    decode step of each, the device ms of the per-call expert re-encode.
    Drills: +1e3 in every prefill at the repeat's attention wk, +1e4 at
    one fp32 router logit of slot 3 in one decode step (the corrected
    routing is the clean run's, a second slot hit only where the faulted
    routing displaced its assignment) and +1e4 at the shared expert's down
    on slot 3 in one decode step, every token equal to the clean run's.
    Then one prefill with the grouped entries pinned to the group-axis
    kernels in each mode: flags clear, 3 grouped launches per forward."""
    import numpy as np
    import torch
    from repro_torch import configs, core, fp32_ieee
    from repro_torch.core import protected as P
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as M
    from repro_torch.serving import ProtectedSession

    log(f"phase 15: Kimi-K2 serving ({MOE_LAYERS} of 61 layers)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(MOE_ARCH).replace(num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                           device=DEVICE)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = core.force_fused_matmul(plan)
    kinds = [e.op.kind for e in fused.entries.values()]
    grouped = [n for n, e in fused.entries.items()
               if e.op.kind == "grouped_matmul"]
    if (kinds.count("matmul"), len(grouped)) != (MOE_MATMUL_SITES,
                                                 MOE_GROUPED_SITES):
        fail(f"the plan has {kinds.count('matmul')} matmul and "
             f"{len(grouped)} grouped entries")
    if any(fused[n].wck is not None or fused[n].cfg.use_fused_kernel
           for n in grouped):
        fail("a stage's grouped entry carries checksums or a pinned kernel")
    log(f"  {cfg.name}: {cfg.num_layers} layers, {M.count_params(cfg) / 1e9:.3f}"
        f" G params bf16, {MOE_MATMUL_SITES} matmul + {MOE_GROUPED_SITES} "
        f"grouped sites per forward; init {init_s:.1f} s, build_plan "
        f"{plan_s:.1f} s")
    res = {"init_s": init_s, "build_plan_s": plan_s}
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)
    moe_w = params["stages"]["b1_moe"]["moe"]

    # -- the main path: deferred, kernels pinned -----------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    AM.GROUPED_LAUNCHES = AM.GROUPED_DETECT_LAUNCHES = 0
    sess, rids, rep, steps = serve(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES,
                "abft_matmul_detect/grouped": AM.GROUPED_DETECT_LAUNCHES,
                "abft_matmul/grouped": AM.GROUPED_LAUNCHES}
    reads = workflow.HOST_READS
    tokens = {r: sess.tokens_for(r) for r in rids}
    distinct = [len(set(t)) for t in tokens.values()]
    echoes = [r for r, p in zip(rids, prompts)
              if all(x == int(p[-1]) for x in tokens[r])]
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  deferred: {rep['completed']} requests, {c['prefills']} prefills "
        f"+ {c['decode_steps']} decode steps, launches {launches}, host reads "
        f"{reads}, faults {c['faults_detected']}; distinct tokens per "
        f"request {distinct}, echoes {len(echoes)}")
    if reasons != ["length"] * N_REQ or rep["completed"] != N_REQ:
        fail(f"requests finished with {reasons}")
    if c["faults_detected"] or c["dropped"] or c["faults_unattributed"]:
        fail(f"clean serving counted {c}")
    if echoes:
        fail(f"requests {echoes} echo their prompt's last token")
    if launches != {"abft_matmul_detect": MOE_MATMUL_SITES * forwards,
                    "abft_matmul": 0, "abft_matmul_detect/grouped": 0,
                    "abft_matmul/grouped": 0} or reads != forwards:
        fail(f"{forwards} clean forwards launched {launches} with {reads} "
             f"host reads")
    res["deferred"] = {"counters": c, "launches": launches,
                       "host_reads": reads, "forwards": forwards,
                       "distinct_tokens": distinct}

    # -- per_layer serves the same tokens ------------------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    s_pl, r_pl, rep_pl, _ = serve(params, cfg, fused, prompts[:8], 8,
                                  correction="per_layer")
    f_pl = rep_pl["counters"]["prefills"] + rep_pl["counters"]["decode_steps"]
    got = [s_pl.tokens_for(r) for r in r_pl]
    want = [tokens[r][:8] for r in rids[:8]]
    per_fwd = workflow.HOST_READS / f_pl
    log(f"  per_layer, first 8 requests x 8 tokens: {workflow.HOST_READS} "
        f"host reads over {f_pl} forwards ({per_fwd:g} each: "
        f"{MOE_MATMUL_SITES} matmul sites + {MOE_GROUPED_SITES} grouped), "
        f"abft_matmul launches {AM.LAUNCHES}; tokens == deferred: "
        f"{got == want}")
    if got != want:
        fail(f"per_layer tokens {got} differ from deferred's {want}")
    if (workflow.HOST_READS != (MOE_MATMUL_SITES + MOE_GROUPED_SITES) * f_pl
            or AM.LAUNCHES != MOE_MATMUL_SITES * f_pl):
        fail(f"per_layer: {workflow.HOST_READS} reads, {AM.LAUNCHES} "
             "launches")
    res["per_layer"] = {"host_reads": workflow.HOST_READS, "forwards": f_pl,
                        "launches": AM.LAUNCHES}

    # -- teacher-forced with the session's batch composition -----------------
    # MoE couples a batch's rows through expert capacity, so the reference
    # is not an unbatched forward: the unprotected model replays the
    # served tokens in the same slots, buckets and admission steps, and so
    # does the protected one (its rows are the served run's, bitwise); the
    # routes' largest logit gap at the same inputs is the noise floor
    ucfg = cfg.replace(abft=False)
    forced = [tokens[r] for r in rids]
    runs, routes = {}, {}
    for name, (kcfg, kplan) in (("unprotected", (ucfg, None)),
                                ("protected", (cfg, fused))):
        routes[name] = []
        with record_routing(routes[name]):
            runs[name] = forced_session(params, kcfg, kplan, prompts, forced)
        if runs[name].stats.counters["faults_detected"]:
            fail(f"teacher-forced {name} run flagged")
    ref_rows, kern_rows = runs["unprotected"].rows, runs["protected"].rows
    if set(ref_rows) != set(kern_rows) or len(ref_rows) != N_REQ * GEN:
        fail(f"teacher-forced runs recorded {len(ref_rows)} / "
             f"{len(kern_rows)} rows")
    ru, rp = routes["unprotected"], routes["protected"]
    if not len(ru) == len(rp) == runs["unprotected"].forwards:
        fail(f"the replays routed {len(ru)} and {len(rp)} of "
             f"{runs['unprotected'].forwards} forwards")
    flips, rows_routed = {}, 0
    for f, ((eu, _), (ep, _)) in enumerate(zip(ru, rp)):
        rows_routed += eu.shape[0]
        nflip = int((torch.sort(eu, dim=1).values
                     != torch.sort(ep, dim=1).values).any(dim=1).sum())
        if nflip:
            flips[f] = nflip
    # a forward whose two routes picked different experts for a row did not
    # compute its rows on the same inputs (capacity couples them): the gap,
    # the routes' noise floor, is taken over the other forwards alone, and
    # the gate holds their tokens; a flip forward's margins stand apart
    forward_of = runs["unprotected"].forward_of
    gap, gap_at, worst, off = 0.0, None, 0.0, 0
    flip_margins = {}
    for key, ref in ref_rows.items():
        kern = kern_rows[key]
        tok = forced[key[0]][key[1]]
        off += int(int(torch.argmax(kern)) != tok)
        margin = float(ref.max() - ref[tok])
        f = forward_of[key]
        if f in flips:
            flip_margins[f] = max(flip_margins.get(f, 0.0), margin)
            continue
        e = max_err(kern, ref)
        if e > gap:
            gap, gap_at = e, {"request": key[0], "token": key[1],
                              "forward": f}
        worst = max(worst, margin)
    if off:
        fail(f"the protected replay's argmax left the served tokens at {off} "
             f"of {len(kern_rows)} positions")
    log(f"  teacher-forced with the session's batch composition: top-8 "
        f"expert sets differ between the routes in {sum(flips.values())} of "
        f"{rows_routed} routed rows, in {len(flips)} of {len(ru)} forwards "
        f"{sorted(flips)}; over the other forwards the two routes differ by "
        f"up to {gap:.4g} in a logit (at {gap_at}) and served tokens lie at "
        f"most {worst:.4g} below the unprotected top logit (limit 2 x gap + "
        f"{DELTA} = {2 * gap + DELTA:.4g}); the largest margin in each flip "
        f"forward, apart: {flip_margins}")
    if not worst <= 2 * gap + DELTA:
        fail(f"a served token's unprotected logit is {worst:.4g} below the "
             f"top, beyond twice the routes' gap {gap:.4g} plus {DELTA}")
    res["teacher_forced"] = {"max_logit_gap": gap, "max_gap_at": gap_at,
                             "max_margin": worst,
                             "routed_rows": rows_routed,
                             "forwards": len(ru),
                             "flipped_rows": sum(flips.values()),
                             "flips_per_forward": flips,
                             "flip_forward_margins": flip_margins}
    del runs, ref_rows, kern_rows, routes, ru, rp

    # -- timings: two sessions in turns --------------------------------------
    # over one wave of the 8 slots (the first 8 requests, 32 tokens each),
    # half the main run's decode steps, in LATE_TIMED_ROUNDS rounds
    sessions = {"unprotected": (ucfg, None), "kernels_on": (cfg, fused)}
    times = {k: {"decode_ms": [], "ttft_ms": []} for k in sessions}
    for rnd in range(LATE_TIMED_ROUNDS):
        keys = list(sessions)
        for k in keys[rnd % 2:] + keys[:rnd % 2]:
            kcfg, kplan = sessions[k]
            _, _, rp_, st = serve(params, kcfg, kplan, prompts[:SLOTS], GEN)
            times[k]["decode_ms"].append(statistics.median(st["ms"]))
            times[k]["ttft_ms"].append(rp_["ttft_p50_s"] * 1e3)
    for k, v in times.items():
        log(f"  {k}: median decode step ms {v['decode_ms']}, TTFT p50 ms "
            f"{v['ttft_ms']}")
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    over = {m: med["kernels_on"][m] / med["unprotected"][m] - 1
            for m in med["kernels_on"]}
    log(f"  error-free overhead: decode step {over['decode_ms'] * 100:.1f}%, "
        f"TTFT p50 {over['ttft_ms'] * 100:.1f}%")
    res["times"], res["overhead"] = times, over

    # -- what a stage's expert stack costs per call --------------------------
    with torch.no_grad(), fp32_ieee():
        enc = {n: time_events(lambda n=n: P.grouped_weight_checksums(
            moe_w[n][0], cfg.abft_col_chunk)) for n in ("gate", "up", "down")}
    log(f"  per-call expert re-encode of the stage's 4-D stacks (device ms "
        f"per call, each reads {moe_w['gate'][0].numel() * 2 / 1e9:.2f} GB): "
        + ", ".join(f"{n} {v:.3f}" for n, v in enc.items())
        + f"; {sum(enc.values()):.3f} per forward")
    res["reencode_ms"] = enc

    # -- profile of one decode step of each ----------------------------------
    res["profile"] = {}
    for k, (kcfg, kplan) in sessions.items():
        ps = ProtectedSession(params, kcfg, kplan, slots=SLOTS,
                              max_len=MAX_LEN, device=DEVICE)
        for p in prompts[:SLOTS]:
            ps.submit(p, max_new_tokens=GEN)
        ps.step()                     # admits all 8, one decode step
        prof = profile_forward(ps.step)
        res["profile"][k] = prof
        log(f"  profile, one decode step {k}: wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['device_ms']:.3f} ms ({prof['kernels']} "
            f"kernels), idle share {prof['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in prof["top"][:6]))
        del ps

    # -- drills ----------------------------------------------------------------
    drill_prompts = prompts[:SLOTS]
    clean_routes = []
    with record_routing(clean_routes):
        s_c, r_c, _, _ = serve(params, cfg, fused, drill_prompts, 8)
    clean = [s_c.tokens_for(r) for r in r_c]
    if clean != [tokens[r][:8] for r in rids[:SLOTS]]:
        fail("the clean drill run's tokens differ from the main run's")
    target, step_hit = 3, 3

    def by_slot_of(rp_, ids):
        recs = {r["id"]: r for r in rp_["requests"]}
        return {recs[r]["slot"]: recs[r] for r in ids}

    calls = [0]

    def prefill_hook(o):
        if o.shape[0] == 1 and o.shape[1] > 1:
            o = o.clone()
            o[0, 5, 17 % o.shape[-1]] += 1e3
        return o

    site = "stages/b0_attn_full/attn/wk"
    s_p, r_p, rep_p, _ = serve(params, cfg, fused, drill_prompts, 8,
                               hook=(site, prefill_hook))
    recs = {r["id"]: r for r in rep_p["requests"]}
    cp_ = rep_p["counters"]
    same = [s_p.tokens_for(r) for r in r_p] == clean
    ok = (all(recs[r]["prefill_detected"] == 1
              and recs[r]["faults_detected"] == 1
              and recs[r]["corrections_applied"] == 1
              and recs[r]["residuals"] == 0 for r in r_p)
          and cp_["residual_steps"] == 0 and cp_["faults_unattributed"] == 0)
    log(f"  prefill fault at {site}: prefill_detected "
        f"{[recs[r]['prefill_detected'] for r in r_p]}, corrected "
        f"{cp_['faults_corrected']}/{cp_['faults_detected']}; tokens == "
        f"clean: {same}")
    if not (ok and same):
        fail(f"{site} drill: {recs} counters {cp_} tokens equal {same}")
    res["drills"] = {"prefill": {"site": site, "counters": cp_}}

    def decode_hook(o):
        # a decode step's (8, M) rows; step s's detect pass is call s, its
        # corrective rerun call s + 1 (no earlier step reruns)
        if o.dim() == 2 and o.shape[0] == SLOTS:
            calls[0] += 1
            if calls[0] - 1 in (step_hit, step_hit + 1):
                o = o.clone()
                o[target, 7] += 1e4
        return o

    dec = lambda rs: [x for x in rs if x[0].shape[0] == SLOTS]
    for site in ("stages/b1_moe/moe/router", "stages/b1_moe/moe/shared/down"):
        calls[0] = 0
        drill_routes = []
        with record_routing(drill_routes):
            s_o, r_o, rep_o, st_o = serve(params, cfg, fused, drill_prompts,
                                          8, hook=(site, decode_hook))
        by_slot, co = by_slot_of(rep_o, r_o), rep_o["counters"]
        hit_steps = [i for i, h in enumerate(st_o["hits"]) if any(h)]
        hit_slots = sorted({i for h in st_o["hits"] for i, x in enumerate(h)
                            if x})
        same = [s_o.tokens_for(r) for r in r_o] == clean
        cd, dd = dec(clean_routes), dec(drill_routes)
        if len(dd) != len(cd) + 1:
            fail(f"{site} drill: {len(dd)} decode routings, clean {len(cd)}")
        faulted, rerun = dd[step_hit], dd[step_hit + 1]
        kept_sets = lambda r: [set(e[k_].tolist()) for e, k_ in zip(*r)]
        clean_sets, faulted_sets = kept_sets(cd[step_hit]), kept_sets(faulted)
        displaced = sorted(i for i in range(SLOTS) if i != target
                           and faulted_sets[i] != clean_sets[i])
        rerun_clean = (torch.equal(rerun[0], cd[step_hit][0])
                       and torch.equal(rerun[1], cd[step_hit][1]))
        later_clean = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                          for a, b in zip(dd[step_hit + 2:],
                                          cd[step_hit + 1:]))
        allowed = sorted({target, *displaced})
        ok = (co["faults_detected"] == 1 and co["faults_corrected"] == 1
              and by_slot[target]["faults_detected"] == 1
              and by_slot[target]["corrections_applied"] == 1
              and by_slot[target]["residuals"] == 0
              and co["residual_steps"] == 0 and co["faults_unattributed"] == 0
              and hit_steps == [step_hit] and target in hit_slots
              and set(hit_slots) <= set(allowed)
              and rerun_clean and later_clean)
        log(f"  decode fault at {site}, slot {target}, decode step "
            f"{step_hit}: {co['faults_detected']} detected / "
            f"{co['faults_corrected']} corrected, localizer hit steps "
            f"{hit_steps} slots {hit_slots}; the faulted pass kept slot "
            f"{target}'s experts {sorted(faulted_sets[target])} (clean "
            f"{sorted(clean_sets[target])}), displacing slots {displaced}; "
            f"the corrected rerun routed as the clean run: {rerun_clean}, "
            f"later steps too: {later_clean}; every later token == clean: "
            f"{same}")
        if not (ok and same):
            fail(f"{site} drill: {by_slot} counters {co} hits {hit_steps} "
                 f"{hit_slots} displaced {displaced} tokens equal {same}")
        res["drills"][site.split("/", 2)[2]] = {
            "counters": co, "hit_slots": hit_slots, "displaced": displaced}

    # -- the grouped entries pinned to the group-axis kernels -----------------
    pinned = core.ProtectionPlan(
        entries={n: dataclasses.replace(e, cfg=e.cfg.replace(
            use_fused_kernel=True)) if e.op.kind == "grouped_matmul" else e
            for n, e in fused.entries.items()}, meta=dict(fused.meta))
    toks = torch.as_tensor(np.asarray(prompts[0]), device=DEVICE)[None]
    out = {}
    with torch.no_grad():
        for name, pl in (("plain", fused), ("pinned", pinned)):
            pm = core.ProtectedModel(M.prefill_apply(cfg, MAX_LEN), pl)
            for mode in ("deferred", "per_layer"):
                AM.LAUNCHES = AM.DETECT_LAUNCHES = 0
                AM.GROUPED_LAUNCHES = AM.GROUPED_DETECT_LAUNCHES = 0
                (lt, _), rp_ = pm(params, toks, correction=mode)
                v = core.as_fault_report(rp_)
                out[(name, mode)] = (lt, int(v.detected), (
                    AM.DETECT_LAUNCHES, AM.LAUNCHES,
                    AM.GROUPED_DETECT_LAUNCHES, AM.GROUPED_LAUNCHES))
    want = {"deferred": (MOE_MATMUL_SITES, 0, MOE_GROUPED_SITES, 0),
            "per_layer": (0, MOE_MATMUL_SITES, 0, MOE_GROUPED_SITES)}
    pin_gap = max(max_err(out[("pinned", m)][0], out[("plain", m)][0])
                  for m in want)
    log(f"  prefill of {toks.shape[1]} tokens with the grouped entries pinned "
        f"to the group-axis kernels: launches (detect, abft_matmul, grouped "
        f"detect, grouped) deferred {out[('pinned', 'deferred')][2]}, "
        f"per_layer {out[('pinned', 'per_layer')][2]}; flags "
        f"{[out[k][1] for k in out]}; logits within {pin_gap:.4g} of the "
        f"plain grouped route's; per_layer == deferred: "
        f"{torch.equal(out[('pinned', 'deferred')][0], out[('pinned', 'per_layer')][0])}")
    if (any(out[k][1] for k in out)
            or any(out[("pinned", m)][2] != want[m] for m in want)
            or not torch.equal(out[("pinned", "deferred")][0],
                               out[("pinned", "per_layer")][0])):
        fail(f"pinned grouped forwards: {[(k, out[k][1:]) for k in out]}")
    res["pinned_grouped"] = {
        "launches": {m: out[("pinned", m)][2] for m in want},
        "logit_gap_to_plain": pin_gap,
        "grouped_detect_launches": out[("pinned", "deferred")][2][2],
        "grouped_launches": out[("pinned", "per_layer")][2][3]}
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {res['peak_memory_gib']:.2f} GiB")
    if res["peak_memory_gib"] > 70:
        fail(f"peak device memory {res['peak_memory_gib']:.2f} GiB")
    report["moe_serving"] = res
    return res


# --------------------------------------------------------------------------
# phase 16: training through the ssm, rec and moe blocks at full width
# --------------------------------------------------------------------------

def profile_step(fn) -> dict:
    """profile_forward's numbers for one call of fn (no warm-up), from the
    card's activity alone, read off the trace's raw records: a 48-layer
    train step leaves ~100,000 of them, which the profiler's event objects
    take seconds to build (13 s for Mamba2-1.3B's step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by[e.name()][0] += 1
            by[e.name()][1] += e.duration_ns() / 1e6
    if not by:
        fail("the trace of a train step recorded no device activity")
    busy = sum(ms for _, ms in by.values())
    top = sorted(by.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    return {"wall_ms": wall, "device_ms": busy,
            "kernels": sum(n for n, _ in by.values()),
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"name": k, "calls": n, "ms": ms} for k, (n, ms) in top]}


def state_diff(a, b) -> tuple:
    """(the leaves of two trees that differ, the largest |difference|)."""
    import torch
    from repro_torch._tree import tree_flatten_with_path
    diff, worst = [], 0.0
    for (n, x), (_, y) in zip(tree_flatten_with_path(a),
                              tree_flatten_with_path(b)):
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            diff.append(n)
            worst = max(worst, max_err(x, y))
    return diff, worst


@contextlib.contextmanager
def recording_aux(log_):
    """Append each forward's moe load-balancing loss, made by launch.steps'
    forward_train in the scope, to log_ (the step's metrics do not carry
    it)."""
    from repro_torch.launch import steps as S
    inner = S.M.forward_train

    def forward_train(params, tokens, cfg):
        logits, rep, aux = inner(params, tokens, cfg)
        log_.append(float(aux.detach()))
        return logits, rep, aux

    S.M.forward_train = forward_train
    try:
        yield log_
    finally:
        S.M.forward_train = inner


@contextlib.contextmanager
def counting_ladders(log_):
    """Append D's shape of each protect_matmul_output call in the scope
    that carries a host flag of True (the grouped ladder's call for one
    flagged expert) to log_."""
    from repro_torch.core import protected as P
    inner = P.protect_matmul_output

    def counted(*a, **kw):
        if kw.get("detected") is True:
            log_.append(tuple(a[0].shape))
        return inner(*a, **kw)

    P.protect_matmul_output = counted
    try:
        yield log_
    finally:
        P.protect_matmul_output = inner


def train_cell(key: str, cfg, opt, batch: int, seq: int, mb: int, drills,
               remat_layers: int = 0) -> dict:
    """Train `cfg` (its params drawn on the card from a seed) with `opt`,
    batch x seq tokens in `mb` microbatches, remat on, warmup 1, for
    TRAIN16_STEPS steps over three cycled batches: every report clean,
    every loss finite and the last below the first, no kernel launched
    (the plain route, as the JAX package's step), the last step profiled.
    Then, from the state after step 2: the step's new params bitwise its
    abft=False twin's; each drill (label, site, repeat): +1e4 at one
    element of the site's output in that stage repeat in every forward of
    one step, run by StepRunner inside plan_scope(mode="correct") -
    detected, corrected
    with residual 0, counted, no retry, the hook fired again in each
    recompute, the loss within rtol 1e-4 of the clean step's, the new
    params bitwise the clean ones or their largest difference printed (a
    grouped site: the ladder runs for one expert per forward); remat on
    against off at `remat_layers` layers (0: this depth), one step each,
    bitwise, with each one's peak memory. Per step ms and host reads (the
    recompute's apart), peak memory under TRAIN16_PEAK_GIB, the moe
    load-balancing loss per step."""
    import torch
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.core import injection as inj
    from repro_torch.core import plan_scope, workflow
    from repro_torch.core.plan import current_repeat
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    from repro_torch.runtime.ft import FTPolicy, StepRunner

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def init(c):
        state = S.init_train_state(
            torch.Generator(device=DEVICE).manual_seed(SEED), c, opt,
            device=DEVICE)
        torch.cuda.synchronize()
        return state

    t_cell = time.perf_counter()
    state = init(cfg)
    init_s = time.perf_counter() - t_cell
    n_params = sum(p.numel() for _, p in
                   tree_flatten_with_path(state["params"]))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    batches = []
    for i in range(3):
        tk, lb = host_batch(dcfg, i)
        batches.append({"tokens": tk.to(DEVICE), "labels": lb.to(DEVICE)})
    make = lambda c: S.make_train_step(c, opt, microbatches=mb, warmup=1)
    step = make(cfg)
    _, reps, _ = cfg.stages()
    log(f"  {cfg.name}: {cfg.num_layers} layers ({reps} stage repeats), "
        f"{n_params / 1e9:.3f} G params bf16, {opt.kind} state fp32; batch "
        f"{batch} x {seq} in {mb} microbatch(es), remat {cfg.remat}; init "
        f"{init_s:.1f} s")
    res = {"layers": cfg.num_layers, "params_g": n_params / 1e9,
           "init_s": init_s, "optimizer": opt.kind,
           "batch": [batch, seq, mb]}

    losses, ms, reads, aux = [], [], [], []
    mid, prof = None, None
    AM.LAUNCHES = AM.DETECT_LAUNCHES = 0
    for i in range(TRAIN16_STEPS):
        if i == 2:
            mid = state
        workflow.HOST_READS = workflow.RECOMPUTE_READS = 0
        aux_i, out = [], []

        def one():
            with recording_aux(aux_i):
                out.append(step(state, batches[i % 3]))

        t0 = time.perf_counter()
        if i == TRAIN16_STEPS - 1:
            # the last step, traced; its wall is the profile's
            prof = profile_step(one)
        else:
            one()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        (state, m), = out
        del one, out
        reads.append((workflow.HOST_READS, workflow.RECOMPUTE_READS))
        aux.append(sum(aux_i) / len(aux_i))
        loss = float(m["loss"])
        v = tuple(int(x) for x in m["report"])
        losses.append(loss)
        if v != (0, 0, 0) or not math.isfinite(loss):
            fail(f"{key}: train step {i}: report {v}, loss {loss}")
    launches = AM.LAUNCHES + AM.DETECT_LAUNCHES
    log("  losses " + " ".join(f"{x:.4f}" for x in losses)
        + ("; aux " + " ".join(f"{x:.4f}" for x in aux)
           if cfg.num_experts else ""))
    if not losses[-1] < losses[0]:
        fail(f"{key}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches:
        fail(f"{key}: {launches} kernel launches in the train steps, want 0")
    steady = ms[1:-1]
    res.update({"losses": losses, "step_ms": ms,
                "median_step_ms": statistics.median(steady),
                "host_reads_per_step": [r[0] for r in reads],
                "recompute_reads_per_step": [r[1] for r in reads],
                "profile": prof})
    if cfg.num_experts:
        res["aux"] = aux
    log(f"  median step {res['median_step_ms']:.1f} ms (steps 1-"
        f"{TRAIN16_STEPS - 2}; step 0 {ms[0]:.1f}); host reads per step "
        f"{reads[1][0]}, of them the recompute's {reads[1][1]}")
    log(f"  profile of step {TRAIN16_STEPS - 1}: {prof['kernels']} device "
        f"kernels, device busy {prof['device_ms']:.1f} of "
        f"{prof['wall_ms']:.1f} ms, idle share {prof['idle_share']:.3f}")
    for e in prof["top"][:6]:
        log(f"    {e['ms']:.3f} ms  x{e['calls']}  {e['name'][:90]}")
    # from here on the state the checks start from and the clean step's new
    # params are resident; each check compares the new params it gives
    # with the clean step's
    del state
    res["steps_s"] = time.perf_counter() - t_cell

    # -- the abft=False twin ---------------------------------------------------
    batch2 = batches[2]
    above = {}
    overall = torch.cuda.max_memory_allocated()

    def peak_above(fn):
        """fn()'s result and the peak memory it allocated above what was
        resident when it started, GiB."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    (clean, mc), above["protected"] = peak_above(lambda: step(mid, batch2))
    clean = clean["params"]
    (twin, mt), above["abft=False"] = peak_above(
        lambda: make(cfg.replace(abft=False))(mid, batch2))
    diff, worst = state_diff(clean, twin["params"])
    same = not diff and torch.equal(mc["loss"], mt["loss"])
    del twin
    log(f"  step 2 from the same state: protected == abft=False bitwise: "
        f"{same} (leaves differing: {diff[:4]}, largest |diff| {worst:.3g});"
        f" the step's peak memory above the resident states: protected "
        f"{above['protected']:.2f}, abft=False {above['abft=False']:.2f} "
        "GiB")
    if not same:
        fail(f"{key}: the protected step differs from its abft=False twin "
             f"in {diff[:6]} (largest {worst:.3g})")
    res["bitwise_twin"] = same
    res["step_peak_above_gib"] = above

    # -- drills ----------------------------------------------------------------
    res["drills"] = {}
    for label, site, rep_hit in drills:
        calls, ladders = [], []

        def hook(o, rep_hit=rep_hit, calls=calls):
            calls.append(current_repeat())
            if current_repeat() != rep_hit:
                return o
            o = o.clone()
            o.reshape(-1)[12345 % o.numel()] += 1e4
            return o

        runner = StepRunner(step, FTPolicy())
        with plan_scope(mode="correct"), inj.fault_scope(site, hook), \
                counting_ladders(ladders):
            got, m = runner.run(mid, batch2)
        torch.cuda.synchronize()
        v = tuple(int(x) for x in m["report"])
        d_loss = abs(float(m["loss"]) - float(mc["loss"]))
        diff, worst = state_diff(got["params"], clean)
        del got
        fired = calls.count(rep_hit)
        st = runner.stats
        log(f"  drill {label} at {site}, repeat {rep_hit}: verdict {v}, "
            f"StepRunner {st['faults_detected']} detected / "
            f"{st['faults_corrected']} corrected, {st['retries']} retries; "
            f"the hook fired {fired} times in that repeat ({mb} forwards and "
            f"their recomputes); grouped ladders {len(ladders)}; loss "
            f"|diff| {d_loss:.3g}; new params bitwise the clean step's: "
            f"{not diff} (largest |diff| {worst:.3g} over {len(diff)} "
            "leaves)")
        ok = (v[0] == 1 and v[1] != 0 and v[2] == 0
              and st["faults_detected"] == 1 and st["faults_corrected"] == 1
              and st["retries"] == 0 and fired == 2 * mb
              and d_loss <= 1e-4 * abs(float(mc["loss"])))
        if site.endswith(("/gate", "/up", "/down")) and "moe/" in site \
                and "shared" not in site:
            ok = ok and len(ladders) == 2 * mb
        if not ok:
            fail(f"{key}: drill {label}: verdict {v}, stats {st}, hook in "
                 f"repeat {fired}, ladders {ladders}, loss {float(m['loss'])} "
                 f"vs {float(mc['loss'])}")
        res["drills"][label] = {"site": site, "repeat": rep_hit,
                                "verdict": v, "bitwise_clean": not diff,
                                "max_abs_diff": worst,
                                "grouped_ladders": len(ladders)}
    del clean, mid
    res["checks_s"] = time.perf_counter() - t_cell - res["steps_s"]
    res["peak_memory_gib"] = max(overall, torch.cuda.max_memory_allocated()
                                 ) / 2 ** 30
    log(f"  peak device memory {res['peak_memory_gib']:.2f} GiB")
    if res["peak_memory_gib"] >= TRAIN16_PEAK_GIB:
        fail(f"{key}: peak memory {res['peak_memory_gib']:.2f} GiB")

    # -- remat on against off ----------------------------------------------------
    if remat_layers:
        cfg = cfg.replace(num_layers=remat_layers)
    del batches, step
    torch.cuda.empty_cache()
    state = init(cfg)
    peaks, on = [], None
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        new, m = make(cfg.replace(remat=remat))(state, batch2)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        if on is None:
            on, loss_on = new["params"], m["loss"]
        else:
            diff, worst = state_diff(on, new["params"])
            same = not diff and torch.equal(loss_on, m["loss"])
        del new
    log(f"  remat on vs off at {cfg.num_layers} layers: bitwise {same} "
        f"(largest |diff| {worst:.3g}); peak memory {peaks[0]:.2f} / "
        f"{peaks[1]:.2f} GiB")
    if not same:
        fail(f"{key}: remat on and off differ in {diff[:6]}")
    res["remat_check"] = {"layers": cfg.num_layers, "bitwise": True,
                          "peak_gib_on": peaks[0], "peak_gib_off": peaks[1]}
    res["seconds"] = time.perf_counter() - t_cell
    log(f"  {key}: {res['seconds']:.1f} s (steps {res['steps_s']:.1f}, twin "
        f"and drills {res['checks_s']:.1f})")
    return res


def run_block_training(report) -> dict:
    """Phase 16: training through the ssm, rec and moe blocks at full
    width (train_cell): 16a Mamba2-1.3B at MAMBA_TRAIN_LAYERS with its drill at
    one repeat's in_proj; 16b RecurrentGemma-2B at RG_TRAIN_LAYERS
    layers, its drill at one repeat's rec in_x; 16c Kimi-K2 at MOE_LAYERS layers with
    MOE_TRAIN_EXPERTS experts and Adafactor, its drills at the fp32 router
    and at the experts' gate (the grouped ladder)."""
    from repro_torch import configs
    from repro_torch.optim import OptConfig

    import torch
    log("phase 16: training the ssm, rec and moe blocks at full width")
    # the cells' states are tens of GB and a step allocates full-size
    # temporaries of many sizes: expandable segments keep the caching
    # allocator from fragmenting (16c's first step failed for 4.4 GiB with
    # 25 GiB reserved but unallocated). Phase 16 runs last: no phase after
    # it captures a CUDA graph.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    res = {}
    cfg = configs.get(MAMBA_ARCH).replace(num_layers=MAMBA_TRAIN_LAYERS)
    reps = cfg.stages()[1]
    log(f"phase 16a: Mamba2-1.3B, {MAMBA_TRAIN_LAYERS} of 48 layers")
    res["mamba"] = train_cell(
        "16a", cfg, OptConfig(lr=TRAIN_LR), TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB,
        [("in_proj", "stages/b0_ssm/ssm/in_proj", reps // 2)],
        remat_layers=REMAT_CHECK_LAYERS)
    log(f"phase 16b: RecurrentGemma-2B, {RG_TRAIN_LAYERS} of 26 layers")
    res["rg"] = train_cell(
        "16b", configs.get(RG_ARCH).replace(num_layers=RG_TRAIN_LAYERS),
        OptConfig(lr=TRAIN_LR), TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB,
        [("in_x", "stages/b0_rec/rec/in_x", RG_TRAIN_LAYERS // 3 // 2)])
    log(f"phase 16c: Kimi-K2, {MOE_LAYERS} of 61 layers, {MOE_TRAIN_EXPERTS}"
        " of 384 experts")
    res["kimi"] = train_cell(
        "16c", configs.get(MOE_ARCH).replace(num_layers=MOE_LAYERS,
                                             num_experts=MOE_TRAIN_EXPERTS),
        OptConfig(lr=MOE_TRAIN_LR, kind="adafactor"), MOE_TRAIN_BATCH,
        MOE_TRAIN_SEQ, 1,
        [("router", "stages/b1_moe/moe/router", 0),
         ("gate", "stages/b1_moe/moe/gate", 0)])
    res["cuts"] = {"rg_layers": RG_TRAIN_LAYERS, "kimi_layers": MOE_LAYERS,
                   "kimi_experts": MOE_TRAIN_EXPERTS}
    report["block_training"] = res
    return res


# --------------------------------------------------------------------------
# phase 3h and 17: the (data, model) mesh
# --------------------------------------------------------------------------

def check_yi_shard_kernels(gen, report):
    """Phase 3h: both bf16 kernels at one rank's local GEMM shapes of
    Yi-9B on model 2 (phase 17a's 29 detect launches per forward), at a
    decode step's 8 rows and 128."""
    return check_model_kernels(gen, report, "yi_shard_kernels",
                               YI_SHARD_SITES, YI_SHARD_ROWS)


def check_rec_shard_kernels(gen, report):
    """Phase 3i: both bf16 kernels at one rank's local GEMM shapes of the
    ssm and rec blocks on model 2 (phase 18's), at a decode step's 8 rows
    and 128."""
    return check_model_kernels(gen, report, "rec_shard_kernels",
                               REC_SHARD_SITES, REC_SHARD_ROWS)


def _digest(tree) -> dict:
    import hashlib
    from repro_torch._tree import tree_flatten_with_path
    return {p: hashlib.sha256(t.detach().contiguous().view(-1).view(
        __import__("torch").uint8).cpu().numpy().tobytes()).hexdigest()
        for p, t in tree_flatten_with_path(tree)}


def _mesh_session(params, cfg, plan, prompts, gen: int, mesh,
                  correction="auto", hook=None, slots: int = SLOTS,
                  max_len: int = MAX_LEN):
    """One ProtectedSession (sharded when `mesh` is given) over `prompts`:
    (session, request ids, report, median decode-step ms)."""
    import torch
    from repro_torch.core import injection
    from repro_torch.serving import ProtectedSession
    sess = ProtectedSession(params, cfg, plan, slots=slots, max_len=max_len,
                            correction=correction, mesh=mesh, device=DEVICE)
    rids = [sess.submit(p, max_new_tokens=gen) for p in prompts]
    scope = (injection.fault_scope(*hook) if hook
             else contextlib.nullcontext())
    with scope:
        rep = sess.run()
    torch.cuda.synchronize()
    ms = statistics.median(e["dispatch_s"] * 1e3
                           for e in sess.stats.decode_log)
    return sess, rids, rep, ms


def mesh_rank(rank: int, ref_dir: str) -> dict:
    """One rank of phases 17a/b and 18 (launch.mesh.run_ranks starts four,
    once for both phases): what the parent checks, as host values."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    mesh = make_host_mesh(*YI_MESH, backend="gloo", device=DEVICE)
    t0 = time.perf_counter()
    out = yi_mesh_rank(rank, ref_dir, mesh)
    out["seconds_17"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["rec"] = rec_mesh_rank(rank, ref_dir, mesh)
    out["seconds_18"] = time.perf_counter() - t0
    return out


def yi_mesh_rank(rank: int, ref_dir: str, mesh) -> dict:
    """Phases 17a and 17b on one rank of `mesh`."""
    import torch
    from repro_torch import configs, core
    from repro_torch.models import transformer as M
    out = {"rank": rank, "coords": dict(mesh.coords)}
    t0 = time.perf_counter()
    cfg = configs.get(YI_ARCH).replace(num_layers=YI_LAYERS)
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    plan = core.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                           device=DEVICE)
    fused = core.force_fused_matmul(plan)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)

    # -- 17a: the main path: deferred on the mesh, the kernels pinned;
    # per_layer; +1e3 at rank 1's row-parallel wo partial in every layer
    t0 = time.perf_counter()
    local_slots = SLOTS // mesh.axis_size("data")
    out.update(_mesh_serving_cell(
        rank, mesh, cfg, params, fused, prompts,
        (("wo", "stages/b0_attn_full/attn/wo",
          _drill_hook(local_slots, whole_row=False)),), True))
    tokens = out["tokens"]
    out["serve_s"] = time.perf_counter() - t0

    out["serve_peak_before_reference_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        d = out["deferred"]
        log(f"  [rank 0] setup {out['setup_s']:.1f} s, the three mesh "
            f"sessions {out['serve_s']:.1f} s; deferred decode step "
            f"{d['decode_ms']:.2f} ms, {d['detect_launches']} detect "
            f"launches, {d['host_reads']} reads over {d['forwards']} "
            "forwards")
    # the unsharded session on the same params and the teacher-forced gate,
    # on rank 0 (the others wait at the next collective, their cached
    # memory handed back to the card)
    torch.cuda.empty_cache()
    if rank == 0:
        t0 = time.perf_counter()
        s_u, r_u, rep_u, ms_u = _mesh_session(params, cfg, fused, prompts,
                                              GEN, None)
        out["unsharded"] = {"decode_ms": ms_u,
                            "tokens": [s_u.tokens_for(r) for r in r_u]}
        del s_u
        gap, worst = teacher_forced(params, cfg, fused, prompts, tokens)
        out["teacher_forced"] = {"max_logit_gap": gap, "max_margin": worst}
        out["reference_s"] = time.perf_counter() - t0
    del params, plan, fused
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    from repro_torch.runtime import sharding as SH
    SH.axis_max(torch.zeros(1, device=DEVICE), mesh, "world")   # join
    out["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    out["train"] = _mesh_training(rank, mesh, ref_dir, YI_TRAIN_CELL)
    out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# the mesh's training cells (17b, 18d): (name, arch, layers, drill site
# and the rank it is drilled on); each trains YI_TRAIN_STEPS AdamW steps
# of YI_TRAIN_BATCH x YI_TRAIN_SEQ in YI_TRAIN_MB microbatches at
# YI_TRAIN_LR from params and batches drawn on the card from the seed
YI_TRAIN_CELL = ("yi", YI_ARCH, YI_TRAIN_LAYERS, "stages/b1_ffn/ffn/up",
                 YI_LOSS_TOL)


def _train_inputs(cell, device):
    """A training cell's config, start params and batches, drawn on the
    card from the seed: the mesh's ranks and the unsharded reference make
    the same."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as M
    cfg = configs.get(cell[1]).replace(num_layers=cell[2])
    full = M.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(SEED),
        device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    batches = [{k: torch.randint(0, cfg.vocab_size,
                                 (YI_TRAIN_BATCH, YI_TRAIN_SEQ),
                                 generator=g, device=device)
                for k in ("tokens", "labels")}
               for _ in range(YI_TRAIN_STEPS)]
    return cfg, full, batches


def _mesh_training(rank: int, mesh, ref_dir: str, cell) -> dict:
    """A training cell on one rank of the mesh (17b, 18d): bf16 params,
    AdamW, remat on; the drill pair, then YI_TRAIN_STEPS sharded steps,
    their params gathered and saved by rank 0 to `ref_dir` for the
    unsharded reference, which runs after the mesh's ranks have left the
    card (mesh_train_reference)."""
    import torch
    from repro_torch import core
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.core import injection
    from repro_torch.core.plan import current_repeat
    from repro_torch.launch import steps as ST
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime import sharding as SH
    # four ranks' training states share the card, and a step allocates
    # temporaries of many sizes: expandable segments keep each rank's
    # caching allocator from reserving GiBs it does not hold (as phase
    # 16). Training is the rank's last work of a model: it captures no
    # graph.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    name, drill_site = cell[0], cell[3]
    t0 = time.perf_counter()
    opt = OptConfig(lr=YI_TRAIN_LR)
    cfg, full, batches = _train_inputs(cell, DEVICE)
    specs = SH.param_shardings(full, mesh, cfg)
    flat = SH.flat_specs(specs)
    local = SH.shard_tree(full, specs, mesh)
    del full
    state = {"params": local, "opt": init_opt_state(local, opt),
             "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
    del local
    step = ST.make_train_step(cfg, opt, microbatches=YI_TRAIN_MB, warmup=0,
                              mesh_axes=("data", "model"))
    out = {"setup_s": time.perf_counter() - t0}

    # the drill pair: one step from the start state, clean and with +1e3
    # at rank 1's shard of the drill site in the first repeat (forward and
    # remat's recompute), both inside plan_scope(mode="correct")
    def hook(o):
        if current_repeat() == 0:
            o = o.clone()
            o[0, 5, 7] += 1e3
        return o

    with SH.parallel_scope(mesh, specs):
        with core.plan_scope(mode="correct"):
            clean, m_c = step(state, batches[0])
        # the new moments go at once, the params to the host: the drilled
        # step then holds no second state on the card
        clean = {p: t.cpu() for p, t in
                 tree_flatten_with_path(clean["params"])}
        drill = (drill_site, hook) if rank == 1 else None
        with core.plan_scope(mode="correct"), (
                injection.fault_scope(*drill) if drill
                else contextlib.nullcontext()):
            drilled, m_d = step(state, batches[0])
        drilled = drilled["params"]
    pairs = [(clean[p], t.cpu()) for p, t in
             tree_flatten_with_path(drilled)]
    out["drill"] = {
        "rank": 1, "site": drill_site,
        "report": [int(x) for x in m_d["report"]],
        "clean_report": [int(x) for x in m_c["report"]],
        "loss": float(m_d["loss"]), "clean_loss": float(m_c["loss"]),
        "params_bitwise": all(torch.equal(a, b) for a, b in pairs),
        "max_abs_diff": max(float((a.float() - b.float()).abs().max())
                            for a, b in pairs)}
    del clean, drilled, pairs

    # YI_TRAIN_STEPS sharded steps, timed
    losses, ms = [], []
    with SH.parallel_scope(mesh, specs):
        for b in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        gathered = SH.unshard_tree(state["params"], specs, mesh)
    out["losses"], out["step_ms"] = losses, ms
    out["replicated"] = {p: h for p, h in _digest(state["params"]).items()
                         if not SH.is_sharded(flat[p])}
    out["reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        log(f"  [rank 0] {name} sharded: losses {losses}, step ms {ms}")
        torch.save({p: t.cpu() for p, t in
                    tree_flatten_with_path(gathered)},
                   os.path.join(ref_dir, f"{name}_sharded_params.pt"))
    del state, gathered
    out["seconds"] = time.perf_counter() - t0
    return out


def _train_reference(ref_dir: str, cell) -> dict:
    """A training cell's unsharded reference, alone on the card once the
    mesh's ranks have left it: YI_TRAIN_STEPS unsharded steps from the
    same start params on the same batches, and two controls the gates
    must tell from a sound sharded run: the steps on each batch's first
    half (one data rank's rows alone) and the losses of the start state
    (an update that left the state unchanged). For each leaf, the sharded
    update's distance from the unsharded one, |d_s - d_r| / |d_r|
    (Frobenius, the updates d = new - start in fp32; 0 where both are 0),
    and the half-batch control's; the per-element reading against the JAX
    test's 2e-2 beside them."""
    import torch
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.launch import steps as ST
    from repro_torch.optim import OptConfig, init_opt_state
    t0 = time.perf_counter()
    opt = OptConfig(lr=YI_TRAIN_LR)
    cfg, full, batches = _train_inputs(cell, DEVICE)
    ref_step = ST.make_train_step(cfg, opt, microbatches=YI_TRAIN_MB,
                                  warmup=0)

    def start():
        return {"params": full, "opt": init_opt_state(full, opt),
                "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}

    def run(rows):
        st, losses, ms = start(), [], []
        for b in batches:
            b = {k: v[:rows] for k, v in b.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, m = ref_step(st, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        return dict(tree_flatten_with_path(st["params"])), losses, ms

    ref, ref_losses, ref_ms = run(YI_TRAIN_BATCH)
    half, half_losses, _ = run(YI_TRAIN_BATCH // 2)
    # the unchanged state's step 0 is the unsharded step 0
    unchanged_losses = [float(ref_step(start(), b)[1]["loss"])
                        for b in batches[1:]]
    sharded = torch.load(os.path.join(ref_dir,
                                      f"{cell[0]}_sharded_params.pt"))
    p0 = dict(tree_flatten_with_path(full))

    def update_gap(a, r, s0):
        d_r = r.float() - s0.float()
        gap = float(torch.linalg.vector_norm(a.float() - s0.float() - d_r))
        norm = float(torch.linalg.vector_norm(d_r))
        return gap / norm if norm else (0.0 if gap == 0 else math.inf)

    upd, upd_half, over_tol, moves = {}, {}, {}, {}
    for p, r in ref.items():
        moves[p] = not torch.equal(r, p0[p])
        a = sharded[p].to(DEVICE)
        upd[p] = update_gap(a, r, p0[p])
        upd_half[p] = update_gap(half[p], r, p0[p])
        lim = YI_TRAIN_TOL + YI_TRAIN_TOL * r.float().abs()
        over_tol[p] = float(((a.float() - r.float()).abs() / lim).max())
    out = {"losses": ref_losses, "step_ms": ref_ms,
           "half_losses": half_losses,
           "unchanged_losses": unchanged_losses,
           "update_dist": upd, "half_update_dist": upd_half,
           "moves": moves,
           "worst_over_tol": max(over_tol.values()),
           "worst_leaf": max(over_tol, key=over_tol.get),
           "reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "seconds": time.perf_counter() - t0}
    del ref, half, sharded, p0, full
    torch.cuda.empty_cache()
    return out


def unsharded_rank(rank: int, ref_dir: str, cells) -> dict:
    """The mesh phases' one-process work, alone on the card after the
    mesh's ranks have left it, in a world of one NCCL rank: 17c, then
    17b's and 18d's unsharded references ({cell name: reference})."""
    import torch
    torch.cuda.set_device(0)
    out = {"nccl": yi_nccl_rank(rank)}
    t0 = time.perf_counter()
    out["refs"] = {cell[0]: _train_reference(ref_dir, cell)
                   for cell in cells}
    out["refs_s"] = time.perf_counter() - t0
    return out


def yi_nccl_rank(rank: int) -> dict:
    """Phase 17c: a (1, 1) NCCL mesh serving yi-9b-smoke's widths in bf16
    against the unsharded session on the same params: tokens, counters
    and the forward's logits bitwise."""
    import torch
    from repro_torch import configs, core
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as M
    from repro_torch.runtime import sharding as SH
    mesh = make_host_mesh(1, 1, backend="nccl", device=DEVICE)
    cfg = configs.get(YI_ARCH + "-smoke").replace(dtype="bfloat16")
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    fused = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)
    out = {}
    for name, m in (("unsharded", None), ("mesh", mesh)):
        AM.DETECT_LAUNCHES = 0
        s, rids, rep, _ = _mesh_session(params, cfg, fused, prompts, 8, m)
        out[name] = {"tokens": [s.tokens_for(r) for r in rids],
                     "counters": rep["counters"],
                     "detect_launches": AM.DETECT_LAUNCHES}
    n = min(len(p) for p in prompts)
    toks = torch.as_tensor(__import__("numpy").stack(
        [p[:n] for p in prompts[:SLOTS]]), device=DEVICE)
    specs = SH.param_shardings(params, mesh, cfg)
    with torch.no_grad():
        want = M.forward_train(params, toks, cfg)[0]
        with SH.parallel_scope(mesh, specs):
            got = M.forward_train(SH.shard_tree(params, specs, mesh), toks,
                                  cfg)[0]
    out["logits_bitwise"] = bool(torch.equal(got, want))
    # the seam skips the collectives of an axis of one rank, so one
    # all_reduce goes to NCCL by hand
    import torch.distributed as dist
    x = torch.arange(1, 5, dtype=torch.float32, device=DEVICE)
    dist.all_reduce(x, group=mesh.group("world"))
    out["nccl_all_reduce"] = x.tolist()
    return out


def _drill_hook(local_slots: int, whole_row: bool):
    """A decode-step hook (rows of `local_slots` slots, one position) that
    adds 1e3 at slot 3's row: at one element, or across the rank's whole
    shard of the row (one element of a decay gate moves the logits by less
    than the localizer's tolerance). Rank 1 holds data shard 0, slots 0-3,
    on the (2, 2) mesh."""
    def hook(o):
        if o.dim() == 3 and o.shape[0] == local_slots and o.shape[1] == 1:
            o = o.clone()
            cols = slice(None) if whole_row else 1234 % o.shape[-1]
            o[3 % local_slots, 0, cols] += 1e3
        return o
    return hook


def _rank_counts(AM, workflow) -> dict:
    return {"detect_launches": AM.DETECT_LAUNCHES, "launches": AM.LAUNCHES,
            "host_reads": workflow.HOST_READS}


def _by_slot(rep, rids) -> dict:
    recs = {r["id"]: r for r in rep["requests"]}
    return {recs[r]["slot"]: {k: recs[r][k] for k in (
        "faults_detected", "corrections_applied", "residuals")}
        for r in rids}


def _mesh_serving_cell(rank: int, mesh, cfg, params, fused, prompts,
                       drills, per_layer: bool) -> dict:
    """One model served on the mesh as 17a serves Yi-9B: the deferred
    session over `prompts` (the kernels pinned) with its launches and
    reads, with `per_layer` the first SLOTS requests' first 8 tokens in
    per_layer mode, and each of `drills` ((name, site, hook): the hook
    runs on rank 1 only) over the first SLOTS requests' 8 tokens."""
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    out = {"seconds": {}}
    t0 = time.perf_counter()
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    sess, rids, rep, ms = _mesh_session(params, cfg, fused, prompts, GEN,
                                        mesh)
    c = rep["counters"]
    out["deferred"] = {
        "counters": c, "forwards": c["prefills"] + c["decode_steps"],
        **_rank_counts(AM, workflow), "decode_ms": ms,
        "completed": rep["completed"],
        "reasons": [r["finish_reason"] for r in rep["requests"]],
        "hits": sum(int(any(e["hit"])) for e in sess.stats.decode_log)}
    out["tokens"] = [sess.tokens_for(r) for r in rids]
    del sess
    out["seconds"]["deferred"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if per_layer:
        AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
        s_pl, r_pl, rep_pl, _ = _mesh_session(
            params, cfg, fused, prompts[:SLOTS], 8, mesh,
            correction="per_layer")
        c_pl = rep_pl["counters"]
        out["per_layer"] = {
            "tokens": [s_pl.tokens_for(r) for r in r_pl],
            "forwards": c_pl["prefills"] + c_pl["decode_steps"],
            "launches": AM.LAUNCHES, "host_reads": workflow.HOST_READS}
        del s_pl
        out["seconds"]["per_layer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["drills"] = {}
    for name, site, hook in drills:
        s_d, r_d, rep_d, _ = _mesh_session(
            params, cfg, fused, prompts[:SLOTS], 8, mesh,
            hook=(site, hook) if rank == 1 else None)
        out["drills"][name] = {
            "rank": 1, "site": site, "counters": rep_d["counters"],
            "by_slot": _by_slot(rep_d, r_d),
            "tokens": [s_d.tokens_for(r) for r in r_d]}
        del s_d
    out["seconds"]["drills"] = time.perf_counter() - t0
    return out


def rec_mesh_rank(rank: int, ref_dir: str, mesh) -> dict:
    """Phase 18 on one rank of `mesh` (the ranks of phase 17, after it):
    18a RecurrentGemma-2B served at full width, 18b its context-parallel
    decode of one long prompt, 18c Mamba2-1.3B served, 18d both trained;
    what the parent checks, as host values. Rank 0 also runs the
    unsharded references of 18a-c (the teacher-forced forwards, 18b's
    unsharded session) while the others wait at the next collective."""
    import numpy as np
    import torch
    from repro_torch import configs, core
    from repro_torch._tree import tree_flatten_with_path, tree_map
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as M
    from repro_torch.runtime import sharding as SH
    torch.cuda.reset_peak_memory_stats()
    out = {}
    local_slots = SLOTS // mesh.axis_size("data")
    row_hook = _drill_hook(local_slots, whole_row=True)
    one_hook = _drill_hook(local_slots, whole_row=False)

    def join():
        SH.axis_max(torch.zeros(1, device=DEVICE), mesh, "world")

    # -- 18a: RecurrentGemma-2B on the mesh ----------------------------------
    t0 = time.perf_counter()
    cfg = configs.get(RG_ARCH).replace(num_layers=RG_MESH_LAYERS)
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    params["embed"]["table"].mul_(RG_TABLE_SCALE)
    fused = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)
    t0 = time.perf_counter()
    a = _mesh_serving_cell(
        rank, mesh, cfg, params, fused, prompts,
        (("gate_a", "stages/b0_rec/rec/gate_a", row_hook),
         ("wo", "stages/b4_attn_swa/attn/wo", one_hook)), True)
    a["setup_s"] = setup_s
    a["serve_s"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        gap, worst = teacher_forced(params, cfg, fused, prompts,
                                    a["tokens"])
        a["teacher_forced"] = {"bf16": {"max_logit_gap": gap,
                                        "max_margin": worst}}
        a["reference_s"] = time.perf_counter() - t0
    a["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    join()
    out["rg"] = a

    # -- 18b: context-parallel decode of one long prompt ---------------------
    t0 = time.perf_counter()
    prompt = np.random.default_rng(SEED + 4).integers(0, cfg.vocab_size,
                                                       CP_PROMPT)
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    sess, rids, rep, ms = _mesh_session(params, cfg, fused, [prompt],
                                        CP_GEN, mesh, slots=1,
                                        max_len=CP_MAX_LEN)
    c = rep["counters"]
    b = {"counters": c, "forwards": c["prefills"] + c["decode_steps"],
         **_rank_counts(AM, workflow), "decode_ms": ms,
         "completed": rep["completed"],
         "tokens": sess.tokens_for(rids[0]),
         "kv_shapes": {p: list(t.shape) for p, t in
                       tree_flatten_with_path(sess._caches)
                       if p.endswith(("/k", "/v"))}}
    del sess
    b["seconds"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        s_u, r_u, _, ms_u = _mesh_session(params, cfg, fused, [prompt],
                                          CP_GEN, None, slots=1,
                                          max_len=CP_MAX_LEN)
        b["unsharded"] = {"decode_ms": ms_u,
                          "tokens": s_u.tokens_for(r_u[0])}
        del s_u
        torch.cuda.empty_cache()
        tf = {}
        for k, toks in (("mesh", b["tokens"]),
                        ("unsharded", b["unsharded"]["tokens"])):
            gap, worst = teacher_forced(params, cfg, fused, [prompt], [toks])
            tf[k] = {"max_logit_gap": gap, "max_margin": worst}
        b["teacher_forced"] = tf
        b["reference_s"] = time.perf_counter() - t0
    b["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    fused = None
    torch.cuda.empty_cache()
    join()
    out["cp"] = b

    # -- 18a's float32 twin of the same weights, served on the mesh (the
    # bf16 plan gone first: one model's plan on the card at a time) -------
    t0 = time.perf_counter()
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    fused32 = core.force_fused_matmul(core.build_plan(
        p32, cfg32, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    s32, r32, rep32, _ = _mesh_session(p32, cfg32, fused32,
                                       prompts[:SLOTS], 8, mesh)
    a["f32"] = {"counters": rep32["counters"],
                "completed": rep32["completed"]}
    tokens32 = [s32.tokens_for(r) for r in r32]
    del s32
    if rank == 0:
        gap32, worst32 = teacher_forced(p32, cfg32, fused32,
                                        prompts[:SLOTS], tokens32)
        a["teacher_forced"]["f32"] = {"max_logit_gap": gap32,
                                      "max_margin": worst32}
    a["f32"]["seconds"] = time.perf_counter() - t0
    a["f32"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    del p32, fused32
    torch.cuda.empty_cache()
    join()

    # -- 18c: Mamba2-1.3B on the mesh ----------------------------------------
    t0 = time.perf_counter()
    cfg = configs.get(MAMBA_ARCH).replace(num_layers=MAMBA_MESH_LAYERS)
    params = M.init_params(
        cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    fused = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=SLOTS, seq=MAX_LEN, device=DEVICE))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)
    t0 = time.perf_counter()
    m = _mesh_serving_cell(
        rank, mesh, cfg, params, fused, prompts,
        (("in_proj", "stages/b0_ssm/ssm/in_proj", one_hook),), False)
    m["setup_s"], m["serve_s"] = setup_s, time.perf_counter() - t0
    if rank == 0:
        gap, worst = teacher_forced(params, cfg, fused, prompts,
                                    m["tokens"])
        m["teacher_forced"] = {"max_logit_gap": gap, "max_margin": worst}
    m["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, fused
    torch.cuda.empty_cache()
    join()
    out["mamba"] = m
    out["serving_peak_gib"] = max(a["peak_gib"], a["f32"]["peak_gib"],
                                  b["peak_gib"], m["peak_gib"])

    # -- 18d: training both ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    out["train"] = {cell[0]: _mesh_training(rank, mesh, ref_dir, cell)
                    for cell in REC_TRAIN_CELLS}
    out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        log(f"  [rank 0] 18: setup RecurrentGemma-2B {a['setup_s']:.1f} s, "
            f"its sessions {a['serve_s']:.1f} s, 18b {b['seconds']:.1f} s, "
            f"Mamba2-1.3B setup {m['setup_s']:.1f} s, sessions "
            f"{m['serve_s']:.1f} s, training "
            f"{[round(t['seconds'], 1) for t in out['train'].values()]} s")
    return out


@contextlib.contextmanager
def card_memory_peak(out: dict, key: str, period_s: float = 0.05):
    """The card's memory in use by every process (cudaMemGetInfo),
    sampled on a thread every `period_s` while the scope runs; its peak
    in GiB lands in out[key]."""
    import threading
    import torch
    stop = threading.Event()
    peak = [0]

    def poll():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)
            stop.wait(period_s)

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()
        out[key] = peak[0] / 2 ** 30


def check_mesh_training(label: str, trains, ref, loss_tol: float) -> dict:
    """The gates of a training cell on the mesh (17b, 18d): `trains` is
    each rank's _mesh_training result, `ref` the cell's
    _train_reference, `loss_tol` its loss limit. The limits must catch
    both controls: each is over the loss limit at some step, and the
    half-batch control over the update limit at some leaf."""
    t = trains[0]
    loss_gap = [abs(a - b) for a, b in zip(t["losses"], ref["losses"])]
    half_gap = [abs(a - b) for a, b in zip(ref["half_losses"],
                                           ref["losses"])]
    same_gap = [abs(a - b) for a, b in zip(ref["unchanged_losses"],
                                           ref["losses"][1:])]
    upd = ref["update_dist"]
    worst_upd = max(upd, key=upd.get)
    half_upd = [d for p, d in ref["half_update_dist"].items()
                if ref["moves"][p]]
    log(f"  {label}: losses {t['losses']} sharded, {ref['losses']} unsharded; "
        f"|loss gap| {[f'{x:.3g}' for x in loss_gap]} (limit "
        f"{loss_tol}; controls: half batch "
        f"{[f'{x:.3g}' for x in half_gap]}, unchanged state "
        f"{[f'{x:.3g}' for x in same_gap]} after step 0)")
    log(f"  {label} updates: |d_sharded - d_unsharded| / |d_unsharded| at most "
        f"{upd[worst_upd]:.4g} ({worst_upd}; limit {YI_UPDATE_TOL}); the "
        f"half-batch control {min(half_upd):.4g}-{max(half_upd):.4g} on the "
        f"{len(half_upd)} leaves that move (the others stay bitwise: bf16 "
        "rounds their updates away); an unchanged state reads 1. "
        f"Per element: |diff| / ({YI_TRAIN_TOL} + {YI_TRAIN_TOL} |p|) "
        f"{ref['worst_over_tol']:.3g} at {ref['worst_leaf']}")
    log(f"  {label} step ms {[round(x, 1) for x in t['step_ms']]} sharded, "
        f"{[round(x, 1) for x in ref['step_ms']]} unsharded (alone, "
        f"{ref['seconds']:.1f} s with its controls)")
    if not (max(half_gap) > loss_tol and max(same_gap) > loss_tol
            and max(half_upd) > YI_UPDATE_TOL):
        fail(f"{label}: the limits do not catch the controls (half batch: "
             f"loss gaps {half_gap}, updates up to {max(half_upd):.4g}; "
             f"unchanged state: {same_gap})")
    for i, g in enumerate(loss_gap):
        if not g <= loss_tol:
            fail(f"{label} step {i}: loss {t['losses'][i]} sharded vs "
                 f"{ref['losses'][i]} unsharded")
    for p, d in upd.items():
        if not d <= YI_UPDATE_TOL:
            fail(f"{label}: {p}'s update is {d:.4g} of the unsharded one "
                 "away from it")
    if not ref["worst_over_tol"] <= 1.0:
        fail(f"{label}: {ref['worst_leaf']} beyond {YI_TRAIN_TOL}")
    for rank, tr in enumerate(trains):
        if tr["replicated"] != t["replicated"]:
            fail(f"{label}: rank {rank}'s replicated leaves differ from "
                 "rank 0's")
        dr = tr["drill"]
        if not (dr["report"][0] and dr["report"][1] and not dr["report"][2]
                and dr["clean_report"] == [0, 0, 0]
                and dr["loss"] == dr["clean_loss"]
                and dr["params_bitwise"]):
            fail(f"{label} rank {rank}: {dr['site']} drill {dr}")
    dr = t["drill"]
    log(f"  {label} drill: +1e3 at rank 1's {dr['site']} shard (forward and "
        f"recompute): report {dr['report']} on every rank, loss "
        f"{dr['loss']} == clean {dr['clean_loss']}; new params bitwise the "
        "clean step's on every rank; replicated leaves bitwise equal "
        "across ranks")
    return {"losses": t["losses"], "unsharded": ref,
            "step_ms": [tr["step_ms"] for tr in trains],
            "drill": t["drill"],
            "reserved_gib": [tr["reserved_gib"] for tr in trains]}


def _check_mesh_serving(label: str, cells, n_sites: int,
                        per_layer: bool) -> None:
    """17a's serving gates on every rank's _mesh_serving_cell result:
    every request finished by length, a clean count, `n_sites` detect
    launches and 1 read per forward, the tokens equal across ranks,
    per_layer's same tokens with `n_sites` launches and reads a forward,
    and each drill detected and corrected in every decode step at slot 3
    only, its tokens the clean ones."""
    c0 = cells[0]
    want = [t[:8] for t in c0["tokens"][:SLOTS]]
    for rank, cell in enumerate(cells):
        d = cell["deferred"]
        log(f"  {label} rank {rank}: deferred {d['completed']} requests, "
            f"{d['forwards']} forwards, detect launches "
            f"{d['detect_launches']}, abft_matmul {d['launches']}, host "
            f"reads {d['host_reads']}, decode step {d['decode_ms']:.2f} ms")
        if d["reasons"] != ["length"] * N_REQ or d["completed"] != N_REQ:
            fail(f"{label} rank {rank}: requests finished {d['reasons']}")
        c = d["counters"]
        if c["faults_detected"] or c["dropped"] or d["hits"]:
            fail(f"{label} rank {rank}: clean serving counted {c}")
        if (d["detect_launches"] != n_sites * d["forwards"] or d["launches"]
                or d["host_reads"] != d["forwards"]):
            fail(f"{label} rank {rank}: {d['forwards']} forwards launched "
                 f"{d['detect_launches']} detect / {d['launches']} "
                 f"abft_matmul with {d['host_reads']} reads; want "
                 f"{n_sites} detect launches and 1 read each")
        if cell["tokens"] != c0["tokens"]:
            fail(f"{label}: rank {rank}'s tokens differ from rank 0's")
        if per_layer:
            pl = cell["per_layer"]
            if pl["tokens"] != want:
                fail(f"{label} rank {rank}: per_layer tokens differ from "
                     "deferred's")
            if (pl["launches"] != n_sites * pl["forwards"]
                    or pl["host_reads"] != n_sites * pl["forwards"]):
                fail(f"{label} rank {rank}: per_layer {pl}")
        for name, dr in cell["drills"].items():
            by, cd = dr["by_slot"], dr["counters"]
            tgt = by[3]
            ok = (tgt["faults_detected"] == cd["decode_steps"]
                  and tgt["corrections_applied"] == cd["decode_steps"]
                  and tgt["residuals"] == 0
                  and all(v["faults_detected"] == 0
                          for sl, v in by.items() if sl != 3)
                  and cd["faults_unattributed"] == 0
                  and cd["residual_steps"] == 0)
            if not ok or dr["tokens"] != want:
                fail(f"{label} rank {rank}: {name} drill {by} {cd}, tokens "
                     f"equal {dr['tokens'] == want}")
    log(f"  {label} seconds on rank 0: " + ", ".join(
        f"{k} {v:.1f}" for k, v in c0["seconds"].items()))
    if per_layer:
        pl = c0["per_layer"]
        log(f"  {label} per_layer: {pl['launches']} abft_matmul launches "
            f"and {pl['host_reads']} reads over {pl['forwards']} forwards, "
            "tokens == deferred, on every rank")
    for name, dr in c0["drills"].items():
        cd = dr["counters"]
        log(f"  {label} drill: +1e3 at rank 1's {dr['site']} shard, slot 3, "
            f"every decode step: {cd['faults_detected']} detected / "
            f"{cd['faults_corrected']} corrected over {cd['decode_steps']} "
            "steps on every rank, attributed to its request, tokens == "
            "clean")


def check_rec_mesh(ranks, refs) -> dict:
    """Phase 18's gates on what the ranks returned (rec_mesh_rank) and the
    unsharded training references."""
    recs = [r["rec"] for r in ranks]
    r0 = recs[0]
    res = {}
    # -- 18a
    n_rg = 23 * RG_MESH_LAYERS // 3 + 1
    _check_mesh_serving("18a", [r["rg"] for r in recs], n_rg, True)
    a = r0["rg"]
    tf = a["teacher_forced"]
    log(f"  18a teacher-forced, bf16: the kernel route and cuBLAS differ by "
        f"up to {tf['bf16']['max_logit_gap']:.4g} in a logit; the mesh's "
        f"tokens at most {tf['bf16']['max_margin']:.4g} below the "
        f"unsharded unprotected top (limit 2 x gap + {DELTA}); the float32 "
        f"twin served on the mesh {tf['f32']['max_margin']:.4g} (limit "
        f"{DELTA}, gap {tf['f32']['max_logit_gap']:.4g})")
    if not (tf["bf16"]["max_margin"]
            <= 2 * tf["bf16"]["max_logit_gap"] + DELTA):
        fail(f"18a: a served token is {tf['bf16']['max_margin']:.4g} below "
             "the unsharded top")
    for r in recs:
        f32 = r["rg"]["f32"]
        if f32["counters"]["faults_detected"] or f32["completed"] != SLOTS:
            fail(f"18a float32 twin on the mesh: {f32}")
    if not tf["f32"]["max_margin"] <= DELTA:
        fail(f"18a float32 twin: a served token is "
             f"{tf['f32']['max_margin']:.4g} below the top")
    res["rg"] = {"decode_ms": [r["rg"]["deferred"]["decode_ms"]
                               for r in recs],
                 "detect_launches_per_forward": n_rg,
                 "forwards": a["deferred"]["forwards"],
                 "teacher_forced": tf,
                 "drills": {k: v["counters"] for k, v in a["drills"].items()},
                 "setup_s": [r["rg"]["setup_s"] for r in recs],
                 "serve_s": [r["rg"]["serve_s"] for r in recs]}
    # -- 18b
    from repro_torch import configs
    b = r0["cp"]
    cfg = configs.get(RG_ARCH)
    tp = YI_MESH[1]
    hkv = cfg.num_kv_heads // (tp if cfg.num_kv_heads % tp == 0 else 1)
    want_kv = [RG_MESH_LAYERS // 3, 1, CP_MAX_LEN // YI_MESH[0], hkv,
               cfg.head_dim]
    for rank, r in enumerate(recs):
        cp = r["cp"]
        if cp["tokens"] != b["tokens"] or cp["completed"] != 1:
            fail(f"18b: rank {rank} served {cp['tokens']}")
        if (cp["detect_launches"] != n_rg * cp["forwards"] or cp["launches"]
                or cp["host_reads"] != cp["forwards"]
                or cp["counters"]["faults_detected"]):
            fail(f"18b rank {rank}: {cp['forwards']} forwards, "
                 f"{cp['detect_launches']} detect launches, "
                 f"{cp['host_reads']} reads, {cp['counters']}")
        if any(v != want_kv for v in cp["kv_shapes"].values()):
            fail(f"18b rank {rank}: KV blocks {cp['kv_shapes']}, want "
                 f"{want_kv} each")
    tfb = b["teacher_forced"]
    same = sum(x == y for x, y in zip(b["tokens"], b["unsharded"]["tokens"]))
    log(f"  18b: one {CP_PROMPT}-token prompt, {CP_GEN} new tokens, 1 slot, "
        f"max_len {CP_MAX_LEN}: each data rank's KV blocks {want_kv} "
        f"(every decode window of {cfg.window_size} crosses position "
        f"{CP_MAX_LEN // YI_MESH[0]}); {n_rg} detect launches and 1 read "
        f"per forward per rank; {same}/{CP_GEN} tokens equal the unsharded "
        f"session's; teacher-forced, the mesh's tokens at most "
        f"{tfb['mesh']['max_margin']:.4g} below the unsharded unprotected "
        f"top, the unsharded session's {tfb['unsharded']['max_margin']:.4g} "
        f"(limit: the unsharded session's + {DELTA}); decode step "
        f"{[round(r['cp']['decode_ms'], 2) for r in recs]} ms a rank, "
        f"unsharded {b['unsharded']['decode_ms']:.2f} ms (four ranks on one "
        "card: not a multi-card speed)")
    if not (tfb["mesh"]["max_margin"]
            <= tfb["unsharded"]["max_margin"] + DELTA):
        fail(f"18b: the context-parallel tokens sit "
             f"{tfb['mesh']['max_margin']:.4g} below the top, the unsharded "
             f"session's {tfb['unsharded']['max_margin']:.4g}")
    res["cp"] = {"decode_ms": [r["cp"]["decode_ms"] for r in recs],
                 "unsharded_decode_ms": b["unsharded"]["decode_ms"],
                 "token_equal": same, "teacher_forced": tfb,
                 "kv_block": want_kv,
                 "seconds": [r["cp"]["seconds"] for r in recs]}
    # -- 18c
    n_m = 2 * MAMBA_MESH_LAYERS + 1
    _check_mesh_serving("18c", [r["mamba"] for r in recs], n_m, False)
    tfm = r0["mamba"]["teacher_forced"]
    log(f"  18c teacher-forced, bf16: gap {tfm['max_logit_gap']:.4g}, the "
        f"mesh's tokens at most {tfm['max_margin']:.4g} below the top "
        f"(limit 2 x gap + {DELTA})")
    if not tfm["max_margin"] <= 2 * tfm["max_logit_gap"] + DELTA:
        fail(f"18c: a served token is {tfm['max_margin']:.4g} below the top")
    res["mamba"] = {"decode_ms": [r["mamba"]["deferred"]["decode_ms"]
                                  for r in recs],
                    "detect_launches_per_forward": n_m,
                    "forwards": r0["mamba"]["deferred"]["forwards"],
                    "teacher_forced": tfm,
                    "drills": {k: v["counters"] for k, v in
                               r0["mamba"]["drills"].items()}}
    # -- 18d
    res["training"] = {
        cell[0]: check_mesh_training(f"18d {cell[0]}",
                                     [r["train"][cell[0]] for r in recs],
                                     refs[cell[0]], cell[4])
        for cell in REC_TRAIN_CELLS}
    peaks = {k: [round(v, 2) for v in vals] for k, vals in (
        ("18a", [r["rg"]["peak_gib"] for r in recs]),
        ("18a float32 twin", [r["rg"]["f32"]["peak_gib"] for r in recs]),
        ("18b", [r["cp"]["peak_gib"] for r in recs]),
        ("18c", [r["mamba"]["peak_gib"] for r in recs]),
        *((f"18d {c[0]}", [r["train"][c[0]]["peak_gib"] for r in recs])
          for c in REC_TRAIN_CELLS))}
    log(f"  18 allocated peaks a rank, GiB: {peaks}")
    res["peaks_gib"] = peaks
    res["peak_gib"] = [max(r["serving_peak_gib"], r["train_peak_gib"])
                       for r in recs]
    return res


def run_mesh_phase(report) -> dict:
    """Phases 17 and 18: the (data, model) mesh (YI_MESH: four ranks that
    share the card through gloo) serving (17a) and training (17b) Yi-9B
    at full width, then in the same ranks RecurrentGemma-2B served (18a)
    with one long prompt's context-parallel decode (18b), Mamba2-1.3B
    served (18c) and both trained (18d); then a (1, 1) NCCL mesh (17c).
    The ranks are child processes (launch.mesh.run_ranks), the unsharded
    training references a process of their own after them; this process
    checks what they return."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import run_ranks
    log(f"phase 17a/b: Yi-9B on a {YI_MESH} mesh of {math.prod(YI_MESH)} "
        f"ranks sharing the card through gloo ({YI_LAYERS} layers served, "
        f"{YI_TRAIN_LAYERS} trained), then in the same ranks phase 18: "
        f"RecurrentGemma-2B ({RG_MESH_LAYERS} layers served, one "
        f"{CP_PROMPT}-token prompt decoded context-parallel), Mamba2-1.3B "
        f"({MAMBA_MESH_LAYERS} layers served), both trained "
        f"({[c[2] for c in REC_TRAIN_CELLS]} layers)")
    torch.cuda.empty_cache()        # the card's memory gate counts ours too
    log(f"  this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
        "GiB of the card's memory while the ranks run")
    t0 = time.perf_counter()
    card = {}
    cells = (YI_TRAIN_CELL,) + REC_TRAIN_CELLS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ref_dir:
        with card_memory_peak(card, "peak_gib"):
            ranks = run_ranks(mesh_rank, math.prod(YI_MESH), "gloo",
                              MESH_TIMEOUT_S, (ref_dir,))
        res = {"wall_s": time.perf_counter() - t0}
        # 17c and the unsharded training references, alone on the card
        t1 = time.perf_counter()
        with card_memory_peak(card, "reference_peak_gib"):
            (alone,) = run_ranks(unsharded_rank, 1, "nccl",
                                 MESH_TIMEOUT_S, (ref_dir, cells))
        res["alone_s"] = time.perf_counter() - t1
    refs = alone["refs"]
    res["train_reference_s"] = alone["refs_s"]
    ref = refs["yi"]
    res.update({"card_peak_gib": card["peak_gib"],
                "reference_card_peak_gib": card["reference_peak_gib"],
                "setup_s": [r["setup_s"] for r in ranks],
                "serve_s": [r["serve_s"] for r in ranks],
                "rank_seconds_17": [r["seconds_17"] for r in ranks],
                "rank_seconds_18": [r["seconds_18"] for r in ranks]})
    r0 = ranks[0]
    n_sites = YI_LAYERS * 7 + 1
    log(f"  setup {[round(r['setup_s'], 1) for r in ranks]} s a rank")
    _check_mesh_serving("17a", ranks, n_sites, True)
    tf = r0["teacher_forced"]
    un = r0["unsharded"]
    same = sum(a == b for a, b in zip(r0["tokens"], un["tokens"]))
    log(f"  teacher-forced vs the unsharded unprotected forward: largest "
        f"logit gap {tf['max_logit_gap']:.4g}; served tokens at most "
        f"{tf['max_margin']:.4g} below the top (limit {DELTA}); "
        f"{same}/{N_REQ} requests token-equal to the unsharded session")
    if not tf["max_margin"] <= DELTA:
        fail(f"17a: a served token's reference logit is "
             f"{tf['max_margin']:.4g} below the top")
    log(f"  decode step: mesh {[round(r['deferred']['decode_ms'], 3) for r in ranks]} "
        f"ms per rank, unsharded session {un['decode_ms']:.3f} ms (four "
        f"ranks on one card: not a multi-card speed)")
    res["serving"] = {
        "decode_ms": [r["deferred"]["decode_ms"] for r in ranks],
        "unsharded_decode_ms": un["decode_ms"],
        "detect_launches_per_forward": n_sites,
        "forwards": r0["deferred"]["forwards"],
        "detect_launches": [r["deferred"]["detect_launches"] for r in ranks],
        "per_layer_launches": [r["per_layer"]["launches"] for r in ranks],
        "per_layer_forwards": r0["per_layer"]["forwards"],
        "host_reads": [r["deferred"]["host_reads"] for r in ranks],
        "teacher_forced": tf, "token_equal_requests": same,
        "drill": r0["drills"]["wo"]["counters"],
        "peak_gib": [r["serving_peak_gib"] for r in ranks]}

    # -- 17b --------------------------------------------------------------
    res["training"] = check_mesh_training(
        "17b", [r["train"] for r in ranks], ref, YI_TRAIN_CELL[4])
    res["training"]["peak_gib"] = [r["train_peak_gib"] for r in ranks]

    # -- 18 ---------------------------------------------------------------
    res["rec"] = check_rec_mesh(ranks, refs)
    log(f"  the card's memory in use, every process, at its peak: "
        f"{card['peak_gib']:.1f} GiB on the mesh (limit {MESH_PEAK_GIB}; "
        f"the ranks' own allocated peaks "
        f"{[round(max(r['serving_peak_gib'], r['train_peak_gib'], r['rec']['serving_peak_gib'], r['rec']['train_peak_gib']), 1) for r in ranks]}"
        f" GiB, reserved in training "
        f"{[round(max(t['reserved_gib'] for t in [r['train']] + list(r['rec']['train'].values())), 1) for r in ranks]}), "
        f"{card['reference_peak_gib']:.1f} GiB for the references alone; "
        f"phases 17a/b and 18 {res['wall_s']:.1f} s (a rank's 17a/b "
        f"{[round(r['seconds_17'], 1) for r in ranks]} s, 18 "
        f"{[round(r['seconds_18'], 1) for r in ranks]} s), 17c and the "
        f"references in one process {res['alone_s']:.1f} s")
    if card["peak_gib"] > MESH_PEAK_GIB:
        fail(f"phases 17-18: the card held {card['peak_gib']:.1f} GiB")

    # -- 17c --------------------------------------------------------------
    log("phase 17c: a (1, 1) NCCL mesh serving yi-9b-smoke's widths in "
        "bf16 (in the references' process, before them)")
    c = alone["nccl"]
    res["nccl_s"] = res["alone_s"] - res["train_reference_s"]
    ok = (c["mesh"]["tokens"] == c["unsharded"]["tokens"]
          and c["mesh"]["counters"] == c["unsharded"]["counters"]
          and c["mesh"]["detect_launches"]
          == c["unsharded"]["detect_launches"] > 0
          and c["logits_bitwise"]
          and c["nccl_all_reduce"] == [1.0, 2.0, 3.0, 4.0])
    log(f"  tokens, counters and {c['mesh']['detect_launches']} detect "
        f"launches equal, forward logits bitwise, one NCCL all_reduce on "
        f"the card: {ok} ({res['nccl_s']:.1f} s; the mesh's own "
        "collectives are no-ops on axes of one rank)")
    if not ok:
        fail(f"17c: the (1, 1) NCCL mesh differs from the unsharded path: "
             f"{c}")
    res["nccl"] = {"detect_launches": c["mesh"]["detect_launches"]}
    report["mesh"] = res
    return res


# --------------------------------------------------------------------------
# phase 8: the campaign
# --------------------------------------------------------------------------

def campaign_part(spec: dict) -> dict:
    """One part of phase 8, run in a process of its own (`--campaign-part
    SPEC`): a layer of the paper grid at spec["paper_trials"] per cell,
    some layers of the whole grid at spec["grid_trials"], or ("vs_cpu")
    every arm of every layer at spec["cmp_trials"] under scheme full on
    the card and on the CPU, with the per-arm counts of differing
    verdicts and the differing corrected_by values. A result is the
    CampaignResult's dict or {"vs_cpu": {...}}."""
    import numpy as np
    import torch
    from repro_torch.campaign import (LAYER_CASES, SCHEME_CONFIGS,
                                      CampaignEngine)
    from repro_torch.core import injection as inj
    kind, _, arg = spec["part"].partition(":")
    if kind != "vs_cpu":
        # the trial loops launch small ops one by one from the host;
        # one intra-op thread each leaves the cores to the other parts
        torch.set_num_threads(1)
    eng = CampaignEngine(device=spec["device"])
    seed = spec["seed"]
    if kind == "paper":
        return eng.run([arg], ["full"], trials=spec["paper_trials"],
                       seed=seed).to_dict()
    if kind == "grid":
        return eng.run(arg.split(","), list(SCHEME_CONFIGS),
                       trials=spec["grid_trials"], seed=seed).to_dict()
    cpu = CampaignEngine(device="cpu")
    n = spec["cmp_trials"]
    out = {}
    for layer in LAYER_CASES:
        for fault in [inj.CONTROL_MODEL] + inj.fault_model_names():
            a, _ = eng.run_trials(layer, "full", fault, n, seed=seed)
            b, _ = cpu.run_trials(layer, "full", fault, n, seed=seed)
            rung = a.corrected_by != b.corrected_by
            out[f"{layer}/{fault}"] = {
                **{f: int(np.sum(getattr(a, f) != getattr(b, f)))
                   for f in ("detected", "corrected_by", "residual")},
                "rungs": [a.corrected_by[rung].tolist(),
                          b.corrected_by[rung].tolist()]}
    return {"vs_cpu": out}


def start_campaign() -> dict:
    """Start phase 8: each of CAMPAIGN_PARTS in a child process of this
    script, writing its result under build/chip_smoke_campaign/. The
    trial loops wait on the host (about 10 ms a trial, the card mostly
    idle), so the parts run side by side and beside phases 6-7b;
    run_campaign_phase collects them."""
    import shutil
    out_dir = ROOT / "build" / "chip_smoke_campaign"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = []
    for i, part in enumerate(CAMPAIGN_PARTS):
        spec = {"part": part, "device": DEVICE, "seed": SEED,
                "paper_trials": PAPER_TRIALS, "grid_trials": GRID_TRIALS,
                "cmp_trials": CMP_TRIALS}
        out, logf = out_dir / f"part{i}.json", out_dir / f"part{i}.log"
        with open(logf, "w") as f:
            p = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--campaign-part", json.dumps(spec), "--json", str(out)],
                stdout=f, stderr=subprocess.STDOUT, cwd=ROOT)
        procs.append({"part": part, "proc": p, "out": out, "log": logf})
    log(f"phase 8: the campaign, started in {len(procs)} processes "
        f"beside phases 4-7b: {', '.join(CAMPAIGN_PARTS)}")
    return {"procs": procs, "t0": time.perf_counter()}


def stop_campaign(started: dict) -> None:
    """End every child process of start_campaign still running."""
    for c in started.get("procs", []):
        if c["proc"].poll() is None:
            c["proc"].kill()
        c["proc"].wait()


def run_campaign_phase(report, started: dict) -> dict:
    """Phase 8: the fault-injection campaign on the card. The JAX CLI's
    default grid (matmul and conv, scheme full, every registered arm) at
    PAPER_TRIALS per cell, and the whole grid (three layers x five
    schemes x every arm) at GRID_TRIALS: every gate of the port's check
    holds, and deferred gives full's detection rate and scheme histogram
    per arm.
    Every arm of every layer (CMP_TRIALS trials, scheme full) is run
    again on the CPU: the per-trial verdicts are compared; a detected or
    residual mismatch fails. corrected_by may differ (which rung first
    verifies depends on the order of the sums, ROADMAP 3.4), but only
    between two correcting verdicts and in at most RUNG_MISMATCH_SHARE of
    the trials. The parts ran in start_campaign's processes; this waits
    for them and checks what they wrote."""
    import numpy as np
    from repro_torch.campaign import CampaignResult, CellResult
    from repro_torch.campaign.run import check
    from repro_torch.core import types as T
    correcting = [T.COC, T.RC, T.CLC, T.FC, T.RECOMPUTE]

    log("phase 8: the campaign (collected)")
    t_wait = time.perf_counter()
    got = {}
    for c in started["procs"]:
        left = CAMPAIGN_LIMIT_S - (time.perf_counter() - started["t0"])
        try:
            rc = c["proc"].wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            fail(f"campaign part {c['part']} still running "
                 f"{CAMPAIGN_LIMIT_S} s after its start")
        if rc != 0 or not c["out"].is_file():
            tail = c["log"].read_text()[-4000:] if c["log"].is_file() else ""
            fail(f"campaign part {c['part']} exited {rc}:\n{tail}")
        got[c["part"]] = json.loads(c["out"].read_text())
    waited = time.perf_counter() - t_wait
    wall_s = time.perf_counter() - started["t0"]

    def merged(kind):
        parts = [got[p] for p in CAMPAIGN_PARTS if p.startswith(kind)]
        cells = [CellResult(**c) for r in parts for c in r["cells"]]
        meta = dict(parts[0]["meta"], wall_seconds=sum(
            c.wall_seconds for c in cells))
        return CampaignResult(cells=cells, meta=meta)

    paper, grid = merged("paper:"), merged("grid:")
    for c in paper.cells + grid.cells:
        log(f"  {c.row()}")
    bad = check(paper) + check(grid)
    if bad:
        fail(f"campaign gates: {bad}")
    for c in grid.cells:
        if c.scheme == "deferred":
            f = grid.cell(c.layer, "full", c.fault)
            if (c.detection_rate, c.corrected_by) != \
                    (f.detection_rate, f.corrected_by):
                fail(f"{c.layer}/{c.fault}: deferred {c.detection_rate} "
                     f"{c.corrected_by} vs full {f.detection_rate} "
                     f"{f.corrected_by}")
    mism = got["vs_cpu"]["vs_cpu"]
    for key, n in mism.items():
        if n["detected"] or n["residual"]:
            fail(f"card vs CPU {key}: {n}")
        a, b = n.pop("rungs")
        if not (np.isin(a, correcting).all()
                and np.isin(b, correcting).all()):
            fail(f"card vs CPU {key}: corrected_by {a} vs {b}")
    by = sum(v["corrected_by"] for v in mism.values())
    if by > RUNG_MISMATCH_SHARE * CMP_TRIALS * len(mism):
        fail(f"card vs CPU: {by} corrected_by mismatches in "
             f"{CMP_TRIALS * len(mism)} trials")
    trials = sum(c.trials for c in paper.cells + grid.cells)
    loops = paper.meta["wall_seconds"] + grid.meta["wall_seconds"]
    log(f"  gates hold on {len(paper.cells)} paper cells x "
        f"{paper.meta['trials']} and {len(grid.cells)} grid cells x "
        f"{grid.meta['trials']} trials; deferred == full per "
        f"arm; card vs CPU ({CMP_TRIALS} trials per arm, scheme full): 0 "
        f"detected / 0 residual mismatches, {by} corrected_by mismatches "
        f"of {CMP_TRIALS * len(mism)}")
    log(f"  {trials} trials, {loops:.1f} s in the trial loops of "
        f"{len(started['procs'])} processes ({loops / trials * 1e6:.0f} us "
        f"per trial on the host clock); {wall_s:.1f} s from their start, "
        f"{waited:.1f} s of it waited for here")
    res = {"paper": paper.to_dict(), "grid": grid.to_dict(),
           "card_vs_cpu_mismatches": mism,
           "us_per_trial": loops / trials * 1e6,
           "wall_s": wall_s, "waited_s": waited}
    report["campaign"] = res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write the run's details as JSON to PATH")
    ap.add_argument("--campaign-part", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.campaign_part:
        # a child of start_campaign: one part of phase 8, its result to
        # the --json path
        sys.path.insert(0, str(SRC))
        res = campaign_part(json.loads(args.campaign_part))
        Path(args.json).write_text(json.dumps(res))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    report = {}
    phase_s = report["phase_s"] = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.perf_counter() - t0
            log(f"  [phase {name}: {phase_s[name]:.1f} s, "
                f"{time.perf_counter() - t_start:.1f} s since the start]")

    log("phase 1: environment")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} x{torch.cuda.device_count()}")
    log(f"  {smi}")
    report["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvidia_smi": smi, "device": kind}

    log("phase 2: build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = phase_s["2"] = time.perf_counter() - t0
    log(f"  built {', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    report["build_s"] = build_s

    log("phase 3: kernels vs their plain versions")
    from repro_torch.models import cnn
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = cnn.resnet18(1.0)
    kernels = timed("3", lambda: [check_checksum_reduce(cfg, gen, report),
                                  check_abft_matmul(cfg, gen, report)])
    log("phase 3b: the serving path's kernels at SmolLM-360M's shapes")
    kernels += timed("3b", check_serving_kernels, gen, report)
    log("phase 3c: the kernels at Mamba2-1.3B's shapes")
    timed("3c", check_mamba_kernels, gen, report)
    log("phase 3d: the kernels at RecurrentGemma-2B's shapes")
    timed("3d", check_rg_kernels, gen, report)
    log("phase 3e: the kernels at MusicGen-large's shapes")
    timed("3e", check_musicgen_kernels, gen, report)
    log("phase 3f: the group-axis kernels at Kimi-K2's expert shapes")
    kernels += timed("3f", check_moe_kernels, gen, report)
    log("phase 3g: the kernels at Kimi-K2's plain-matmul sites")
    timed("3g", check_kimi_kernels, gen, report)
    log("phase 3h: the kernels at Yi-9B's local shapes on model 2")
    timed("3h", check_yi_shard_kernels, gen, report)
    log("phase 3i: the kernels at the ssm and rec blocks' local shapes on "
        "model 2")
    timed("3i", check_rec_shard_kernels, gen, report)
    # the mesh's ranks are processes of their own that share the card: run
    # them while this process holds little of its memory
    torch.cuda.empty_cache()
    timed("17-18", run_mesh_phase, report)

    campaign = {}
    try:
        # the campaign's host-bound trial loops start before phase 4, so
        # they have finished by the end of 7b on a fast host
        campaign.update(timed("8-start", start_campaign))
        log("phase 4: the slice")
        res, slice_ctx = timed("4-5b", run_slice, report)
        rows = {k["name"]: k for k in kernels}
        for name in ("checksum_reduce", "abft_matmul"):
            rows[name]["launches"] = res["per_layer"]["launches"][name]
            rows[name]["launches_from"] = ("phase 4: one clean per_layer "
                                           "forward")
        log("phase 6: the serving slice")
        serving, serve_ctx = timed("6-7b", run_serving, report)
        timed("8", run_campaign_phase, report, campaign)
    finally:
        stop_campaign(campaign)
    # the detect kernel's count is the deferred main path's; the serving
    # abft_matmul row's is the per_layer path's (0 launches when deferred
    # and clean)
    rows["abft_matmul_detect"]["launches"] = serving["deferred"]["launches"][
        "abft_matmul_detect"]
    rows["abft_matmul_detect"]["launches_from"] = (
        "phase 6: the deferred session's forwards")
    rows["abft_matmul/serving_bf16"]["launches"] = \
        serving["per_layer"]["launches"]
    rows["abft_matmul/serving_bf16"]["launches_from"] = (
        "phase 6: the per_layer session's forwards")
    timed("9", run_calibrated_plan, report, slice_ctx)
    del slice_ctx
    timed("10", run_driver_phase, report, serve_ctx)
    del serve_ctx
    timed("11", run_training_phase, report)
    timed("12", run_mamba_serving, report)
    timed("13", run_rg_serving, report)
    timed("14", run_musicgen_serving, report)
    moe = timed("15", run_moe_serving, report)
    timed("16", run_block_training, report)
    # the group-axis kernels' counts are the forwards with the grouped
    # entries pinned to them (force_fused_matmul leaves them on their plain
    # route, as the JAX package's does)
    rows["abft_matmul_detect/grouped"]["launches"] = \
        moe["pinned_grouped"]["grouped_detect_launches"]
    rows["abft_matmul_detect/grouped"]["launches_from"] = (
        "phase 15: a deferred prefill with the grouped entries pinned")
    rows["abft_matmul/grouped"]["launches"] = \
        moe["pinned_grouped"]["grouped_launches"]
    rows["abft_matmul/grouped"]["launches_from"] = (
        "phase 15: a per_layer prefill with the grouped entries pinned")
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phase_s.items()))
    log(f"total {report['seconds']:.1f} s")
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
        log(f"details in {out}")
    print(nvidia_smi())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
