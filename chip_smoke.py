#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moldiff_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py                 # the smoke run (one card, about 13 min)
  python3 chip_smoke.py --num-mols 192 --batch-size 128 --budget-s 700
                                        # a longer sampling phase, for the success rate
  python3 chip_smoke.py --num-mols 8 --guided-num-mols 1000 --guided-batch-size 128 \
      --budget-s 3300                   # a longer guided phase, for its success rate
  python3 chip_smoke.py --fuse-num-mols 1000 --fuse-batch-size 128 --budget-s 3300
                                        # a longer path-B phase (fuse_block), for its rate
  python3 chip_smoke.py --gate s100 [--gate-num-mols 1000 --gate-batch-size 128] --budget-s 3300
                                        # one sampling gate alone (after the build)
  python3 chip_smoke.py --train-gate demo_scratch --budget-s 1500
                                        # one training check alone (after the build)
  python3 chip_smoke.py --eval-gate demo30k
                                        # one evaluation check alone (after the build)

Phases, each asserting and none catching a failure:
  1. environment: torch and CUDA versions, the card's name and power limit,
     and whether scipy and yaml import there (printed only);
  2. build: nvcc builds the kernels of moldiff_tpu_torch/csrc;
  3. kernel checks: each forward kernel (rows 1, 2, 4, 6, 8) against its
     plain PyTorch version on the card, at flagship widths, N = 32 and 40,
     B = 16, block-0 weights of ckpts/flagship_v2.ckpt, seeded inputs and
     random masks; times by CUDA events; then all five again with the
     block-0 weights of the demo denoiser (ckpts/demo_synthetic_30k.ckpt:
     node_dim 128, edge_dim 32, the NodeBlock and EdgeBlock pair kernels'
     other instantiation, which rows 2 and 6 run too);
  4. forward check: one MolDiff.forward with the kernels against the same
     forward with the plain versions, on the card;
  5. sampling: the sample CLI's run() with the settings of
     configs/sample/sample_flagship_v2.yml (T = 1000, commit: nodes),
     decoded and classified; each launch count must equal the kernels one
     wrapper call launches (prep + pair: 2) x num_blocks x T x chains;
  6. backward kernel checks: the backward kernels against their plain
     versions on every output (each parameter gradient included), block-0
     weights of ckpts/bondpred_v2.ckpt (rows 3, 5) and of flagship_v2
     (rows 7, 9), B = 16, N = 32 and 40, seeded inputs, cotangents and
     masks, then all four again with the weights of the demo pair
     (ckpts/demo_bondpred_4k.ckpt, demo_synthetic_30k.ckpt: node_dim 128,
     edge_dim 32, the pair kernels' other instantiation); times by CUDA
     events; rows 3 and 5 also in their inputs-only
     mode (no parameter gradients, with and without d_t): its outputs
     equal the full mode's bit for bit and the plain version's within the
     tolerance, and it launches no grad.cu kernel but the time kernel;
  7. gradient check: one bond_guidance_delta (uncertainty) at B = 16 with
     the kernels against the same delta with the plain versions;
  8. guided sampling: run() with the settings of
     configs/sample/sample_flagship_v2_guided.yml but the model's bonds (as
     the JAX gate results/gate_r5_guided_modelbonds.json): flagship_v2
     steered by bondpred_v2, uncertainty guidance at 1e-4, T = 1000; each
     backward kernel's launches must equal its inputs-only launches per
     call (guidance differentiates positions alone: no grad.cu launch) x 8
     predictor blocks x T x chains, each forward kernel's those of the
     denoiser's 6 blocks plus (node_block, edge_pair) the predictor's 8;
  9. training gradient check: one get_loss + backward of flagship_v2 with
     the settings of configs/train/train_v2_cont.yml at B = 16, N = 32 with
     the kernels against the same with the plain versions; each forward
     kernel alone, the backward kernels alone, and the plain versions with
     one-ulp bumps where the forward kernels differ, read beside it;
 10. fine-tuning: the train CLI's run() with those settings from
     flagship_v2 (step 300000) at batch 128, two steps in each bucket (32
     and 40) on an in-memory corpus of v2 molecules drawn at sizes inside
     each bucket; every step's launches must equal each kernel's launches
     per call x 6 blocks; then one eval step, one scheduler step, and the
     checkpoint it wrote reloaded in the port;
 11. fine-tuning kernel checks: each of the six kernels at batch 128, N = 40
     on the arguments of its first call in one loss and backward of a
     corpus batch, against its plain version on every output (rows 3 and 5
     in both modes);
 12. path B, the whole-block kernel (row 2): flagship_v2 with
     model.denoiser.fuse_block set in memory; phase 4's forward check, then
     run() with the unguided settings, each step's launches 6 x row 2's
     per call and none of rows 1, 4, 8; row 2 at batch 128, N = 40 on a
     sampling state against its plain version; one fine-tuning step with
     fuse_block (row 2 forward; rows 1, 4, 8 recomputed and 3, 5, 9
     backward), its launches asserted and its checkpoint's config read;
 13. path A, the full-EdgeBlock kernels (rows 6, 7): phase 10 with
     model.denoiser.edge_full (no launch of rows 4, 5), the checkpoint's
     config carrying edge_full; phase 9 with edge_full; phase 11 for rows 6
     and 7 at batch 128, N = 40;
 14. grid-size invariance: the persistent pair kernels (rows 1, 4 and 8,
     and rows 2 and 6, which run them and their own persistent edge_emb
     and tail kernels) rerun with their grid capped at 1, 7 and 33 CTAs and
     at the card's own, GRID_REPEATS times each, at both widths, N = 32 and
     40, B = 16: every output equals the first run's bit for bit. Each
     node's sum is added in partner order whatever tiles its CTA takes, and
     each pair's tail is its own, so a difference is a race or a
     tile-boundary fault (no race detector runs on the card machine);
 15. the sampler's modes: run() with the unguided settings and, in turn,
     num_steps 100 (s100); num_steps 100 with pos_sampler ddim, eta 0
     (ddim_s100); commit both at T = 1000, classified by a pool of
     POOL_WORKERS spawned processes (commit_both); use_ema with
     num_steps 100 (ema_s100); save_traj_prob 1.0 with num_steps 100
     (traj_s100); each until MODE_NUM_MOLS = 8 finished at batch 16. Each
     run's launches of rows 1, 4 and 8 are launches per call x 6 blocks x S
     x chains (S = 100 or 1000), none of the others. Each run's rate over
     every molecule classified must reach its floor. A broken chain finishes
     no molecule (rate 0). With 8 finished asked for, batch 16 and the
     generate loop's stop after 3 x 8 failures, 20,000 simulated runs at
     the JAX bar's rate p give a rate below the floor this often:
       s100, traj_s100: floor 0.25, p 0.6246 (gate_r5_commit_s100): none;
       commit_both: floor 0.125, p 0.3275 (gate_r5_commit_both): 0.0018;
       ema_s100: floor 0.125, p 0.4446 (soak_v2x2_1k_ema, commit none and
         the full chain: no bar exists for this mode): none;
       ddim_s100: floor 0.125: no bar exists on flagship_v2; at commit
         both's 0.3275, 0.0018.
     The trajectory run's traj_<k>.sdf files hold S + 1 = 101 states each,
     the last with molecule k's final elements and positions (its bonds are
     the step-0 draw, which decode's argmax need not equal);
 16. the server: make_http_server on 127.0.0.1 at an ephemeral port in a
     thread, flagship_v2, num_steps 100, commit nodes, batch 16, coalescing
     window 1 s, after its warmup (a 2-step chain per bucket): GET /health
     names the card; two POST /generate with seed 7 return the same SMILES;
     one with format sdf; two concurrent unseeded requests share one pool
     (coalesced 2); launches as in phase 15 over the chains the requests
     ran; each request's latency printed;
 17. the bond predictor's training: the bond CLI's run() with the settings
     of configs/train/train_bondpred_v2.yml from ckpts/bondpred_40k.ckpt
     (step 40000, the checkpoint that config resumes) at batch 128, two
     steps in each bucket (32, 40) on phase 10's corpus; each step's
     launches rows 1, 4 and rows 3, 5 in full mode (grad.cu's kernels
     included) per call x 8 blocks, none of rows 2, 6-9; one eval step, one
     scheduler step and the checkpoint reloaded; then phase 9 (its rule and
     constants) on the predictor's loss at B = 16, N = 32;
 18. training from scratch: the train CLI's run() with the settings of
     configs/train/train_full_synthetic_xl_scratch.yml and no checkpoint
     (params drawn on the card from train.seed), batch 128, bucket 32, on
     the first 400 molecules of its synthetic_xl recipe, 3 steps with
     ckpt_freq 1, keep_ckpts 2 and the config's async checkpoints; each
     step's launches rows 1, 4, 8 and 3, 5, 9 per call x 6 blocks; exactly
     2 numeric checkpoints remain, the last equal to the final state; then
     one step with grad_accum 2 on that state, twice a step's launches;
 19. scoring: run() with the settings of configs/sample/sample_demo.yml
     (ckpts/demo_synthetic_30k.ckpt: node_dim 128, edge_dim 32, 4 blocks,
     T = 200) until 16 finished at batch 16, rows 1, 4 and 8 launched 2 x
     4 x 200 x chains times each; the eval CLI (moldiff_tpu_torch.eval,
     every family but global_3d) on its output directory, with similarity
     against the train and val splits of the first 400 molecules of the
     ./data/synthetic recipe, and on that recipe's test split; analyze on
     the two. Every output file exists, validity.json holds summary.json's
     counts; each family's empty rows and the host seconds per molecule are
     printed;
 20. the data path: the first 512 molecules of the ./data/synthetic_xl2
     recipe written as an SDF directory (sdf/, mol_summary.csv,
     split_by_molid.pkl) by a worker while the kernels build; the native
     SDF parser built from moldiff_tpu_torch/native (its time printed);
     get_dataset processes the directory into a record store, every record
     equal to the recipe's in elements and bonds and within 5e-5 in
     positions, its bytes and read rate printed; the train CLI's run() with
     the settings of configs/train/train_v2_cont.yml pointed at that
     directory, from flagship_v2 (--reset_ema, --reset_optim), 4 steps at
     batch 128 (val_freq 2, ckpt_freq 2, val_batches 1), its summary's data
     "store", each step's launches as in phase 10; log.txt,
     metrics.jsonl and the event file written and agreeing; a second run()
     resumed from the newest checkpoint for 2 steps in a new log dir; the
     test split read and sanitized from the store; flagship_v2's params
     exported to the reference .pt format, loaded and converted back with
     every leaf bit-equal, and one forward (B = 16, N = 32) through the
     kernels on them bit-equal to the forward on the original params;
 21. the model variants at flagship_v2's widths (train/settings.py: its
     training config with one override each), params from train.seed:
     MOE_V2 (an expert bank of 4, top-2, in every NodeBlock) trained 4
     steps at batch 128 on phase 10's corpus (both buckets), then with
     edge_full 4, with fuse_block 1 (off under MoE) and MOE_BONDPRED_V2 (8
     blocks) 1: each step's launches rows 4, 5, 8, 9 (edge_full: 6, 7, 8,
     9; the predictor 4, 5) per call x blocks and none of rows 1-3,
     loss_moe finite and above 0; a 100-step respaced chain of its
     checkpoint through run() at batch 16 (rows 4 and 8 only); phases 4
     and 9 on the MoE path at bf16 with flagship_v2's weights, its node MLP
     copied into every expert, the plain runs routed as the kernel run was
     (the router's argmax is discontinuous); the forward on the 4-step
     weights held to the one-ulp witness; the tokens that choose another
     expert with the kernels, the plain versions and at float32 printed;
     CONT_V2 (the continuous categorical space, scaling [1, 4, 8]) trained
     4 steps (rows 1, 3, 4, 5, 8, 9), its full 1000-step chain at batch 16
     (rows 1, 4, 8; its s/step beside phase 5's), a 100-step fuse_block
     chain (row 2), a 100-step chain guided by bondpred_v2 (rows 3, 5
     inputs-only), edge_guidance refused before any launch, phases 4 and 9
     on flagship_v2's weights and the 4-step forward held to the witness;
     UNGATED_V2: one forward and two training steps at B = 128, N = 40,
     timed, no launch of any kernel;
 22. the data axis (about 2 min), both ranks on the one card over gloo
     (NCCL refuses two ranks on one device): (a) the train CLI's run()
     with train/settings.py's TRAIN_V2_CONT_DP2 from flagship_v2, 4 steps
     at global batch 128 by 2 ranks, then the same 4 steps at world size 1
     (the same loader batches and noise): each step's loss within
     DP_LOSS_RTOL, every rank's params bit-equal after each step, each
     rank's launches per step phase 10's; the data axis's gradient (B =
     32, N = 40) against the world-1 gradient under phase 9's rules; (b)
     one step through an NCCL group of one rank, bit-equal to the plain
     world-1 step; (c) TRAIN_V2_CONT_FSDP2 through run(), 2 steps, a
     sharded checkpoint after each: its losses within DP_LOSS_RTOL of (a)'s
     and its params within DP_PARAM_MAX_FRAC of (a)'s after 2 steps; the
     directory read at W = 1 and resharded at W = 2, bit-equal; the state
     read back, saved again and read back takes a step bit-equal to it;
     (d) the sample CLI with --num_processes 2 on the one card (16
     molecules, batch 8, 100 respaced steps), --merge, the counts equal
     to the gathered global counts, the eval CLI on the merged directory.
     It prints the step seconds at world sizes 1 and 2, the collectives'
     ms a step, the checkpoint's bytes and seconds and the card's name
     and power limit;
 23. the pipe and expert axes (about 3 min), both ranks on the one card
     over gloo: (a) the train CLI's run() with TRAIN_V2_CONT_PP2 from
     flagship_v2 (its 6 blocks as 2 stages of 3, 2 microbatches of 64),
     4 steps at batch 128, then the same 4 steps at world size 1: the loss
     of step 1 within AXIS_LOSS_RTOL_1, of steps 2-4 within AXIS_LOSS_RTOL,
     each rank's launches a step phase 10's, the params after step 1 each
     leaf within 2x its one-ulp witness (world 1's step 1 recomputed from
     its gradient with one bf16 ulp of the leaf's largest element added to
     every element); (b) one PP2 step with edge_full and one with
     fuse_block against world 1's; (c) the pipeline of one stage through
     an NCCL group of one rank; (d) MOE_V2_EP2 (the expert banks over 2
     ranks) and MOE_V2_DP2 (MoE on 2 data ranks) from flagship_v2
     upcycled to MOE_V2 (every expert its node MLP, the router from
     MOE_V2's seed), 4 steps each, replaying the expert choices of
     MOE_V2's 4 steps at world size 1 (recorded first), held to them as in
     (a); the free choices that differ from the replayed ones, and the
     routing flips of their weights after each step against world 1's,
     printed. It prints the step seconds, the pipe's p2p and broadcast ms
     and the collectives' ms a step, the peak memory a rank and the card's
     name and power limit.
 24. the graph and model axes (JAX's plain route, its collectives written
     out), the ranks on the one card over gloo: the train CLI's rank body
     with TRAIN_V2_CONT_GRAPH2 (the pair tensors split by receiver over 2
     ranks) and TRAIN_V2_CONT_TP2 (the MLPs split over 2 ranks), 4 steps
     each from flagship_v2 at batch 128, and TRAIN_BONDPRED_V2 on graph 2
     one step from bondpred_40k, in one process group of 2; in one process
     group of 4 ranks, one step each at batch 32: graph 2 x model 2, MOE_V2
     on graph 2 x model 2 from flagship_v2 upcycled (as phase 23 (d)) with
     world 1's expert choices replayed, and TRAIN_BONDPRED_V2 with FSDP on
     data 2 x pipe 2 (the pipe ranks replicas, no pipeline) from
     bondpred_40k; each against the same steps at world size 1 on the
     plain route (make_mesh_2d(1, 1); the FSDP predictor against world 1
     on the kernel route): every plain-route loss within GRAPH_LOSS_RTOL,
     the FSDP predictor's under phase 23's rule, every run's params after
     step 1 within 2x the one-ulp witness, no kernel launched on any rank
     of the plain route and the predictor's per-step counts on every FSDP
     rank, the replicas' params bit-equal; the kernel route's step-1 loss
     printed beside the plain route's. It prints the seconds a step, the
     collectives' ms and bytes a step by kind, the peak memory a rank
     against world 1's, and the card's name and power limit.
 25. the host classification pool and the guidance-scale sweep: 64
     molecules of a 100-step commit-both chain of flagship_v2 (batch 64)
     classified serially and through a pool of POOL_WORKERS spawned
     processes (min(8, CPUs)), twice: the entries equal in order; the
     molecules a second both ways and the pool's start-up seconds printed
     beside the CPU count; the sweep (python -m
     moldiff_tpu_torch.sample.sweep) through its main() on flagship_v2 and
     bondpred_v2 at one scale (1e-4), 100-step guided chains at batch 16
     until 8 finished, with the pool: its JSON holds the JAX script's keys
     and its launches are phase 8's per step.
--gate NAME runs one sampling gate instead of the phases (after 1 and 2):
the settings of a committed YAML with named overrides (GATES; a CPU test
holds each equal to its YAML plus its overrides): s100, ddim_s100,
commit_both, commit_none, ema_none (use_ema, commit none), connect
(add_edge connect), eg1 (bondpred_v2's edge guidance 1.0), eg1_t300 (with
edge_guidance_tmax 300) over sample_flagship_v2.yml, and guided
(sample_flagship_v2_guided.yml as written, add_edge distance); its launches
must equal one reverse step's with the same settings x steps x chains.
--train-gate NAME runs one training check instead (after phases 1 and 2),
4000 steps from scratch on the ./data/synthetic recipe (8000 molecules,
made in memory while the kernels build): demo_scratch
(configs/train/train_demo_synthetic_30k.yml) prints its eight validation
losses beside JAX's run of the same config (results/demo30k_metrics.jsonl)
and passes when their means lie within 0.10; bondpred_demo_scratch
(configs/train/train_bondpred_demo.yml) evaluates its predictor and the
committed ckpts/demo_bondpred_4k.ckpt (JAX's step 4000 of that config) on
the whole validation split with the same noise under four seeds, and
passes when the port's loss is at most 1.10 x the committed one's and its
acc_bond at most 0.03 below. Every step of either launches the kernels of
its route, as many as the first step.
--eval-gate NAME runs one evaluation check instead (after phases 1 and 2):
demo30k samples configs/sample/sample_demo.yml as written (256 molecules,
batch 128, seed 2023), scores them with the eval CLI and holds them to the
JAX package's scores of its own such run (results/demo30k_eval, read only):
the success interval (Wilson 95 %) must overlap the bar's and each mean of
EVAL_GATE_COLUMNS lie within |z| <= 3 (Welch) of the bar's; analyze then
compares both with the whole test split of the ./data/synthetic recipe
(8000 molecules, scored by the eval CLI in a process of its own while the
kernels build) and prints their count-property JSDs side by side.
The last line is {"ok": true, "device": {...}}. A hang ends in a traceback
and a non-zero exit (faulthandler) before the budget runs out. The script
imports only torch, numpy, the standard library and moldiff_tpu_torch.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import faulthandler
import functools
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = "ckpts/flagship_v2.ckpt"
# configs/sample/sample_flagship_v2.yml (a CPU test holds the two equal)
SAMPLE_SETTINGS = {
    "model": {"checkpoint": CHECKPOINT},
    "sample": {
        "seed": 2023,
        "batch_size": 128,
        "num_mols": 1000,
        "save_traj_prob": 0.0,
        "size_mean": 24.923,
        "size_std": 5.516,
        "sanitize_mode": "reference",
        "commit": "nodes",
        "buckets": [32, 40],
    },
}
# the kernels' bf16 outputs against their plain versions: elementwise
# |kernel - plain| <= ATOL_FRAC * max|plain| + RTOL * |plain|. Both compute
# the same roundings; only float32 summation order differs, which can move
# a bf16 intermediate by one unit in the last place (2^-8 relative) and so
# the result by a few.
KERNEL_RTOL = 2e-2
KERNEL_ATOL_FRAC = 1e-2
# the whole forward (6 blocks) with kernels against it with plain versions:
# one-ulp bf16 differences grow through the blocks, so the bound is on the
# largest difference relative to the output's range. Runs on the H100 read
# at most 2.3e-3; a dropped term (a bias, the gate's time row) moves an
# output by far more.
FORWARD_MAX_FRAC = 1e-2
# configs/sample/sample_flagship_v2_guided.yml without add_edge: distance,
# i.e. the model's bonds (a CPU test holds the two equal)
BOND_PREDICTOR = "ckpts/bondpred_v2.ckpt"
# configs/sample/sample_demo_guided.yml's pair at the demo widths (node_dim
# 128, edge_dim 32): the pair kernels' second instantiation
DEMO_CHECKPOINT = "ckpts/demo_synthetic_30k.ckpt"
DEMO_BOND_PREDICTOR = "ckpts/demo_bondpred_4k.ckpt"
GUIDED_SETTINGS = {
    "model": {"checkpoint": CHECKPOINT},
    "bond_predictor": BOND_PREDICTOR,
    "sample": {
        "seed": 2023,
        "batch_size": 128,
        "num_mols": 1000,
        "save_traj_prob": 0.0,
        "size_mean": 24.923,
        "size_std": 5.516,
        "sanitize_mode": "reference",
        "commit": "nodes",
        "guidance": ["uncertainty", 1.0e-4],
        "buckets": [32, 40],
    },
}
# configs/train/train_v2_cont.yml, kept in the package so that
# profile_steps --train runs the same settings (a CPU test holds it equal
# to the YAML file); a copy of this script without the package stops in main()
try:
    from moldiff_tpu_torch.train.settings import (CONT_V2, MOE_BONDPRED_V2, MOE_V2,
                                                  TRAIN_BONDPRED_DEMO, TRAIN_BONDPRED_V2,
                                                  TRAIN_DEMO_SYNTHETIC_30K,
                                                  TRAIN_FULL_SYNTHETIC_XL_SCRATCH, UNGATED_V2)
    from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT as TRAIN_SETTINGS
except ImportError:
    TRAIN_SETTINGS = TRAIN_BONDPRED_V2 = TRAIN_BONDPRED_DEMO = None
    TRAIN_DEMO_SYNTHETIC_30K = TRAIN_FULL_SYNTHETIC_XL_SCRATCH = None
    MOE_V2 = MOE_BONDPRED_V2 = CONT_V2 = UNGATED_V2 = None
# the fine-tuning phase: steps per bucket; the in-memory corpus holds
# TRAIN_MOLS_PER_BUCKET molecules of each bucket (one batch each per epoch)
TRAIN_STEPS_PER_BUCKET = 2
TRAIN_MOLS_PER_BUCKET = 130
# the training loss and gradient (6 blocks forward and backward in bf16)
# with kernels against them with plain versions: the loss to 1e-3
# relative and the global gradient norm to 2 %. A forward kernel's bf16
# output differs from plain by one ulp at a small share of its elements
# (float32 summation order), and a gradient that sums relu- and
# LayerNorm-gated terms (a decoder's first layer) can move by a quarter of
# its scale from that. The phase measures this witness: the plain forwards
# with one ulp added at random elements, as many as the kernels differ in.
# Each leaf is held to TRAIN_LEAF_MAX_FRAC of its scale and to
# TRAIN_WITNESS_RATIO x the witness's largest leaf move, and the whole
# gradient to the JAX package's aggregate rule for its bf16 kernels: the
# mean over leaves of the kernels' error against the float32 plain
# gradient within 1.5x that of the bf16 plain gradient. The backward
# kernels alone (forward plain, so no gate flips) are held to
# TRAIN_BWD_LEAF_MAX_FRAC of every leaf's scale: a few bf16 ulps (2^-8).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_NORM_RTOL = 2e-2
TRAIN_LEAF_MAX_FRAC = 0.5
TRAIN_MEAN_ERR_RATIO = 1.5
TRAIN_WITNESS_RATIO = 2.0
TRAIN_BWD_LEAF_MAX_FRAC = 0.05
TRAIN_WITNESS_SEEDS = (0, 1, 2)
# phase 17: the bond predictor's training (configs/train/train_bondpred_v2.yml)
# from the checkpoint that config resumes, on phase 10's corpus
BOND_PREDICTOR_40K = "ckpts/bondpred_40k.ckpt"
# phase 18: training from scratch (configs/train/train_full_synthetic_xl_scratch.yml):
# its steps (a checkpoint after each, SCRATCH_KEEP kept), on the first
# SCRATCH_CORPUS_MOLS molecules of its corpus recipe (synthetic_xl, v1)
SCRATCH_STEPS = 3
SCRATCH_KEEP = 2
SCRATCH_CORPUS_MOLS = 400
# phase 20: the data path. The first STORE_CORPUS molecules of the
# synthetic_xl2 recipe (train_v2_cont.yml's corpus) written as an SDF
# directory under STORE_ROOT while the kernels build, processed into a record
# store whose positions match the recipe's within STORE_POS_ATOL (the SDF
# files round them to 4 decimals) plus one float32 spacing; STORE_STEPS training steps from it, then
# STORE_RESUME_STEPS more resumed from the newest checkpoint. At the
# generator's N(24.9, 5.5) only bucket 32 fills a batch of 128 from the
# 409 training molecules.
STORE_ROOT = os.path.join("outputs_torch", "chip_smoke", "synthetic_xl2_512")
STORE_CORPUS = ("./data/synthetic_xl2", 512)
STORE_POS_ATOL = 5e-5
STORE_STEPS = 4
STORE_RESUME_STEPS = 2
# --train-gate NAME: a training run from scratch of TRAIN_GATE_STEPS steps on
# the ./data/synthetic recipe (8000 molecules, seed 7, v1, split 80/10/10)
TRAIN_GATES = {"demo_scratch": TRAIN_DEMO_SYNTHETIC_30K,
               "bondpred_demo_scratch": TRAIN_BONDPRED_DEMO}
TRAIN_GATE_STEPS = 4000
TRAIN_GATE_CORPUS = ("./data/synthetic", 8000)
# demo_scratch: JAX's validation losses of the same config from scratch
# (results/demo30k_metrics.jsonl, "val/loss"; a CPU test holds the two
# equal); it passes when the mean of the port's at these steps lies within
# DEMO_VAL_MEAN_TOL of the mean of JAX's (1.7089)
JAX_DEMO30K_VAL = {500: 1.8426229655742645, 1000: 1.7408255636692047,
                   1500: 1.7310275733470917, 2000: 1.626937747001648,
                   2500: 1.663754940032959, 3000: 1.6986547410488129,
                   3500: 1.7342965304851532, 4000: 1.633127123117447}
DEMO_VAL_MEAN_TOL = 0.10
# bondpred_demo_scratch: the port's step-4000 predictor and the committed
# ckpts/demo_bondpred_4k.ckpt (the same config's step 4000 in JAX) on the
# whole validation split, the same noise for both under each seed; it passes
# when the port's mean loss is at most BONDPRED_LOSS_RATIO x the committed
# one's and its acc_bond at most BONDPRED_ACC_DROP below
DEMO_BONDPRED_4K = "ckpts/demo_bondpred_4k.ckpt"
BONDPRED_EVAL_SEEDS = (0, 1, 2, 3)
BONDPRED_LOSS_RATIO = 1.10
BONDPRED_ACC_DROP = 0.03
# the guidance delta (8 predictor blocks forward and backward in bf16) with
# kernels against it with plain versions: one-ulp bf16 differences grow
# through the blocks and their gradients, so the bound is on the largest
# difference relative to the delta's largest component
GRAD_MAX_FRAC = 5e-2
# rows 2, 6 and 7 round the two EdgeBlock chains' float32 endpoint sums to
# bf16 and feed them through the tail (LayerNorm, relu). Where the kernel's
# sum and the plain version's lie one bf16 ulp apart (the share that row
# 4's check shows: float32 summation order), the relu can flip at a pair
# and move that pair's outputs past compare()'s tolerance. For these
# kernels compare_witnessed() holds each output's count of elements outside
# the tolerance to SUM_WITNESS_RATIO x the largest count the plain version
# shows against itself with one ulp added to its sums at that share
# (TRAIN_WITNESS_SEEDS), and every other element to the tolerance.
SUM_WITNESS_KERNELS = ("fused_block", "edge_block_full", "edge_block_full_bwd")
SUM_WITNESS_RATIO = 2.0
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
KERNELS = {
    "node_block": ("moldiff_tpu_torch/csrc/node_block.cu",
                   "moldiff_tpu/ops/pallas_kernels.py:49"),
    "fused_block": ("moldiff_tpu_torch/csrc/fused_block.cu",
                    "moldiff_tpu/ops/pallas_kernels.py:389"),
    "edge_pair": ("moldiff_tpu_torch/csrc/edge_pair.cu",
                  "moldiff_tpu/ops/pallas_kernels.py:1062"),
    "pos_update": ("moldiff_tpu_torch/csrc/pos_update.cu",
                   "moldiff_tpu/ops/pallas_kernels.py:1891"),
    "node_block_bwd": ("moldiff_tpu_torch/csrc/node_block_bwd.cu",
                       "moldiff_tpu/ops/pallas_kernels.py:657"),
    "edge_pair_bwd": ("moldiff_tpu_torch/csrc/edge_pair_bwd.cu",
                      "moldiff_tpu/ops/pallas_kernels.py:1157"),
    "pos_update_bwd": ("moldiff_tpu_torch/csrc/pos_update_bwd.cu",
                       "moldiff_tpu/ops/pallas_kernels.py:1918"),
    "edge_block_full": ("moldiff_tpu_torch/csrc/edge_block_full.cu",
                        "moldiff_tpu/ops/pallas_kernels.py:1442"),
    "edge_block_full_bwd": ("moldiff_tpu_torch/csrc/edge_block_full.cu",
                            "moldiff_tpu/ops/pallas_kernels.py:1474"),
}
# the backward kernels with an inputs-only mode (guidance: no parameter
# gradient is read), and the grad.cu launches their full mode makes per
# call (weight gradients, time, reduction), none of which the inputs-only
# mode without d_t makes
INPUTS_ONLY_KERNELS = ("node_block_bwd", "edge_pair_bwd")
GRAD_CU_LAUNCHES = 3
# the partial path's kernels (every configuration's default)
FORWARD_KERNELS = ("node_block", "edge_pair", "pos_update")
BACKWARD_KERNELS = ("node_block_bwd", "edge_pair_bwd", "pos_update_bwd")
# the kernels each route runs in a training step (models/denoiser.py): the
# whole-block route (fuse_block) runs row 2 forward and differentiates the
# partial path's block, recomputed; the full-EdgeBlock route (edge_full)
# runs rows 6 and 7 in place of rows 4 and 5
TRAIN_ROUTES = {
    "partial": FORWARD_KERNELS + BACKWARD_KERNELS,
    "fuse_block": ("fused_block",) + FORWARD_KERNELS + BACKWARD_KERNELS,
    "edge_full": ("node_block", "edge_block_full", "pos_update", "node_block_bwd",
                  "edge_block_full_bwd", "pos_update_bwd"),
}
# path B's sampling: the checkpoint's model config with fuse_block set in
# memory, as scripts/sample_drug3d.py:161 sets remat
FUSE_SETTINGS = dict(SAMPLE_SETTINGS, model={"checkpoint": CHECKPOINT,
                                             "denoiser": {"fuse_block": True}})
LIBRARY_NOTE = ("library_ms is null: no single PyTorch call computes these fused "
                "MLP-gate-sum chains")
# phase 14: the persistent kernels (and rows 2 and 6, which run them and
# their own persistent tail and edge_emb kernels), the grid caps (0: the
# card's own) and the reruns at each
PERSISTENT_KERNELS = ("node_block", "edge_pair", "pos_update", "fused_block", "edge_block_full")
GRID_CAPS = (0, 1, 7, 33)
GRID_REPEATS = 3
# phase 21: the model variants (train/settings.py: MOE_V2, MOE_BONDPRED_V2,
# CONT_V2, UNGATED_V2) from a seed: training steps at batch 128 (fuse_block
# and the predictor one each), respaced chains of VARIANT_CHAIN_STEPS and the
# continuous model's full chain, at batch VARIANT_BATCH
VARIANT_STEPS = 4
VARIANT_CHAIN_STEPS = 100
VARIANT_BATCH = 16


def with_sample(settings: dict, top: "dict | None" = None, **sample) -> dict:
    """A copy of ``settings`` with the top-level keys ``top`` and the sample
    settings ``sample`` set."""
    out = dict(settings, **(top or {}))
    out["sample"] = dict(settings["sample"], **sample)
    return out


# host classification workers (sample/classify.py): as many as the machine
# has cores, at most the 8 of JAX's soak runs (scripts/run_r5_soaks.py:35)
POOL_WORKERS = min(8, os.cpu_count() or 1)
# phase 15: the sampler's modes through run(), each the unguided settings
# with these sample settings, MODE_NUM_MOLS finished at batch MODE_BATCH,
# and its floor on the rate over every molecule classified (the module
# docstring gives the arithmetic)
MODE_RUNS = {
    "s100": ({"num_steps": 100}, 0.25),
    "ddim_s100": ({"num_steps": 100, "pos_sampler": "ddim", "eta": 0.0}, 0.125),
    "commit_both": ({"commit": "both", "recon_workers": POOL_WORKERS}, 0.125),
    "ema_s100": ({"use_ema": True, "num_steps": 100}, 0.125),
    "traj_s100": ({"save_traj_prob": 1.0, "num_steps": 100}, 0.25),
}
MODE_NUM_MOLS = 8
MODE_BATCH = 16
# phase 16: the server (flagship_v2, 100 respaced steps, commit nodes,
# batch 16, coalescing window), the molecules per request
SERVE_BATCH = 16
SERVE_STEPS = 100
SERVE_WINDOW_MS = 1000.0
SERVE_NUM_MOLS = 4
# --gate NAME: (committed YAML, top-level overrides, sample overrides); the
# settings are the YAML's (the dicts above, which CPU tests hold equal to
# the files: the card has no PyYAML) with the overrides set
V2 = "configs/sample/sample_flagship_v2.yml"
V2_GUIDED = "configs/sample/sample_flagship_v2_guided.yml"
YAML_SETTINGS = {V2: SAMPLE_SETTINGS,
                 V2_GUIDED: with_sample(GUIDED_SETTINGS, add_edge="distance")}
GATES = {
    "s100": (V2, {}, {"num_steps": 100}),
    "ddim_s100": (V2, {}, {"num_steps": 100, "pos_sampler": "ddim", "eta": 0.0}),
    "commit_both": (V2, {}, {"commit": "both"}),
    "commit_none": (V2, {}, {"commit": "none"}),
    "ema_none": (V2, {}, {"use_ema": True, "commit": "none"}),
    "connect": (V2, {}, {"add_edge": "connect"}),
    "eg1": (V2, {"bond_predictor": BOND_PREDICTOR}, {"edge_guidance": 1.0}),
    "eg1_t300": (V2, {"bond_predictor": BOND_PREDICTOR},
                 {"edge_guidance": 1.0, "edge_guidance_tmax": 300}),
    "guided": (V2_GUIDED, {}, {}),
}


def gate_settings(name: str) -> dict:
    path, top, sample = GATES[name]
    return with_sample(YAML_SETTINGS[path], top, **sample)


# phase 19 and --eval-gate: configs/sample/sample_demo.yml (a CPU test holds
# the two equal): the demo denoiser (node_dim 128, edge_dim 32, 4 blocks,
# T = 200), unguided, the sampler's defaults otherwise
SAMPLE_DEMO = {
    "model": {"checkpoint": DEMO_CHECKPOINT},
    "sample": {"seed": 2023, "batch_size": 128, "num_mols": 256, "save_traj_prob": 0.0},
}
# phase 19: molecules finished and per chain; the corpus recipe whose test
# split (its first 400 molecules, split 80/10/10) analyze compares with
EVAL_NUM_MOLS = 16
EVAL_BATCH = 16
EVAL_CORPUS = ("./data/synthetic", 400)
# the files the eval CLI writes for generated molecules (similarity.json
# when given a dataset) and for a dataset split
EVAL_FILES = ("mols.csv", "validity.json", "local3d.pkl", "freq_ring_type.pkl")
EVAL_SPLIT_FILES = ("mols.csv", "local3d.pkl", "freq_ring_type.pkl")
# --eval-gate NAME: (settings, the JAX package's scripts/evaluate_all.py run
# on molecules it sampled with them; results/README.md). The port's run of
# the same settings passes when its success interval (Wilson 95 %) overlaps
# the bar's and each of EVAL_GATE_COLUMNS' means lies within |z| <=
# EVAL_GATE_Z of the bar's (Welch's z on the two samples); a column that is
# zero in every row on both sides must have equal means. The count-property
# JSDs of both against the whole test split of EVAL_GATE_CORPUS (8000
# molecules, made in memory) are printed side by side, not held.
EVAL_GATES = {"demo30k": (SAMPLE_DEMO, "results/demo30k_eval")}
EVAL_GATE_COLUMNS = ("qed", "sa", "logp", "lipinski", "n_atoms", "n_bonds", "n_rings",
                     "n_rotatable", "weight", "n_hacc", "n_hdon")
EVAL_GATE_Z = 3.0
EVAL_GATE_CORPUS = "./data/synthetic"
COUNT_PROPS = ("n_atoms", "n_bonds", "n_rings", "n_rotatable", "n_hacc", "n_hdon")


def say(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def work(name: str, blk: dict, b: int, n: int, inputs_only: bool = False) -> tuple:
    """(FLOPs, bytes) one call needs: every product of the chain (for a
    backward kernel: the forward recompute, the input-gradient products and
    the weight-gradient products), each input read once and each output
    written once, bf16 weights read once (float32 gradients written once).
    inputs_only (rows 3 and 5, guidance's mode): no weight-gradient product
    and no gradient written."""
    nb, eb = blk["node_block"], blk["edge_block"]
    pairs, nodes = b * n * n, b * n
    if name == "fused_block":
        de = eb["self_ffn"]["w"].shape[0]
        dh = blk["edge_emb"]["w"].shape[0] - de
        dn, h = nb["centroid_lin"]["w"].shape
        flops = (pairs * 2 * (de + dh) * de + nodes * 4 * dn * h
                 + sum(work(k, blk, b, n)[0] for k in ("node_block", "edge_block_full",
                                                        "pos_update")))
        io = (nodes * (2 * dn + 2 * dn + 12) + pairs * (2 * de + 2 * dh + 12 + 4 + 4 + 2 * de)
              + 4 * b)
        return flops, io + 2 * _numel(blk)
    if name in ("edge_block_full", "edge_block_full_bwd"):
        side = eb["bond_ffn_left"]
        de, i = side["bond_linear"]["w"].shape
        dn = side["node_linear"]["w"].shape[0]
        g = side["gate"]["layers"][0]["lin"]["w"].shape[1]
        do = eb["out"]["w"].shape[1]
        per_pair = 2 * de * i + 2 * i * i + 2 * i * do + 2 * de * g + 2 * g * do
        per_node = 2 * dn * i + 2 * dn * g
        # both chains, then the tail: self_ffn and out per pair, the node FFNs per node
        flops = (2 * (pairs * per_pair + nodes * per_node) + pairs * (2 * de * do + 2 * do * do)
                 + nodes * 4 * dn * do)
        if name == "edge_block_full":
            io = pairs * (2 * de + 4 + 2 * do) + nodes * 2 * dn + 4 * b
            return flops, io + 2 * _numel(eb)
        io = pairs * (2 * de + 4 + 2 * do + 2 * de + 4) + nodes * (2 * dn + 2 * dn) + 8 * b
        return 3 * flops, io + 6 * _numel(eb)
    if name in ("node_block", "node_block_bwd"):
        de, h = nb["edge_net"]["layers"][0]["lin"]["w"].shape
        dn = nb["node_net"]["layers"][0]["lin"]["w"].shape[0]
        weights = _numel({k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")})
        if name == "node_block":
            flops = pairs * (4 * de * h + 6 * h * h) + nodes * (4 * dn * h + 2 * h * h)
            io = pairs * (2 * de + 4) + nodes * (2 * dn + 2 * h) + 4 * b
            return flops, io + 2 * weights
        flops = pairs * (12 * de * h + 18 * h * h) + nodes * (12 * dn * h + 6 * h * h)
        io = pairs * (2 * de + 4 + 2 * de + 4) + nodes * (2 * dn + 2 * h + 2 * dn) + 8 * b
        if inputs_only:
            return 2 * flops // 3, io + 2 * weights
        return flops, io + 6 * weights
    if name in ("edge_pair", "edge_pair_bwd"):
        side = eb["bond_ffn_left"]
        de, i = side["bond_linear"]["w"].shape
        dn = side["node_linear"]["w"].shape[0]
        g = side["gate"]["layers"][0]["lin"]["w"].shape[1]
        do = side["inter"]["layers"][1]["lin"]["w"].shape[1]
        weights = _numel([eb["bond_ffn_left"], eb["bond_ffn_right"]])
        per_pair = 2 * de * i + 2 * i * i + 2 * i * do + 2 * de * g + 2 * g * do
        per_node = 2 * dn * i + 2 * dn * g
        if name == "edge_pair":
            flops = 2 * (pairs * per_pair + nodes * per_node)
            io = pairs * (2 * de + 4) + nodes * (2 * dn + 2 * 2 * do) + 4 * b
            return flops, io + 2 * weights
        flops = 2 * 3 * (pairs * per_pair + nodes * per_node)
        io = pairs * (2 * de + 4 + 2 * de + 4) + nodes * (2 * dn + 2 * 2 * do + 2 * dn) + 8 * b
        if inputs_only:
            return 2 * flops // 3, io + 2 * weights
        return flops, io + 6 * weights
    pb = blk["pos_block"]
    el = pb["edge_lin"]
    de, i = el["bond_linear"]["w"].shape
    dl = el["node_linear"]["w"].shape[0]
    dn = pb["left_lin_edge"]["layers"][0]["lin"]["w"].shape[0]
    g = el["gate"]["layers"][0]["lin"]["w"].shape[1]
    per_pair = 2 * de * i + 2 * dl * i + 2 * i * i + 2 * i + 2 * de * g + 2 * dl * g + 2 * g
    per_node = 2 * (2 * dn * dl + 2 * dl * dl)
    weights = _numel(pb)
    io = pairs * (2 * de + 12 + 4 + 4) + nodes * (2 * dn + 12) + 4 * b
    if name == "pos_update":
        return pairs * (per_pair + dl) + nodes * per_node, io + 2 * weights
    # the recompute, the input-gradient and the weight-gradient products
    flops = pairs * (3 * per_pair + dl) + nodes * 3 * per_node
    return flops, 2 * io + nodes * 2 * dn + 6 * weights


def kernel_inputs(b: int, n: int, seed: int, device, dn: int = 256, de: int = 64):
    """Seeded activations (node width dn, edge width de: flagship's by
    default) with random molecule sizes."""
    import torch

    from moldiff_tpu_torch.ops import graph_ops
    from moldiff_tpu_torch.models.nn import GaussianSmearing, safe_distance

    g = torch.Generator(device="cpu").manual_seed(seed)
    sizes = torch.randint(n // 2, n + 1, (b,), generator=g)
    node_mask = (torch.arange(n)[None, :] < sizes[:, None]).float()
    pair_mask = graph_ops.pair_mask_from_node_mask(node_mask)
    pos = torch.randn((b, n, 3), generator=g) * 3.0
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    x = torch.randn((b, n, dn), generator=g).to(torch.bfloat16)
    e = torch.randn((b, n, n, de), generator=g).to(torch.bfloat16)
    t = torch.rand((b, 1, 1), generator=g)
    dist = safe_distance(rel)
    # flagship_v2's distance features: 16 Gaussians up to its cutoff of 15
    hd = GaussianSmearing(stop=15.0, num_gaussians=16)(dist).to(torch.bfloat16)
    return {k: v.to(device).contiguous() for k, v in dict(
        x=x, e=e, t=t, pair_mask=pair_mask, rel=rel, dist=dist, hd=hd).items()}


def kernel_calls(blk: dict, inp: dict) -> dict:
    """name -> the arguments of one call of each forward kernel, all on the
    same inputs."""
    nb, eb, pb = blk["node_block"], blk["edge_block"], blk["pos_block"]
    nb_p = {k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")}
    eb_p = {"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]}
    x, e, t, m = inp["x"], inp["e"], inp["t"], inp["pair_mask"]
    return {"node_block": (nb_p, x, e, t, m), "edge_pair": (eb_p, e, x, t, m),
            "pos_update": (pb, x, e, inp["rel"], inp["dist"], t, m),
            "fused_block": (blk, x, e, inp["hd"], inp["rel"], inp["dist"], t, m),
            "edge_block_full": (eb, e, x, t, m)}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def outside(name: str, got, want) -> dict:
    """path -> (elements outside the kernels' tolerance, largest |got - want|)
    over every leaf of two output trees."""
    import torch

    out = {}
    for (path, a), (_, w) in zip(_leaves(got), _leaves(want)):
        a, w = a.float(), w.float()
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), f"{name}{path}"
        tol = KERNEL_ATOL_FRAC * w.abs().max() + KERNEL_RTOL * w.abs()
        out[path] = (int(((a - w).abs() > tol).sum()), float((a - w).abs().max()))
    return out


def compare(name: str, got, want) -> float:
    """Every leaf of a kernel's outputs against its plain version's, with
    the kernels' tolerance; returns the largest |kernel - plain|."""
    err = 0.0
    for path, (bad, e) in outside(name, got, want).items():
        assert bad == 0, f"{name}{path}: {bad} elements outside the tolerance"
        err = max(err, e)
    return err


def _int_view(x):
    import torch

    return x.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[x.dtype])


def bump_ulp(w, share: float, gen):
    """w with one ulp added (a random sign) at a random share of its nonzero
    elements."""
    import torch

    pick = (torch.rand(w.shape, generator=gen, device=w.device) < share) & (w != 0)
    sign = torch.where(torch.rand(w.shape, generator=gen, device=w.device) < 0.5, -1, 1)
    bumped = (_int_view(w) + sign.to(_int_view(w).dtype)).view(w.dtype)
    return torch.where(pick, bumped, w)


def sum_inputs(name: str, args: tuple) -> tuple:
    """(EdgeBlock params, h_bond, h_node, time, pair mask) of a row-2, 6 or
    7 call: its chains' inputs (row 2's embedded edges stand in by its input
    edges)."""
    if name == "fused_block":
        blk, x, e, _, _, _, t, m = args
        return blk["edge_block"], e, x, t, m
    return args[:5]


def compare_witnessed(name: str, got, want, plain, args: tuple) -> float:
    """compare() for SUM_WITNESS_KERNELS (see SUM_WITNESS_RATIO): ``plain``
    recomputes the plain version, ``args`` are the call's arguments."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    eb, e, x, t, m = sum_inputs(name.split()[0], args)
    chains = {"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]}
    share = max(float((a != w).sum()) / max(int((w != 0).sum()), 1) for a, w in zip(
        K.edge_pair_aggregate(chains, e, x, t, m),
        K.edge_pair_aggregate_plain(chains, e, x, t, m)))
    kernel = outside(name, got, want)
    sums, witness = K._edge_sums, []
    for seed in TRAIN_WITNESS_SEEDS:
        gen = torch.Generator(device=e.device).manual_seed(seed)
        K._edge_sums = lambda *a: tuple(bump_ulp(o, share, gen) for o in sums(*a))
        try:
            witness.append(outside(f"{name} witness", plain(), want))
        finally:
            K._edge_sums = sums
    err = 0.0
    for path, (bad, e_max) in kernel.items():
        most = max(w[path][0] for w in witness)
        if bad or most:
            say(f"  {name}{path}: {bad} elements outside the tolerance; the one-ulp witness "
                f"(sums bumped at a share of {share:.3g}): at most {most}")
        assert bad <= SUM_WITNESS_RATIO * most, (f"{name}{path}: {bad} elements outside the "
                                                 f"tolerance > {SUM_WITNESS_RATIO} x {most}")
        err = max(err, e_max)
    return err


def check_call(name: str, args: tuple, wblk: dict, results: dict, what: str,
               keep: bool = False, iters: int = 20, plain_iters: int = 5) -> None:
    """One kernel call against its plain version on the same arguments
    (compare(), or compare_witnessed() for SUM_WITNESS_KERNELS), both timed
    by CUDA events beside the bound; records its launches per call and,
    with ``keep``, its times in ``results``."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    kern_fn = getattr(K, KERNEL_FUNCTIONS[name])
    plain_fn = getattr(K, KERNEL_FUNCTIONS[name] + "_plain")
    kern, plain = (lambda: kern_fn(*args)), (lambda: plain_fn(*args))
    with torch.no_grad():
        before = K.launch_counts[name]
        got = kern()
        per_call = K.launch_counts[name] - before
        torch.cuda.synchronize()
        want = plain()
        err = (compare_witnessed(f"{name} {what}", got, want, plain, args)
               if name in SUM_WITNESS_KERNELS else compare(f"{name} {what}", got, want))
        ms = median_ms(kern, warmup=2, iters=iters)
        plain_ms = median_ms(plain, warmup=1, iters=plain_iters)
    b, n = args[1].shape[:2]
    flops, nbytes = work(name, wblk, b, n)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    say(f"kernel {name} {what}: max_abs_err {err:.6g} ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"bound_ms {max(t_ops, t_bytes):.5f} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) "
        f"launches/call {per_call}")
    r = results.setdefault(name, {"max_abs_err": 0.0, "per_call": per_call})
    assert per_call == r["per_call"] > 0, f"{name}: {per_call} launches per call"
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if keep:
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")


def check_kernels(blk: dict, demo_blk: dict, device) -> dict:
    """Phase 3: each forward kernel at B = 16, N = 32 and 40, at flagship
    widths (``blk``; the N = 32 times, the sampling phase's shape, kept),
    then at the demo denoiser's (``demo_blk``)."""
    results = {}
    for tag, wblk, keep in (("", blk, True), (", demo widths", demo_blk, False)):
        nb = wblk["node_block"]
        dn, de = nb["node_net"]["layers"][0]["lin"]["w"].shape[0], wblk["edge_emb"]["w"].shape[1]
        for n in (32, 40):
            inp = kernel_inputs(16, n, seed=n, device=device, dn=dn, de=de)
            for name, args in kernel_calls(wblk, inp).items():
                check_call(name, args, wblk, results, f"B=16 N={n}{tag}", keep=keep and n == 32)
    return results


def check_grid_invariance(blk: dict, demo_blk: dict, device) -> None:
    """Phase 14: the persistent kernels' outputs at each grid cap of
    GRID_CAPS, GRID_REPEATS times, against their first run at the card's own
    grid, bit for bit; both widths, N = 32 and 40, B = 16."""
    import torch

    from moldiff_tpu_torch.ops import build
    from moldiff_tpu_torch.ops import kernels as K

    lib = build.library()
    runs = 0
    try:
        for tag, wblk in (("", blk), (", demo widths", demo_blk)):
            nb = wblk["node_block"]
            dn = nb["node_net"]["layers"][0]["lin"]["w"].shape[0]
            de = wblk["edge_emb"]["w"].shape[1]
            for n in (32, 40):
                calls = kernel_calls(wblk, kernel_inputs(16, n, seed=300 + n, device=device,
                                                         dn=dn, de=de))
                first = {}
                with torch.no_grad():
                    for cap in GRID_CAPS:
                        build.check(lib, lib.md_set_persistent_slots(cap), "grid cap")
                        for _ in range(GRID_REPEATS):
                            for name in PERSISTENT_KERNELS:
                                out = _outputs(getattr(K, KERNEL_FUNCTIONS[name])(*calls[name]))
                                torch.cuda.synchronize()
                                want = first.setdefault(name, out)
                                for k, (a, w) in enumerate(zip(out, want)):
                                    assert torch.equal(a, w), (
                                        f"{name} B=16 N={n}{tag}: output {k} at a grid of "
                                        f"{cap or 'the card'} CTAs differs from the first run")
                                runs += 1
    finally:
        build.check(lib, lib.md_set_persistent_slots(0), "grid cap")
    say(f"grid-size invariance: {', '.join(PERSISTENT_KERNELS)} at grid caps {GRID_CAPS} "
        f"(0: the card's own) x {GRID_REPEATS}, both widths, N = 32 and 40, B = 16: {runs} "
        "runs, every output bit-equal to the first")


def forward_inputs(model, device, b: int = 16, n: int = 32) -> tuple:
    """Seeded arguments of MolDiff.forward after the params: a noised state
    of b molecules of 12..n atoms at t = 500, and its node mask."""
    import torch

    g = torch.Generator(device=device).manual_seed(7)
    node_mask = (torch.arange(n, device=device)[None, :]
                 < torch.randint(12, n + 1, (b, 1), generator=g, device=device)).float()
    state = model.init_state(node_mask, model.draw_noise(b, n, g))
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    return state.h_node, state.pos, state.h_halfedge, t, node_mask


def check_forward(model, params, device) -> None:
    """MolDiff.forward at flagship width, kernels against plain versions
    (every forward kernel's wrapper replaced by its plain version)."""
    import torch

    blocks = model.prepare(params)
    args = (params,) + forward_inputs(model, device)
    got = model.forward(*args, blocks=blocks)
    with plain_versions():
        want = model.forward(*args, blocks=blocks)
    torch.cuda.synchronize()
    for name, a, w in zip(got._fields, got, want):
        assert bool(torch.isfinite(a).all()), name
        frac = float((a - w).abs().max() / w.abs().max())
        say(f"forward {name} {tuple(a.shape)}: max |kernels - plain| / max |plain| = {frac:.3g}")
        assert frac <= FORWARD_MAX_FRAC, f"forward {name}: {frac} > {FORWARD_MAX_FRAC}"


def backward_calls(blk: dict, b: int, n: int, seed: int, device) -> dict:
    """name -> the arguments of one call of each backward kernel on seeded
    inputs, cotangents and masks: rows 3 and 5 at ``blk``'s widths."""
    import torch

    nb, eb = blk["node_block"], blk["edge_block"]
    inp = kernel_inputs(b, n, seed, device, dn=nb["node_net"]["layers"][0]["lin"]["w"].shape[0],
                        de=nb["edge_net"]["layers"][0]["lin"]["w"].shape[0])
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    nb_p = {k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")}
    eb_p = {"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]}
    h = nb["msg_net"]["w"].shape[1]
    do = eb["bond_ffn_left"]["inter"]["layers"][1]["lin"]["w"].shape[1]
    dout = torch.randn((b, n, h), generator=g).to(torch.bfloat16).to(device)
    dt_ct = torch.randn((b, n, do), generator=g).to(torch.bfloat16).to(device)
    du_ct = torch.randn((b, n, do), generator=g).to(torch.bfloat16).to(device)
    x, e, t, m = inp["x"], inp["e"], inp["t"], inp["pair_mask"]
    return {"node_block_bwd": (nb_p, x, e, t, m, dout),
            "edge_pair_bwd": (eb_p, e, x, t, m, dt_ct, du_ct)}


def pos_backward_calls(blk: dict, b: int, n: int, seed: int, device) -> dict:
    """The arguments of pos_update_bwd and edge_block_full_bwd calls (rows
    9 and 7) on seeded inputs, cotangents and masks at the denoiser's
    widths."""
    import torch

    side = blk["edge_block"]["bond_ffn_left"]
    inp = kernel_inputs(b, n, seed, device, dn=side["node_linear"]["w"].shape[0],
                        de=side["bond_linear"]["w"].shape[0])
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    ct = torch.randn((b, n, 3), generator=g).to(device)
    ct_e = torch.randn(tuple(inp["e"].shape), generator=g).to(torch.bfloat16).to(device)
    return {"pos_update_bwd": (blk["pos_block"], inp["x"], inp["e"], inp["rel"], inp["dist"],
                               inp["t"], inp["pair_mask"], ct),
            "edge_block_full_bwd": (blk["edge_block"], inp["e"], inp["x"], inp["t"],
                                    inp["pair_mask"], ct_e)}


def check_modes(name: str, args: tuple, wblk: dict, results: dict, what: str,
                keep: bool = False, iters: int = 20) -> None:
    """Row 3 or 5 in its inputs-only mode (need_params=False; with and
    without need_time) on the arguments of a full-mode check: every output
    it forms must equal the full mode's bit for bit (the same arithmetic
    makes it) and the plain version's under compare(), and it launches no
    grad.cu kernel but the time kernel when d_t is asked for. Records the
    launches per call of guidance's mode (no d_t) and, with ``keep``, its
    time beside its bound."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    kern_fn = getattr(K, KERNEL_FUNCTIONS[name])
    plain_fn = getattr(K, KERNEL_FUNCTIONS[name] + "_plain")
    full_calls = results[name]["per_call"]
    with torch.no_grad():
        full = kern_fn(*args)
        want = plain_fn(*args)
        for need_time in (True, False):
            before = K.launch_counts[name]
            got = kern_fn(*args, need_params=False, need_time=need_time)
            per_call = K.launch_counts[name] - before
            torch.cuda.synchronize()
            assert got[0] is None and (got[3] is None) != need_time, name
            for k, (g, f, w) in enumerate(zip(got, full, want)):
                if g is None:
                    continue
                assert torch.equal(g, f), (f"{name} {what}: inputs-only output {k} differs "
                                           "from the full mode's")
                compare(f"{name} {what} inputs-only output {k}", g, w)
            # the full mode's grad.cu launches: weight gradients, time, reduction
            assert per_call == full_calls - (2 if need_time else GRAD_CU_LAUNCHES), (
                name, need_time, per_call, full_calls)
        ms = median_ms(lambda: kern_fn(*args, need_params=False, need_time=False), warmup=2,
                       iters=iters)
    b, n = args[1].shape[:2]
    flops, nbytes = work(name, wblk, b, n, inputs_only=True)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    say(f"kernel {name} {what} inputs-only (bit-equal to the full mode): ms {ms:.4f} bound_ms "
        f"{bound:.5f} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) launches/call "
        f"{per_call} (with d_t: {per_call + 1}; grad.cu: 0)")
    r = results[name]
    assert r.setdefault("per_call_guided", per_call) == per_call
    if keep:
        r.update(inputs_ms=ms, inputs_bound_ms=bound)


def check_backward(blk: dict, pos_blk: dict, demo: tuple, device) -> dict:
    """Phase 6: each backward kernel against its plain version on every
    output, B = 16, N = 32 and 40; times at both, the N = 32 ones kept.
    Rows 3 and 5 in both modes (check_modes).
    NodeBlock and EdgeBlock at the predictor's widths (``blk``), PosUpdate
    and the full EdgeBlock at the denoiser's (``pos_blk``); then all four
    again at the demo widths (``demo``: the blocks of that pair), the
    pair kernels' other instantiation."""
    results = {}
    for tag, (b_blk, p_blk), keep in (("", (blk, pos_blk), True),
                                      (", demo widths", demo, False)):
        for n in (32, 40):
            calls = [(name, args, b_blk) for name, args in backward_calls(
                b_blk, 16, n, seed=100 + n, device=device).items()]
            calls += [(name, args, p_blk) for name, args in pos_backward_calls(
                p_blk, 16, n, seed=200 + n, device=device).items()]
            what = f"B=16 N={n}{tag}"
            for name, args, wblk in calls:
                check_call(name, args, wblk, results, what, keep=keep and n == 32,
                           plain_iters=3)
                if name in INPUTS_ONLY_KERNELS:
                    check_modes(name, args, wblk, results, what, keep=keep and n == 32)
    return results


def check_gradient(model, bp, bp_params, device) -> None:
    """Phase 7: the guidance delta (uncertainty, B = 16, N = 32, t = 500)
    with the kernels against it with the plain versions, on the card."""
    import torch

    from moldiff_tpu_torch.models.moldiff import bond_guidance_delta
    from moldiff_tpu_torch.ops import kernels as K

    b, n = 16, 32
    g = torch.Generator(device=device).manual_seed(11)
    node_mask = (torch.arange(n, device=device)[None, :]
                 < torch.randint(12, n + 1, (b, 1), generator=g, device=device)).float()
    state = model.init_state(node_mask, model.draw_noise(b, n, g))
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    e = n * (n - 1) // 2
    he_prev = torch.randint(0, model.num_edge_types, (b, e), generator=g, device=device)
    log_he = torch.log_softmax(torch.randn((b, e, model.num_edge_types), generator=g,
                                           device=device), dim=-1)
    h_node = state.h_node[..., :bp.num_node_types]
    args = ((bp, bp_params, bp.prepare(bp_params)), "uncertainty", 1.0, h_node, state.pos, t,
            node_mask, he_prev, log_he)
    got = bond_guidance_delta(*args)
    names = ("node_block_aggregate", "edge_pair_aggregate", "node_block_aggregate_bwd",
             "edge_pair_aggregate_bwd")
    saved = {k: getattr(K, k) for k in names}
    for k in names:
        setattr(K, k, getattr(K, k + "_plain"))
    try:
        want = bond_guidance_delta(*args)
    finally:
        for k, fn in saved.items():
            setattr(K, k, fn)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0
    frac = float((got - want).abs().max() / want.abs().max())
    say(f"gradient: guidance delta {tuple(got.shape)}: max |kernels - plain| / max |plain| "
        f"= {frac:.3g}")
    assert frac <= GRAD_MAX_FRAC, f"guidance delta: {frac} > {GRAD_MAX_FRAC}"


def _corpus_chunk(args: tuple) -> list:
    from moldiff_tpu_torch.data.dataset import generate_records

    seed, sizes = args
    return generate_records(len(sizes), seed, "v2", n_atoms=sizes)


def start_corpus(pool, seed: int = 2026):
    """Phase 10's corpus, made in worker processes while the kernels build:
    TRAIN_MOLS_PER_BUCKET v2 molecules at sizes drawn in 20..32 and as many
    in 33..38 (the largest size the v2 generator draws), so that each
    bucket fills one batch of 128 per epoch. A corpus of the configuration's
    size distribution would need about 3,000 molecules for as many batches
    of the larger bucket."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.integers(20, 33, TRAIN_MOLS_PER_BUCKET),
                            rng.integers(33, 39, TRAIN_MOLS_PER_BUCKET)])
    rng.shuffle(sizes)
    chunks = np.array_split(sizes, 8)
    return [pool.submit(_corpus_chunk, (seed + k, list(map(int, c))))
            for k, c in enumerate(chunks)]


def collect_corpus(futures) -> dict:
    recs = [r for f in futures for r in f.result(timeout=300)]
    for k, r in enumerate(recs):
        r["molid"] = f"smoke{k:05d}"
    return {"train": recs, "val": recs[:16], "test": []}


def featurizer(settings: dict):
    from moldiff_tpu_torch.data.featurize import featurizer_from_config
    from moldiff_tpu_torch.utils.config import Config

    return featurizer_from_config(Config(settings))


def train_model(settings: dict, device, dtype: "str | None" = None):
    """The model of a training configuration (MolDiff or BondPredictor),
    its compute dtype set to ``dtype`` when given."""
    import copy

    from moldiff_tpu_torch.models.bond_predictor import BondPredictor
    from moldiff_tpu_torch.models.moldiff import MolDiff

    cfg = copy.deepcopy(settings["model"])
    if dtype is not None:
        net(cfg)["dtype"] = dtype
    feat = featurizer(settings)
    cls = BondPredictor if cfg.get("name") == "bond_predictor" else MolDiff
    return cls(cfg, feat.num_node_types, feat.num_edge_types, device=device)


def net(model_cfg: dict) -> dict:
    """The NodeEdgeNet section of a model config: the denoiser's or the bond
    predictor's encoder."""
    return model_cfg["encoder" if model_cfg.get("name") == "bond_predictor" else "denoiser"]


def train_batch(records: list, b: int, n: int, device, settings: "dict | None" = None) -> dict:
    """The first b records of at most n atoms as one padded batch on the
    card, featurized as ``settings`` (by default TRAIN_SETTINGS) say."""
    import numpy as np

    from moldiff_tpu_torch.data.batching import pad_mols
    from moldiff_tpu_torch.data.loader import featurize_record
    from moldiff_tpu_torch.train.trainer import batch_to_device

    feat = featurizer(settings or TRAIN_SETTINGS)
    rng = np.random.default_rng(0)
    mols = [featurize_record(r, feat, rng) for r in records if len(r["element"]) <= n][:b]
    assert len(mols) == b
    return batch_to_device(pad_mols(mols, n_max=n), device)


FORWARD_FUNCTIONS = {"node_block": "node_block_aggregate", "edge_pair": "edge_pair_aggregate",
                     "pos_update": "pos_update", "fused_block": "fused_block",
                     "edge_block_full": "edge_block_full"}
KERNEL_FUNCTIONS = dict(FORWARD_FUNCTIONS, node_block_bwd="node_block_aggregate_bwd",
                        edge_pair_bwd="edge_pair_aggregate_bwd", pos_update_bwd="pos_update_bwd",
                        edge_block_full_bwd="edge_block_full_bwd")


def with_denoiser(settings: dict, **flags) -> dict:
    """A copy of a configuration with ``flags`` set on model.denoiser."""
    import copy

    out = copy.deepcopy(settings)
    out["model"]["denoiser"].update(flags)
    return out


def route(settings: dict) -> str:
    """The route a configuration's blocks take (models/denoiser.py):
    fuse_block is off under MoE and without gates."""
    den = net(settings["model"])
    fuse = den.get("fuse_block") and den.get("use_gate", True) and not den.get("moe")
    return "fuse_block" if fuse else "edge_full" if den.get("edge_full") else "partial"


def train_kernels(settings: dict) -> tuple:
    """The kernels a training step of ``settings`` runs: its route's, less
    PosUpdate's without ``update_pos`` (the bond predictor), less the
    NodeBlock's under MoE (the NodeBlock runs JAX's plain path there), and
    none without gates."""
    den = net(settings["model"])
    if not den.get("use_gate", True):
        return ()
    runs = TRAIN_ROUTES[route(settings)]
    if not den.get("update_pos", True):
        runs = tuple(k for k in runs if not k.startswith("pos_update"))
    if den.get("moe"):
        runs = tuple(k for k in runs if not k.startswith("node_block"))
    return runs


def train_launches(settings: dict, results: dict) -> dict:
    """Each kernel's launches in one training step of ``settings``: its
    launches per call x the blocks, for the kernels it runs, else 0."""
    blocks = net(settings["model"])["num_blocks"]
    runs = train_kernels(settings)
    return {name: results[name]["per_call"] * blocks if name in runs else 0 for name in KERNELS}


def _outputs(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def ulp_witness(kern, plain, gen, shares: list):
    """A forward function that returns the plain version's outputs with one
    ulp added (a random sign) at a random share of their nonzero elements:
    the share where ``kern`` differs from ``plain`` on the same inputs.
    Appends (that share, the part of those elements one ulp apart, the
    largest difference over the output's largest value) to ``shares``."""
    def call(*args):
        got, want = _outputs(kern(*args)), _outputs(plain(*args))
        out = []
        for a, w in zip(got, want):
            nz = w != 0
            differ = int((a != w).sum())
            one_ulp = ((_int_view(a).int() - _int_view(w).int()).abs() == 1) & (
                a.sign() == w.sign()) & nz
            shares.append((differ / max(int(nz.sum()), 1), int(one_ulp.sum()) / max(differ, 1),
                           float((a - w).abs().max() / w.abs().max())))
            out.append(bump_ulp(w, shares[-1][0], gen))
        return tuple(out) if len(out) > 1 else out[0]

    return call


def check_train_gradient(params, records: list, device, settings: dict, b: int = 16,
                         n: int = 32) -> dict:
    """Phase 9: the training loss and every parameter gradient of
    ``params`` (flagship_v2's; phase 17: bondpred_40k's) with ``settings``
    at B = b, N = n, kernels against plain versions, both bf16, with the
    plain versions at float32 as the ground truth; each forward kernel of
    the route alone, its backward kernels alone, and the one-ulp witness
    against plain."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K
    from moldiff_tpu_torch.train.optim import global_norm, tree_leaves, tree_unflatten

    def tree_map_paths(tree, path=""):
        if isinstance(tree, dict):
            return {k: tree_map_paths(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [tree_map_paths(v, f"{path}/{k}") for k, v in enumerate(tree)]
        return path

    model = train_model(settings, device)
    model32 = train_model(settings, device, dtype="float32")
    batch = train_batch(records, b, n, device, settings)
    noise = model.draw_loss_noise(b, n, torch.Generator(device=device).manual_seed(9))
    kern = {name: getattr(K, fn) for name, fn in KERNEL_FUNCTIONS.items()}
    plain = {name: getattr(K, fn + "_plain") for name, fn in KERNEL_FUNCTIONS.items()}

    def loss_and_grads(m, use: dict):
        """use: kernel name -> the function its wrapper's name stands for."""
        for name, fn in KERNEL_FUNCTIONS.items():
            setattr(K, fn, use[name])
        try:
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            loss, _ = m.get_loss(tree_unflatten(params, leaves), batch["node_type"],
                                 batch["pos"], batch["halfedge_type"], batch["node_mask"], noise)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for name, fn in KERNEL_FUNCTIONS.items():
                setattr(K, fn, kern[name])
        return float(loss.detach()), grads

    runs = train_kernels(settings)
    fwd_kernels = [k for k in runs if not k.endswith("_bwd")]
    bwd_kernels = [k for k in runs if k.endswith("_bwd")]
    before = dict(K.launch_counts)
    loss_k, grads_k = loss_and_grads(model, kern)
    launched = {k: K.launch_counts[k] - before[k] for k in before}
    loss_p, grads_p = loss_and_grads(model, plain)
    loss_t, grads_t = loss_and_grads(model32, plain)
    _, grads_b = loss_and_grads(model, dict(plain, **{k: kern[k] for k in bwd_kernels}))
    alone = {name: loss_and_grads(model, dict(plain, **{name: kern[name]}))[1]
             for name in fwd_kernels}
    witness, shares = [], {name: [] for name in fwd_kernels}
    for seed in TRAIN_WITNESS_SEEDS:
        gen = torch.Generator(device=device).manual_seed(seed)
        bumped = {name: ulp_witness(kern[name], plain[name], gen, shares[name])
                  for name in fwd_kernels}
        witness.append(loss_and_grads(model, dict(plain, **bumped))[1])
    torch.cuda.synchronize()
    assert {k for k, v in launched.items() if v > 0} == set(runs), launched

    paths = tree_leaves(tree_map_paths(params))
    scale = lambda x: float(x.abs().max().clamp(min=1e-30))
    frac = lambda grads: [float((a - w).abs().max()) / scale(w) for a, w in zip(grads, grads_p)]
    worst = lambda fr: max(zip(fr, paths))
    differ, bwd = frac(grads_k), frac(grads_b)
    for path, a in zip(paths, grads_k):
        assert bool(torch.isfinite(a).all()), path
    err_k = [float((a - t).abs().max()) / scale(t) for a, t in zip(grads_k, grads_t)]
    err_p = [float((w - t).abs().max()) / scale(t) for w, t in zip(grads_p, grads_t)]
    norm_k, norm_p = float(global_norm(list(grads_k))), float(global_norm(list(grads_p)))
    mean_k, mean_p = statistics.mean(err_k), statistics.mean(err_p)
    top = worst(differ)
    at_top = lambda fr: fr[paths.index(top[1])]
    say(f"train gradient ({settings['model']['name']}, {route(settings)}) B={b} N={n}: loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} float32 "
        f"{loss_t:.6f}; grad norm kernels {norm_k:.6f} plain {norm_p:.6f}; mean error against "
        f"float32: kernels {mean_k:.4g}, plain {mean_p:.4g}; launches {launched}")
    say(f"  |kernels - plain| / scale over {len(differ)} leaves: median "
        f"{statistics.median(differ):.3g}, largest {top[0]:.3g} ({top[1]})")
    for name, grads in alone.items():
        fr = frac(grads)
        say(f"  the {name} forward kernel alone: median {statistics.median(fr):.3g}, largest "
            f"{worst(fr)[0]:.3g} ({worst(fr)[1]}), on {top[1]} {at_top(fr):.3g}")
    for name, sh in shares.items():
        say(f"  {name}: the kernel differs from plain at a share of at most "
            f"{max(s[0] for s in sh):.3g} of an output's nonzero elements, at least "
            f"{min(s[1] for s in sh):.3g} of them by one ulp, by at most {max(s[2] for s in sh):.3g} "
            f"of the output's largest value")
    for seed, grads in zip(TRAIN_WITNESS_SEEDS, witness):
        fr = frac(grads)
        say(f"  one-ulp witness, seed {seed}: median {statistics.median(fr):.3g}, largest "
            f"{worst(fr)[0]:.3g} ({worst(fr)[1]}), on {top[1]} {at_top(fr):.3g}")
    pos_bwd = max(((f, p) for f, p in zip(bwd, paths) if "/pos_block/" in p), default=None)
    say(f"  the backward kernels alone: median {statistics.median(bwd):.3g}, largest "
        f"{worst(bwd)[0]:.3g} ({worst(bwd)[1]})" + (
            f", largest pos_block leaf {pos_bwd[0]:.3g} ({pos_bwd[1]})" if pos_bwd else ""))
    assert abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p), (loss_k, loss_p)
    assert abs(norm_k - norm_p) <= TRAIN_NORM_RTOL * norm_p, (norm_k, norm_p)
    assert top[0] <= TRAIN_LEAF_MAX_FRAC, top
    # the kernels move no leaf further than TRAIN_WITNESS_RATIO x the
    # witness's largest move in this run: their differences are its kind
    assert top[0] <= TRAIN_WITNESS_RATIO * max(worst(frac(g))[0] for g in witness), top
    assert mean_k <= TRAIN_MEAN_ERR_RATIO * mean_p, (mean_k, mean_p)
    assert worst(bwd)[0] <= TRAIN_BWD_LEAF_MAX_FRAC, worst(bwd)
    return {"loss": [loss_k, loss_p, loss_t], "grad_norm": [norm_k, norm_p],
            "leaf_max_frac": top[0], "mean_err": [mean_k, mean_p], "bwd_max": worst(bwd)[0],
            "witness_max": [worst(frac(g))[0] for g in witness]}


def check_train_kernels(params, records: list, results: dict, device, settings: dict,
                        names: tuple) -> None:
    """Phase 11: the kernels ``names`` of the route of ``settings`` at the
    fine-tuning shape (batch 128, the larger bucket) on a batch of the
    fine-tune corpus: the arguments of each one's first call in one
    get_loss + backward through the kernels, replayed through the kernel
    and its plain version and compared with compare(); times by CUDA
    events."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K
    from moldiff_tpu_torch.train.optim import tree_leaves, tree_unflatten

    b, n = settings["train"]["batch_size"], max(settings["train"]["buckets"])
    model = train_model(settings, device)
    batch = train_batch(records, b, n, device, settings)
    noise = model.draw_loss_noise(b, n, torch.Generator(device=device).manual_seed(5))
    kern = {name: getattr(K, fn) for name, fn in KERNEL_FUNCTIONS.items()}
    captured = {}

    def recorder(name):
        def call(*args, **flags):
            captured.setdefault(name, args)
            return kern[name](*args, **flags)
        return call

    for name, fn in KERNEL_FUNCTIONS.items():
        setattr(K, fn, recorder(name))
    try:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.get_loss(tree_unflatten(params, leaves), batch["node_type"], batch["pos"],
                                 batch["halfedge_type"], batch["node_mask"], noise)
        torch.autograd.grad(loss, leaves)
    finally:
        for name, fn in KERNEL_FUNCTIONS.items():
            setattr(K, fn, kern[name])
    blk0 = model.prepare(params)[0]
    assert sorted(captured) == sorted(TRAIN_ROUTES[route(settings)]), sorted(captured)
    for name in names:
        what = f"B={b} N={n} (a corpus batch, denoiser widths)"
        check_call(name, captured[name], blk0, results, what, iters=10, plain_iters=3)
        if name in INPUTS_ONLY_KERNELS:
            check_modes(name, captured[name], blk0, results, what, iters=10)


def check_step_terms(step: dict, settings: dict) -> None:
    """Every loss term, accuracy and the gradient norm that a training step
    of ``settings``' model reports is in the step record and finite: loss,
    loss_pos, loss_node, loss_edge, loss_len and grad_norm for MolDiff;
    loss, loss_edge, acc_bond and grad_norm for the bond predictor."""
    names = ("loss", "loss_pos", "loss_node", "loss_edge", "loss_len", "grad_norm")
    if settings["model"]["name"] == "bond_predictor":
        names = ("loss", "loss_edge", "acc_bond", "grad_norm")
    assert all(math.isfinite(step[k]) for k in names), step


def fine_tune(corpus: dict, results: dict, device, settings: dict,
              steps_per_bucket: int = TRAIN_STEPS_PER_BUCKET,
              checkpoint: str = CHECKPOINT) -> tuple:
    """Phase 10 (and 17): the train CLI's run() with ``settings`` from
    flagship_v2 (--reset_ema, --reset_optim), or the bond CLI's from
    ``checkpoint`` for a bond predictor's settings, at batch 128,
    ``steps_per_bucket`` steps in each bucket (or one step in all, with 0);
    launch counts set to 0 just before and read just after, each step's
    equal to train_launches(). Then one eval step, one scheduler step and
    the written checkpoint reloaded in the port, its config carrying the
    route's flags."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.train.optim import tree_leaves
    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    start = int(load_checkpoint_numpy(checkpoint)["step"])
    steps = max(2 * steps_per_bucket, 1)
    name = os.path.splitext(os.path.basename(checkpoint))[0]
    run = functools.partial(train_cli.run, reset_ema=True, reset_optim=True)
    if settings["model"]["name"] == "bond_predictor":
        run = bond_cli.run
    kernels.reset_launch_counts()
    out = run(settings, checkpoint, device=device,
              logdir=os.path.join("outputs_torch", "chip_smoke"),
              name=f"train_{name}_{route(settings)}", max_iters=start + steps, subsets=corpus,
              log=lambda m: say(f"  {m}"))
    counts = dict(kernels.launch_counts)
    per_step = train_launches(settings, results)
    by_bucket = {}
    for st in out["steps"]:
        assert st["launches"] == per_step, (st["it"], st["launches"], per_step)
        check_step_terms(st, settings)
        by_bucket.setdefault(st["n"], []).append(st["s"])
        say(f"  train step {st['it']} N={st['n']}: {st['s']:.4f} s loss {st['loss']:.4f} "
            f"grad_norm {st['grad_norm']:.4f}")
    if steps_per_bucket:
        assert sorted(by_bucket) == settings["train"]["buckets"], by_bucket
        assert all(len(v) >= steps_per_bucket for v in by_bucket.values()), by_bucket
    assert counts == {k: v * len(out["steps"]) for k, v in per_step.items()}, counts
    trainer, state = out["trainer"], out["state"]
    batch = train_batch(corpus["val"], 16, 40, device, settings)
    gen = torch.Generator(device=device).manual_seed(3)
    vaux = trainer.eval_step(state.params, batch,
                             trainer.draw_noise(batch, gen))
    lr0 = state.opt_state.lr
    state = trainer.scheduler_step(state, float(vaux["loss"]))
    assert math.isfinite(float(vaux["loss"])) and state.opt_state.lr == lr0
    path = out["checkpoints"][-1]
    back = Trainer(trainer.model, settings["train"]).load_checkpoint(path, device)
    assert back.step == start + steps and back.opt_state.count == steps
    for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    saved = net(load_checkpoint_numpy(path)["config"]["model"])
    for flag in ("fuse_block", "edge_full"):
        assert bool(saved.get(flag)) == bool(net(settings["model"]).get(flag)), saved
    s_step = {n: statistics.mean(v[1:] or v) for n, v in sorted(by_bucket.items())}
    say(f"fine-tuning {name} ({route(settings)}): {len(out['steps'])} steps at batch "
        f"{settings['train']['batch_size']}, s/step by bucket (first step of each left out) "
        f"{s_step}, eval loss {float(vaux['loss']):.4f}, checkpoint {path} reloaded (its "
        f"denoiser config {dict(saved)}); launches {counts}")
    return counts, s_step


def check_fused_state(model, params, results: dict, device, b: int = 128, n: int = 40) -> None:
    """Row 2 at path B's largest sampling shape: the arguments of the first
    block's whole-block call in one MolDiff.forward of a sampling state
    (batch b, bucket n, t = 500), replayed through the kernel and its plain
    version."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    g = torch.Generator(device=device).manual_seed(13)
    node_mask = (torch.arange(n, device=device)[None, :]
                 < torch.randint(n // 2, n + 1, (b, 1), generator=g, device=device)).float()
    state = model.init_state(node_mask, model.draw_noise(b, n, g))
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    blocks = model.prepare(params)
    kern, captured = K.fused_block, {}

    def recorder(*args):
        captured.setdefault("fused_block", args)
        return kern(*args)

    K.fused_block = recorder
    try:
        with torch.no_grad():
            model.forward(params, state.h_node, state.pos, state.h_halfedge, t, node_mask,
                          blocks=blocks)
    finally:
        K.fused_block = kern
    check_call("fused_block", captured["fused_block"], blocks[0], results,
               f"B={b} N={n} (a sampling state)", iters=10, plain_iters=3)


def run_path(cli, settings: dict, args_num_mols: int, batch_size: int, run_name: str) -> tuple:
    """Drive one main path through the sample CLI's run(): the launch
    counts are set to 0 just before and read just after."""
    import os

    from moldiff_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    summary = cli.run(settings, device="cuda", outdir=os.path.join("outputs_torch", "chip_smoke"),
                      num_mols=args_num_mols, batch_size=batch_size, run_name=run_name,
                      log=lambda m: say(f"  {m}"))
    return summary, dict(kernels.launch_counts)


def guided_expected(results: dict, dn_blocks: int, bp_blocks: int, steps: int) -> dict:
    """Each kernel's launches in ``steps`` guided reverse steps: the
    denoiser's forward kernels and the predictor's (no PosUpdate), and the
    predictor's backward kernels inputs-only (guidance differentiates
    positions alone)."""
    out = {}
    for name in KERNELS:
        per_step = {"node_block": dn_blocks + bp_blocks, "edge_pair": dn_blocks + bp_blocks,
                    "pos_update": dn_blocks, "node_block_bwd": bp_blocks,
                    "edge_pair_bwd": bp_blocks}.get(name, 0)
        per_call = results[name]["per_call_guided" if name in INPUTS_ONLY_KERNELS
                                 else "per_call"]
        out[name] = per_call * per_step * steps
    return out


def forward_expected(results: dict, calls: int) -> dict:
    """Each kernel's launches when only the default route's forward kernels
    (rows 1, 4, 8) run, ``calls`` wrapper calls of each."""
    return {name: results[name]["per_call"] * calls if name in FORWARD_KERNELS else 0
            for name in KERNELS}


def check_modes_run(cli, results: dict, blocks: int) -> dict:
    """Phase 15: each of MODE_RUNS through run(); every run's launches are
    each forward kernel's per call x ``blocks`` x its steps x its chains;
    the trajectory run's traj_<k>.sdf files hold S + 1 states, the last one
    with the elements and positions of molecule k's final decode. Returns
    the launch counts of all runs, summed."""
    import pickle

    from moldiff_tpu_torch.chem.sdf import read_sdf

    total = {name: 0 for name in KERNELS}
    for tag, (overrides, floor) in MODE_RUNS.items():
        t0 = time.time()
        summary, counts = run_path(cli, with_sample(SAMPLE_SETTINGS, **overrides),
                                   MODE_NUM_MOLS, MODE_BATCH, f"mode_{tag}")
        steps = summary["num_steps"]
        expected = forward_expected(results, blocks * steps * summary["chains"])
        say(f"mode {tag} {overrides}: {summary['chains']} chains x {steps} steps, launches "
            f"{counts}, expected {expected}, {time.time() - t0:.1f} s")
        assert counts == expected, (tag, counts, expected)
        assert summary["recon_workers"] == overrides.get("recon_workers", 0), summary
        assert summary["num_finished"] >= 1 and summary["num_classified"] >= MODE_BATCH, summary
        assert summary["success_rate_classified"] >= floor, (tag, floor, summary)
        report(f"mode {tag}", summary, steps)
        for k, v in counts.items():
            total[k] += v
        if overrides.get("save_traj_prob"):
            out_dir = os.path.join("outputs_torch", "chip_smoke", f"mode_{tag}")
            with open(os.path.join(out_dir, "samples_all.pkl"), "rb") as f:
                finished = pickle.load(f)["finished"]
            assert summary["num_trajectories"] == len(finished) > 0, summary
            for k, entry in enumerate(finished):
                states = list(read_sdf(os.path.join(out_dir, "SDF", f"traj_{k}.sdf")))
                assert len(states) == steps + 1, (k, len(states))
                last, final = states[-1], entry["decoded"]
                assert [a.z for a in last.atoms] == [int(z) for z in final["element"]], k
                pos = [a.pos for a in last.atoms]
                assert max(float(abs(p - q).max()) for p, q in zip(pos, final["atom_pos"])) < 1e-3
            say(f"mode {tag}: {len(finished)} trajectories of {steps + 1} states, each ending "
                "in its molecule's final elements and positions")
    return total


def check_server(results: dict, blocks: int, device) -> dict:
    """Phase 16: make_http_server on 127.0.0.1 at an ephemeral port in a
    thread (flagship_v2, SERVE_STEPS respaced steps, commit nodes, batch
    SERVE_BATCH, coalescing on): /health names the card; two seeded
    requests give the same SMILES; an SDF request; two concurrent unseeded
    requests share one pool; launches as in phase 15 over the chains the
    requests ran. Returns those launch counts."""
    import threading
    import urllib.request

    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.serve import build_service_from_checkpoint, make_http_server
    from moldiff_tpu_torch.serve.server import WARMUP_STEPS

    svc = build_service_from_checkpoint(CHECKPOINT, batch_size=SERVE_BATCH, buckets=[32, 40],
                                        num_steps=SERVE_STEPS, commit="nodes",
                                        batch_window_ms=SERVE_WINDOW_MS, device=device)
    say(f"server warmup (a {WARMUP_STEPS}-step chain per bucket): {svc.warmup():.1f} s")
    srv = make_http_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"

    def call(path: str, body: "dict | None" = None) -> dict:
        t0 = time.time()
        req = urllib.request.Request(url + path, data=None if body is None else
                                     json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200, r.status
            out = json.loads(r.read())
        say(f"  {'POST' if body else 'GET'} {path} {body or ''}: {time.time() - t0:.3f} s")
        return out

    try:
        kernels.reset_launch_counts()
        chains = svc.sampler.chains
        health = call("/health")
        assert health["device"] == torch.cuda.get_device_name(0) and health["warm"] == [32, 40]
        a = call("/generate", {"num_mols": SERVE_NUM_MOLS, "seed": 7})
        b = call("/generate", {"num_mols": SERVE_NUM_MOLS, "seed": 7})
        assert a["smiles"] == b["smiles"] and len(a["smiles"]) == SERVE_NUM_MOLS, (a, b)
        sdf = call("/generate", {"num_mols": SERVE_NUM_MOLS, "seed": 8, "format": "sdf"})
        assert len(sdf["sdf"]) == len(sdf["smiles"]) == SERVE_NUM_MOLS
        assert all("V2000" in blk and blk.endswith("$$$$\n") for blk in sdf["sdf"])
        replies = [None, None]

        def unseeded(i: int) -> None:
            replies[i] = call("/generate", {"num_mols": SERVE_NUM_MOLS})

        workers = [threading.Thread(target=unseeded, args=(i,)) for i in range(2)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        assert not any(w.is_alive() for w in workers)
        assert [r["coalesced"] for r in replies] == [2, 2], replies
        assert replies[0]["seed"] == replies[1]["seed"]
        stats = call("/stats")
        assert stats["requests"] == 5 and stats["batches"] == 1 and stats["errors"] == 0, stats
        counts = dict(kernels.launch_counts)
        ran = svc.sampler.chains - chains
        expected = forward_expected(results, blocks * SERVE_STEPS * ran)
        say(f"server: {ran} chains x {SERVE_STEPS} steps, launches {counts}, expected "
            f"{expected}; seeded SMILES {a['smiles']}")
        assert counts == expected, (counts, expected)
        kernels.reset_launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=30)
    return counts


def step_launches(sampler, params, device) -> dict:
    """Each kernel's launches in one reverse step with ``sampler``'s
    settings (every step of its chains launches the same)."""
    import torch

    from moldiff_tpu_torch.ops import kernels

    model = sampler.model
    b, n = 2, sampler.buckets[0]
    g = torch.Generator(device=device).manual_seed(3)
    node_mask = torch.ones((b, n), device=device)
    state = model.init_state(node_mask, model.draw_noise(b, n, g))
    kw = sampler.chain_kwargs()
    if sampler.bond_predictor is not None:
        bp, bp_params = sampler.bond_predictor
        kw["bond_predictor"] = (bp, bp_params, bp.prepare(bp_params))
    kernels.reset_launch_counts()
    with torch.no_grad():
        model.reverse_step(params, state, 1, node_mask, model.draw_noise(b, n, g),
                           blocks=model.prepare(params), **kw)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    return counts


def _make_corpus(args: tuple) -> dict:
    from moldiff_tpu_torch.data.dataset import make_corpus

    return make_corpus(*args)


def check_bond_training(corpus: dict, results: dict, device) -> dict:
    """Phase 17: the bond CLI's run() with TRAIN_BONDPRED_V2 from
    bondpred_40k (step 40000) at batch 128, two steps in each bucket on
    phase 10's corpus; each step's launches rows 1, 4 and rows 3, 5 in full
    mode (grad.cu's kernels included) per call x 8 blocks, none of the
    others; one eval step, one scheduler step and the checkpoint reloaded
    (fine_tune). Then the predictor's loss and every gradient at B = 16,
    N = 32, kernels against plain versions, under phase 9's rule
    (check_train_gradient) on bondpred_40k's weights."""
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint

    counts, _ = fine_tune(corpus, results, device, TRAIN_BONDPRED_V2,
                          checkpoint=BOND_PREDICTOR_40K)
    params = load_checkpoint(BOND_PREDICTOR_40K, device)["params"]
    check_train_gradient(params, corpus["train"], device, TRAIN_BONDPRED_V2)
    return counts


def train_from_scratch(corpus: dict, results: dict, device) -> tuple:
    """Phase 18: the train CLI's run() with TRAIN_FULL_SYNTHETIC_XL_SCRATCH
    and no checkpoint (params drawn on the card from train.seed), batch 128,
    bucket 32, SCRATCH_STEPS steps with ckpt_freq 1, keep_ckpts SCRATCH_KEEP
    and the config's ckpt_async: each step's launches rows 1, 4, 8 and 3,
    5, 9 per call x 6 blocks, every loss finite; exactly SCRATCH_KEEP
    numeric checkpoints remain, the last equal to the final state. Then
    one step with grad_accum 2 on that state: twice a step's launches.
    Returns the launches of both."""
    import copy

    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.train.optim import tree_leaves
    from moldiff_tpu_torch.train.trainer import Trainer

    settings = copy.deepcopy(TRAIN_FULL_SYNTHETIC_XL_SCRATCH)
    settings["train"].update(ckpt_freq=1, keep_ckpts=SCRATCH_KEEP)
    assert settings["train"]["ckpt_async"] and settings["train"]["buckets"] == [32]
    kernels.reset_launch_counts()
    out = train_cli.run(settings, None, device=device,
                        logdir=os.path.join("outputs_torch", "chip_smoke"), name="train_xl_scratch",
                        max_iters=SCRATCH_STEPS, subsets=corpus, log=lambda m: say(f"  {m}"))
    counts = dict(kernels.launch_counts)
    per_step = train_launches(settings, results)
    assert [st["it"] for st in out["steps"]] == list(range(1, SCRATCH_STEPS + 1))
    for st in out["steps"]:
        assert st["launches"] == per_step, (st["it"], st["launches"], per_step)
        check_step_terms(st, settings)
        say(f"  scratch step {st['it']} N={st['n']}: {st['s']:.4f} s loss {st['loss']:.4f} "
            f"grad_norm {st['grad_norm']:.4f}")
    assert counts == {k: v * SCRATCH_STEPS for k, v in per_step.items()}, counts
    ckpt_dir = os.path.join(out["log_dir"], "checkpoints")
    kept = sorted(os.listdir(ckpt_dir), key=lambda f: int(f.split(".")[0]))
    assert kept == [f"{it}.ckpt" for it in range(SCRATCH_STEPS - SCRATCH_KEEP + 1,
                                                  SCRATCH_STEPS + 1)], kept
    trainer, state = out["trainer"], out["state"]
    back = Trainer(trainer.model, settings["train"]).load_checkpoint(
        os.path.join(ckpt_dir, kept[-1]), device)
    assert back.step == SCRATCH_STEPS and back.opt_state.count == SCRATCH_STEPS
    for a, b in zip(tree_leaves((back.params, back.ema_params)),
                    tree_leaves((state.params, state.ema_params))):
        assert torch.equal(a, b)

    accum = Trainer(trainer.model, dict(settings["train"], grad_accum=2))
    batch = train_batch(corpus["train"], settings["train"]["batch_size"], 32, device, settings)
    noise = accum.draw_step_noise(batch, torch.Generator(device=device).manual_seed(4))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    new, aux = accum.train_step(state, batch, noise)
    aux = {k: float(v) for k, v in aux.items()}
    dt = time.perf_counter() - t0
    a_counts = dict(kernels.launch_counts)
    assert a_counts == {k: 2 * v for k, v in per_step.items()}, a_counts
    assert new.step == SCRATCH_STEPS + 1, new.step
    check_step_terms(aux, settings)
    say(f"from scratch: {SCRATCH_STEPS} steps at batch {settings['train']['batch_size']}, N = 32, "
        f"kept {kept} (async, keep {SCRATCH_KEEP}), the last equal to the final state; "
        f"launches {counts}; grad_accum 2: {dt:.4f} s loss {aux['loss']:.4f} grad_norm "
        f"{aux['grad_norm']:.4f}, launches {a_counts}")
    return counts, a_counts


def _make_store_dir(args: tuple) -> str:
    """Phase 20's dataset directory: the first n molecules of a corpus
    recipe written as SDF files, a summary and a split (the store is built
    in the phase), anew."""
    import shutil

    from moldiff_tpu_torch.data.dataset import CORPORA
    from moldiff_tpu_torch.data.synthetic import make_synthetic_dataset

    root, recipe, n_mols = args
    _, seed, chemistry = CORPORA[recipe]
    shutil.rmtree(root, ignore_errors=True)
    make_synthetic_dataset(root, n_mols=n_mols, seed=seed, chemistry=chemistry)
    return root


def start_store(pool) -> tuple:
    """Phase 20's directory and the same molecules made in memory by their
    recipe, in worker processes while the kernels build."""
    recipe, n_mols = STORE_CORPUS
    return (pool.submit(_make_store_dir, (STORE_ROOT, recipe, n_mols)),
            pool.submit(_make_corpus, STORE_CORPUS))


def check_store_records(dataset, corpus: dict) -> None:
    """Every record of the store against the recipe's record of its molid:
    element, bond_index and bond_type equal, positions within
    STORE_POS_ATOL (the SDF files round them to 4 decimals) plus one
    float32 spacing of the position."""
    import numpy as np

    want = {r["molid"]: r for split in corpus.values() for r in split}
    assert len(dataset) == len(want) == STORE_CORPUS[1], (len(dataset), len(want))
    worst = 0.0
    for i in range(len(dataset)):
        rec = dataset[i]
        ref = want[rec["molid"]]
        for k in ("element", "bond_index", "bond_type"):
            assert rec[k].dtype == ref[k].dtype and np.array_equal(rec[k], ref[k]), \
                (rec["molid"], k)
        assert rec["pos"].shape == ref["pos"].shape, (rec["molid"], rec["pos"].shape)
        # both sides are float32 roundings: one float32 spacing beyond the
        # 4-decimal rounding
        diff = np.abs(rec["pos"].astype(np.float64) - ref["pos"])
        assert (diff <= STORE_POS_ATOL + np.spacing(np.abs(ref["pos"]))).all(), rec["molid"]
        worst = max(worst, float(diff.max()))
    say(f"store: {len(dataset)} records equal to the recipe's (elements, bonds), positions "
        f"within {worst:.7g} (bound {STORE_POS_ATOL} + one float32 spacing)")


def check_run_records(out: dict) -> list:
    """A train run's directory: log.txt, metrics.jsonl with the JAX CLI's
    (tag, step) pairs for its iterations, and an event file whose (tag,
    step, value) triples are the JSONL's (values as float32). Returns the
    JSONL's records."""
    import numpy as np

    from moldiff_tpu_torch.utils.tb_writer import read_events

    assert os.path.getsize(os.path.join(out["log_dir"], "log.txt")) > 0
    with open(out["metrics"]) as f:
        rows = [json.loads(line) for line in f]
    settings = out["trainer"].config
    want = []
    for st in out["steps"]:
        it = st["it"]
        if it % 100 == 0 or it == 1:
            want += [(f"train/{k}", it) for k in ("loss", "loss_pos", "loss_node", "loss_edge",
                                                   "grad_norm", "loss_len", "lr",
                                                   "steps_per_sec")]
        if it % int(settings["val_freq"]) == 0:
            want.append(("val/loss", it))
    assert sorted((r["tag"], r["step"]) for r in rows) == sorted(want), (rows, want)
    events = read_events(out["events"])
    assert events[0]["file_version"] == "brain.Event:2"
    assert [(e["tag"], e["step"], e["value"]) for e in events[1:]] == \
        [(r["tag"], r["step"], float(np.float32(r["value"]))) for r in rows], events
    return rows


def train_from_store(results: dict, model, params, store_jobs, device) -> tuple:
    """Phase 20: the data path. STORE_CORPUS's directory (made while the
    kernels build) processed into a record store by the port's native
    parser, each record held to the recipe's; the train CLI's run() with
    TRAIN_SETTINGS from flagship_v2 (--reset_ema, --reset_optim) fed from
    that store, STORE_STEPS steps at batch 128, then resumed from its newest
    checkpoint for STORE_RESUME_STEPS more in a new log dir; each step's
    launches train_launches(), each run's those and its validation
    forwards'; run records written and agreeing; the test
    split read and sanitized from the store; flagship_v2's params exported
    to the reference format, saved, loaded and converted back bit for bit,
    and one kernel forward of ``model`` on them bit-equal to the original
    params'. Returns the two runs' launches."""
    import copy
    import shutil

    import torch

    from moldiff_tpu_torch.chem import sdf_native
    from moldiff_tpu_torch.data.dataset import get_dataset
    from moldiff_tpu_torch.data.record_store import RecordReader
    from moldiff_tpu_torch.eval.evaluate import load_dataset_mols
    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.utils import convert
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_numpy

    t_phase = time.time()
    root = store_jobs[0].result(timeout=600)
    corpus = store_jobs[1].result(timeout=600)
    t0 = time.time()
    built = sdf_native.lib_path().exists()
    sdf_native.build()
    say(f"native SDF parser: {'reused' if built else 'built'} in {time.time() - t0:.2f} s "
        f"({sdf_native.lib_path()})")
    settings = copy.deepcopy(TRAIN_SETTINGS)
    settings["dataset"]["root"] = root
    settings["train"].update(val_freq=2, ckpt_freq=2, val_batches=1)
    t0 = time.time()
    dataset, subsets = get_dataset(settings["dataset"])
    assert dataset.parser == "native"
    say(f"store: {len(dataset)} records processed in {time.time() - t0:.2f} s, "
        f"{os.path.getsize(dataset.store_path + '.bin')} + "
        f"{os.path.getsize(dataset.store_path + '.idx')} bytes (.bin + .idx); splits "
        + ", ".join(f"{k} {len(v)}" for k, v in subsets.items()))
    check_store_records(dataset, corpus)
    with RecordReader(dataset.store_path) as reader:
        t0 = time.perf_counter()
        for i in range(len(reader)):
            reader[i]
        dt = time.perf_counter() - t0
    say(f"store: {len(dataset)} records read back in {dt:.4f} s ({len(dataset) / dt:.0f} "
        f"records/s, RecordReader, warm page cache)")

    start = int(load_checkpoint_numpy(CHECKPOINT)["step"])
    logdir = os.path.join("outputs_torch", "chip_smoke")
    per_step = train_launches(settings, results)
    counts = []
    outs = []
    for resume, steps, flags in ((CHECKPOINT, STORE_STEPS, {"reset_ema": True,
                                                            "reset_optim": True}),
                                 (None, STORE_RESUME_STEPS, {})):
        resume = resume or outs[-1]["checkpoints"][-1]
        first = int(load_checkpoint_numpy(resume)["step"]) + 1
        kernels.reset_launch_counts()
        out = train_cli.run(settings, resume, device=device, logdir=logdir, name="train_store",
                            max_iters=first + steps - 1, log=lambda m: say(f"  {m}"), **flags)
        counts.append(dict(kernels.launch_counts))
        assert out["data"] == "store", out["data"]
        assert [st["it"] for st in out["steps"]] == list(range(first, first + steps))
        for st in out["steps"]:
            assert st["launches"] == per_step, (st["it"], st["launches"], per_step)
            check_step_terms(st, settings)
            say(f"  store step {st['it']} N={st['n']}: {st['s']:.4f} s loss {st['loss']:.4f} "
                f"grad_norm {st['grad_norm']:.4f}")
        # and each validation batch's forward: rows 1, 4, 8 per call x blocks
        val_calls = net(settings["model"])["num_blocks"] * sum(v["batches"] for v in out["val"])
        val_launches = forward_expected(results, val_calls)
        assert counts[-1] == {k: v * steps + val_launches[k] for k, v in per_step.items()}, \
            (counts[-1], per_step, val_launches)
        rows = check_run_records(out)
        assert [r["step"] for r in rows if r["tag"] == "val/loss"] == \
            [it for it in range(first, first + steps) if it % 2 == 0]
        say(f"run records of {out['log_dir']}: {len(rows)} scalars in metrics.jsonl and "
            f"{os.path.basename(out['events'])}, equal; log.txt; timer {out['timer']}")
        outs.append(out)
    assert outs[0]["log_dir"] != outs[1]["log_dir"]
    assert outs[0]["steps"][0]["it"] == start + 1
    s_step = [st["s"] for out in outs for st in out["steps"][1:]]
    say(f"training from the store: {STORE_STEPS} + {STORE_RESUME_STEPS} steps at batch "
        f"{settings['train']['batch_size']}, N {sorted({st['n'] for o in outs for st in o['steps']})}"
        f", s/step (each run's first left out) mean {statistics.mean(s_step):.4f}; launches "
        f"{counts}")

    mols = load_dataset_mols(root, "test")
    assert 0 < len(mols) <= len(subsets["test"]), (len(mols), len(subsets["test"]))
    say(f"scoring input: {len(mols)} sanitized molecules of the store's test split "
        f"({len(subsets['test'])} records)")

    ckpt = load_checkpoint(CHECKPOINT, device)
    exported = convert.export_moldiff_state_dict(params)
    path = os.path.join(logdir, "flagship_v2_reference.pt")
    torch.save({"config": ckpt["config"].to_dict(),
                "model": {k: torch.from_numpy(v) for k, v in exported.items()},
                "iteration": start}, path)
    sd, config = convert.load_reference_checkpoint(path)
    back = convert.convert_moldiff_state_dict(sd, config.model, device=device)
    got_leaves, want_leaves = dict(_leaves(back)), dict(_leaves(params))
    assert sorted(got_leaves) == sorted(want_leaves)
    for k, w in want_leaves.items():
        assert got_leaves[k].dtype == w.dtype and torch.equal(got_leaves[k], w), k
    args = forward_inputs(model, device)
    got = model.forward(back, *args)
    want = model.forward(params, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    say(f"reference checkpoint: {len(exported)} tensors exported to {path} "
        f"({os.path.getsize(path)} bytes), loaded and converted back: every leaf bit-equal, "
        f"one kernel forward (B=16, N=32) bit-equal")
    shutil.rmtree(root)
    say(f"phase 20 (data path and run records): {time.time() - t_phase:.1f} s")
    return counts[0], counts[1]


class RoutePins:
    """Phase 21's MoE checks: moe.choose (each token's experts) recorded
    over the first ``calls`` routings, one forward's (a call per block),
    then replayed in that order, so every later forward routes each token
    to the first forward's experts. The router's argmax is discontinuous:
    a one-ulp difference in a block's input can send a token to another
    expert, which moves the output far more than any kernel difference.
    The first forward runs the kernels; the plain versions then take its
    routing, and the comparison holds what the kernels compute."""

    def __init__(self, calls: int):
        self.calls = calls
        self.recorded = []
        self.replays = 0

    def __enter__(self):
        from moldiff_tpu_torch.models import moe

        self.moe, self.choose_free = moe, moe.choose
        moe.choose = self.choose
        return self

    def __exit__(self, *exc) -> None:
        self.moe.choose = self.choose_free

    def choose(self, probs, top_k: int) -> list:
        if len(self.recorded) < self.calls:
            self.recorded.append(self.choose_free(probs, top_k))
            return self.recorded[-1]
        out = self.recorded[self.replays % self.calls]
        self.replays += 1
        return out


@contextlib.contextmanager
def plain_versions(functions: dict = FORWARD_FUNCTIONS):
    """Each kernel wrapper of ``functions`` (kernel name -> wrapper; by
    default every forward kernel's) replaced by its plain version."""
    from moldiff_tpu_torch.ops import kernels as K

    saved = {fn: getattr(K, fn) for fn in functions.values()}
    for fn in saved:
        setattr(K, fn, getattr(K, fn + "_plain"))
    try:
        yield
    finally:
        for fn, f in saved.items():
            setattr(K, fn, f)


def upcycle_moe(dense: dict, moe: dict) -> dict:
    """MoE params whose leaves are a dense model's (flagship_v2's) but for
    the NodeBlock's node MLP: every expert a copy of it, the router
    ``moe``'s. Top-2 gates sum to 1, so a token that keeps both its slots
    gets the dense node MLP's output: the MoE path on trained weights, the
    weights phases 4 and 9 hold the dense path on."""
    import torch

    from moldiff_tpu_torch.utils.tree import tree_map

    experts = moe["denoiser"]["blocks"]["node_block"]["node_net"]["router"]["w"].shape[-1]
    node_block = dict(dense["denoiser"]["blocks"]["node_block"])
    node_block["node_net"] = {
        "router": moe["denoiser"]["blocks"]["node_block"]["node_net"]["router"],
        "experts": tree_map(lambda x: torch.stack([x] * experts, dim=1),
                            node_block["node_net"])}
    return dict(dense, denoiser={"blocks": dict(dense["denoiser"]["blocks"],
                                                node_block=node_block)})


def check_forward_witnessed(model, params, device) -> None:
    """MolDiff.forward (phase 4's inputs) with the kernels against the plain
    versions on weights trained a few steps from a seed. Such a network can
    carry a kernel's one-ulp bf16 differences further than flagship_v2's,
    so each output's largest difference relative to its range is held to
    TRAIN_WITNESS_RATIO x that of the plain versions with one ulp added at
    the share of elements where each kernel differs (ulp_witness, over
    TRAIN_WITNESS_SEEDS), not to phase 4's bound. Under MoE the plain runs
    take the kernel run's routing (RoutePins)."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    blocks = model.prepare(params)
    args = (params,) + forward_inputs(model, device)
    kern = {fn: getattr(K, fn) for fn in FORWARD_FUNCTIONS.values()}
    plain = {fn: getattr(K, fn + "_plain") for fn in kern}

    def run(use: dict):
        for fn, f in use.items():
            setattr(K, fn, f)
        try:
            with torch.no_grad():
                return model.forward(*args, blocks=blocks)
        finally:
            for fn, f in kern.items():
                setattr(K, fn, f)

    moe = model.denoiser_static["moe"] is not None
    with (RoutePins(len(blocks)) if moe else contextlib.nullcontext()):
        got, want = run(kern), run(plain)
        witness = []
        for seed in TRAIN_WITNESS_SEEDS:
            gen = torch.Generator(device=device).manual_seed(seed)
            witness.append(run({fn: ulp_witness(kern[fn], plain[fn], gen, [])
                                for fn in kern}))
    torch.cuda.synchronize()
    frac = lambda a, w: float((a - w).abs().max() / w.abs().max())
    for k, name in enumerate(got._fields):
        assert bool(torch.isfinite(got[k]).all()), name
        f_k = frac(got[k], want[k])
        f_w = max(frac(w[k], want[k]) for w in witness)
        say(f"forward {name} (few-step weights): max |kernels - plain| / max |plain| = "
            f"{f_k:.3g}, the one-ulp witness's largest {f_w:.3g}")
        assert f_k <= TRAIN_WITNESS_RATIO * f_w, (name, f_k, f_w)


def moe_routing_flips(model, model32, params, device) -> dict:
    """How many real tokens chose another expert (first or second choice,
    summed over the blocks) in MolDiff.forward of phase 4's inputs (B = 16,
    N = 32, t = 500) with the kernels at bf16, with the plain versions at
    bf16 and with the plain versions at float32, pair by pair, each run
    routing freely."""
    import torch

    args = (params,) + forward_inputs(model, device)
    real = args[-1].reshape(-1) > 0
    blocks = model.denoiser_static["num_blocks"]
    choices = {}
    for name, m, plain in (("kernels_bf16", model, False), ("plain_bf16", model, True),
                           ("plain_f32", model32, True)):
        with RoutePins(blocks) as pins, torch.no_grad(), (
                plain_versions() if plain else contextlib.nullcontext()):
            m.forward(*args)
        choices[name] = pins.recorded
    flips = {}
    for a, b in (("kernels_bf16", "plain_bf16"), ("kernels_bf16", "plain_f32"),
                 ("plain_bf16", "plain_f32")):
        flips[f"{a}_vs_{b}"] = [
            sum(int(((x[j] != y[j]) & real).sum()) for x, y in zip(choices[a], choices[b]))
            for j in range(len(choices[a][0]))]
    flips["real_tokens_x_blocks"] = int(real.sum()) * blocks
    return flips


def train_variant(settings: dict, corpus: dict, results: dict, device, steps: int,
                  name: str) -> tuple:
    """The train CLI's run() (the bond CLI's for a predictor) with
    ``settings`` from scratch (params from train.seed) for ``steps`` steps
    at batch 128 on phase 10's corpus: launch counts set to 0 just before
    and read just after, each step's equal to train_launches(); every loss
    term finite, and under MoE loss_moe finite and above 0. Returns the
    counts, the run's summary and its s/step by bucket (first step of each
    left out when a bucket has more)."""
    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train import cli as train_cli

    bond = settings["model"]["name"] == "bond_predictor"
    run = bond_cli.run if bond else train_cli.run
    kernels.reset_launch_counts()
    out = run(settings, None, device=device, logdir=os.path.join("outputs_torch", "chip_smoke"),
              name=f"variant_{name}", max_iters=steps, subsets=corpus,
              log=lambda m: say(f"  {m}"))
    counts = dict(kernels.launch_counts)
    per_step = train_launches(settings, results)
    moe = bool(net(settings["model"]).get("moe"))
    by_bucket = {}
    for st in out["steps"]:
        assert st["launches"] == per_step, (name, st["it"], st["launches"], per_step)
        check_step_terms(st, settings)
        if moe:
            assert math.isfinite(st["loss_moe"]) and st["loss_moe"] > 0, st
        by_bucket.setdefault(st["n"], []).append(st["s"])
    assert len(out["steps"]) == steps
    assert counts == {k: v * steps for k, v in per_step.items()}, counts
    s_step = {n: statistics.mean(v[1:] or v) for n, v in sorted(by_bucket.items())}
    say(f"variant {name} ({route(settings)}): {steps} steps at batch "
        f"{settings['train']['batch_size']}, s/step by bucket {s_step}, losses "
        + ", ".join(f"{st['loss']:.4f}" + (f" (moe {st['loss_moe']:.5f})" if moe else "")
                    for st in out["steps"]) + f"; launches per step {per_step}")
    return counts, out, s_step


def sample_variant(cli, settings: dict, results: dict, expected_per_step: dict, num_mols: int,
                   batch_size: int, run_name: str) -> tuple:
    """run_path() of ``settings``; its launches must equal
    ``expected_per_step`` (launches a reverse step) x steps x chains.
    Returns the counts and the summary."""
    summary, counts = run_path(cli, settings, num_mols, batch_size, run_name)
    steps = summary["num_steps"] * summary["chains"]
    expected = {k: expected_per_step.get(k, 0) * steps for k in KERNELS}
    s_step = summary["chain_s"] / steps
    say(f"{run_name}: {summary['chains']} chains x {summary['num_steps']} steps at batch "
        f"{batch_size}, {s_step:.5f} s/step, finished {summary['num_finished']} failed "
        f"{summary['num_failed']}; launches {counts}, expected {expected}")
    assert counts == expected, (run_name, counts, expected)
    assert summary["num_finished"] + summary["num_failed"] >= 1, summary
    return counts, summary, s_step


def check_ungated(corpus: dict, device, b: int = 128, n: int = 40) -> dict:
    """UNGATED_V2 from a seed: one MolDiff.forward of a sampling state and
    training steps (loss, backward, adamw, EMA) at batch b, bucket n on a
    corpus batch, each timed (the second of two, after a synchronize), with
    no launch of any kernel (JAX takes its kernels only where blocks are
    gated) and finite outputs; peak device memory printed."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train.trainer import Trainer

    model = train_model(UNGATED_V2, device)
    trainer = Trainer(model, UNGATED_V2["train"])
    gen = torch.Generator(device=device).manual_seed(UNGATED_V2["train"]["seed"])
    state = trainer.init_state(gen)
    batch = train_batch(corpus["train"], b, n, device, UNGATED_V2)
    mask = batch["node_mask"]
    sample = model.init_state(mask, model.draw_noise(b, n, gen))
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    times = {"forward": [], "train_step": []}
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            preds = model.forward(state.params, sample.h_node, sample.pos, sample.h_halfedge, t,
                                  mask)
            torch.cuda.synchronize(device)
            times["forward"].append(time.perf_counter() - t0)
    assert all(bool(torch.isfinite(x).all()) for x in preds)
    for _ in range(2):
        t0 = time.perf_counter()
        state, aux = trainer.train_step(state, batch, trainer.draw_step_noise(batch, gen))
        torch.cuda.synchronize(device)
        times["train_step"].append(time.perf_counter() - t0)
        check_step_terms({k: float(v) for k, v in aux.items()}, UNGATED_V2)
    counts = dict(kernels.launch_counts)
    assert not any(counts.values()), counts
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    say(f"ungated (use_gate: false) B={b} N={n}: forward {times['forward'][1] * 1e3:.3f} ms, "
        f"train step {times['train_step'][1] * 1e3:.3f} ms (first {times['train_step'][0]:.3f} "
        f"s), loss {float(aux['loss']):.4f}, peak memory {peak:.2f} GB; launches {counts}")
    return counts


def check_variants(cli, corpus: dict, results: dict, device, dense: dict,
                   dense_params: dict) -> list:
    """Phase 21: the model variants at flagship_v2's widths from a seed
    (train/settings.py), their launches on their main paths, their kernels
    against the plain versions, and their times beside the dense model's in
    this call (``dense``: phase 5's unguided s/step at batch 16 and phase
    10's s/step by bucket; ``dense_params``: flagship_v2's). Returns the
    launch counts of the main paths."""
    import torch

    from moldiff_tpu_torch.ops import kernels

    t_phase = time.time()
    paths = []
    blocks = MOE_V2["model"]["denoiser"]["num_blocks"]
    per_call = lambda name: results[name]["per_call"]

    # MoE: training on the default route, edge_full and fuse_block (fuse
    # is off under MoE); the predictor; a respaced chain from its checkpoint
    t0 = time.time()
    counts, moe_out, moe_s = train_variant(MOE_V2, corpus, results, device, VARIANT_STEPS, "moe")
    paths.append(counts)
    assert sorted(moe_s) == MOE_V2["train"]["buckets"], moe_s
    say(f"MoE training step s by bucket {moe_s} against the dense model's {dense['train_s']} "
        f"(phase 10, this call)")
    paths.append(train_variant(with_denoiser(MOE_V2, edge_full=True), corpus, results, device,
                               VARIANT_STEPS, "moe_edge_full")[0])
    paths.append(train_variant(with_denoiser(MOE_V2, fuse_block=True), corpus, results, device,
                               1, "moe_fuse_block")[0])
    paths.append(train_variant(MOE_BONDPRED_V2, corpus, results, device, 1, "moe_bondpred")[0])
    moe_ckpt = moe_out["checkpoints"][-1]
    counts, _, _ = sample_variant(
        cli, with_sample(SAMPLE_SETTINGS, {"model": {"checkpoint": moe_ckpt}},
                         num_steps=VARIANT_CHAIN_STEPS),
        results, {"edge_pair": per_call("edge_pair") * blocks,
                  "pos_update": per_call("pos_update") * blocks},
        1, VARIANT_BATCH, "moe_v2_s100")
    paths.append(counts)
    say(f"  MoE main paths: {time.time() - t0:.1f} s")

    # MoE kernels against the plain versions at bf16, the plain runs routed
    # as the kernel run was (RoutePins): phases 4 and 9 on flagship_v2's
    # weights with its node MLP as every expert, and the few-step weights
    # against the one-ulp witness; the routing flips
    t0 = time.time()
    moe_params = moe_out["state"].params
    upcycled = upcycle_moe(dense_params, moe_params)
    model, model32 = train_model(MOE_V2, device), train_model(MOE_V2, device, dtype="float32")
    with RoutePins(blocks):
        check_forward(model, upcycled, device)
    with RoutePins(blocks):
        check_train_gradient(upcycled, corpus["train"], device, MOE_V2)
    check_forward_witnessed(model, moe_params, device)
    flips = moe_routing_flips(model, model32, moe_params, device)
    say(f"MoE routing (first, second choice) that differ over {flips.pop('real_tokens_x_blocks')} "
        f"real tokens x blocks: {flips}")
    say(f"  MoE checks: {time.time() - t0:.1f} s")

    # the continuous categorical space: training, a full unguided chain
    # (default route, then fuse_block respaced), a guided respaced chain,
    # edge guidance refused; its kernels against the plain versions
    t0 = time.time()
    counts, cont_out, cont_s = train_variant(CONT_V2, corpus, results, device, VARIANT_STEPS,
                                             "cont")
    paths.append(counts)
    cont_ckpt = cont_out["checkpoints"][-1]
    cont = with_sample(SAMPLE_SETTINGS, {"model": {"checkpoint": cont_ckpt}})
    counts, _, s_cont = sample_variant(
        cli, cont, results, {k: per_call(k) * blocks for k in FORWARD_KERNELS}, 1,
        VARIANT_BATCH, "cont_v2_1000")
    paths.append(counts)
    say(f"continuous chain {s_cont:.5f} s/step against the discrete chain's "
        f"{dense['sample_s']:.5f} (phase 5, batch 16, this call): ratio "
        f"{s_cont / dense['sample_s']:.3f}")
    fused = with_sample(SAMPLE_SETTINGS, {"model": {"checkpoint": cont_ckpt,
                                                    "denoiser": {"fuse_block": True}}},
                        num_steps=VARIANT_CHAIN_STEPS)
    paths.append(sample_variant(cli, fused, results,
                                {"fused_block": per_call("fused_block") * blocks}, 1,
                                VARIANT_BATCH, "cont_v2_fuse_s100")[0])
    bp_blocks = TRAIN_BONDPRED_V2["model"]["encoder"]["num_blocks"]
    guided = with_sample(GUIDED_SETTINGS, {"model": {"checkpoint": cont_ckpt}},
                         num_steps=VARIANT_CHAIN_STEPS)
    paths.append(sample_variant(cli, guided, results,
                                guided_expected(results, blocks, bp_blocks, 1), 1,
                                VARIANT_BATCH, "cont_v2_guided_s100")[0])
    refused = with_sample(SAMPLE_SETTINGS, {"model": {"checkpoint": cont_ckpt},
                                            "bond_predictor": BOND_PREDICTOR},
                          edge_guidance=1.0, num_steps=VARIANT_CHAIN_STEPS)
    kernels.reset_launch_counts()
    try:
        cli.run(refused, device="cuda", outdir=os.path.join("outputs_torch", "chip_smoke"),
                num_mols=1, batch_size=VARIANT_BATCH, run_name="cont_v2_eg", log=say)
    except ValueError as exc:
        assert "edge_guidance" in str(exc), exc
        say(f"continuous edge_guidance 1.0 refused: {exc}")
    else:
        raise AssertionError("edge_guidance on a continuous model was not refused")
    assert not any(kernels.launch_counts.values()), kernels.launch_counts
    # phases 4 and 9 on flagship_v2's weights (the continuous space's tree
    # is the dense one), and the few-step weights against the witness
    cont_model = train_model(CONT_V2, device)
    check_forward(cont_model, dense_params, device)
    check_train_gradient(dense_params, corpus["train"], device, CONT_V2)
    check_forward_witnessed(cont_model, cont_out["state"].params, device)
    say(f"  continuous space: {time.time() - t0:.1f} s")

    # ungated blocks: no kernel at all
    t0 = time.time()
    paths.append(check_ungated(corpus, device))
    say(f"  ungated: {time.time() - t0:.1f} s")
    del model, model32
    torch.cuda.empty_cache()
    say(f"phase 21 (model variants): {time.time() - t_phase:.1f} s")
    return paths


# phase 22: the data axis. TRAIN_V2_CONT_DP2 (two data-parallel ranks) and
# TRAIN_V2_CONT_FSDP2 (FSDP, sharded checkpoints) from flagship_v2 on phase
# 10's corpus, both ranks on the one card over gloo (NCCL refuses two ranks
# on one device); NCCL at world size 1; the sample CLI over 2 processes.
# The per-step losses of W = 2 against W = 1 (the same loader batches and
# noise; only the order of the sums differs, and the params after step 1
# by the bf16 gradient's last bits): relative, at most DP_LOSS_RTOL; the
# FSDP run's params after 2 steps against the data-parallel run's: each
# leaf within DP_PARAM_MAX_FRAC of its scale.
DP_STEPS = 4
DP_LOSS_RTOL = 1e-3
DP_PARAM_MAX_FRAC = 1e-3
# the gradient check's batch (phase 9's rules: the float32 plain gradient
# at B = 128 would not fit beside the rest), split over the two ranks
DP_GRAD_BATCH = 32
SHARDED_SAMPLE = with_sample(SAMPLE_SETTINGS, num_mols=16, batch_size=8, num_steps=100)


def _to(tree, device):
    """Every tensor of a (nested) batch or noise structure on ``device``."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _host_tree(tree):
    from moldiff_tpu_torch.utils.tree import tree_map

    return None if tree is None else tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _whole_state(trainer, state) -> dict:
    full = trainer.gathered(state)
    return {"params": _host_tree(full.params), "mu": _host_tree(full.opt_state.mu),
            "nu": _host_tree(full.opt_state.nu), "ema": _host_tree(full.ema_params),
            "count": full.opt_state.count, "lr": full.opt_state.lr, "step": full.step}


def _rank_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _gloo_rank(rank: int, world: int, init: str, settings: dict, checkpoint: str, batch: dict,
               noise, ckpt_dir: str, device: str) -> "dict | None":
    """Phase 22 (a) and (c) at 2 ranks on the card over gloo: the data
    axis's gradient of ``batch``, from flagship_v2; then the FSDP CLI's
    sharded directory read at W = 2 and gathered, saved again, read back,
    and one step from each of the two states."""
    import torch

    from moldiff_tpu_torch.parallel.mesh import Mesh, initialize_distributed, shutdown_distributed
    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.tree import tree_leaves

    device = _rank_device(device)
    initialize_distributed(init, world, rank, backend="gloo")
    try:
        mesh = Mesh(data=world, backend="gloo").at(rank, device)
        model = train_model(settings, device)
        trainer = Trainer(model, settings["train"], mesh=mesh)
        state = trainer.load_checkpoint(checkpoint, device)
        b, nz = _to(batch, device), _to(noise, device)
        grads, norm, aux = trainer.gradient(state, b, nz)
        out = {"grads": [g.cpu() for g in grads], "norm": float(norm), "loss": float(aux["loss"])}
        fs = Trainer(model, settings["train"], mesh=mesh, fsdp=True)
        state = fs.load_checkpoint(ckpt_dir, device)
        out["whole"] = _whole_state(fs, state)
        out["shard_numel"] = sum(x.numel() for x in tree_leaves(state.params))
        again = ckpt_dir + "_again"
        fs.save_checkpoint_sharded(again, state, {"model": settings["model"]})
        back = Trainer(model, settings["train"], mesh=mesh, fsdp=True)
        resumed = back.load_checkpoint(again, device)
        s1, a1 = fs.train_step(state, b, nz)
        s2, a2 = back.train_step(resumed, b, nz)
        p1, p2 = (tree_leaves(t.gathered(s).params) for t, s in ((fs, s1), (back, s2)))
        out["resumed_equal"] = (float(a1["loss"]) == float(a2["loss"])
                                and all(torch.equal(x, y) for x, y in zip(p1, p2)))
        return out if rank == 0 else None
    finally:
        shutdown_distributed()


def _one_rank_step(rank: int, world: int, init: str, settings: dict, checkpoint: str,
                   batch: dict, noise, device: str, backend: str) -> dict:
    """Phase 22 (b): one data-parallel step from flagship_v2 through a
    process group of one rank (NCCL on the card)."""
    import torch.distributed as dist

    from moldiff_tpu_torch.parallel.mesh import Mesh, shutdown_distributed
    from moldiff_tpu_torch.train.trainer import Trainer

    device = _rank_device(device)
    # initialize_distributed makes no group for one process, as JAX's
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        trainer = Trainer(train_model(settings, device), settings["train"],
                          mesh=Mesh(data=world, backend=backend).at(rank, device))
        assert trainer.mesh is not None
        state = trainer.load_checkpoint(checkpoint, device)
        state, aux = trainer.train_step(state, _to(batch, device), _to(noise, device))
        return {"params": _host_tree(state.params), "aux": {k: float(v) for k, v in aux.items()}}
    finally:
        shutdown_distributed()


def _run_dp(settings: dict, corpus: dict, device, name: str, **kw) -> tuple:
    """The train CLI's run() with ``settings`` from flagship_v2 (--reset_ema,
    --reset_optim) for DP_STEPS (or kw's max) steps -> (summary, start)."""
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    start = int(load_checkpoint_numpy(CHECKPOINT)["step"])
    steps = kw.pop("steps", DP_STEPS)
    out = train_cli.run(settings, CHECKPOINT, device=device, reset_ema=True, reset_optim=True,
                        logdir=os.path.join("outputs_torch", "chip_smoke"), name=name,
                        max_iters=start + steps, subsets=corpus, log=lambda m: say(f"  {m}"),
                        **kw)
    return out, start


def _leaf_frac(got: list, want: list) -> float:
    return max(float(abs(a - b).max()) / max(float(abs(b).max()), 1e-30)
               for a, b in zip(got, want))


def _start_sharded_sampling(work: str, device) -> tuple:
    """Phase 22 (d): the sample CLI as 2 processes sharing the one card (a
    FileStore rendezvous), started in the background."""
    rendezvous = os.path.abspath(os.path.join(work, "rendezvous"))
    if os.path.exists(rendezvous):
        os.remove(rendezvous)   # a stale FileStore would join an old run
    cfg = os.path.join(work, "sample_flagship_v2_s100.yml")
    with open(cfg, "w") as f:
        json.dump(SHARDED_SAMPLE, f)   # JSON is YAML
    procs = []
    for pid in range(2):
        log = open(os.path.join(work, f"sample_{pid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "moldiff_tpu_torch.sample", "--config", cfg,
             "--device", device.type, "--outdir", work, "--run_name", "sharded",
             "--num_processes", "2",
             "--process_id", str(pid), "--coordinator", "file://" + rendezvous],
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs, os.path.join(work, "sharded")


def _stop(procs: list) -> None:
    """Kill the sampling processes still running; close their logs."""
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _finish_sharded_sampling(procs: list, run_dir: str, t0: float) -> dict:
    import pickle

    from moldiff_tpu_torch.eval import evaluate

    try:
        for p, _ in procs:
            p.wait(timeout=300)
    finally:
        _stop(procs)
    for pid, (p, log) in enumerate(procs):
        if p.returncode != 0:
            with open(log.name) as f:
                say(f.read()[-3000:])
        assert p.returncode == 0, (pid, p.returncode)
    wall = time.time() - t0
    shards = []
    for pid in range(2):
        with open(os.path.join(run_dir, f"shard_{pid}", "summary.json")) as f:
            shards.append(json.load(f))
    counts = shards[0]["global_counts"]
    assert counts == shards[1]["global_counts"] == [[s["num_finished"], s["num_failed"]]
                                                    for s in shards], counts
    merged = subprocess.run([sys.executable, "-m", "moldiff_tpu_torch.sample", "--merge", run_dir],
                            capture_output=True, text=True, timeout=120)
    assert merged.returncode == 0, merged.stderr[-2000:]
    n_fin = sum(c[0] for c in counts)
    assert n_fin == SHARDED_SAMPLE["sample"]["num_mols"], counts
    with open(os.path.join(run_dir, "SMILES.txt")) as f:
        assert len(f.read().split()) == n_fin
    assert len(os.listdir(os.path.join(run_dir, "SDF"))) == n_fin
    with open(os.path.join(run_dir, "samples_all.pkl"), "rb") as f:
        pool = pickle.load(f)
    assert len(pool["finished"]) == n_fin and len(pool["failed"]) == sum(c[1] for c in counts)
    report = evaluate.main(["--root", run_dir])
    assert report["num_mols"] == n_fin, report
    say(f"sharded sampling: 2 processes on the one card, {SHARDED_SAMPLE['sample']['num_mols']} "
        f"molecules at batch {SHARDED_SAMPLE['sample']['batch_size']}, "
        f"{SHARDED_SAMPLE['sample']['num_steps']} respaced steps: global counts {counts}, "
        f"{wall:.1f} s from start to merged; the eval CLI read {report['num_mols']} molecules")
    return {"counts": counts, "wall_s": wall}


def check_data_axis(corpus: dict, results: dict, device) -> list:
    """Phase 22: (a) TRAIN_V2_CONT_DP2 through the train CLI's run(), 2 ranks
    on the one card over gloo, DP_STEPS steps at global batch 128, then the
    same steps at world size 1: per-step losses within DP_LOSS_RTOL, every
    rank's params bit-equal after each step, each rank's launches per step
    phase 10's; the data axis's gradient (B = DP_GRAD_BATCH, N = 40) against
    the world-1 gradient under phase 9's whole-gradient rules; (b) one step
    through an NCCL group of one rank, bit-equal to the plain world-1 step;
    (c) TRAIN_V2_CONT_FSDP2 through run() for 2 steps, a sharded checkpoint
    after each: read at W = 1 and (resharded) at W = 2, bit-equal; its
    params within DP_PARAM_MAX_FRAC of (a)'s after 2 steps; the state read
    back, saved again and read back takes a step bit-equal to it; (d) the
    sample CLI over 2 processes, merged and scored. -> the launch counts of
    (a)'s runs (both ranks, and world 1)."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.parallel import launch
    from moldiff_tpu_torch.train import checkpoint_sharded
    from moldiff_tpu_torch.train.optim import global_norm
    from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT_DP2, TRAIN_V2_CONT_FSDP2
    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy
    from moldiff_tpu_torch.utils.tree import tree_leaves

    t_phase = time.time()
    per_step = train_launches(TRAIN_SETTINGS, results)
    dp2 = copy_settings(TRAIN_V2_CONT_DP2, ckpt_freq=1)
    # (a) two ranks, then world 1, the same loader batches and noise
    t0 = time.time()
    out2, start = _run_dp(dp2, corpus, device, "dp2", backend="gloo", check_replicas=True)
    wall2 = time.time() - t0
    kernels.reset_launch_counts()
    t0 = time.time()
    out1, _ = _run_dp(TRAIN_SETTINGS, corpus, device, "dp1")
    wall1 = time.time() - t0
    counts1 = dict(kernels.launch_counts)
    assert counts1 == {k: v * DP_STEPS for k, v in per_step.items()}, counts1
    rank_counts = []
    for r, rank in enumerate(out2["ranks"]):
        assert len(rank["steps"]) == DP_STEPS
        for st in rank["steps"]:
            assert st["launches"] == per_step, (r, st["it"], st["launches"], per_step)
            assert st["replicas_equal"], (r, st["it"])
        rank_counts.append({k: v * DP_STEPS for k, v in per_step.items()})
    for s2, s1 in zip(out2["steps"], out1["steps"]):
        check_step_terms(s2, TRAIN_SETTINGS)
        say(f"  step {s2['it']} N={s2['n']}: loss W=2 {s2['loss']:.6f} W=1 {s1['loss']:.6f} "
            f"(rel {abs(s2['loss'] - s1['loss']) / abs(s1['loss']):.2e}); grad_norm W=2 "
            f"{s2['grad_norm']:.6f} W=1 {s1['grad_norm']:.6f}; s/step W=2 {s2['s']:.4f} W=1 "
            f"{s1['s']:.4f}; collectives {1e3 * s2['comm_s']:.2f} ms")
        assert abs(s2["loss"] - s1["loss"]) <= DP_LOSS_RTOL * abs(s1["loss"]), (s2, s1)
    s_w2 = statistics.mean(s["s"] for s in out2["steps"][1:])
    s_w1 = statistics.mean(s["s"] for s in out1["steps"][1:])
    comm_ms = 1e3 * statistics.mean(s["comm_s"] for s in out2["steps"][1:])
    say(f"data axis (a): W=2 (gloo, one card) {s_w2:.4f} s/step, W=1 {s_w1:.4f} s/step (steps "
        f"2-{DP_STEPS}), collectives {comm_ms:.2f} ms/step; run() walls {wall2:.1f} s / "
        f"{wall1:.1f} s")

    # (c) FSDP and sharded checkpoints through the CLI: 2 steps
    fsdp = copy_settings(TRAIN_V2_CONT_FSDP2, ckpt_freq=1)
    t0 = time.time()
    outf, _ = _run_dp(fsdp, corpus, device, "fsdp2", backend="gloo", steps=2)
    wallf = time.time() - t0
    for st, s2 in zip(outf["steps"], out2["steps"]):
        assert st["launches"] == per_step, (st["it"], st["launches"])
        assert abs(st["loss"] - s2["loss"]) <= DP_LOSS_RTOL * abs(s2["loss"]), (st, s2)
    ckpt = outf["checkpoints"][-1]
    assert checkpoint_sharded.is_sharded_checkpoint(ckpt), ckpt
    n_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    f_step = outf["steps"][-1]
    say(f"data axis (c): FSDP W=2 {f_step['s']:.4f} s at step 2 (the first "
        f"{outf['steps'][0]['s']:.4f} s), collectives {1e3 * f_step['comm_s']:.2f} ms of it, "
        f"losses {[round(s['loss'], 6) for s in outf['steps']]}; sharded checkpoint {ckpt}: "
        f"{n_bytes} bytes in {len(os.listdir(ckpt))} files, written in "
        f"{outf['checkpoint_s'][-1]:.3f} s (the first: {outf['checkpoint_s'][0]:.3f} s); "
        f"run() wall {wallf:.1f} s")
    # (d) sharded sampling in the background meanwhile (nothing below is timed)
    work = os.path.join("outputs_torch", "chip_smoke", "phase22")
    os.makedirs(work, exist_ok=True)
    t_sample = time.time()
    procs, run_dir = _start_sharded_sampling(work, device)
    try:
        # the params after 2 steps: FSDP's directory, read whole at W = 1, against
        # (a)'s pickle checkpoint of the same step
        full = checkpoint_sharded.load_checkpoint_sharded(ckpt)["state"]
        dp_after2 = load_checkpoint_numpy(out2["checkpoints"][1])
        assert int(dp_after2["step"]) == int(full["step"]) == start + 2
        frac = _leaf_frac(tree_leaves(full["params"]), tree_leaves(dp_after2["params"]))
        say(f"  FSDP params after 2 steps against the data-parallel run's: largest leaf "
            f"difference {frac:.3g} of its scale")
        assert frac <= DP_PARAM_MAX_FRAC, frac

        # the gradient (a) and the directory resharded (c), 2 ranks over gloo
        batch = train_batch(corpus["train"], DP_GRAD_BATCH, 40, device)
        ref = Trainer(train_model(TRAIN_SETTINGS, device), TRAIN_SETTINGS["train"])
        noise = ref.draw_step_noise(batch, torch.Generator(device=device).manual_seed(22))
        ranks = launch.spawn(_gloo_rank, 2,
                             args=(TRAIN_SETTINGS, CHECKPOINT, _to(batch, "cpu"),
                                   _to(noise, "cpu"), ckpt, str(device)), timeout_s=300)
        got = ranks[0]
        state = ref.load_checkpoint(CHECKPOINT, device)
        g1, n1, a1 = ref.gradient(state, batch, noise)
        model32 = train_model(TRAIN_SETTINGS, device, dtype="float32")
        with plain_versions(KERNEL_FUNCTIONS):
            ref32 = Trainer(model32, TRAIN_SETTINGS["train"])
            gt, _, _ = ref32.gradient(ref32.load_checkpoint(CHECKPOINT, device), batch, noise)
        g2 = [g.to(device) for g in got["grads"]]
        err = lambda gs: statistics.mean(float((a - t).abs().max())
                                         / max(float(t.abs().max()), 1e-30)
                                         for a, t in zip(gs, gt))
        mean2, mean1 = err(g2), err(g1)
        n1, n2 = float(n1), float(global_norm(g2))
        say(f"  gradient B={DP_GRAD_BATCH} N=40: loss W=2 {got['loss']:.6f} W=1 "
            f"{float(a1['loss']):.6f}; "
            f"grad norm W=2 {n2:.6f} (reported {got['norm']:.6f}) W=1 {n1:.6f}; mean leaf error "
            f"against float32 plain: W=2 {mean2:.4g}, W=1 {mean1:.4g}")
        assert abs(got["loss"] - float(a1["loss"])) <= TRAIN_LOSS_RTOL * abs(float(a1["loss"]))
        assert abs(n2 - n1) <= TRAIN_NORM_RTOL * n1, (n2, n1)
        # (the floor: float32 summation order alone, where the world-1 gradient
        # is the truth itself, as in a float32 run)
        assert mean2 <= TRAIN_MEAN_ERR_RATIO * mean1 + 1e-5, (mean2, mean1)
        whole = got["whole"]
        for name, want in (("params", full["params"]), ("mu", full["opt_state"]["mu"]),
                           ("nu", full["opt_state"]["nu"]), ("ema", full["ema_params"])):
            for x, y in zip(tree_leaves(whole[name]), tree_leaves(want)):
                assert x.shape == y.shape and (x == y).all(), name
        assert whole["step"] == int(full["step"])
        assert whole["count"] == int(full["opt_state"]["count"])
        assert whole["lr"] == float(full["opt_state"]["lr"])
        assert got["resumed_equal"]
        say(f"  the directory read at W=1 and resharded at W=2 (each rank {got['shard_numel']} of "
            f"{sum(x.size for x in tree_leaves(full['params']))} params) bit-equal; a step from "
            f"the state saved again and read back bit-equal to the step from the state itself")

        # (b) NCCL at world size 1
        backend = "nccl" if device.type == "cuda" else "gloo"
        nccl = launch.spawn(_one_rank_step, 1,
                            args=(TRAIN_SETTINGS, CHECKPOINT, _to(batch, "cpu"), _to(noise, "cpu"),
                                  str(device), backend), timeout_s=300)[0]
        plain_state, plain_aux = ref.train_step(ref.load_checkpoint(CHECKPOINT, device), batch,
                                                noise)
        for x, y in zip(tree_leaves(nccl["params"]), tree_leaves(plain_state.params)):
            assert (x == y.cpu().numpy()).all()
        assert nccl["aux"] == {k: float(v) for k, v in plain_aux.items()}
        say(f"data axis (b): one step through a {backend} group of one rank bit-equal to the "
            "world-1 step")

        sampled = _finish_sharded_sampling(procs, run_dir, t_sample)
    finally:
        _stop(procs)
    say(f"phase 22 (data axis): {time.time() - t_phase:.1f} s")
    say(json.dumps({"data_axis": {"s_per_step_w1": s_w1, "s_per_step_w2": s_w2,
                                  "collective_ms_per_step": comm_ms,
                                  "fsdp_s_step2": f_step["s"],
                                  "fsdp_collective_ms_step2": 1e3 * f_step["comm_s"],
                                  "ckpt_bytes": n_bytes, "ckpt_s": outf["checkpoint_s"][-1],
                                  "sharded_sample_wall_s": sampled["wall_s"],
                                  "card": nvidia_smi()}}))
    return rank_counts + [counts1]


# phase 23: the pipe and expert axes, both ranks on the one card over gloo.
# TRAIN_V2_CONT_PP2 (flagship_v2's 6 blocks as 2 stages of 3, 2
# microbatches) for AXIS_STEPS steps, then one step each with edge_full and
# with fuse_block; MOE_V2_EP2 (the expert banks over 2 ranks) and MOE_V2_DP2
# (MoE on 2 data ranks) from flagship_v2 upcycled to MOE_V2 (upcycle_moe:
# a network from a seed drifts apart from one ulp within a few steps, a
# trained one does not) for AXIS_STEPS steps, replaying
# the expert choices of MOE_V2's run at world size 1; each held against the
# same steps at world size 1 in this call (the same loader batches and
# noise): the loss of step 1 within AXIS_LOSS_RTOL_1, of the
# later steps within AXIS_LOSS_RTOL, and PP2's params after step 1 each leaf
# within TRAIN_WITNESS_RATIO x its one-ulp witness or one float32 ulp of the
# leaf's largest value. The witness is world 1's step 1 from its gradient
# with one bf16 ulp of each leaf's largest gradient element added, a random
# sign, to every element (over TRAIN_WITNESS_SEEDS): the block kernels return
# their weight gradients in bf16, and the pipe adds two microbatches' bf16
# gradients where world 1 rounds one sum, so an element whose two halves
# nearly cancel can change sign, and Adam's first step there moves by up to
# twice the learning rate. The pipeline also runs at world size 1 through
# NCCL (one stage, 2 microbatches).
AXIS_STEPS = 4
AXIS_LOSS_RTOL_1 = 1e-5
AXIS_LOSS_RTOL = 1e-4


def _axis_run(settings: dict, corpus: dict, device, name: str, resume: "str | None",
              steps: int, backend: "str | None" = None, check_replicas: bool = False,
              build=None, **build_kw) -> dict:
    """The train CLI's run() with ``settings`` for ``steps`` steps, from
    ``resume`` (--reset_ema, --reset_optim) or from train.seed, a checkpoint
    after each step. With ``build`` the same ranks (cli.run_ranks) run
    ``build`` (_pinned_run_local, _routes_run_local) in place of the CLI's
    own rank body, given ``build_kw``."""
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    start = int(load_checkpoint_numpy(resume)["step"]) if resume else 0
    kw = dict(resume=resume, logdir=os.path.join("outputs_torch", "chip_smoke"), name=name,
              max_iters=start + steps, reset_ema=bool(resume), reset_optim=bool(resume),
              subsets=corpus, check_replicas=check_replicas)
    settings = copy_settings(settings, ckpt_freq=1)
    log = lambda m: say(f"  {m}")
    if build is None:
        return train_cli.run(settings, device=device, log=log, backend=backend, **kw)
    return train_cli.run_ranks(build, settings, device, backend, log, override_lr=None,
                               profile_at=0, corpus_mols=train_cli.DEFAULT_CORPUS_MOLS,
                               config_path=None, **kw, **build_kw)


def _summary(out: dict) -> dict:
    """A rank's run summary without its state and trainer (they stay in the
    rank's process)."""
    return {k: v for k, v in out.items() if k not in ("state", "trainer")}


def _routes_run_local(config: dict, device, mesh, log, flags: tuple, **kwargs) -> dict:
    """One rank of cli.run_ranks: the train CLI's own rank body
    (cli._run_local) once per flag of ``flags``, set on model.denoiser, in
    one process group -> {"routes": {flag: its summary}}."""
    from moldiff_tpu_torch.train import cli as train_cli

    return {"routes": {flag: _summary(train_cli._run_local(
        with_denoiser(config, **{flag: True}), device, mesh, log,
        **dict(kwargs, name=f"{kwargs['name']}_{flag}"))) for flag in flags}}


class RouteReplay:
    """moe.choose replaced by a replay of recorded expert choices (a
    RoutePins.recorded of world 1's run: one entry per MoE call, each the
    choices of the whole batch's tokens), this data rank's rows of each, in
    order; each call also counts the tokens (real and padded) whose free
    choice differs, per choice."""

    def __init__(self, recorded: list, part: int):
        self.recorded, self.part = recorded, part
        self.flips = []

    def __enter__(self):
        from moldiff_tpu_torch.models import moe

        self.moe, self.choose_free = moe, moe.choose
        moe.choose = self.choose
        return self

    def __exit__(self, *exc) -> None:
        self.moe.choose = self.choose_free

    def choose(self, probs, top_k: int) -> list:
        free = self.choose_free(probs, top_k)
        s = probs.shape[0]
        pinned = [c[self.part * s:(self.part + 1) * s].to(probs.device)
                  for c in self.recorded[len(self.flips)]]
        self.flips.append([int((f != p).sum()) for f, p in zip(free, pinned)])
        return pinned


def _pinned_run_local(config: dict, device, mesh, log, pins: str, **kwargs) -> dict:
    """One rank of cli.run_ranks: the train CLI's own rank body (cli._run_local)
    with world 1's expert choices replayed (RouteReplay) -> its summary and
    ``route_flips``, the free choices that differed, per MoE call."""
    import torch

    from moldiff_tpu_torch.train import cli as train_cli

    recorded = torch.load(pins)
    with RouteReplay(recorded, mesh.data_rank if mesh is not None else 0) as replay:
        out = _summary(train_cli._run_local(config, device, mesh, log, **kwargs))
    out["route_flips"] = replay.flips
    return out


def _axis_losses(name: str, out: dict, ref: dict) -> list:
    """Each step's loss of a run on a mesh against world 1's: step 1 within
    AXIS_LOSS_RTOL_1, the others within AXIS_LOSS_RTOL -> the relative
    differences."""
    rels = []
    assert len(out["steps"]) == len(ref["steps"]), (name, len(out["steps"]), len(ref["steps"]))
    for k, (a, b) in enumerate(zip(out["steps"], ref["steps"])):
        assert a["it"] == b["it"] and a["n"] == b["n"], (name, a["it"], b["it"])
        rels.append(abs(a["loss"] - b["loss"]) / abs(b["loss"]))
        say(f"  {name} step {a['it']} N={a['n']}: loss {a['loss']:.7f} world 1 {b['loss']:.7f} "
            f"(rel {rels[-1]:.2e}); s/step {a['s']:.4f} world 1 {b['s']:.4f}; collectives "
            f"{1e3 * a['comm_s']:.2f} ms" + (f", pipe p2p {1e3 * a['pipe']['p2p_s']:.2f} ms "
                                             f"({a['pipe']['p2p_bytes']} bytes) broadcast "
                                             f"{1e3 * a['pipe']['broadcast_s']:.2f} ms"
                                             if "pipe" in a else ""))
        assert rels[-1] <= (AXIS_LOSS_RTOL_1 if k == 0 else AXIS_LOSS_RTOL), (name, k, rels)
    return rels


def _axis_launches(name: str, out: dict, per_step: dict, settings: dict = TRAIN_SETTINGS) -> list:
    """Every rank's launches in each step equal ``per_step`` and its terms
    are ``settings``' model's -> each rank's counts over the run."""
    counts = []
    for r, rank in enumerate(out["ranks"]):
        for st in rank["steps"]:
            assert st["launches"] == per_step, (name, r, st["it"], st["launches"], per_step)
            check_step_terms(st, settings)
        counts.append({k: v * len(rank["steps"]) for k, v in per_step.items()})
    return counts


def _mean_later(out: dict, key) -> float:
    steps = out["steps"][1:] or out["steps"]
    return statistics.mean(key(st) for st in steps)


def step1_witness(settings: dict, corpus: dict, device, mesh=None,
                  checkpoint: str = CHECKPOINT) -> tuple:
    """World 1's params after the first step of run() from ``checkpoint``
    (the loader's first batch and the run's first noise, drawn here as
    fit() draws them), and per TRAIN_WITNESS_SEEDS the same step from the
    gradient with one bf16 ulp of each leaf's largest element added, a
    random sign, to every element. ``mesh``: the trainer's (a mesh of one
    rank without a process group: make_mesh_2d(1, 1) takes the plain
    route)."""
    import torch

    from moldiff_tpu_torch.data.loader import BucketedLoader
    from moldiff_tpu_torch.train.optim import tree_leaves, tree_unflatten
    from moldiff_tpu_torch.train.trainer import Trainer, batch_to_device

    tcfg = settings["train"]
    seed = int(tcfg["seed"])
    trainer = Trainer(train_model(settings, device), tcfg, mesh=mesh)
    state = trainer.load_checkpoint(checkpoint, device)
    loader = iter(BucketedLoader(corpus["train"], featurizer(settings), int(tcfg["batch_size"]),
                                 tuple(tcfg["buckets"]), shuffle=True, seed=seed, infinite=True))
    batch = batch_to_device(next(loader), device)
    noise = trainer.draw_step_noise(batch, torch.Generator(device=device).manual_seed(seed))
    grads, _, _ = trainer.gradient(state, batch, noise)

    def step(g):
        p, _ = trainer.optimizer.update(tree_unflatten(state.params, list(g)),
                                        trainer.optimizer.init(state.params), state.params)
        return [x.cpu() for x in tree_leaves(p)]

    def bumped(g, gen):
        ulp = torch.exp2(torch.floor(torch.log2(g.abs().max().clamp(min=1e-30))) - 7)
        sign = torch.where(torch.rand(g.shape, generator=gen, device=g.device) < 0.5, -1.0, 1.0)
        return g + sign * ulp

    witness = []
    for s in TRAIN_WITNESS_SEEDS:
        gen = torch.Generator(device=device).manual_seed(s)
        witness.append(step([bumped(g, gen) for g in grads]))
    return step(grads), witness


def _params_after(out: dict, k: int = 0) -> list:
    """The params of a run's checkpoint after its step k + 1, as tensors."""
    import torch

    from moldiff_tpu_torch.train.optim import tree_leaves
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    return [torch.from_numpy(x) for x in
            tree_leaves(load_checkpoint_numpy(out["checkpoints"][k])["params"])]


def check_step1_witness(name: str, got: list, want: list, witness: list) -> dict:
    """Each leaf of ``got`` (a mesh run's params after step 1) within
    TRAIN_WITNESS_RATIO x the witness's largest move of that leaf, or one
    float32 ulp of the leaf's largest value, from ``want`` (world 1's)."""
    moved, over, far = 0, [], []
    for j, (a, w) in enumerate(zip(got, want)):
        d = float((a - w).abs().max())
        d_w = max(float((x[j] - w).abs().max()) for x in witness)
        ulp = float(w.abs().max()) * 2.0 ** -23
        moved += d > 0
        over.append(d / max(d_w, ulp))
        if d > TRAIN_WITNESS_RATIO * d_w + ulp:
            far.append((j, d, d_w, ulp))
    top = max(range(len(over)), key=over.__getitem__)
    say(f"  {name} params after step 1 against world 1's: {moved} of {len(got)} leaves differ; "
        f"the largest leaf difference {max(over):.3g} x its witness (or ulp), leaf {top}; "
        f"elements that differ {sum(int((a != w).sum()) for a, w in zip(got, want))} of "
        f"{sum(w.numel() for w in want)}")
    assert not far, (name, far)
    return {"leaves_differ": moved, "leaves": len(got), "max_over_witness": max(over)}


def moe_step_flips(runs: dict, ref: dict, device) -> dict:
    """Per run (name -> its summary) and step: the real tokens (first and
    second choice, summed over the blocks) that choose another expert in
    MolDiff.forward of phase 4's inputs with the run's params after that
    step than with world 1's (``ref``), each forward routing freely."""
    import torch

    from moldiff_tpu_torch.utils.checkpoint import params_to_torch, load_checkpoint_numpy

    model = train_model(MOE_V2, device)
    args = forward_inputs(model, device)
    real = args[-1].reshape(-1) > 0
    blocks = MOE_V2["model"]["denoiser"]["num_blocks"]

    def choices(out, k):
        params = params_to_torch(load_checkpoint_numpy(out["checkpoints"][k])["params"], device)
        with RoutePins(blocks) as pins, torch.no_grad():
            model.forward(params, *args)
        return pins.recorded

    flips = {name: [] for name in runs}
    for k in range(len(ref["checkpoints"])):
        want = choices(ref, k)
        for name, out in runs.items():
            got = choices(out, k)
            flips[name].append([sum(int(((x[j] != y[j]) & real).sum()) for x, y in zip(got, want))
                                for j in range(len(want[0]))])
    flips["real_tokens_x_blocks"] = int(real.sum()) * blocks
    return flips


def upcycled_checkpoint(device) -> str:
    """flagship_v2's params upcycled to MOE_V2's tree (upcycle_moe: every
    expert its node MLP, the router MOE_V2's from its seed), written as a
    step-0 checkpoint -> its path."""
    import torch

    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint

    model = train_model(MOE_V2, device)
    seeded = model.init_params(torch.Generator(device=device).manual_seed(
        int(MOE_V2["train"]["seed"])))
    trainer = Trainer(model, MOE_V2["train"])
    state = trainer.init_from_params(upcycle_moe(load_checkpoint(CHECKPOINT, device)["params"],
                                                 seeded))
    path = os.path.join("outputs_torch", "chip_smoke", "moe_v2_upcycled.ckpt")
    trainer.save_checkpoint(path, state, MOE_V2)
    return path


def _one_rank_pipe_step(rank: int, world: int, init: str, settings: dict, checkpoint: str,
                        batch: dict, noise, device: str, backend: str) -> dict:
    """Phase 23 (c): one step from flagship_v2 with the denoiser as a
    pipeline of one stage (2 microbatches) through a process group of one
    rank (NCCL on the card) -> its loss terms and launches."""
    import torch.distributed as dist

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.parallel.mesh import make_mesh_pipe, shutdown_distributed
    from moldiff_tpu_torch.train.trainer import Trainer

    device = _rank_device(device)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        mesh = make_mesh_pipe(1, 1, device, backend).at(rank, device)
        model = train_model(settings, device)
        trainer = Trainer(model, settings["train"], mesh=mesh)
        model.pipeline_cfg = (mesh, settings["train"]["num_microbatches"])
        state = trainer.load_checkpoint(checkpoint, device)
        kernels.reset_launch_counts()
        state, aux = trainer.train_step(state, _to(batch, device), _to(noise, device))
        return {"aux": {k: float(v) for k, v in aux.items()},
                "launches": dict(kernels.launch_counts)}
    finally:
        shutdown_distributed()


def check_pipe_expert_axes(corpus: dict, results: dict, device) -> list:
    """Phase 23: (a) TRAIN_V2_CONT_PP2 through the train CLI's run(), 2
    ranks (the 2 stages) on the one card over gloo, AXIS_STEPS steps from
    flagship_v2 at batch 128, and the same steps at world size 1: losses
    (_axis_losses), every rank's launches a step phase 10's (3 blocks x 2
    microbatches a stage), the params after step 1 within the one-ulp
    witness; (b) one PP2 step each with edge_full and with fuse_block
    against world 1's; (c) the pipeline of one stage through an NCCL group
    of one rank against the world-1 step at B = DP_GRAD_BATCH; (d)
    MOE_V2_EP2 and MOE_V2_DP2 from flagship_v2 upcycled to MOE_V2
    (upcycled_checkpoint), AXIS_STEPS steps through
    cli.run_ranks with world 1's expert choices replayed, against MOE_V2's
    at world size 1 as in (a), launches a step phase 21's; the free choices
    that differ from the replayed ones, and the routing flips of their
    weights after each step against world 1's. -> the launch counts of the
    runs (each rank's, and world 1's)."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.parallel import launch
    from moldiff_tpu_torch.train.settings import MOE_V2_DP2, MOE_V2_EP2, TRAIN_V2_CONT_PP2
    from moldiff_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    paths = []

    def world_one(settings, name, resume, steps):
        kernels.reset_launch_counts()
        out = _axis_run(settings, corpus, device, name, resume, steps)
        paths.append(dict(kernels.launch_counts))
        return out

    # (a) the pipe: 4 steps at PP2, then world 1
    per_step = train_launches(TRAIN_SETTINGS, results)
    t0 = time.time()
    pp = _axis_run(TRAIN_V2_CONT_PP2, corpus, device, "pp2", CHECKPOINT, AXIS_STEPS,
                   backend="gloo", check_replicas=True)
    wall_pp = time.time() - t0
    t0 = time.time()
    pp1 = world_one(TRAIN_SETTINGS, "pp2_world1", CHECKPOINT, AXIS_STEPS)
    wall_pp1 = time.time() - t0
    paths += _axis_launches("PP2", pp, per_step)
    for r, rank in enumerate(pp["ranks"]):
        assert all(st["replicas_equal"] and st["pipe"]["p2p_bytes"] > 0 for st in rank["steps"]), r
    rel_pp = _axis_losses("PP2", pp, pp1)
    p1, witness = step1_witness(TRAIN_SETTINGS, corpus, device)
    cli_p1 = _params_after(pp1)
    same = sum(bool(torch.equal(a, b)) for a, b in zip(cli_p1, p1))
    say(f"  world 1's step 1 recomputed here: {same} of {len(p1)} leaves bit-equal to run()'s")
    wit_pp = check_step1_witness("PP2", _params_after(pp), p1, witness)
    check_step1_witness("world 1 (run() against its recomputation)", cli_p1, p1, witness)

    # (b) one PP2 step with each route (both in one process group) beside
    # world 1's
    routes = {}
    flags = ("edge_full", "fuse_block")
    both = _axis_run(TRAIN_V2_CONT_PP2, corpus, device, "pp2", CHECKPOINT, 1, backend="gloo",
                     build=_routes_run_local, flags=flags)
    for flag in flags:
        ref_settings = with_denoiser(TRAIN_SETTINGS, **{flag: True})
        out = dict(both["routes"][flag], ranks=[r["routes"][flag] for r in both["ranks"]])
        ref = world_one(ref_settings, f"pp2_{flag}_world1", CHECKPOINT, 1)
        paths.extend(_axis_launches(f"PP2 {flag}", out, train_launches(ref_settings, results)))
        routes[flag] = {"rel": _axis_losses(f"PP2 {flag}", out, ref)[0],
                        "s": out["steps"][0]["s"], "world1_s": ref["steps"][0]["s"]}

    # (c) the pipeline through NCCL at world size 1
    batch = train_batch(corpus["train"], DP_GRAD_BATCH, 40, device)
    ref = Trainer(train_model(TRAIN_SETTINGS, device), TRAIN_SETTINGS["train"])
    noise = ref.draw_step_noise(batch, torch.Generator(device=device).manual_seed(23))
    backend = "nccl" if device.type == "cuda" else "gloo"
    one = launch.spawn(_one_rank_pipe_step, 1,
                       args=(TRAIN_V2_CONT_PP2, CHECKPOINT, _to(batch, "cpu"), _to(noise, "cpu"),
                             str(device), backend), timeout_s=300)[0]
    _, plain_aux = ref.train_step(ref.load_checkpoint(CHECKPOINT, device), batch, noise)
    rel_one = abs(one["aux"]["loss"] - float(plain_aux["loss"])) / abs(float(plain_aux["loss"]))
    assert rel_one <= AXIS_LOSS_RTOL_1, (one["aux"], float(plain_aux["loss"]))
    assert one["launches"] == {k: 2 * v for k, v in per_step.items()}, one["launches"]
    paths.append(one["launches"])
    say(f"pipe (c): one stage, 2 microbatches, through a {backend} group of one rank: loss "
        f"{one['aux']['loss']:.7f} against the world-1 step's {float(plain_aux['loss']):.7f} "
        f"(rel {rel_one:.2e}), B={DP_GRAD_BATCH}")

    # (d) MoE on the expert axis and on the data axis, from flagship_v2
    # upcycled: world 1 first, its expert choices recorded, then EP2 and
    # DP2 replaying them
    # (the router's argmax is discontinuous: a one-ulp difference in a
    # block's input can send a token to another expert), the free choices
    # that differ counted
    moe_step = train_launches(MOE_V2, results)
    t0 = time.time()
    moe_ckpt = upcycled_checkpoint(device)
    with RoutePins(10 ** 9) as pins:
        moe1 = world_one(MOE_V2, "moe_world1", moe_ckpt, AXIS_STEPS)
    pins_path = os.path.join("outputs_torch", "chip_smoke", "moe_world1_routes.pt")
    torch.save([[c.cpu() for c in entry] for entry in pins.recorded], pins_path)
    ep = _axis_run(MOE_V2_EP2, corpus, device, "moe_ep2", moe_ckpt, AXIS_STEPS, backend="gloo",
                   check_replicas=True, build=_pinned_run_local, pins=pins_path)
    dp = _axis_run(MOE_V2_DP2, corpus, device, "moe_dp2", moe_ckpt, AXIS_STEPS, backend="gloo",
                   check_replicas=True, build=_pinned_run_local, pins=pins_path)
    wall_moe = time.time() - t0
    paths += _axis_launches("MoE EP2", ep, moe_step) + _axis_launches("MoE DP2", dp, moe_step)
    flips = {}
    for name, out in (("EP2", ep), ("DP2", dp)):
        for r, rank in enumerate(out["ranks"]):
            assert all(st["replicas_equal"] for st in rank["steps"]), (name, r)
            assert all(st["loss_moe"] > 0 for st in rank["steps"]), (name, r)
            assert len(rank["route_flips"]) == len(pins.recorded), (name, r)
        flips[name] = [sum(rank["route_flips"][k][j] for rank in out["ranks"]
                           for k in range(len(pins.recorded)))
                       for j in range(len(pins.recorded[0]))]
    rel_ep = _axis_losses("MoE EP2", ep, moe1)
    rel_dp = _axis_losses("MoE DP2", dp, moe1)
    weights = moe_step_flips({"EP2": ep, "DP2": dp}, moe1, device)
    flips["tokens_x_calls"] = sum(int(c[0].numel()) for c in pins.recorded)
    say(f"MoE routing: the free choices (first, second) that differ from world 1's replayed "
        f"ones over the runs' {flips['tokens_x_calls']} tokens x MoE calls (EP2 counts each "
        f"token on both ranks): EP2 {flips['EP2']}, DP2 {flips['DP2']}; MolDiff.forward of "
        f"phase 4's inputs with the weights after each step against world 1's, over "
        f"{weights['real_tokens_x_blocks']} real tokens x blocks: EP2 {weights['EP2']}, "
        f"DP2 {weights['DP2']}")
    flips["weights"] = weights

    peak = lambda out: max(st.get("peak_bytes", 0) for r in out["ranks"] for st in r["steps"])
    summary = {
        "pp2_s_per_step": _mean_later(pp, lambda st: st["s"]),
        "world1_s_per_step": _mean_later(pp1, lambda st: st["s"]),
        "pp2_collective_ms": 1e3 * _mean_later(pp, lambda st: st["comm_s"]),
        "pp2_p2p_ms": 1e3 * _mean_later(pp, lambda st: st["pipe"]["p2p_s"]),
        "pp2_broadcast_ms": 1e3 * _mean_later(pp, lambda st: st["pipe"]["broadcast_s"]),
        "pp2_p2p_bytes": pp["steps"][-1]["pipe"]["p2p_bytes"],
        "pp2_peak_gb": peak(pp) / 1e9, "pp2_loss_rel": rel_pp, "pp2_step1_params": wit_pp,
        "pp2_routes": routes, "nccl_world1_loss_rel": rel_one,
        "ep2_s_per_step": _mean_later(ep, lambda st: st["s"]),
        "dp2_moe_s_per_step": _mean_later(dp, lambda st: st["s"]),
        "moe_world1_s_per_step": _mean_later(moe1, lambda st: st["s"]),
        "ep2_collective_ms": 1e3 * _mean_later(ep, lambda st: st["comm_s"]),
        "dp2_moe_collective_ms": 1e3 * _mean_later(dp, lambda st: st["comm_s"]),
        "ep2_peak_gb": peak(ep) / 1e9, "dp2_moe_peak_gb": peak(dp) / 1e9,
        "ep2_loss_rel": rel_ep, "dp2_moe_loss_rel": rel_dp, "moe_flips": flips,
        "walls_s": {"pp2": wall_pp, "pp2_world1": wall_pp1, "moe_three_runs": wall_moe},
        "card": nvidia_smi()}
    say(f"pipe (a): PP2 (gloo, one card) {summary['pp2_s_per_step']:.4f} s/step against world "
        f"1's {summary['world1_s_per_step']:.4f} (steps 2-{AXIS_STEPS}), p2p "
        f"{summary['pp2_p2p_ms']:.2f} ms, broadcast {summary['pp2_broadcast_ms']:.2f} ms, "
        f"collectives {summary['pp2_collective_ms']:.2f} ms a step, peak "
        f"{summary['pp2_peak_gb']:.2f} GB a rank")
    say(f"expert (d): EP2 {summary['ep2_s_per_step']:.4f} s/step, MoE DP2 "
        f"{summary['dp2_moe_s_per_step']:.4f}, world 1 {summary['moe_world1_s_per_step']:.4f}; "
        f"collectives {summary['ep2_collective_ms']:.2f} / {summary['dp2_moe_collective_ms']:.2f}"
        f" ms a step; peak {summary['ep2_peak_gb']:.2f} / {summary['dp2_moe_peak_gb']:.2f} GB")
    say(f"phase 23 (pipe and expert axes): {time.time() - t_phase:.1f} s")
    say(json.dumps({"pipe_expert_axes": summary}))
    return paths


# phase 24: the graph and model axes (JAX's plain route, models/denoiser.py
# node_edge_net_sharded), both ranks on the one card over gloo, in one
# process group: TRAIN_V2_CONT_GRAPH2 (the pair tensors split by receiver
# over 2 ranks) and TRAIN_V2_CONT_TP2 (the MLPs split over 2 ranks) for
# AXIS_STEPS steps from flagship_v2, and one step of TRAIN_BONDPRED_V2 on
# graph 2 from bondpred_40k; then in one process group of 4 ranks one step
# each at batch MESH3D_BATCH of MESH3D (graph 2 x model 2), of MOE_V2 on that
# mesh (world 1's expert choices replayed) and of TRAIN_BONDPRED_V2 with FSDP
# on data 2 x pipe 2 (held to world 1 on the kernel route by phase 23's
# rules). The others are held against the same steps at world size 1 on
# the plain route (make_mesh_2d(1, 1), as JAX runs it) in this call: every
# loss within GRAPH_LOSS_RTOL; the gradient norm before
# clipping (a backward that sums over graph as well as data scales it by the
# graph size, which Adam's first step all but hides in the params) of step 1,
# from the same params and batch, within GRAPH_NORM_RTOL_1, one bf16 unit
# roundoff (the two backward passes differ in the order of their bf16 sums),
# and of the later steps within GRAPH_NORM_RTOL (after step 1 the params
# differ where Adam's first step flipped a sign, and the norm moves by
# percents: phase 22's data axis, on the kernel route, by up to 4e-2); the
# params after step 1 of every run each leaf within TRAIN_WITNESS_RATIO x its
# one-ulp witness (phase 23's, from the plain route's gradient of that run's
# settings); and no kernel of the table launched on any of these ranks. The two routes differ at world
# 1 by bf16 roundings: the kernel route's step-1 loss is printed beside the
# plain route's, not held.
GRAPH_LOSS_RTOL = 1e-3
GRAPH_NORM_RTOL_1 = 2.0 ** -8
GRAPH_NORM_RTOL = 0.1
MESH3D_BATCH = 32


def _plain_run_local(config: dict, device, mesh, log, bond: bool = False, **kwargs) -> dict:
    """cli.run_ranks' body for one rank without a process group: the train
    CLI's (bond_cli's with ``bond``) rank body on make_mesh_2d(1, 1), so the
    model takes JAX's plain route at world size 1."""
    from moldiff_tpu_torch.parallel.mesh import make_mesh_2d
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train import cli as train_cli

    run_local = bond_cli._run_local if bond else train_cli._run_local
    return run_local(config, device, make_mesh_2d(1, 1, device, "gloo"), log, **kwargs)


def _axes_run_local(config: dict, device, mesh, log, runs: list, **kwargs) -> dict:
    """One rank of cli.run_ranks: per (name, settings, resume, steps, bond,
    pins) of ``runs`` the train CLI's (bond_cli's) rank body on the mesh of
    ``settings``' parallel section at this rank, in one process group, with
    the expert choices of ``pins`` (a path, or None) replayed (RouteReplay)
    -> {"runs": {name: its summary}}."""
    import torch

    from moldiff_tpu_torch.parallel.mesh import make_mesh_from_config
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    out = {}
    for name, settings, resume, steps, bond, pins in runs:
        m = make_mesh_from_config(settings["parallel"], device, mesh.backend).at(mesh.rank, device)
        assert m.world_size == mesh.world_size
        run_local = bond_cli._run_local if bond else train_cli._run_local
        start = int(load_checkpoint_numpy(resume)["step"])
        with (RouteReplay(torch.load(pins), m.data_rank) if pins
              else contextlib.nullcontext()) as replay:
            out[name] = _summary(run_local(copy_settings(settings, ckpt_freq=1), device, m, log,
                                           **dict(kwargs, name=name, resume=resume,
                                                  max_iters=start + steps)))
        if pins:
            out[name]["route_flips"] = replay.flips
    return {"runs": out}


def _comm(out: dict) -> dict:
    """Per rank, the mean over steps 2-AXIS_STEPS (or the one step) of the
    seconds and bytes a step of the model's collectives (by kind) and of
    the trainer's."""
    keys = [f"{k}_{q}" for k in ("all_reduce", "all_gather", "reduce_scatter")
            for q in ("s", "bytes", "calls")]
    per_rank = []
    for rank in out["ranks"]:
        steps = rank["steps"][1:] or rank["steps"]
        rec = {k: statistics.mean(st["model_comm"][k] for st in steps) for k in keys}
        rec["trainer_s"] = statistics.mean(st["comm_s"] for st in steps)
        rec["s_per_step"] = statistics.mean(st["s"] for st in steps)
        rec["peak_gb"] = max(st.get("peak_bytes", 0) for st in rank["steps"]) / 1e9
        per_rank.append(rec)
    return per_rank


def check_graph_model_axes(corpus: dict, results: dict, device) -> list:
    """Phase 24: (a) TRAIN_V2_CONT_GRAPH2 and TRAIN_V2_CONT_TP2 through the
    train CLI's rank body, AXIS_STEPS steps each from flagship_v2 at batch
    128, and GRAPH2_BOND one step from bondpred_40k, the 2 ranks on the one
    card over gloo in one process group, params checked equal over the
    replicas after each step; (b) in one process group of 4 ranks, one step
    each at batch MESH3D_BATCH: MESH3D (data 1, graph 2, model 2), MOE_V2
    on that mesh from flagship_v2 upcycled (upcycled_checkpoint) with world
    1's expert choices replayed, and TRAIN_BONDPRED_V2 with FSDP on data 2
    x pipe 2 (the pipe ranks replicas) from bondpred_40k; (c) each against
    the same steps at world size 1 (on the plain route, the predictor's
    FSDP run on the kernel route under phase 23's rules), and the plain
    route's step-1 loss against the kernel route's (one step of phase
    10's settings). Every step of every rank on the plain route launches
    no kernel; the FSDP predictor's launch its per-step counts. -> the
    launch counts of the runs."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.parallel.mesh import make_mesh_2d
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train.settings import (MOE_V2, TRAIN_BONDPRED_V2,
                                                  TRAIN_V2_CONT_GRAPH2, TRAIN_V2_CONT_TP2)

    t_phase = time.time()
    zero = {k: 0 for k in train_launches(TRAIN_SETTINGS, results)}
    bond_graph2 = copy_settings(TRAIN_BONDPRED_V2)
    bond_graph2["parallel"] = {"num_devices": 2, "graph": 2}
    mesh3d = copy_settings(TRAIN_SETTINGS, batch_size=MESH3D_BATCH)
    mesh3d["parallel"] = {"num_devices": 4, "graph": 2, "model": 2}
    moe3d = copy_settings(MOE_V2, batch_size=MESH3D_BATCH)
    moe3d["parallel"] = dict(mesh3d["parallel"])
    bond_fsdp = copy_settings(TRAIN_BONDPRED_V2, batch_size=MESH3D_BATCH)
    bond_fsdp["parallel"] = {"num_devices": 4, "pipe": 2, "fsdp": True}
    bond_step = train_launches(TRAIN_BONDPRED_V2, results)
    paths = []

    def world_one(settings, name, resume, steps, **kw):
        kernels.reset_launch_counts()
        out = _axis_run(settings, corpus, device, name, resume, steps, **kw)
        paths.append(dict(kernels.launch_counts))
        return out

    # (c) first: world 1, the plain route and the kernel route's step 1
    t0 = time.time()
    plain = world_one(TRAIN_SETTINGS, "plain_world1", CHECKPOINT, AXIS_STEPS,
                      build=_plain_run_local)
    wall_plain = time.time() - t0
    assert paths[-1] == zero, paths[-1]
    kernel = world_one(TRAIN_SETTINGS, "kernel_world1", CHECKPOINT, 1)
    k1, p1_loss = kernel["steps"][0]["loss"], plain["steps"][0]["loss"]
    say(f"  world 1, step 1 from flagship_v2 (B=128, N={plain['steps'][0]['n']}): plain route "
        f"loss {p1_loss:.7f}, kernel route {k1:.7f} (rel {abs(k1 - p1_loss) / abs(p1_loss):.2e}); "
        f"s/step plain {_mean_later(plain, lambda st: st['s']):.4f}, peak "
        f"{max(st.get('peak_bytes', 0) for st in plain['steps']) / 1e9:.2f} GB")
    bond1 = world_one(bond_graph2 | {"parallel": {}}, "bond_plain_world1", BOND_PREDICTOR_40K,
                      1, build=_plain_run_local, bond=True)
    one3d = world_one(mesh3d | {"parallel": {}}, "mesh3d_plain_world1", CHECKPOINT, 1,
                      build=_plain_run_local)
    # MoE on the plain route at world 1 from flagship_v2 upcycled, its expert
    # choices recorded for the 4 ranks to replay (the router's argmax is
    # discontinuous: phase 23)
    moe_ckpt = upcycled_checkpoint(device)
    with RoutePins(10 ** 9) as pins:
        moe1 = world_one(moe3d | {"parallel": {}}, "moe_mesh3d_plain_world1", moe_ckpt, 1,
                         build=_plain_run_local)
    recorded = [[c.cpu() for c in entry] for entry in pins.recorded]
    pins_path = os.path.join("outputs_torch", "chip_smoke", "moe_mesh3d_world1_routes.pt")
    torch.save(recorded, pins_path)
    t0 = time.time()
    bond_fsdp1 = world_one(bond_fsdp | {"parallel": {}}, "bond_fsdp_world1", BOND_PREDICTOR_40K,
                           1, build=bond_cli._run_local)
    wall_bond1 = time.time() - t0
    assert paths[-1] == bond_step, (paths[-1], bond_step)

    # (a) GRAPH2, TP2 and the predictor on graph 2, one process group
    t0 = time.time()
    runs = [("graph2", TRAIN_V2_CONT_GRAPH2, CHECKPOINT, AXIS_STEPS, False, None),
            ("tp2", TRAIN_V2_CONT_TP2, CHECKPOINT, AXIS_STEPS, False, None),
            ("bond_graph2", bond_graph2, BOND_PREDICTOR_40K, 1, True, None)]
    both = _axis_run(TRAIN_V2_CONT_GRAPH2, corpus, device, "axes", CHECKPOINT, AXIS_STEPS,
                     backend="gloo", check_replicas=True, build=_axes_run_local, runs=runs)
    wall_two = time.time() - t0
    outs = {name: dict(both["runs"][name], ranks=[r["runs"][name] for r in both["ranks"]])
            for name, *_ in runs}
    # (b) graph 2 x model 2 (dense and MoE) and the FSDP predictor beside a
    # pipe, four ranks in one process group
    t0 = time.time()
    runs4 = [("mesh3d", mesh3d, CHECKPOINT, 1, False, None),
             ("moe_mesh3d", moe3d, moe_ckpt, 1, False, pins_path),
             ("bond_fsdp_pipe", bond_fsdp, BOND_PREDICTOR_40K, 1, True, None)]
    four = _axis_run(mesh3d, corpus, device, "four", CHECKPOINT, 1, backend="gloo",
                     check_replicas=True, build=_axes_run_local, runs=runs4)
    wall_3d = time.time() - t0
    outs.update({name: dict(four["runs"][name], ranks=[r["runs"][name] for r in four["ranks"]])
                 for name, *_ in runs4})

    rels, norm_rels = {}, {}
    for name, ref in (("graph2", plain), ("tp2", plain), ("bond_graph2", bond1),
                      ("mesh3d", one3d), ("moe_mesh3d", moe1)):
        out = outs[name]
        settings = TRAIN_BONDPRED_V2 if name.startswith("bond") else TRAIN_SETTINGS
        for r, rank in enumerate(out["ranks"]):
            for st in rank["steps"]:
                assert st["launches"] == zero, (name, r, st["it"], st["launches"])
                assert st["replicas_equal"], (name, r, st["it"])
                check_step_terms(st, settings)
            paths.append({k: 0 for k in zero})
        rels[name], norm_rels[name] = [], []
        for k, (a, b) in enumerate(zip(out["steps"], ref["steps"])):
            assert a["it"] == b["it"] and a["n"] == b["n"], (name, a["it"], b["it"])
            rels[name].append(abs(a["loss"] - b["loss"]) / abs(b["loss"]))
            norm_rels[name].append(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
            say(f"  {name} step {a['it']} N={a['n']}: loss {a['loss']:.7f} world 1 (plain) "
                f"{b['loss']:.7f} (rel {rels[name][-1]:.2e}); grad_norm {a['grad_norm']:.6f} "
                f"world 1 {b['grad_norm']:.6f} (rel {norm_rels[name][-1]:.2e}); s/step "
                f"{a['s']:.4f} world 1 {b['s']:.4f}")
        assert len(rels[name]) == len(ref["steps"]), (name, len(out["steps"]))
        assert max(rels[name]) <= GRAPH_LOSS_RTOL, (name, rels[name])
        assert norm_rels[name][0] <= GRAPH_NORM_RTOL_1, (name, norm_rels[name])
        assert max(norm_rels[name]) <= GRAPH_NORM_RTOL, (name, norm_rels[name])
    moe_out = outs["moe_mesh3d"]
    for r, rank in enumerate(moe_out["ranks"]):
        assert all(st["loss_moe"] > 0 for st in rank["steps"]), r
        assert len(rank["route_flips"]) == len(recorded), (r, len(rank["route_flips"]))
    moe_flips = [sum(fl[j] for fl in moe_out["ranks"][0]["route_flips"])
                 for j in range(len(recorded[0]))]
    say(f"  moe_mesh3d: the free choices (first, second) that differ from world 1's replayed "
        f"ones, rank 0, over {sum(int(c[0].numel()) for c in recorded)} tokens x MoE calls: "
        f"{moe_flips}")
    # the FSDP predictor beside a pipe: the kernel route, phase 23's rules
    bond_out = outs["bond_fsdp_pipe"]
    paths += _axis_launches("bond FSDP beside pipe", bond_out, bond_step, TRAIN_BONDPRED_V2)
    for r, rank in enumerate(bond_out["ranks"]):
        assert all(st["replicas_equal"] for st in rank["steps"]), r
    rels["bond_fsdp_pipe"] = _axis_losses("bond FSDP beside pipe", bond_out, bond_fsdp1)

    # each run's params after step 1 against its world-1 run's, within the
    # one-ulp witness of that run's settings (MoE's recomputed on world 1's
    # expert choices)
    wit = {}
    plain_mesh = make_mesh_2d(1, 1, device)
    for ref_name, ref, settings, ckpt, names, mesh, replay in (
            ("world 1 plain", plain, TRAIN_SETTINGS, CHECKPOINT, ("graph2", "tp2"), plain_mesh,
             None),
            ("world 1 plain predictor", bond1, bond_graph2 | {"parallel": {}},
             BOND_PREDICTOR_40K, ("bond_graph2",), plain_mesh, None),
            ("world 1 plain B=32", one3d, mesh3d | {"parallel": {}}, CHECKPOINT, ("mesh3d",),
             plain_mesh, None),
            ("world 1 plain MoE B=32", moe1, moe3d | {"parallel": {}}, moe_ckpt,
             ("moe_mesh3d",), plain_mesh, recorded),
            ("world 1 predictor B=32", bond_fsdp1, bond_fsdp | {"parallel": {}},
             BOND_PREDICTOR_40K, ("bond_fsdp_pipe",), None, None)):
        with (RouteReplay(replay, 0) if replay else contextlib.nullcontext()):
            p1, witness = step1_witness(settings, corpus, device, mesh=mesh, checkpoint=ckpt)
        for name in names:
            wit[name] = check_step1_witness(name.upper(), _params_after(outs[name]), p1, witness)
        check_step1_witness(f"{ref_name} (run() against its recomputation)", _params_after(ref),
                            p1, witness)
    comm = {name: _comm(outs[name]) for name in ("graph2", "tp2", "mesh3d", "moe_mesh3d")}
    for name, per_rank in comm.items():
        for r, c in enumerate(per_rank):
            say(f"  {name} rank {r}: {c['s_per_step']:.4f} s/step; collectives a step: "
                + ", ".join(f"{k} {1e3 * c[k + '_s']:.1f} ms {c[k + '_bytes'] / 1e6:.1f} MB "
                            f"({c[k + '_calls']:.0f} calls)"
                            for k in ("all_gather", "reduce_scatter", "all_reduce"))
                + f", the trainer's {1e3 * c['trainer_s']:.1f} ms; peak {c['peak_gb']:.2f} GB")
    peak1 = max(st.get("peak_bytes", 0) for st in plain["steps"]) / 1e9
    step_s = lambda out: [rank["steps"][0]["s"] for rank in out["ranks"]]
    summary = {
        "world1_plain_s_per_step": _mean_later(plain, lambda st: st["s"]),
        "world1_plain_peak_gb": peak1,
        "world1_kernel_step1_loss": k1, "world1_plain_step1_loss": p1_loss,
        "loss_rel": rels, "grad_norm_rel": norm_rels, "step1_params": wit, "comm": comm,
        "peak_gb_over_world1": {name: max(c["peak_gb"] for c in per_rank) / max(peak1, 1e-9)
                                for name, per_rank in comm.items() if "mesh3d" not in name},
        "mesh3d_s": step_s(outs["mesh3d"]), "moe_mesh3d_s": step_s(moe_out),
        "moe_world1_plain_s": moe1["steps"][0]["s"], "dense_world1_plain_b32_s":
        one3d["steps"][0]["s"], "moe_mesh3d_flips_rank0": moe_flips,
        "bond_fsdp_pipe_s": step_s(bond_out), "bond_fsdp_pipe_comm_s":
        [rank["steps"][0]["comm_s"] for rank in bond_out["ranks"]],
        "bond_world1_s": bond_fsdp1["steps"][0]["s"],
        "walls_s": {"plain_world1": wall_plain, "graph2_tp2_bond": wall_two,
                    "four_ranks": wall_3d, "bond_world1": wall_bond1},
        "card": nvidia_smi()}
    say(f"graph/model axes: GRAPH2 {comm['graph2'][0]['s_per_step']:.4f} s/step, TP2 "
        f"{comm['tp2'][0]['s_per_step']:.4f}, world 1 plain {summary['world1_plain_s_per_step']:.4f}"
        f"; peak a rank GRAPH2 {summary['peak_gb_over_world1']['graph2']:.2f}x, TP2 "
        f"{summary['peak_gb_over_world1']['tp2']:.2f}x world 1's {peak1:.2f} GB")
    say(f"graph 2 x model 2 at B={MESH3D_BATCH}, rank 0's step: dense {summary['mesh3d_s'][0]:.4f} "
        f"s, MoE {summary['moe_mesh3d_s'][0]:.4f} s (world 1 plain: dense "
        f"{summary['dense_world1_plain_b32_s']:.4f}, MoE {summary['moe_world1_plain_s']:.4f}); "
        f"the predictor with FSDP beside pipe {summary['bond_fsdp_pipe_s'][0]:.4f} s "
        f"(collectives {1e3 * summary['bond_fsdp_pipe_comm_s'][0]:.1f} ms) against world 1's "
        f"{summary['bond_world1_s']:.4f} s")
    say(f"phase 24 (graph and model axes): {time.time() - t_phase:.1f} s")
    say(json.dumps({"graph_model_axes": summary}))
    return paths


# phase 25: one POOL_STEPS-step commit-both chain of flagship_v2 at batch
# POOL_BATCH (two chains: one a bucket), classified serially and through a
# pool of POOL_WORKERS spawned processes, twice (the first pass pays the
# workers' start-up); the guidance-scale sweep's main() on flagship_v2 and
# bondpred_v2 with SWEEP_ARGS, its JSON holding SWEEP_KEYS
POOL_BATCH = 64
POOL_STEPS = 100
SWEEP_ARGS = ("--scales", "1e-4", "--skip_unguided", "--num_steps", "100", "--num_mols", "8",
              "--batch_size", "16")
SWEEP_KEYS = ("bp_ckpt", "ckpt", "ckpt_step", "mode", "num_mols", "num_steps", "runs", "seed")


def check_pool_and_sweep(cli, results: dict, dn_blocks: int, bp_blocks: int, device) -> list:
    """Phase 25: (a) POOL_BATCH molecules of a POOL_STEPS-step commit-both
    chain of flagship_v2 (MolSampler.sample_sizes; each forward kernel's
    launches per call x blocks x steps x chains), classified serially, then
    through a pool of POOL_WORKERS twice: every pass's entries (pool,
    reason, SMILES, stage) equal in order; molecules a second each way and
    the pool's start-up seconds (its first pass less its second) printed;
    (b) the sweep's main() with SWEEP_ARGS and the pool: the JSON it writes
    is its return value and holds SWEEP_KEYS, one run at the one scale
    that stopped where generate() stops, its interval around its rate;
    the launches are a guided step's (phase 8's rule) x steps. -> the launch counts of (a) and (b)."""
    import numpy as np
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.sample import classify, sweep

    t_phase = time.time()
    scfg = with_sample(SAMPLE_SETTINGS, commit="both", num_steps=POOL_STEPS)["sample"]
    sampler, params = cli.build_sampler(CHECKPOINT, scfg, device, batch_size=POOL_BATCH)
    seed = int(scfg["seed"])
    kernels.reset_launch_counts()
    decoded = sampler.sample_sizes(params, sampler.draw_sizes(POOL_BATCH,
                                                              np.random.default_rng(seed)),
                                   torch.Generator(device=device).manual_seed(seed))
    counts = dict(kernels.launch_counts)
    expected = forward_expected(results, dn_blocks * POOL_STEPS * sampler.chains)
    assert counts == expected, (counts, expected)
    key = lambda e: (e["pool"], e.get("reason"), e.get("smiles"), e.get("stage"))
    t0 = time.perf_counter()
    serial = classify.classify_batch(decoded, sampler.add_edge, None, sampler.sanitize_mode)
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    workers = classify.make_classify_pool(POOL_WORKERS)
    try:
        cold = classify.classify_batch(decoded, sampler.add_edge, workers, sampler.sanitize_mode)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = classify.classify_batch(decoded, sampler.add_edge, workers, sampler.sanitize_mode)
        warm_s = time.perf_counter() - t0
    finally:
        workers.shutdown()
    assert [key(e) for e in cold] == [key(e) for e in serial] == [key(e) for e in warm]
    n = len(decoded)
    pool = {"molecules": n, "chains": sampler.chains, "finished": sum(e["pool"] == "finished"
                                                                      for e in serial),
            "workers": POOL_WORKERS, "cpus": os.cpu_count(), "serial_s": serial_s,
            "pooled_cold_s": cold_s, "pooled_warm_s": warm_s,
            "serial_mols_per_s": n / serial_s, "pooled_mols_per_s": n / warm_s,
            "startup_s": cold_s - warm_s}
    say(f"pool: {n} molecules of a {POOL_STEPS}-step commit-both chain ({pool['finished']} "
        f"finished): serial {serial_s:.3f} s ({pool['serial_mols_per_s']:.2f} mols/s, "
        f"{1e3 * serial_s / n:.1f} ms a molecule); {POOL_WORKERS} workers ({os.cpu_count()} "
        f"CPUs) first pass {cold_s:.3f} s, second {warm_s:.3f} s ({pool['pooled_mols_per_s']:.2f}"
        f" mols/s, {serial_s / warm_s:.2f}x serial); start-up {pool['startup_s']:.3f} s; the "
        "entries of all three passes equal in order")

    # (b) the sweep through its entry point
    out_path = os.path.join("outputs_torch", "chip_smoke", "sweep_flagship_v2.json")
    kernels.reset_launch_counts()
    t0 = time.time()
    res = sweep.main(["--ckpt", CHECKPOINT, "--bp_ckpt", BOND_PREDICTOR, *SWEEP_ARGS,
                      "--recon_workers", str(POOL_WORKERS), "--out", out_path],
                     log=lambda m: say(f"  {m}"))
    sweep_s = time.time() - t0
    s_counts = dict(kernels.launch_counts)
    per_step = guided_expected(results, dn_blocks, bp_blocks, 1)
    steps = s_counts["pos_update"] // per_step["pos_update"]
    assert steps > 0 and steps % POOL_STEPS == 0, (s_counts, per_step)
    assert s_counts == guided_expected(results, dn_blocks, bp_blocks, steps), s_counts
    with open(out_path) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(res)), "the sweep's JSON is not its result"
    assert tuple(sorted(on_disk)) == SWEEP_KEYS, sorted(on_disk)
    assert list(on_disk["runs"]) == ["uncertainty@0.0001"], list(on_disk["runs"])
    run = on_disk["runs"]["uncertainty@0.0001"]
    lo, hi = run["ci95"]
    # generate() stops at num_mols finished or past 3 x num_mols failed
    assert run["finished"] == 8 or run["failed"] > 24, run
    assert lo <= run["success"] <= hi, run
    summary = {"pool": pool, "sweep": {"wall_s": sweep_s, "chains": steps // POOL_STEPS,
                                       "run": run}, "card": nvidia_smi()}
    say(f"sweep: {steps // POOL_STEPS} guided chains of {POOL_STEPS} steps at batch 16, success "
        f"{run['success']:.4f} [{lo:.4f}, {hi:.4f}] ({run['finished']} finished, "
        f"{run['failed']} failed: {run['failure_modes']}), {sweep_s:.1f} s")
    say(f"phase 25 (classification pool and sweep): {time.time() - t_phase:.1f} s")
    say(json.dumps({"pool_and_sweep": summary}))
    return [counts, s_counts]


def copy_settings(settings: dict, **train) -> dict:
    """A copy of ``settings`` with ``train`` set on its train section."""
    import copy

    out = copy.deepcopy(settings)
    out["train"].update(train)
    return out


def bond_gate_eval(out: dict, settings: dict, corpus: dict, device) -> bool:
    """bondpred_demo_scratch: the port's final predictor and the committed
    DEMO_BONDPRED_4K on every validation molecule (batch 128, the config's
    buckets), the same noise for both under each of BONDPRED_EVAL_SEEDS;
    prints both means and returns whether the port meets the bars."""
    import torch

    from moldiff_tpu_torch.data.loader import BucketedLoader
    from moldiff_tpu_torch.train.trainer import batch_to_device
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint

    committed = load_checkpoint(DEMO_BONDPRED_4K, device)
    assert committed["step"] == TRAIN_GATE_STEPS and committed["config"]["model"] == \
        settings["model"], committed["config"]
    trainer = out["trainer"]
    models = {"port": out["state"].params, "committed": committed["params"]}
    terms = {k: {"loss": [], "acc_bond": []} for k in models}
    n_mols = 0
    for seed in BONDPRED_EVAL_SEEDS:
        gen = torch.Generator(device=device).manual_seed(seed)
        loader = BucketedLoader(corpus["val"], featurizer(settings),
                                settings["train"]["batch_size"], settings["train"]["buckets"],
                                shuffle=False, infinite=False, drop_last=False, prefetch=0)
        for vb in loader:
            batch = batch_to_device(vb, device)
            n_mols += int((batch["node_mask"].sum(1) > 0).sum()) if seed == 0 else 0
            noise = trainer.draw_noise(batch, gen)
            for k, params in models.items():
                aux = trainer.eval_step(params, batch, noise)
                for t in terms[k]:
                    terms[k][t].append(float(aux[t]))
    mean = {k: {t: statistics.mean(v) for t, v in d.items()} for k, d in terms.items()}
    passed = (mean["port"]["loss"] <= BONDPRED_LOSS_RATIO * mean["committed"]["loss"]
              and mean["port"]["acc_bond"] >= mean["committed"]["acc_bond"] - BONDPRED_ACC_DROP)
    say(f"bond predictors on the validation split ({n_mols} molecules, "
        f"{len(terms['port']['loss']) // len(BONDPRED_EVAL_SEEDS)} batches, seeds "
        f"{BONDPRED_EVAL_SEEDS}): port loss {mean['port']['loss']:.4f} acc_bond "
        f"{mean['port']['acc_bond']:.4f}; committed {DEMO_BONDPRED_4K} loss "
        f"{mean['committed']['loss']:.4f} acc_bond {mean['committed']['acc_bond']:.4f}; bars: "
        f"loss <= {BONDPRED_LOSS_RATIO} x, acc_bond >= committed - {BONDPRED_ACC_DROP}: "
        f"{'pass' if passed else 'miss'}")
    return passed


def run_train_gate(name: str, corpus: dict, device) -> None:
    """--train-gate NAME: TRAIN_GATES[NAME] from scratch for TRAIN_GATE_STEPS
    steps through the train or bond CLI's run(); every step launches what
    the first does (the kernels of its route, none other) and every loss
    is finite; then the gate's comparison with JAX. Fails on a miss, after
    printing it."""
    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import bond_cli
    from moldiff_tpu_torch.train import cli as train_cli

    settings = TRAIN_GATES[name]
    is_bond = settings["model"]["name"] == "bond_predictor"
    run = bond_cli.run if is_bond else train_cli.run
    t0 = time.time()
    kernels.reset_launch_counts()
    out = run(settings, None, device=device, logdir=os.path.join("outputs_torch", "chip_smoke"),
              name=f"gate_{name}", max_iters=TRAIN_GATE_STEPS, subsets=corpus,
              log=lambda m: say(f"  {m}"))
    wall = time.time() - t0
    counts = dict(kernels.launch_counts)
    first = out["steps"][0]["launches"]
    assert {k for k, v in first.items() if v} == set(train_kernels(settings)), first
    assert all(st["launches"] == first for st in out["steps"])
    # the validation batches add forward launches only
    steps = len(out["steps"])
    assert all(counts[k] == v * steps if k.endswith("_bwd") else counts[k] >= v * steps
               for k, v in first.items()), counts
    for st in out["steps"]:
        check_step_terms(st, settings)
    by_bucket = {}
    for st in out["steps"][1:]:
        by_bucket.setdefault(st["n"], []).append(st["s"])
    s_step = {n: round(statistics.mean(v), 5) for n, v in sorted(by_bucket.items())}
    say(f"gate {name}: {len(out['steps'])} steps from scratch at batch "
        f"{settings['train']['batch_size']}, s/step by bucket (steps) {s_step} "
        f"({ {n: len(v) for n, v in sorted(by_bucket.items())} }), wall {wall:.1f} s, launches "
        f"per step {first}")
    if is_bond:
        passed = bond_gate_eval(out, settings, corpus, device)
    else:
        port = {v["it"]: v["loss"] for v in out["val"]}
        assert sorted(port) == sorted(JAX_DEMO30K_VAL), sorted(port)
        for it, want in sorted(JAX_DEMO30K_VAL.items()):
            say(f"  val loss at {it}: port {port[it]:.4f} JAX {want:.4f}")
        mean_p = statistics.mean(port.values())
        mean_j = statistics.mean(JAX_DEMO30K_VAL.values())
        passed = abs(mean_p - mean_j) <= DEMO_VAL_MEAN_TOL
        say(f"gate {name}: mean val loss port {mean_p:.4f} JAX {mean_j:.4f} (bar: within "
            f"{DEMO_VAL_MEAN_TOL}): {'pass' if passed else 'miss'}")
    assert passed, f"train gate {name}: missed its bar"


def run_gate(cli, name: str, num_mols: int, batch_size: int, device) -> None:
    """--gate NAME: run() with gate_settings(NAME) until ``num_mols``
    finished at ``batch_size``; its launches are one reverse step's (with
    the same settings) x steps x chains."""
    settings = gate_settings(name)
    sampler, params = cli.build_sampler(settings["model"]["checkpoint"], settings["sample"],
                                        device, batch_size,
                                        bond_predictor=settings.get("bond_predictor"))
    per_step = step_launches(sampler, params, device)
    summary, counts = run_path(cli, settings, num_mols, batch_size, f"gate_{name}_{num_mols}")
    steps = summary["num_steps"]
    expected = {k: v * steps * summary["chains"] for k, v in per_step.items()}
    say(f"gate {name} {GATES[name]}: {summary['chains']} chains x {steps} steps, launches "
        f"{counts}, expected {expected}")
    assert counts == expected, (counts, expected)
    assert any(expected[k] for k in FORWARD_KERNELS)
    report(f"gate {name}", summary, steps)


def validity_interval(metrics_dir: str) -> tuple:
    """(complete, classified, lo, hi) of a validity.json: the molecules
    complete of all classified and their Wilson 95 % interval."""
    from moldiff_tpu_torch.sample.cli import wilson_interval

    with open(os.path.join(metrics_dir, "validity.json")) as f:
        v = json.load(f)
    n = v["n_complete"] + v["n_disconnect"] + v["n_invalid"]
    return (v["n_complete"], n) + tuple(wilson_interval(v["n_complete"], n))


def mean_se(values) -> tuple:
    """Mean and standard error (sample standard deviation / sqrt n)."""
    values = [float(v) for v in values]
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(len(values))


def compare_with_bar(port_dir: str, bar_dir: str) -> dict:
    """--eval-gate's rule on two metric directories (the port's and the
    bar's: validity.json and mols.csv, read with csv and json): each check
    and whether all passed."""
    from moldiff_tpu_torch.eval.analyze import read_metrics_csv

    k, n, lo, hi = validity_interval(port_dir)
    bk, bn, blo, bhi = validity_interval(bar_dir)
    out = {"success": {"port": [k, n, lo, hi], "jax": [bk, bn, blo, bhi],
                       "ok": lo <= bhi and blo <= hi}}
    say(f"success: port {k}/{n} = {k / n:.4f} [{lo:.4f}, {hi:.4f}], JAX {bk}/{bn} = "
        f"{bk / bn:.4f} [{blo:.4f}, {bhi:.4f}]: {'overlap' if out['success']['ok'] else 'MISS'}")
    port = read_metrics_csv(os.path.join(port_dir, "mols.csv"))
    bar = read_metrics_csv(os.path.join(bar_dir, "mols.csv"))
    for col in EVAL_GATE_COLUMNS:
        (mp, sp), (mb, sb) = mean_se(port[col]), mean_se(bar[col])
        if sp == 0 and sb == 0:
            # zero (or constant) in every row on both sides: equal means
            z = 0.0 if mp == mb else math.inf
        else:
            z = (mp - mb) / math.sqrt(sp * sp + sb * sb)
        ok = abs(z) <= EVAL_GATE_Z
        out[col] = {"port": [mp, sp], "jax": [mb, sb], "z": z, "ok": ok}
        say(f"  {col}: port {mp:.4f} (SE {sp:.4f}), JAX {mb:.4f} (SE {sb:.4f}), z {z:+.2f}: "
            f"{'ok' if ok else 'MISS'}")
    out["passed"] = all(v["ok"] for v in out.values())
    return out


def check_eval(cli, results: dict, blocks: int) -> dict:
    """Phase 19: the sample CLI's run() with SAMPLE_DEMO until
    EVAL_NUM_MOLS finished at batch EVAL_BATCH (rows 1, 4 and 8 launched
    per call x 4 blocks x 200 steps x chains, none of the others); then the
    eval CLI's main on its output directory (every family but global_3d;
    similarity against EVAL_CORPUS's train and val splits) and on
    EVAL_CORPUS's test split, and analyze on the two. Every output file
    exists and validity.json holds summary.json's counts; the empty rows
    of each family and the host seconds per molecule are printed."""
    from moldiff_tpu_torch.eval import analyze, evaluate
    from moldiff_tpu_torch.ops import kernels

    summary, counts = run_path(cli, SAMPLE_DEMO, EVAL_NUM_MOLS, EVAL_BATCH, "demo_eval")
    steps = summary["num_steps"]
    expected = forward_expected(results, blocks * steps * summary["chains"])
    say(f"demo sampling: {summary['chains']} chains x {steps} steps, launches {counts}, "
        f"expected {expected}")
    assert (blocks, steps) == (4, 200), (blocks, steps)
    assert counts == expected, (counts, expected)
    kernels.reset_launch_counts()
    assert summary["num_finished"] >= EVAL_NUM_MOLS
    report("demo sampling", summary, steps)

    out_dir = os.path.join("outputs_torch", "chip_smoke", "demo_eval")
    root, n_corpus = EVAL_CORPUS
    gen = evaluate.main(["--root", out_dir, "--dataset_root", root,
                         "--corpus_mols", str(n_corpus)])
    ref_dir = os.path.join("outputs_torch", "chip_smoke", "demo_eval_test_split")
    ref = evaluate.main(["--from_where", "dataset", "--dataset_root", root, "--split", "test",
                         "--corpus_mols", str(n_corpus), "--outdir", ref_dir, "--force"])
    table = os.path.join(out_dir, "metrics_all_methods.csv")
    rows = analyze.main(["--ref", ref_dir, "--methods", f"port={gen['out_dir']}",
                         "--out", table])
    for d, names in ((gen["out_dir"], EVAL_FILES + ("similarity.json",)),
                     (ref_dir, EVAL_SPLIT_FILES)):
        for name in names:
            assert os.path.exists(os.path.join(d, name)), (d, name)
    assert os.path.exists(table)
    k, n, _, _ = validity_interval(gen["out_dir"])
    assert (k, n) == (summary["num_finished"], summary["num_finished"] + summary["num_failed"]), \
        (k, n, summary)
    for tag, rep in (("generated", gen), ("test split", ref)):
        for family, idx in rep["empty_rows"].items():
            say(f"eval {tag}: {family}: {len(idx)} empty rows {idx}")
        score_s = rep["seconds"] - rep["load_s"] - rep["similarity_s"]
        say(f"eval {tag}: {rep['num_mols']} molecules, {score_s:.3f} s host time scoring "
            f"({score_s / max(rep['num_mols'], 1):.4f} s/molecule), {rep['load_s']:.3f} s "
            f"reading or making them, {rep['similarity_s']:.3f} s similarity")
    say(f"analyze: {json.dumps(rows)}")
    return counts


def start_eval_reference(name: str):
    """--eval-gate: the eval CLI on EVAL_GATE_CORPUS's whole test split, in
    a process of its own (its own worker pool, no CUDA context) while the
    kernels build and the chains run; (process, metrics dir)."""
    out = os.path.join("outputs_torch", "chip_smoke", f"eval_gate_{name}_test_split")
    proc = subprocess.Popen([sys.executable, "-m", "moldiff_tpu_torch.eval", "--from_where",
                             "dataset", "--dataset_root", EVAL_GATE_CORPUS, "--split", "test",
                             "--outdir", out, "--force", "--parallel"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def run_eval_gate(cli, name: str, device, reference) -> None:
    """--eval-gate NAME: run() with EVAL_GATES[NAME]'s settings as written
    (its launches one reverse step's x steps x chains), the eval CLI on its
    output, compare_with_bar against the bar's directory, then analyze on
    both against the test split's metrics."""
    from moldiff_tpu_torch.eval import analyze, evaluate

    settings, bar_dir = EVAL_GATES[name]
    batch = settings["sample"]["batch_size"]
    sampler, params = cli.build_sampler(settings["model"]["checkpoint"], settings["sample"],
                                        device, batch)
    per_step = step_launches(sampler, params, device)
    summary, counts = run_path(cli, settings, None, batch, f"eval_gate_{name}")
    steps = summary["num_steps"]
    expected = {k: v * steps * summary["chains"] for k, v in per_step.items()}
    say(f"eval gate {name}: {summary['chains']} chains x {steps} steps, launches {counts}, "
        f"expected {expected}")
    assert counts == expected, (counts, expected)
    assert any(expected[k] for k in FORWARD_KERNELS)
    report(f"eval gate {name}", summary, steps)
    out_dir = os.path.join("outputs_torch", "chip_smoke", f"eval_gate_{name}")
    gen = evaluate.main(["--root", out_dir])
    score_s = gen["seconds"] - gen["load_s"]
    say(f"eval gate {name}: {gen['num_mols']} molecules scored in {score_s:.3f} s "
        f"({score_s / max(gen['num_mols'], 1):.4f} s/molecule); empty rows "
        f"{ {f: len(i) for f, i in gen['empty_rows'].items()} }")
    result = compare_with_bar(gen["out_dir"], bar_dir)
    proc, ref_dir = reference
    t0 = time.time()
    log, _ = proc.communicate(timeout=900)
    say(f"test split metrics (ready {time.time() - t0:.1f} s after the port's): "
        + " | ".join(log.strip().splitlines()[-3:]))
    assert proc.returncode == 0, log[-3000:]
    rows = analyze.main(["--ref", ref_dir, "--methods", f"port={gen['out_dir']}",
                         f"jax={bar_dir}", "--out", os.path.join(out_dir, "metrics_all_methods.csv")])
    for col in COUNT_PROPS:
        say(f"  jsd_{col} against the test split: port {rows['port'][f'jsd_{col}']:.4f}, "
            f"JAX {rows['jax'][f'jsd_{col}']:.4f}")
    say(json.dumps({"eval_gate": name, "result": result, "analyze": rows}))
    say(f"eval gate {name}: {'pass' if result['passed'] else 'miss'}")
    assert result["passed"], f"eval gate {name}: missed its bar"


def report(tag: str, summary: dict, steps: int) -> None:
    chains = summary["chains"]
    say(f"{tag}: success {summary['success_rate']:.4f} (Wilson 95% "
        f"[{summary['success_wilson95'][0]:.4f}, {summary['success_wilson95'][1]:.4f}], "
        f"{summary['num_finished']} finished of {summary['num_finished'] + summary['num_failed']}"
        f"); over all {summary['num_classified']} classified "
        f"{summary['success_rate_classified']:.4f} [{summary['success_wilson95_classified'][0]:.4f}"
        f", {summary['success_wilson95_classified'][1]:.4f}]; s/step "
        f"{summary['chain_s'] / (chains * steps):.5f} mols/s {summary['mols_per_s']:.4f} "
        f"wall {summary['wall_s']:.1f} s")
    say(json.dumps(summary))


def main() -> None:
    ap = argparse.ArgumentParser(description="smoke run of moldiff_tpu_torch on the card")
    ap.add_argument("--num-mols", type=int, default=8,
                    help="molecules the sampling phase generates (finished)")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="molecules per reverse chain in the sampling phase")
    ap.add_argument("--guided-num-mols", type=int, default=8,
                    help="molecules the guided sampling phase generates (finished)")
    ap.add_argument("--guided-batch-size", type=int, default=16,
                    help="molecules per reverse chain in the guided sampling phase")
    ap.add_argument("--fuse-num-mols", type=int, default=8,
                    help="molecules path B's sampling (fuse_block) generates (finished)")
    ap.add_argument("--fuse-batch-size", type=int, default=16,
                    help="molecules per reverse chain in path B's sampling")
    ap.add_argument("--gate", choices=sorted(GATES), default=None,
                    help="run only this gate (after the build): its settings until "
                         "--gate-num-mols finished at --gate-batch-size")
    ap.add_argument("--train-gate", choices=sorted(TRAIN_GATES), default=None,
                    help="run only this training check (after the build): TRAIN_GATES[NAME] "
                         "from scratch for TRAIN_GATE_STEPS steps, against JAX's run")
    ap.add_argument("--eval-gate", choices=sorted(EVAL_GATES), default=None,
                    help="run only this evaluation check (after the build): EVAL_GATES[NAME]'s "
                         "settings as written, scored and held to the JAX package's scores")
    ap.add_argument("--gate-num-mols", type=int, default=1000)
    ap.add_argument("--gate-batch-size", type=int, default=128)
    ap.add_argument("--budget-s", type=float, default=1050.0,
                    help="wall-clock budget; the run is stopped with a traceback after it "
                         "(the default ends a hang inside a 1200 s call)")
    args = ap.parse_args()
    faulthandler.dump_traceback_later(args.budget_s, exit=True)
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr, flush=True)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "moldiff_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr, flush=True)
        sys.exit(2)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moldiff_tpu_torch.ops import build, kernels
    from moldiff_tpu_torch.sample import cli
    device = torch.device("cuda", 0)
    assert "jax" not in sys.modules and "moldiff_tpu" not in sys.modules

    # the corpora of phases 10 and 18 (or of a training gate), made by worker
    # processes while the kernels build
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    if args.train_gate:
        gate_corpus_job = pool.submit(_make_corpus, TRAIN_GATE_CORPUS)
    elif args.eval_gate:
        eval_reference = start_eval_reference(args.eval_gate)
    elif not args.gate:
        corpus_jobs = start_corpus(pool)
        scratch_job = pool.submit(_make_corpus, (TRAIN_FULL_SYNTHETIC_XL_SCRATCH["dataset"]["root"],
                                                 SCRATCH_CORPUS_MOLS))
        store_jobs = start_store(pool)

    # 1. environment
    smi = nvidia_smi()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    say(f"card: {smi}")
    # what the eval slice will need (printed only): does each module import here?
    for module in ("scipy", "yaml"):
        probe = subprocess.run([sys.executable, "-c", f"import {module}; print({module}.__version__)"],
                               capture_output=True, text=True, timeout=120)
        say(f"import {module}: " + (f"yes, {probe.stdout.strip()}" if probe.returncode == 0
                                    else "no (" + (probe.stderr.strip().splitlines() or ["?"])[-1]
                                    + ")"))

    # 2. build
    t0 = time.time()
    build.library()
    say(f"build: {time.time() - t0:.1f} s")
    kernel = "?"
    for line in "".join(build.build_log).splitlines():
        found = re.search(r"Compiling entry function '.*?\d+([A-Za-z_]+_kernel)", line)
        kernel = found.group(1) if found else kernel
        if "registers" in line or "spill" in line:
            say(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")

    if args.gate or args.train_gate or args.eval_gate:
        if args.gate:
            run_gate(cli, args.gate, args.gate_num_mols, args.gate_batch_size, device)
        elif args.eval_gate:
            run_eval_gate(cli, args.eval_gate, device, eval_reference)
        else:
            t0 = time.time()
            corpus = gate_corpus_job.result(timeout=900)
            say(f"corpus {TRAIN_GATE_CORPUS}: {len(corpus['train'])} train, {len(corpus['val'])} "
                f"val (ready {time.time() - t0:.1f} s after the build)")
            run_train_gate(args.train_gate, corpus, device)
        pool.shutdown()
        say(f"total {time.time() - t_start:.1f} s")
        say(nvidia_smi())
        faulthandler.cancel_dump_traceback_later()
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return

    # 3. kernel checks at flagship widths, then the demo denoiser's; block-0 weights
    sampler, params = cli.build_sampler(CHECKPOINT, SAMPLE_SETTINGS["sample"], device)
    model = sampler.model
    blk0 = model.prepare(params)[0]
    d_sampler, d_params = cli.build_sampler(DEMO_CHECKPOINT, SAMPLE_SETTINGS["sample"], device)
    d_blk0 = d_sampler.model.prepare(d_params)[0]
    results = check_kernels(blk0, d_blk0, device)

    # 4. one full forward, kernels against plain versions
    check_forward(model, params, device)

    # 5. the main path: the sample CLI's run()
    summary, counts = run_path(cli, SAMPLE_SETTINGS, args.num_mols, args.batch_size,
                               f"flagship_v2_{args.num_mols}")
    chains = summary["chains"]
    steps = model.num_timesteps
    calls = model.denoiser_static["num_blocks"] * steps * chains
    expected = {name: results[name]["per_call"] * calls if name in FORWARD_KERNELS else 0
                for name in KERNELS}
    say(f"sampling: {chains} chains x {steps} steps, launches {counts}, expected {expected}")
    assert counts == expected, (counts, expected)
    kernels.reset_launch_counts()   # the checks below are not a main path
    assert summary["num_finished"] >= args.num_mols
    # the rate over every molecule classified: at a few molecules the JAX
    # CLI's rate (finished cut to num_mols) reads low
    assert summary["success_rate_classified"] >= 0.25, summary
    report("sampling", summary, steps)

    # 6. the backward kernels at the predictor's widths, block-0 weights,
    # then at the demo pair's
    bp, bp_params = cli.load_bond_predictor(BOND_PREDICTOR, sampler.featurizer, device)
    bp_blk0 = bp.prepare(bp_params)[0]
    d_bp, d_bp_params = cli.load_bond_predictor(DEMO_BOND_PREDICTOR, d_sampler.featurizer, device)
    demo = (d_bp.prepare(d_bp_params)[0], d_blk0)
    results.update(check_backward(bp_blk0, blk0, demo, device))

    # 7. the guidance gradient, kernels against plain versions
    check_gradient(model, bp, bp_params, device)
    say(f"launches made by the checks (not counted below): {kernels.launch_counts}")

    # 8. the guided path: the sample CLI's run() with the bond predictor
    g_summary, g_counts = run_path(cli, GUIDED_SETTINGS, args.guided_num_mols,
                                   args.guided_batch_size, f"flagship_v2_guided_"
                                   f"{args.guided_num_mols}")
    g_chains = g_summary["chains"]
    dn_blocks = model.denoiser_static["num_blocks"]
    bp_blocks = bp.encoder_static["num_blocks"]
    g_expected = guided_expected(results, dn_blocks, bp_blocks, steps * g_chains)
    say(f"guided sampling: {g_chains} chains x {steps} steps, launches {g_counts}, "
        f"expected {g_expected}")
    assert g_counts == g_expected, (g_counts, g_expected)
    kernels.reset_launch_counts()
    assert g_summary["num_finished"] >= args.guided_num_mols
    assert g_summary["success_rate_classified"] >= 0.25, g_summary
    report("guided sampling", g_summary, steps)

    # 9. the training gradient, kernels against plain versions
    corpus = collect_corpus(corpus_jobs)
    scratch_corpus = scratch_job.result(timeout=300)
    pool.shutdown()
    check_train_gradient(params, corpus["train"], device, TRAIN_SETTINGS)
    say(f"launches made by the checks (not counted below): {kernels.launch_counts}")

    # 10. the training path: the train CLI's run() from flagship_v2
    t_counts, t_s_step = fine_tune(corpus, results, device, TRAIN_SETTINGS)

    # 11. the six kernels at the fine-tuning shape, against plain versions
    check_train_kernels(params, corpus["train"], results, device, TRAIN_SETTINGS,
                        TRAIN_ROUTES["partial"])

    # 12. path B: the whole-block kernel (fuse_block) on flagship_v2's
    # sampling path and in one fine-tuning step
    t0 = time.time()
    f_sampler, _ = cli.build_sampler(CHECKPOINT, FUSE_SETTINGS["sample"], device,
                                     denoiser=FUSE_SETTINGS["model"]["denoiser"])
    f_model = f_sampler.model
    assert f_model.denoiser_static["fuse_block"]
    check_forward(f_model, params, device)
    f_summary, f_counts = run_path(cli, FUSE_SETTINGS, args.fuse_num_mols, args.fuse_batch_size,
                                   f"flagship_v2_fuse_block_{args.fuse_num_mols}")
    f_calls = dn_blocks * steps * f_summary["chains"]
    f_expected = {name: results[name]["per_call"] * f_calls if name == "fused_block" else 0
                  for name in KERNELS}
    say(f"fuse_block sampling: {f_summary['chains']} chains x {steps} steps, launches "
        f"{f_counts}, expected {f_expected}")
    assert f_counts == f_expected, (f_counts, f_expected)
    kernels.reset_launch_counts()
    assert f_summary["num_finished"] >= args.fuse_num_mols
    assert f_summary["success_rate_classified"] >= 0.25, f_summary
    report("fuse_block sampling", f_summary, steps)
    check_fused_state(f_model, params, results, device)
    fb_counts, _ = fine_tune(corpus, results, device,
                             with_denoiser(TRAIN_SETTINGS, fuse_block=True), steps_per_bucket=0)
    say(f"phase 12 (path B, fuse_block): {time.time() - t0:.1f} s")

    # 13. path A: the full-EdgeBlock kernels (edge_full) on fine-tuning
    t0 = time.time()
    edge_full = with_denoiser(TRAIN_SETTINGS, edge_full=True)
    e_counts, _ = fine_tune(corpus, results, device, edge_full)
    check_train_gradient(params, corpus["train"], device, edge_full)
    check_train_kernels(params, corpus["train"], results, device, edge_full,
                        ("edge_block_full", "edge_block_full_bwd"))
    ws = build.library().md_edge_block_full_backward_workspace(128, 40, 256, 64, 128, 32)
    say(f"row 7's workspace at B=128 N=40, flagship widths: {ws / 1e9:.3f} GB")
    say(f"phase 13 (path A, edge_full): {time.time() - t0:.1f} s")

    # 14. the persistent kernels at other grid sizes, bit for bit
    t0 = time.time()
    check_grid_invariance(blk0, d_blk0, device)
    say(f"phase 14 (grid-size invariance): {time.time() - t0:.1f} s")

    # 15. the sampler's modes: respaced, DDIM, edge commit, EMA, trajectories
    t0 = time.time()
    m_counts = check_modes_run(cli, results, dn_blocks)
    say(f"phase 15 (sampler modes): {time.time() - t0:.1f} s")

    # 16. the sampling server over HTTP
    t0 = time.time()
    s_counts = check_server(results, dn_blocks, device)
    say(f"phase 16 (server): {time.time() - t0:.1f} s")

    # 17. the bond predictor's training: the bond CLI from bondpred_40k, and
    # its loss and gradient, kernels against plain versions
    t0 = time.time()
    b_counts = check_bond_training(corpus, results, device)
    say(f"phase 17 (bond predictor training): {time.time() - t0:.1f} s")

    # 18. training from scratch at the flagship widths, async and pruned
    # checkpoints, and one grad_accum step
    t0 = time.time()
    x_counts, a_counts = train_from_scratch(scratch_corpus, results, device)
    say(f"phase 18 (training from scratch): {time.time() - t0:.1f} s")

    # 19. scoring: the demo denoiser's samples through the eval and analyze
    # CLIs
    t0 = time.time()
    v_counts = check_eval(cli, results, d_sampler.model.denoiser_static["num_blocks"])
    say(f"phase 19 (evaluation): {time.time() - t0:.1f} s")

    # 20. the data path: training fed from a record store built by the
    # native SDF parser, its run records, scoring input from the store, and
    # the reference-checkpoint round trip
    r_counts, rr_counts = train_from_store(results, model, params, store_jobs, device)

    # 21. the model variants (MoE, the continuous categorical space, ungated
    # blocks) at flagship width from a seed, beside the dense model's times
    dense = {"sample_s": summary["chain_s"] / (steps * chains), "train_s": t_s_step}
    variant_counts = check_variants(cli, corpus, results, device, dense, params)

    # 22. the data axis: data-parallel and FSDP training (2 ranks on the one
    # card over gloo), NCCL at world size 1, sharded checkpoints, sampling
    # sharded over 2 processes
    data_counts = check_data_axis(corpus, results, device)

    # 23. the pipe and expert axes: GPipe over the stacked blocks, MoE's
    # expert banks over 2 ranks and MoE on 2 data ranks (2 ranks on the one
    # card over gloo), the pipeline through NCCL at world size 1
    axis_counts = check_pipe_expert_axes(corpus, results, device)

    # 24. the graph and model axes: JAX's plain route with the pair tensors
    # split by receiver and the MLPs split (2 and 4 ranks on the one card
    # over gloo), against world size 1 on the plain route
    graph_counts = check_graph_model_axes(corpus, results, device)

    # 25. the host classification pool (serial against pooled on one
    # chain's molecules) and the guidance-scale sweep's entry point
    pool_counts = check_pool_and_sweep(cli, results, dn_blocks, bp_blocks, device)

    main_paths = (counts, g_counts, t_counts, f_counts, fb_counts, e_counts, m_counts, s_counts,
                  b_counts, x_counts, a_counts, v_counts, r_counts, rr_counts, *variant_counts,
                  *data_counts, *axis_counts, *graph_counts, *pool_counts)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(c[name] for c in main_paths),
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": None,
         **({"inputs_ms": results[name]["inputs_ms"],
             "inputs_bound_ms": results[name]["inputs_bound_ms"]}
            if name in INPUTS_ONLY_KERNELS else {})}
        for name, (src, replaces) in KERNELS.items()]}
    say(LIBRARY_NOTE)
    say(json.dumps(line))
    say(f"total {time.time() - t_start:.1f} s")
    say(nvidia_smi())
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
