#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moldiff_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py                 # the smoke run (one card, < 10 min)
  python3 chip_smoke.py --num-mols 192 --batch-size 128 --budget-s 700
                                        # a longer sampling phase, for the success rate
  python3 chip_smoke.py --num-mols 8 --guided-num-mols 1000 --guided-batch-size 128 \
      --budget-s 3300                   # a longer guided phase, for its success rate
  python3 chip_smoke.py --fuse-num-mols 1000 --fuse-batch-size 128 --budget-s 3300
                                        # a longer path-B phase (fuse_block), for its rate

Phases, each asserting and none catching a failure:
  1. environment: torch and CUDA versions, the card's name and power limit;
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
     tile-boundary fault (no race detector runs on the card machine).
The last line is {"ok": true, "device": {...}}. A hang ends in a traceback
and a non-zero exit (faulthandler) before the budget runs out. The script
imports only torch, numpy, the standard library and moldiff_tpu_torch.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import faulthandler
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
    from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT as TRAIN_SETTINGS
except ImportError:
    TRAIN_SETTINGS = None
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


def check_forward(model, params, device) -> None:
    """MolDiff.forward at flagship width, kernels against plain versions
    (every forward kernel's wrapper replaced by its plain version)."""
    import torch

    from moldiff_tpu_torch.ops import kernels as K

    b, n = 16, 32
    g = torch.Generator(device=device).manual_seed(7)
    node_mask = (torch.arange(n, device=device)[None, :]
                 < torch.randint(12, n + 1, (b, 1), generator=g, device=device)).float()
    state = model.init_state(node_mask, model.draw_noise(b, n, g))
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    blocks = model.prepare(params)
    args = (params, state.h_node, state.pos, state.h_halfedge, t, node_mask)
    got = model.forward(*args, blocks=blocks)
    saved = {fn: getattr(K, fn) for fn in FORWARD_FUNCTIONS.values()}
    for fn in saved:
        setattr(K, fn, getattr(K, fn + "_plain"))
    try:
        want = model.forward(*args, blocks=blocks)
    finally:
        for fn, f in saved.items():
            setattr(K, fn, f)
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


def train_batch(records: list, b: int, n: int, device) -> dict:
    """The first b records of at most n atoms as one padded batch on the card."""
    import numpy as np

    from moldiff_tpu_torch.data.batching import pad_mols
    from moldiff_tpu_torch.data.featurize import featurizer_from_config
    from moldiff_tpu_torch.data.loader import featurize_record
    from moldiff_tpu_torch.train.trainer import batch_to_device
    from moldiff_tpu_torch.utils.config import Config

    feat = featurizer_from_config(Config(TRAIN_SETTINGS))
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
    den = settings["model"]["denoiser"]
    return "fuse_block" if den.get("fuse_block") else "edge_full" if den.get("edge_full") \
        else "partial"


def train_launches(settings: dict, results: dict) -> dict:
    """Each kernel's launches in one training step of ``settings``: its
    launches per call x the blocks, for the kernels of its route, else 0."""
    blocks = settings["model"]["denoiser"]["num_blocks"]
    runs = TRAIN_ROUTES[route(settings)]
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
    flagship_v2 with ``settings`` at B = b, N = n, kernels against plain
    versions, both bf16, with the plain versions at float32 as the ground
    truth; each forward kernel of the route alone, its backward kernels
    alone, and the one-ulp witness against plain."""
    import copy

    import torch

    from moldiff_tpu_torch.models.moldiff import MolDiff
    from moldiff_tpu_torch.ops import kernels as K
    from moldiff_tpu_torch.train.optim import global_norm, tree_leaves, tree_unflatten

    def tree_map_paths(tree, path=""):
        if isinstance(tree, dict):
            return {k: tree_map_paths(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [tree_map_paths(v, f"{path}/{k}") for k, v in enumerate(tree)]
        return path

    cfg32 = copy.deepcopy(settings["model"])
    cfg32["denoiser"]["dtype"] = "float32"
    model = MolDiff(settings["model"], 8, 6, device=device)
    model32 = MolDiff(cfg32, 8, 6, device=device)
    batch = train_batch(records, b, n, device)
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

    runs = TRAIN_ROUTES[route(settings)]
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
    say(f"train gradient ({route(settings)}) B={b} N={n}: loss kernels {loss_k:.6f} plain "
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
    pos_bwd = max((f, p) for f, p in zip(bwd, paths) if "/pos_block/" in p)
    say(f"  the backward kernels alone: median {statistics.median(bwd):.3g}, largest "
        f"{worst(bwd)[0]:.3g} ({worst(bwd)[1]}), largest pos_block leaf {pos_bwd[0]:.3g} "
        f"({pos_bwd[1]})")
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

    from moldiff_tpu_torch.models.moldiff import MolDiff
    from moldiff_tpu_torch.ops import kernels as K
    from moldiff_tpu_torch.train.optim import tree_leaves, tree_unflatten

    b, n = settings["train"]["batch_size"], max(settings["train"]["buckets"])
    model = MolDiff(settings["model"], 8, 6, device=device)
    batch = train_batch(records, b, n, device)
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


def fine_tune(corpus: dict, results: dict, device, settings: dict,
              steps_per_bucket: int = TRAIN_STEPS_PER_BUCKET) -> tuple:
    """Phase 10: the train CLI's run() with ``settings`` from flagship_v2 at
    batch 128, ``steps_per_bucket`` steps in each bucket (or one step in
    all, with 0); launch counts set to 0 just before and read just after,
    each step's equal to train_launches(). Then one eval step, one scheduler
    step and the written checkpoint reloaded in the port, its config
    carrying the route's flags."""
    import torch

    from moldiff_tpu_torch.ops import kernels
    from moldiff_tpu_torch.train import cli as train_cli
    from moldiff_tpu_torch.train.optim import tree_leaves
    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    start = int(load_checkpoint_numpy(CHECKPOINT)["step"])
    steps = max(2 * steps_per_bucket, 1)
    kernels.reset_launch_counts()
    out = train_cli.run(settings, CHECKPOINT, device=device,
                        logdir=os.path.join("outputs_torch", "chip_smoke"),
                        name=f"train_v2_cont_{route(settings)}", max_iters=start + steps,
                        reset_ema=True, reset_optim=True, subsets=corpus,
                        log=lambda m: say(f"  {m}"))
    counts = dict(kernels.launch_counts)
    per_step = train_launches(settings, results)
    by_bucket = {}
    for st in out["steps"]:
        assert st["launches"] == per_step, (st["it"], st["launches"], per_step)
        assert all(math.isfinite(st[k]) for k in ("loss", "loss_pos", "loss_node",
                                                   "loss_edge", "loss_len", "grad_norm"))
        by_bucket.setdefault(st["n"], []).append(st["s"])
        say(f"  train step {st['it']} N={st['n']}: {st['s']:.4f} s loss {st['loss']:.4f} "
            f"grad_norm {st['grad_norm']:.4f}")
    if steps_per_bucket:
        assert sorted(by_bucket) == settings["train"]["buckets"], by_bucket
        assert all(len(v) >= steps_per_bucket for v in by_bucket.values()), by_bucket
    assert counts == {k: v * len(out["steps"]) for k, v in per_step.items()}, counts
    trainer, state = out["trainer"], out["state"]
    batch = train_batch(corpus["val"], 16, 40, device)
    gen = torch.Generator(device=device).manual_seed(3)
    vaux = trainer.eval_step(state.params, batch, trainer.draw_noise(batch, gen))
    lr0 = state.opt_state.lr
    state = trainer.scheduler_step(state, float(vaux["loss"]))
    assert math.isfinite(float(vaux["loss"])) and state.opt_state.lr == lr0
    path = out["checkpoints"][-1]
    back = Trainer(trainer.model, settings["train"]).load_checkpoint(path, device)
    assert back.step == start + steps and back.opt_state.count == steps
    for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    saved = load_checkpoint_numpy(path)["config"]["model"]["denoiser"]
    for flag in ("fuse_block", "edge_full"):
        assert bool(saved.get(flag)) == bool(settings["model"]["denoiser"].get(flag)), saved
    s_step = {n: statistics.mean(v[1:] or v) for n, v in sorted(by_bucket.items())}
    say(f"fine-tuning ({route(settings)}): {len(out['steps'])} steps at batch "
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
    ap.add_argument("--budget-s", type=float, default=540.0,
                    help="wall-clock budget; the run is stopped with a traceback after it "
                         "(the default ends a hang well inside a 900 s call)")
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

    # phase 10's corpus, made by worker processes while the kernels build
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    corpus_jobs = start_corpus(pool)

    # 1. environment
    smi = nvidia_smi()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    say(f"card: {smi}")

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
    g_expected = {}
    for name in KERNELS:
        per_step = {"node_block": dn_blocks + bp_blocks, "edge_pair": dn_blocks + bp_blocks,
                    "pos_update": dn_blocks, "node_block_bwd": bp_blocks,
                    "edge_pair_bwd": bp_blocks}.get(name, 0)
        # guidance differentiates positions only: rows 3 and 5 run inputs-only
        per_call = results[name]["per_call_guided" if name in INPUTS_ONLY_KERNELS
                                 else "per_call"]
        g_expected[name] = per_call * per_step * steps * g_chains
    say(f"guided sampling: {g_chains} chains x {steps} steps, launches {g_counts}, "
        f"expected {g_expected}")
    assert g_counts == g_expected, (g_counts, g_expected)
    kernels.reset_launch_counts()
    assert g_summary["num_finished"] >= args.guided_num_mols
    assert g_summary["success_rate_classified"] >= 0.25, g_summary
    report("guided sampling", g_summary, steps)

    # 9. the training gradient, kernels against plain versions
    corpus = collect_corpus(corpus_jobs)
    pool.shutdown()
    check_train_gradient(params, corpus["train"], device, TRAIN_SETTINGS)
    say(f"launches made by the checks (not counted below): {kernels.launch_counts}")

    # 10. the training path: the train CLI's run() from flagship_v2
    t_counts, _ = fine_tune(corpus, results, device, TRAIN_SETTINGS)

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

    main_paths = (counts, g_counts, t_counts, f_counts, fb_counts, e_counts)
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
