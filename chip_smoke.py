#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moldiff_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py                 # the smoke run (one card, < 10 min)
  python3 chip_smoke.py --num-mols 192 --batch-size 128 --budget-s 700
                                        # a longer sampling phase, for the success rate

Phases, each asserting and none catching a failure:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds the kernels of moldiff_tpu_torch/csrc;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at flagship widths, N = 32 and 40, B = 16, block-0 weights of
     ckpts/flagship_v2.ckpt, seeded inputs and random masks; times by CUDA
     events;
  4. forward check: one MolDiff.forward with the kernels against the same
     forward with the plain versions, on the card;
  5. sampling: the sample CLI's run() with the settings of
     configs/sample/sample_flagship_v2.yml (T = 1000, commit: nodes),
     decoded and classified; each launch count must equal the kernels one
     wrapper call launches (prep + pair: 2) x num_blocks x T x chains.
The last line is {"ok": true, "device": {...}}. A hang ends in a traceback
and a non-zero exit (faulthandler) before the budget runs out. The script
imports only torch, numpy, the standard library and moldiff_tpu_torch.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
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
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
KERNELS = {
    "node_block": ("moldiff_tpu_torch/csrc/node_block.cu",
                   "moldiff_tpu/ops/pallas_kernels.py:49"),
    "edge_pair": ("moldiff_tpu_torch/csrc/edge_pair.cu",
                  "moldiff_tpu/ops/pallas_kernels.py:1062"),
    "pos_update": ("moldiff_tpu_torch/csrc/pos_update.cu",
                   "moldiff_tpu/ops/pallas_kernels.py:1891"),
}
LIBRARY_NOTE = ("library_ms is null: no single PyTorch call computes these fused "
                "MLP-gate-sum chains")


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


def work(name: str, blk: dict, b: int, n: int) -> tuple:
    """(FLOPs, bytes) one call needs: every product of the chain, each input
    read once and each output written once, bf16 weights read once."""
    nb, eb, pb = blk["node_block"], blk["edge_block"], blk["pos_block"]
    pairs, nodes = b * n * n, b * n
    if name == "node_block":
        de, h = nb["edge_net"]["layers"][0]["lin"]["w"].shape
        dn = nb["node_net"]["layers"][0]["lin"]["w"].shape[0]
        flops = pairs * (4 * de * h + 6 * h * h) + nodes * (4 * dn * h + 2 * h * h)
        weights = _numel({k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")})
        io = pairs * (2 * de + 4) + nodes * (2 * dn + 2 * h) + 4 * b
    elif name == "edge_pair":
        side = eb["bond_ffn_left"]
        de, i = side["bond_linear"]["w"].shape
        dn = side["node_linear"]["w"].shape[0]
        g = side["gate"]["layers"][0]["lin"]["w"].shape[1]
        do = side["inter"]["layers"][1]["lin"]["w"].shape[1]
        flops = 2 * (pairs * (2 * de * i + 2 * i * i + 2 * i * do + 2 * de * g + 2 * g * do)
                     + nodes * (2 * dn * i + 2 * dn * g))
        weights = _numel([eb["bond_ffn_left"], eb["bond_ffn_right"]])
        io = pairs * (2 * de + 4) + nodes * (2 * dn + 2 * 2 * do) + 4 * b
    else:
        el = pb["edge_lin"]
        de, i = el["bond_linear"]["w"].shape
        dl = el["node_linear"]["w"].shape[0]
        dn = pb["left_lin_edge"]["layers"][0]["lin"]["w"].shape[0]
        g = el["gate"]["layers"][0]["lin"]["w"].shape[1]
        flops = (pairs * (2 * de * i + 2 * dl * i + 2 * i * i + 2 * i + 2 * de * g
                          + 2 * dl * g + 2 * g + dl)
                 + nodes * 2 * (2 * dn * dl + 2 * dl * dl))
        weights = _numel(pb)
        io = pairs * (2 * de + 12 + 4 + 4) + nodes * (2 * dn + 12) + 4 * b
    return flops, io + 2 * weights


def kernel_inputs(b: int, n: int, seed: int, device):
    """Seeded activations at flagship width with random molecule sizes."""
    import torch

    from moldiff_tpu_torch.ops import graph_ops
    from moldiff_tpu_torch.models.nn import safe_distance

    g = torch.Generator(device="cpu").manual_seed(seed)
    sizes = torch.randint(n // 2, n + 1, (b,), generator=g)
    node_mask = (torch.arange(n)[None, :] < sizes[:, None]).float()
    pair_mask = graph_ops.pair_mask_from_node_mask(node_mask)
    pos = torch.randn((b, n, 3), generator=g) * 3.0
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    x = torch.randn((b, n, 256), generator=g).to(torch.bfloat16)
    e = torch.randn((b, n, n, 64), generator=g).to(torch.bfloat16)
    t = torch.rand((b, 1, 1), generator=g)
    return {k: v.to(device).contiguous() for k, v in dict(
        x=x, e=e, t=t, pair_mask=pair_mask, rel=rel, dist=safe_distance(rel)).items()}


def kernel_calls(blk: dict, inp: dict):
    """name -> (kernel call, plain call) on the same inputs."""
    from moldiff_tpu_torch.ops import kernels as K

    nb, eb, pb = blk["node_block"], blk["edge_block"], blk["pos_block"]
    nb_p = {k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")}
    eb_p = {"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]}
    x, e, t, m = inp["x"], inp["e"], inp["t"], inp["pair_mask"]
    pos_args = (pb, x, e, inp["rel"], inp["dist"], t, m)
    return {
        "node_block": (lambda: K.node_block_aggregate(nb_p, x, e, t, m),
                       lambda: K.node_block_aggregate_plain(nb_p, x, e, t, m)),
        "edge_pair": (lambda: K.edge_pair_aggregate(eb_p, e, x, t, m),
                      lambda: K.edge_pair_aggregate_plain(eb_p, e, x, t, m)),
        "pos_update": (lambda: K.pos_update(*pos_args),
                       lambda: K.pos_update_plain(*pos_args)),
    }


def check_kernels(blk: dict, device) -> dict:
    import torch

    from moldiff_tpu_torch.ops import kernels

    results = {}
    for n in (32, 40):
        inp = kernel_inputs(16, n, seed=n, device=device)
        for name, (kern, plain) in kernel_calls(blk, inp).items():
            before = kernels.launch_counts[name]
            got, want = kern(), plain()
            per_call = kernels.launch_counts[name] - before
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for a, w in zip(got, want):
                a, w = a.float(), w.float()
                assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
                tol = KERNEL_ATOL_FRAC * w.abs().max() + KERNEL_RTOL * w.abs()
                bad = int(((a - w).abs() > tol).sum())
                assert bad == 0, f"{name} N={n}: {bad} elements outside the tolerance"
                err = max(err, float((a - w).abs().max()))
            ms = median_ms(kern, warmup=3, iters=20)
            plain_ms = median_ms(plain, warmup=1, iters=5)
            flops, nbytes = work(name, blk, 16, n)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            say(f"kernel {name} B=16 N={n}: max_abs_err {err:.6g} ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {max(t_ops, t_bytes):.5f} "
                f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
            r = results.setdefault(name, {"max_abs_err": 0.0, "per_call": per_call})
            assert per_call == r["per_call"] > 0, f"{name}: {per_call} launches per call"
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if n == 32:  # the shape of the sampling phase
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
    say(LIBRARY_NOTE)
    return results


def check_forward(model, params, device) -> None:
    """MolDiff.forward at flagship width, kernels against plain versions."""
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
    saved = (K.node_block_aggregate, K.edge_pair_aggregate, K.pos_update)
    K.node_block_aggregate = K.node_block_aggregate_plain
    K.edge_pair_aggregate = K.edge_pair_aggregate_plain
    K.pos_update = K.pos_update_plain
    try:
        want = model.forward(*args, blocks=blocks)
    finally:
        K.node_block_aggregate, K.edge_pair_aggregate, K.pos_update = saved
    torch.cuda.synchronize()
    for name, a, w in zip(got._fields, got, want):
        assert bool(torch.isfinite(a).all()), name
        frac = float((a - w).abs().max() / w.abs().max())
        say(f"forward {name} {tuple(a.shape)}: max |kernels - plain| / max |plain| = {frac:.3g}")
        assert frac <= FORWARD_MAX_FRAC, f"forward {name}: {frac} > {FORWARD_MAX_FRAC}"


def main() -> None:
    ap = argparse.ArgumentParser(description="smoke run of moldiff_tpu_torch on the card")
    ap.add_argument("--num-mols", type=int, default=8,
                    help="molecules the sampling phase generates (finished)")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="molecules per reverse chain in the sampling phase")
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

    # 3. kernel checks at flagship widths, block-0 weights
    sampler, params = cli.build_sampler(CHECKPOINT, SAMPLE_SETTINGS["sample"], device)
    model = sampler.model
    blk0 = model.prepare(params)[0]
    results = check_kernels(blk0, device)
    say(f"launches made by the checks (not counted below): {kernels.launch_counts}")

    # 4. one full forward, kernels against plain versions
    check_forward(model, params, device)

    # 5. the main path: the sample CLI's run()
    kernels.reset_launch_counts()
    summary = cli.run(SAMPLE_SETTINGS, device=device,
                      outdir=os.path.join("outputs_torch", "chip_smoke"),
                      num_mols=args.num_mols, batch_size=args.batch_size,
                      run_name=f"flagship_v2_{args.num_mols}",
                      log=lambda m: say(f"  {m}"))
    counts = dict(kernels.launch_counts)
    chains = summary["chains"]
    steps = model.num_timesteps
    calls = model.denoiser_static["num_blocks"] * steps * chains
    expected = {name: results[name]["per_call"] * calls for name in KERNELS}
    say(f"sampling: {chains} chains x {steps} steps, launches {counts}, expected {expected}")
    for name in KERNELS:
        assert counts[name] == expected[name], (
            f"{name}: {counts[name]} launches, expected {expected[name]}")
    n_done = summary["num_classified"]
    assert summary["num_finished"] >= args.num_mols
    assert summary["success_rate"] >= 0.25, summary
    say(f"sampling: success {summary['success_rate']:.4f} "
        f"(Wilson 95% [{summary['success_wilson95'][0]:.4f}, "
        f"{summary['success_wilson95'][1]:.4f}], {n_done} molecules) "
        f"s/step {summary['chain_s'] / (chains * steps):.5f} "
        f"mols/s {summary['mols_per_s']:.4f} wall {summary['wall_s']:.1f} s")
    say(json.dumps(summary))

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": None}
        for name, (src, replaces) in KERNELS.items()]}
    say(json.dumps(line))
    say(f"total {time.time() - t_start:.1f} s")
    say(nvidia_smi())
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
