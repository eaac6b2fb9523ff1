"""Where a reverse step's time goes on the card: a torch.profiler trace of a
few sampling steps of flagship_v2 (commit: nodes) at given batch sizes,
unguided or (``--guided``) steered by bondpred_v2 with uncertainty guidance
at 1e-4, as configs/sample/sample_flagship_v2_guided.yml.

  python -m moldiff_tpu_torch.sample.profile_steps [--batch 16 128]
      [--bucket 32 40] [--steps 5] [--guided] [--out outputs_torch/profile]

For each (batch, bucket) it runs WARMUP steps, times ``--steps`` steps with
CUDA events, then traces as many more under torch.profiler and prints one
JSON line (the trace goes to ``<out>/trace_B<batch>_N<bucket>.json``):

  step_ms              time per step, untraced (CUDA events)
  traced_step_ms       time per step while traced (the profiler's overhead in it)
  device_busy_ms       per step: the union of the device's kernel, copy and
                       set intervals in the trace
  device_idle_share    1 - device_busy_ms / step_ms
  launches             per step: device kernels (the port's own among them)
  port_kernel_ms       per step: device time of the port's CUDA kernels
                       (ops/kernels.py), by kernel
  other_kernel_ms      per step: device time of every other kernel
  top_other            the other kernels with the most device time per step

If the trace holds no device events, the device figures are null and the
line says so. Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

CHECKPOINT = "ckpts/flagship_v2.ckpt"
BOND_PREDICTOR = "ckpts/bondpred_v2.ckpt"
GUIDANCE = ("uncertainty", 1.0e-4)
SETTINGS = {"seed": 2023, "batch_size": 128, "size_mean": 24.923, "size_std": 5.516,
            "sanitize_mode": "reference", "commit": "nodes", "buckets": [32, 40]}
WARMUP = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels (csrc/*.cu): <node|edge|pos>_<prep|pair>_kernel, the
# backward's <node|edge>_bwd_<pair|node>_kernel and grad.cu's three
PORT_KERNEL = re.compile(r"\b((?:node|edge|pos)_(?:prep|pair)_kernel"
                         r"|(?:node|edge)_bwd_(?:pair|node)_kernel"
                         r"|wgrad_kernel|reduce_kernel|time_kernel)\b")


def summarize_trace(events: List[dict], steps: int, step_ms: float,
                    top: int = 8) -> Dict[str, object]:
    """Per-step device figures of a Chrome trace's events (``ts``/``dur`` in
    microseconds) over ``steps`` traced steps."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"device_busy_ms": None, "device_idle_share": None, "launches": None,
                "port_kernel_ms": None, "other_kernel_ms": None, "top_other": None,
                "note": "the trace holds no device events"}
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e["ts"]):
        start, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    port: Dict[str, float] = defaultdict(float)
    other: Dict[str, float] = defaultdict(float)
    n_kernels = n_port = 0
    for e in dev:
        if e["cat"] != "kernel":
            continue
        n_kernels += 1
        found = PORT_KERNEL.search(e["name"])
        if found:
            n_port += 1
            port[found.group(1)] += float(e["dur"])
        else:
            other[e["name"][:100]] += float(e["dur"])
    per = lambda us: us / 1e3 / steps
    busy_ms = per(busy)
    return {
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "launches": {"all": n_kernels / steps, "port": n_port / steps},
        "port_kernel_ms": {k: per(v) for k, v in sorted(port.items())},
        "other_kernel_ms": per(sum(other.values())),
        "top_other": [[k, per(v)] for k, v in
                      sorted(other.items(), key=lambda kv: -kv[1])[:top]],
    }


def profile(model, params, batch: int, bucket: int, steps: int, out_dir: str,
            seed: int = 0, bond_predictor=None) -> Dict[str, object]:
    """``bond_predictor``: (BondPredictor, params) for guided steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..data.batching import node_mask_from_counts

    dev = model.device
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.normal(SETTINGS["size_mean"], SETTINGS["size_std"], batch)
                    .astype(np.int32), 3, bucket)
    node_mask = torch.from_numpy(node_mask_from_counts(sizes, bucket)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = model.prepare(params)
    guided = {}
    if bond_predictor is not None:
        bp, bp_params = bond_predictor
        guided = {"bond_predictor": (bp, bp_params, bp.prepare(bp_params)),
                  "guidance": GUIDANCE}
    state = model.init_state(node_mask, model.draw_noise(batch, bucket, gen))
    step = model.num_timesteps - 1

    def run(k: int) -> None:
        nonlocal state, step
        with torch.no_grad():
            for _ in range(k):
                state = model.reverse_step(params, state, step, node_mask,
                                           model.draw_noise(batch, bucket, gen),
                                           commit=SETTINGS["commit"], blocks=blocks, **guided)
                step -= 1

    run(WARMUP)
    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    stop.record()
    stop.synchronize()
    step_ms = start.elapsed_time(stop) / steps

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    os.makedirs(out_dir, exist_ok=True)
    tag = "guided_" if guided else ""
    path = os.path.join(out_dir, f"trace_{tag}B{batch}_N{bucket}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"guided": bool(guided), "batch": batch, "bucket": bucket, "steps": steps,
            "step_ms": step_ms,
            "traced_step_ms": traced_ms, **summarize_trace(events, steps, step_ms)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from ..models.moldiff import resolve_device
    from .cli import build_sampler, load_bond_predictor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 128])
    ap.add_argument("--bucket", type=int, nargs="+", default=[32, 40])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--guided", action="store_true",
                    help="guided steps (bondpred_v2, uncertainty guidance at 1e-4)")
    ap.add_argument("--out", default=os.path.join("outputs_torch", "profile"))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sampler, params = build_sampler(CHECKPOINT, SETTINGS, device)
    bond_predictor = (load_bond_predictor(BOND_PREDICTOR, sampler.featurizer, device)
                      if args.guided else None)
    lines = []
    for batch in args.batch:
        for bucket in args.bucket:
            line = profile(sampler.model, params, batch, bucket, args.steps, args.out,
                           bond_predictor=bond_predictor)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
