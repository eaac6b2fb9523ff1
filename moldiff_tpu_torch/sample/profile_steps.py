"""Where a reverse step's time goes on the card: a torch.profiler trace of a
few sampling steps of flagship_v2 (commit: nodes) at given batch sizes,
unguided or (``--guided``) steered by bondpred_v2 with uncertainty guidance
at 1e-4, as configs/sample/sample_flagship_v2_guided.yml; or (``--train``)
of a few training steps of flagship_v2 (the loss, its gradient through the
backward kernels, adamw and EMA) with the settings of
configs/train/train_v2_cont.yml (train/settings.py), on one batch of v2
molecules per bucket drawn at sizes inside the bucket, as chip_smoke.py's
fine-tuning corpus; with ``--bond-predictor``, of the bond predictor's
training steps instead (configs/train/train_bondpred_v2.yml from the
weights of ckpts/bondpred_40k.ckpt, the checkpoint that config resumes).
``--fuse-block`` and ``--edge-full`` set those flags on the model config
the trace builds (models/denoiser.py): the whole-block kernel in every
block, or the full-EdgeBlock kernels.

  python -m moldiff_tpu_torch.sample.profile_steps [--batch 16 128]
      [--bucket 32 40] [--steps 5] [--guided | --train [--bond-predictor]]
      [--fuse-block] [--edge-full] [--out outputs_torch/profile]

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
  flops_per_step       utils/flops.py's analytic count of the step's matrix
                       products: one denoiser forward for a sampling step;
                       with guidance also the bond predictor's forward and
                       its gradient (3 x its forward); 3 x the model's
                       forward for a training step (forward and backward, no
                       recomputation), as bench.py:102-125 and :294-304
  tflops_per_sec       flops_per_step over step_ms
  pct_peak             its share of the card's dense bf16 peak
                       (utils/flops.device_peak_flops)

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
BOND_PREDICTOR_40K = "ckpts/bondpred_40k.ckpt"
GUIDANCE = ("uncertainty", 1.0e-4)
SETTINGS = {"seed": 2023, "batch_size": 128, "size_mean": 24.923, "size_std": 5.516,
            "sanitize_mode": "reference", "commit": "nodes", "buckets": [32, 40]}
WARMUP = 3
# --train: molecule sizes per bucket, as chip_smoke.py's corpus draws them
# (38 atoms is the most the v2 generator makes)
TRAIN_SIZES = {32: (20, 32), 40: (33, 38)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels (csrc/*.cu, each in an anonymous namespace):
# <node|edge|pos>_<prep|pair>_kernel, the backward's
# <node|edge|pos>_bwd_<pair|node>_kernel, grad.cu's three, the EdgeBlock
# tail's tail_<prep|fwd|bwd_pair|bwd_node>_kernel and the whole block's
# edge_emb_kernel and node_tail_kernel (templates: each instantiation counts
# under its kernel's name); PyTorch's own reductions are also
# named reduce_kernel (at::native::reduce_kernel<...>), so a name counts
# only unqualified or in the anonymous namespace
PORT_KERNEL = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                         r"((?:node|edge|pos)_(?:prep|pair)_kernel"
                         r"|(?:node|edge|pos)_bwd_(?:pair|node)_kernel"
                         r"|tail_(?:prep|fwd|bwd_pair|bwd_node)_kernel"
                         r"|edge_emb_kernel|node_tail_kernel"
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


def _node_mask(batch: int, bucket: int, rng: np.random.Generator, dev) -> torch.Tensor:
    from ..data.batching import node_mask_from_counts

    sizes = np.clip(rng.normal(SETTINGS["size_mean"], SETTINGS["size_std"], batch)
                    .astype(np.int32), 3, bucket)
    return torch.from_numpy(node_mask_from_counts(sizes, bucket)).to(dev)


def forward_flops(model, batch: int, bucket: int) -> float:
    """utils/flops.py's count of one forward of ``model``'s NodeEdgeNet
    (MolDiff's denoiser or the bond predictor's encoder)."""
    from ..utils.flops import denoiser_forward_flops

    static = model.encoder_static if hasattr(model, "encoder_static") else model.denoiser_static
    return denoiser_forward_flops(batch, bucket, model.node_dim, model.edge_dim,
                                  static["num_blocks"], static["num_gaussians"],
                                  static["update_edge"], static["update_pos"],
                                  static["use_gate"])


def rate(flops: float, step_ms: float, dev) -> Dict[str, float]:
    """flops_per_step, tflops_per_sec and pct_peak of the card ``dev``."""
    from ..utils.flops import device_peak_flops, mfu

    peak = device_peak_flops(torch.cuda.get_device_name(dev))
    return {"flops_per_step": flops, **mfu(flops, step_ms / 1e3, peak)}


def _timed_and_traced(run, steps: int, dev, out_dir: str, name: str) -> Dict[str, object]:
    """WARMUP steps, ``steps`` timed by CUDA events, ``steps`` traced."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

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
    path = os.path.join(out_dir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"steps": steps, "step_ms": step_ms, "traced_step_ms": traced_ms,
            **summarize_trace(events, steps, step_ms)}


def train_batch(settings: dict, batch: int, bucket: int, seed: int, dev) -> dict:
    """One padded batch of v2 molecules at sizes drawn in TRAIN_SIZES[bucket],
    featurized as the train loader does, on ``dev``."""
    from ..data.batching import pad_mols
    from ..data.dataset import generate_records
    from ..data.featurize import featurizer_from_config
    from ..data.loader import featurize_record
    from ..train.trainer import batch_to_device
    from ..utils.config import Config

    rng = np.random.default_rng(seed)
    lo, hi = TRAIN_SIZES[bucket]
    records = generate_records(batch, seed, "v2", n_atoms=rng.integers(lo, hi + 1, batch).tolist())
    feat = featurizer_from_config(Config(settings))
    mols = [featurize_record(r, feat, rng) for r in records]
    return batch_to_device(pad_mols(mols, n_max=bucket), dev)


def profile_train(trainer, params, data: dict, steps: int, out_dir: str,
                  seed: int = 0) -> Dict[str, object]:
    """Training steps (train_step: loss, backward, optimizer, EMA) on one
    fixed batch ``data``."""
    model = trainer.model
    dev = model.device
    batch, bucket = data["node_mask"].shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = trainer.init_from_params(params)

    def run(k: int) -> None:
        nonlocal state
        for _ in range(k):
            state, _ = trainer.train_step(state, data, trainer.draw_step_noise(data, gen))

    bond = hasattr(model, "encoder_static")
    static = model.encoder_static if bond else model.denoiser_static
    tag = "bond_" if bond else ""
    line = {"train": True, "bond_predictor": bond, "batch": batch, "bucket": bucket,
            "route": {k: static[k] for k in ("fuse_block", "edge_full")},
            **_timed_and_traced(run, steps, dev, out_dir,
                                f"trace_train_{tag}B{batch}_N{bucket}.json")}
    return {**line, **rate(3 * forward_flops(model, batch, bucket), line["step_ms"], dev)}


def profile(model, params, batch: int, bucket: int, steps: int, out_dir: str,
            seed: int = 0, bond_predictor=None) -> Dict[str, object]:
    """``bond_predictor``: (BondPredictor, params) for guided steps."""
    dev = model.device
    rng = np.random.default_rng(seed)
    node_mask = _node_mask(batch, bucket, rng, dev)
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

    tag = "guided_" if guided else ""
    line = {"guided": bool(guided), "batch": batch, "bucket": bucket,
            "route": {k: model.denoiser_static[k] for k in ("fuse_block", "edge_full")},
            **_timed_and_traced(run, steps, dev, out_dir, f"trace_{tag}B{batch}_N{bucket}.json")}
    flops = forward_flops(model, batch, bucket)
    if bond_predictor is not None:
        flops += 3 * forward_flops(bond_predictor[0], batch, bucket)
    return {**line, **rate(flops, line["step_ms"], dev)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from ..models.moldiff import resolve_device
    from .cli import build_sampler, load_bond_predictor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 128])
    ap.add_argument("--bucket", type=int, nargs="+", default=[32, 40])
    ap.add_argument("--steps", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--guided", action="store_true",
                      help="guided steps (bondpred_v2, uncertainty guidance at 1e-4)")
    mode.add_argument("--train", action="store_true",
                      help="training steps (configs/train/train_v2_cont.yml)")
    ap.add_argument("--bond-predictor", action="store_true",
                    help="with --train: the bond predictor's training steps "
                         "(configs/train/train_bondpred_v2.yml, bondpred_40k's weights)")
    ap.add_argument("--fuse-block", action="store_true",
                    help="model.denoiser.fuse_block: the whole-block kernel in every block")
    ap.add_argument("--edge-full", action="store_true",
                    help="model.denoiser.edge_full: the full-EdgeBlock kernels")
    ap.add_argument("--out", default=os.path.join("outputs_torch", "profile"))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flags = {k: True for k, on in (("fuse_block", args.fuse_block),
                                   ("edge_full", args.edge_full)) if on}
    sampler, params = build_sampler(CHECKPOINT, SETTINGS, device, denoiser=flags)
    bond_predictor = (load_bond_predictor(BOND_PREDICTOR, sampler.featurizer, device)
                      if args.guided else None)
    trainer = None
    if args.train:
        from ..data.featurize import featurizer_from_config
        from ..models.bond_predictor import BondPredictor
        from ..models.moldiff import MolDiff
        from ..train.settings import TRAIN_BONDPRED_V2, TRAIN_V2_CONT
        from ..train.trainer import Trainer
        from ..utils.checkpoint import load_checkpoint
        from ..utils.config import Config

        settings = TRAIN_BONDPRED_V2 if args.bond_predictor else TRAIN_V2_CONT
        cfg = dict(settings["model"])
        net = "encoder" if args.bond_predictor else "denoiser"
        cfg[net] = dict(cfg[net], **flags)
        feat = featurizer_from_config(Config(settings))
        cls = BondPredictor if args.bond_predictor else MolDiff
        model = cls(cfg, feat.num_node_types, feat.num_edge_types, device=device)
        trainer = Trainer(model, settings["train"])
        if args.bond_predictor:
            params = load_checkpoint(BOND_PREDICTOR_40K, device)["params"]
    lines = []
    for batch in args.batch:
        for bucket in args.bucket:
            if trainer is not None:
                data = train_batch(settings, batch, bucket, seed=bucket, dev=device)
                line = profile_train(trainer, params, data, args.steps, args.out)
            else:
                line = profile(sampler.model, params, batch, bucket, args.steps, args.out,
                               bond_predictor=bond_predictor)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
