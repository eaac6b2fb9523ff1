"""The forward kernels of this checkout against another checkout's build
of them, bit for bit, on the card, and the full-EdgeBlock backward against
itself: one process builds both kernel libraries (each from its own
``csrc/`` into its own ``build/``) and runs each through this checkout's
wrappers on the same inputs, at flagship_v2's and the demo denoiser's
block-0 weights, for each batch and bucket:

  pos_update (fused 0)     row 8 alone
  fused_block (fused 1)    row 2, the whole block (row 8 inside it)
  edge_block_full          row 6, the whole EdgeBlock forward
  edge_block_full_bwd      row 7: its largest difference from the other
                           build on each output (reported, not held), and
                           two runs of this build, which must be bit-equal

  python -m moldiff_tpu_torch.ops.compare_builds --other build/parent
      [--batch 16 128] [--bucket 32 40]

It prints one JSON line per case (the elements that differ, the largest
difference) and exits with 1 if any element of a forward output differs
from the other build's, or row 7's two runs differ. Both checkouts' C
entry points must take the same arguments. Runs on the card only.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

CHECKPOINTS = {"flagship_v2": "ckpts/flagship_v2.ckpt",
               "demo_synthetic_30k": "ckpts/demo_synthetic_30k.ckpt"}
SAMPLE = {"batch_size": 16, "size_mean": 24.923, "size_std": 5.516, "buckets": [32, 40]}


def other_library(root: str):
    """The kernel library of the checkout at ``root``, built by its own
    ops/build.py."""
    path = os.path.join(root, "moldiff_tpu_torch", "ops", "build.py")
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def inputs(b: int, n: int, seed: int, dn: int, de: int, device) -> dict:
    """Seeded activations with random molecule sizes, as chip_smoke.py's
    kernel checks make them."""
    from moldiff_tpu_torch.models.nn import GaussianSmearing, safe_distance
    from moldiff_tpu_torch.ops import graph_ops

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
    hd = GaussianSmearing(stop=15.0, num_gaussians=16)(dist).to(torch.bfloat16)
    ct = (torch.randn((b, n, n, de), generator=g) * 0.1).to(torch.bfloat16)
    return {k: v.to(device).contiguous() for k, v in dict(
        x=x, e=e, t=t, m=pair_mask, rel=rel, dist=dist, hd=hd, ct=ct).items()}


def run_with(lib, call) -> list:
    """call()'s outputs with ``lib`` as the kernel library."""
    from moldiff_tpu_torch.ops import build

    own = build.library
    build.library = lambda: lib
    try:
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
    finally:
        build.library = own
    return out


def diff(a: list, b: list) -> tuple:
    """(elements that differ, largest difference) per output."""
    return ([int((x != y).sum()) for x, y in zip(a, b)],
            [float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 128])
    ap.add_argument("--bucket", type=int, nargs="+", default=[32, 40])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_builds: no card")
    from moldiff_tpu_torch.ops import build, kernels
    from moldiff_tpu_torch.sample import cli

    device = torch.device("cuda", 0)
    libs = {"this": build.library(), "other": other_library(args.other)}
    differ = 0
    for model, ckpt in CHECKPOINTS.items():
        sampler, params = cli.build_sampler(ckpt, SAMPLE, device)
        blk = sampler.model.prepare(params)[0]
        eb = blk["edge_block"]
        dn = blk["node_block"]["node_net"]["layers"][0]["lin"]["w"].shape[0]
        de = blk["edge_emb"]["w"].shape[1]
        for b in args.batch:
            for n in args.bucket:
                x = inputs(b, n, seed=1000 * b + n, dn=dn, de=de, device=device)
                calls = {
                    "pos_update (fused 0)": lambda: [kernels.pos_update(
                        blk["pos_block"], x["x"], x["e"], x["rel"], x["dist"], x["t"], x["m"])],
                    "fused_block (fused 1)": lambda: list(kernels.fused_block(
                        blk, x["x"], x["e"], x["hd"], x["rel"], x["dist"], x["t"], x["m"])),
                    "edge_block_full": lambda: [kernels.edge_block_full(
                        eb, x["e"], x["x"], x["t"], x["m"])],
                }
                for name, call in calls.items():
                    outs = {tree: run_with(lib, call) for tree, lib in libs.items()}
                    bad, err = diff(outs["this"], outs["other"])
                    differ += sum(bad)
                    print(json.dumps({"model": model, "kernel": name, "B": b, "N": n,
                                      "elements": [a.numel() for a in outs["this"]],
                                      "differ": bad, "max_abs_diff": err}), flush=True)

                def bwd():
                    d_params, *d_in = kernels.edge_block_full_bwd(eb, x["e"], x["x"], x["t"],
                                                                  x["m"], x["ct"])
                    return list(d_in) + kernels._edge_block_full_leaves(d_params)

                first, again = run_with(libs["this"], bwd), run_with(libs["this"], bwd)
                other = run_with(libs["other"], bwd)
                rerun = diff(first, again)[0]
                differ += sum(rerun)
                bad, err = diff(first, other)
                print(json.dumps({"model": model, "kernel": "edge_block_full_bwd", "B": b,
                                  "N": n, "outputs": len(first),
                                  "rerun_differ": sum(rerun),
                                  "other_build": {"outputs_differ": sum(k > 0 for k in bad),
                                                  "max_abs_diff": dict(zip(
                                                      ["d_bond", "d_node", "d_time", "d_mask"],
                                                      err[:4])),
                                                  "max_abs_diff_params": max(err[4:])}}),
                      flush=True)
    print(json.dumps({"bit_equal": differ == 0, "card": torch.cuda.get_device_name(0)}))
    sys.exit(0 if differ == 0 else 1)


if __name__ == "__main__":
    main()
