"""Reference (PyTorch) checkpoints -> the port's param trees, and back (a
copy of moldiff_tpu/utils/convert.py).

Lets users of the upstream PyTorch implementation load their trained
``.pt`` checkpoints ({'config', 'model', ...}) into the port, and export
the port's params to that format.

Name mapping (reference module tree, models/model.py:12-46 and
models/graph.py):

  node_embedder.weight                  -> node_embedder.w (transposed)
  denoiser.node_blocks_with_edge.{i}.*  -> denoiser.blocks.node_block.* [i]
  denoiser.edge_embs.{i}.*              -> denoiser.blocks.edge_emb.* [i]
  denoiser.edge_blocks.{i}.*            -> denoiser.blocks.edge_block.* [i]
  denoiser.pos_blocks.{i}.*             -> denoiser.blocks.pos_block.* [i]
  node_decoder / edge_decoder (MLP)     -> same

torch.nn.Linear stores weight [out, in]; the port's w is [in, out], the
JAX layout, so it is transposed on conversion. The reference MLP is
Sequential([Linear, LayerNorm, ReLU] * (L-1), Linear) with indices 0, 1, 3
(2 layers) / 0, 1, 3, 4, 6 (3 layers). Per-block subtrees are stacked on a
leading num_blocks axis. The converted trees are torch tensors (float32)
on ``device``; the exports are numpy arrays.
"""
from __future__ import annotations

import sys
import types
from typing import Dict

import numpy as np
import torch

from ..models.moldiff import resolve_device
from .checkpoint import params_to_torch
from .config import Config
from .tree import tree_leaves, tree_map


def _ensure_easydict_stub() -> None:
    """torch.load of a reference checkpoint needs the easydict module;
    register a minimal stand-in when it is not installed."""
    if "easydict" in sys.modules:
        return
    mod = types.ModuleType("easydict")

    class EasyDict(dict):
        def __init__(self, d=None, **kw):
            super().__init__()
            d = dict(d or {})
            d.update(kw)
            for k, v in d.items():
                self[k] = v

        def __setitem__(self, k, v):
            if isinstance(v, dict) and not isinstance(v, EasyDict):
                v = EasyDict(v)
            if isinstance(v, (list, tuple)):
                v = type(v)(
                    EasyDict(x) if isinstance(x, dict) else x for x in v
                )
            super().__setitem__(k, v)
            super().__setattr__(k, v)

        __setattr__ = __setitem__

        def __getattr__(self, k):
            try:
                return self[k]
            except KeyError:
                raise AttributeError(k) from None

    mod.EasyDict = EasyDict
    sys.modules["easydict"] = mod


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def linear_from_torch(sd: Dict, prefix: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{prefix}.weight"]).T}
    if bias:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def layernorm_from_torch(sd: Dict, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def mlp_from_torch(sd: Dict, prefix: str, num_layer: int = 2) -> dict:
    """Reference MLP Sequential indices: Linear at 3*k, LayerNorm at 3*k+1
    (for k < num_layer-1), final Linear at 3*(num_layer-1)."""
    layers = []
    for k in range(num_layer):
        idx = 3 * k
        lp = {"lin": linear_from_torch(sd, f"{prefix}.net.{idx}")}
        if k < num_layer - 1:
            lp["ln"] = layernorm_from_torch(sd, f"{prefix}.net.{idx + 1}")
        layers.append(lp)
    return {"layers": layers}


def bond_ffn_from_torch(sd: Dict, prefix: str, use_gate: bool) -> dict:
    p = {
        "bond_linear": linear_from_torch(sd, f"{prefix}.bond_linear", bias=False),
        "node_linear": linear_from_torch(sd, f"{prefix}.node_linear", bias=False),
        "inter": mlp_from_torch(sd, f"{prefix}.inter_module"),
    }
    if use_gate:
        p["gate"] = mlp_from_torch(sd, f"{prefix}.gate")
    return p


def node_block_from_torch(sd: Dict, prefix: str, use_gate: bool) -> dict:
    p = {
        "node_net": mlp_from_torch(sd, f"{prefix}.node_net"),
        "edge_net": mlp_from_torch(sd, f"{prefix}.edge_net"),
        "msg_net": linear_from_torch(sd, f"{prefix}.msg_net"),
        "centroid_lin": linear_from_torch(sd, f"{prefix}.centroid_lin"),
        "ln": layernorm_from_torch(sd, f"{prefix}.layer_norm"),
        "out": linear_from_torch(sd, f"{prefix}.out_transform"),
    }
    if use_gate:
        p["gate"] = mlp_from_torch(sd, f"{prefix}.gate")
    return p


def edge_block_from_torch(sd: Dict, prefix: str, use_gate: bool) -> dict:
    return {
        "bond_ffn_left": bond_ffn_from_torch(sd, f"{prefix}.bond_ffn_left", use_gate),
        "bond_ffn_right": bond_ffn_from_torch(sd, f"{prefix}.bond_ffn_right", use_gate),
        "node_ffn_left": linear_from_torch(sd, f"{prefix}.node_ffn_left"),
        "node_ffn_right": linear_from_torch(sd, f"{prefix}.node_ffn_right"),
        "self_ffn": linear_from_torch(sd, f"{prefix}.self_ffn"),
        "ln": layernorm_from_torch(sd, f"{prefix}.layer_norm"),
        "out": linear_from_torch(sd, f"{prefix}.out_transform"),
    }


def pos_update_from_torch(sd: Dict, prefix: str, use_gate: bool) -> dict:
    return {
        "left_lin_edge": mlp_from_torch(sd, f"{prefix}.left_lin_edge"),
        "right_lin_edge": mlp_from_torch(sd, f"{prefix}.right_lin_edge"),
        "edge_lin": bond_ffn_from_torch(sd, f"{prefix}.edge_lin", use_gate),
    }


def denoiser_from_torch(sd: Dict, prefix: str, num_blocks: int, use_gate: bool,
                        update_edge: bool = True, update_pos: bool = True) -> dict:
    blocks = []
    for i in range(num_blocks):
        blk = {
            "node_block": node_block_from_torch(
                sd, f"{prefix}.node_blocks_with_edge.{i}", use_gate
            ),
            "edge_emb": linear_from_torch(sd, f"{prefix}.edge_embs.{i}"),
        }
        if update_edge:
            blk["edge_block"] = edge_block_from_torch(
                sd, f"{prefix}.edge_blocks.{i}", use_gate
            )
        if update_pos:
            blk["pos_block"] = pos_update_from_torch(
                sd, f"{prefix}.pos_blocks.{i}", use_gate
            )
        blocks.append(blk)
    return {"blocks": tree_map(lambda *xs: np.stack(xs), *blocks)}


def convert_moldiff_state_dict(sd: Dict, config,
                               device: "str | torch.device | None" = None) -> dict:
    """Reference MolDiff state_dict -> the port's param tree
    (models/moldiff.py init_params layout) on ``device`` (the card unless
    told otherwise)."""
    den = config["denoiser"]
    params = {
        "node_embedder": linear_from_torch(sd, "node_embedder", bias=False),
        "edge_embedder": linear_from_torch(sd, "edge_embedder", bias=False),
        "denoiser": denoiser_from_torch(
            sd, "denoiser",
            num_blocks=den["num_blocks"], use_gate=den["use_gate"],
            update_edge=den.get("update_edge", True),
            update_pos=den.get("update_pos", True),
        ),
        "node_decoder": mlp_from_torch(sd, "node_decoder"),
        "edge_decoder": mlp_from_torch(sd, "edge_decoder"),
    }
    return params_to_torch(params, resolve_device(device))


def convert_bond_predictor_state_dict(sd: Dict, config,
                                      device: "str | torch.device | None" = None) -> dict:
    """Reference BondPredictor state_dict -> the port's param tree
    (models/bond_predictor.py init_params layout; 3-layer edge decoder) on
    ``device`` (the card unless told otherwise)."""
    enc = config["encoder"]
    params = {
        "node_embedder": linear_from_torch(sd, "node_embedder", bias=False),
        "edge_embedder": linear_from_torch(sd, "edge_embedder", bias=False),
        "encoder": denoiser_from_torch(
            sd, "encoder",
            num_blocks=enc["num_blocks"], use_gate=enc["use_gate"],
            update_edge=enc.get("update_edge", True),
            update_pos=enc.get("update_pos", True),
        ),
        "edge_decoder": mlp_from_torch(sd, "edge_decoder", num_layer=3),
    }
    return params_to_torch(params, resolve_device(device))


def load_reference_checkpoint(path: str):
    """A reference ``.pt`` checkpoint -> (state_dict of numpy arrays,
    Config). Its EasyDict config unpickles through a stand-in when the
    easydict package is absent, and becomes the port's Config. The file is
    unpickled in full (``weights_only=False``): load only checkpoints you
    trust."""
    _ensure_easydict_stub()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v
          for k, v in ckpt["model"].items()}
    config = Config(_to_plain(ckpt["config"]))
    return sd, config


def _to_plain(d):
    if isinstance(d, dict):
        return {k: _to_plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_to_plain(x) for x in d)
    return d


# ---------------------------------------------------------------------------
# reverse direction: the port's param tree -> reference torch state_dict
# ---------------------------------------------------------------------------

def linear_to_torch(p: dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])


def layernorm_to_torch(p: dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def mlp_to_torch(p: dict, prefix: str, out: Dict) -> None:
    """Inverse of :func:`mlp_from_torch` (Sequential indices 3k / 3k+1)."""
    layers = p["layers"]
    for k, lp in enumerate(layers):
        idx = 3 * k
        linear_to_torch(lp["lin"], f"{prefix}.net.{idx}", out)
        if "ln" in lp:
            layernorm_to_torch(lp["ln"], f"{prefix}.net.{idx + 1}", out)


def bond_ffn_to_torch(p: dict, prefix: str, out: Dict) -> None:
    linear_to_torch(p["bond_linear"], f"{prefix}.bond_linear", out)
    linear_to_torch(p["node_linear"], f"{prefix}.node_linear", out)
    mlp_to_torch(p["inter"], f"{prefix}.inter_module", out)
    if "gate" in p:
        mlp_to_torch(p["gate"], f"{prefix}.gate", out)


def node_block_to_torch(p: dict, prefix: str, out: Dict) -> None:
    mlp_to_torch(p["node_net"], f"{prefix}.node_net", out)
    mlp_to_torch(p["edge_net"], f"{prefix}.edge_net", out)
    linear_to_torch(p["msg_net"], f"{prefix}.msg_net", out)
    linear_to_torch(p["centroid_lin"], f"{prefix}.centroid_lin", out)
    layernorm_to_torch(p["ln"], f"{prefix}.layer_norm", out)
    linear_to_torch(p["out"], f"{prefix}.out_transform", out)
    if "gate" in p:
        mlp_to_torch(p["gate"], f"{prefix}.gate", out)


def edge_block_to_torch(p: dict, prefix: str, out: Dict) -> None:
    bond_ffn_to_torch(p["bond_ffn_left"], f"{prefix}.bond_ffn_left", out)
    bond_ffn_to_torch(p["bond_ffn_right"], f"{prefix}.bond_ffn_right", out)
    linear_to_torch(p["node_ffn_left"], f"{prefix}.node_ffn_left", out)
    linear_to_torch(p["node_ffn_right"], f"{prefix}.node_ffn_right", out)
    linear_to_torch(p["self_ffn"], f"{prefix}.self_ffn", out)
    layernorm_to_torch(p["ln"], f"{prefix}.layer_norm", out)
    linear_to_torch(p["out"], f"{prefix}.out_transform", out)


def pos_update_to_torch(p: dict, prefix: str, out: Dict) -> None:
    mlp_to_torch(p["left_lin_edge"], f"{prefix}.left_lin_edge", out)
    mlp_to_torch(p["right_lin_edge"], f"{prefix}.right_lin_edge", out)
    bond_ffn_to_torch(p["edge_lin"], f"{prefix}.edge_lin", out)


def denoiser_to_torch(params: dict, prefix: str, out: Dict) -> None:
    """Unstack the block axis back into the reference's per-block module
    lists (node_blocks_with_edge / edge_embs / edge_blocks / pos_blocks)."""
    stacked = params["blocks"]
    num_blocks = int(tree_leaves(stacked)[0].shape[0])
    for i in range(num_blocks):
        blk = tree_map(lambda x: x[i], stacked)
        node_block_to_torch(
            blk["node_block"], f"{prefix}.node_blocks_with_edge.{i}", out
        )
        linear_to_torch(blk["edge_emb"], f"{prefix}.edge_embs.{i}", out)
        if "edge_block" in blk:
            edge_block_to_torch(
                blk["edge_block"], f"{prefix}.edge_blocks.{i}", out
            )
        if "pos_block" in blk:
            pos_update_to_torch(
                blk["pos_block"], f"{prefix}.pos_blocks.{i}", out
            )


def export_moldiff_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """The port's (or the JAX package's) MolDiff param tree -> reference
    state_dict arrays, the inverse of :func:`convert_moldiff_state_dict`: a
    reference models/model.py MolDiff built from the same config accepts it
    through ``load_state_dict(..., strict=False)`` (its schedule and
    time-embedding buffers are rebuilt from the config; every trainable
    parameter is here). Values are float32 numpy arrays; wrap them with
    ``torch.from_numpy`` to save a reference-format checkpoint."""
    out: Dict[str, np.ndarray] = {}
    linear_to_torch(params["node_embedder"], "node_embedder", out)
    linear_to_torch(params["edge_embedder"], "edge_embedder", out)
    denoiser_to_torch(params["denoiser"], "denoiser", out)
    mlp_to_torch(params["node_decoder"], "node_decoder", out)
    mlp_to_torch(params["edge_decoder"], "edge_decoder", out)
    return out


def export_bond_predictor_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """The port's BondPredictor param tree -> reference state_dict arrays
    (the inverse of :func:`convert_bond_predictor_state_dict`)."""
    out: Dict[str, np.ndarray] = {}
    linear_to_torch(params["node_embedder"], "node_embedder", out)
    linear_to_torch(params["edge_embedder"], "edge_embedder", out)
    denoiser_to_torch(params["encoder"], "encoder", out)
    mlp_to_torch(params["edge_decoder"], "edge_decoder", out)
    return out
