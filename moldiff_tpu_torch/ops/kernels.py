"""The denoiser's three forward pair kernels, their wrappers and their
plain PyTorch versions.

Each function here stands for one Pallas kernel of
moldiff_tpu/ops/pallas_kernels.py and computes what that kernel's body
computes, with the same bf16 roundings (every product accumulated in
float32, biases and LayerNorm parameters read as float32):

  node_block_aggregate  <- _node_block_kernel  (NodeBlock gated message sum)
  edge_pair_aggregate   <- _edge_pair_kernel   (EdgeBlock's two BondFFN chains
                                                and their endpoint sums)
  pos_update            <- _pos_update_kernel  (PosUpdate force sum)

A wrapper takes its plain version (``*_plain``) for tensors on the CPU,
which is where the tests run. For CUDA tensors it launches the hand-written
kernel of ``csrc/`` (built by ops/build.py) or raises: there is no fallback.
The kernels take bf16 activations and bf16 parameters (the denoiser casts
its parameters to the compute dtype first, as the JAX package does), and
float32 masks, times, relative vectors and distances.

``launch_counts`` counts the kernel launches of each wrapper, as the C
function reports them: each call launches two kernels, a node-level prep
kernel and the pair kernel. Nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

launch_counts: Dict[str, int] = {"node_block": 0, "edge_pair": 0, "pos_update": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w accumulated in float32 (``jnp.dot(..., preferred_element_type=
    float32)``): products of bf16 values are exact in float32."""
    return a.float() @ w.float()


def _ln32(h: torch.Tensor, ln: dict, eps: float = 1e-5) -> torch.Tensor:
    mean = h.mean(dim=-1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * ln["scale"].float() + ln["bias"].float()


def _mlp2(x: torch.Tensor, p: dict, dt: torch.dtype) -> torch.Tensor:
    """Linear -> LN -> ReLU -> (dt) -> Linear, float32 result."""
    l0, l1 = p["layers"]
    h = _dot(x, l0["lin"]["w"]) + l0["lin"]["b"].float()
    h = torch.relu(_ln32(h, l0["ln"])).to(dt)
    return _dot(h, l1["lin"]["w"]) + l1["lin"]["b"].float()


def _time_col(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1).float()


def node_block_aggregate_plain(params, x, edge_attr, node_time, pair_mask):
    """pallas_kernels.py:_node_block_kernel. x [B,N,Dn], edge_attr
    [B,N,N,De], node_time [B,1,1], pair_mask [B,N,N] -> [B,N,H] in x's dtype."""
    dt = x.dtype
    de, dn = edge_attr.shape[-1], x.shape[-1]
    h = _mlp2(edge_attr, params["edge_net"], dt).to(dt)
    xn = _mlp2(x, params["node_net"], dt).to(dt)
    hh = h * xn[:, None, :, :]
    msg = (_dot(hh, params["msg_net"]["w"]) + params["msg_net"]["b"].float()).to(dt)
    g0, g1 = params["gate"]["layers"]
    wg1 = g0["lin"]["w"]
    g = (_dot(edge_attr, wg1[:de]) + _dot(x, wg1[de:de + dn])[:, None, :, :]
         + _time_col(node_time) * wg1[de + dn].float() + g0["lin"]["b"].float())
    g = torch.relu(_ln32(g, g0["ln"])).to(dt)
    g = torch.sigmoid(_dot(g, g1["lin"]["w"]) + g1["lin"]["b"].float()).to(dt)
    gated = (msg * g).float() * pair_mask.float()[..., None]
    return gated.sum(dim=2).to(dt)


def _bond_chain(p, e, x, t, node_axis: int, dt):
    """One gated BondFFN chain of pallas_kernels.py:_edge_side_chain; the
    node features x [B,N,Dn] index the pair axis ``node_axis``."""
    de, dn = e.shape[-1], x.shape[-1]
    expand = (lambda a: a[:, :, None]) if node_axis == 1 else (lambda a: a[:, None])
    inter0 = _dot(e, p["bond_linear"]["w"]) * expand(_dot(x, p["node_linear"]["w"]))
    out = _mlp2(inter0.to(dt), p["inter"], dt)
    g0, g1 = p["gate"]["layers"]
    wg1 = g0["lin"]["w"]
    g = (_dot(e, wg1[:de]) + expand(_dot(x, wg1[de:de + dn]))
         + _time_col(t) * wg1[de + dn].float() + g0["lin"]["b"].float())
    g = torch.relu(_ln32(g, g0["ln"])).to(dt)
    sig = torch.sigmoid(_dot(g, g1["lin"]["w"]) + g1["lin"]["b"].float())
    return out * sig


def edge_pair_aggregate_plain(params, h_bond, h_node, bond_time, pair_mask):
    """pallas_kernels.py:_edge_pair_kernel. params {'left', 'right'} BondFFN
    params; h_bond [B,N,N,De], h_node [B,N,Dn] -> (t [B,N,Do], u [B,N,Do]):
    t[j] = sum_i left chain (node features of i), u[i] = sum_j right chain
    (node features of j)."""
    dt = h_bond.dtype
    mask4 = pair_mask.float()[..., None]
    msg_l = _bond_chain(params["left"], h_bond, h_node, bond_time, 1, dt)
    t_out = (msg_l * mask4).sum(dim=1).to(dt)
    msg_r = _bond_chain(params["right"], h_bond, h_node, bond_time, 2, dt)
    u_out = (msg_r * mask4).sum(dim=2).to(dt)
    return t_out, u_out


def pos_update_plain(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask):
    """pallas_kernels.py:_pos_update_kernel -> [B,N,3] float32."""
    dt = h_node.dtype
    lout = _mlp2(h_node, params["left_lin_edge"], dt).to(dt)
    rout = _mlp2(h_node, params["right_lin_edge"], dt).to(dt)
    xp = (lout.float()[:, :, None, :] * rout.float()[:, None, :, :]).to(dt)
    el = params["edge_lin"]
    de, dxp = h_edge.shape[-1], xp.shape[-1]
    inter0 = _dot(h_edge, el["bond_linear"]["w"]) * _dot(xp, el["node_linear"]["w"])
    out = _mlp2(inter0.to(dt), el["inter"], dt)
    g0, g1 = el["gate"]["layers"]
    wg1 = g0["lin"]["w"]
    g = (_dot(h_edge, wg1[:de]) + _dot(xp, wg1[de:de + dxp])
         + _time_col(edge_time) * wg1[de + dxp].float() + g0["lin"]["b"].float())
    g = torch.relu(_ln32(g, g0["ln"])).to(dt)
    w = out * torch.sigmoid(_dot(g, g1["lin"]["w"]) + g1["lin"]["b"].float())
    mask4 = pair_mask.float()[..., None]
    d_safe = torch.where(mask4 > 0, distance.float()[..., None], torch.ones_like(mask4))
    force = w * rel_vec.float() * (1.0 / d_safe) * (1.0 / (d_safe + 1.0)) * mask4
    return force.sum(dim=2)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _mlp_leaves(p: dict) -> List[torch.Tensor]:
    l0, l1 = p["layers"]
    return [l0["lin"]["w"], l0["lin"]["b"], l0["ln"]["scale"], l0["ln"]["bias"],
            l1["lin"]["w"], l1["lin"]["b"]]


def _bond_ffn_leaves(p: dict) -> List[torch.Tensor]:
    return ([p["bond_linear"]["w"], p["node_linear"]["w"]]
            + _mlp_leaves(p["inter"]) + _mlp_leaves(p["gate"]))


def _check(name: str, t: torch.Tensor, shape: Sequence[int], dtype: torch.dtype,
           device: torch.device, align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: address not {align}-byte aligned")


def _check_weights(kernel: str, leaves: List[torch.Tensor], shapes: List[Sequence[int]],
                   device: torch.device) -> None:
    for k, (t, shape) in enumerate(zip(leaves, shapes)):
        # matrices are read as 16x16 tensor-core tiles: 32-byte alignment
        _check(f"{kernel} weight {k}", t, shape, torch.bfloat16, device,
               align=32 if len(shape) == 2 else 2)


def _mlp_shapes(din: int, hid: int, dout: int) -> List[tuple]:
    return [(din, hid), (hid,), (hid,), (hid,), (hid, dout), (dout,)]


def _check_width(kernel: str, **widths: int) -> None:
    for name, w in widths.items():
        if w % 32 or not 32 <= w <= 256:
            raise ValueError(f"{kernel}: {name} = {w}; the kernel takes multiples of 32 up to 256")


def _require_cuda(kernel: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {device}; the kernel runs on CUDA, "
                         "the plain version on the CPU")


def _pointers(tensors: List[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_pairs(kernel: str, b: int, n: int, device, pair_mask, time) -> torch.Tensor:
    if not 2 <= n <= 64:
        raise ValueError(f"{kernel}: N = {n}; the kernel takes 2 <= N <= 64")
    _check(f"{kernel} pair_mask", pair_mask, (b, n, n), torch.float32, device, align=4)
    t = time.reshape(-1)
    _check(f"{kernel} time", t, (b,), torch.float32, device, align=4)
    return t


def node_block_aggregate(params, x, edge_attr, node_time, pair_mask):
    """NodeBlock gated message sum (see node_block_aggregate_plain)."""
    if x.device.type == "cpu":
        return node_block_aggregate_plain(params, x, edge_attr, node_time, pair_mask)
    from . import build

    dev = x.device
    b, n, dn = x.shape
    de = edge_attr.shape[-1]
    h = params["msg_net"]["w"].shape[0]
    _check_width("node_block", Dn=dn, De=de, H=h)
    leaves = (_mlp_leaves(params["edge_net"]) + _mlp_leaves(params["node_net"])
              + [params["msg_net"]["w"], params["msg_net"]["b"]]
              + _mlp_leaves(params["gate"]))
    shapes = (_mlp_shapes(de, h, h) + _mlp_shapes(dn, h, h) + [(h, h), (h,)]
              + _mlp_shapes(de + dn + 1, h, h))
    _check_weights("node_block", leaves, shapes, dev)
    _check("node_block x", x, (b, n, dn), torch.bfloat16, dev)
    _check("node_block edge_attr", edge_attr, (b, n, n, de), torch.bfloat16, dev)
    t = _check_pairs("node_block", b, n, dev, pair_mask, node_time)
    xn = torch.empty((b, n, h), dtype=torch.bfloat16, device=dev)
    gpre = torch.empty((b, n, h), dtype=torch.float32, device=dev)
    out = torch.empty((b, n, h), dtype=torch.bfloat16, device=dev)
    _require_cuda("node_block", dev)
    lib = build.library()
    launched = ctypes.c_int(0)
    rc = lib.md_node_block_forward(
        _pointers(leaves + [x, edge_attr, pair_mask, t, xn, gpre, out]),
        b, n, dn, de, h, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "node_block")
    launch_counts["node_block"] += launched.value
    return out


def edge_pair_aggregate(params, h_bond, h_node, bond_time, pair_mask):
    """EdgeBlock pair aggregate (see edge_pair_aggregate_plain)."""
    if h_bond.device.type == "cpu":
        return edge_pair_aggregate_plain(params, h_bond, h_node, bond_time, pair_mask)
    from . import build

    dev = h_bond.device
    b, n, dn = h_node.shape
    de = h_bond.shape[-1]
    left = params["left"]
    i_dim = left["bond_linear"]["w"].shape[1]
    g = left["gate"]["layers"][0]["lin"]["w"].shape[1]
    do = left["inter"]["layers"][1]["lin"]["w"].shape[1]
    _check_width("edge_pair", Dn=dn, De=de, I=i_dim, G=g, Do=do)
    if g > i_dim or do > i_dim:
        raise ValueError("edge_pair: the gate and output widths must not exceed I")
    shapes = ([(de, i_dim), (dn, i_dim)] + _mlp_shapes(i_dim, i_dim, do)
              + _mlp_shapes(de + dn + 1, g, do))
    leaves = _bond_ffn_leaves(left) + _bond_ffn_leaves(params["right"])
    _check_weights("edge_pair", leaves, shapes + shapes, dev)
    _check("edge_pair h_bond", h_bond, (b, n, n, de), torch.bfloat16, dev)
    _check("edge_pair h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    t = _check_pairs("edge_pair", b, n, dev, pair_mask, bond_time)
    np_ = torch.empty((2, b, n, i_dim), dtype=torch.float32, device=dev)
    gpre = torch.empty((2, b, n, g), dtype=torch.float32, device=dev)
    out = torch.empty((2, b, n, do), dtype=torch.bfloat16, device=dev)
    _require_cuda("edge_pair", dev)
    lib = build.library()
    launched = ctypes.c_int(0)
    rc = lib.md_edge_pair_forward(
        _pointers(leaves + [h_bond, h_node, pair_mask, t, np_, gpre, out]),
        b, n, dn, de, i_dim, g, do, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "edge_pair")
    launch_counts["edge_pair"] += launched.value
    return out[0], out[1]


def pos_update(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask):
    """PosUpdate force sum (see pos_update_plain)."""
    if h_node.device.type == "cpu":
        return pos_update_plain(params, h_node, h_edge, rel_vec, distance, edge_time,
                                pair_mask)
    from . import build

    dev = h_node.device
    b, n, dn = h_node.shape
    de = h_edge.shape[-1]
    dl = params["left_lin_edge"]["layers"][1]["lin"]["w"].shape[1]
    hl = params["left_lin_edge"]["layers"][0]["lin"]["w"].shape[1]
    el = params["edge_lin"]
    i_dim = el["bond_linear"]["w"].shape[1]
    g = el["gate"]["layers"][0]["lin"]["w"].shape[1]
    _check_width("pos_update", Dn=dn, De=de, Dl=dl, I=i_dim, G=g)
    if hl != dl:
        raise ValueError("pos_update: the node MLPs' hidden width must equal their output")
    shapes = (_mlp_shapes(dn, dl, dl) * 2 + [(de, i_dim), (dl, i_dim)]
              + _mlp_shapes(i_dim, i_dim, 1) + _mlp_shapes(de + dl + 1, g, 1))
    leaves = (_mlp_leaves(params["left_lin_edge"]) + _mlp_leaves(params["right_lin_edge"])
              + _bond_ffn_leaves(el))
    _check_weights("pos_update", leaves, shapes, dev)
    _check("pos_update h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    _check("pos_update h_edge", h_edge, (b, n, n, de), torch.bfloat16, dev)
    _check("pos_update rel_vec", rel_vec, (b, n, n, 3), torch.float32, dev, align=4)
    _check("pos_update distance", distance, (b, n, n), torch.float32, dev, align=4)
    t = _check_pairs("pos_update", b, n, dev, pair_mask, edge_time)
    lr = torch.empty((2, b, n, dl), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    _require_cuda("pos_update", dev)
    lib = build.library()
    launched = ctypes.c_int(0)
    rc = lib.md_pos_update_forward(
        _pointers(leaves + [h_node, h_edge, rel_vec, distance, pair_mask, t, lr, out]),
        b, n, dn, de, dl, i_dim, g, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "pos_update")
    launch_counts["pos_update"] += launched.value
    return out
