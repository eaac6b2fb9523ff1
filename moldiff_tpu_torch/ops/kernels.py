"""The denoiser's pair kernels, forward and backward, their wrappers and
their plain PyTorch versions.

Each function here stands for one Pallas kernel of
moldiff_tpu/ops/pallas_kernels.py and computes what that kernel's body
computes, with the same bf16 roundings (every product accumulated in
float32, biases and LayerNorm parameters read as float32):

  node_block_aggregate  <- _node_block_kernel  (NodeBlock gated message sum)
  edge_pair_aggregate   <- _edge_pair_kernel   (EdgeBlock's two BondFFN chains
                                                and their endpoint sums)
  pos_update            <- _pos_update_kernel  (PosUpdate force sum)
  node_block_aggregate_bwd <- _node_block_bwd_kernel (recompute + cotangents)
  edge_pair_aggregate_bwd  <- _edge_pair_bwd_kernel  (recompute + cotangents)
  pos_update_bwd           <- _pos_update_bwd_kernel (recompute + cotangents)

The backward versions return cotangents matching the primal signature, as
the Pallas wrappers do: (d_params, then one cotangent per input), parameter
grads accumulated in float32 and cast to the parameter dtype at the end.
Like the Pallas backward bodies, their recompute keeps the sigmoid and the
message in float32 where the forward rounds them to bf16.
:func:`node_block_aggregate_ad`, :func:`edge_pair_aggregate_ad` and
:func:`pos_update_ad` are the differentiable versions: a
``torch.autograd.Function`` whose forward is the forward wrapper and whose
backward is the backward wrapper.

A wrapper takes its plain version (``*_plain``) for tensors on the CPU,
which is where the tests run. For CUDA tensors it launches the hand-written
kernel of ``csrc/`` (built by ops/build.py) or raises: there is no fallback.
The kernels take bf16 activations and bf16 parameters (the denoiser casts
its parameters to the compute dtype first, as the JAX package does), and
float32 masks, times, relative vectors and distances.

``launch_counts`` counts the kernel launches of each wrapper, as the C
function reports them: each forward call launches two kernels, a
node-level prep kernel and the pair kernel; a backward call launches the
kernels its C entry point lists. Nothing else changes it.

The NodeBlock and EdgeBlock backward wrappers take ``need_params`` and
``need_time``; their autograd Functions set them from
``ctx.needs_input_grad``. Guidance differentiates positions alone, so its
backward forms no parameter gradient (no weight-gradient or reduction
launch) and no d_t; what is formed equals the full mode's bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

launch_counts: Dict[str, int] = {"node_block": 0, "edge_pair": 0, "pos_update": 0,
                                  "node_block_bwd": 0, "edge_pair_bwd": 0,
                                  "pos_update_bwd": 0, "fused_block": 0, "edge_block_full": 0,
                                  "edge_block_full_bwd": 0}


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


def _edge_sums(params, h_bond, h_node, bond_time, pair_mask, round_msg: bool):
    """The two chains' masked endpoint sums, rounded to h_bond's dtype; with
    ``round_msg`` each message is rounded to it first (the whole-block
    kernel's _bond_ffn_flat)."""
    dt = h_bond.dtype
    mask4 = pair_mask.float()[..., None]
    rnd = (lambda m: m.to(dt).float()) if round_msg else (lambda m: m)
    msg_l = rnd(_bond_chain(params["left"], h_bond, h_node, bond_time, 1, dt))
    t_out = (msg_l * mask4).sum(dim=1).to(dt)
    msg_r = rnd(_bond_chain(params["right"], h_bond, h_node, bond_time, 2, dt))
    u_out = (msg_r * mask4).sum(dim=2).to(dt)
    return t_out, u_out


def edge_pair_aggregate_plain(params, h_bond, h_node, bond_time, pair_mask):
    """pallas_kernels.py:_edge_pair_kernel. params {'left', 'right'} BondFFN
    params; h_bond [B,N,N,De], h_node [B,N,Dn] -> (t [B,N,Do], u [B,N,Do]):
    t[j] = sum_i left chain (node features of i), u[i] = sum_j right chain
    (node features of j)."""
    return _edge_sums(params, h_bond, h_node, bond_time, pair_mask, False)


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
# plain backward versions
# ---------------------------------------------------------------------------

def _ln_stats(h: torch.Tensor, ln: dict, eps: float = 1e-5):
    """pallas_kernels.py:_ln_fwd_stats: (LN output, xhat, 1/std), float32."""
    mean = h.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(((h - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
    xhat = (h - mean) * inv
    return xhat * ln["scale"].float() + ln["bias"].float(), xhat, inv


def _ln_bwd(d_y: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor, ln: dict):
    """pallas_kernels.py:_ln_bwd: (d_h, per-row d_scale); d_bias rows = d_y."""
    d_xhat = d_y * ln["scale"].float()
    m1 = d_xhat.mean(dim=-1, keepdim=True)
    m2 = (d_xhat * xhat).mean(dim=-1, keepdim=True)
    return inv * (d_xhat - m1 - xhat * m2), d_y * xhat


def _dot_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T accumulated in float32."""
    return a.float() @ w.float().t()


def _wgrad(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum over rows of a[r]^T d[r] (a [..., K1], d [..., K2]) -> [K1, K2] float32."""
    return a.reshape(-1, a.shape[-1]).float().t() @ d.reshape(-1, d.shape[-1]).float()


def _rows(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1]).float().sum(dim=0)


def _mlp_grads(dw0, db0, dscale, dbias, dw1, db1) -> dict:
    return {"layers": [{"lin": {"w": dw0, "b": db0}, "ln": {"scale": dscale, "bias": dbias}},
                       {"lin": {"w": dw1, "b": db1}}]}


def _cast_like(grads, params):
    if isinstance(grads, dict):
        return {k: _cast_like(grads[k], params[k]) for k in grads}
    if isinstance(grads, (list, tuple)):
        return type(grads)(_cast_like(g, p) for g, p in zip(grads, params))
    return grads.to(params.dtype)


def _drop(out: tuple, need_params: bool, need_time: bool) -> tuple:
    """Rows 3 and 5's cotangents (d_params, ..., d_time at 3, d_mask) with
    what is not asked for left out (None)."""
    out = list(out)
    if not need_params:
        out[0] = None
    if not need_time:
        out[3] = None
    return tuple(out)


def node_block_aggregate_bwd_plain(params, x, edge_attr, node_time, pair_mask, dout,
                                   need_params: bool = True, need_time: bool = True):
    """pallas_kernels.py:_node_block_bwd_kernel (as _pallas_node_block_bwd
    wraps it) -> (d_params, dx, d_edge, d_time, d_mask); d_params (without
    need_params) and d_time (without need_time) are None, as the kernel's
    wrapper leaves them."""
    dt = x.dtype
    de, dn = edge_attr.shape[-1], x.shape[-1]
    pe0, pe1 = params["edge_net"]["layers"]
    pn0, pn1 = params["node_net"]["layers"]
    pg0, pg1 = params["gate"]["layers"]
    wm = params["msg_net"]["w"]
    wg1 = pg0["lin"]["w"]
    t = node_time.reshape(-1).float()

    # forward recompute, float32 sigmoid and message
    h1 = _dot(edge_attr, pe0["lin"]["w"]) + pe0["lin"]["b"].float()
    ln_e, xhat_e, inv_e = _ln_stats(h1, pe0["ln"])
    r1 = torch.relu(ln_e).to(dt)
    h = (_dot(r1, pe1["lin"]["w"]) + pe1["lin"]["b"].float()).to(dt)
    hn1 = _dot(x, pn0["lin"]["w"]) + pn0["lin"]["b"].float()
    ln_n, xhat_n, inv_n = _ln_stats(hn1, pn0["ln"])
    rn = torch.relu(ln_n).to(dt)
    xn = (_dot(rn, pn1["lin"]["w"]) + pn1["lin"]["b"].float()).to(dt)
    hh = h * xn[:, None, :, :]
    msg = (_dot(hh, wm) + params["msg_net"]["b"].float()).to(dt)
    g1 = (_dot(edge_attr, wg1[:de]) + _dot(x, wg1[de:de + dn])[:, None, :, :]
          + _time_col(node_time) * wg1[de + dn].float() + pg0["lin"]["b"].float())
    ln_g, xhat_g, inv_g = _ln_stats(g1, pg0["ln"])
    rg = torch.relu(ln_g).to(dt)
    sig = torch.sigmoid(_dot(rg, pg1["lin"]["w"]) + pg1["lin"]["b"].float())

    # backward
    dout4 = dout.float()[:, :, None, :]
    d_gated = dout4 * pair_mask.float()[..., None]
    msg_f = msg.float()
    d_msg = d_gated * sig
    d_sig = d_gated * msg_f
    d_mask = (dout4 * (msg_f * sig)).sum(dim=-1)
    d_hh = _dot_t(d_msg, wm)
    d_h = d_hh * xn.float()[:, None, :, :]
    d_xn = (d_hh * h.float()).sum(dim=1)                      # over receivers
    d_lne = _dot_t(d_h, pe1["lin"]["w"]) * (ln_e > 0)
    d_h1, dse_rows = _ln_bwd(d_lne, xhat_e, inv_e, pe0["ln"])
    d_e_edge = _dot_t(d_h1.to(dt), pe0["lin"]["w"])
    d_lnn = _dot_t(d_xn, pn1["lin"]["w"]) * (ln_n > 0)
    d_hn1, dsn_rows = _ln_bwd(d_lnn, xhat_n, inv_n, pn0["ln"])
    d_x_node = _dot_t(d_hn1.to(dt), pn0["lin"]["w"])
    d_g2 = d_sig * sig * (1.0 - sig)
    d_lng = _dot_t(d_g2.to(dt), pg1["lin"]["w"]) * (ln_g > 0)
    d_g1, dsg_rows = _ln_bwd(d_lng, xhat_g, inv_g, pg0["ln"])
    d_e_gate = _dot_t(d_g1.to(dt), wg1[:de])
    s_sender = d_g1.sum(dim=1)                                # over receivers
    d_x_gate = _dot_t(s_sender.to(dt), wg1[de:de + dn])
    d_g1_tot = d_g1.sum(dim=(1, 2))                           # [B, H]
    d_t = d_g1_tot @ wg1[de + dn].float()

    d_params = {
        "edge_net": _mlp_grads(_wgrad(edge_attr, d_h1), _rows(d_h1), _rows(dse_rows),
                               _rows(d_lne), _wgrad(r1, d_h), _rows(d_h)),
        "node_net": _mlp_grads(_wgrad(x, d_hn1), _rows(d_hn1), _rows(dsn_rows),
                               _rows(d_lnn), _wgrad(rn, d_xn), _rows(d_xn)),
        "msg_net": {"w": _wgrad(hh, d_msg), "b": _rows(d_msg)},
        "gate": _mlp_grads(
            torch.cat([_wgrad(edge_attr, d_g1), _wgrad(x, s_sender),
                       (t[:, None] * d_g1_tot).sum(dim=0)[None]], dim=0),
            _rows(d_g1), _rows(dsg_rows), _rows(d_lng), _wgrad(rg, d_g2), _rows(d_g2)),
    }
    return _drop((_cast_like(d_params, params), (d_x_node + d_x_gate).to(dt),
                  (d_e_edge + d_e_gate).to(dt), d_t.reshape(node_time.shape).to(node_time.dtype),
                  d_mask.to(pair_mask.dtype)), need_params, need_time)


def _bond_chain_bwd(p, e, x, t, mask4, d_red, node_axis: int, dt):
    """pallas_kernels.py:_edge_side_bwd for one gated BondFFN chain and its
    masked endpoint sum, given the cotangent d_red broadcast to the pairs ->
    (d_params (float32), d_e, d_x, d_time, d_mask)."""
    de, dn = e.shape[-1], x.shape[-1]
    expand = (lambda a: a[:, :, None]) if node_axis == 1 else (lambda a: a[:, None])
    sum_axis = 3 - node_axis          # the axis the node features broadcast over
    pi0, pi1 = p["inter"]["layers"]
    pg0, pg1 = p["gate"]["layers"]
    wb, wn, wg1 = p["bond_linear"]["w"], p["node_linear"]["w"], pg0["lin"]["w"]

    bp = _dot(e, wb)
    np_ = _dot(x, wn)
    inter0 = bp * expand(np_)
    h1 = _dot(inter0.to(dt), pi0["lin"]["w"]) + pi0["lin"]["b"].float()
    ln1, xhat1, inv1 = _ln_stats(h1, pi0["ln"])
    r1 = torch.relu(ln1).to(dt)
    out_i = _dot(r1, pi1["lin"]["w"]) + pi1["lin"]["b"].float()
    g1 = (_dot(e, wg1[:de]) + expand(_dot(x, wg1[de:de + dn]))
          + _time_col(t) * wg1[de + dn].float() + pg0["lin"]["b"].float())
    lng, xhatg, invg = _ln_stats(g1, pg0["ln"])
    rg = torch.relu(lng).to(dt)
    sig = torch.sigmoid(_dot(rg, pg1["lin"]["w"]) + pg1["lin"]["b"].float())

    d_mask = (d_red * (out_i * sig)).sum(dim=-1)
    d_msg = d_red * mask4
    d_out_i = d_msg * sig
    d_g2 = d_msg * out_i * sig * (1.0 - sig)
    d_lng = _dot_t(d_g2.to(dt), pg1["lin"]["w"]) * (lng > 0)
    d_g1, dsg_rows = _ln_bwd(d_lng, xhatg, invg, pg0["ln"])
    d_e_gate = _dot_t(d_g1.to(dt), wg1[:de])
    s_node = d_g1.sum(dim=sum_axis)
    d_x_gate = _dot_t(s_node.to(dt), wg1[de:de + dn])
    d_g1_tot = d_g1.sum(dim=(1, 2))
    d_time = d_g1_tot @ wg1[de + dn].float()
    d_ln1 = _dot_t(d_out_i.to(dt), pi1["lin"]["w"]) * (ln1 > 0)
    d_h1, ds1_rows = _ln_bwd(d_ln1, xhat1, inv1, pi0["ln"])
    d_inter0 = _dot_t(d_h1.to(dt), pi0["lin"]["w"])
    d_bp = d_inter0 * expand(np_)
    d_np = (d_inter0 * bp).sum(dim=sum_axis)
    d_e = _dot_t(d_bp.to(dt), wb) + d_e_gate
    d_x = d_x_gate + _dot_t(d_np.to(dt), wn)

    tv = t.reshape(-1).float()
    d_params = {
        "bond_linear": {"w": _wgrad(e, d_bp)},
        "node_linear": {"w": _wgrad(x, d_np)},
        "inter": _mlp_grads(_wgrad(inter0, d_h1), _rows(d_h1), _rows(ds1_rows),
                            _rows(d_ln1), _wgrad(r1, d_out_i), _rows(d_out_i)),
        "gate": _mlp_grads(
            torch.cat([_wgrad(e, d_g1), _wgrad(x, s_node),
                       (tv[:, None] * d_g1_tot).sum(dim=0)[None]], dim=0),
            _rows(d_g1), _rows(dsg_rows), _rows(d_lng), _wgrad(rg, d_g2), _rows(d_g2)),
    }
    return d_params, d_e, d_x, d_time, d_mask


def edge_pair_aggregate_bwd_plain(params, h_bond, h_node, bond_time, pair_mask, dt_ct, du_ct,
                                  need_params: bool = True, need_time: bool = True):
    """pallas_kernels.py:_edge_pair_bwd_kernel (as _pallas_edge_pair_bwd
    wraps it): cotangents dt_ct, du_ct [B,N,Do] of (t, u) -> (d_params,
    d_bond, d_node, d_time, d_mask). t sums over rows, so its cotangent
    broadcasts back over rows; u's over columns. The two flags as
    node_block_aggregate_bwd_plain's."""
    dt = h_bond.dtype
    mask4 = pair_mask.float()[..., None]
    left = _bond_chain_bwd(params["left"], h_bond, h_node, bond_time, mask4,
                           dt_ct.float()[:, None, :, :], 1, dt)
    right = _bond_chain_bwd(params["right"], h_bond, h_node, bond_time, mask4,
                            du_ct.float()[:, :, None, :], 2, dt)
    d_params = _cast_like({"left": left[0], "right": right[0]}, params)
    return _drop((d_params, (left[1] + right[1]).to(dt), (left[2] + right[2]).to(dt),
                  (left[3] + right[3]).reshape(bond_time.shape).to(bond_time.dtype),
                  (left[4] + right[4]).to(pair_mask.dtype)), need_params, need_time)


def _mlp2_parts(x: torch.Tensor, p: dict, dt: torch.dtype):
    """_mlp2 keeping what its backward needs (pallas_kernels.py:_mlp_chain):
    (LN output, xhat, 1/std, relu output in dt, output in dt)."""
    l0, l1 = p["layers"]
    ln1, xhat1, inv1 = _ln_stats(_dot(x, l0["lin"]["w"]) + l0["lin"]["b"].float(), l0["ln"])
    r1 = torch.relu(ln1).to(dt)
    out = (_dot(r1, l1["lin"]["w"]) + l1["lin"]["b"].float()).to(dt)
    return ln1, xhat1, inv1, r1, out


def _mlp2_bwd(x: torch.Tensor, p: dict, parts, d_out: torch.Tensor, dt: torch.dtype):
    """pallas_kernels.py:_mlp_bwd given the float32 cotangent of _mlp2's
    output -> (float32 parameter grads, d_x)."""
    ln1, xhat1, inv1, r1, _ = parts
    l0, l1 = p["layers"]
    d_ln1 = _dot_t(d_out.to(dt), l1["lin"]["w"]) * (ln1 > 0)
    d_h1, ds_rows = _ln_bwd(d_ln1, xhat1, inv1, l0["ln"])
    d_x = _dot_t(d_h1.to(dt), l0["lin"]["w"])
    return _mlp_grads(_wgrad(x, d_h1), _rows(d_h1), _rows(ds_rows), _rows(d_ln1),
                      _wgrad(r1, d_out), _rows(d_out)), d_x


def pos_update_bwd_plain(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask, ct):
    """pallas_kernels.py:_pos_update_bwd_kernel (as _pallas_pos_update_bwd
    wraps it): cotangent ct [B,N,3] of the force sum -> (d_params, d_node,
    d_edge, d_rel_vec, d_distance, d_time, d_mask); d_rel_vec and d_distance
    float32, the gate's first-layer gradient as its e, xp and t rows."""
    dt = h_node.dtype
    parts_l = _mlp2_parts(h_node, params["left_lin_edge"], dt)
    parts_r = _mlp2_parts(h_node, params["right_lin_edge"], dt)
    lout, rout = parts_l[-1].float(), parts_r[-1].float()
    xp = (lout[:, :, None, :] * rout[:, None, :, :]).to(dt)
    el = params["edge_lin"]
    pi0, pi1 = el["inter"]["layers"]
    pg0, pg1 = el["gate"]["layers"]
    wb, wn, wg1 = el["bond_linear"]["w"], el["node_linear"]["w"], pg0["lin"]["w"]
    de, dxp = h_edge.shape[-1], xp.shape[-1]

    # forward recompute, float32 sigmoid and message
    bp = _dot(h_edge, wb)
    np_ = _dot(xp, wn)
    inter0 = bp * np_
    ln1, xhat1, inv1 = _ln_stats(_dot(inter0.to(dt), pi0["lin"]["w"]) + pi0["lin"]["b"].float(),
                                 pi0["ln"])
    r1 = torch.relu(ln1).to(dt)
    out_i = _dot(r1, pi1["lin"]["w"]) + pi1["lin"]["b"].float()
    g1 = (_dot(h_edge, wg1[:de]) + _dot(xp, wg1[de:de + dxp])
          + _time_col(edge_time) * wg1[de + dxp].float() + pg0["lin"]["b"].float())
    lng, xhatg, invg = _ln_stats(g1, pg0["ln"])
    rg = torch.relu(lng).to(dt)
    sig = torch.sigmoid(_dot(rg, pg1["lin"]["w"]) + pg1["lin"]["b"].float())
    w = out_i * sig

    # force backward: q = 1/d', r = 1/(d'+1) (pallas_kernels.py:_pos_force_terms)
    mask4 = pair_mask.float()[..., None]
    d_safe = torch.where(mask4 > 0, distance.float()[..., None], torch.ones_like(mask4))
    q, r = 1.0 / d_safe, 1.0 / (d_safe + 1.0)
    qr = q * r
    ct4 = ct.float()[:, :, None, :]
    ct_dot_rv = (ct4 * rel_vec.float()).sum(dim=-1, keepdim=True)
    d_w = ct_dot_rv * qr * mask4
    d_rel = ct4 * w * qr * mask4
    d_mask = (ct_dot_rv * w * qr)[..., 0]
    d_dist = (ct_dot_rv * w * mask4 * (-qr) * (q + r))[..., 0]

    # gated BondFFN backward
    d_out_i = d_w * sig
    d_g2 = d_w * out_i * sig * (1.0 - sig)
    d_lng = _dot_t(d_g2.to(dt), pg1["lin"]["w"]) * (lng > 0)
    d_g1, dsg_rows = _ln_bwd(d_lng, xhatg, invg, pg0["ln"])
    d_e_gate = _dot_t(d_g1.to(dt), wg1[:de])
    d_xp_gate = _dot_t(d_g1.to(dt), wg1[de:de + dxp])
    d_g1_tot = d_g1.sum(dim=(1, 2))                           # [B, G]
    d_time = d_g1_tot @ wg1[de + dxp].float()
    d_ln1 = _dot_t(d_out_i.to(dt), pi1["lin"]["w"]) * (ln1 > 0)
    d_h1, ds1_rows = _ln_bwd(d_ln1, xhat1, inv1, pi0["ln"])
    d_inter0 = _dot_t(d_h1.to(dt), pi0["lin"]["w"])
    d_bp = d_inter0 * np_
    d_np = d_inter0 * bp
    d_e = d_e_gate + _dot_t(d_bp.to(dt), wb)
    d_xp = d_xp_gate + _dot_t(d_np.to(dt), wn)

    # pair product and node MLPs: d_lout[i] sums over j, d_rout[j] over i
    grads_l, dx_l = _mlp2_bwd(h_node, params["left_lin_edge"], parts_l,
                              (d_xp * rout[:, None, :, :]).sum(dim=2), dt)
    grads_r, dx_r = _mlp2_bwd(h_node, params["right_lin_edge"], parts_r,
                              (d_xp * lout[:, :, None, :]).sum(dim=1), dt)

    tv = edge_time.reshape(-1).float()
    d_params = {
        "left_lin_edge": grads_l,
        "right_lin_edge": grads_r,
        "edge_lin": {
            "bond_linear": {"w": _wgrad(h_edge, d_bp)},
            "node_linear": {"w": _wgrad(xp, d_np)},
            "inter": _mlp_grads(_wgrad(inter0, d_h1), _rows(d_h1), _rows(ds1_rows),
                                _rows(d_ln1), _wgrad(r1, d_out_i), _rows(d_out_i)),
            "gate": _mlp_grads(
                torch.cat([_wgrad(h_edge, d_g1), _wgrad(xp, d_g1),
                           (tv[:, None] * d_g1_tot).sum(dim=0)[None]], dim=0),
                _rows(d_g1), _rows(dsg_rows), _rows(d_lng), _wgrad(rg, d_g2), _rows(d_g2)),
        },
    }
    return (_cast_like(d_params, params), (dx_l + dx_r).to(dt), d_e.to(dt),
            d_rel.to(rel_vec.dtype), d_dist.to(distance.dtype),
            d_time.reshape(edge_time.shape).to(edge_time.dtype), d_mask.to(pair_mask.dtype))


# ---------------------------------------------------------------------------
# plain versions of the full-EdgeBlock and whole-block kernels
# ---------------------------------------------------------------------------

def _linear32(x: torch.Tensor, p: dict) -> torch.Tensor:
    return _dot(x, p["w"]) + p["b"].float()


def _edge_tail(p, e, x, t_per, u_per, dt):
    """pallas_kernels.py:_edge_block_tail_fwd: the EdgeBlock tail given the
    two endpoint sums, every term added in float32 -> (LN output, xhat,
    1/std, relu output in dt, delta in dt)."""
    projl = _linear32(x, p["node_ffn_left"]).to(dt)
    projr = _linear32(x, p["node_ffn_right"]).to(dt)
    h1 = (t_per.float()[:, :, None] + u_per.float()[:, None] + projl.float()[:, :, None]
          + projr.float()[:, None] + _linear32(e, p["self_ffn"]))
    ln_out, xhat, inv = _ln_stats(h1, p["ln"])
    r = torch.relu(ln_out).to(dt)
    return ln_out, xhat, inv, r, _linear32(r, p["out"]).to(dt)


def _edge_chains(p: dict) -> dict:
    return {"left": p["bond_ffn_left"], "right": p["bond_ffn_right"]}


def edge_block_full_plain(params, h_bond, h_node, bond_time, pair_mask):
    """pallas_kernels.py:_edge_block_full_kernel. params: the EdgeBlock's
    (both BondFFN chains, node and self FFNs, LN, out); h_bond [B,N,N,De],
    h_node [B,N,Dn] -> the block's delta [B,N,N,De] in h_bond's dtype: the
    two chains' endpoint sums (edge_pair_aggregate_plain) and the tail."""
    t_per, u_per = _edge_sums(_edge_chains(params), h_bond, h_node, bond_time, pair_mask, False)
    return _edge_tail(params, h_bond, h_node, t_per, u_per, h_bond.dtype)[-1]


def edge_block_full_bwd_plain(params, h_bond, h_node, bond_time, pair_mask, ct):
    """pallas_kernels.py:_edge_block_full_bwd_kernel (as
    _pallas_edge_block_full_bwd wraps it): cotangent ct [B,N,N,De] of the
    delta -> (d_params, d_bond, d_node, d_time, d_mask). The tail's
    backward gives d_h per pair; its sums over columns and over rows are the
    cotangents of the two endpoint sums, which the chains' backward
    (_edge_side_bwd) takes in float32."""
    dt = h_bond.dtype
    mask4 = pair_mask.float()[..., None]
    t_per, u_per = _edge_sums(_edge_chains(params), h_bond, h_node, bond_time, pair_mask, False)
    ln_out, xhat, inv, r, _ = _edge_tail(params, h_bond, h_node, t_per, u_per, dt)
    d_delta = ct.float()
    d_ln = _dot_t(d_delta.to(dt), params["out"]["w"]) * (ln_out > 0)
    d_h, ds_rows = _ln_bwd(d_ln, xhat, inv, params["ln"])
    d_e_self = _dot_t(d_h.to(dt), params["self_ffn"]["w"])
    d_projl = d_h.sum(dim=2)          # t_per[i] and projl[i] broadcast over columns
    d_projr = d_h.sum(dim=1)          # u_per[j] and projr[j] over rows
    d_x_proj = (_dot_t(d_projl.to(dt), params["node_ffn_left"]["w"])
                + _dot_t(d_projr.to(dt), params["node_ffn_right"]["w"]))
    left = _bond_chain_bwd(params["bond_ffn_left"], h_bond, h_node, bond_time, mask4,
                           d_projl[:, None, :, :], 1, dt)
    right = _bond_chain_bwd(params["bond_ffn_right"], h_bond, h_node, bond_time, mask4,
                            d_projr[:, :, None, :], 2, dt)
    d_params = {
        "bond_ffn_left": left[0], "bond_ffn_right": right[0],
        "node_ffn_left": {"w": _wgrad(h_node, d_projl), "b": _rows(d_projl)},
        "node_ffn_right": {"w": _wgrad(h_node, d_projr), "b": _rows(d_projr)},
        "self_ffn": {"w": _wgrad(h_bond, d_h), "b": _rows(d_h)},
        "ln": {"scale": _rows(ds_rows), "bias": _rows(d_ln)},
        "out": {"w": _wgrad(r, d_delta), "b": _rows(d_delta)},
    }
    return (_cast_like(d_params, params), (d_e_self + left[1] + right[1]).to(dt),
            (d_x_proj + left[2] + right[2]).to(dt),
            (left[3] + right[3]).reshape(bond_time.shape).to(bond_time.dtype),
            (left[4] + right[4]).to(pair_mask.dtype))


def fused_block_plain(blk, h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask):
    """pallas_kernels.py:_fused_block_kernel: one whole denoiser block
    (edge_emb, NodeBlock, EdgeBlock, both residuals, PosUpdate) with the
    node time as its one time input. h_node [B,N,Dn], h_edge [B,N,N,De],
    h_dist [B,N,N,Dh], rel_vec [B,N,N,3], distance [B,N,N] -> (h_node_new
    [B,N,Dn], h_edge_new [B,N,N,De] in h_node's dtype, pos_delta [B,N,3]
    float32). Its roundings are its own, not the partial path's: the
    message sum enters the NodeBlock in float32, the EdgeBlock's and
    PosUpdate's gated messages are rounded to the compute dtype, the tail
    adds its four broadcast terms in the compute dtype before the float32
    self term, and the force divides by d and d + 1."""
    dt = h_node.dtype
    x = h_node
    de, dn = h_edge.shape[-1], x.shape[-1]
    mask4 = pair_mask.float()[..., None]
    tcol = _time_col(node_time)
    w_ee = blk["edge_emb"]["w"]
    he = (_dot(h_edge, w_ee[:de]) + _dot(h_dist.to(dt), w_ee[de:])
          + blk["edge_emb"]["b"].float()).to(dt)

    # NodeBlock: message sum over senders j, added in float32
    nb = blk["node_block"]
    h_e = _mlp2(he, nb["edge_net"], dt).to(dt)
    xn = _mlp2(x, nb["node_net"], dt).to(dt)
    msg = _linear32((h_e.float() * xn.float()[:, None]).to(dt), nb["msg_net"]).to(dt)
    g0, g1 = nb["gate"]["layers"]
    wg1 = g0["lin"]["w"]
    g = (_dot(he, wg1[:de]) + _dot(x, wg1[de:de + dn])[:, None] + tcol * wg1[de + dn].float()
         + g0["lin"]["b"].float())
    g = torch.relu(_ln32(g, g0["ln"])).to(dt)
    gate = torch.sigmoid(_linear32(g, g1["lin"])).to(dt)
    aggr = ((msg * gate).float() * mask4).sum(dim=2)
    nbv = torch.relu(_ln32(_linear32(x, nb["centroid_lin"]) + aggr, nb["ln"])).to(dt)
    h_node_new = x + _linear32(nbv, nb["out"]).to(dt)

    # EdgeBlock on the old node features, gated messages rounded to dt
    eb = blk["edge_block"]
    t_per, u_per = _edge_sums(_edge_chains(eb), he, x, node_time, pair_mask, True)
    projl = _linear32(x, eb["node_ffn_left"]).to(dt)
    projr = _linear32(x, eb["node_ffn_right"]).to(dt)
    h = (t_per[:, :, None] + u_per[:, None] + projl[:, :, None] + projr[:, None]
         + _linear32(he, eb["self_ffn"]))
    h = torch.relu(_ln32(h, eb["ln"])).to(dt)
    h_edge_new = he + _linear32(h, eb["out"]).to(dt)

    # PosUpdate on the new node and edge features
    pb = blk["pos_block"]
    lf = _mlp2(h_node_new, pb["left_lin_edge"], dt).to(dt)
    rf = _mlp2(h_node_new, pb["right_lin_edge"], dt).to(dt)
    xp = (lf[:, :, None] * rf[:, None]).to(dt)
    el = pb["edge_lin"]
    dxp = xp.shape[-1]
    inter = _mlp2((_dot(h_edge_new, el["bond_linear"]["w"])
                   * _dot(xp, el["node_linear"]["w"])).to(dt), el["inter"], dt)
    p0, p1 = el["gate"]["layers"]
    wp1 = p0["lin"]["w"]
    gp = (_dot(h_edge_new, wp1[:de]) + _dot(xp, wp1[de:de + dxp]) + tcol * wp1[de + dxp].float()
          + p0["lin"]["b"].float())
    gp = torch.relu(_ln32(gp, p0["ln"])).to(dt)
    weight = (inter * torch.sigmoid(_linear32(gp, p1["lin"]))).to(dt)
    d_safe = torch.where(mask4 > 0, distance.float()[..., None], torch.ones_like(mask4))
    force = weight.float() * rel_vec.float() / d_safe / (d_safe + 1.0) * mask4
    return h_node_new, h_edge_new, force.sum(dim=2)


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


# The widths for which csrc/node_block_bwd.cu, (H, De), and
# csrc/edge_pair_bwd.cu, (De, I, G, Do), instantiate their pair kernels:
# those of every model in configs/ and ckpts/ (node_dim / edge_dim 256 / 64
# and 128 / 32; H = node_dim, I = 2 edge_dim, G = 32, Do = De = edge_dim).
# Row 7 (edge_block_full_bwd) runs the EdgeBlock pair kernel too.
NODE_BWD_WIDTHS = ((256, 64), (128, 32))
EDGE_BWD_WIDTHS = ((64, 128, 32, 64), (32, 64, 32, 32))


def _check_built(kernel: str, names: str, widths: tuple, built: tuple) -> None:
    if widths not in built:
        raise ValueError(f"{kernel}: {names} = {widths}; the pair kernel is built for "
                         f"{' and '.join(map(str, built))}")


def _require_cuda(kernel: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {device}; the kernel runs on CUDA, "
                         "the plain version on the CPU")


def _pointers(tensors: List[Optional[torch.Tensor]]):
    """The tensors' addresses as a C array of pointers (None: a null one)."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


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


def _pos_update_checks(kernel: str, params, h_node, h_edge, rel_vec, distance, edge_time,
                       pair_mask):
    """Widths, weight leaves and the flat time vector of a PosUpdate call,
    after checking every operand -> (De, Dl, I, G, leaves, t)."""
    dev = h_node.device
    b, n, dn = h_node.shape
    de = h_edge.shape[-1]
    dl = params["left_lin_edge"]["layers"][1]["lin"]["w"].shape[1]
    hl = params["left_lin_edge"]["layers"][0]["lin"]["w"].shape[1]
    el = params["edge_lin"]
    i_dim = el["bond_linear"]["w"].shape[1]
    g = el["gate"]["layers"][0]["lin"]["w"].shape[1]
    _check_width(kernel, Dn=dn, De=de, Dl=dl, I=i_dim, G=g)
    if hl != dl:
        raise ValueError(f"{kernel}: the node MLPs' hidden width must equal their output")
    shapes = (_mlp_shapes(dn, dl, dl) * 2 + [(de, i_dim), (dl, i_dim)]
              + _mlp_shapes(i_dim, i_dim, 1) + _mlp_shapes(de + dl + 1, g, 1))
    leaves = _pos_update_leaves(params)
    _check_weights(kernel, leaves, shapes, dev)
    _check(f"{kernel} h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    _check(f"{kernel} h_edge", h_edge, (b, n, n, de), torch.bfloat16, dev)
    _check(f"{kernel} rel_vec", rel_vec, (b, n, n, 3), torch.float32, dev, align=4)
    _check(f"{kernel} distance", distance, (b, n, n), torch.float32, dev, align=4)
    t = _check_pairs(kernel, b, n, dev, pair_mask, edge_time)
    return de, dl, i_dim, g, leaves, t


def pos_update(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask):
    """PosUpdate force sum (see pos_update_plain)."""
    if h_node.device.type == "cpu":
        return pos_update_plain(params, h_node, h_edge, rel_vec, distance, edge_time,
                                pair_mask)
    from . import build

    dev = h_node.device
    b, n, dn = h_node.shape
    de, dl, i_dim, g, leaves, t = _pos_update_checks("pos_update", params, h_node, h_edge,
                                                     rel_vec, distance, edge_time, pair_mask)
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


def _mlp_tree(leaves: Sequence[torch.Tensor]) -> dict:
    w0, b0, s0, c0, w1, b1 = leaves
    return {"layers": [{"lin": {"w": w0, "b": b0}, "ln": {"scale": s0, "bias": c0}},
                       {"lin": {"w": w1, "b": b1}}]}


def _node_block_leaves(p: dict) -> List[torch.Tensor]:
    return (_mlp_leaves(p["edge_net"]) + _mlp_leaves(p["node_net"])
            + [p["msg_net"]["w"], p["msg_net"]["b"]] + _mlp_leaves(p["gate"]))


def _node_block_tree(leaves: Sequence[torch.Tensor]) -> dict:
    return {"edge_net": _mlp_tree(leaves[0:6]), "node_net": _mlp_tree(leaves[6:12]),
            "msg_net": {"w": leaves[12], "b": leaves[13]}, "gate": _mlp_tree(leaves[14:20])}


def _bond_ffn_tree(leaves: Sequence[torch.Tensor]) -> dict:
    return {"bond_linear": {"w": leaves[0]}, "node_linear": {"w": leaves[1]},
            "inter": _mlp_tree(leaves[2:8]), "gate": _mlp_tree(leaves[8:14])}


def _edge_pair_tree(leaves: Sequence[torch.Tensor]) -> dict:
    return {"left": _bond_ffn_tree(leaves[:14]), "right": _bond_ffn_tree(leaves[14:28])}


def _edge_pair_leaves(p: dict) -> List[torch.Tensor]:
    return _bond_ffn_leaves(p["left"]) + _bond_ffn_leaves(p["right"])


def _pos_update_leaves(p: dict) -> List[torch.Tensor]:
    return (_mlp_leaves(p["left_lin_edge"]) + _mlp_leaves(p["right_lin_edge"])
            + _bond_ffn_leaves(p["edge_lin"]))


def _pos_update_tree(leaves: Sequence[torch.Tensor]) -> dict:
    return {"left_lin_edge": _mlp_tree(leaves[0:6]), "right_lin_edge": _mlp_tree(leaves[6:12]),
            "edge_lin": _bond_ffn_tree(leaves[12:26])}


def _leaf_grads(d_params, leaves_of, need: Sequence[bool]) -> list:
    """The leaves' gradients in autograd's order, None where none is asked
    for (d_params is None when no leaf needs one)."""
    if d_params is None:
        return [None] * len(need)
    return [g if nd else None for g, nd in zip(leaves_of(d_params), need)]


class _NodeBlockAggregate(torch.autograd.Function):
    """node_block_aggregate with the NodeBlock backward kernel as its
    gradient; saves only the inputs, the backward recomputes."""

    @staticmethod
    def forward(ctx, x, edge_attr, node_time, pair_mask, *leaves):
        ctx.save_for_backward(x, edge_attr, node_time, pair_mask, *leaves)
        return node_block_aggregate(_node_block_tree(leaves), x, edge_attr, node_time,
                                    pair_mask)

    @staticmethod
    def backward(ctx, dout):
        x, edge_attr, node_time, pair_mask, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_params, dx, d_edge, d_t, d_mask = node_block_aggregate_bwd(
            _node_block_tree(leaves), x, edge_attr, node_time, pair_mask, dout.contiguous(),
            need_params=any(need[4:]), need_time=need[2])
        return (dx, d_edge, d_t, d_mask, *_leaf_grads(d_params, _node_block_leaves, need[4:]))


class _EdgePairAggregate(torch.autograd.Function):
    """edge_pair_aggregate with the EdgeBlock pair backward kernel as its
    gradient; saves only the inputs, the backward recomputes."""

    @staticmethod
    def forward(ctx, h_bond, h_node, bond_time, pair_mask, *leaves):
        ctx.save_for_backward(h_bond, h_node, bond_time, pair_mask, *leaves)
        return edge_pair_aggregate(_edge_pair_tree(leaves), h_bond, h_node, bond_time,
                                   pair_mask)

    @staticmethod
    def backward(ctx, dt_ct, du_ct):
        h_bond, h_node, bond_time, pair_mask, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_params, d_bond, d_node, d_time, d_mask = edge_pair_aggregate_bwd(
            _edge_pair_tree(leaves), h_bond, h_node, bond_time, pair_mask,
            dt_ct.contiguous(), du_ct.contiguous(), need_params=any(need[4:]),
            need_time=need[2])
        return (d_bond, d_node, d_time, d_mask,
                *_leaf_grads(d_params, _edge_pair_leaves, need[4:]))


class _PosUpdate(torch.autograd.Function):
    """pos_update with the PosUpdate backward kernel as its gradient; saves
    only the inputs, the backward recomputes."""

    @staticmethod
    def forward(ctx, h_node, h_edge, rel_vec, distance, edge_time, pair_mask, *leaves):
        ctx.save_for_backward(h_node, h_edge, rel_vec, distance, edge_time, pair_mask, *leaves)
        return pos_update(_pos_update_tree(leaves), h_node, h_edge, rel_vec, distance,
                          edge_time, pair_mask)

    @staticmethod
    def backward(ctx, ct):
        h_node, h_edge, rel_vec, distance, edge_time, pair_mask, *leaves = ctx.saved_tensors
        d_params, *d_inputs = pos_update_bwd(
            _pos_update_tree(leaves), h_node, h_edge, rel_vec, distance, edge_time, pair_mask,
            ct.contiguous())
        return (*d_inputs, *_pos_update_leaves(d_params))


def node_block_aggregate_ad(params, x, edge_attr, node_time, pair_mask):
    """Differentiable node_block_aggregate (forward and backward kernels)."""
    return _NodeBlockAggregate.apply(x, edge_attr, node_time, pair_mask,
                                     *_node_block_leaves(params))


def edge_pair_aggregate_ad(params, h_bond, h_node, bond_time, pair_mask):
    """Differentiable edge_pair_aggregate (forward and backward kernels)."""
    return _EdgePairAggregate.apply(h_bond, h_node, bond_time, pair_mask,
                                    *_edge_pair_leaves(params))


def pos_update_ad(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask):
    """Differentiable pos_update (forward and backward kernels)."""
    return _PosUpdate.apply(h_node, h_edge, rel_vec, distance, edge_time, pair_mask,
                            *_pos_update_leaves(params))


def _grad_buffers(shapes: List[Sequence[int]], device) -> List[torch.Tensor]:
    return [torch.empty(tuple(s), dtype=torch.float32, device=device) for s in shapes]


def node_block_aggregate_bwd(params, x, edge_attr, node_time, pair_mask, dout,
                             need_params: bool = True, need_time: bool = True):
    """NodeBlock backward (see node_block_aggregate_bwd_plain). Without
    need_params the parameter gradients are not formed (d_params is None,
    and the kernel launches neither grad.cu's weight-gradient nor its
    reduction kernel); without need_time d_t is not formed (None). Every
    output that is formed equals the full mode's."""
    if x.device.type == "cpu":
        return node_block_aggregate_bwd_plain(params, x, edge_attr, node_time, pair_mask, dout,
                                              need_params=need_params, need_time=need_time)
    from . import build

    dev = x.device
    b, n, dn = x.shape
    de = edge_attr.shape[-1]
    h = params["msg_net"]["w"].shape[0]
    _check_width("node_block_bwd", Dn=dn, De=de, H=h)
    leaves = _node_block_leaves(params)
    shapes = (_mlp_shapes(de, h, h) + _mlp_shapes(dn, h, h) + [(h, h), (h,)]
              + _mlp_shapes(de + dn + 1, h, h))
    _check_weights("node_block_bwd", leaves, shapes, dev)
    _check("node_block_bwd x", x, (b, n, dn), torch.bfloat16, dev)
    _check("node_block_bwd edge_attr", edge_attr, (b, n, n, de), torch.bfloat16, dev)
    _check("node_block_bwd dout", dout, (b, n, h), torch.bfloat16, dev)
    t = _check_pairs("node_block_bwd", b, n, dev, pair_mask, node_time)
    _require_cuda("node_block_bwd", dev)
    _check_built("node_block_bwd", "(H, De)", (h, de), NODE_BWD_WIDTHS)
    lib = build.library()
    dx = torch.empty_like(x)
    d_edge = torch.empty_like(edge_attr)
    d_t = torch.empty((b,), dtype=torch.float32, device=dev) if need_time else None
    d_mask = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    grads = _grad_buffers(shapes, dev) if need_params else [None] * len(shapes)
    ws = torch.empty((lib.md_node_block_backward_workspace(b, n, dn, de, h, int(need_params)),),
                     dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    rc = lib.md_node_block_backward(
        _pointers(leaves + [x, edge_attr, pair_mask, t, dout, dx, d_edge, d_t, d_mask]
                  + grads + [ws]),
        b, n, dn, de, h, int(need_params), int(need_time), _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "node_block_bwd")
    launch_counts["node_block_bwd"] += launched.value
    d_params = _cast_like(_node_block_tree(grads), params) if need_params else None
    if need_time:
        d_t = d_t.reshape(node_time.shape).to(node_time.dtype)
    return d_params, dx, d_edge, d_t, d_mask.to(pair_mask.dtype)


def edge_pair_aggregate_bwd(params, h_bond, h_node, bond_time, pair_mask, dt_ct, du_ct,
                            need_params: bool = True, need_time: bool = True):
    """EdgeBlock pair backward (see edge_pair_aggregate_bwd_plain); the two
    modes as node_block_aggregate_bwd's."""
    if h_bond.device.type == "cpu":
        return edge_pair_aggregate_bwd_plain(params, h_bond, h_node, bond_time, pair_mask,
                                             dt_ct, du_ct, need_params=need_params,
                                             need_time=need_time)
    from . import build

    dev = h_bond.device
    b, n, dn = h_node.shape
    de = h_bond.shape[-1]
    left = params["left"]
    i_dim = left["bond_linear"]["w"].shape[1]
    g = left["gate"]["layers"][0]["lin"]["w"].shape[1]
    do = left["inter"]["layers"][1]["lin"]["w"].shape[1]
    _check_width("edge_pair_bwd", Dn=dn, De=de, I=i_dim, G=g, Do=do)
    shapes = ([(de, i_dim), (dn, i_dim)] + _mlp_shapes(i_dim, i_dim, do)
              + _mlp_shapes(de + dn + 1, g, do))
    leaves = _edge_pair_leaves(params)
    _check_weights("edge_pair_bwd", leaves, shapes + shapes, dev)
    _check("edge_pair_bwd h_bond", h_bond, (b, n, n, de), torch.bfloat16, dev)
    _check("edge_pair_bwd h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    _check("edge_pair_bwd dt_ct", dt_ct, (b, n, do), torch.bfloat16, dev)
    _check("edge_pair_bwd du_ct", du_ct, (b, n, do), torch.bfloat16, dev)
    t = _check_pairs("edge_pair_bwd", b, n, dev, pair_mask, bond_time)
    _require_cuda("edge_pair_bwd", dev)
    _check_built("edge_pair_bwd", "(De, I, G, Do)", (de, i_dim, g, do), EDGE_BWD_WIDTHS)
    lib = build.library()
    d_bond = torch.empty_like(h_bond)
    d_node = torch.empty_like(h_node)
    d_time = torch.empty((b,), dtype=torch.float32, device=dev) if need_time else None
    d_mask = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    grads = (_grad_buffers(shapes + shapes, dev) if need_params
             else [None] * (2 * len(shapes)))
    ws = torch.empty((lib.md_edge_pair_backward_workspace(b, n, dn, de, i_dim, g, do,
                                                          int(need_params)),),
                     dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    rc = lib.md_edge_pair_backward(
        _pointers(leaves + [h_bond, h_node, pair_mask, t, dt_ct, du_ct, d_bond, d_node,
                            d_time, d_mask] + grads + [ws]),
        b, n, dn, de, i_dim, g, do, int(need_params), int(need_time), _stream(dev),
        ctypes.byref(launched))
    build.check(lib, rc, "edge_pair_bwd")
    launch_counts["edge_pair_bwd"] += launched.value
    d_params = _cast_like(_edge_pair_tree(grads), params) if need_params else None
    if need_time:
        d_time = d_time.reshape(bond_time.shape).to(bond_time.dtype)
    return d_params, d_bond, d_node, d_time, d_mask.to(pair_mask.dtype)


def pos_update_bwd(params, h_node, h_edge, rel_vec, distance, edge_time, pair_mask, ct):
    """PosUpdate backward (see pos_update_bwd_plain)."""
    if h_node.device.type == "cpu":
        return pos_update_bwd_plain(params, h_node, h_edge, rel_vec, distance, edge_time,
                                    pair_mask, ct)
    from . import build

    dev = h_node.device
    b, n, dn = h_node.shape
    de, dl, i_dim, g, leaves, t = _pos_update_checks("pos_update_bwd", params, h_node, h_edge,
                                                     rel_vec, distance, edge_time, pair_mask)
    _check("pos_update_bwd ct", ct, (b, n, 3), torch.float32, dev, align=4)
    if max(de, dl, g) > i_dim:
        raise ValueError("pos_update_bwd: the edge, node-feature and gate widths must not "
                         "exceed I")
    _require_cuda("pos_update_bwd", dev)
    lib = build.library()
    d_node = torch.empty_like(h_node)
    d_edge = torch.empty_like(h_edge)
    d_rel = torch.empty_like(rel_vec)
    d_dist = torch.empty_like(distance)
    d_time = torch.empty((b,), dtype=torch.float32, device=dev)
    d_mask = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    grads = _grad_buffers([tuple(x.shape) for x in leaves], dev)
    ws = torch.empty((lib.md_pos_update_backward_workspace(b, n, dn, de, dl, i_dim, g),),
                     dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    rc = lib.md_pos_update_backward(
        _pointers(leaves + [h_node, h_edge, rel_vec, distance, pair_mask, t, ct, d_node, d_edge,
                            d_rel, d_dist, d_time, d_mask] + grads + [ws]),
        b, n, dn, de, dl, i_dim, g, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "pos_update_bwd")
    launch_counts["pos_update_bwd"] += launched.value
    d_params = _cast_like(_pos_update_tree(grads), params)
    return (d_params, d_node, d_edge, d_rel, d_dist,
            d_time.reshape(edge_time.shape).to(edge_time.dtype), d_mask.to(pair_mask.dtype))


# ---------------------------------------------------------------------------
# the full EdgeBlock (rows 6, 7) and the whole block (row 2)
# ---------------------------------------------------------------------------

def _linear_leaves(p: dict) -> List[torch.Tensor]:
    return [p["w"], p["b"]]


def _ln_leaves(p: dict) -> List[torch.Tensor]:
    return [p["scale"], p["bias"]]


def _edge_block_full_leaves(p: dict) -> List[torch.Tensor]:
    """pallas_kernels.py:_edge_full_weights order (38): both chains, then
    node_ffn_left, node_ffn_right, self_ffn, ln, out."""
    return (_bond_ffn_leaves(p["bond_ffn_left"]) + _bond_ffn_leaves(p["bond_ffn_right"])
            + _linear_leaves(p["node_ffn_left"]) + _linear_leaves(p["node_ffn_right"])
            + _linear_leaves(p["self_ffn"]) + _ln_leaves(p["ln"]) + _linear_leaves(p["out"]))


def _edge_block_full_tree(leaves: Sequence[torch.Tensor]) -> dict:
    lin = lambda k: {"w": leaves[k], "b": leaves[k + 1]}
    return {"bond_ffn_left": _bond_ffn_tree(leaves[0:14]),
            "bond_ffn_right": _bond_ffn_tree(leaves[14:28]),
            "node_ffn_left": lin(28), "node_ffn_right": lin(30), "self_ffn": lin(32),
            "ln": {"scale": leaves[34], "bias": leaves[35]}, "out": lin(36)}


def _fused_block_leaves(blk: dict) -> List[torch.Tensor]:
    """pallas_kernels.py:flatten_block_weights order (92): edge_emb, the
    NodeBlock (edge_net, node_net, msg_net, gate, centroid_lin, ln, out),
    the EdgeBlock (_edge_block_full_leaves) and PosUpdate."""
    nb = blk["node_block"]
    return (_linear_leaves(blk["edge_emb"]) + _node_block_leaves(nb)
            + _linear_leaves(nb["centroid_lin"]) + _ln_leaves(nb["ln"]) + _linear_leaves(nb["out"])
            + _edge_block_full_leaves(blk["edge_block"]) + _pos_update_leaves(blk["pos_block"]))


def _fused_block_tree(leaves: Sequence[torch.Tensor]) -> dict:
    nb = _node_block_tree(leaves[2:22])
    nb.update(centroid_lin={"w": leaves[22], "b": leaves[23]},
              ln={"scale": leaves[24], "bias": leaves[25]}, out={"w": leaves[26], "b": leaves[27]})
    return {"edge_emb": {"w": leaves[0], "b": leaves[1]}, "node_block": nb,
            "edge_block": _edge_block_full_tree(leaves[28:66]),
            "pos_block": _pos_update_tree(leaves[66:92])}


def _edge_block_full_shapes(dn: int, de: int, i_dim: int, g: int) -> List[tuple]:
    """The 38 weight shapes of _edge_block_full_leaves (output width De)."""
    chain = ([(de, i_dim), (dn, i_dim)] + _mlp_shapes(i_dim, i_dim, de)
             + _mlp_shapes(de + dn + 1, g, de))
    return chain + chain + [(dn, de), (de,), (dn, de), (de,), (de, de), (de,), (de,), (de,),
                            (de, de), (de,)]


def _edge_block_full_checks(kernel: str, params, h_bond, h_node, bond_time, pair_mask):
    """Widths, weight leaves and the flat time vector of a full-EdgeBlock
    call, after checking every operand -> (I, G, leaves, t)."""
    dev = h_bond.device
    b, n, dn = h_node.shape
    de = h_bond.shape[-1]
    left = params["bond_ffn_left"]
    i_dim = left["bond_linear"]["w"].shape[1]
    g = left["gate"]["layers"][0]["lin"]["w"].shape[1]
    do = params["out"]["w"].shape[1]
    _check_width(kernel, Dn=dn, De=de, I=i_dim, G=g, Do=do)
    if do != de or g > i_dim or de > i_dim:
        raise ValueError(f"{kernel}: the output width must equal De, and G and De must not "
                         "exceed I")
    leaves = _edge_block_full_leaves(params)
    _check_weights(kernel, leaves, _edge_block_full_shapes(dn, de, i_dim, g), dev)
    _check(f"{kernel} h_bond", h_bond, (b, n, n, de), torch.bfloat16, dev)
    _check(f"{kernel} h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    t = _check_pairs(kernel, b, n, dev, pair_mask, bond_time)
    return i_dim, g, leaves, t


def edge_block_full(params, h_bond, h_node, bond_time, pair_mask):
    """The whole EdgeBlock's delta (see edge_block_full_plain)."""
    if h_bond.device.type == "cpu":
        return edge_block_full_plain(params, h_bond, h_node, bond_time, pair_mask)
    from . import build

    dev = h_bond.device
    b, n, dn = h_node.shape
    de = h_bond.shape[-1]
    i_dim, g, leaves, t = _edge_block_full_checks("edge_block_full", params, h_bond, h_node,
                                                  bond_time, pair_mask)
    _require_cuda("edge_block_full", dev)
    lib = build.library()
    np_ = torch.empty((2, b, n, i_dim), dtype=torch.float32, device=dev)
    gpre = torch.empty((2, b, n, g), dtype=torch.float32, device=dev)
    tu = torch.empty((2, b, n, de), dtype=torch.bfloat16, device=dev)
    proj = torch.empty((2, b, n, de), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(h_bond)
    launched = ctypes.c_int(0)
    rc = lib.md_edge_block_full_forward(
        _pointers(leaves + [h_bond, h_node, pair_mask, t, np_, gpre, tu, proj, out]),
        b, n, dn, de, i_dim, g, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "edge_block_full")
    launch_counts["edge_block_full"] += launched.value
    return out


def edge_block_full_bwd(params, h_bond, h_node, bond_time, pair_mask, ct):
    """The whole EdgeBlock's backward (see edge_block_full_bwd_plain)."""
    if h_bond.device.type == "cpu":
        return edge_block_full_bwd_plain(params, h_bond, h_node, bond_time, pair_mask, ct)
    from . import build

    dev = h_bond.device
    b, n, dn = h_node.shape
    de = h_bond.shape[-1]
    i_dim, g, leaves, t = _edge_block_full_checks("edge_block_full_bwd", params, h_bond, h_node,
                                                  bond_time, pair_mask)
    _check("edge_block_full_bwd ct", ct, (b, n, n, de), torch.bfloat16, dev)
    _require_cuda("edge_block_full_bwd", dev)
    _check_built("edge_block_full_bwd", "(De, I, G, Do)", (de, i_dim, g, de), EDGE_BWD_WIDTHS)
    lib = build.library()
    d_bond = torch.empty_like(h_bond)
    d_node = torch.empty_like(h_node)
    d_time = torch.empty((b,), dtype=torch.float32, device=dev)
    d_mask = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    grads = _grad_buffers([tuple(x.shape) for x in leaves], dev)
    ws = torch.empty((lib.md_edge_block_full_backward_workspace(b, n, dn, de, i_dim, g),),
                     dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    rc = lib.md_edge_block_full_backward(
        _pointers(leaves + [h_bond, h_node, pair_mask, t, ct, d_bond, d_node, d_time, d_mask]
                  + grads + [ws]),
        b, n, dn, de, i_dim, g, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "edge_block_full_bwd")
    launch_counts["edge_block_full_bwd"] += launched.value
    d_params = _cast_like(_edge_block_full_tree(grads), params)
    return (d_params, d_bond, d_node, d_time.reshape(bond_time.shape).to(bond_time.dtype),
            d_mask.to(pair_mask.dtype))


def _fused_block_dims(blk, h_node, h_edge, h_dist) -> List[int]:
    """[B, N, Dn, De, Dh, H, I, G, Dl, Ip, Gp]: the batch, the NodeBlock's
    hidden width H, the EdgeBlock chains' interior and gate widths I and G,
    PosUpdate's node-MLP, interior and gate widths Dl, Ip and Gp."""
    b, n, dn = h_node.shape
    eb, el = blk["edge_block"]["bond_ffn_left"], blk["pos_block"]["edge_lin"]
    return [b, n, dn, h_edge.shape[-1], h_dist.shape[-1],
            blk["node_block"]["msg_net"]["w"].shape[0], eb["bond_linear"]["w"].shape[1],
            eb["gate"]["layers"][0]["lin"]["w"].shape[1],
            blk["pos_block"]["left_lin_edge"]["layers"][1]["lin"]["w"].shape[1],
            el["bond_linear"]["w"].shape[1], el["gate"]["layers"][0]["lin"]["w"].shape[1]]


def fused_block(blk, h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask):
    """One whole denoiser block (see fused_block_plain)."""
    if h_node.device.type == "cpu":
        return fused_block_plain(blk, h_node, h_edge, h_dist, rel_vec, distance, node_time,
                                 pair_mask)
    from . import build

    dev = h_node.device
    dims = _fused_block_dims(blk, h_node, h_edge, h_dist)
    b, n, dn, de, dh, h, i_dim, g, dl, ip, gp = dims
    _check_width("fused_block", Dn=dn, De=de, H=h, I=i_dim, G=g, Dl=dl, Ip=ip, Gp=gp)
    if dh % 16 or not 16 <= dh <= 256:
        raise ValueError(f"fused_block: Dh = {dh}; the kernel takes multiples of 16 up to 256")
    if g > i_dim or de > i_dim:
        raise ValueError("fused_block: the EdgeBlock's gate and edge widths must not exceed I")
    if blk["pos_block"]["left_lin_edge"]["layers"][0]["lin"]["w"].shape[1] != dl:
        raise ValueError("fused_block: the node MLPs' hidden width must equal their output")
    shapes = ([(de + dh, de), (de,)]
              + _mlp_shapes(de, h, h) + _mlp_shapes(dn, h, h) + [(h, h), (h,)]
              + _mlp_shapes(de + dn + 1, h, h) + [(dn, h), (h,), (h,), (h,), (h, dn), (dn,)]
              + _edge_block_full_shapes(dn, de, i_dim, g)
              + _mlp_shapes(dn, dl, dl) * 2 + [(de, ip), (dl, ip)]
              + _mlp_shapes(ip, ip, 1) + _mlp_shapes(de + dl + 1, gp, 1))
    leaves = _fused_block_leaves(blk)
    _check_weights("fused_block", leaves, shapes, dev)
    _check("fused_block h_node", h_node, (b, n, dn), torch.bfloat16, dev)
    _check("fused_block h_edge", h_edge, (b, n, n, de), torch.bfloat16, dev)
    _check("fused_block h_dist", h_dist, (b, n, n, dh), torch.bfloat16, dev)
    _check("fused_block rel_vec", rel_vec, (b, n, n, 3), torch.float32, dev, align=4)
    _check("fused_block distance", distance, (b, n, n), torch.float32, dev, align=4)
    t = _check_pairs("fused_block", b, n, dev, pair_mask, node_time)
    _require_cuda("fused_block", dev)
    lib = build.library()
    dims_c = (ctypes.c_int * len(dims))(*dims)
    node_out = torch.empty_like(h_node)
    edge_out = torch.empty_like(h_edge)
    pos_out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.md_fused_block_forward_workspace(dims_c),), dtype=torch.uint8,
                     device=dev)
    launched = ctypes.c_int(0)
    rc = lib.md_fused_block_forward(
        _pointers(leaves + [h_node, h_edge, h_dist, rel_vec, distance, pair_mask, t, node_out,
                            edge_out, pos_out, ws]),
        dims_c, _stream(dev), ctypes.byref(launched))
    build.check(lib, rc, "fused_block")
    launch_counts["fused_block"] += launched.value
    return node_out, edge_out, pos_out


class _EdgeBlockFull(torch.autograd.Function):
    """edge_block_full with the full-EdgeBlock backward kernel as its
    gradient; saves only the inputs, the backward recomputes."""

    @staticmethod
    def forward(ctx, h_bond, h_node, bond_time, pair_mask, *leaves):
        ctx.save_for_backward(h_bond, h_node, bond_time, pair_mask, *leaves)
        return edge_block_full(_edge_block_full_tree(leaves), h_bond, h_node, bond_time,
                               pair_mask)

    @staticmethod
    def backward(ctx, ct):
        h_bond, h_node, bond_time, pair_mask, *leaves = ctx.saved_tensors
        d_params, *d_inputs = edge_block_full_bwd(_edge_block_full_tree(leaves), h_bond, h_node,
                                                  bond_time, pair_mask, ct.contiguous())
        return (*d_inputs, *_edge_block_full_leaves(d_params))


class _FusedBlock(torch.autograd.Function):
    """fused_block whose gradient is that of ``recompute``, the partial
    path's block on the same inputs with the node time as both times (the
    port's counterpart of pallas_kernels.py:_fb_bwd, the VJP of
    _xla_fused_block); saves only the inputs, the backward recomputes under
    autograd and differentiates the recompute."""

    @staticmethod
    def forward(ctx, recompute, h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask,
                *leaves):
        ctx.recompute = recompute
        ctx.save_for_backward(h_node, h_edge, h_dist, rel_vec, distance, node_time, pair_mask,
                              *leaves)
        return fused_block(_fused_block_tree(leaves), h_node, h_edge, h_dist, rel_vec, distance,
                           node_time, pair_mask)

    @staticmethod
    def backward(ctx, d_node, d_edge, d_pos):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(nd) for a, nd in zip(ctx.saved_tensors, need)]
            outs = ctx.recompute(_fused_block_tree(args[7:]), *args[:7])
            wrt = [a for a, nd in zip(args, need) if nd]
            grads = iter(torch.autograd.grad(outs, wrt, (d_node, d_edge, d_pos),
                                             allow_unused=True))
        return (None, *[next(grads) if nd else None for nd in need])


def edge_block_full_ad(params, h_bond, h_node, bond_time, pair_mask):
    """Differentiable edge_block_full (forward and backward kernels)."""
    return _EdgeBlockFull.apply(h_bond, h_node, bond_time, pair_mask,
                                *_edge_block_full_leaves(params))


def fused_block_ad(blk, recompute, h_node, h_edge, h_dist, rel_vec, distance, node_time,
                   pair_mask):
    """Differentiable fused_block: the whole-block kernel forward, the
    gradient of ``recompute(blk, h_node, h_edge, h_dist, rel_vec, distance,
    node_time, pair_mask)`` backward."""
    return _FusedBlock.apply(recompute, h_node, h_edge, h_dist, rel_vec, distance, node_time,
                             pair_mask, *_fused_block_leaves(blk))
