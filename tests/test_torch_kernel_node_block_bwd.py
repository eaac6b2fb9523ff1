"""moldiff_tpu_torch/ops/kernels.py node_block_aggregate_bwd (the plain
version of the CUDA NodeBlock backward kernel) against the Pallas backward
kernel in interpret mode, and the autograd Function against it, on the same
numpy inputs, weights and cotangent."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_block
from moldiff_tpu.ops.pallas_kernels import _pallas_node_block_bwd, _xla_node_block_aggregate
from moldiff_tpu_torch.ops import kernels
from torch_port_util import TRAIN_CONFIGS, config_blocks, jax_tree, np_tree, to_np, torch_tree

B, N, DN, DE = 3, 8, 64, 32
KEYS = ("node_net", "edge_net", "msg_net", "gate")


@pytest.fixture(scope="module")
def case():
    params = np_tree(init_node_block(jax.random.key(1), DN, DE, DN, use_gate=True))
    params = {k: params[k] for k in KEYS}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([8, 5, 3])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    dout = rng.normal(size=(B, N, DN)).astype(np.float32)
    return params, x, e, t, mask, dout


def _vjp(fn, args, ct):
    """(fn(*args), vjp of fn at args applied to ct(fn(*args))), compiled
    (as the JAX package runs its XLA path) rather than op by op."""
    @jax.jit
    def run(a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(ct(out))
    return run(args)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _torch_bwd(case, dtype):
    params, x, e, t, mask, dout = case
    return kernels.node_block_aggregate_bwd(
        torch_tree(params, dtype), torch.tensor(x).to(dtype), torch.tensor(e).to(dtype),
        torch.tensor(t), torch.tensor(mask), torch.tensor(dout).to(dtype))


def _pallas_bwd(case, dtype):
    params, x, e, t, mask, dout = case
    return _pallas_node_block_bwd(
        jax_tree(params, dtype), jnp.asarray(x, dtype), jnp.asarray(e, dtype), jnp.asarray(t),
        jnp.asarray(mask), jnp.asarray(dout, dtype), interpret=True)


def _as_tree(out):
    """(d_params, dx, d_edge, d_t, d_mask) -> one nested structure with
    JAX-comparable leaves."""
    d_params, *rest = out
    return {"params": d_params, "dx": rest[0], "d_edge": rest[1], "d_t": rest[2],
            "d_mask": rest[3]}


def test_f32_matches_pallas_every_output(case):
    """float32: every cotangent and each parameter grad equals the Pallas
    backward to float32 summation order (1e-4 of the output's scale)."""
    got = _as_tree(_torch_bwd(case, torch.float32))
    want = _as_tree(_pallas_bwd(case, jnp.float32))
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, w) in zip(got_l, want_l):
        a, w = to_np(a), np.asarray(w, np.float32).reshape(to_np(a).shape)
        scale = np.abs(w).max() + 1e-6
        assert np.abs(a - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                       float(np.abs(a - w).max()), scale)


def test_bf16_within_twice_the_xla_error(case):
    """bf16, with the cotangent 2 * out of tests/test_pallas_kernels.py:
    against the float32 ground truth (XLA's vjp in float32), every output's
    error is within 2x the XLA path's own bf16 error (or 1e-3 of its
    scale), the repo's rule for the Pallas backward; and the plain version
    lies within 2^-6 of each output's scale of the Pallas kernel's bf16
    result (the two round alike; float32 sums in another order move a bf16
    value by one unit in the last place, 2^-8 relative)."""
    params, x, e, t, mask, _ = case
    args32 = (jax_tree(params), jnp.asarray(x), jnp.asarray(e), jnp.asarray(t), jnp.asarray(mask))
    out32, truth = _vjp(_xla_node_block_aggregate, args32, lambda out: 2.0 * out)
    args16 = (jax_tree(params, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
              jnp.asarray(e, jnp.bfloat16), jnp.asarray(t), jnp.asarray(mask))
    dout16 = (2.0 * out32).astype(jnp.bfloat16)
    _, xla16 = _vjp(_xla_node_block_aggregate, args16, lambda out: dout16)
    bf_case = (params, x, e, t, mask, np.asarray(dout16, np.float32))
    got = _as_tree(_torch_bwd(bf_case, torch.bfloat16))
    assert got["dx"].dtype == torch.bfloat16 and got["d_edge"].dtype == torch.bfloat16
    pallas = _as_tree(_pallas_bwd(bf_case, jnp.bfloat16))
    truth_t = {"params": truth[0], "dx": truth[1], "d_edge": truth[2], "d_t": truth[3],
               "d_mask": truth[4]}
    xla_t = {"params": xla16[0], "dx": xla16[1], "d_edge": xla16[2], "d_t": xla16[3],
             "d_mask": xla16[4]}
    for (path, g), (_, ref), (_, xl) in zip(_leaves(got), _leaves(truth_t), _leaves(xla_t)):
        ref = np.asarray(ref, np.float32)
        g = to_np(g).reshape(ref.shape)
        scale = np.abs(ref).max() + 1e-9
        err = np.abs(g - ref).max() / scale
        err_xla = np.abs(np.asarray(xl, np.float32).reshape(ref.shape) - ref).max() / scale
        assert err <= max(2 * err_xla, 1e-3), (jax.tree_util.keystr(path), err, err_xla)
    for (path, g), (_, p) in zip(_leaves(got), _leaves(pallas)):
        p = np.asarray(p, np.float32)
        g = to_np(g).reshape(p.shape)
        scale = np.abs(p).max() + 1e-9
        assert np.abs(g - p).max() <= 2 ** -6 * scale, (jax.tree_util.keystr(path),
                                                         np.abs(g - p).max() / scale)


def test_autograd_function_equals_plain_backward(case):
    """torch.autograd.grad through node_block_aggregate_ad on the CPU gives
    the plain backward's cotangents (the Function saves the inputs and calls
    the backward wrapper)."""
    params, x, e, t, mask, dout = case
    tp = torch_tree(params)
    leaves = kernels._node_block_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt, et = torch.tensor(x, requires_grad=True), torch.tensor(e, requires_grad=True)
    out = kernels.node_block_aggregate_ad(tp, xt, et, torch.tensor(t), torch.tensor(mask))
    with torch.no_grad():
        want_out = kernels.node_block_aggregate_plain(tp, xt, et, torch.tensor(t),
                                                      torch.tensor(mask))
    np.testing.assert_array_equal(out.detach().numpy(), want_out.numpy())
    grads = torch.autograd.grad(out, [xt, et] + leaves, torch.tensor(dout))
    d_params, dx, de, _, _ = _torch_bwd(case, torch.float32)
    want = [dx, de] + kernels._node_block_leaves(d_params)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("time_grad", [True, False], ids=["with_d_t", "without_d_t"])
@pytest.mark.parametrize("leaves_grad", [True, False], ids=["full", "inputs_only"])
def test_autograd_asks_only_for_what_it_reads(case, monkeypatch, leaves_grad, time_grad):
    """The Function passes need_params / need_time to the backward wrapper
    from what needs a gradient: without need_params d_params comes back as
    None (no leaf gets a gradient), without need_time d_t is not formed,
    and every gradient formed equals the full mode's (the plain backward
    with everything asked for)."""
    params, x, e, t, mask, dout = case
    calls = []
    wrapper = kernels.node_block_aggregate_bwd

    def record(*args, **flags):
        out = wrapper(*args, **flags)
        calls.append((flags, out))
        return out

    monkeypatch.setattr(kernels, "node_block_aggregate_bwd", record)
    tp = torch_tree(params)
    leaves = kernels._node_block_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(leaves_grad)
    xt, et = torch.tensor(x, requires_grad=True), torch.tensor(e, requires_grad=True)
    tt = torch.tensor(t, requires_grad=time_grad)
    out = kernels.node_block_aggregate_ad(tp, xt, et, tt, torch.tensor(mask))
    wrt = [xt, et] + [tt] * time_grad + leaves * leaves_grad
    grads = torch.autograd.grad(out, wrt, torch.tensor(dout))
    [(flags, (d_params, _, _, d_t, _))] = calls
    assert flags == {"need_params": leaves_grad, "need_time": time_grad}
    assert (d_params is None) != leaves_grad and (d_t is None) != time_grad
    full_params, dx, de, full_t, _ = _torch_bwd(case, torch.float32)
    want = [dx, de] + [full_t] * time_grad + kernels._node_block_leaves(full_params) * leaves_grad
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape).numpy())


def test_wrapper_refuses_devices_without_kernel(case):
    """Off the CPU the backward wrapper launches the CUDA kernel or raises."""
    params, x, e, t, mask, dout = case
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mp = jax.tree.map(lambda a: meta(a, torch.bfloat16), torch_tree(params))
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.node_block_aggregate_bwd(mp, meta(x, torch.bfloat16), meta(e, torch.bfloat16),
                                         meta(t), meta(mask), meta(dout, torch.bfloat16))
    assert kernels.launch_counts == before


@pytest.mark.parametrize("config", TRAIN_CONFIGS, ids=lambda p: Path(p).stem)
def test_pair_kernel_is_built_for_every_configured_model(config):
    """The NodeBlock widths (H, De) of every model that configs/train/
    defines are among those the pair kernel is instantiated for."""
    nb = config_blocks(config)["node_block"]
    widths = (nb["msg_net"]["w"].shape[-1], nb["edge_net"]["layers"][0]["lin"]["w"].shape[-2])
    assert widths in kernels.NODE_WIDTHS


def test_built_widths_are_the_c_sources():
    """NODE_WIDTHS lists the widths csrc/node_block_bwd.cu accepts and
    dispatches on, no more and no fewer: it accepts those of the forward
    kernel's predicate, md::node_block_built, and instantiates the same."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "node_block_bwd.cu").read_text()
    assert re.findall(r"if \(!(\S+)\(H, De\)\) return cudaErrorInvalidValue", src) == [
        "md::node_block_built"]
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+)>\(a", src)) == sorted(
        (str(h), str(de)) for h, de in kernels.NODE_WIDTHS)
