"""moldiff_tpu_torch/ops/kernels.py edge_pair_aggregate_bwd (the plain
version of the CUDA EdgeBlock pair backward kernel) against the Pallas
backward kernel in interpret mode, and the autograd Function against it, on
the same numpy inputs, weights and cotangents."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_edge_block
from moldiff_tpu.ops.pallas_kernels import _pallas_edge_pair_bwd, _xla_edge_pair_aggregate
from moldiff_tpu_torch.ops import kernels
from torch_port_util import TRAIN_CONFIGS, config_blocks, jax_tree, np_tree, to_np, torch_tree

B, N, DN, DE = 3, 8, 64, 32


@pytest.fixture(scope="module")
def case():
    eb = np_tree(init_edge_block(jax.random.key(2), DE, DN, use_gate=True))
    params = {"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]}
    rng = np.random.default_rng(1)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([8, 6, 2])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    ct = (rng.normal(size=(B, N, DE)).astype(np.float32),
          rng.normal(size=(B, N, DE)).astype(np.float32))
    return params, e, x, t, mask, ct


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
    params, e, x, t, mask, ct = case
    return kernels.edge_pair_aggregate_bwd(
        torch_tree(params, dtype), torch.tensor(e).to(dtype), torch.tensor(x).to(dtype),
        torch.tensor(t), torch.tensor(mask), torch.tensor(ct[0]).to(dtype),
        torch.tensor(ct[1]).to(dtype))


def _pallas_bwd(case, dtype):
    params, e, x, t, mask, ct = case
    return _pallas_edge_pair_bwd(
        jax_tree(params, dtype), jnp.asarray(e, dtype), jnp.asarray(x, dtype), jnp.asarray(t),
        jnp.asarray(mask), (jnp.asarray(ct[0], dtype), jnp.asarray(ct[1], dtype)),
        interpret=True)


def _as_tree(out):
    d_params, *rest = out
    return {"params": d_params, "d_bond": rest[0], "d_node": rest[1], "d_time": rest[2],
            "d_mask": rest[3]}


def test_f32_matches_pallas_every_output(case):
    """float32: every cotangent and each parameter grad of both chains
    equals the Pallas backward to float32 summation order (1e-4 of the
    output's scale)."""
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
    """bf16, with the cotangents 2 * (t, u) of tests/test_pallas_kernels.py:
    every output is within 2x the XLA path's own bf16 error of the float32
    ground truth (or 1e-3 of its scale), the repo's rule; and the plain
    version lies within 2^-6 of each output's scale of the Pallas kernel's
    bf16 result."""
    params, e, x, t, mask, _ = case
    args32 = (jax_tree(params), jnp.asarray(e), jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask))
    out32, truth = _vjp(_xla_edge_pair_aggregate, args32,
                        lambda out: (2.0 * out[0], 2.0 * out[1]))
    args16 = (jax_tree(params, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16),
              jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), jnp.asarray(mask))
    ct16 = tuple((2.0 * o).astype(jnp.bfloat16) for o in out32)
    _, xla16 = _vjp(_xla_edge_pair_aggregate, args16, lambda out: ct16)
    bf_case = (params, e, x, t, mask, tuple(np.asarray(c, np.float32) for c in ct16))
    got = _as_tree(_torch_bwd(bf_case, torch.bfloat16))
    assert got["d_bond"].dtype == torch.bfloat16 and got["d_node"].dtype == torch.bfloat16
    pallas = _as_tree(_pallas_bwd(bf_case, jnp.bfloat16))
    keys = lambda r: {"params": r[0], "d_bond": r[1], "d_node": r[2], "d_time": r[3],
                      "d_mask": r[4]}
    for (path, g), (_, ref), (_, xl) in zip(_leaves(got), _leaves(keys(truth)),
                                            _leaves(keys(xla16))):
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
    """torch.autograd.grad through edge_pair_aggregate_ad on the CPU gives
    the plain backward's cotangents."""
    params, e, x, t, mask, ct = case
    tp = torch_tree(params)
    leaves = kernels._edge_pair_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    et, xt = torch.tensor(e, requires_grad=True), torch.tensor(x, requires_grad=True)
    out = kernels.edge_pair_aggregate_ad(tp, et, xt, torch.tensor(t), torch.tensor(mask))
    with torch.no_grad():
        want_out = kernels.edge_pair_aggregate_plain(tp, et, xt, torch.tensor(t),
                                                     torch.tensor(mask))
    for a, w in zip(out, want_out):
        np.testing.assert_array_equal(a.detach().numpy(), w.numpy())
    grads = torch.autograd.grad(out, [et, xt] + leaves,
                                (torch.tensor(ct[0]), torch.tensor(ct[1])))
    d_params, d_bond, d_node, _, _ = _torch_bwd(case, torch.float32)
    want = [d_bond, d_node] + kernels._edge_pair_leaves(d_params)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("time_grad", [True, False], ids=["with_d_t", "without_d_t"])
@pytest.mark.parametrize("leaves_grad", [True, False], ids=["full", "inputs_only"])
def test_autograd_asks_only_for_what_it_reads(case, monkeypatch, leaves_grad, time_grad):
    """The Function passes need_params / need_time to the backward wrapper
    from what needs a gradient: without need_params d_params comes back as
    None (no leaf gets a gradient), without need_time d_time is not formed,
    and every gradient formed equals the full mode's (the plain backward
    with everything asked for)."""
    params, e, x, t, mask, ct = case
    calls = []
    wrapper = kernels.edge_pair_aggregate_bwd

    def record(*args, **flags):
        out = wrapper(*args, **flags)
        calls.append((flags, out))
        return out

    monkeypatch.setattr(kernels, "edge_pair_aggregate_bwd", record)
    tp = torch_tree(params)
    leaves = kernels._edge_pair_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(leaves_grad)
    et, xt = torch.tensor(e, requires_grad=True), torch.tensor(x, requires_grad=True)
    tt = torch.tensor(t, requires_grad=time_grad)
    out = kernels.edge_pair_aggregate_ad(tp, et, xt, tt, torch.tensor(mask))
    wrt = [et, xt] + [tt] * time_grad + leaves * leaves_grad
    grads = torch.autograd.grad(out, wrt, (torch.tensor(ct[0]), torch.tensor(ct[1])))
    [(flags, (d_params, _, _, d_time, _))] = calls
    assert flags == {"need_params": leaves_grad, "need_time": time_grad}
    assert (d_params is None) != leaves_grad and (d_time is None) != time_grad
    full_params, d_bond, d_node, full_time, _ = _torch_bwd(case, torch.float32)
    want = ([d_bond, d_node] + [full_time] * time_grad
            + kernels._edge_pair_leaves(full_params) * leaves_grad)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape).numpy())


def test_wrapper_refuses_devices_without_kernel(case):
    """Off the CPU the backward wrapper launches the CUDA kernel or raises."""
    params, e, x, t, mask, ct = case
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mp = jax.tree.map(lambda a: meta(a, torch.bfloat16), torch_tree(params))
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.edge_pair_aggregate_bwd(mp, meta(e, torch.bfloat16), meta(x, torch.bfloat16),
                                        meta(t), meta(mask), meta(ct[0], torch.bfloat16),
                                        meta(ct[1], torch.bfloat16))
    assert kernels.launch_counts == before


@pytest.mark.parametrize("config", TRAIN_CONFIGS, ids=lambda p: Path(p).stem)
def test_pair_kernel_is_built_for_every_configured_model(config):
    """The EdgeBlock chain widths (De, I, G, Do) of every model that
    configs/train/ defines are among those the pair kernel is instantiated
    for (rows 5 and 7 both run it)."""
    side = config_blocks(config)["edge_block"]["bond_ffn_left"]
    de, i_dim = side["bond_linear"]["w"].shape[-2:]
    widths = (de, i_dim, side["gate"]["layers"][0]["lin"]["w"].shape[-1],
              side["inter"]["layers"][1]["lin"]["w"].shape[-1])
    assert widths in kernels.EDGE_BWD_WIDTHS


def test_built_widths_are_the_c_sources():
    """EDGE_BWD_WIDTHS lists the widths csrc/edge_pair_bwd.cu accepts and
    dispatches on, no more and no fewer."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "edge_pair_bwd.cu").read_text()
    accepted = re.search(r"bool edge_chain_bwd_built\(.*?\) \{(.*?)\}", src, re.S).group(1)
    want = [tuple(map(str, w)) for w in kernels.EDGE_BWD_WIDTHS]
    assert re.findall(r"De == (\d+) && I == (\d+) && G == (\d+) && Do == (\d+)",
                      accepted) == want
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+), (\d+), (\d+)>\(a", src)) == sorted(want)
