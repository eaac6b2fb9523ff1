"""moldiff_tpu_torch/ops/kernels.py edge_block_full and edge_block_full_bwd
(the plain versions of the CUDA full-EdgeBlock forward and backward
kernels) against the Pallas kernels in interpret mode, the bf16 dtype
contract against the XLA path, and the autograd Function against the plain
backward, on the same numpy inputs, weights and cotangents."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_edge_block
from moldiff_tpu.ops.pallas_kernels import (_pallas_edge_block_full, _pallas_edge_block_full_bwd,
                                            _xla_edge_block_full)
from moldiff_tpu_torch.ops import kernels
from torch_port_util import jax_tree, np_tree, to_np, torch_tree

B, N, DN, DE = 3, 8, 64, 32


@pytest.fixture(scope="module")
def case():
    params = np_tree(init_edge_block(jax.random.key(4), DE, DN, use_gate=True))
    rng = np.random.default_rng(6)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([8, 6, 2])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    ct = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    return params, e, x, t, mask, ct


def _torch_args(case, dtype):
    params, e, x, t, mask, _ = case
    return (torch_tree(params, dtype), torch.tensor(e).to(dtype), torch.tensor(x).to(dtype),
            torch.tensor(t), torch.tensor(mask))


def _jax_args(case, dtype):
    params, e, x, t, mask, _ = case
    return (jax_tree(params, dtype), jnp.asarray(e, dtype), jnp.asarray(x, dtype),
            jnp.asarray(t), jnp.asarray(mask))


def _as_tree(out):
    d_params, *rest = out
    return {"params": d_params, "d_bond": rest[0], "d_node": rest[1], "d_time": rest[2],
            "d_mask": rest[3]}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def pallas_f32(case):
    """The Pallas forward and backward, interpreted, at float32."""
    ct = jnp.asarray(case[-1])
    return (_pallas_edge_block_full(*_jax_args(case, jnp.float32), interpret=True),
            _pallas_edge_block_full_bwd(*_jax_args(case, jnp.float32), ct, interpret=True))


def test_forward_f32_matches_pallas(case, pallas_f32):
    """float32: the block delta equals the Pallas forward to 1e-5 of its scale."""
    got = kernels.edge_block_full(*_torch_args(case, torch.float32))
    want = np.asarray(pallas_f32[0])
    assert got.shape == want.shape == (B, N, N, DE) and got.dtype == torch.float32
    assert np.abs(to_np(got) - want).max() <= 1e-5 * np.abs(want).max()


def test_backward_f32_matches_pallas_every_leaf(case, pallas_f32):
    """float32: every cotangent and each of the 38 parameter gradients, in
    the Pallas wrapper's tree, equals the Pallas backward to 2e-4 of its
    scale (the JAX package's own tolerance for this kernel)."""
    got = _as_tree(kernels.edge_block_full_bwd(*_torch_args(case, torch.float32),
                                               torch.tensor(case[-1])))
    want = _as_tree(pallas_f32[1])
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    assert len(kernels._edge_block_full_leaves(got["params"])) == 38
    for (path, a), (_, w) in zip(got_l, want_l):
        a, w = to_np(a), np.asarray(w, np.float32)
        assert a.shape == w.shape, jax.tree_util.keystr(path)
        scale = np.abs(w).max() + 1e-6
        assert np.abs(a - w).max() <= 2e-4 * scale, (jax.tree_util.keystr(path),
                                                       float(np.abs(a - w).max()), scale)


def test_bf16_dtype_contract(case):
    """bf16, cotangent 2 x the delta (the JAX package's test of this
    kernel): the forward and every cotangent come back in the primal dtypes
    and lie within 2.5x the XLA path's own bf16 error of the float32 ground
    truth, or 1e-3 of the output's scale (tests/test_pallas_kernels.py)."""
    args32, args16 = _jax_args(case, jnp.float32), _jax_args(case, jnp.bfloat16)

    @jax.jit
    def xla_vjp(args, ct):
        out, vjp = jax.vjp(_xla_edge_block_full, *args)
        return out, vjp(ct)

    out32 = jax.jit(_xla_edge_block_full)(*args32)
    _, truth = xla_vjp(args32, 2.0 * out32)
    ct16 = (2.0 * out32).astype(jnp.bfloat16)
    out16, xla16 = xla_vjp(args16, ct16)
    targs = _torch_args(case, torch.bfloat16)
    fwd = kernels.edge_block_full(*targs)
    assert fwd.dtype == torch.bfloat16
    ref = np.asarray(out32)
    err_xla = np.abs(np.asarray(out16, np.float32) - ref).max()
    assert np.abs(to_np(fwd) - ref).max() <= max(2.5 * err_xla, 1e-3 * np.abs(ref).max())
    got = kernels.edge_block_full_bwd(*targs, torch.tensor(np.asarray(ct16, np.float32)).to(
        torch.bfloat16))
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    assert got[3].dtype == got[4].dtype == torch.float32
    keys = lambda r: {"params": r[0], "d_bond": r[1], "d_node": r[2], "d_time": r[3],
                      "d_mask": r[4]}
    for (path, g), (_, t), (_, xl) in zip(_leaves(_as_tree(got)), _leaves(keys(truth)),
                                          _leaves(keys(xla16))):
        t = np.asarray(t, np.float32)
        g = to_np(g).reshape(t.shape)
        scale = np.abs(t).max() + 1e-9
        err = np.abs(g - t).max() / scale
        err_x = np.abs(np.asarray(xl, np.float32).reshape(t.shape) - t).max() / scale
        assert err <= max(2.5 * err_x, 1e-3), (jax.tree_util.keystr(path), err, err_x)


def test_autograd_function_equals_plain_backward(case):
    """torch.autograd.grad through edge_block_full_ad on the CPU gives the
    plain backward's cotangents, every input and leaf."""
    params, e, x, t, mask, ct = case
    tp = torch_tree(params)
    leaves = kernels._edge_block_full_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    et, xt = torch.tensor(e, requires_grad=True), torch.tensor(x, requires_grad=True)
    tt, mt = torch.tensor(t, requires_grad=True), torch.tensor(mask, requires_grad=True)
    out = kernels.edge_block_full_ad(kernels._edge_block_full_tree(leaves), et, xt, tt, mt)
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(),
                                      kernels.edge_block_full_plain(tp, et, xt, tt, mt).numpy())
    grads = torch.autograd.grad(out, [et, xt, tt, mt] + leaves, torch.tensor(ct))
    d_params, *d_inputs = kernels.edge_block_full_bwd_plain(tp, et.detach(), xt.detach(),
                                                            tt.detach(), mt.detach(),
                                                            torch.tensor(ct))
    for g, w in zip(grads, d_inputs + kernels._edge_block_full_leaves(d_params)):
        np.testing.assert_array_equal(g.numpy(), w.detach().numpy())


def test_wrappers_refuse_devices_without_kernel(case):
    """Off the CPU both wrappers launch their CUDA kernel or raise, before
    any launch; a width the kernel does not take is refused by name."""
    params, e, x, t, mask, ct = case
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mp = jax.tree.map(lambda a: meta(a, torch.bfloat16), torch_tree(params))
    args = (mp, meta(e, torch.bfloat16), meta(x, torch.bfloat16), meta(t), meta(mask))
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.edge_block_full(*args)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.edge_block_full_bwd(*args, meta(ct, torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        kernels.edge_block_full_bwd(*args, meta(ct))
    narrow = jax.tree.map(lambda a: meta(a, torch.bfloat16),
                          torch_tree(np_tree(init_edge_block(jax.random.key(0), 16, DN, True))))
    with pytest.raises(ValueError, match="De = 16"):
        kernels.edge_block_full(narrow, meta(e[..., :16], torch.bfloat16),
                                *args[2:])
    assert kernels.launch_counts == before
