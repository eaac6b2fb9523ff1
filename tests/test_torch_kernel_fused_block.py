"""moldiff_tpu_torch/ops/kernels.py fused_block (the plain version of the
CUDA whole-block kernel) against the Pallas kernel in interpret mode and
the bf16 rule against the XLA composition, and fused_block_ad's gradient
(the partial path's block differentiated, models/denoiser.py
fused_block_recompute) against the JAX package's own (_fb_bwd), on the same
numpy inputs, weights and cotangents."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_edge_net
from moldiff_tpu.ops.pallas_kernels import _fb_bwd, _pallas_fused_block, _xla_fused_block
from moldiff_tpu_torch.models.denoiser import fused_block_recompute
from moldiff_tpu_torch.ops import kernels
from torch_port_util import jax_tree, np_tree, to_np, torch_tree

B, N, DN, DE, DH = 3, 8, 64, 32, 16
NAMES = ("h_node", "h_edge", "pos_delta")


@pytest.fixture(scope="module")
def case():
    params, _ = init_node_edge_net(jax.random.key(3), DN, DE, num_blocks=1, cutoff=10,
                                   use_gate=True)
    blk = np_tree(jax.tree.map(lambda a: a[0], params["blocks"]))
    rng = np.random.default_rng(8)
    node_mask = (np.arange(N)[None] < np.array([8, 6, 2])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    pos = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    rel = (pos[:, :, None] - pos[:, None]).astype(np.float32)
    args = (rng.normal(size=(B, N, DN)).astype(np.float32),
            rng.normal(size=(B, N, N, DE)).astype(np.float32),
            rng.uniform(size=(B, N, N, DH)).astype(np.float32), rel,
            np.linalg.norm(rel, axis=-1).astype(np.float32),
            rng.uniform(size=(B, 1, 1)).astype(np.float32), mask)
    cts = (rng.normal(size=(B, N, DN)).astype(np.float32),
           rng.normal(size=(B, N, N, DE)).astype(np.float32),
           rng.normal(size=(B, N, 3)).astype(np.float32))
    return blk, args, cts


def _jax_args(case, dtype):
    blk, args, _ = case
    h_node, h_edge, h_dist, *rest = args
    return (jax_tree(blk, dtype), jnp.asarray(h_node, dtype), jnp.asarray(h_edge, dtype),
            jnp.asarray(h_dist, dtype), *map(jnp.asarray, rest))


def _torch_args(case, dtype):
    blk, args, _ = case
    h_node, h_edge, h_dist, *rest = args
    return (torch_tree(blk, dtype), torch.tensor(h_node).to(dtype), torch.tensor(h_edge).to(dtype),
            torch.tensor(h_dist).to(dtype), *map(torch.tensor, rest))


@pytest.fixture(scope="module")
def xla_f32(case):
    return jax.jit(_xla_fused_block)(*_jax_args(case, jnp.float32))


def test_f32_matches_pallas(case):
    """float32: the three outputs equal the Pallas body (interpreted, once)
    to 1e-4 of their scale, the JAX package's tolerance for this kernel."""
    want = _pallas_fused_block(*_jax_args(case, jnp.float32), interpret=True)
    got = kernels.fused_block(*_torch_args(case, torch.float32))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.abs(to_np(g) - w).max() <= 1e-4 * np.abs(w).max(), name


def test_bf16_within_xla_error(case, xla_f32):
    """bf16 weights and activations (float32 geometry and time): each
    output in its dtype and within 2.5x the XLA composition's own bf16
    error of the float32 result, or 1e-3 of its scale
    (tests/test_pallas_kernels.py's rule for the full-block kernels)."""
    xla16 = jax.jit(_xla_fused_block)(*_jax_args(case, jnp.bfloat16))
    got = kernels.fused_block(*_torch_args(case, torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, g, x, t in zip(NAMES, got, xla16, xla_f32):
        t = np.asarray(t, np.float32)
        scale = np.abs(t).max()
        err = np.abs(to_np(g) - t).max() / scale
        err_x = np.abs(np.asarray(x, np.float32) - t).max() / scale
        assert np.isfinite(to_np(g)).all() and err <= max(2.5 * err_x, 1e-3), (name, err, err_x)


def test_rounds_where_the_pallas_body_rounds(case):
    """bf16: the message sum enters the NodeBlock unrounded, the EdgeBlock's
    and PosUpdate's messages are rounded to bf16, the tail's broadcast terms
    added in bf16: the plain version is not the partial path's composition,
    whose h_node differs from it."""
    blk, h_node, h_edge, h_dist, rel, dist, t, mask = _torch_args(case, torch.bfloat16)
    got = kernels.fused_block(blk, h_node, h_edge, h_dist, rel, dist, t, mask)
    partial = fused_block_recompute(blk, h_node, h_edge, h_dist, rel, dist, t, mask)
    assert not torch.equal(got[0], partial[0])
    for g, p in zip(got, partial):
        assert float((g.float() - p.float()).abs().max()) <= 0.05 * float(p.float().abs().max())


def test_gradients_match_fb_bwd_f32(case):
    """float32: fused_block_ad's gradient (the partial path recomputed and
    differentiated) equals the JAX package's _fb_bwd (the VJP of
    _xla_fused_block) for every one of the 92 weights and every input, to
    1e-4 of its scale, under the same random cotangents."""
    blk, args, cts = case
    jargs = _jax_args(case, jnp.float32)
    want = jax.jit(_fb_bwd)(jargs, tuple(map(jnp.asarray, cts)))
    tblk, *targs = _torch_args(case, torch.float32)
    leaves = kernels._fused_block_leaves(tblk)
    assert len(leaves) == 92
    for a in leaves + targs:
        a.requires_grad_(True)
    out = kernels.fused_block_ad(kernels._fused_block_tree(leaves), fused_block_recompute,
                                 *targs)
    with torch.no_grad():
        plain = kernels.fused_block_plain(tblk, *targs)
    for a, p in zip(out, plain):
        np.testing.assert_array_equal(a.detach().numpy(), p.numpy())
    grads = torch.autograd.grad(out, leaves + targs, tuple(map(torch.tensor, cts)))
    got = (kernels._fused_block_tree(list(grads[:92])), *grads[92:])
    got_l = jax.tree_util.tree_flatten_with_path(got)[0]
    want_l = jax.tree_util.tree_flatten_with_path(tuple(want))[0]
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        g = to_np(g).reshape(w.shape)
        scale = np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                       float(np.abs(g - w).max()), scale)


def test_wrapper_refuses_devices_without_kernel(case):
    """Off the CPU the wrapper launches the CUDA kernel or raises, before any
    launch; an h_dist width the kernel does not take is refused by name."""
    blk, h_node, h_edge, h_dist, rel, dist, t, mask = _torch_args(case, torch.float32)
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mblk = jax.tree.map(lambda a: meta(a, torch.bfloat16), blk)
    args = [meta(h_node, torch.bfloat16), meta(h_edge, torch.bfloat16),
            meta(h_dist, torch.bfloat16), meta(rel), meta(dist), meta(t), meta(mask)]
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.fused_block(mblk, *args)
    with pytest.raises(ValueError, match="h_edge: dtype"):
        kernels.fused_block(mblk, args[0], meta(h_edge), *args[2:])
    with pytest.raises(ValueError, match="Dh = 8"):
        kernels.fused_block(mblk, *args[:2], meta(h_dist[..., :8], torch.bfloat16), *args[3:])
    assert kernels.launch_counts == before
