"""moldiff_tpu_torch/ops/kernels.py pos_update_bwd (the plain version of the
CUDA PosUpdate backward kernel) against the Pallas backward kernel in
interpret mode, and the autograd Function against it, on the same numpy
inputs, weights and cotangents."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_pos_update
from moldiff_tpu.ops.pallas_kernels import _pallas_pos_update_bwd, _xla_pos_update
from moldiff_tpu_torch.models.nn import safe_distance
from moldiff_tpu_torch.ops import kernels
from torch_port_util import jax_tree, np_tree, to_np, torch_tree

B, N, DN, DE = 3, 8, 64, 32
OUTPUTS = ("params", "d_node", "d_edge", "d_rel", "d_dist", "d_time", "d_mask")


def _make_case(seed: int, sizes):
    params = np_tree(init_pos_update(jax.random.key(seed), DN, DE, DE, use_gate=True))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    pos = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    dist = safe_distance(torch.tensor(rel)).numpy()
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array(sizes)[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    ct = rng.normal(size=(B, N, 3)).astype(np.float32)
    return params, x, e, rel, dist, t, mask, ct


@pytest.fixture(scope="module", params=[(3, (8, 5, 1)), (4, (8, 8, 3))],
                ids=["lone_atom", "full"])
def case(request):
    return _make_case(*request.param)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _as_tree(out):
    return dict(zip(OUTPUTS, out))


def _torch_bwd(case, dtype):
    params, x, e, rel, dist, t, mask, ct = case
    return kernels.pos_update_bwd(
        torch_tree(params, dtype), torch.tensor(x).to(dtype), torch.tensor(e).to(dtype),
        torch.tensor(rel), torch.tensor(dist), torch.tensor(t), torch.tensor(mask),
        torch.tensor(ct))


def _pallas_bwd(case, dtype):
    params, x, e, rel, dist, t, mask, ct = case
    return _pallas_pos_update_bwd(
        jax_tree(params, dtype), jnp.asarray(x, dtype), jnp.asarray(e, dtype),
        jnp.asarray(rel), jnp.asarray(dist), jnp.asarray(t), jnp.asarray(mask),
        jnp.asarray(ct), interpret=True)


def test_f32_matches_pallas_every_output(case):
    """float32: every cotangent and each parameter grad (the gate's
    first-layer rows e, xp and t included) equals the Pallas backward to
    float32 summation order (1e-4 of the output's scale)."""
    got = _as_tree(_torch_bwd(case, torch.float32))
    want = _as_tree(_pallas_bwd(case, jnp.float32))
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, w) in zip(got_l, want_l):
        a, w = to_np(a), np.asarray(w, np.float32).reshape(to_np(a).shape)
        scale = np.abs(w).max() + 1e-6
        assert np.abs(a - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                       float(np.abs(a - w).max()), scale)


def test_bf16_within_the_xla_error(case):
    """bf16 activations with the cotangent 2 * force, the bound of the JAX
    package's own test of this kernel (tests/test_pallas_kernels.py
    TestPosUpdateFused.test_bf16_dtype_contract): the mean over outputs of
    the error against the float32 ground truth within 1.5x the XLA path's,
    each output within 4x. A per-output 2x bound does not hold for the
    Pallas kernel itself (its bf16 rounding points differ from XLA's vjp,
    and a relu-boundary flip moves one output's largest error by ~3x at
    these sizes); the plain version is held to the Pallas kernel's bf16
    result within 2^-6 of each output's scale, and to the same bound."""
    params, x, e, rel, dist, t, mask, _ = case

    def vjp(dtype, ct=None):
        args = (jax_tree(params, dtype), jnp.asarray(x, dtype), jnp.asarray(e, dtype),
                jnp.asarray(rel), jnp.asarray(dist), jnp.asarray(t), jnp.asarray(mask))

        @jax.jit
        def run(a):
            out, fn = jax.vjp(_xla_pos_update, *a)
            return out, fn(2.0 * out if ct is None else ct)
        return run(args)

    out32, truth = vjp(jnp.float32)
    ct = 2.0 * out32
    _, xla16 = vjp(jnp.bfloat16, ct)
    bf_case = (params, x, e, rel, dist, t, mask, np.asarray(ct, np.float32))
    got = _as_tree(_torch_bwd(bf_case, torch.bfloat16))
    assert got["d_node"].dtype == torch.bfloat16 and got["d_edge"].dtype == torch.bfloat16
    assert got["d_rel"].dtype == torch.float32 and got["d_dist"].dtype == torch.float32
    pallas = _as_tree(_pallas_bwd(bf_case, jnp.bfloat16))

    def errors(tree):
        out = []
        for (path, g), (_, ref) in zip(_leaves(tree), _leaves(_as_tree(truth))):
            ref = np.asarray(ref, np.float32)
            scale = np.abs(ref).max() + 1e-9
            out.append(np.abs(to_np(g).reshape(ref.shape) - ref).max() / scale)
        return np.array(out)

    err, err_xla, err_pallas = errors(got), errors(_as_tree(xla16)), errors(pallas)
    paths = [jax.tree_util.keystr(p) for p, _ in _leaves(got)]
    mean_xla = err_xla.mean()
    for name, e_ in (("plain", err), ("pallas", err_pallas)):
        assert e_.mean() <= max(1.5 * mean_xla, 2e-3), (name, e_.mean(), mean_xla)
        bound = np.maximum(np.maximum(4 * err_xla, 4 * mean_xla), 5e-3)
        assert (e_ <= bound).all(), (name, [(p, a, b) for p, a, b in zip(paths, e_, err_xla)
                                            if a > max(4 * b, 4 * mean_xla, 5e-3)])
    for (path, g), (_, p) in zip(_leaves(got), _leaves(pallas)):
        p = np.asarray(p, np.float32)
        g = to_np(g).reshape(p.shape)
        scale = np.abs(p).max() + 1e-9
        assert np.abs(g - p).max() <= 2 ** -6 * scale, (jax.tree_util.keystr(path),
                                                         np.abs(g - p).max() / scale)


def test_autograd_function_equals_plain_backward(case):
    """torch.autograd.grad through pos_update_ad on the CPU gives the plain
    forward's output and the plain backward's cotangents, the position
    inputs (rel_vec, distance) included."""
    params, x, e, rel, dist, t, mask, ct = case
    tp = torch_tree(params)
    leaves = kernels._pos_update_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    inputs = [torch.tensor(a, requires_grad=True) for a in (x, e, rel, dist)]
    out = kernels.pos_update_ad(tp, *inputs, torch.tensor(t), torch.tensor(mask))
    with torch.no_grad():
        want_out = kernels.pos_update_plain(tp, *inputs, torch.tensor(t), torch.tensor(mask))
    np.testing.assert_array_equal(out.detach().numpy(), want_out.numpy())
    grads = torch.autograd.grad(out, inputs + leaves, torch.tensor(ct))
    d_params, *d_inputs = _torch_bwd(case, torch.float32)
    want = d_inputs[:4] + kernels._pos_update_leaves(d_params)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_no_grad_forward_is_the_forward_wrapper(case):
    """Under torch.no_grad() pos_update_ad is pos_update: same output, no
    backward launches."""
    params, x, e, rel, dist, t, mask, _ = case
    tp = torch_tree(params)
    args = [torch.tensor(a) for a in (x, e, rel, dist, t, mask)]
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        out = kernels.pos_update_ad(tp, *args)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), kernels.pos_update(tp, *args).numpy())
    assert kernels.launch_counts == before


@pytest.mark.parametrize("bad", ["device", "ct_dtype", "h_node_dtype", "n_too_large"])
def test_wrapper_refuses_before_launch(bad):
    """Off the CPU the backward wrapper launches the CUDA kernel or raises;
    a wrong dtype or width is refused before anything is built or launched."""
    params, x, e, rel, dist, t, mask, ct = _make_case(3, (8, 5, 1))
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mp = jax.tree.map(lambda a: meta(a, torch.bfloat16), torch_tree(params))
    args = dict(h_node=meta(x, torch.bfloat16), h_edge=meta(e, torch.bfloat16), rel_vec=meta(rel),
                distance=meta(dist), edge_time=meta(t), pair_mask=meta(mask), ct=meta(ct))
    match = "kernel runs on CUDA"
    if bad == "ct_dtype":
        args["ct"], match = meta(ct, torch.bfloat16), "ct: dtype"
    elif bad == "h_node_dtype":
        args["h_node"], match = meta(x), "h_node: dtype"
    elif bad == "n_too_large":
        m = N * 10
        args.update(h_node=meta(np.zeros((B, m, DN)), torch.bfloat16),
                    h_edge=meta(np.zeros((B, m, m, DE)), torch.bfloat16),
                    rel_vec=meta(np.zeros((B, m, m, 3))), distance=meta(np.zeros((B, m, m))),
                    pair_mask=meta(np.zeros((B, m, m))), ct=meta(np.zeros((B, m, 3))))
        match = "N = 80"
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match=match):
        kernels.pos_update_bwd(mp, **args)
    assert kernels.launch_counts == before


def test_built_widths_are_the_c_sources():
    """The backward entry point takes the widths of the forward's predicate
    (md::pos_update_built, so POS_WIDTHS) and refuses others before any
    launch; its pair kernel is instantiated for the same widths."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "pos_update_bwd.cu").read_text()
    assert re.findall(r"if \(!(\S+)\(Dn, De, Dl, I, G\)\) return cudaErrorInvalidValue",
                      src) == ["md::pos_update_built"]
    want = sorted(tuple(map(str, w[1:])) for w in kernels.POS_WIDTHS)
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+), (\d+), (\d+)>\(a", src)) == want
