"""moldiff_tpu_torch/ops/kernels.py pos_update (the plain version of the
CUDA PosUpdate kernel) against the JAX XLA composition and the Pallas
kernel in interpret mode, on the same numpy inputs and weights."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_pos_update
from moldiff_tpu.ops.pallas_kernels import _pallas_pos_update, _xla_pos_update
from moldiff_tpu_torch.models.nn import safe_distance
from moldiff_tpu_torch.ops import kernels
from torch_port_util import TRAIN_CONFIGS, config_blocks, jax_tree, max_err, np_tree, torch_tree

B, N, DN, DE = 3, 8, 64, 32


@pytest.fixture(scope="module")
def case():
    params = np_tree(init_pos_update(jax.random.key(3), DN, DE, DE, use_gate=True))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    pos = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    dist = safe_distance(torch.tensor(rel)).numpy()
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([8, 4, 1])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    return params, x, e, rel, dist, t, mask


def _run_torch(case, dtype):
    params, x, e, rel, dist, t, mask = case
    return kernels.pos_update(
        torch_tree(params, dtype), torch.tensor(x).to(dtype), torch.tensor(e).to(dtype),
        torch.tensor(rel), torch.tensor(dist), torch.tensor(t), torch.tensor(mask))


def _run_jax(fn, case, dtype, **kw):
    params, x, e, rel, dist, t, mask = case
    return fn(jax_tree(params, dtype), jnp.asarray(x, dtype), jnp.asarray(e, dtype),
              jnp.asarray(rel), jnp.asarray(dist), jnp.asarray(t), jnp.asarray(mask), **kw)


def test_f32_matches_xla_and_pallas(case):
    """float32: agreement to float32 summation order."""
    got = _run_torch(case, torch.float32)
    xla = _run_jax(_xla_pos_update, case, jnp.float32)
    pallas = _run_jax(_pallas_pos_update, case, jnp.float32, interpret=True)
    assert got.shape == (B, N, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-6)


def test_bf16_matches_pallas_rounding(case):
    """bf16 activations, float32 force: within 2^-7 of the force range of
    the Pallas kernel, and within 2x the XLA composition's own bf16 error
    against the float32 result."""
    got = _run_torch(case, torch.bfloat16)
    assert got.dtype == torch.float32
    pallas = _run_jax(_pallas_pos_update, case, jnp.bfloat16, interpret=True)
    xla = _run_jax(_xla_pos_update, case, jnp.bfloat16)
    ref = _run_jax(_xla_pos_update, case, jnp.float32)
    scale = float(np.abs(np.asarray(ref)).max())
    assert max_err(got, pallas) <= 2 ** -7 * scale
    assert max_err(got, ref) <= 2 * max_err(xla, ref)


def test_padded_and_lone_atoms_get_no_force(case):
    """Padded atoms and a molecule of one atom get exactly zero force."""
    out = _run_torch(case, torch.float32).numpy()
    assert np.all(out[1, 4:] == 0.0)
    assert np.all(out[2] == 0.0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("bad", ["rel_vec_dtype", "n_too_large"])
def test_wrapper_checks_before_launch(case, bad):
    """The CUDA wrapper refuses a wrong device, dtype or size before it
    builds or launches anything."""
    params, x, e, rel, dist, t, mask = case
    meta = lambda a, dt=torch.bfloat16, shape=None: torch.empty(
        shape or tuple(a.shape), dtype=dt, device="meta")
    tp = jax.tree.map(meta, torch_tree(params))
    with pytest.raises(ValueError, match="dtype" if bad == "rel_vec_dtype" else "N = 80"):
        if bad == "rel_vec_dtype":
            kernels.pos_update(tp, meta(x), meta(e), meta(rel, torch.bfloat16),
                               meta(dist, torch.float32), meta(t, torch.float32),
                               meta(mask, torch.float32))
        else:
            kernels.pos_update(tp, meta(x, shape=(B, 80, DN)), meta(e, shape=(B, 80, 80, DE)),
                               meta(rel, torch.float32, (B, 80, 80, 3)),
                               meta(dist, torch.float32, (B, 80, 80)),
                               meta(t, torch.float32), meta(mask, torch.float32, (B, 80, 80)))


def _pos_widths(pb) -> tuple:
    """(Dn, De, Dl, I, G) of a PosUpdate's weights (a leading blocks axis
    allowed)."""
    el, left = pb["edge_lin"], pb["left_lin_edge"]["layers"]
    de, i_dim = el["bond_linear"]["w"].shape[-2:]
    return (left[0]["lin"]["w"].shape[-2], de, left[1]["lin"]["w"].shape[-1], i_dim,
            el["gate"]["layers"][0]["lin"]["w"].shape[-1])


@pytest.mark.parametrize("config", TRAIN_CONFIGS, ids=lambda p: Path(p).stem)
def test_pair_kernel_is_built_for_every_configured_model(config):
    """The PosUpdate widths (Dn, De, Dl, I, G) of every denoiser that
    configs/train/ defines are among those the pair kernels, forward and
    backward, are instantiated for (rows 8, 9 and 2 run them); a bond
    predictor updates no positions."""
    blocks = config_blocks(config)
    if "pos_block" not in blocks:
        assert Path(config).stem.startswith("train_bondpred"), sorted(blocks)
        return
    assert _pos_widths(blocks["pos_block"]) in kernels.POS_WIDTHS


def test_built_widths_are_the_c_sources():
    """POS_WIDTHS lists the widths csrc/pos_update.cu accepts and dispatches
    on, no more and no fewer, and the whole-block kernel (row 2) checks the
    same predicate before its first launch."""
    csrc = Path(kernels.__file__).parent.parent / "csrc"
    src = (csrc / "pos_update.cu").read_text()
    accepted = re.search(r"bool pos_update_built\(int Dn, int De, int Dl, int I, int G\) "
                         r"\{(.*?)\}", src, re.S).group(1)
    want = [tuple(map(str, w)) for w in kernels.POS_WIDTHS]
    assert re.findall(r"Dn == (\d+) && De == (\d+) && Dl == (\d+) && I == (\d+) && G == (\d+)",
                      accepted) == want
    assert re.findall(r"if \(!(\S+)\(Dn, De, Dl, I, G\)\) return cudaErrorInvalidValue",
                      src) == ["pos_update_built"]
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+), (\d+), (\d+)>\(a", src)) == sorted(
        w[1:] for w in want)
    assert "md::pos_update_built(Dn, De, Dl, Ip, Gp)" in (csrc / "fused_block.cu").read_text()
