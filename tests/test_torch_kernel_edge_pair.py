"""moldiff_tpu_torch/ops/kernels.py edge_pair_aggregate (the plain version
of the CUDA EdgeBlock pair kernel) against the JAX XLA composition and the
Pallas kernel in interpret mode, on the same numpy inputs and weights."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_edge_block
from moldiff_tpu.ops.pallas_kernels import (
    _pallas_edge_pair_aggregate,
    _xla_edge_pair_aggregate,
)
from moldiff_tpu_torch.ops import kernels
from torch_port_util import (TRAIN_CONFIGS, config_blocks, jax_tree, max_err, np_tree,
                             torch_tree)

B, N, DN, DE = 3, 8, 64, 32


@pytest.fixture(scope="module")
def case():
    blk = np_tree(init_edge_block(jax.random.key(2), DE, DN, use_gate=True))
    params = {"left": blk["bond_ffn_left"], "right": blk["bond_ffn_right"]}
    rng = np.random.default_rng(1)
    e = rng.normal(size=(B, N, N, DE)).astype(np.float32)
    x = rng.normal(size=(B, N, DN)).astype(np.float32)
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    node_mask = (np.arange(N)[None] < np.array([8, 6, 2])[:, None]).astype(np.float32)
    mask = node_mask[:, :, None] * node_mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    return params, e, x, t, mask


def _run_torch(case, dtype):
    params, e, x, t, mask = case
    return kernels.edge_pair_aggregate(
        torch_tree(params, dtype), torch.tensor(e).to(dtype), torch.tensor(x).to(dtype),
        torch.tensor(t), torch.tensor(mask))


def _run_jax(fn, case, dtype, **kw):
    params, e, x, t, mask = case
    return fn(jax_tree(params, dtype), jnp.asarray(e, dtype), jnp.asarray(x, dtype),
              jnp.asarray(t), jnp.asarray(mask), **kw)


@pytest.fixture(scope="module")
def results(case):
    """(port, XLA, Pallas) outputs in float32 and bf16, each computed once."""
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        out[name] = (_run_torch(case, tdt), _run_jax(_xla_edge_pair_aggregate, case, jdt),
                     _run_jax(_pallas_edge_pair_aggregate, case, jdt, interpret=True))
    return out


@pytest.mark.parametrize("side", [0, 1], ids=["t_left", "u_right"])
def test_f32_matches_xla_and_pallas(results, side):
    """float32: agreement to float32 summation order."""
    got, xla, pallas = (r[side] for r in results["f32"])
    assert got.shape == (B, N, DE)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", [0, 1], ids=["t_left", "u_right"])
def test_bf16_matches_pallas_rounding(results, side):
    """bf16: within one bf16 step (2^-7) of the output's range of the
    Pallas kernel, and within 2x the XLA composition's own bf16 error
    against the float32 result."""
    got, xla, pallas = (r[side] for r in results["bf16"])
    ref = results["f32"][1][side]
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(ref)).max())
    assert max_err(got, pallas) <= 2 ** -7 * scale
    assert max_err(got, ref) <= 2 * max_err(xla, ref)


def test_sums_run_over_rows_and_columns(results):
    """t sums the left chain over rows i, u the right chain over columns j:
    a node with no real partner gets exactly zero on both."""
    t_out, u_out = results["f32"][0]
    assert np.all(t_out.numpy()[2, 2:] == 0.0)
    assert np.all(u_out.numpy()[2, 2:] == 0.0)
    assert np.abs(t_out.numpy()[0]).max() > 0


@pytest.mark.parametrize("config", TRAIN_CONFIGS, ids=lambda p: Path(p).stem)
def test_pair_kernel_is_built_for_every_configured_model(config):
    """The EdgeBlock chain widths (De, I, G, Do) of every model that
    configs/train/ defines are among those the forward pair kernel is
    instantiated for (rows 4, 2 and 6 run it)."""
    side = config_blocks(config)["edge_block"]["bond_ffn_left"]
    de, i_dim = side["bond_linear"]["w"].shape[-2:]
    widths = (de, i_dim, side["gate"]["layers"][0]["lin"]["w"].shape[-1],
              side["inter"]["layers"][1]["lin"]["w"].shape[-1])
    assert widths in kernels.EDGE_WIDTHS


def test_built_widths_are_the_c_sources():
    """EDGE_WIDTHS lists the widths csrc/edge_pair.cu accepts and
    dispatches on, no more and no fewer."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "edge_pair.cu").read_text()
    accepted = re.search(r"bool edge_pair_built\(.*?\) \{(.*?)\}", src, re.S).group(1)
    want = [tuple(map(str, w)) for w in kernels.EDGE_WIDTHS]
    assert re.findall(r"De == (\d+) && I == (\d+) && G == (\d+) && Do == (\d+)",
                      accepted) == want
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+), (\d+), (\d+)>\(a", src)) == sorted(want)
