"""moldiff_tpu_torch/ops/kernels.py node_block_aggregate (the plain version
of the CUDA NodeBlock kernel) against the JAX XLA composition and the Pallas
kernel in interpret mode, on the same numpy inputs and weights."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_block
from moldiff_tpu.ops.pallas_kernels import (
    _pallas_node_block_aggregate,
    _xla_node_block_aggregate,
)
from moldiff_tpu_torch.ops import kernels
from torch_port_util import (TRAIN_CONFIGS, config_blocks, jax_tree, max_err, np_tree,
                             torch_tree)

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
    return params, x, e, t, mask


def _run_torch(case, dtype):
    params, x, e, t, mask = case
    return kernels.node_block_aggregate(
        torch_tree(params, dtype), torch.tensor(x).to(dtype), torch.tensor(e).to(dtype),
        torch.tensor(t), torch.tensor(mask))


def _run_jax(fn, case, dtype, **kw):
    params, x, e, t, mask = case
    return fn(jax_tree(params, dtype), jnp.asarray(x, dtype), jnp.asarray(e, dtype),
              jnp.asarray(t), jnp.asarray(mask), **kw)


def test_f32_matches_xla_and_pallas(case):
    """float32: the three agree to float32 summation order (1e-5 of O(1) values)."""
    got = _run_torch(case, torch.float32)
    xla = _run_jax(_xla_node_block_aggregate, case, jnp.float32)
    pallas = _run_jax(_pallas_node_block_aggregate, case, jnp.float32, interpret=True)
    assert got.shape == (B, N, DN)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


def test_bf16_matches_pallas_rounding(case):
    """bf16: the plain version rounds where the Pallas body rounds, so it
    lies closer to the Pallas kernel than one bf16 step (2^-7 relative) of
    the output's range; against the float32 result its error is within 2x
    the XLA composition's own bf16 error."""
    got = _run_torch(case, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    pallas = _run_jax(_pallas_node_block_aggregate, case, jnp.bfloat16, interpret=True)
    xla = _run_jax(_xla_node_block_aggregate, case, jnp.bfloat16)
    ref = _run_jax(_xla_node_block_aggregate, case, jnp.float32)
    scale = float(np.abs(np.asarray(ref)).max())
    assert max_err(got, pallas) <= 2 ** -7 * scale
    assert max_err(got, ref) <= 2 * max_err(xla, ref)


def test_masked_pairs_contribute_nothing(case):
    """A receiver whose pairs are all masked gets exactly zero."""
    params, x, e, t, mask = case
    out = _run_torch(case, torch.float32).numpy()
    assert np.all(out[2, 3:] == 0.0)
    mask2 = mask.copy()
    e2 = e.copy()
    e2[mask2 == 0] = 1e3  # garbage in masked pairs must not leak
    out2 = _run_torch((params, x, e2, t, mask2), torch.float32).numpy()
    np.testing.assert_array_equal(out, out2)


def test_wrapper_refuses_devices_without_kernel(case):
    """Off the CPU the wrapper launches the CUDA kernel or raises; a
    tensor on another device is refused before any launch."""
    params, x, e, t, mask = case
    meta = lambda a, dt=torch.float32: torch.empty(tuple(a.shape), dtype=dt, device="meta")
    mp = jax.tree.map(lambda a: meta(a, torch.bfloat16), torch_tree(params))
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        kernels.node_block_aggregate(mp, meta(x, torch.bfloat16), meta(e, torch.bfloat16),
                                     meta(t), meta(mask))
    assert kernels.launch_counts == before


@pytest.mark.parametrize("config", TRAIN_CONFIGS, ids=lambda p: Path(p).stem)
def test_pair_kernel_is_built_for_every_configured_model(config):
    """The NodeBlock widths (H, De) of every model that configs/train/
    defines are among those the forward pair kernel is instantiated for
    (rows 1 and 2 both run it)."""
    nb = config_blocks(config)["node_block"]
    widths = (nb["msg_net"]["w"].shape[-1], nb["edge_net"]["layers"][0]["lin"]["w"].shape[-2])
    assert widths in kernels.NODE_WIDTHS


def test_built_widths_are_the_c_sources():
    """NODE_WIDTHS lists the widths csrc/node_block.cu accepts and
    dispatches on, no more and no fewer."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "node_block.cu").read_text()
    accepted = re.search(r"bool node_block_built\(int H, int De\) \{(.*?)\}", src, re.S).group(1)
    want = [tuple(map(str, w)) for w in kernels.NODE_WIDTHS]
    assert re.findall(r"H == (\d+) && De == (\d+)", accepted) == want
    assert sorted(re.findall(r"launch_pair<(\d+), (\d+)>\(a", src)) == sorted(want)
