"""moldiff_tpu_torch/utils/flops.py against moldiff_tpu/utils/flops.py: the
analytic NodeEdgeNet count equals JAX's over a grid of widths, gates and
update flags; FlopCounterMode's count of one plain block (the port's
NodeEdgeNet on the CPU, the kernels' plain versions) holds the analytic
count inside JAX's band against XLA (tests/test_flops.py: 0.6 < analytic /
counted <= 1.05); mfu's fields; and the card table's peaks, which refuse
an unknown card."""
import itertools

import jax
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_edge_net
from moldiff_tpu.utils import flops as jflops
from moldiff_tpu_torch.models import denoiser as tden
from moldiff_tpu_torch.utils import flops
from torch_port_util import np_tree, torch_tree

GRID = list(itertools.product((1, 16), (8, 40), (64, 256), (16, 64), (1, 6), (True, False),
                              (True, False), (True, False)))


@pytest.mark.parametrize("dn", [64, 256])
def test_analytic_count_equals_jax(dn):
    for b, n, _, de, blocks, gate, edge, pos in GRID:
        args = (b, n, dn, de, blocks)
        kw = dict(update_edge=edge, update_pos=pos, use_gate=gate)
        assert flops.denoiser_forward_flops(*args, **kw) == \
            jflops.denoiser_forward_flops(*args, **kw), (args, kw)


@pytest.mark.parametrize("use_gate", [True, False])
def test_counted_block_within_jax_band(use_gate):
    """One block at JAX's test shape (B = 2, N = 16, 64 / 32): the analytic
    count over FlopCounterMode's lies in (0.6, 1.05], JAX's band against
    XLA's count (the ratio at these shapes: 0.950 gated, 0.946 ungated)."""
    b, n, dn, de = 2, 16, 64, 32
    params, _ = init_node_edge_net(jax.random.key(0), dn, de, num_blocks=1, cutoff=15,
                                   use_gate=use_gate)
    static = tden.denoiser_static_config(num_blocks=1, cutoff=15, use_gate=use_gate)
    pair = torch.ones(b, n, n) * (1 - torch.eye(n))
    args = (torch_tree(np_tree(params)), static, torch.zeros(b, n, dn),
            torch.randn(b, n, 3, generator=torch.Generator().manual_seed(0)),
            torch.zeros(b, n, n, de), torch.zeros(b, 1, 1), torch.zeros(b, 1, 1), pair)
    with torch.no_grad():
        counted = flops.counted_flops(tden.node_edge_net, *args)
    ratio = flops.denoiser_forward_flops(b, n, dn, de, 1, use_gate=use_gate) / counted
    assert 0.6 < ratio <= 1.05, (ratio, counted)


def test_mfu_fields():
    out = flops.mfu(1e12, 0.5, 989.4e12)   # 2 TFLOP/s sustained
    assert out["tflops_per_sec"] == pytest.approx(2.0)
    assert out["pct_peak"] == pytest.approx(100 * 2e12 / 989.4e12)
    assert flops.mfu(None, 1.0, 1e12) == {} and flops.mfu(1e12, 0.0, 1e12) == {}
    # JAX's rounded fields against its own default peak
    want = jflops.mfu(3e12, 0.7)
    got = flops.mfu(3e12, 0.7, jflops.DEFAULT_PEAK)
    assert {k: round(v, 1) for k, v in got.items()} == want


def test_device_peak_flops():
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    for kind in ("NVIDIA A100-SXM4-80GB", "TPU v5e", ""):
        with pytest.raises(ValueError, match="peak"):
            flops.device_peak_flops(kind)
