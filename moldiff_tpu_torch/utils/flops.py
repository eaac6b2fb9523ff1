"""FLOP accounting for the achieved rate and its share of the card's peak
(moldiff_tpu/utils/flops.py).

``denoiser_forward_flops`` is the JAX package's analytic count of one
NodeEdgeNet forward, the same function. ``counted_flops`` counts the
operations PyTorch dispatches (``FlopCounterMode``) where the JAX package
reads XLA's cost analysis. ``device_peak_flops`` is a table of Hopper
cards' dense bf16 peaks from NVIDIA's data sheets, by
``torch.cuda.get_device_name()``; an unknown card raises, with no default
peak to fall back to.
"""
from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# (NVIDIA H100 data sheet, without sparsity; the SXM5 part at its 700 W limit)
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}


def device_peak_flops(kind: str) -> float:
    """The dense bf16 peak FLOP/s of a card named ``kind``."""
    try:
        return PEAK_BF16[kind]
    except KeyError:
        raise ValueError(f"no bf16 peak is known for {kind!r}; known: {sorted(PEAK_BF16)}") \
            from None


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn`` as torch.utils.flop_counter counts them
    (matrix products and the like). Count on the CPU, with the kernels'
    plain versions: the port's kernels launch through ctypes, where the
    counter cannot see them, so on the card it would miss their work."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def denoiser_forward_flops(batch: int, n_atoms: int, node_dim: int, edge_dim: int,
                           num_blocks: int, num_gaussians: int = 16, update_edge: bool = True,
                           update_pos: bool = True, use_gate: bool = True) -> float:
    """Analytic matmul FLOPs of one dense NodeEdgeNet forward
    (flops.py:47-91): the O(N^2) pair-tensor products, 2 m k n each; the
    O(N) and O(1) terms, under 1 % at these widths, are left out."""
    bn2 = float(batch) * n_atoms * n_atoms
    dn, de, g = node_dim, edge_dim, num_gaussians
    per_block = 0.0
    # edge_emb: [.., De+G] @ [De+G, De]
    per_block += 2 * (de + g if update_edge else g) * de
    # NodeBlock: edge_net MLP (De->Dn->Dn), msg_net (Dn->Dn),
    # gate edge part (De->Dn) + second layer (Dn->Dn)
    per_block += 2 * (de * dn + dn * dn) + 2 * dn * dn
    if use_gate:
        per_block += 2 * de * dn + 2 * dn * dn
    if update_edge:
        # EdgeBlock: 2 x BondFFN(De, Dn, inter=2De) + self/out linears; the
        # node-side linear runs on the [B,N,1,Dn] slab (O(N))
        inter = 2 * de
        bffn = 2 * de * inter                     # bond_linear
        bffn += 2 * (inter * inter + inter * de)  # inter MLP
        if use_gate:
            bffn += 2 * (de * 32 + 32 * de)       # gate bond part + layer 2
        per_block += 2 * bffn + 2 * de * de + 2 * de * de
    if update_pos:
        # PosUpdate edge_lin = BondFFN(De, De, inter=Dn, out=1) on pair
        # tensors on both sides (the node side is the left * right product)
        per_block += 2 * de * dn + 2 * de * dn        # bond/node linears
        per_block += 2 * (dn * dn + dn * 1)           # inter MLP
        if use_gate:
            per_block += 2 * (de * 32 + de * 32 + 32 * 1)
    return per_block * bn2 * num_blocks


def mfu(flops_per_step: Optional[float], seconds_per_step: float, peak: float) -> dict:
    """{'tflops_per_sec', 'pct_peak'} of ``flops_per_step`` done in
    ``seconds_per_step`` against ``peak`` FLOP/s, unrounded; empty without
    a count or a time."""
    if not flops_per_step or seconds_per_step <= 0:
        return {}
    sustained = flops_per_step / seconds_per_step
    return {"tflops_per_sec": sustained / 1e12, "pct_peak": 100.0 * sustained / peak}
