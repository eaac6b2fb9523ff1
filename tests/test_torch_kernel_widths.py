"""The wrappers whose kernels run the NodeBlock, EdgeBlock and PosUpdate
pair kernels (node_block, edge_pair, edge_block_full, fused_block,
pos_update, pos_update_bwd: rows 1, 4, 6, 2, 8, 9) refuse a width those
kernels are not instantiated for with a ValueError that names the built
ones, before the kernel library is loaded or anything is launched. No card
here: meta tensors stand in for CUDA ones, with the wrappers' device check
passed."""
import jax
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_edge_net
from moldiff_tpu_torch.ops import build, kernels

# node_dim / edge_dim 192 / 96: multiples of 32 up to 256 (which every
# wrapper's width check takes), but no model of the repo's
B, N, DN, DE, DH = 2, 8, 192, 96, 16


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _calls():
    params = jax.eval_shape(lambda: init_node_edge_net(
        jax.random.key(0), DN, DE, num_blocks=1, cutoff=10, use_gate=True)[0])
    blk = jax.tree.map(lambda a: _meta(a.shape[1:]), params["blocks"])
    nb, eb, pb = blk["node_block"], blk["edge_block"], blk["pos_block"]
    x, e, hd = _meta((B, N, DN)), _meta((B, N, N, DE)), _meta((B, N, N, DH))
    rel, dist = _meta((B, N, N, 3), torch.float32), _meta((B, N, N), torch.float32)
    t, mask = _meta((B, 1, 1), torch.float32), _meta((B, N, N), torch.float32)
    ct = _meta((B, N, 3), torch.float32)
    return {
        "node_block": (kernels.node_block_aggregate,
                       ({k: nb[k] for k in ("node_net", "edge_net", "msg_net", "gate")},
                        x, e, t, mask)),
        "edge_pair": (kernels.edge_pair_aggregate,
                      ({"left": eb["bond_ffn_left"], "right": eb["bond_ffn_right"]},
                       e, x, t, mask)),
        "edge_block_full": (kernels.edge_block_full, (eb, e, x, t, mask)),
        "fused_block": (kernels.fused_block, (blk, x, e, hd, rel, dist, t, mask)),
        "pos_update": (kernels.pos_update, (pb, x, e, rel, dist, t, mask)),
        "pos_update_bwd": (kernels.pos_update_bwd, (pb, x, e, rel, dist, t, mask, ct)),
    }


@pytest.mark.parametrize("name", ["node_block", "edge_pair", "edge_block_full", "fused_block",
                                  "pos_update", "pos_update_bwd"])
def test_unbuilt_width_is_refused_before_any_launch(name, monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "_require_cuda", lambda kernel, device: None)
    monkeypatch.setattr(build, "library", no_library)
    fn, args = _calls()[name]
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match=r"the pair kernel is built for \("):
        fn(*args)
    assert kernels.launch_counts == before
