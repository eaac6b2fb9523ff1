"""The port's sampling pipeline and CLI on the CPU, end to end at a small
size: the demo checkpoint (T = 200), generate until one molecule, decode,
classify, write SMILES.txt / SDF / summary.json."""
import json
import os

import numpy as np
import pytest
import torch

from moldiff_tpu_torch.sample import cli
from moldiff_tpu_torch.sample.pipeline import MolSampler


def test_cli_run_on_cpu(tmp_path):
    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "size_mean": 9.0,
                         "size_std": 1.0, "sanitize_mode": "reference", "commit": "nodes",
                         "buckets": [12]}}
    logs = []
    summary = cli.run(config, device="cpu", outdir=str(tmp_path), run_name="r", log=logs.append)
    out = tmp_path / "r"
    assert summary["num_finished"] == 1
    assert summary["chains"] >= 1 and summary["num_classified"] >= 1
    assert summary["num_classified"] == summary["chains"] * 4
    lo, hi = summary["success_wilson95"]
    assert 0.0 <= lo <= summary["success_rate"] <= hi <= 1.0
    smiles = (out / "SMILES.txt").read_text().split()
    assert len(smiles) == 1 and "." not in smiles[0]
    assert os.path.exists(out / "SDF" / "0.sdf")
    assert json.loads((out / "summary.json").read_text())["num_finished"] == 1


def test_cli_refuses_unported_settings(tmp_path):
    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "num_steps": 100}}
    with pytest.raises(NotImplementedError, match="num_steps"):
        cli.run(config, device="cpu", outdir=str(tmp_path))


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run({"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
                 "sample": {"seed": 1, "batch_size": 4, "num_mols": 1}})


@pytest.mark.parametrize("k,n,want", [(0, 0, (0.0, 1.0)), (5, 10, (0.2366, 0.7634)),
                                      (745, 1000, (0.7171, 0.7710))])
def test_wilson_interval(k, n, want):
    np.testing.assert_allclose(cli.wilson_interval(k, n), want, atol=1e-4)


def test_sizes_and_buckets():
    """Sizes clip to [3, largest bucket]; each bucket runs in batches padded
    to batch_size."""
    class Stub:
        device = torch.device("cpu")

        def __init__(self):
            self.masks = []

        def sample(self, params, node_mask, generator, commit):
            self.masks.append(node_mask)
            b, n = node_mask.shape
            from moldiff_tpu_torch.models.moldiff import MolDiffPreds
            return MolDiffPreds(torch.zeros(b, n, 8), torch.zeros(b, n, 3),
                                torch.zeros(b, n * (n - 1) // 2, 6))

    stub = Stub()
    from moldiff_tpu_torch.data.featurize import MolFeaturizer

    sampler = MolSampler(stub, MolFeaturizer(), buckets=[40, 32], batch_size=3)
    sizes = sampler.draw_sizes(1000, np.random.default_rng(0))
    assert sizes.min() >= 3 and sizes.max() <= 40
    out = sampler.sample_sizes(None, np.array([30, 35, 31, 5, 32]), torch.Generator())
    assert [tuple(m.shape) for m in stub.masks] == [(3, 32), (3, 32), (3, 40)]
    assert stub.masks[1].sum(1).tolist() == [32, 3, 3]  # padded with 3-atom graphs
    assert sampler.chains == 3 and len(out) == 5
    assert [len(d["element"]) for d in out] == [30, 35, 31, 5, 32]
