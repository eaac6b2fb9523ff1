"""moldiff_tpu_torch's host classification pool (sample/classify.py,
MolSampler's ``recon_workers``, the sample CLI's ``--recon_workers``) and
the guidance-scale sweep (``python -m moldiff_tpu_torch.sample.sweep``)
against moldiff_tpu's, on the CPU:

- classify_batch over one batch of 40 decoded molecules (synthetic
  molecules and random decoder outputs, so both pools fill) through a
  spawn pool of 2 workers equals the serial result entry for entry and in
  order (pool, reason, SMILES, stage), for add_edge None, distance and
  connect; the serial result equals JAX's ``_classify_batch``; the workers
  never import torch;
- a job that raises in a worker raises in the caller, and a worker that
  dies raises BrokenProcessPool;
- generate() on a tiny random checkpoint with recon_workers 2 returns the
  pool it returns serially under one seed;
- the CLI's --recon_workers overrides sample.recon_workers;
- the sweep at two scales on a tiny denoiser and predictor writes the JAX
  script's JSON keys for the same arguments."""
import copy
import json
import os
import pickle
import sys
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

from moldiff_tpu.sample.pipeline import _classify_batch as j_classify_batch
from moldiff_tpu_torch.data.dataset import generate_records
from moldiff_tpu_torch.data.featurize import MolFeaturizer, featurizer_from_config
from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.sample import classify, cli, sweep
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy
from moldiff_tpu_torch.utils.config import Config

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
ADD_EDGE = [None, "distance", "connect"]
KEY = lambda e: (e["pool"], e.get("reason"), e.get("smiles"), e.get("stage"))


def _decoded() -> list:
    """20 synthetic molecules (positions jittered; their own bonds) and 20
    decodes of random logits, interleaved."""
    rng = np.random.default_rng(5)
    out = []
    feat = MolFeaturizer()
    for rec in generate_records(20, seed=3):
        pos = rec["pos"][0] + rng.normal(size=rec["pos"][0].shape).astype(np.float32) * 0.03
        out.append({"element": rec["element"].astype(np.int64), "atom_pos": pos,
                    "bond_index": rec["bond_index"].astype(np.int64),
                    "bond_type": rec["bond_type"].astype(np.int64)})
        n = int(rng.integers(5, 14))
        node = rng.normal(size=(n, feat.num_node_types)) * 2
        node[:, 0] += 2.5
        he = rng.normal(size=(n * (n - 1) // 2, feat.num_edge_types)) * 2
        he[:, 0] += 3.5
        out.append(feat.decode_output(node.astype(np.float32),
                                      (rng.normal(size=(n, 3)) * 1.5).astype(np.float32),
                                      he.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def pool():
    workers = classify.make_classify_pool(2)
    yield workers
    workers.shutdown()


@pytest.mark.parametrize("add_edge", ADD_EDGE)
def test_pooled_classification_equals_serial_and_jax(pool, add_edge):
    decoded = _decoded()
    serial = classify.classify_batch(decoded, add_edge)
    pooled = classify.classify_batch(decoded, add_edge, pool)
    assert [KEY(e) for e in pooled] == [KEY(e) for e in serial]
    assert [KEY(e) for e in serial] == [KEY(e) for e in j_classify_batch(decoded, add_edge)]
    assert {e["pool"] for e in serial} == {"finished", "failed"}
    for e, d in zip(pooled, decoded):
        np.testing.assert_array_equal(e["decoded"]["atom_pos"], d["atom_pos"])
    assert not pool.submit(eval, "'torch' in __import__('sys').modules").result()


def test_pool_sizes():
    assert classify.make_classify_pool(0) is None and classify.make_classify_pool(1) is None
    assert classify.make_classify_pool(None) is None


def test_a_job_that_raises_in_a_worker_raises_here(pool):
    bad = _decoded()[:3] + [{"element": np.array([6, 6])}]
    with pytest.raises(KeyError):
        classify.classify_batch(bad, None, pool)


class _Dies:
    """Unpickled in a worker, it ends the worker's process."""

    def __reduce__(self):
        return (os._exit, (3,))


def test_a_dead_worker_raises_broken_pool():
    workers = classify.make_classify_pool(2)
    try:
        with pytest.raises(BrokenProcessPool):
            classify.classify_batch([_Dies()] * 4, None, workers)
    finally:
        workers.shutdown()


# -- the tiny checkpoints: the demo configs at node 16, edge 8, one block, T = 10 ---

def _tiny_config(path: str, section: str) -> dict:
    cfg = copy.deepcopy(load_checkpoint_numpy(path)["config"])
    cfg["model"].update(node_dim=16, edge_dim=8)
    cfg["model"][section].update(num_blocks=1, dtype="float32")
    cfg["model"]["diff"].update(num_timesteps=10, time_dim=4)
    return cfg


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny denoiser and bond predictor from seeds, written as
    checkpoints both packages read."""
    from moldiff_tpu_torch.utils.tree import tree_map

    work = tmp_path_factory.mktemp("tiny")
    out = {}
    for name, path, section in (("ckpt", "ckpts/demo_synthetic_30k.ckpt", "denoiser"),
                                ("bp_ckpt", "ckpts/demo_bondpred_4k.ckpt", "encoder")):
        cfg = _tiny_config(path, section)
        feat = featurizer_from_config(Config(cfg))
        if section == "denoiser":
            model = MolDiff(Config(cfg).model, feat.num_node_types, feat.num_edge_types,
                            device="cpu")
        else:
            model = BondPredictor(Config(cfg).model, feat.num_node_types,
                                  feat.num_bond_types + 1, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(len(name)))
        out[name] = str(work / f"{name}.ckpt")
        with open(out[name], "wb") as f:
            pickle.dump({"config": cfg, "params": tree_map(lambda x: x.numpy(), params),
                         "ema_params": None, "step": 7, "opt_state": None, "scheduler": None,
                         "key": None}, f)
    out["work"] = work
    return out


def test_generate_pooled_equals_serial():
    """The demo checkpoint's 5-step respaced chains: the same pool with 2
    workers as serially, under one seed."""
    pools = []
    for workers in (0, 2):
        sampler, params = cli.build_sampler("ckpts/demo_synthetic_30k.ckpt", {
            "num_steps": 5, "buckets": [12], "size_mean": 9.0, "size_std": 1.0,
            "recon_workers": workers}, torch.device("cpu"), batch_size=8)
        assert sampler.recon_workers == workers
        pools.append(sampler.generate(params, 4, torch.Generator().manual_seed(4),
                                      rng=np.random.default_rng(4), batch_graphs=8))
    serial, pooled = pools
    assert serial["classified"] == pooled["classified"]
    assert sum(serial["classified"].values()) >= 8 and serial["finished"]
    for key in ("finished", "failed"):
        assert [KEY(e) for e in pooled[key]] == [KEY(e) for e in serial[key]]
    assert all(len(e["decoded"]["element"]) >= 3 for e in serial["finished"])


def test_cli_recon_workers_flag_overrides_the_config(tmp_path, monkeypatch):
    import yaml

    cfg = tmp_path / "c.yml"
    cfg.write_text(yaml.safe_dump({"model": {"checkpoint": "ckpts/flagship_v2.ckpt"},
                                   "sample": {"seed": 1, "batch_size": 4, "num_mols": 1,
                                              "recon_workers": 3}}))
    monkeypatch.setattr(cli, "run", lambda config, **kw: config)
    assert cli.main(["--config", str(cfg)])["sample"]["recon_workers"] == 3
    assert cli.main(["--config", str(cfg), "--recon_workers", "2"])["sample"]["recon_workers"] == 2


def test_sweep_writes_the_jax_scripts_keys(tiny, monkeypatch):
    """Both sweeps at two scales on the same arguments: the same top-level
    keys and settings, the same run names, and in each run analyze_pool's
    keys (the gap statistics where a disconnect was autopsied), ci95 and
    wall_s."""
    monkeypatch.syspath_prepend(SCRIPTS)
    import guidance_sweep as jsweep

    args = ["--ckpt", tiny["ckpt"], "--bp_ckpt", tiny["bp_ckpt"], "--scales", "1e-4,3e-4",
            "--num_mols", "1", "--batch_size", "4", "--size_mean", "9", "--size_std", "1"]
    work = tiny["work"]
    got = sweep.main(args + ["--device", "cpu", "--recon_workers", "2",
                             "--out", str(work / "port.json")], log=lambda m: None)
    want = jsweep.main(args + ["--out", str(work / "jax.json")])
    on_disk = json.loads((work / "port.json").read_text())
    assert on_disk == json.loads(json.dumps(got))
    assert sorted(got) == sorted(want)
    for k in ("ckpt", "bp_ckpt", "ckpt_step", "mode", "num_mols", "seed", "num_steps"):
        assert got[k] == want[k], k
    assert list(got["runs"]) == list(want["runs"]) == ["unguided", "uncertainty@0.0001",
                                                       "uncertainty@0.0003"]
    gaps = {"gap_mean", "gap_median", "failed_size_mean"}
    for name in got["runs"]:
        for r in (got["runs"][name], want["runs"][name]):
            autopsied = r["disconnect_bondtype"] + r["disconnect_geometry"] > 0
            assert (gaps <= set(r)) == autopsied and (gaps & set(r)) in (set(), gaps)
        assert set(got["runs"][name]) - gaps == set(want["runs"][name]) - gaps, name
        lo, hi = got["runs"][name]["ci95"]
        assert 0.0 <= lo <= got["runs"][name]["success"] <= hi <= 1.0
    assert "torch" not in sys.modules["moldiff_tpu_torch.sample.sweep"].__dict__
