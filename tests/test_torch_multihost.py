"""moldiff_tpu_torch.parallel.multihost against moldiff_tpu.parallel.multihost:
shard_range over a grid of cases; the per-process seed streams (distinct
by process, reproducible); merge_shards writing files byte-equal to JAX's
on the same shard directories (numeric order of shards and SDF files
included); and the sample CLI run by 2 processes on the CPU (the demo
checkpoint, a 50-step respaced chain, 4 molecules, a FileStore
rendezvous), then ``--merge``, read by the eval CLI."""
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from moldiff_tpu.parallel import multihost as jmulti
from moldiff_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shard_range_equals_jax():
    for num in range(0, 23):
        for procs in range(1, 7):
            got = [multihost.shard_range(num, p, procs) for p in range(procs)]
            assert got == [jmulti.shard_range(num, p, procs) for p in range(procs)]
            assert sum(b - a for a, b in got) == num and got[0][0] == 0


def test_seed_streams_differ_by_process_and_repeat():
    seeds = [multihost.shard_seeds(2023, p) for p in range(4)]
    assert seeds == [multihost.shard_seeds(2023, p) for p in range(4)]
    assert [s[1] for s in seeds] == [(2023, p) for p in range(4)]   # JAX CLI's numpy seed
    assert len({s[0] for s in seeds}) == 4 and multihost.shard_seeds(2024, 0) != seeds[0]
    draws = [torch.rand(4, generator=torch.Generator().manual_seed(t)) for t, _ in seeds]
    assert all(not torch.equal(draws[0], d) for d in draws[1:])
    again = torch.rand(4, generator=torch.Generator().manual_seed(seeds[1][0]))
    assert torch.equal(again, draws[1])
    n = [np.random.default_rng(s[1]).random(3) for s in seeds]
    assert not np.array_equal(n[0], n[1])


def _make_shards(root: str) -> None:
    rng = np.random.default_rng(0)
    for pid, n in ((0, 3), (2, 12), (10, 1)):
        d = os.path.join(root, f"shard_{pid}")
        os.makedirs(os.path.join(d, "SDF" if pid != 2 else "sdf"))
        pool = {"finished": [{"smiles": f"C{pid}{k}", "decoded": {"pos": rng.normal(size=(2, 3))}}
                             for k in range(n)],
                "failed": [{"reason": "x", "decoded": None}] * pid, "wall_s": 1.0}
        with open(os.path.join(d, "samples_all.pkl"), "wb") as f:
            pickle.dump(pool, f)
        with open(os.path.join(d, "SMILES.txt"), "w") as f:
            f.write("".join(f"C{pid}{k}\n" for k in range(n)))
        for k in range(n):
            with open(os.path.join(d, "SDF" if pid != 2 else "sdf", f"{k}.sdf"), "w") as f:
                f.write(f"mol {pid} {k}\n$$$$\n")
        if pid == 2:
            with open(os.path.join(d, "sdf", "traj_1.sdf"), "w") as f:
                f.write("traj\n")
    os.makedirs(os.path.join(root, "other"))


def _files(root: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("remove", [False, True])
def test_merge_shards_byte_equal_to_jax(tmp_path, remove):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    _make_shards(ours)
    shutil.copytree(ours, theirs)
    got = multihost.merge_shards(ours, remove=remove)
    want = jmulti.merge_shards(theirs, remove=remove)
    assert pickle.dumps(got) == pickle.dumps(want)
    a, b = _files(ours), _files(theirs)
    assert a == b and "SDF/15.sdf" in a and "meta.json" in a
    assert a["SDF/3.sdf"] == b"mol 2 0\n$$$$\n" and a["SDF/14.sdf"] == b"mol 2 11\n$$$$\n"
    with pytest.raises(FileNotFoundError):
        multihost.merge_shards(str(tmp_path / "ours" / "other"))


def test_sample_cli_two_processes_then_merge(tmp_path):
    """Two CLI processes share the pool of 4 (2 each, disjoint streams) and
    log the global counts; --merge writes 4 SMILES lines, 4 SDF files and
    the merged pool; the eval CLI reads the merged directory."""
    cfg = tmp_path / "sample.yml"
    cfg.write_text(yaml.safe_dump({
        "model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
        "sample": {"seed": 5, "batch_size": 4, "num_mols": 4, "size_mean": 9.0, "size_std": 1.0,
                   "sanitize_mode": "reference", "commit": "nodes", "num_steps": 50,
                   "buckets": [12]}}))
    out = tmp_path / "out"
    rdv = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "moldiff_tpu_torch.sample", "--config", str(cfg), "--device", "cpu",
         "--outdir", str(out), "--run_name", "r", "--num_processes", "2", "--process_id", str(p),
         "--coordinator", rdv], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-3000:]
    run = out / "r"
    summaries = [json.loads((run / f"shard_{p}" / "summary.json").read_text()) for p in range(2)]
    counts = summaries[0]["global_counts"]
    assert counts == summaries[1]["global_counts"] == [[s["num_finished"], s["num_failed"]]
                                                       for s in summaries]
    assert [s["num_finished"] for s in summaries] == [2, 2]
    smiles = [(run / f"shard_{p}" / "SMILES.txt").read_text() for p in range(2)]
    merged = subprocess.run([sys.executable, "-m", "moldiff_tpu_torch.sample", "--merge",
                             str(run)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert merged.returncode == 0, merged.stderr[-2000:]
    assert (run / "SMILES.txt").read_text() == "".join(smiles)
    assert len((run / "SMILES.txt").read_text().split()) == sum(c[0] for c in counts) == 4
    assert sorted(os.listdir(run / "SDF")) == [f"{k}.sdf" for k in range(4)]
    with open(run / "samples_all.pkl", "rb") as f:
        pool = pickle.load(f)
    assert len(pool["finished"]) == 4 and len(pool["failed"]) == sum(c[1] for c in counts)
    from moldiff_tpu_torch.eval import evaluate
    report = evaluate.main(["--root", str(run)])
    assert report["num_mols"] == 4
