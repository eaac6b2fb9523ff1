"""What a training run leaves in its directory, held to the JAX package:
MetricsWriter's lines, the TensorBoard event file's bytes (time and host
pinned) and its reader, StepTimer's summary, and the train CLIs' run
records: a CPU run of ``moldiff_tpu_torch.train`` from a store directory
writes log.txt, the config, metrics.jsonl and an event file with the
(tag, step) pairs that scripts/train_drug3d.py writes for the same
settings, for a tiny dense config and a tiny MoE one (``loss_moe``); the
recipe branch still runs; any other root raises."""
import copy
import json
import logging
import os
import socket
import time

import numpy as np
import pytest
import yaml

import moldiff_tpu.utils.profiling as jprofiling
from moldiff_tpu.utils import misc as jmisc
from moldiff_tpu.utils import tb_writer as jtb
from moldiff_tpu_torch.data.synthetic import make_synthetic_dataset
from moldiff_tpu_torch.train import settings
from moldiff_tpu_torch.utils import misc, profiling, tb_writer

SCALARS = [("train/loss", 1.5, 1), ("train/lr", 3e-4, 1), ("val/loss", 2.25, 100),
           ("train/loss", float(np.float32(0.1)), 300001), ("val/loss", -7.0, 2 ** 40)]


def _write(mod, log_dir, tensorboard):
    w = mod.MetricsWriter(str(log_dir), tensorboard=tensorboard)
    for tag, value, step in SCALARS:
        w.add_scalar(tag, value, step)
    w.flush()
    w.close()


def test_metrics_lines_equal_jax_but_ts(tmp_path):
    _write(misc, tmp_path / "port", False)
    _write(jmisc, tmp_path / "jax", False)
    rows = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
             for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
            for d in ("port", "jax")]
    assert rows[0] == rows[1] and len(rows[0]) == len(SCALARS)
    assert not [n for n in os.listdir(tmp_path / "port") if n.startswith("events")]


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    """With the clock and the host name pinned, the port's event file is
    JAX's byte for byte and has its name."""
    monkeypatch.setattr(time, "time", lambda: 1792329046.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "card.example")
    monkeypatch.delenv("MOLDIFF_TB", raising=False)
    _write(misc, tmp_path / "port", None)
    _write(jmisc, tmp_path / "jax", None)
    names = [sorted(n for n in os.listdir(tmp_path / d) if n.startswith("events"))
             for d in ("port", "jax")]
    assert names[0] == names[1] == ["events.out.tfevents.1792329046.card"]
    assert (tmp_path / "port" / names[0][0]).read_bytes() == \
        (tmp_path / "jax" / names[0][0]).read_bytes()


def test_tb_off_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MOLDIFF_TB", "0")
    w = misc.MetricsWriter(str(tmp_path))
    assert w.event_path is None
    w.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


def test_read_events_reads_jax_files(tmp_path):
    """The port's reader gives the JAX writer's scalars back, steps of 128
    and more included, which the JAX reader reads wrong (its varint never
    shifts); CRCs are checked on every record."""
    w = jtb.TBEventWriter(str(tmp_path))
    for tag, value, step in SCALARS:
        w.add_scalar(tag, value, step)
    w.close()
    ev = tb_writer.read_events(w.path)
    assert ev[0]["file_version"] == "brain.Event:2"
    assert [(e["tag"], e["step"], e["value"]) for e in ev[1:]] == \
        [(t, s, float(np.float32(v))) for t, v, s in SCALARS]
    assert [e["step"] for e in jtb.read_events(w.path)[1:]] != [s for _, _, s in SCALARS]
    assert tb_writer.crc32c(b"123456789") == jtb.crc32c(b"123456789") == 0xE3069283
    data = bytearray(open(w.path, "rb").read())
    data[-1] ^= 1
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(AssertionError, match="crc"):
        tb_writer.read_events(w.path)


def test_step_timer_equals_jax(monkeypatch):
    ticks = [10.0, 10.5, 10.75, 12.0, 12.01, 12.5, 13.5]
    out = []
    for mod in (profiling, jprofiling):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=4)
        assert timer.summary() == {}
        dts = [timer.tick() for _ in ticks]
        out.append((dts, timer.summary()))
    assert out[0] == out[1] and out[0][0][0] is None
    assert profiling.device_memory_stats() == {}


def test_logger_and_log_dirs(tmp_path):
    """get_logger writes log.txt in its log dir, and a later call moves the
    file to the new dir; get_new_log_dir is JAX's name."""
    a = misc.get_new_log_dir(str(tmp_path), prefix="run", tag="x")
    assert os.path.basename(a).startswith("run_") and a.endswith("_x") and os.path.isdir(a)
    b = str(tmp_path / "b")
    misc.get_logger("records_test", a).info("first")
    misc.get_logger("records_test", b).info("second")
    assert "first" in open(os.path.join(a, "log.txt")).read()
    text_b = open(os.path.join(b, "log.txt")).read()
    assert "second" in text_b and "first" not in text_b
    hole = misc.BlackHole()
    hole.anything = 1
    assert hole.anything(3).more is hole


# -- the train CLIs' run records --------------------------------------------

def _tiny_cfg(root: str) -> dict:
    full = copy.deepcopy(settings.TRAIN_FULL_SYNTHETIC_XL_SCRATCH)
    full["model"].update(node_dim=32, edge_dim=16)
    full["model"]["denoiser"].update(num_blocks=2, dtype="float32")
    full["dataset"]["root"] = root
    full["parallel"]["num_devices"] = 1
    full["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=2, val_batches=1,
                         ckpt_freq=2, keep_ckpts=0, ckpt_async=False)
    return full


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "synthetic40")
    make_synthetic_dataset(root, n_mols=40, seed=1, chemistry="v1")
    return root


def _pairs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return rows, sorted((r["tag"], r["step"]) for r in rows)


def _events(log_dir):
    (name,) = [n for n in os.listdir(log_dir) if n.startswith("events.out.tfevents.")]
    return tb_writer.read_events(os.path.join(log_dir, name))


def _train_cli_records(cfg_dict: dict, tmp_path, monkeypatch) -> tuple:
    """python -m moldiff_tpu_torch.train --config tiny.yml (2 steps) and
    scripts/train_drug3d.py on the same config -> (the port's log dir, its
    metrics rows and (tag, step) pairs, JAX's pairs), after checking both
    wrote the same files."""
    from moldiff_tpu_torch.train import cli as train_cli
    from scripts import train_drug3d

    monkeypatch.delenv("MOLDIFF_TB", raising=False)
    # JAX's get_logger adds its log file only to a logger without handlers
    monkeypatch.setattr(logging.getLogger("train"), "handlers", [])
    cfg = str(tmp_path / "tiny.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(cfg_dict, f)
    args = ["--config", cfg, "--max_iters", "2"]
    jax = train_drug3d.main(args + ["--logdir", str(tmp_path / "jax")])
    port = train_cli.main(args + ["--logdir", str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(n for n in os.listdir(port) if not n.startswith("events")) == \
        sorted(n for n in os.listdir(jax) if not n.startswith("events")) == \
        ["checkpoints", "log.txt", "metrics.jsonl", "tiny.yml"]
    rows, pairs = _pairs(port)
    return port, rows, pairs, _pairs(jax)[1]


def test_train_cli_records_equal_jax_scripts(store_dir, tmp_path, monkeypatch):
    """python -m moldiff_tpu_torch.train --config tiny.yml (2 steps from the
    store directory, val_freq 2) and scripts/train_drug3d.py on the same
    config: the same files in the log dir, and the same (tag, step) pairs in
    metrics.jsonl and in the event file. Values differ (the RNGs do)."""
    port, rows, pairs, jax_pairs = _train_cli_records(_tiny_cfg(store_dir), tmp_path,
                                                      monkeypatch)
    assert pairs == jax_pairs
    assert ("train/loss_len", 1) in pairs and ("val/loss", 2) in pairs
    ev = _events(port)
    assert [(e["tag"], e["step"], e["value"]) for e in ev[1:]] == \
        [(r["tag"], r["step"], float(np.float32(r["value"]))) for r in rows]
    log = open(os.path.join(port, "log.txt")).read()
    assert "record store" in log and "[it 1] loss" in log and "[val 2]" in log


def test_train_cli_records_moe_equal_jax_scripts(store_dir, tmp_path, monkeypatch):
    """The same 2-step run of the tiny config with train/settings.py's
    expert bank (model.denoiser.moe): train/loss_moe under JAX's (tag,
    step) pairs, in metrics.jsonl and in the event file, and in the log
    line."""
    cfg = _tiny_cfg(store_dir)
    cfg["model"]["denoiser"]["moe"] = dict(settings.MOE)
    port, rows, pairs, jax_pairs = _train_cli_records(cfg, tmp_path, monkeypatch)
    assert pairs == jax_pairs and ("train/loss_moe", 1) in pairs
    moe = [r["value"] for r in rows if r["tag"] == "train/loss_moe"]
    assert len(moe) == 1 and 0 < moe[0] < 1
    ev = _events(port)
    assert [(e["tag"], e["step"], e["value"]) for e in ev[1:]] == \
        [(r["tag"], r["step"], float(np.float32(r["value"]))) for r in rows]
    assert "loss_moe" in open(os.path.join(port, "log.txt")).read()


def test_run_summary_says_the_source(store_dir, tmp_path):
    """run() on a directory reads its store (summary "store"), on a corpus
    recipe that is not a directory makes it in memory ("recipe"); given
    subsets are "given"; any other root raises before a step. A resumed run
    writes val/loss but no train/* at a first iteration that is neither 1
    nor a multiple of 100."""
    from moldiff_tpu_torch.data.dataset import make_corpus
    from moldiff_tpu_torch.train import cli as train_cli

    kw = dict(device="cpu", logdir=str(tmp_path), max_iters=2)
    store = train_cli.run(_tiny_cfg(store_dir), **kw)
    assert store["data"] == "store" and store["timer"]["steps_per_sec"] > 0
    recipe = train_cli.run(_tiny_cfg("./data/synthetic"), corpus_mols=40, name="recipe", **kw)
    assert recipe["data"] == "recipe" and [s["it"] for s in recipe["steps"]] == [1, 2]
    given = train_cli.run(_tiny_cfg("nowhere"), subsets=make_corpus("./data/synthetic", 40),
                          name="given", **kw)
    assert given["data"] == "given"
    with pytest.raises(ValueError, match="neither a directory nor a corpus recipe"):
        train_cli.run(_tiny_cfg(str(tmp_path / "nowhere")), name="bad", **kw)
    resumed = train_cli.run(_tiny_cfg(store_dir), resume=store["checkpoints"][-1],
                            name="resumed", **dict(kw, max_iters=4))
    assert [s["it"] for s in resumed["steps"]] == [3, 4]
    assert _pairs(resumed["log_dir"])[1] == [("val/loss", 4)]


def test_bond_cli_records(store_dir, tmp_path, monkeypatch):
    """python -m moldiff_tpu_torch.train.bond_cli --config tiny_bond.yml and
    scripts/train_bond.py on the same config (2 steps from the store
    directory, val_freq 2): the same files in the log dir and the same
    (tag, step) pairs, train/loss and train/acc_bond at iteration 1 and
    val/loss at each validation."""
    from moldiff_tpu_torch.train import bond_cli
    from scripts import train_bond

    monkeypatch.delenv("MOLDIFF_TB", raising=False)
    monkeypatch.setattr(logging.getLogger("train_bond"), "handlers", [])
    full = copy.deepcopy(settings.TRAIN_BONDPRED_DEMO)
    full["model"].update(node_dim=32, edge_dim=16)
    full["model"]["encoder"].update(num_blocks=2, dtype="float32")
    full["dataset"]["root"] = store_dir
    full.setdefault("parallel", {})["num_devices"] = 1
    full["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=2, val_batches=1,
                         ckpt_freq=2)
    cfg = str(tmp_path / "tiny_bond.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(full, f)
    args = ["--config", cfg, "--max_iters", "2"]
    jax = train_bond.main(args + ["--logdir", str(tmp_path / "jax")])
    port = bond_cli.main(args + ["--logdir", str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(n for n in os.listdir(port) if not n.startswith("events")) == \
        sorted(n for n in os.listdir(jax) if not n.startswith("events")) == \
        ["checkpoints", "log.txt", "metrics.jsonl", "tiny_bond.yml"]
    assert _pairs(port)[1] == _pairs(jax)[1] == [("train/acc_bond", 1), ("train/loss", 1),
                                                 ("val/loss", 2)]
    assert [(e["tag"], e["step"]) for e in _events(port)[1:]] == \
        [(e["tag"], e["step"]) for e in _events(jax)[1:]]
    assert "record store" in open(os.path.join(port, "log.txt")).read()


def test_chip_smoke_phase20_checks(store_dir, tmp_path, monkeypatch):
    """chip_smoke.py phase 20's checks on the CPU: the first molecules of
    the synthetic_xl2 recipe written as a directory and processed into a
    store match the recipe's records (positions to the SDF's 4 decimals),
    and a run's metrics.jsonl and event file agree; a dropped event fails."""
    import chip_smoke
    from moldiff_tpu_torch.data.dataset import get_dataset, make_corpus
    from moldiff_tpu_torch.train import cli as train_cli

    assert chip_smoke.STORE_CORPUS == ("./data/synthetic_xl2", 512)
    monkeypatch.setattr(chip_smoke, "STORE_CORPUS", ("./data/synthetic_xl2", 12))
    root = chip_smoke._make_store_dir((str(tmp_path / "xl2"), "./data/synthetic_xl2", 12))
    cfg = dict(chip_smoke.TRAIN_SETTINGS["dataset"], root=root)
    dataset, _ = get_dataset(cfg)
    chip_smoke.check_store_records(dataset, make_corpus("./data/synthetic_xl2", 12))
    out = train_cli.run(_tiny_cfg(store_dir), device="cpu", logdir=str(tmp_path), max_iters=2)
    rows = chip_smoke.check_run_records(out)
    assert [(r["tag"], r["step"]) for r in rows][-1] == ("val/loss", 2)
    with open(out["metrics"], "a") as f:
        f.write(json.dumps({"step": 2, "tag": "val/extra", "value": 1.0, "ts": 0.0}) + "\n")
    with pytest.raises(AssertionError):
        chip_smoke.check_run_records(out)
