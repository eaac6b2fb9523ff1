"""moldiff_tpu_torch and chip_smoke.py run where neither JAX, the JAX
package, PyYAML, pandas nor ml_dtypes can be imported, as on a machine that
has only PyTorch and numpy: every module imports, flagship_v2.ckpt loads,
the demo checkpoint runs MolDiff.forward, one reverse step, one respaced
DDIM step with commit both, one SamplerService.generate, the sampler's
pool classified by two spawned workers as serially, and one training
step (on an in-memory corpus) on the CPU, and the same forward with
fuse_block and a training step with edge_full; the demo bond predictor
initialised from scratch takes a training step, and the demo denoiser one
with grad_accum 2; the evaluation CLI scores a tiny sample directory and a
dataset split and the analysis CLI compares them; a record store is built
from an SDF directory by the native parser and a training step reads it;
a reference state dict converts back to the demo checkpoint's params; the
model variants run: one training step of a MoE denoiser (the demo widths
with train/settings.py's expert bank), one reverse step of the continuous
categorical space, guided, and one forward of an ungated denoiser, with
utils/flops.py's count beside it; the data axis: the train CLI with
parallel.num_devices 2 and FSDP starts two gloo processes, which take a
step and write a sharded checkpoint, read back here; and the pipe axis
(parallel/pipeline.py): the train CLI with parallel.pipe 2 runs the demo
denoiser's blocks as two stages in two gloo processes for a step; the graph
and model axes: the train CLI with parallel.graph 2, then parallel.model
2, takes a step in two gloo processes by the plain route; all in a fresh
interpreter with those modules blocked."""
import json
import os
import subprocess
import sys

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "moldiff_tpu", "yaml", "pandas", "ml_dtypes")

CHILD = r"""
import sys
BLOCKED = %r
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None   # any import of it now raises ImportError

import importlib, json, pkgutil
import numpy as np
import torch
import moldiff_tpu_torch

names = []
for info in pkgutil.walk_packages(moldiff_tpu_torch.__path__, "moldiff_tpu_torch."):
    if not info.name.endswith("__main__"):
        importlib.import_module(info.name)
        names.append(info.name)
import chip_smoke

from moldiff_tpu_torch.utils.checkpoint import load_checkpoint, map_global
from moldiff_tpu_torch.data.featurize import featurizer_from_config
from moldiff_tpu_torch.models.moldiff import MolDiff

flag = load_checkpoint("ckpts/flagship_v2.ckpt", device="cpu")
assert flag["params"]["denoiser"]["blocks"]["edge_emb"]["w"].shape == (6, 80, 64)
assert map_global("numpy._core.numeric", "_frombuffer", False)[0] == "numpy.core.numeric"

ck = load_checkpoint("ckpts/demo_synthetic_30k.ckpt", device="cpu")
feat = featurizer_from_config(ck["config"])
model = MolDiff(ck["config"]["model"], feat.num_node_types, feat.num_edge_types, device="cpu")
b, n = 2, 12
node_mask = torch.ones(b, n)
node_mask[1, 9:] = 0
g = torch.Generator().manual_seed(0)
state = model.init_state(node_mask, model.draw_noise(b, n, g))
t = torch.full((b,), 150, dtype=torch.long)
preds = model.forward(ck["params"], state.h_node, state.pos, state.h_halfedge, t, node_mask)
step = model.reverse_step(ck["params"], state, 150, node_mask, model.draw_noise(b, n, g),
                          commit="nodes")
assert all(bool(torch.isfinite(x).all()) for x in preds)
assert step.pos.shape == (b, n, 3) and bool(torch.isfinite(step.pos).all())

from moldiff_tpu_torch.sample.cli import load_bond_predictor
bp, bp_params = load_bond_predictor("ckpts/demo_bondpred_4k.ckpt", feat, torch.device("cpu"))
guided = model.reverse_step(ck["params"], state, 150, node_mask, model.draw_noise(b, n, g),
                            commit="nodes", bond_predictor=(bp, bp_params, None),
                            guidance=("uncertainty", 1e-4), edge_guidance=0.5)
assert bool(torch.isfinite(guided.pos).all())

transitions, t_map = model._respaced(20)
ddim = model.reverse_step(ck["params"], state, 10, node_mask, model.draw_noise(b, n, g),
                          commit="both", transitions=transitions, t_model=int(t_map[10]),
                          pos_sampler="ddim", eta=0.0)
assert bool(torch.isfinite(ddim.pos).all()) and ddim.com_edge.shape == (b, n * (n - 1) // 2)

from moldiff_tpu_torch.sample.cli import build_sampler
from moldiff_tpu_torch.serve import SamplerService
sampler, sparams = build_sampler("ckpts/demo_synthetic_30k.ckpt",
                                 {"num_steps": 3, "buckets": [12], "size_mean": 9.0,
                                  "size_std": 1.0}, torch.device("cpu"), batch_size=2)
served = SamplerService(sampler, sparams).generate(1, seed=0)
assert served["seed"] == 0 and isinstance(served["smiles"], list)
# the classification pool: two spawned workers give the serial pool
pools = []
for workers in (0, 2):
    sampler.recon_workers = workers
    pools.append(sampler.generate(sparams, 1, torch.Generator().manual_seed(0),
                                  rng=np.random.default_rng(0), batch_graphs=2))
entries = [[(e["pool"], e.get("smiles")) for e in p["finished"] + p["failed"]] for p in pools]
assert entries[1] == entries[0] and entries[0], entries
sampler.recon_workers = 0

from moldiff_tpu_torch.data.dataset import make_corpus
from moldiff_tpu_torch.data.loader import BucketedLoader
from moldiff_tpu_torch.train.trainer import batch_to_device
from moldiff_tpu_torch.train.trainer import Trainer
train_cfg = dict(chip_smoke.TRAIN_SETTINGS["train"], batch_size=2)
trainer = Trainer(model, train_cfg)
tstate = trainer.init_from_params(ck["params"])
recs = make_corpus("./data/synthetic", 10)["train"]
batch = batch_to_device(next(iter(BucketedLoader(recs, feat, 2, (16, 24, 32), prefetch=0))), "cpu")
tstate, aux = trainer.train_step(tstate, batch, trainer.draw_step_noise(batch, g))
assert tstate.step == 1 and all(bool(torch.isfinite(v)) for v in aux.values()), aux

# the two other routes: a whole-block (fuse_block) forward and an
# edge_full training step
import copy
from moldiff_tpu_torch.ops import kernels
routed = {}
for flag in ("fuse_block", "edge_full"):
    cfg = copy.deepcopy(ck["config"]["model"])
    cfg["denoiser"][flag] = True
    routed[flag] = MolDiff(cfg, feat.num_node_types, feat.num_edge_types, device="cpu")
    assert routed[flag].denoiser_static[flag]
fused = routed["fuse_block"].forward(ck["params"], state.h_node, state.pos, state.h_halfedge, t,
                                     node_mask)
assert all(bool(torch.isfinite(x).all()) for x in fused)
trainer = Trainer(routed["edge_full"], train_cfg)
tstate, aux = trainer.train_step(trainer.init_from_params(ck["params"]), batch,
                                 trainer.draw_step_noise(batch, g))
assert tstate.step == 1 and all(bool(torch.isfinite(v)) for v in aux.values()), aux

# training from scratch: the bond predictor's init and one step of its loss
# (the demo predictor's config), and one grad_accum step of the denoiser
from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.train.settings import TRAIN_BONDPRED_DEMO
from moldiff_tpu_torch.utils.config import Config
bp_cfg = Config(TRAIN_BONDPRED_DEMO)
bp_feat = featurizer_from_config(bp_cfg)
bp_model = BondPredictor(bp_cfg.model, bp_feat.num_node_types, bp_feat.num_edge_types,
                         device="cpu")
trainer = Trainer(bp_model, dict(bp_cfg.train, batch_size=2))
bp_batch = batch_to_device(next(iter(BucketedLoader(recs, bp_feat, 2, (16, 24, 32),
                                                    prefetch=0))), "cpu")
tstate, aux = trainer.train_step(trainer.init_state(g), bp_batch,
                                 trainer.draw_step_noise(bp_batch, g))
assert tstate.step == 1 and "acc_bond" in aux, aux
assert all(bool(torch.isfinite(v)) for v in aux.values()), aux
trainer = Trainer(model, dict(train_cfg, grad_accum=2))
tstate, aux = trainer.train_step(trainer.init_state(g), batch,
                                 trainer.draw_step_noise(batch, g))
assert tstate.step == 1 and all(bool(torch.isfinite(v)) for v in aux.values()), aux
# evaluation: both CLIs on a tiny sample directory in the sample CLI's
# layout, scored against a dataset split made by its corpus recipe
import os, pickle, shutil, tempfile
from moldiff_tpu_torch.chem.sanitize import sanitize
from moldiff_tpu_torch.chem.sdf import write_sdf
from moldiff_tpu_torch.data.dataset import mol_to_arrays
from moldiff_tpu_torch.data.synthetic_v2 import random_molecule_v2
from moldiff_tpu_torch.eval import analyze, evaluate
work = tempfile.mkdtemp()
try:
    gen_dir = os.path.join(work, "gen")
    os.makedirs(os.path.join(gen_dir, "SDF"))
    rng = np.random.default_rng(3)
    finished = []
    for k in range(4):
        mol = sanitize(random_molecule_v2(rng))
        write_sdf([mol], os.path.join(gen_dir, "SDF", f"{k}.sdf"))
        arr = mol_to_arrays(mol)
        finished.append({"decoded": {"element": arr["element"], "atom_pos": arr["pos"],
                                     "bond_index": arr["bond_index"],
                                     "bond_type": arr["bond_type"]}})
    with open(os.path.join(gen_dir, "samples_all.pkl"), "wb") as f:
        pickle.dump({"finished": finished, "failed": []}, f)
    with open(os.path.join(gen_dir, "summary.json"), "w") as f:
        json.dump({"sanitize_mode": "reference"}, f)
    report = evaluate.main(["--root", gen_dir])
    assert report["num_mols"] == 4, report
    ref_dir = os.path.join(work, "ref")
    evaluate.main(["--from_where", "dataset", "--dataset_root", "./data/synthetic",
                   "--corpus_mols", "40", "--outdir", ref_dir])
    table = analyze.main(["--ref", ref_dir, "--methods", "port=" + report["out_dir"],
                          "--out", os.path.join(work, "metrics_all_methods.csv")])
    assert "jsd_n_atoms" in table["port"] and table["port"]["v_n_complete"] >= 1, table
finally:
    shutil.rmtree(work)

# the data path: a record store built from an SDF directory by the native
# parser, one training step read from it, and a reference state dict
# converted (the demo checkpoint's params exported and read back)
import copy
from moldiff_tpu_torch.data.synthetic import make_synthetic_dataset
from moldiff_tpu_torch.train import cli as train_cli
from moldiff_tpu_torch.train.settings import TRAIN_DEMO_SYNTHETIC_30K
from moldiff_tpu_torch.utils import convert
work = tempfile.mkdtemp()
try:
    root = os.path.join(work, "data")
    make_synthetic_dataset(root, n_mols=12, seed=0, chemistry="v2")
    cfg = copy.deepcopy(TRAIN_DEMO_SYNTHETIC_30K)
    cfg["dataset"]["root"] = root
    cfg["model"]["denoiser"]["dtype"] = "float32"
    cfg["train"].update(batch_size=2, buckets=[24, 32, 48], val_freq=1, val_batches=1)
    out = train_cli.run(cfg, device="cpu", logdir=os.path.join(work, "logs"), max_iters=1,
                        log=lambda m: None)
    assert out["data"] == "store" and len(out["steps"]) == 1, out["data"]
    assert os.path.exists(os.path.join(root, "processed.bin"))
    assert all(np.isfinite(out["steps"][0][k]) for k in ("loss", "grad_norm"))
    sd = convert.export_moldiff_state_dict(ck["params"])
    back = convert.convert_moldiff_state_dict(sd, ck["config"]["model"], device="cpu")
    from moldiff_tpu_torch.utils.tree import tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(ck["params"])))
finally:
    shutil.rmtree(work)
# the model variants: a MoE training step, a guided continuous reverse
# step, an ungated forward and its FLOP count
from moldiff_tpu_torch.train.settings import MOE
from moldiff_tpu_torch.utils.flops import counted_flops, denoiser_forward_flops
variants = {}
for name, section, over in (("moe", "denoiser", {"moe": MOE}),
                            ("continuous", "diff", {"categorical_space": "continuous",
                                                    "scaling": [1.0, 4.0, 8.0]}),
                            ("ungated", "denoiser", {"use_gate": False})):
    cfg = copy.deepcopy(ck["config"]["model"])
    cfg[section].update(over)
    variants[name] = MolDiff(cfg, feat.num_node_types, feat.num_edge_types, device="cpu")
trainer = Trainer(variants["moe"], train_cfg)
tstate, aux = trainer.train_step(trainer.init_state(g), batch, trainer.draw_step_noise(batch, g))
assert tstate.step == 1 and float(aux["loss_moe"]) > 0, aux
cont = variants["continuous"]
cstate = cont.init_state(node_mask, cont.draw_noise(b, n, g))
cstep = cont.reverse_step(ck["params"], cstate, 150, node_mask, cont.draw_noise(b, n, g),
                          bond_predictor=(bp, bp_params, None), guidance=("uncertainty", 1e-4))
assert cstep.log_node is None and bool(torch.isfinite(cstep.h_halfedge).all())
ungated = variants["ungated"]
uparams = ungated.init_params(g)
with torch.no_grad():
    counted = counted_flops(ungated.forward, uparams, state.h_node, state.pos, state.h_halfedge,
                            t, node_mask)
assert counted > denoiser_forward_flops(b, n, 128, 32, 4, use_gate=False) > 0
# the data axis: the train CLI with parallel.num_devices 2 starts two gloo
# processes (FSDP, a sharded checkpoint), read back here
from moldiff_tpu_torch.train import checkpoint_sharded
from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT_FSDP2
work = tempfile.mkdtemp()
try:
    cfg = copy.deepcopy(TRAIN_V2_CONT_FSDP2)
    cfg["model"] = copy.deepcopy(ck["config"]["model"])
    cfg["model"]["denoiser"]["dtype"] = "float32"
    cfg["dataset"]["root"] = "./data/synthetic"
    cfg["train"].update(batch_size=2, buckets=[16, 24, 32], val_freq=1, val_batches=1)
    out = train_cli.run(cfg, device="cpu", logdir=os.path.join(work, "logs"), max_iters=1,
                        corpus_mols=10, log=lambda m: None)
    assert len(out["ranks"]) == 2 and out["ranks"][0]["steps"][0]["loss"] == \
        out["ranks"][1]["steps"][0]["loss"], out["ranks"]
    st = checkpoint_sharded.load_checkpoint_sharded(out["checkpoints"][0])["state"]
    assert int(st["step"]) == 1 and "denoiser" in st["params"]
finally:
    shutil.rmtree(work)
# the pipe axis: two stages of the demo denoiser's 4 blocks, one step
from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT_PP2
work = tempfile.mkdtemp()
try:
    cfg = copy.deepcopy(TRAIN_V2_CONT_PP2)
    cfg["model"] = copy.deepcopy(ck["config"]["model"])
    cfg["model"]["denoiser"]["dtype"] = "float32"
    cfg["dataset"]["root"] = "./data/synthetic"
    cfg["train"].update(batch_size=2, buckets=[16, 24, 32], val_freq=1, val_batches=1)
    out = train_cli.run(cfg, device="cpu", logdir=os.path.join(work, "logs"), max_iters=1,
                        corpus_mols=10, log=lambda m: None)
    s0, s1 = (r["steps"][0] for r in out["ranks"])
    assert s0["loss"] == s1["loss"] and s0["pipe"]["p2p_bytes"] > 0, (s0, s1)
finally:
    shutil.rmtree(work)
# the graph and model axes: one step of the demo denoiser with its pair
# tensors split by receiver over 2 ranks, then with its MLPs split over 2
from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT_GRAPH2, TRAIN_V2_CONT_TP2
for settings in (TRAIN_V2_CONT_GRAPH2, TRAIN_V2_CONT_TP2):
    work = tempfile.mkdtemp()
    try:
        cfg = copy.deepcopy(settings)
        cfg["model"] = copy.deepcopy(ck["config"]["model"])
        cfg["model"]["denoiser"]["dtype"] = "float32"
        cfg["dataset"]["root"] = "./data/synthetic"
        cfg["train"].update(batch_size=2, buckets=[16, 24, 32], val_freq=1, val_batches=1)
        out = train_cli.run(cfg, device="cpu", logdir=os.path.join(work, "logs"), max_iters=1,
                            corpus_mols=10, log=lambda m: None)
        s0, s1 = (r["steps"][0] for r in out["ranks"])
        assert s0["loss"] == s1["loss"] and s0["model_comm"]["all_reduce_calls"] > 0, (s0, s1)
        assert sum(s0["launches"].values()) == 0, s0["launches"]
    finally:
        shutil.rmtree(work)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print(json.dumps({"modules": names, "settings": chip_smoke.SAMPLE_SETTINGS,
                  "guided": chip_smoke.GUIDED_SETTINGS, "train": chip_smoke.TRAIN_SETTINGS}))
"""


def test_port_runs_without_jax_yaml_pandas():
    proc = subprocess.run([sys.executable, "-c", CHILD % (BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("moldiff_tpu_torch.ops.kernels", "moldiff_tpu_torch.ops.build",
                 "moldiff_tpu_torch.sample.cli", "moldiff_tpu_torch.models.moldiff",
                 "moldiff_tpu_torch.models.bond_predictor",
                 "moldiff_tpu_torch.chem.bond_perception", "moldiff_tpu_torch.train.cli",
                 "moldiff_tpu_torch.train.trainer", "moldiff_tpu_torch.train.optim",
                 "moldiff_tpu_torch.train.bond_cli", "moldiff_tpu_torch.train.checkpoint_async",
                 "moldiff_tpu_torch.data.synthetic_v2", "moldiff_tpu_torch.data.loader",
                 "moldiff_tpu_torch.ops.respace", "moldiff_tpu_torch.serve.server",
                 "moldiff_tpu_torch.eval", "moldiff_tpu_torch.eval.evaluate",
                 "moldiff_tpu_torch.eval.analyze", "moldiff_tpu_torch.eval.metrics",
                 "moldiff_tpu_torch.chem.smarts", "moldiff_tpu_torch.chem.embed",
                 "moldiff_tpu_torch.chem.sdf_native", "moldiff_tpu_torch.data.record_store",
                 "moldiff_tpu_torch.data.convert_lmdb", "moldiff_tpu_torch.data.make_corpus",
                 "moldiff_tpu_torch.utils.misc", "moldiff_tpu_torch.utils.tb_writer",
                 "moldiff_tpu_torch.utils.profiling", "moldiff_tpu_torch.utils.convert",
                 "moldiff_tpu_torch.utils.strip_checkpoint",
                 "moldiff_tpu_torch.train.supervisor", "moldiff_tpu_torch.models.moe",
                 "moldiff_tpu_torch.utils.flops", "moldiff_tpu_torch.parallel",
                 "moldiff_tpu_torch.parallel.mesh", "moldiff_tpu_torch.parallel.multihost",
                 "moldiff_tpu_torch.parallel.launch", "moldiff_tpu_torch.parallel.pipeline",
                 "moldiff_tpu_torch.parallel.collectives",
                 "moldiff_tpu_torch.train.checkpoint_sharded",
                 "moldiff_tpu_torch.sample.classify", "moldiff_tpu_torch.sample.sweep"):
        assert name in out["modules"]
    # chip_smoke's sample settings are the committed YAML config's
    with open(os.path.join(REPO, "configs/sample/sample_flagship_v2.yml")) as f:
        assert out["settings"] == yaml.safe_load(f)
    # its guided settings are the guided config's, with the model's bonds
    # (the JAX gate's regime) in place of add_edge: distance
    with open(os.path.join(REPO, "configs/sample/sample_flagship_v2_guided.yml")) as f:
        guided = yaml.safe_load(f)
    assert guided["sample"].pop("add_edge") == "distance"
    assert out["guided"] == guided
    # its training settings are configs/train/train_v2_cont.yml's (the
    # dataset root aside: the smoke draws its corpus at given sizes)
    with open(os.path.join(REPO, "configs/train/train_v2_cont.yml")) as f:
        train = yaml.safe_load(f)
    for cfg in (train, out["train"]):
        cfg["dataset"].pop("root")
    assert out["train"] == train
