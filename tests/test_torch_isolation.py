"""moldiff_tpu_torch and chip_smoke.py run where neither JAX, the JAX
package, PyYAML, pandas nor ml_dtypes can be imported, as on a machine that
has only PyTorch and numpy: every module imports, flagship_v2.ckpt loads,
and the demo checkpoint runs MolDiff.forward and one reverse step on the
CPU, in a fresh interpreter with those modules blocked."""
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
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print(json.dumps({"modules": names, "settings": chip_smoke.SAMPLE_SETTINGS}))
"""


def test_port_runs_without_jax_yaml_pandas():
    proc = subprocess.run([sys.executable, "-c", CHILD % (BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("moldiff_tpu_torch.ops.kernels", "moldiff_tpu_torch.ops.build",
                 "moldiff_tpu_torch.sample.cli", "moldiff_tpu_torch.models.moldiff"):
        assert name in out["modules"]
    # chip_smoke's sample settings are the committed YAML config's
    with open(os.path.join(REPO, "configs/sample/sample_flagship_v2.yml")) as f:
        assert out["settings"] == yaml.safe_load(f)
