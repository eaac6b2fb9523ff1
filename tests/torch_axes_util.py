"""Helpers of the graph- and model-axis tests (tests/test_torch_graph_parallel.py,
tests/test_torch_tensor_parallel.py): tests/test_pipeline.py's tiny MolDiff
(node_dim 16, edge_dim 8, T = 8) with two blocks, so that the row-split
edge features pass from one block to the next, at float32; a narrow bond
predictor; mid-run states and JAX's Trainer on JAX's meshes of the
conftest's virtual CPU devices. The spawned ranks run in a thread while
JAX computes its side."""
import concurrent.futures
import copy

import jax
import numpy as np

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu_torch.ops import kernels
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from test_torch_data_parallel import TYPES, model_cfg as dp_model_cfg, step_noise
from test_torch_ungated import KERNEL_WRAPPERS
from torch_dist_util import make_model, np_batch_to_torch, start_state, whole

SPAWN_S = 240
T_MAX = {"moldiff": 8, "bond": 200}


def model_cfg(kind: str = "moldiff") -> dict:
    """tests/test_pipeline.py's tiny_model config with two blocks (MolDiff),
    or tests/test_torch_data_parallel.py's bond predictor (node 32, edge
    16, two blocks, T = 200)."""
    if kind == "bond":
        return dp_model_cfg("bond")
    sched = {"beta_schedule": "advance", "scale_start": 0.9999, "scale_end": 0.0001, "width": 3}
    return {"node_dim": 16, "edge_dim": 8,
            "denoiser": {"num_blocks": 2, "cutoff": 10, "use_gate": True},
            "diff": {"num_timesteps": 8, "time_dim": 4, "categorical_space": "discrete",
                     "diff_pos": dict(sched), "diff_atom": dict(sched, init_prob="tomask"),
                     "diff_bond": dict(sched, init_prob="absorb")}}


def jax_model(kind: str = "moldiff", cfg: "dict | None" = None):
    """JAX's model of ``kind`` with :func:`model_cfg` (or ``cfg``)."""
    kn, ke = TYPES[kind]
    return (JMolDiff if kind == "moldiff" else JBondPredictor)(
        copy.deepcopy(cfg or model_cfg(kind)), kn, ke)


def noise(kind: str, key, b_padded: int, accum: int = 1) -> list:
    return step_noise(kind, key, b_padded, accum, T_MAX[kind])


def mid_run(kind: str, params: dict, tcfg: dict, b: dict, cfg: "dict | None" = None) -> dict:
    """A state ten steps into a run (tests/test_torch_data_parallel.py's
    mid_run, for this module's models, or ``cfg``'s): adam's count 10, mu 0
    and nu 1e-2 x the square of each leaf's gradient scale, EMA a copy of
    the params."""
    kn, ke = TYPES[kind]
    tr = Trainer(make_model(kind, cfg or model_cfg(kind), kn, ke), dict(tcfg, grad_accum=1))
    st = tr.init_from_params(params_to_torch(params, "cpu"))
    grads, _, _ = tr.gradient(st, np_batch_to_torch(b),
                              noise(kind, jax.random.key(1), len(b["pos"]))[0])
    nu = [np.full(g.shape, 1e-2 * float(g.abs().max()) ** 2 + 1e-12, np.float32) for g in grads]
    tree = jax.tree.structure(params)
    return {"params": params, "step": 100, "count": 10,
            "mu": jax.tree.map(np.zeros_like, params), "nu": jax.tree.unflatten(tree, nu),
            "ema": params if tcfg.get("ema_decay") else None}


def run_kwargs(kind: str, tcfg: dict, state: dict, steps: list, axes: dict,
               cfg: "dict | None" = None, **kw) -> dict:
    """One run of torch_dist_util.axis_worker (the model of :func:`model_cfg`
    or ``cfg``)."""
    kn, ke = TYPES[kind]
    return dict(kind=kind, model_cfg=cfg or model_cfg(kind), kn=kn, ke=ke, train_cfg=tcfg,
                state=state, steps=steps, axes=axes, **kw)


def world_one(kind: str, tcfg: dict, state: dict, steps: list, cfg: "dict | None" = None) -> tuple:
    """The port's trainer at world 1 on the same steps -> (aux per step,
    whole state per step)."""
    kn, ke = TYPES[kind]
    tr = Trainer(make_model(kind, cfg or model_cfg(kind), kn, ke), tcfg)
    st = start_state(tr, state)
    auxs, states = [], []
    for b, nz in steps:
        st, aux = tr.train_step(st, b, nz)
        auxs.append({k: float(v) for k, v in aux.items()})
        states.append(whole(tr, st))
    return auxs, states


def padded(b: dict, rows: int) -> dict:
    """``b`` with fully masked graphs appended up to ``rows``."""
    extra = rows - len(b["pos"])
    return {k: np.concatenate([v, np.zeros((extra,) + v.shape[1:], v.dtype)])
            for k, v in b.items()}


def background(fn, *args, **kw):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return future


class NoKernels:
    """Every kernel wrapper of ops/kernels.py replaced, for the test, by a
    recorder of its calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        for fn in KERNEL_WRAPPERS:
            monkeypatch.setattr(kernels, fn, lambda *a, _n=fn, **k: self.calls.append(_n))
