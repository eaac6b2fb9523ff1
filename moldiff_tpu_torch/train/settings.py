"""The committed training configurations that run on the card, as dicts:
the card has no PyYAML. A CPU test holds each equal to its YAML file.

  TRAIN_V2_CONT                    configs/train/train_v2_cont.yml (flagship_v2 fine-tuning)
  TRAIN_FULL_SYNTHETIC_XL_SCRATCH  configs/train/train_full_synthetic_xl_scratch.yml
                                   (the flagship widths from scratch)
  TRAIN_DEMO_SYNTHETIC_30K         configs/train/train_demo_synthetic_30k.yml (the demo
                                   denoiser from scratch)
  TRAIN_BONDPRED_V2                configs/train/train_bondpred_v2.yml (the bond predictor,
                                   fine-tuned from ckpts/bondpred_40k.ckpt)
  TRAIN_BONDPRED_DEMO              configs/train/train_bondpred_demo.yml (the demo bond
                                   predictor from scratch)

and the model variants, none of which a committed config uses, each a
committed config with one override (held to the file and the override by
the same CPU test):

  MOE_V2             TRAIN_V2_CONT, model.denoiser.moe {num_experts: 4, top_k: 2}
                     (JAX's defaults for the rest: capacity 1.25, aux weight 0.01)
  MOE_BONDPRED_V2    TRAIN_BONDPRED_V2, model.encoder.moe as MOE_V2's
  CONT_V2            TRAIN_V2_CONT, model.diff {categorical_space: continuous,
                     scaling: [1.0, 4.0, 8.0]} (tests/test_continuous_mode.py's)
  UNGATED_V2         TRAIN_V2_CONT, model.denoiser.use_gate false

and the data axis (phase 22 of chip_smoke.py), TRAIN_V2_CONT with its
``parallel`` section (and ``train.ckpt_sharded``) overridden:

  TRAIN_V2_CONT_DP2     parallel {num_devices: 2}: two data-parallel ranks
  TRAIN_V2_CONT_FSDP2   parallel {num_devices: 2, fsdp: true},
                        train.ckpt_sharded true

and the pipe and expert axes (phase 23), with the same overrides:

  TRAIN_V2_CONT_PP2     parallel {num_devices: 2, pipe: 2}, train.num_microbatches 2:
                        the 6 blocks as 2 stages of 3, 2 microbatches
  MOE_V2_EP2            MOE_V2, parallel {num_devices: 2, expert: 2}: 2 experts a rank
  MOE_V2_DP2            MOE_V2, parallel {num_devices: 2}: MoE on two data ranks

``chip_smoke.py`` and ``profile_steps --train`` run these. Each dict is
built anew here, so that no two share a nested dict; copy one before
changing it.
"""
import copy


def _advance(**extra) -> dict:
    return {**extra, "beta_schedule": "advance", "scale_start": 0.9999, "scale_end": 0.0001,
            "width": 3}


def _segment_bond() -> dict:
    return {"init_prob": "absorb", "beta_schedule": "segment", "time_segment": [600, 400],
            "segment_diff": [{"scale_start": 0.9999, "scale_end": 0.001, "width": 3},
                             {"scale_start": 0.001, "scale_end": 0.0001, "width": 2}]}


def _diff(num_timesteps: int, time_dim: int, diff_bond: "dict | None" = None) -> dict:
    out = {"num_timesteps": num_timesteps, "time_dim": time_dim,
           "categorical_space": "discrete", "diff_pos": _advance(),
           "diff_atom": _advance(init_prob="tomask")}
    if diff_bond is not None:
        out["diff_bond"] = diff_bond
    return out


def _train(seed: int, max_iters: int, val_freq: int, ckpt_freq: int, buckets: list,
           lr: float, **extra) -> dict:
    return {"seed": seed, "batch_size": 128, "max_iters": max_iters, "val_freq": val_freq,
            "val_batches": 4, "pos_noise_std": 0.05, **extra, "max_grad_norm": 50.0,
            "ckpt_freq": ckpt_freq, "buckets": buckets,
            "optimizer": {"type": "adamw", "lr": lr, "weight_decay": 1.0e-8, "beta1": 0.99,
                          "beta2": 0.999},
            "scheduler": {"type": "plateau", "factor": 0.8, "patience": 3, "min_lr": 1.0e-5}}


def _data(root: str, use_mask_edge: bool) -> dict:
    """The parallel, transform, dataset and chem sections."""
    return {
        "parallel": {"num_devices": None},
        "transform": {"use_mask_node": True, "use_mask_edge": use_mask_edge},
        "dataset": {"name": "drug3d", "root": root,
                    "path_dict": {"sdf": "sdf", "summary": "mol_summary.csv",
                                  "processed": "processed.mdb"},
                    "split": "split_by_molid.pkl"},
        "chem": {"atomic_numbers": [6, 7, 8, 9, 15, 16, 17], "mol_bond_types": [1, 2, 3, 4]},
    }


def _denoiser(node_dim: int, edge_dim: int, num_blocks: int, num_timesteps: int,
              diff_bond: dict) -> dict:
    return {"name": "diffusion", "node_dim": node_dim, "edge_dim": edge_dim,
            "bond_len_loss": True,
            "denoiser": {"backbone": "NodeEdgeNet", "num_blocks": num_blocks, "cutoff": 15,
                         "use_gate": True, "dtype": "bfloat16"},
            "diff": _diff(num_timesteps, 10, diff_bond)}


def _bond_predictor(node_dim: int, edge_dim: int, num_blocks: int, num_timesteps: int,
                    time_dim: int) -> dict:
    return {"name": "bond_predictor", "node_dim": node_dim, "edge_dim": edge_dim,
            "encoder": {"backbone": "NodeEdgeNet", "num_blocks": num_blocks, "cutoff": 20,
                        "use_gate": True, "update_edge": True, "update_pos": False,
                        "dtype": "bfloat16"},
            "diff": _diff(num_timesteps, time_dim)}


TRAIN_V2_CONT = {
    "model": _denoiser(256, 64, 6, 1000, _segment_bond()),
    "train": _train(2026, 340000, 1000, 2000, [32, 40], 3.0e-5, ema_decay=0.999),
    **_data("./data/synthetic_xl2", use_mask_edge=True),
}

TRAIN_FULL_SYNTHETIC_XL_SCRATCH = {
    "model": _denoiser(256, 64, 6, 1000, _segment_bond()),
    "train": dict(_train(2023, 140000, 1000, 5000, [32], 3.0e-4, ema_decay=0.999),
                  keep_ckpts=10, ckpt_async=True),
    **_data("./data/synthetic_xl", use_mask_edge=True),
}

TRAIN_DEMO_SYNTHETIC_30K = {
    "model": _denoiser(128, 32, 4, 200, _advance(init_prob="absorb")),
    "train": _train(2023, 30000, 500, 1000, [32, 48], 3.0e-4),
    **_data("./data/synthetic", use_mask_edge=True),
}

TRAIN_BONDPRED_V2 = {
    "model": _bond_predictor(256, 64, 8, 1000, 20),
    "train": _train(2024, 60000, 1000, 2000, [32, 40], 1.0e-4),
    **_data("./data/synthetic_xl2", use_mask_edge=False),
}

TRAIN_BONDPRED_DEMO = {
    "model": _bond_predictor(128, 32, 4, 200, 10),
    "train": _train(2023, 20000, 2000, 5000, [32, 48], 3.0e-4),
    **_data("./data/synthetic", use_mask_edge=False),
}


def _override(settings: dict, section: str, **values) -> dict:
    """A copy of ``settings`` with ``values`` set on its model's
    ``section`` ("denoiser", "encoder" or "diff")."""
    out = copy.deepcopy(settings)
    out["model"][section].update(values)
    return out


MOE = {"num_experts": 4, "top_k": 2}
MOE_V2 = _override(TRAIN_V2_CONT, "denoiser", moe=MOE)
MOE_BONDPRED_V2 = _override(TRAIN_BONDPRED_V2, "encoder", moe=MOE)
CONT_V2 = _override(TRAIN_V2_CONT, "diff", categorical_space="continuous",
                        scaling=[1.0, 4.0, 8.0])
UNGATED_V2 = _override(TRAIN_V2_CONT, "denoiser", use_gate=False)


def _sections(settings: dict, **sections) -> dict:
    """A copy of ``settings`` with ``sections`` (top-level name -> values)
    updated."""
    out = copy.deepcopy(settings)
    for name, values in sections.items():
        out[name].update(values)
    return out


TRAIN_V2_CONT_DP2 = _sections(TRAIN_V2_CONT, parallel={"num_devices": 2})
TRAIN_V2_CONT_FSDP2 = _sections(TRAIN_V2_CONT, parallel={"num_devices": 2, "fsdp": True},
                                train={"ckpt_sharded": True})
TRAIN_V2_CONT_PP2 = _sections(TRAIN_V2_CONT, parallel={"num_devices": 2, "pipe": 2},
                              train={"num_microbatches": 2})
TRAIN_V2_CONT_GRAPH2 = _sections(TRAIN_V2_CONT, parallel={"num_devices": 2, "graph": 2})
TRAIN_V2_CONT_TP2 = _sections(TRAIN_V2_CONT, parallel={"num_devices": 2, "model": 2})
MOE_V2_EP2 = _sections(MOE_V2, parallel={"num_devices": 2, "expert": 2})
MOE_V2_DP2 = _sections(MOE_V2, parallel={"num_devices": 2})
