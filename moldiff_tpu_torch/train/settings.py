"""The committed training configurations that run on the card, as dicts:
the card has no PyYAML. A CPU test holds each equal to its YAML file.

  TRAIN_V2_CONT   configs/train/train_v2_cont.yml (flagship_v2 fine-tuning)

Both ``chip_smoke.py`` and ``profile_steps --train`` run this one.
"""

TRAIN_V2_CONT = {
    "model": {
        "name": "diffusion", "node_dim": 256, "edge_dim": 64, "bond_len_loss": True,
        "denoiser": {"backbone": "NodeEdgeNet", "num_blocks": 6, "cutoff": 15,
                     "use_gate": True, "dtype": "bfloat16"},
        "diff": {
            "num_timesteps": 1000, "time_dim": 10, "categorical_space": "discrete",
            "diff_pos": {"beta_schedule": "advance", "scale_start": 0.9999,
                         "scale_end": 0.0001, "width": 3},
            "diff_atom": {"init_prob": "tomask", "beta_schedule": "advance",
                          "scale_start": 0.9999, "scale_end": 0.0001, "width": 3},
            "diff_bond": {"init_prob": "absorb", "beta_schedule": "segment",
                          "time_segment": [600, 400],
                          "segment_diff": [
                              {"scale_start": 0.9999, "scale_end": 0.001, "width": 3},
                              {"scale_start": 0.001, "scale_end": 0.0001, "width": 2}]},
        },
    },
    "train": {
        "seed": 2026, "batch_size": 128, "max_iters": 340000, "val_freq": 1000,
        "val_batches": 4, "pos_noise_std": 0.05, "ema_decay": 0.999, "max_grad_norm": 50.0,
        "ckpt_freq": 2000, "buckets": [32, 40],
        "optimizer": {"type": "adamw", "lr": 3.0e-5, "weight_decay": 1.0e-8, "beta1": 0.99,
                      "beta2": 0.999},
        "scheduler": {"type": "plateau", "factor": 0.8, "patience": 3, "min_lr": 1.0e-5},
    },
    "parallel": {"num_devices": None},
    "transform": {"use_mask_node": True, "use_mask_edge": True},
    "dataset": {"name": "drug3d", "root": "./data/synthetic_xl2",
                "path_dict": {"sdf": "sdf", "summary": "mol_summary.csv",
                              "processed": "processed.mdb"},
                "split": "split_by_molid.pkl"},
    "chem": {"atomic_numbers": [6, 7, 8, 9, 15, 16, 17], "mol_bond_types": [1, 2, 3, 4]},
}
