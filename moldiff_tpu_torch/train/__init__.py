"""Training: the optimizer and schedulers (optim.py), the train and eval
steps and checkpoints (trainer.py, checkpoint_async.py), and the command
lines: the denoiser's (``python -m moldiff_tpu_torch.train``, cli.py) and
the bond predictor's (``python -m moldiff_tpu_torch.train.bond``,
bond_cli.py)."""
