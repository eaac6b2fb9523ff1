"""Training: the optimizer and schedulers (optim.py), the train and eval
steps and checkpoints (trainer.py), and the command line
(``python -m moldiff_tpu_torch.train``, cli.py)."""
