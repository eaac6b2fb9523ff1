"""Sampling: the generate-until-N pipeline (pipeline.py) and the command
line (``python -m moldiff_tpu_torch.sample``, cli.py)."""
