"""``python -m moldiff_tpu_torch.train.bond --config ... [--resume ...]`` (see bond_cli.py)."""
from .bond_cli import main

if __name__ == "__main__":
    main()
