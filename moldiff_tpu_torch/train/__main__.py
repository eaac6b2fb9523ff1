"""``python -m moldiff_tpu_torch.train --config ... [--resume ...]`` (see cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
