"""``python -m moldiff_tpu_torch.sample --config ...`` (see cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
