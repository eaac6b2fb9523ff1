"""``python -m moldiff_tpu_torch.eval --root <sample dir>`` (see evaluate.py)."""
from .evaluate import main

if __name__ == "__main__":
    main()
