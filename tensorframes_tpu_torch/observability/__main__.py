"""Entry point: ``python -m tensorframes_tpu_torch.observability``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
