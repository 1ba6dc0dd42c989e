"""``python -m repro_torch.analysis``: the port's odlint CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
