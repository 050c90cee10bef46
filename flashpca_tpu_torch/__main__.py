"""``python -m flashpca_tpu_torch`` == the flashpca-compatible CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
