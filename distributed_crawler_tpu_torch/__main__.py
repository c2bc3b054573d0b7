"""``python -m distributed_crawler_tpu_torch``: the port's CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
