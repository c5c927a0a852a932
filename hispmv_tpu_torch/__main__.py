"""``python -m hispmv_tpu_torch``: the host CLI (``cli.py``)."""

import sys

from hispmv_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
