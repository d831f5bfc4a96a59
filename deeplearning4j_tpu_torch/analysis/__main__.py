"""``python -m deeplearning4j_tpu_torch.analysis`` — run graftcheck."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
