"""`python -m zignal_tpu_torch.cli` entry (the installed `zignal-torch`
script calls main.main directly). Importing this module runs nothing."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
