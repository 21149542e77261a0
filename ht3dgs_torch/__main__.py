"""`python -m ht3dgs_torch --mode ...`: see `ht3dgs_torch.run`."""

import sys

from .run import main

main(sys.argv[1:])
