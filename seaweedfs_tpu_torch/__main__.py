"""``python -m seaweedfs_tpu_torch <subcommand>``: the port's ``weed``."""

import sys

from .command import main

sys.exit(main())
