"""``python -m textblaster_tpu_torch`` — see :mod:`.cli`."""

import sys

from .cli import main

sys.exit(main())
