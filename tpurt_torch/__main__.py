"""``python -m tpurt_torch`` runs the command line (``tpurt_torch.cli``)."""

import sys

from tpurt_torch.cli import main

sys.exit(main())
