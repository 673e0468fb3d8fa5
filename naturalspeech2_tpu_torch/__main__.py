"""`python -m naturalspeech2_tpu_torch` → the ns2-torch CLI."""

import sys

from naturalspeech2_tpu_torch.cli import main

sys.exit(main())
