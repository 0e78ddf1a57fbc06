"""``python -m ont_tcrconsensus_tpu_torch <run_config.json> [--cpu]``."""

import sys

from ont_tcrconsensus_tpu_torch.pipeline.cli import main

if __name__ == "__main__":
    sys.exit(main())
