"""``python -m repro_torch.bench`` runs `repro_torch.bench.run`."""
import sys

from repro_torch.bench.run import main

sys.exit(main())
