import sys

from chemprop_tpu_torch.cli.main import main

sys.exit(main())
