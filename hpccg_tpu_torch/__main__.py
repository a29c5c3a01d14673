import sys

from hpccg_tpu_torch.cli import main

sys.exit(main())
