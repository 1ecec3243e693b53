import sys

from smafa_tpu_torch.cli import main

sys.exit(main())
