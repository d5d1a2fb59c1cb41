import sys

from heybuddy_tpu_torch.cli import main

sys.exit(main())
