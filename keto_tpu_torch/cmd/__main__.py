import sys

from keto_tpu_torch.cmd import main

if __name__ == "__main__":
    sys.exit(main())
