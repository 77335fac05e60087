import sys

from pim_jpeg_decoder_tpu_torch.cli import main

sys.exit(main())
