"""Package logging.

The reference's observability is bare ``std::cout`` prints with filename
prefixes (SURVEY.md section 5); here a standard :mod:`logging` logger with
the same information content — per-file errors, batch flushes, device
launches — that integrates with whatever the host application configures.
Set ``PIM_JPEG_TPU_LOG=debug|info|warning`` to adjust without code.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("pim_jpeg_decoder_tpu_torch")

_level = os.environ.get("PIM_JPEG_TPU_LOG")
if _level:
    logging.basicConfig()
    logger.setLevel(getattr(logging, _level.upper(), logging.WARNING))
