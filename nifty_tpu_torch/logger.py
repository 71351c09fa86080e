"""The port's logger (counterpart of ``nifty_tpu/logger.py``): the standard
``logging`` logger named ``nifty_tpu_torch``; the application configures
its handlers and level."""

import logging

logger = logging.getLogger("nifty_tpu_torch")
