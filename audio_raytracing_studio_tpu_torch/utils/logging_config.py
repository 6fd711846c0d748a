"""Structured logging — port of ``audio_raytracing_studio_tpu/utils/logging_config.py``.

One logger hierarchy rooted at ``ars_torch`` (the port's modules log as
``ars_torch.<name>``), with its level from the ``ARS_TORCH_LOG_LEVEL``
environment variable, beside ``ARS_TORCH_DEVICE``.  The JAX package's root
is ``ars_tpu``, so a process that loads both packages keeps two separate
hierarchies.
"""

from __future__ import annotations

import logging
import os

ROOT_LOGGER = "ars_torch"


def configure(level: str | int | None = None) -> logging.Logger:
    """Configure the port's root logger once; idempotent."""
    logger = logging.getLogger(ROOT_LOGGER)
    if logger.handlers:
        return logger
    if level is None:
        level = os.environ.get("ARS_TORCH_LOG_LEVEL", "INFO")
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT_LOGGER}.{name}")
