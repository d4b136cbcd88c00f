"""Dual-handler logger (a copy of vocal_remover_tpu/train/logging.py;
reference train.py:18-34 `setup_logger`):
DEBUG to file, INFO to console, propagation off."""

from __future__ import annotations

import logging


def setup_logger(name, logfile="LOGFILENAME.log"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fh = logging.FileHandler(logfile, encoding="utf8")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(
        logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    )

    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)

    logger.addHandler(fh)
    logger.addHandler(sh)

    return logger
