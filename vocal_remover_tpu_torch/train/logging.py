"""Dual-handler logger (a copy of vocal_remover_tpu/train/logging.py;
reference train.py:18-34 `setup_logger`):
DEBUG to file, INFO to console, propagation off."""

from __future__ import annotations

import logging


def setup_logger(name, logfile="LOGFILENAME.log"):
    """`logfile` None: no file, and errors only on the console (the
    ranks of a mesh other than rank 0, which logs the run)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO if logfile is not None else logging.ERROR)
    if logfile is not None:
        fh = logging.FileHandler(logfile, encoding="utf8")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        )
        logger.addHandler(fh)
    logger.addHandler(sh)

    return logger
