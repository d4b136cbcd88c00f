"""Dataset discovery and train/val splitting.

Counterpart of vocal_remover_tpu/data/pairing.py (reference
lib/dataset.py:144-195): pairing is by sorted order (not name matching)
over INPUT_EXTS, matched case-sensitively as the JAX package does (the
inference CLI's directory mode lower-cases extensions, JAX's
`cli/inference.py` too); `random` split shuffles with the `random`
module and takes the trailing val_rate fraction (honoring an explicit
val filelist by exclusion), `subdirs` uses fixed training/ and
validation/ subtrees.
"""

from __future__ import annotations

import os
import random

INPUT_EXTS = [".wav", ".m4a", ".mp3", ".mp4", ".flac", ".aac"]


def make_pair(mix_dir: str, inst_dir: str):
    X_list = sorted(
        os.path.join(mix_dir, fname)
        for fname in os.listdir(mix_dir)
        if os.path.splitext(fname)[1] in INPUT_EXTS
    )
    y_list = sorted(
        os.path.join(inst_dir, fname)
        for fname in os.listdir(inst_dir)
        if os.path.splitext(fname)[1] in INPUT_EXTS
    )
    return list(zip(X_list, y_list))


def train_val_split(dataset_dir: str, split_mode: str, val_rate: float,
                    val_filelist):
    if split_mode == "random":
        filelist = make_pair(
            os.path.join(dataset_dir, "mixtures"),
            os.path.join(dataset_dir, "instruments"),
        )
        random.shuffle(filelist)

        if len(val_filelist) == 0:
            val_size = int(len(filelist) * val_rate)
            train_filelist = filelist[:-val_size]
            val_filelist = filelist[-val_size:]
        else:
            train_filelist = [
                pair for pair in filelist if list(pair) not in val_filelist
            ]
    elif split_mode == "subdirs":
        if len(val_filelist) != 0:
            raise ValueError(
                "`val_filelist` option is not available with `subdirs` mode"
            )
        train_filelist = make_pair(
            os.path.join(dataset_dir, "training/mixtures"),
            os.path.join(dataset_dir, "training/instruments"),
        )
        val_filelist = make_pair(
            os.path.join(dataset_dir, "validation/mixtures"),
            os.path.join(dataset_dir, "validation/instruments"),
        )
    else:
        raise ValueError(f"unknown split_mode {split_mode!r}")

    return train_filelist, val_filelist
