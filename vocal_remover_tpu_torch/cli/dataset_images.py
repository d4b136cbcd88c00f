"""Images of the estimated vocal magnitude of every pair of a dataset,
on the host (reference lib/dataset.py:262-287 `__main__`).

    python -m vocal_remover_tpu_torch.cli.dataset_images MIX_DIR INST_DIR OUT_DIR

Counterpart of vocal_remover_tpu/cli/dataset_images.py: each pair's
spectrograms come from the cache (data/cache.py, 44.1 kHz, n_fft 2048,
hop 1024; made on first use), and OUT_DIR/<name>_Vocal.jpg (`.png`
where PIL is not installed) shows |X| - |y| where it exceeds |y|.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    mix_dir, inst_dir, outdir = argv[0], argv[1], argv[2]

    from vocal_remover_tpu_torch.data import cache, pairing
    from vocal_remover_tpu_torch.utils import image
    from vocal_remover_tpu_torch.utils.spec import spectrogram_to_image

    os.makedirs(outdir, exist_ok=True)

    for mix_path, inst_path in pairing.make_pair(mix_dir, inst_dir):
        mix_basename = os.path.splitext(os.path.basename(mix_path))[0]
        X_spec, y_spec, _, _ = cache.cache_or_load(
            mix_path, inst_path, 44100, 1024, 2048)

        X_mag = np.abs(X_spec)
        y_mag = np.abs(y_spec)
        v_mag = X_mag - y_mag
        v_mag *= v_mag > y_mag

        outpath = os.path.join(outdir, f"{mix_basename}_Vocal.jpg")
        image.imwrite(outpath, spectrogram_to_image(v_mag))


if __name__ == "__main__":
    main()
