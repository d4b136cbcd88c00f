"""STFT round trip and spectrogram images of one pair, on the host
(reference lib/spec_utils.py:168-198 `__main__`).

    python -m vocal_remover_tpu_torch.cli.spec_debug MIX.wav INST.wav

Counterpart of vocal_remover_tpu/cli/spec_debug.py. Writes, in the
working directory, test_{X,y,v}.jpg (`.png` where PIL is not installed:
utils/image.py) of the mixture, instrumental and vocal spectrograms at
44.1 kHz, n_fft 2048, hop 1024, and test_{X,y,v}.wav, their iSTFTs.
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]

    from vocal_remover_tpu_torch.ops.stft import istft_np, stft_np
    from vocal_remover_tpu_torch.utils import audio, image
    from vocal_remover_tpu_torch.utils.spec import (
        align_wave_head_and_tail,
        spectrogram_to_image,
    )

    X, _ = audio.load(argv[0], sr=44100)
    y, _ = audio.load(argv[1], sr=44100)
    if X.ndim == 1:
        X = np.stack([X, X])
    if y.ndim == 1:
        y = np.stack([y, y])

    X, y = align_wave_head_and_tail(X, y, 44100)
    X_spec = stft_np(X, 2048, 1024)
    y_spec = stft_np(y, 2048, 1024)
    v_spec = X_spec - y_spec

    image.imwrite("test_X.jpg", spectrogram_to_image(X_spec))
    image.imwrite("test_y.jpg", spectrogram_to_image(y_spec))
    image.imwrite("test_v.jpg", spectrogram_to_image(v_spec))

    audio.write_wav("test_X.wav", istft_np(X_spec, 2048, 1024), 44100)
    audio.write_wav("test_y.wav", istft_np(y_spec, 2048, 1024), 44100)
    audio.write_wav("test_v.wav", istft_np(v_spec, 2048, 1024), 44100)


if __name__ == "__main__":
    main()
