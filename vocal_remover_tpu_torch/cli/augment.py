"""Offline pitch-shift augmentation of a dataset, on the host.

    python -m vocal_remover_tpu_torch.cli.augment -m MIX_DIR -i INST_DIR [-p -1]

Flag-compatible with vocal_remover_tpu/cli/augment.py (reference
augment.py:14-78). Each (mixture, instrumental) pair is aligned, its
instrumental and vocal (mixture - instrumental) are pitch-shifted by
`--pitch` semitones apart and mixed again, and the two spectrograms are
saved as `<dir>/sr{}_hl{}_nf{}/<name>_pitch{N}.npy`: complex64 (2, F, T),
untransposed, as the reference's np.save of wave_to_spectrogram
(augment.py:71-75). A pair whose two files exist is skipped. The shift
is the built-in phase vocoder (utils/pitch.py); `--engine soundstretch`
runs the external `soundstretch` binary instead, which must be on PATH.
Host only: it touches no card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--hop_length', '-l', type=int, default=1024)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--pitch', '-p', type=int, default=-1)
    p.add_argument('--mixtures', '-m', required=True)
    p.add_argument('--instruments', '-i', required=True)
    p.add_argument('--engine', type=str, default='builtin',
                   choices=['builtin', 'soundstretch'])
    return p


def _soundstretch(wave, sr, pitch):
    from vocal_remover_tpu_torch.utils import audio

    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, 'in.wav')
        dst = os.path.join(td, 'out.wav')
        audio.write_wav(src, wave, sr)
        # a failed shift must not leave an empty or stale cache entry
        subprocess.run(['soundstretch', src, dst, f'-pitch={pitch}'],
                       stderr=subprocess.DEVNULL, check=True)
        out, _ = audio.load(dst, sr=sr)
    if out.ndim == 1:
        out = np.stack([out, out])
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vocal_remover_tpu_torch.data import pairing
    from vocal_remover_tpu_torch.ops.stft import stft_np
    from vocal_remover_tpu_torch.utils import audio
    from vocal_remover_tpu_torch.utils.pitch import pitch_shift
    from vocal_remover_tpu_torch.utils.spec import align_wave_head_and_tail

    if args.engine == 'soundstretch' and shutil.which('soundstretch') is None:
        raise SystemExit('soundstretch not found on PATH; use --engine builtin')

    cache_suffix = f'_pitch{args.pitch}.npy'
    cache_dir = 'sr{}_hl{}_nf{}'.format(args.sr, args.hop_length, args.n_fft)
    mix_cache_dir = os.path.join(args.mixtures, cache_dir)
    inst_cache_dir = os.path.join(args.instruments, cache_dir)
    os.makedirs(mix_cache_dir, exist_ok=True)
    os.makedirs(inst_cache_dir, exist_ok=True)

    for mix_path, inst_path in pairing.make_pair(args.mixtures,
                                                 args.instruments):
        mix_basename = os.path.splitext(os.path.basename(mix_path))[0]
        mix_cache_path = os.path.join(mix_cache_dir,
                                      mix_basename + cache_suffix)
        inst_basename = os.path.splitext(os.path.basename(inst_path))[0]
        inst_cache_path = os.path.join(inst_cache_dir,
                                       inst_basename + cache_suffix)

        if os.path.exists(mix_cache_path) and os.path.exists(inst_cache_path):
            continue
        print(mix_basename)

        X, _ = audio.load(mix_path, sr=args.sr)
        y, _ = audio.load(inst_path, sr=args.sr)
        if X.ndim == 1:
            X = np.stack([X, X])
        if y.ndim == 1:
            y = np.stack([y, y])

        X, y = align_wave_head_and_tail(X, y, args.sr)
        v = X - y

        # instruments and vocals shifted apart, then mixed again
        # (reference augment.py:55-67)
        if args.engine == 'soundstretch':
            y = _soundstretch(y, args.sr, args.pitch)
            v = _soundstretch(v, args.sr, args.pitch)
        else:
            y = pitch_shift(y, args.sr, args.pitch)
            v = pitch_shift(v, args.sr, args.pitch)
        n = min(y.shape[-1], v.shape[-1])
        X = y[:, :n] + v[:, :n]
        y = y[:, :n]

        np.save(mix_cache_path, stft_np(X, args.n_fft, args.hop_length))
        np.save(inst_cache_path, stft_np(y, args.n_fft, args.hop_length))


if __name__ == '__main__':
    main()
