"""Pseudo-label generation for a paired dataset.

    python -m vocal_remover_tpu_torch.cli.pseudo -P model.vrt.npz \
        -m dataset/mixtures -i dataset/instruments [-o pseudo]

Flag-compatible with vocal_remover_tpu/cli/pseudo.py (reference
pseudo.py:16-78): for each aligned (mixture, instrumental) pair the
vocal spectrogram X - y goes through `Separator.separate_tta`, and the
instrumental content it recovers, `a_spec`, is added to the true
instrumental: `<output_dir>/<name>_PseudoInstruments.npy` holds y +
a_spec, complex64 (2, F, T), beside the reference's one-sample
placeholder `<name>_PseudoInstruments.wav` (pseudo.py:73).

Runs on card `--gpu` (default 0), where the BiLSTM recurrence runs as the
CUDA kernel; `--gpu -1` runs on the CPU. The JAX tool's `--gpu` defaults
to -1.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--gpu', '-g', type=int, default=0,
                   help='CUDA card index; -1 runs on the CPU')
    p.add_argument('--pretrained_model', '-P', type=str,
                   default='models/baseline.vrt.npz')
    p.add_argument('--mixtures', '-m', required=True)
    p.add_argument('--instruments', '-i', required=True)
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--batchsize', '-B', type=int, default=4)
    p.add_argument('--cropsize', '-c', type=int, default=256)
    p.add_argument('--postprocess', '-p', action='store_true')
    p.add_argument('--output_dir', '-o', type=str, default='pseudo')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vocal_remover_tpu_torch import resolve_device
    from vocal_remover_tpu_torch.data import pairing
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.ops.stft import stft_np
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.utils import audio
    from vocal_remover_tpu_torch.utils.spec import align_wave_head_and_tail

    device = resolve_device("cpu" if args.gpu < 0 else f"cuda:{args.gpu}")
    model = convert.load_model(args.pretrained_model, args.n_fft,
                               args.hop_length)

    os.makedirs(args.output_dir, exist_ok=True)
    sp = Separator(model, args.batchsize, args.cropsize, device=device,
                   postprocess=args.postprocess)

    filelist = pairing.make_pair(args.mixtures, args.instruments)
    for n, (mix_path, inst_path) in enumerate(filelist):
        basename = os.path.splitext(os.path.basename(mix_path))[0]
        print(f"[{n + 1}/{len(filelist)}] {basename}", flush=True)

        X, sr = audio.load(mix_path, sr=args.sr)
        y, sr = audio.load(inst_path, sr=args.sr)
        if X.ndim == 1:
            X = np.stack([X, X])
        if y.ndim == 1:
            y = np.stack([y, y])

        X, y = align_wave_head_and_tail(X, y, sr)
        X = stft_np(X, args.n_fft, args.hop_length)
        y = stft_np(y, args.n_fft, args.hop_length)

        # the vocal spectrogram, TTA-separated: the instrumental residue
        # it recovers joins the true instrumental as the pseudo label
        a_spec, _ = sp.separate_tta(X - y)
        pseudo_inst = y + a_spec

        audio.write_wav(
            os.path.join(args.output_dir,
                         f'{basename}_PseudoInstruments.wav'),
            np.zeros(1, np.float32), sr)
        np.save(os.path.join(args.output_dir,
                             f'{basename}_PseudoInstruments.npy'),
                pseudo_inst)


if __name__ == '__main__':
    main()
