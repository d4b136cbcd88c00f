"""SDR evaluation of a model over a paired dataset.

    python -m vocal_remover_tpu_torch.cli.evaluate -P model.vrt.npz \
        -m dataset/mixtures -i dataset/instruments [--tta] [--json out.json]

Flag-compatible with vocal_remover_tpu/cli/evaluate.py (the reference
computes no separation-quality metric, SURVEY.md section 5): each
(mixture, instrumental) pair is aligned and separated, and the
instrumental and vocal (mixture - instrumental) estimates are scored
against the references by SDR, SI-SDR and median one-second SDR
(train/metrics.py); per-song lines, then the means, and with `--json`
a file {"songs": [...], "mean": {...}}. Without `--postprocess` the
separation is the device pipeline (`Separator.separate_wave`); with it,
the spectrogram path (host STFT, `separate` / `separate_tta` with
`merge_artifacts`, host iSTFT). Checkpoints: `.vrt.npz` or a reference
`.pth` (CascadedNet(-f, -H, 32, 128)).

Runs on card `--gpu` (default 0), where the BiLSTM recurrence runs as the
CUDA kernel; `--gpu -1` runs on the CPU. The JAX tool has no `--gpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--gpu', '-g', type=int, default=0,
                   help='CUDA card index; -1 runs on the CPU')
    p.add_argument('--pretrained_model', '-P', type=str, required=True)
    p.add_argument('--mixtures', '-m', required=True)
    p.add_argument('--instruments', '-i', required=True)
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--batchsize', '-B', type=int, default=8)
    p.add_argument('--cropsize', '-c', type=int, default=256)
    p.add_argument('--tta', '-t', action='store_true')
    p.add_argument('--postprocess', '-p', action='store_true')
    p.add_argument('--json', type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vocal_remover_tpu_torch import resolve_device
    from vocal_remover_tpu_torch.data import pairing
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.ops.stft import istft_np, stft_np
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.train import metrics
    from vocal_remover_tpu_torch.utils import audio
    from vocal_remover_tpu_torch.utils.spec import align_wave_head_and_tail

    device = resolve_device("cpu" if args.gpu < 0 else f"cuda:{args.gpu}")
    model = convert.load_model(args.pretrained_model, args.n_fft,
                               args.hop_length, 32, 128)
    sp = Separator(model, args.batchsize, args.cropsize, device=device,
                   postprocess=args.postprocess)

    results = []
    for mix_path, inst_path in pairing.make_pair(args.mixtures,
                                                 args.instruments):
        X, sr = audio.load(mix_path, sr=args.sr)
        y, _ = audio.load(inst_path, sr=args.sr)
        if X.ndim == 1:
            X = np.stack([X, X])
        if y.ndim == 1:
            y = np.stack([y, y])
        X, y = align_wave_head_and_tail(X, y, sr)
        v = X - y  # the vocal reference

        if args.postprocess:
            X_spec = stft_np(X, args.n_fft, args.hop_length)
            fn = sp.separate_tta if args.tta else sp.separate
            y_spec, v_spec = fn(X_spec)
            y_est = istft_np(y_spec, args.n_fft, args.hop_length,
                             X.shape[-1])
            v_est = istft_np(v_spec, args.n_fft, args.hop_length,
                             X.shape[-1])
        else:
            y_est, v_est = sp.separate_wave(X, tta=args.tta)

        row = {
            "song": mix_path,
            "instrumental_sdr": metrics.sdr(y, y_est),
            "instrumental_si_sdr": metrics.si_sdr(y, y_est),
            "instrumental_median_sdr": metrics.median_sdr(y, y_est, sr),
            "vocal_sdr": metrics.sdr(v, v_est),
            "vocal_si_sdr": metrics.si_sdr(v, v_est),
            "vocal_median_sdr": metrics.median_sdr(v, v_est, sr),
        }
        results.append(row)
        print(f"{mix_path}: inst SDR {row['instrumental_sdr']:.2f} dB, "
              f"vocal SDR {row['vocal_sdr']:.2f} dB")

    if results:
        agg = {k: float(np.mean([r[k] for r in results]))
               for k in results[0] if k != "song"}
        print("mean:", json.dumps(agg, indent=2))
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"songs": results, "mean": agg}, f, indent=2)


if __name__ == '__main__':
    main()
