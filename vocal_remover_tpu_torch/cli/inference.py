"""Single-song separation CLI on the GPU port.

    python -m vocal_remover_tpu_torch.cli.inference -P ckpt.vrt.npz -i song.wav

Flag-compatible with vocal_remover_tpu/cli/inference.py for the
single-file device path: STFT -> CascadedNet masks -> iSTFT, PCM16 out,
song lengths padded to 30 s buckets (--exact_length turns that off).
Runs on card `--gpu` (default 0); `--gpu -1` runs on the CPU. Without a
card and without `--gpu -1` it raises rather than fall back to the CPU.
`--flat_conv` folds the BatchNorms and runs the enc2 / enc3 convs of
every band net as the flat pixel-packed CUDA kernel; `--precision`
takes `highest` (full float32), `default` (TF32 on the card) and
`bfloat16` (serving transform: folded BatchNorm, bf16 weights and
activations). `--lstm_impl` is accepted for compatibility: on the card
the BiLSTM recurrence always runs as the CUDA kernel. The other modes of
the JAX CLI are refused with a message naming the slice that ports them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "models",
)
DEFAULT_MODEL_PATH = os.path.join(MODEL_DIR, "baseline.vrt.npz")

# flag -> the later slice of the port that brings it
_LATER = {
    "input_dir": "directory mode (slice 2b, ROADMAP.md A8)",
    "stream": "segment streaming (slice 2b, ROADMAP.md A8)",
    "group": "cross-song patch batching (slice 2b, ROADMAP.md A8)",
    "postprocess": "the spectrogram path with merge_artifacts (a later "
                   "slice, ROADMAP.md A5)",
    "output_image": "the spectrogram path with images (a later slice, "
                    "ROADMAP.md A5)",
    "data_parallel": "multi-card inference (parallelism slice, ROADMAP.md "
                     "A10)",
    "profile": "tracing (a later slice)",
}


@contextlib.contextmanager
def _stage(label: str):
    """Timed progress line per pipeline stage."""
    t0 = time.perf_counter()
    yield
    print(f"  {label}: {time.perf_counter() - t0:.2f}s", flush=True)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--gpu', '-g', type=int, default=0,
                   help='CUDA card index; -1 runs on the CPU')
    p.add_argument('--pretrained_model', '-P', type=str,
                   default=DEFAULT_MODEL_PATH)
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument('--input', '-i')
    group.add_argument('--input_dir', type=str)
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--batchsize', '-B', type=int, default=4)
    p.add_argument('--cropsize', '-c', type=int, default=256)
    p.add_argument('--output_image', '-I', action='store_true')
    p.add_argument('--tta', '-t', action='store_true')
    p.add_argument('--postprocess', '-p', action='store_true')
    p.add_argument('--output_dir', '-o', type=str, default="")
    p.add_argument('--precision', type=str, default='highest',
                   choices=['highest', 'default', 'bfloat16', 'int8'],
                   help='highest = full float32, no TF32 (default); '
                        'default = float32 activations with TF32 '
                        'multiplies (the card has no bf16 multiply for '
                        'f32 tensors); bfloat16 = serving mode (folded '
                        'BatchNorm, bf16-resident weights and '
                        'activations, f32 accumulation); int8 is not '
                        'ported yet (ROADMAP.md A13)')
    p.add_argument('--lstm_impl', type=str, default='scan',
                   choices=['scan', 'pallas'],
                   help='accepted for compatibility and ignored: the card '
                        'always runs the CUDA recurrence kernel, the CPU '
                        'its plain version')
    p.add_argument('--flat_conv', action='store_true',
                   help='fold the BatchNorms and run the band nets\' '
                        'enc2..enc3 convs as the flat pixel-packed CUDA '
                        'kernel (nn/conv_pack.py, csrc/flat_conv.cu)')
    p.add_argument('--profile', type=str, default=None, metavar='DIR')
    p.add_argument('--stream', action='store_true')
    p.add_argument('--exact_length', action='store_true',
                   help='no 30 s length bucket (bit-faithful song tail)')
    p.add_argument('--group', type=int, default=None)
    p.add_argument('--data_parallel', type=int, default=1)
    return p


def _refuse_unported(parser, args):
    for flag, slice_name in _LATER.items():
        if getattr(args, flag) != parser.get_default(flag):
            raise SystemExit(f"--{flag} is not ported to the GPU package "
                             f"yet: it comes with {slice_name}")
    if args.precision == 'int8':
        raise SystemExit("--precision int8 is not ported to the GPU package "
                         "yet: it comes with int8 serving (ROADMAP.md A13)")
    if not args.pretrained_model.endswith('.npz'):
        raise SystemExit(f"{args.pretrained_model!r}: only .vrt.npz "
                         "checkpoints are ported yet (.pth and .vrtx "
                         "artifacts come with later slices)")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)

    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.utils import audio

    device = "cpu" if args.gpu < 0 else f"cuda:{args.gpu}"
    with _stage('load model'):
        model = convert.load_model(args.pretrained_model, args.n_fft,
                                   args.hop_length, 32, 128)
        if args.precision == 'bfloat16' or args.flat_conv:
            # serving transform: eval-BN folding, bf16-resident weights
            # for the bf16 mode, packed enc2/enc3 weights for --flat_conv;
            # 'highest' / 'default' keep float32 weights
            from vocal_remover_tpu_torch.models import serving

            model = serving.serving_variables(
                model, 'bfloat16' if args.precision == 'bfloat16' else None,
                flat=args.flat_conv)
        sp = Separator(model, batchsize=args.batchsize,
                       cropsize=args.cropsize, device=device,
                       precision=args.precision)

    with _stage('load audio'):
        X, sr = audio.load(args.input, sr=args.sr)
    if X.ndim == 1:
        X = np.asarray([X, X])  # mono to stereo
    basename = os.path.splitext(os.path.basename(args.input))[0]

    output_dir = args.output_dir
    if output_dir != "":
        output_dir = output_dir.rstrip('/') + '/'
        os.makedirs(output_dir, exist_ok=True)

    bucket = None if args.exact_length else 30 * sr
    with _stage('separate (device pipeline)'):
        y_wave, v_wave = sp.separate_wave(X, tta=args.tta, pcm16_io=True,
                                          bucket=bucket)
    audio.write_wav(f'{output_dir}{basename}_Instruments.wav',
                    y_wave.astype(np.float32) / 32768.0, sr)
    audio.write_wav(f'{output_dir}{basename}_Vocals.wav',
                    v_wave.astype(np.float32) / 32768.0, sr)


if __name__ == '__main__':
    main()
