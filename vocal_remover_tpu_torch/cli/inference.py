"""Separation CLI on the GPU port.

    python -m vocal_remover_tpu_torch.cli.inference -P ckpt.vrt.npz -i song.wav
    python -m vocal_remover_tpu_torch.cli.inference -P ckpt.vrt.npz --input_dir DIR

Flag-compatible with vocal_remover_tpu/cli/inference.py, with its
routing. `-i` takes, in this order:
  * segment streaming (constant device memory for any length), with
    --stream or above STREAM_ABOVE_SECONDS of audio, unless
    --output_image is given or the checkpoint is complex;
  * the device pipeline (STFT -> CascadedNet masks -> iSTFT, PCM16 out,
    song lengths padded to 30 s buckets; --exact_length turns that off),
    without --postprocess and --output_image;
  * otherwise the spectrogram path: host STFT, `Separator.separate` /
    `separate_tta` (masks on the device, `merge_artifacts` with
    --postprocess), host iSTFT of each stem, and with --output_image
    `<name>_Instruments.jpg` / `_Vocals.jpg` (`.png` without PIL).
`--input_dir` runs every audio file of a directory through the pipelined
service, songs padded to 30 s buckets and `--group` equal-length songs
batched into one patch stream, vocals as mixture - instruments.
Checkpoints: `.vrt.npz`, or a reference `.pth` state_dict; or a `.vrtx`
serving artifact (cli/export.py; `--cropsize` must be one of its widths,
the serving transform and the compute dtype are baked in, so
`--flat_conv` has no effect on it). Input: WAV,
FLAC, MP3 and AAC (.m4a / .mp4 / .aac) through the port's native
decoders. `--profile DIR` writes a torch.profiler Chrome trace (CPU and,
on a card, CUDA activity) of the separation into DIR.
Unset performance flags resolve per mode as in the JAX CLI: `-i` crop
256, batch 4, group 1, `highest`; `--input_dir` crop 1024, batch 24,
group 8, `bfloat16`.
Runs on card `--gpu` (default 0); `--gpu -1` runs on the CPU. Without a
card and without `--gpu -1` it raises rather than fall back to the CPU.
`--flat_conv` folds the BatchNorms and runs the enc2 / enc3 convs of
every band net as the flat pixel-packed CUDA kernel; `--precision`
takes `highest` (full float32), `default` (TF32 on the card) and
`bfloat16` (serving transform: folded BatchNorm, bf16 weights and
activations). `--lstm_impl` is accepted for compatibility: on the card
the BiLSTM recurrence always runs as the CUDA kernel. `--data_parallel`
and `--precision int8` are refused with a message naming the slice that
ports them.
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

# single songs longer than this are separated by segment streaming
STREAM_ABOVE_SECONDS = 20 * 60


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
    group.add_argument('--input_dir', type=str,
                       help='separate every audio file in a directory '
                            'through the pipelined serving path')
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--batchsize', '-B', type=int, default=None,
                   help='patches per model call (default 4; directory '
                        'mode 24)')
    p.add_argument('--cropsize', '-c', type=int, default=None,
                   help='patch width in frames (default 256; directory '
                        'mode 1024; streaming always 256)')
    p.add_argument('--output_image', '-I', action='store_true')
    p.add_argument('--tta', '-t', action='store_true')
    p.add_argument('--postprocess', '-p', action='store_true',
                   help='merge_artifacts on the mask')
    p.add_argument('--output_dir', '-o', type=str, default="")
    p.add_argument('--precision', type=str, default=None,
                   choices=['highest', 'default', 'bfloat16', 'int8'],
                   help='highest = full float32, no TF32 (single-file '
                        'default); default = float32 activations with '
                        'TF32 multiplies (the card has no bf16 multiply '
                        'for f32 tensors); bfloat16 = serving mode (folded '
                        'BatchNorm, bf16-resident weights and activations, '
                        'f32 accumulation; directory-mode default); int8 '
                        'is not ported yet (ROADMAP.md A13)')
    p.add_argument('--lstm_impl', type=str, default='scan',
                   choices=['scan', 'pallas'],
                   help='accepted for compatibility and ignored: the card '
                        'always runs the CUDA recurrence kernel, the CPU '
                        'its plain version')
    p.add_argument('--flat_conv', action='store_true',
                   help='fold the BatchNorms and run the band nets\' '
                        'enc2..enc3 convs as the flat pixel-packed CUDA '
                        'kernel (nn/conv_pack.py, csrc/flat_conv.cu)')
    p.add_argument('--profile', type=str, default=None, metavar='DIR',
                   help='write a torch.profiler Chrome trace of the '
                        'separation into DIR')
    p.add_argument('--stream', action='store_true',
                   help='segment-streamed separation: constant device '
                        'memory for any length (on by itself above '
                        f'{STREAM_ABOVE_SECONDS // 60} minutes of audio)')
    p.add_argument('--exact_length', action='store_true',
                   help='no 30 s length bucket (bit-faithful song tail)')
    p.add_argument('--group', type=int, default=None,
                   help='directory mode: stack N equal-length (bucketed) '
                        'songs into one merged patch stream (default 8; '
                        '1 turns it off); leftover partial groups run '
                        'per song')
    p.add_argument('--data_parallel', type=int, default=1)
    return p


def resolve_defaults(args):
    """Unset performance flags per mode, as the JAX CLI resolves them:
    single file crop 256, batch 4, group 1, `highest`; directory mode
    crop 1024, batch 24, group 8 (1 with --data_parallel != 1),
    `bfloat16`."""
    dir_mode = args.input_dir is not None
    if args.cropsize is None:
        args.cropsize = 1024 if dir_mode else 256
    if args.batchsize is None:
        args.batchsize = 24 if dir_mode else 4
    if args.group is None:
        args.group = 8 if (dir_mode and args.data_parallel == 1) else 1
    if args.precision is None:
        args.precision = 'bfloat16' if dir_mode else 'highest'


def _refuse_unported(args):
    if args.input_dir is not None and (args.postprocess or args.output_image):
        raise SystemExit("--input_dir uses the pure-device serving path; "
                         "--postprocess/--output_image require single-file "
                         "mode")
    if args.data_parallel != 1:
        raise SystemExit("--data_parallel is not ported to the GPU package "
                         "yet: it comes with multi-card inference "
                         "(parallelism slice, ROADMAP.md A10)")
    if args.precision == 'int8':
        raise SystemExit("--precision int8 is not ported to the GPU package "
                         "yet: it comes with int8 serving (ROADMAP.md A13)")


def _input_files(input_dir: str):
    """The directory's audio files as the JAX CLI picks them (lower-cased
    extension in INPUT_EXTS, sorted); exits when there is none."""
    from vocal_remover_tpu_torch.data.pairing import INPUT_EXTS

    files = sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if os.path.splitext(f)[1].lower() in INPUT_EXTS)
    if not files:
        raise SystemExit(f"no audio files in {input_dir!r}")
    return files


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """torch.profiler around the block, its Chrome trace written into
    `trace_dir`; a no-op for None. The block is one `separation` span.
    CPU activity is that of the calling thread (directory mode and
    streaming run the model on worker threads); on a card, CUDA
    activity covers every thread's kernels."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, record_function("separation"):
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, time.strftime("separation-%Y%m%d-%H%M%S")
                        + f"-{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"  profile: {path}", flush=True)


def _output_prefix(output_dir: str) -> str:
    if output_dir != "":
        output_dir = output_dir.rstrip('/') + '/'
        os.makedirs(output_dir, exist_ok=True)
    return output_dir


def _write_stems(prefix, y_wave, v_wave, sr):
    from vocal_remover_tpu_torch.utils import audio

    audio.write_wav(f'{prefix}_Instruments.wav',
                    y_wave.astype(np.float32) / 32768.0, sr)
    audio.write_wav(f'{prefix}_Vocals.wav',
                    v_wave.astype(np.float32) / 32768.0, sr)


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_defaults(args)
    _refuse_unported(args)
    files = _input_files(args.input_dir) if args.input_dir else None

    from vocal_remover_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.gpu < 0 else f"cuda:{args.gpu}")
    with _stage('load model'):
        if args.pretrained_model.endswith('.vrtx'):
            # AOT serving artifact: the weights and the serving transform
            # are baked into the exported programs (separate/artifact.py)
            from vocal_remover_tpu_torch.separate.artifact import (
                load_artifact,
            )

            model = load_artifact(args.pretrained_model, device)
            if args.cropsize not in model.cropsizes:
                raise SystemExit(
                    f"artifact carries cropsizes {model.cropsizes}; "
                    f"pass --cropsize one of those (got {args.cropsize})")
            model.program(args.cropsize)  # deserialized in this stage
        else:
            model = _load_checkpoint(args)
        model = model.to(device).eval()

    with _profiled(args.profile, device):
        if files is not None:
            _run_batch(args, model, device, files)
        else:
            _run_single(args, model, device)


def _load_checkpoint(args):
    """The CascadedNet of a `.vrt.npz` / `.pth`, serving-transformed for
    `bfloat16` and `--flat_conv`, on the CPU."""
    from vocal_remover_tpu_torch.models import convert

    model = convert.load_model(args.pretrained_model, args.n_fft,
                               args.hop_length, 32, 128)
    if args.precision == 'bfloat16' or args.flat_conv:
        # serving transform: eval-BN folding, bf16-resident weights for
        # the bf16 mode, packed enc2/enc3 weights for --flat_conv;
        # 'highest' / 'default' keep float32 weights
        from vocal_remover_tpu_torch.models import serving

        model = serving.serving_variables(
            model, 'bfloat16' if args.precision == 'bfloat16' else None,
            flat=args.flat_conv)
    return model


def _run_batch(args, model, device, files):
    """Directory mode: every song through the pipelined service. Songs
    are zero-padded to 30 s buckets, so equal buckets group; the stems
    are trimmed back on write."""
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.separate.service import SeparatorService
    from vocal_remover_tpu_torch.utils import audio

    output_dir = _output_prefix(args.output_dir)
    bucket = 30 * args.sr
    lengths = []

    def gen():
        for path in files:
            X, _ = audio.load(path, sr=args.sr)
            if X.ndim == 1:
                X = np.stack([X, X])
            n = X.shape[-1]
            lengths.append(n)
            yield np.pad(X, ((0, 0), (0, -(-n // bucket) * bucket - n)))

    sp = Separator(model, batchsize=args.batchsize, cropsize=args.cropsize,
                   device=device, precision=args.precision)
    svc = SeparatorService(sp, pcm16_io=True, tta=args.tta,
                           vocals_residual=True, group=args.group)
    with _stage(f'separate (directory, {len(files)} songs)'):
        for i, (y, v) in enumerate(svc.map(gen())):
            basename = os.path.splitext(os.path.basename(files[i]))[0]
            n = lengths[i]
            _write_stems(f'{output_dir}{basename}', y[:, :n], v[:, :n],
                         args.sr)
            print(basename, 'done', flush=True)


def _run_single(args, model, device):
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.utils import audio

    with _stage('load audio'):
        X, sr = audio.load(args.input, sr=args.sr)
    if X.ndim == 1:
        X = np.asarray([X, X])  # mono to stereo
    prefix = _output_prefix(args.output_dir) + \
        os.path.splitext(os.path.basename(args.input))[0]

    # the streamed path is magnitude-mask only and writes no images:
    # complex checkpoints and --output_image take the monolithic paths
    # whatever the length
    if ((args.stream or X.shape[-1] > STREAM_ABOVE_SECONDS * sr)
            and not args.output_image and not model.is_complex):
        from vocal_remover_tpu_torch.separate.streaming import (
            StreamingSeparator,
        )

        sp = StreamingSeparator(model, batchsize=args.batchsize,
                                pcm16_io=True, vocals_residual=True,
                                tta=args.tta, postprocess=args.postprocess,
                                device=device, precision=args.precision)
        with _stage('separate (streamed segments)'):
            y_wave, v_wave = sp.separate_wave(X)
        _write_stems(prefix, y_wave, v_wave, sr)
        return

    sp = Separator(model, batchsize=args.batchsize, cropsize=args.cropsize,
                   device=device, precision=args.precision,
                   postprocess=args.postprocess)
    if not args.postprocess and not args.output_image:
        bucket = None if args.exact_length else 30 * sr
        with _stage('separate (device pipeline)'):
            y_wave, v_wave = sp.separate_wave(X, tta=args.tta, pcm16_io=True,
                                              bucket=bucket)
        _write_stems(prefix, y_wave, v_wave, sr)
        return

    _run_spectrogram(args, sp, X, sr, prefix)


def _run_spectrogram(args, sp, X, sr, prefix):
    """The spectrogram path: host STFT, masks on the device, host iSTFT
    of each stem at its natural length, images with --output_image."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops
    from vocal_remover_tpu_torch.utils import audio, image, spec

    with _stage('stft'):
        X_spec = stft_ops.stft_np(X, args.n_fft, args.hop_length)
    with _stage('separate'):
        if args.tta:
            y_spec, v_spec = sp.separate_tta(X_spec)
        else:
            y_spec, v_spec = sp.separate(X_spec)
    for stem, s in (('Instruments', y_spec), ('Vocals', v_spec)):
        with _stage(f'istft + write {stem.lower()}'):
            audio.write_wav(f'{prefix}_{stem}.wav',
                            stft_ops.istft_np(s, args.n_fft, args.hop_length),
                            sr)
    if args.output_image:
        for stem, s in (('Instruments', y_spec), ('Vocals', v_spec)):
            image.imwrite(f'{prefix}_{stem}.jpg', spec.spectrogram_to_image(s))


if __name__ == '__main__':
    main()
