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
decoders. Each stage prints its time; `load model` adds its parts, the
spans (utils/trace.py) `load.read`, `load.serving_transform` and
`load.to_device`, recorded for that stage alone.
`--profile DIR` writes a torch.profiler Chrome trace of the separation
into DIR: the CPU ops of every thread (the directory service and
streaming run the model on threads of their own), the port's spans as
ranges among them, and on a card the CUDA activity.
Unset performance flags resolve per mode as in the JAX CLI: `-i` crop
256, batch 4, group 1, `highest`; `--input_dir` crop 1024, batch 24,
group 8, `bfloat16`.
Runs on card `--gpu` (default 0); `--gpu -1` runs on the CPU. Without a
card and without `--gpu -1` it raises rather than fall back to the CPU.
`--flat_conv` folds the BatchNorms and runs the enc2 / enc3 convs of
every band net as the flat pixel-packed CUDA kernel; `--precision`
takes `highest` (full float32), `default` (TF32 on the card),
`bfloat16` (serving transform: folded BatchNorm, bf16 weights and
activations) and `int8` (the bfloat16 mode with the conv stack's weights
quantized to per-channel int8 and activations quantized per conv call:
the int8 conv kernel, csrc/conv_int8.cu; not with `--flat_conv`, as in
the JAX CLI; a `.vrtx` artifact runs in its own precision). `--lstm_impl`
is accepted for compatibility: on the card the BiLSTM recurrence always
runs as the CUDA kernel.
`--data_parallel N` shards the patches of each song over N ranks (0: all
of the world's; sequence parallelism, as in the JAX CLI; --group is then
1), one process per card, launched by torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m vocal_remover_tpu_torch.cli.inference ... --data_parallel N

Rank r runs on cuda:LOCAL_RANK over NCCL; with `--gpu -1` every rank
runs on the CPU over gloo. Rank 0 alone writes the stems and prints.
Without a launcher the world is this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

from vocal_remover_tpu_torch.utils import trace

MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "models",
)
DEFAULT_MODEL_PATH = os.path.join(MODEL_DIR, "baseline.vrt.npz")

# single songs longer than this are separated by segment streaming
STREAM_ABOVE_SECONDS = 20 * 60


@contextlib.contextmanager
def _stage(label: str, rec=None):
    """Timed progress line per pipeline stage (rank 0 prints); with a
    `trace.recording()` Recorder `rec`, its spans' seconds by name
    follow."""
    from vocal_remover_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    yield
    if distributed.is_writer():
        took = time.perf_counter() - t0
        said = ", ".join(f"{k} {v:.2f}s" for k, v in
                         (rec.totals() if rec else {}).items())
        print(f"  {label}: {took:.2f}s" + (f" ({said})" if said else ""),
              flush=True)


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
                        'f32 accumulation; directory-mode default); int8 = '
                        'bfloat16 with per-channel int8 conv weights and '
                        'per-call int8 activations (int32 accumulation)')
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
    p.add_argument('--data_parallel', type=int, default=1,
                   help='shard the patch axis of each song over N ranks '
                        '(0 = every rank of the world; sequence '
                        'parallelism: patches are halo-free); launch one '
                        'process per card with torch.distributed.run')
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
    if args.input_dir is not None and args.group > 1 \
            and args.data_parallel != 1:
        raise SystemExit(
            "--group batches songs on one chip; combine with "
            "--data_parallel is not supported (pick one axis)")


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
    `trace_dir`; a no-op for None. The block is one `separation` range,
    recording the port's spans (`trace.recording`): the CPU ops and
    spans of every thread, and on a card every thread's CUDA activity."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import record_function

    with trace.profiler(device.type == "cuda") as prof, \
            trace.recording(), record_function("separation"):
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, time.strftime("separation-%Y%m%d-%H%M%S")
                        + f"-{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"  profile: {path}", flush=True)


def _output_prefix(output_dir: str) -> str:
    from vocal_remover_tpu_torch.parallel import distributed

    if output_dir != "":
        output_dir = output_dir.rstrip('/') + '/'
        if distributed.is_writer():
            os.makedirs(output_dir, exist_ok=True)
    return output_dir


def _write_stems(prefix, y_wave, v_wave, sr):
    """Writes the two stems (rank 0 alone under a mesh)."""
    from vocal_remover_tpu_torch.parallel import distributed
    from vocal_remover_tpu_torch.utils import audio

    if not distributed.is_writer():
        return
    audio.write_wav(f'{prefix}_Instruments.wav',
                    y_wave.astype(np.float32) / 32768.0, sr)
    audio.write_wav(f'{prefix}_Vocals.wav',
                    v_wave.astype(np.float32) / 32768.0, sr)


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_defaults(args)
    _refuse_unported(args)
    files = _input_files(args.input_dir) if args.input_dir else None

    from vocal_remover_tpu_torch.parallel import distributed, mesh

    device = distributed.rank_device(args.gpu)
    with mesh.data_parallel_mesh(args.data_parallel, device) as m:
        _main(args, files, device, m)


def _main(args, files, device, mesh):
    from vocal_remover_tpu_torch.parallel import distributed

    with trace.recording() as rec, _stage('load model', rec):
        if args.pretrained_model.endswith('.vrtx'):
            # AOT serving artifact: the weights and the serving transform
            # are baked into the exported programs (separate/artifact.py)
            from vocal_remover_tpu_torch.separate.artifact import (
                load_artifact,
            )

            with trace.span('load.read'):
                model = load_artifact(args.pretrained_model, device)
                if args.cropsize not in model.cropsizes:
                    raise SystemExit(
                        f"artifact carries cropsizes {model.cropsizes}; "
                        f"pass --cropsize one of those (got "
                        f"{args.cropsize})")
                model.program(args.cropsize)  # deserialized in this stage
        else:
            model = _load_checkpoint(args)
        with trace.span('load.to_device'):
            model = model.to(device).eval()

    trace_dir = args.profile if distributed.is_writer() else None
    with _profiled(trace_dir, device):
        if files is not None:
            _run_batch(args, model, device, files, mesh)
        else:
            _run_single(args, model, device, mesh)


def _load_checkpoint(args):
    """The CascadedNet of a `.vrt.npz` / `.pth`, serving-transformed for
    `bfloat16`, `int8` and `--flat_conv`, on the CPU."""
    from vocal_remover_tpu_torch.models import convert

    with trace.span('load.read'):
        model = convert.load_model(args.pretrained_model, args.n_fft,
                                   args.hop_length, 32, 128)
    if args.precision in ('bfloat16', 'int8') or args.flat_conv:
        # serving transform: eval-BN folding, bf16-resident weights for
        # the bf16 mode, int8 conv weights (dynamic activation scales, as
        # the JAX CLI) for int8, packed enc2/enc3 weights for --flat_conv;
        # 'highest' / 'default' keep float32 weights
        from vocal_remover_tpu_torch.models import serving

        with trace.span('load.serving_transform'):
            model = serving.serving_variables(
                model, args.precision
                if args.precision in ('bfloat16', 'int8') else None,
                flat=args.flat_conv)
    return model


def compute_precision(args) -> str:
    """The mode the model runs in: int8 is a weight transform that runs
    under `bfloat16` (the JAX CLI sets that compute mode for it)."""
    return 'bfloat16' if args.precision == 'int8' else args.precision


def _run_batch(args, model, device, files, mesh):
    """Directory mode: every song through the pipelined service. Songs
    are zero-padded to 30 s buckets, so equal buckets group; the stems
    are trimmed back on write."""
    from vocal_remover_tpu_torch.parallel import distributed
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
                   device=device, precision=compute_precision(args),
                   mesh=mesh)
    svc = SeparatorService(sp, pcm16_io=True, tta=args.tta,
                           vocals_residual=True, group=args.group)
    with _stage(f'separate (directory, {len(files)} songs)'):
        for i, (y, v) in enumerate(svc.map(gen())):
            basename = os.path.splitext(os.path.basename(files[i]))[0]
            n = lengths[i]
            _write_stems(f'{output_dir}{basename}', y[:, :n], v[:, :n],
                         args.sr)
            if distributed.is_writer():
                print(basename, 'done', flush=True)


def _run_single(args, model, device, mesh):
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
                                device=device,
                                precision=compute_precision(args))
        with _stage('separate (streamed segments)'):
            y_wave, v_wave = sp.separate_wave(X)
        _write_stems(prefix, y_wave, v_wave, sr)
        return

    sp = Separator(model, batchsize=args.batchsize, cropsize=args.cropsize,
                   device=device, precision=compute_precision(args),
                   postprocess=args.postprocess, mesh=mesh)
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
    of each stem at its natural length, images with --output_image
    (unsharded, as in the JAX CLI: under a mesh every rank runs it and
    rank 0 writes)."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops
    from vocal_remover_tpu_torch.parallel import distributed
    from vocal_remover_tpu_torch.utils import audio, image, spec

    with _stage('stft'):
        X_spec = stft_ops.stft_np(X, args.n_fft, args.hop_length)
    with _stage('separate'):
        if args.tta:
            y_spec, v_spec = sp.separate_tta(X_spec)
        else:
            y_spec, v_spec = sp.separate(X_spec)
    if not distributed.is_writer():
        return
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
