"""Export a checkpoint as a self-contained AOT serving artifact.

    python -m vocal_remover_tpu_torch.cli.export model.vrt.npz model.vrtx

Counterpart of vocal_remover_tpu/cli/export.py. The output `.vrtx` holds
the `torch.export` program of the patch->mask call (weights baked in
after the serving transform, batch symbolic, one entry per crop width)
and the pipeline geometry; see `separate/artifact.py`. The input is a
native `.vrt.npz` (its embedded config wins over the flags) or a
reference `.pth` state_dict. The trace runs on card `--gpu` (default 0);
`--gpu -1` traces on the CPU; without a card and without `--gpu -1` it
raises. Either way the file serves on both (`inference -P model.vrtx`).
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="export an AOT serving artifact (.vrtx)")
    p.add_argument('input', help='checkpoint (.vrt.npz or torch .pth)')
    p.add_argument('output', help='artifact path (.vrtx)')
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--nout', type=int, default=32)
    p.add_argument('--nout_lstm', type=int, default=128)
    p.add_argument('--precision', default='bfloat16',
                   choices=['highest', 'default', 'bfloat16'],
                   help='numerics baked into the exported computation '
                        '(bfloat16 = the standard serving mode: folded '
                        'BatchNorm, bf16 weights and activations)')
    p.add_argument('--no_serving_transform', action='store_true',
                   help='skip eval-BN folding and the weight cast (export '
                        'the unfolded eval numerics)')
    p.add_argument('--gpu', '-g', type=int, default=0,
                   help='CUDA card index to trace on; -1 traces on the CPU')
    p.add_argument('--cropsizes', default='256,1024',
                   help='comma-separated crop widths to export (one entry '
                        'each; the batch is symbolic within an entry). The '
                        'default covers the reference width and the '
                        'wide-crop serving width')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vocal_remover_tpu_torch import resolve_device
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.separate.artifact import export_artifact

    device = resolve_device("cpu" if args.gpu < 0 else f"cuda:{args.gpu}")
    model = convert.load_model(args.input, args.n_fft, args.hop_length,
                               args.nout, args.nout_lstm)
    dtype = 'bfloat16' if args.precision == 'bfloat16' else None
    meta = export_artifact(
        model, args.output, device=device,
        serving_transform=not args.no_serving_transform,
        dtype=None if args.no_serving_transform else dtype,
        cropsizes=[int(s) for s in args.cropsizes.split(',') if s],
        precision=args.precision,
    )
    print(
        f"wrote {args.output} ({os.path.getsize(args.output)} bytes): "
        f"{meta['model_config']['arch']} "
        f"n_fft={meta['model_config']['n_fft']} "
        f"device={device} crops={meta['cropsizes']}"
    )


if __name__ == '__main__':
    main()
