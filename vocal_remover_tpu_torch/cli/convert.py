"""Checkpoint converter CLI.

    python -m vocal_remover_tpu_torch.cli.convert IN OUT [--n_fft ...]

Counterpart of vocal_remover_tpu/cli/convert.py: converts between the
reference's torch `.pth` state_dicts and the native `.vrt.npz`
checkpoints, in either direction (by the output's extension). A native
input keeps its embedded config; the model flags apply to a `.pth`
input (`--complex` for a complex-mask model). `--quantize int8` writes
the kernels as per-channel symmetric int8 (the JAX package's `.q8` /
`.q8scale` arrays), which `load_native` dequantizes on load.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('input')
    p.add_argument('output')
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--nout', type=int, default=32)
    p.add_argument('--nout_lstm', type=int, default=128)
    p.add_argument('--complex', action='store_true', dest='is_complex')
    p.add_argument('--quantize', choices=['int8'], default=None,
                   help='store conv/dense kernels as per-channel '
                        'symmetric int8 (~4x smaller file; dequantized '
                        'transparently on load)')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    if args.output.endswith('.npz'):
        if args.input.endswith('.npz'):
            # a native input carries its model config; the flags apply
            # to torch inputs only
            model = convert.load_model(args.input, args.n_fft,
                                       args.hop_length, args.nout,
                                       args.nout_lstm)
        else:
            model = convert.load_checkpoint(args.input, CascadedNet(
                args.n_fft, args.hop_length, args.nout, args.nout_lstm,
                args.is_complex))
        convert.save_native(args.output, convert.to_jax_variables(model),
                            convert.model_config(model),
                            quantize=args.quantize)
        tag = f' ({args.quantize} weights)' if args.quantize else ''
        print(f'wrote native checkpoint {args.output}{tag}')
    elif args.output.endswith('.pth'):
        model = convert.load_model(args.input, args.n_fft, args.hop_length,
                                   args.nout, args.nout_lstm)
        convert.export_torch(args.output, model)
        print(f'wrote torch checkpoint {args.output}')
    else:
        raise SystemExit('output must end in .npz (native) or .pth (torch)')


if __name__ == '__main__':
    main()
