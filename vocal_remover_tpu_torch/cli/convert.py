"""Checkpoint converter CLI.

    python -m vocal_remover_tpu_torch.cli.convert IN OUT [--n_fft ...]

Counterpart of vocal_remover_tpu/cli/convert.py: converts between the
reference's torch `.pth` state_dicts and the native `.vrt.npz`
checkpoints, in either direction (by the output's extension). A native
input keeps its embedded config; the model flags apply to a `.pth`
input (`--complex` for a complex-mask model). `--quantize int8` is
refused: int8 weights come with int8 serving (ROADMAP.md A13).
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
                   help='int8 weights: not ported to the GPU package yet '
                        '(ROADMAP.md A13)')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.quantize:
        raise SystemExit("--quantize int8 is not ported to the GPU package "
                         "yet: it comes with int8 serving (ROADMAP.md A13)")

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
                            convert.model_config(model))
        print(f'wrote native checkpoint {args.output}')
    elif args.output.endswith('.pth'):
        model = convert.load_model(args.input, args.n_fft, args.hop_length,
                                   args.nout, args.nout_lstm)
        convert.export_torch(args.output, model)
        print(f'wrote torch checkpoint {args.output}')
    else:
        raise SystemExit('output must end in .npz (native) or .pth (torch)')


if __name__ == '__main__':
    main()
