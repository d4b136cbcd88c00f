"""Training CLI on the GPU port.

    python -m vocal_remover_tpu_torch.cli.train --dataset DIR [--gpu -1]

Flag-compatible with vocal_remover_tpu/cli/train.py (reference
train.py:137-294): the dataset's `mixtures/` and `instruments/` pairs
are split, cached as spectrograms and cut into validation patches; the
model is CascadedNet(n_fft, hop_length, 32, 128), with `--is_complex` a
complex-mask one (re/im channel pairs; `--wave_loss` adds a wave-domain
SDR term through the device iSTFT); each epoch trains, validates, steps
the plateau scheduler, writes
`<output_dir>/model_iter{epoch}.vrt.npz` on a new best validation loss
and the full training state `<output_dir>/train_state.pt` (with its
`.meta.json`), which `--resume` continues; `--resume` also takes the JAX
package's `train_state.msgpack`. `loss_{time}.json`, `val_{time}.json`
and `train_{time}.log` go to the working directory, as in the JAX
package.

Runs on card `--gpu` (default 0); `--gpu -1` runs on the CPU. Without a
card and without `--gpu -1` it raises rather than fall back to the CPU.
Batches are staged in float32 under `--precision highest` and in
bfloat16 otherwise, or as `--transfer_dtype` says. `--precision
bfloat16` trains with bf16 activations and float32 parameters,
`--remat` recomputes the band nets in the backward pass, and
`--device_data_cache` keeps the dataset on the card (float32 under
float32 staging, else bf16). `--data_parallel N` trains on N ranks (0:
every rank of the world) as one card would: one process per card,
launched by torchrun,

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m vocal_remover_tpu_torch.cli.train ... --data_parallel N

each rank on cuda:LOCAL_RANK over NCCL (`--gpu -1`: the CPU over gloo),
drawing the same global batch and keeping its slice (parallel/). Rank 0
alone writes the log, the loss and validation lists, the checkpoints and
the caches (the other ranks wait for it). Songs are sharded and the
loader seeded by node (several hosts), as in the JAX CLI. Unlike the JAX
package's root `train.py`, which logs a failure and exits 0, a failed
run logs the traceback and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from datetime import datetime

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument('--gpu', '-g', type=int, default=0,
                   help='CUDA card index; -1 runs on the CPU')
    p.add_argument('--seed', '-s', type=int, default=2019)
    p.add_argument('--sr', '-r', type=int, default=44100)
    p.add_argument('--hop_length', '-H', type=int, default=1024)
    p.add_argument('--n_fft', '-f', type=int, default=2048)
    p.add_argument('--dataset', '-d', required=True)
    p.add_argument('--split_mode', '-S', type=str, default='random',
                   choices=['random', 'subdirs'])
    p.add_argument('--learning_rate', '-l', type=float, default=0.001)
    p.add_argument('--lr_min', type=float, default=0.0001)
    p.add_argument('--lr_decay_factor', type=float, default=0.9)
    p.add_argument('--lr_decay_patience', type=int, default=6)
    p.add_argument('--batchsize', '-B', type=int, default=4)
    p.add_argument('--accumulation_steps', '-A', type=int, default=1)
    p.add_argument('--cropsize', '-C', type=int, default=256)
    p.add_argument('--patches', '-p', type=int, default=16)
    p.add_argument('--val_rate', '-v', type=float, default=0.2)
    p.add_argument('--val_filelist', '-V', type=str, default=None)
    p.add_argument('--val_batchsize', '-b', type=int, default=4)
    p.add_argument('--val_cropsize', '-c', type=int, default=256)
    p.add_argument('--num_workers', '-w', type=int, default=4)
    p.add_argument('--epoch', '-E', type=int, default=200)
    p.add_argument('--reduction_rate', '-R', type=float, default=0.0)
    p.add_argument('--reduction_level', '-L', type=float, default=0.2)
    p.add_argument('--mixup_rate', '-M', type=float, default=0.0)
    p.add_argument('--mixup_alpha', '-a', type=float, default=1.0)
    p.add_argument('--mono_rate', type=float, default=0.0,
                   help='mono-mix augmentation probability (dormant in '
                        'the reference: lib/dataset.py:81-83)')
    p.add_argument('--pretrained_model', '-P', type=str, default=None)
    p.add_argument('--aux_lambda', type=float, default=0.0,
                   help='deep-supervision weight for the aux mask head '
                        '(0 = reference behaviour)')
    p.add_argument('--is_complex', action='store_true',
                   help='complex-mask training: re/im channel pairs, '
                        'tanh-bounded complex masks (the reference '
                        'sketches this dormant at nets.py:83-84, '
                        'train.py:85-86), end to end through Separator')
    p.add_argument('--wave_loss', type=str, default=None,
                   choices=['sdr', 'weighted_sdr'],
                   help='add a wave-domain SDR loss through the device '
                        'iSTFT (the reference defines these but leaves '
                        'them commented out, train.py:46-65, 83-88). '
                        'Requires --is_complex: magnitude batches carry '
                        'no phase to invert')
    p.add_argument('--wave_loss_weight', type=float, default=0.01,
                   help='weight of the wave-domain loss term (the '
                        "reference's commented-out factor, train.py:84)")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--data_parallel', type=int, default=1,
                   help='ranks in the data-parallel mesh (0 = every rank '
                        'of the world); launch one process per card with '
                        'torch.distributed.run')
    p.add_argument('--resume', type=str, default=None,
                   help='full train-state checkpoint to resume from: the '
                        "port's train_state.pt or the JAX package's "
                        'train_state.msgpack')
    p.add_argument('--precision', type=str, default='highest',
                   choices=['highest', 'default', 'bfloat16'],
                   help='highest = f32-faithful (parity with the '
                        'reference); default = TF32 multiplies, f32 '
                        'activations; bfloat16 = bf16 activations '
                        'end-to-end (mixed-precision training, float32 '
                        'parameters)')
    p.add_argument('--transfer_dtype', type=str, default=None,
                   choices=['float32', 'bfloat16', 'int8'],
                   help='dtype for host->card batch staging (bf16 '
                        'halves link traffic; int8 quarters it via '
                        'per-batch linear quantization — a throughput/'
                        'quality trade, magnitudes only; loss is '
                        'computed in f32 after an on-card dequant). '
                        'Default: float32 under --precision highest '
                        '(f32-faithful mode must not truncate inputs), '
                        'bfloat16 otherwise.')
    p.add_argument('--remat', action='store_true',
                   help='recompute band-net stages in the backward '
                        'pass (torch.utils.checkpoint): less activation '
                        'memory for an extra forward of the band nets; '
                        'use for batch/cropsize configs that run out of '
                        'memory')
    p.add_argument('--device_data_cache', action='store_true',
                   help='keep the whole dataset resident in card memory '
                        '(bf16 magnitudes, float32 under float32 '
                        'staging) and make crops + augmentation on the '
                        'card: a few bytes host->card per step instead '
                        'of megabytes. Needs the dataset to fit on the '
                        'card; magnitude path only (no --is_complex / '
                        'mixup / mono).')
    p.add_argument('--output_dir', type=str, default='models')
    return p


def reduction_weight_ramp(n_fft: int, sr: int, reduction_level: float):
    """Frequency ramp for the vocal-reduction augmentation (reference
    train.py:197-205): 0->1 below 200 Hz, 1->0 up to 22050 Hz, 0 above,
    scaled by reduction_level, clamped to the spectrum (the reference
    crashes below 44.1 kHz). Shape (bins, 1)."""
    bins = n_fft // 2 + 1
    freq_to_bin = 2 * bins / sr
    unstable_bins = min(int(200 * freq_to_bin), bins)
    stable_bins = min(int(22050 * freq_to_bin), bins)
    arr = np.concatenate([
        np.linspace(0, 1, unstable_bins, dtype=np.float32)[:, None],
        np.linspace(1, 0, stable_bins - unstable_bins,
                    dtype=np.float32)[:, None],
        np.zeros((bins - stable_bins, 1), dtype=np.float32),
    ])
    return arr * reduction_level


def main(argv=None):
    args = build_parser().parse_args(argv)
    timestamp = datetime.now().strftime('%Y%m%d%H%M%S')

    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.parallel import distributed
    from vocal_remover_tpu_torch.parallel import mesh as mesh_lib
    from vocal_remover_tpu_torch.train.logging import setup_logger

    device = distributed.rank_device(args.gpu)
    with mesh_lib.data_parallel_mesh(args.data_parallel, device) as mesh:
        logger = setup_logger(__name__, f'train_{timestamp}.log'
                              if distributed.is_writer() else None)
        try:
            # the precision mode is process-wide: restored on the way out
            with config.precision(args.precision):
                _run(args, timestamp, logger, device, mesh)
        except BaseException:
            logger.exception('training failed')
            raise
        finally:
            for h in list(logger.handlers):
                logger.removeHandler(h)
                h.close()


def _run(args, timestamp, logger, device, mesh):
    import torch

    from vocal_remover_tpu_torch.data import cache, dataset, pairing
    from vocal_remover_tpu_torch.data.device_cache import (
        DeviceLoader,
        DeviceTrainingSource,
        DeviceValidationSource,
    )
    from vocal_remover_tpu_torch.data.loader import Loader
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.parallel import distributed
    from vocal_remover_tpu_torch.train import checkpoint
    from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
    from vocal_remover_tpu_torch.train.step import Trainer

    logger.debug(vars(args))
    writer = distributed.is_writer()
    if mesh is not None:
        logger.info('data-parallel mesh: {}'.format(
            dict(zip(mesh.mesh_dim_names, mesh.shape))))

    random.seed(args.seed)
    np.random.seed(args.seed)

    val_filelist = []
    if args.val_filelist is not None:
        with open(args.val_filelist, encoding='utf8') as f:
            val_filelist = json.load(f)

    train_filelist, val_filelist = pairing.train_val_split(
        dataset_dir=args.dataset,
        split_mode=args.split_mode,
        val_rate=args.val_rate,
        val_filelist=val_filelist,
    )

    if args.debug:
        logger.info('### DEBUG MODE')
        train_filelist = train_filelist[:1]
        val_filelist = val_filelist[:1]
    elif args.val_filelist is None and args.split_mode == 'random' \
            and writer:
        with open(f'val_{timestamp}.json', 'w', encoding='utf8') as f:
            json.dump(val_filelist, f, ensure_ascii=False)

    for i, (X_fname, y_fname) in enumerate(val_filelist):
        logger.info('{} {} {}'.format(
            i + 1, os.path.basename(X_fname), os.path.basename(y_fname)))

    reduction_weight = reduction_weight_ramp(
        args.n_fft, args.sr, args.reduction_level)

    # several hosts: each node caches and augments a disjoint stride of
    # the songs (decorrelated crops via host_seed); the global batch is
    # still sharded over the mesh every step
    _, n_hosts = distributed.process_info()
    if n_hosts > 1:
        train_filelist = distributed.shard_filelist(train_filelist)
        logger.info(f'host shard: {len(train_filelist)} songs on this host')
    if args.device_data_cache and n_hosts > 1:
        raise SystemExit(
            '--device_data_cache is single-host only; multi-host runs use '
            'the host data path')
    loader_seed = (distributed.host_seed(args.seed) if n_hosts > 1
                   else args.seed)

    model = CascadedNet(args.n_fft, args.hop_length, 32, 128,
                        is_complex=args.is_complex,
                        generator=torch.Generator().manual_seed(args.seed))
    if args.pretrained_model is not None:
        convert.load_checkpoint(args.pretrained_model, model)

    # rank 0 writes the spectrogram and validation patch caches; the
    # other ranks wait for it, then read them
    if not writer:
        distributed.barrier()
    training_set = cache.make_training_set(
        filelist=train_filelist,
        sr=args.sr,
        hop_length=args.hop_length,
        n_fft=args.n_fft,
    )
    patch_list = dataset.make_validation_set(
        filelist=val_filelist,
        cropsize=args.val_cropsize,
        sr=args.sr,
        hop_length=args.hop_length,
        n_fft=args.n_fft,
        offset=model.offset,
    )
    if writer:
        distributed.barrier()

    transfer_dtype = args.transfer_dtype
    if transfer_dtype is None:
        transfer_dtype = (
            'float32' if args.precision == 'highest' else 'bfloat16')
    logger.info(f'device: {device}, batch staging dtype: {transfer_dtype}')

    trainer = Trainer(
        model,
        learning_rate=args.learning_rate,
        accumulation_steps=args.accumulation_steps,
        seed=args.seed,
        transfer_dtype=('int8' if transfer_dtype == 'int8'
                        else torch.bfloat16 if transfer_dtype == 'bfloat16'
                        else None),
        aux_lambda=args.aux_lambda,
        remat=args.remat,
        wave_loss=args.wave_loss,
        wave_loss_weight=args.wave_loss_weight,
        device=device,
        mesh=mesh,
    )
    scheduler = ReduceLROnPlateau(
        lr=args.learning_rate,
        factor=args.lr_decay_factor,
        patience=args.lr_decay_patience,
        threshold=1e-6,
        min_lr=args.lr_min,
    )

    # resident dtype: float32 under float32 staging, bf16 otherwise
    resident = torch.float32 if transfer_dtype == 'float32' else torch.bfloat16
    device_source = None
    if args.device_data_cache:
        device_source = DeviceTrainingSource(
            training_set * args.patches,
            cropsize=args.cropsize,
            reduction_rate=args.reduction_rate,
            reduction_weight=reduction_weight,
            mixup_rate=args.mixup_rate,
            mono_rate=args.mono_rate,
            is_complex=args.is_complex,
            seed=args.seed,
            dtype=resident,
            device=device,
            mesh=mesh,
        )
        train_loader = DeviceLoader(
            device_source,
            batchsize=args.batchsize,
            shuffle=True,
            seed=loader_seed,
        )
        logger.info('device-resident dataset: {} songs, {:.1f} MB HBM'.format(
            len(training_set), device_source.nbytes / 1e6))
    else:
        train_dataset = dataset.TrainingSet(
            training_set * args.patches,
            cropsize=args.cropsize,
            reduction_rate=args.reduction_rate,
            reduction_weight=reduction_weight,
            mixup_rate=args.mixup_rate,
            mixup_alpha=args.mixup_alpha,
            seed=args.seed,
            is_complex=args.is_complex,
            mono_rate=args.mono_rate,
        )
        train_loader = Loader(
            train_dataset,
            batchsize=args.batchsize,
            shuffle=True,
            num_workers=args.num_workers,
            seed=loader_seed,
        )

    val_source = val_loader = None
    if device_source is not None:
        val_source = DeviceValidationSource(
            patch_list, is_complex=args.is_complex, dtype=resident,
            device=device, mesh=mesh)
        logger.info('device-resident validation: {} patches, {:.1f} MB HBM'
                    .format(len(val_source), val_source.nbytes / 1e6))
    else:
        val_loader = Loader(
            dataset.ValidationSet(patch_list=patch_list,
                                  is_complex=args.is_complex),
            batchsize=args.val_batchsize,
            shuffle=False,
            num_workers=args.num_workers,
        )

    start_epoch = 0
    best_loss = np.inf
    if args.resume is not None:
        start_epoch, best_loss = checkpoint.load_train_state(
            args.resume, trainer, scheduler)
        start_epoch += 1
        # continue the crop / augmentation stream an uninterrupted run
        # would have produced (shuffle and per-item draws are functions
        # of (seed, epoch))
        train_loader.set_epoch(start_epoch)
        logger.info(f'resumed from {args.resume} at epoch {start_epoch}')

    if writer:
        os.makedirs(args.output_dir, exist_ok=True)
    log = []
    for epoch in range(start_epoch, args.epoch):
        logger.info('# epoch {}'.format(epoch))
        if device_source is not None:
            train_loss = trainer.train_epoch_device(device_source,
                                                    train_loader)
            val_loss = trainer.validate_epoch_device(val_source,
                                                     args.val_batchsize)
        else:
            train_loss = trainer.train_epoch(train_loader)
            val_loss = trainer.validate_epoch(val_loader)

        logger.info(
            '  * training loss = {:.6f}, validation loss = {:.6f}'
            .format(train_loss, val_loss))

        trainer.set_learning_rate(scheduler.step(val_loss))

        if val_loss < best_loss:
            best_loss = val_loss
            logger.info('  * best validation loss')
            checkpoint.save_model(
                os.path.join(args.output_dir, f'model_iter{epoch}.vrt.npz'),
                trainer.model)

        checkpoint.save_train_state(
            os.path.join(args.output_dir, checkpoint.STATE_NAME),
            trainer, scheduler, epoch, best_loss)

        log.append([train_loss, val_loss])
        if writer:
            with open(f'loss_{timestamp}.json', 'w', encoding='utf8') as f:
                json.dump(log, f, ensure_ascii=False)


if __name__ == '__main__':
    main()
