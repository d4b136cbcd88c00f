"""Training and validation steps.

Counterpart of vocal_remover_tpu/train/step.py `Trainer` (reference
train.py:68-134 `train_epoch` / `validate_epoch`): L1 mask loss, Adam,
gradient accumulation with a leftover flush, per-sample loss averaging,
validation on the offset-trimmed masked spectrogram.

  * The model trains in place (`model.train()`): batch norm on batch
    statistics with the running update on every microbatch, the
    Decoders' lerp upsample, and the BiLSTM's recurrence as the plain
    loop under autograd (the recurrence kernel has no backward, as the
    JAX package's Pallas recurrence has none). Validation runs the model
    in eval, so on the card its BiLSTMs run the recurrence kernel.
  * Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`, which
    computes what `optax.adam` computes. Parameters stay float32 (or
    float64) in every precision mode: under `--precision bfloat16` the
    convolutions cast them per call, so the gradients come back in the
    parameters' dtype.
  * With `accumulation_steps` A > 1 each microbatch adds grad / A, Adam
    steps every A microbatches, and a leftover is flushed at the end of
    the epoch; A == 1 is the plain step.
  * Losses are summed on the device: one host read per epoch.
  * Dropout draws from a generator seeded by (seed, step counter), as
    JAX folds the step counter into its key, so a resumed run draws the
    same masks as an uninterrupted one; `dropout=False` turns it off.
  * `remat` recomputes the five band nets in the backward pass
    (`CascadedNet.forward(remat=True)`): less activation memory held for
    the backward, for one more forward of the band nets; the same
    gradients and statistics.
  * Batches are staged host -> device by a background thread
    (`prefetch` batches ahead; 0: no thread), from
    pinned memory on a side stream, in `transfer_dtype` (None: as the
    loader gives them; "int8": `quantize_u8` on the host, a uint8 tensor
    and a float32 scale, magnitudes only), and cast up to float32 (or
    wider) on the device.
  * `train_epoch_device` / `validate_epoch_device` take a device-resident
    dataset (data/device_cache.py): a step uploads its crop starts and
    augmentation flags only.
  * With a `mesh` (parallel/mesh.py; JAX `Trainer(mesh=)`) each rank
    trains on its slice of the global batch and the math is the single
    device's: batch norm takes the global batch's statistics, dropout
    the global batch's mask, the gradients are averaged over the data
    axis before Adam (one flat all-reduce), and the epoch losses are the
    global per-sample means on every rank. A model axis of 2 or more
    ranks shards the convs' output channels (parallel/policy.py).
    Training batches must divide by the data axis, as JAX's sharding
    requires; a validation batch that does not runs whole on every rank.

  * A complex-mask model (`is_complex`) takes (N, 4, F, T) batches, the
    real parts of both channels then the imaginary parts, and its
    objective is L1 on the magnitudes of mask (*) X (complex product)
    against |y|; `wave_loss` ('sdr' | 'weighted_sdr', complex models
    only) adds `wave_loss_weight` times an SDR loss between the iSTFTs
    of y and mask (*) X (losses.py), the gradient flowing through the
    device iSTFT.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from vocal_remover_tpu_torch import native, resolve_device
from vocal_remover_tpu_torch.parallel import mesh as mesh_lib
from vocal_remover_tpu_torch.parallel import policy
from vocal_remover_tpu_torch.train import losses
from vocal_remover_tpu_torch.train.prefetch import device_prefetch


def quantize_u8(a):
    """float32 magnitudes -> (uint8 array, float32 scale) with 255 at
    the batch's largest value; the device computes q * scale. The native
    quantizer (native `quantize_u8`), as the JAX package's
    `Trainer._quantize_u8` runs it where its extension is built."""
    out = native.quantize_u8(a)
    return out["q"], out["scale"]


def _complex_product(mask, X):
    """mask (*) X on re/im channel stacks ([:, :2] real, [:, 2:]
    imaginary) -> (real, imaginary)."""
    mr, mi = mask[:, :2], mask[:, 2:]
    xr, xi = X[:, :2], X[:, 2:]
    return mr * xr - mi * xi, mr * xi + mi * xr


def _complex_magnitudes(mask, X, y):
    """(|mask (*) X|, |y|) of re/im channel stacks, 1e-12 under each
    root as in the JAX package."""
    pr, pi = _complex_product(mask, X)
    return (torch.sqrt(pr * pr + pi * pi + 1e-12),
            torch.sqrt(y[:, :2] ** 2 + y[:, 2:] ** 2 + 1e-12))


class Trainer:
    def __init__(self, model, learning_rate, accumulation_steps=1, seed=0,
                 dropout=True, transfer_dtype=None, aux_lambda=0.0,
                 remat=False, wave_loss=None, wave_loss_weight=0.01,
                 device=None, mesh=None, prefetch=2):
        """Trains `model` (a CascadedNet) in place, on `device` (None:
        the card; "cpu" when asked). A model with the serving transforms
        applied (models/serving.py: folded BatchNorm, bf16 weights,
        packed encoders) is refused: it is for inference only.
        `transfer_dtype` is None, a torch dtype, or "int8". `mesh`: a
        (data, model) DeviceMesh (parallel/mesh.make_mesh) whose device
        type is `device`'s; every rank passes the same model. `prefetch`:
        batches staged ahead by the staging thread (0: no thread, each
        batch staged when the step asks for it); the batches and losses
        do not depend on it."""
        if getattr(model, "serving_transformed", False):
            raise ValueError(
                "this model has the serving transforms applied (folded "
                "BatchNorm, cast or packed weights: models/serving.py); "
                "train the model as loaded, before serving_variables")
        if wave_loss not in (None, "sdr", "weighted_sdr"):
            raise ValueError(f"unknown wave_loss {wave_loss!r}")
        if wave_loss is not None and not model.is_complex:
            raise ValueError(
                "wave_loss requires a complex-mask model (is_complex): "
                "magnitude batches have no phase to invert to waves")
        if transfer_dtype == "int8" and model.is_complex:
            raise ValueError(
                "int8 staging quantizes nonnegative magnitudes; "
                "complex-mode batches carry signed re/im channels")
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps {accumulation_steps} < 1")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is on {mesh.device_type} ranks but the "
                    f"trainer on {self.device}")
            policy.shard_variables(mesh, self.model)
            mesh_lib.replicate(mesh, self.model)
            self._data_group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
            self._n_data = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        self.accumulation_steps = int(accumulation_steps)
        self.seed = int(seed)
        self.dropout = dropout
        self.transfer_dtype = transfer_dtype
        self.prefetch = int(prefetch)
        self.aux_lambda = float(aux_lambda)
        self.remat = bool(remat)
        self.wave_loss = wave_loss
        self.wave_loss_weight = float(wave_loss_weight)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8)
        self.optimizer.zero_grad(set_to_none=True)
        self._step_counter = 0
        # host seconds the last epoch's steps waited for their batch
        self.loader_wait_s = 0.0
        self._upload = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    # one step's pieces
    # ------------------------------------------------------------------

    def _generator(self):
        """The dropout generator of the current step (None without
        dropout): seeded by (seed, step counter)."""
        if not self.dropout:
            return None
        state = np.random.SeedSequence(
            [0xD509, self.seed % 2**32, self._step_counter])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
        return g

    @staticmethod
    def _upcast(a):
        """Staged batches up to float32 before the loss: bf16 is cast, an
        int8-staged (q, scale) pair is dequantized as q * scale (JAX
        `_upcast`); float64 (the parity tests) stays."""
        if isinstance(a, tuple):
            q, scale = a
            return q.to(torch.float32) * scale
        return a.to(torch.promote_types(a.dtype, torch.float32))

    def _mask_loss(self, mask, X, y):
        if not self.model.is_complex:
            return losses.mask_l1_loss(mask, X, y)
        return losses.l1(*_complex_magnitudes(mask, X, y))

    def _wave_loss_term(self, mask, X, y):
        """The SDR loss between the iSTFTs of y and mask (*) X (with
        'weighted_sdr' also of the noises X - y and X - mask (*) X)."""
        pr, pi = _complex_product(mask, X)
        n_fft, hop = self.model.n_fft, self.model.hop_length
        y_wave = losses.to_wave(y[:, :2], y[:, 2:], n_fft, hop)
        p_wave = losses.to_wave(pr, pi, n_fft, hop)
        if self.wave_loss == "weighted_sdr":
            xr, xi = X[:, :2], X[:, 2:]
            n_wave = losses.to_wave(xr - y[:, :2], xi - y[:, 2:], n_fft, hop)
            n_pred = losses.to_wave(xr - pr, xi - pi, n_fft, hop)
            return losses.weighted_sdr_loss(y_wave, p_wave, n_wave, n_pred)
        return losses.sdr_loss(y_wave, p_wave)

    def _loss(self, X, y, generator):
        X, y = self._upcast(X), self._upcast(y)
        if self.aux_lambda > 0:
            mask, aux_mask = self.model(X, aux=True, generator=generator,
                                        remat=self.remat)
            loss = (self._mask_loss(mask, X, y) + self.aux_lambda
                    * self._mask_loss(aux_mask, X, y))
        else:
            mask = self.model(X, generator=generator, remat=self.remat)
            loss = self._mask_loss(mask, X, y)
        if self.wave_loss is not None:
            loss = loss + self.wave_loss_weight * self._wave_loss_term(
                mask, X, y)
        return loss

    def _rows(self, a, whole_ok=False):
        """This rank's rows of a global batch (all of it without a
        mesh; see mesh.local_rows for `whole_ok`)."""
        if self.mesh is None:
            return a
        return mesh_lib.local_rows(self.mesh, a, whole_ok)

    def _put(self, a, whole_ok=False):
        """This rank's rows of one host array to the device in the
        staging dtype; int8 gives the (uint8 tensor, float32 scale) pair,
        the scale that of the global batch, as in JAX."""
        if self.transfer_dtype == "int8":
            q, scale = quantize_u8(a)
            # the native result is read-only: torch takes a writable copy
            q = np.require(self._rows(q, whole_ok), requirements="W")
            return self._to_device(torch.from_numpy(q)), float(scale)
        t = torch.from_numpy(np.ascontiguousarray(self._rows(a, whole_ok)))
        if self.transfer_dtype is not None:
            t = t.to(self.transfer_dtype)
        return self._to_device(t)

    def _to_device(self, t):
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _shared(self, n: int) -> bool:
        """Whether a batch of `n` runs whole on every rank of the mesh
        (validation only: it does not divide by the data axis)."""
        return self.mesh is not None and n % self._n_data != 0

    def _local_count(self, n: int) -> int:
        """The rows of a global batch of `n` that this rank holds."""
        return n if self.mesh is None or self._shared(n) else n // self._n_data

    def _stage(self, batch, whole_ok=False):
        """(X, y) global host batch -> (X_dev, y_dev, rows, shared,
        event): this rank's rows (all of a shared batch), copied on the
        upload stream; `event` marks the copies' end (None on the
        CPU)."""
        X, y = batch
        rows, shared = self._local_count(len(X)), self._shared(len(X))
        if self._upload is None:
            return (self._put(X, whole_ok), self._put(y, whole_ok), rows,
                    shared, None)
        with torch.cuda.device(self.device), torch.cuda.stream(self._upload):
            Xd, yd = self._put(X, whole_ok), self._put(y, whole_ok)
            ev = torch.cuda.Event()
            ev.record()
        return Xd, yd, rows, shared, ev

    def _staged(self, loader, whole_ok=False):
        """Iterate (X_dev, y_dev, rows, shared), staged `prefetch` batches
        ahead on a background thread (in the caller's with 0, JAX
        `_staged`); the time spent waiting for each is added to
        `loader_wait_s`."""
        stage = lambda b: self._stage(b, whole_ok)  # noqa: E731
        it = (device_prefetch(iter(loader), stage, depth=self.prefetch)
              if self.prefetch > 0 else map(stage, loader))
        for Xd, yd, rows, shared, ev in self._waited(it):
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                for t in (Xd, yd):
                    (t[0] if isinstance(t, tuple) else t).record_stream(cur)
            yield Xd, yd, rows, shared

    def _check_source(self, source):
        if getattr(source, "mesh", None) is not self.mesh:
            raise ValueError("the device-resident source and the trainer "
                             "must be built on the same mesh")

    def _gathered(self, source, index_loader):
        """Iterate (X_dev, y_dev, rows, False) of a device-resident
        source: each index batch's starts and flags are uploaded and this
        rank's rows gathered into a batch on the device; the host time
        spent drawing them is added to `loader_wait_s`."""
        self._check_source(source)
        for idx_batch in self._waited(iter(index_loader)):
            X, y = source.gather(*idx_batch)
            yield X, y, X.shape[0], False

    def _data_sum(self, *values):
        """Python numbers summed over the mesh's data axis (as they are
        without a mesh), in float64."""
        if self.mesh is None:
            return values
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self._data_group)
        return t.tolist()

    def _data_mean(self, tensors):
        """The tensors averaged over the mesh's data axis, by one flat
        all-reduce."""
        flat = _flatten_dense_tensors(tensors)
        dist.all_reduce(flat, group=self._data_group)
        flat /= self._n_data
        return _unflatten_dense_tensors(flat, tensors)

    def _waited(self, it):
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.loader_wait_s += time.perf_counter() - t0
            yield item

    # ------------------------------------------------------------------
    # host-side drivers
    # ------------------------------------------------------------------

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def compute_grads(self, X, y):
        """(loss, {parameter name: gradient}) for one batch in train mode,
        with NO update: parameters, BatchNorm statistics, Adam state and
        any accumulated gradient are left as they were. A parameter the
        loss does not reach (aux_out without aux_lambda) gets zeros."""
        Xd, yd, _, _, ev = self._stage((X, y))
        if ev is not None:
            ev.synchronize()
        saved = {k: b.clone() for k, b in self.model.named_buffers()}
        self.model.train()
        try:
            loss = self._loss(Xd, yd, self._generator())
            names, params = zip(*self.model.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            with torch.no_grad():
                for k, b in self.model.named_buffers():
                    b.copy_(saved[k])
        loss = loss.detach()
        grads = [(g if g is not None else torch.zeros_like(p)).detach()
                 for p, g in zip(params, grads)]
        if self.mesh is not None:
            # the global batch's loss and gradients, shards made whole
            loss, *grads = self._data_mean([loss.reshape(1), *grads])
            shards = {id(getattr(o, a)): s
                      for o, a, s in getattr(self.model, "_tp_leaves", ())}
            grads = [shards[id(p)].whole(g) if id(p) in shards else g
                     for p, g in zip(params, grads)]
        return float(loss), dict(zip(names, grads))

    def train_epoch(self, loader) -> float:
        """One epoch; returns the dataset-mean per-sample loss (reference
        train.py:68-105 semantics, the leftover flush included)."""
        return self._train(self._staged(loader))

    def train_epoch_device(self, source, index_loader) -> float:
        """One epoch over a device-resident dataset (data/device_cache.py
        `DeviceTrainingSource` driven by a `DeviceLoader`): crops and
        augmentations are made on the device; the same loss and
        accumulation as `train_epoch`."""
        return self._train(self._gathered(source, index_loader))

    def _train(self, batches) -> float:
        A = self.accumulation_steps
        self.model.train()
        self.loader_wait_s = 0.0
        sum_loss, n_samples, itr = None, 0, -1
        for itr, (Xd, yd, blen, _) in enumerate(batches):
            generator = self._generator()
            self._step_counter += 1
            loss = self._loss(Xd, yd, generator)
            if A == 1:
                loss.backward()
                self._apply()
            else:
                (loss * (1.0 / A)).backward()
                if (itr + 1) % A == 0:
                    self._apply()
            loss = loss.detach() * blen
            sum_loss = loss if sum_loss is None else sum_loss + loss
            n_samples += blen
        if A > 1 and itr >= 0 and (itr + 1) % A != 0:
            self._apply()
        total, n = self._data_sum(
            0.0 if sum_loss is None else float(sum_loss), n_samples)
        return 0.0 if n == 0 else total / n

    def _apply(self):
        if self.mesh is not None:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            with torch.no_grad():
                for g, m in zip(grads, self._data_mean(grads)):
                    g.copy_(m)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def _predict(self, X, y):
        """(the offset-trimmed eval prediction, the target it is scored
        against): `model.predict`, or for a complex model the magnitudes
        of mask (*) X and |y|."""
        if not self.model.is_complex:
            return self.model.predict(X), y
        pred, y = _complex_magnitudes(self.model(X), X, y)
        off = self.model.offset
        return pred[:, :, :, off:-off], y

    def validate_epoch(self, loader) -> float:
        """Dataset-mean per-sample L1 of the eval prediction (`_predict`)
        against the target centre-cropped in time (reference
        train.py:122-130)."""
        return self._validate(self._staged(loader, whole_ok=True))

    def validate_epoch_device(self, source, batchsize: int) -> float:
        """`validate_epoch` over a `DeviceValidationSource`: the patches
        stay on the device; nothing is uploaded."""
        self._check_source(source)
        return self._validate(
            (self._rows(X, True), self._rows(y, True), self._local_count(n),
             self._shared(n)) for X, y, n in source.batches(batchsize))

    @torch.no_grad()
    def _validate(self, batches) -> float:
        """Sums the losses of this rank's rows, and apart those of shared
        batches (every rank holds all of one), then the former over the
        data axis."""
        self.model.eval()
        sums, counts = [None, None], [0, 0]  # own rows, shared batches
        for Xd, yd, blen, shared in batches:
            pred, y = self._predict(self._upcast(Xd), self._upcast(yd))
            t = pred.shape[3]
            s = (y.shape[3] - t) // 2
            loss = losses.l1(pred, y[:, :, :, s:s + t]) * blen
            sums[shared] = loss if sums[shared] is None else sums[shared] + loss
            counts[shared] += blen
        own, shared = (0.0 if v is None else float(v) for v in sums)
        total, n = self._data_sum(own, counts[0])
        n += counts[1]
        return 0.0 if n == 0 else (total + shared) / n
