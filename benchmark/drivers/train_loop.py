"""Driver `train_loop`: `Trainer.train_epoch(loader)` as the training CLI
drives it (cli/train.py `_run`): the port's `Loader` over a
`TrainingSet` of the seeded pairs (the spectrogram caches of
`make_training_set`), `patches` crops a song an epoch, shuffled, the
CLI's defaults (augmentations off, 4 loader workers, 2 batches staged
ahead), Adam at the configuration's learning rate, under its precision.

Set-up builds one trainer and drives it through its first `check_steps`
steps in one `train_epoch` call on the same batch stream the window
reads, so those steps run as the window's do, with batches staged ahead
on the prefetch thread while a step runs; it keeps what the check
compares (each step's loss and what it trained on, the first gradients
as Adam holds them, the parameters' change). The window
is one `train_epoch` over batches handed in until `--seconds` have
passed, epoch after epoch; it closes when that call returns. A traced
run then profiles `trace_steps` more steps.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time

import torch

from benchmark import check_train, flops, program, trace, traffic, weights

BETA1 = 0.9  # Adam's first-moment decay, as published


class Batches:
    """The loader's batches, epoch after epoch, handed out in calls:
    `take(n)` yields the next n, `until(deadline)` yields until the
    deadline has passed. Records the batches while `record` is set."""

    def __init__(self, loader, spans=None):
        self.loader = loader
        self._it = iter(loader)
        self.handed = 0
        self.record = None
        self.spans = spans

    def _next(self):
        try:
            batch = next(self._it)
        except StopIteration:
            self._it = iter(self.loader)  # the next epoch
            batch = next(self._it)
        self.handed += 1
        if self.record is not None:
            self.record.append(batch)
        return batch

    def next(self):
        if self.spans is None:
            return self._next()
        with self.spans.span("loader next()"):
            return self._next()

    def take(self, n: int):
        for _ in range(n):
            yield self.next()

    def until(self, deadline: float):
        while time.perf_counter() < deadline:
            yield self.next()

    def close(self):
        self._it.close()


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


class FirstSteps:
    """Records, while the trainer runs its first steps, what the check
    compares: each step's loss and the `check_train.fingerprint` of what
    it trained on (the trainer's `_loss`, wrapped on the instance), and
    after step 1 the norms of Adam's first moment over (1 - beta1) (a
    step post-hook). Kept on the device until `readings()`, so that the
    steps run unsynchronized, as the window's do."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.losses, self.feed, self.grads = [], [], None
        inner = trainer._loss

        def loss_of_step(X, y, generator):
            loss = inner(X, y, generator)
            self.losses.append(loss.detach())
            self.feed.append(check_train.fingerprint(trainer._upcast(X),
                                                     trainer._upcast(y)))
            return loss

        trainer._loss = loss_of_step  # instance attribute: one wrapper
        self._hook = trainer.optimizer.register_step_post_hook(self._step)

    def _step(self, opt, args=None, kwargs=None):
        if self.grads is not None:
            return
        state = opt.state
        # a leaf the loss does not reach (aux_out) has no state
        self.grads = {k: torch.linalg.vector_norm(
            state[p]["exp_avg"].double() / (1 - BETA1))
            if "exp_avg" in state.get(p, {}) else torch.zeros(())
            for k, p in self.trainer.model.named_parameters()}

    def readings(self) -> dict:
        self._hook.remove()
        del self.trainer._loss
        self._step(self.trainer.optimizer)  # no step taken: no moment
        return {"losses": [float(v) for v in self.losses],
                "grads": {k: float(v) for k, v in self.grads.items()},
                "feed": (torch.stack(self.feed).cpu().numpy() if self.feed
                         else None)}


def prepare(r):
    """Set-up: the training set, the loader, the trainer (one object for
    set-up and window), driven through its first `check_steps` steps.
    -> dict of what the window and the check need."""
    from vocal_remover_tpu_torch.cli.train import reduction_weight_ramp
    from vocal_remover_tpu_torch.data import cache, dataset
    from vocal_remover_tpu_torch.data.loader import Loader
    from vocal_remover_tpu_torch.nn import config as port_config
    from vocal_remover_tpu_torch.train.step import Trainer

    cfg, tr, dev = r.config, r.traffic, r.device
    crop, bs = cfg["cropsize"], cfg["batchsize"]
    root = os.path.join(tempfile.gettempdir(), "vocal-remover-benchmark")
    pairs = traffic.training_pairs(tr["pairs"], cfg,
                                   r.seed % tr["pairs"]["variants"], root,
                                   dev)
    training_set = cache.make_training_set(pairs, cfg["sr"],
                                           cfg["hop_length"], cfg["n_fft"])
    data = dataset.TrainingSet(
        training_set * cfg["patches"], cropsize=crop, reduction_rate=0.0,
        reduction_weight=reduction_weight_ramp(cfg["n_fft"], cfg["sr"], 0.2),
        mixup_rate=0.0, mixup_alpha=1.0, seed=r.seed)
    loader = Loader(data, batchsize=bs, shuffle=True,
                    num_workers=tr["num_workers"], seed=r.seed)
    batches = Batches(loader)
    r.log("training set cached")
    sd = weights.make_state_dict(cfg, r.seed, dev)
    net = program.model(cfg, sd, dev, "highest")  # trained as loaded
    names = [n for n, _ in net.named_parameters()]

    with port_config.precision(cfg["precision"]):
        trainer = Trainer(net, learning_rate=cfg["learning_rate"],
                          seed=r.seed, device=dev)
        params = dict(trainer.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        first = FirstSteps(trainer)
        batches.record = checked = []
        trainer.train_epoch(batches.take(tr["check_steps"]))
        batches.record = None
        readings = first.readings()
        readings["change"] = _norms({k: params[k].detach() - start[k]
                                     for k in names})
    r.log(f"set up, first steps' losses {readings['losses']}")
    return {"trainer": trainer, "batches": batches, "sd": sd,
            "pairs": pairs, "checked": checked, "readings": readings}


def reference(r, p, allow_tf32=False):
    """The reference's readings of the first steps (see check_train)."""
    cfg = r.config
    cache_paths = [tuple(traffic.cache_path(a, cfg) for a in pair)
                   for pair in p["pairs"]]
    return check_train.reference_readings(
        cfg, p["sd"], cache_paths, p["checked"], r.seed,
        cfg["learning_rate"], cfg["cropsize"], r.device, allow_tf32)


def run(r):
    from vocal_remover_tpu_torch.nn import config as port_config

    cfg = r.config
    p = prepare(r)
    trainer, batches = p["trainer"], p["batches"]
    with port_config.precision(cfg["precision"]):
        deadline = r.open_window()
        handed = batches.handed
        window_loss = trainer.train_epoch(batches.until(deadline))
        r.close_window()
        steps = batches.handed - handed
        wait = trainer.loader_wait_s
        if r.trace:
            profile(r, trainer, batches, r.traffic["trace_steps"])
    batches.close()
    r.log("window closed")

    per_step = flops.train_flops(cfg, cfg["batchsize"],
                                 cfg["cropsize"])["total"]
    r.attempted = steps
    r.failed = 0 if math.isfinite(window_loss) else steps
    r.work = {"steps": steps, "samples": steps * cfg["batchsize"],
              "useful_flops": steps * per_step,
              "peak_flops": flops.PEAKS[cfg["precision"]]}
    r.counters["loader_wait_s"] = wait

    del trainer, p["trainer"]
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(r, p)
    r.checks = check_train.numbers(p["readings"], ref)
    r.counters["crop_gap"] = ref[3]
    r.log(f"check detail {check_train.detail(p['readings'], ref)}")


def profile(r, trainer, batches, n_steps: int):
    """Profile `n_steps` more steps with the benchmark's spans: `loader
    next()` (a batch from the loader, on the staging thread), `forward`
    (the model, by hooks), `backward` (from the forward's end to the
    optimizer), `optimizer` (Adam's step, by its hooks)."""
    cfg = r.config
    spans = trace.Spans()
    batches.spans = spans
    cur = {}

    def switch(name):
        now = time.time_ns()
        if cur:
            spans.add(cur["name"], cur["t"], now)
            cur.clear()
        if name:
            cur.update(name=name, t=now)

    model, opt = trainer.model, trainer.optimizer
    hooks = [model.register_forward_pre_hook(lambda *a: switch("forward")),
             model.register_forward_hook(lambda *a: switch("backward")),
             opt.register_step_pre_hook(lambda *a: switch("optimizer")),
             opt.register_step_post_hook(lambda *a: switch(None))]
    try:
        prof = trace.profile_slice(
            lambda: trainer.train_epoch(batches.take(n_steps)), spans,
            attribute=("aten::convolution", "aten::convolution_backward"))
    finally:
        for h in hooks:
            h.remove()
        batches.spans = None
    prof["steps"] = n_steps
    prof["conv_bound_s"] = n_steps * flops.conv_bound_s(
        cfg, cfg["batchsize"], cfg["cropsize"], cfg["precision"], train=True)
    prof["conv_device_s"] = sum(prof["attributed_s"].values())
    r.profile = prof
