"""The published training step in plain PyTorch, after tsurumeso/
vocal-remover `train.py` (`train_epoch`): the model in train mode (batch
statistics, channel dropout), L1 between mask * X and y on magnitudes,
the loss's gradients, and Adam (lr, betas (0.9, 0.999), eps 1e-8)
written out here as the published optimizer computes it.

The crops are |z| / coef of the spectrograms both sides read, coef the
song's largest magnitude of mixture and instruments, at the positions
the benchmark found for the program's crops (benchmark/check_train.py).
"""

from __future__ import annotations

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a step's dropout masks: seeded by (seed, step),
    as the measured trainer seeds it, so both draw the same masks."""
    state = np.random.SeedSequence([0xD509, seed % 2**32, step])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
    return g


def magnitudes(spec: torch.Tensor) -> torch.Tensor:
    """(T, 2, F) complex cache rows -> (2, F, T) float64 |z|."""
    return spec.to(torch.complex128).abs().permute(1, 2, 0)


class Adam:
    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = lr
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + EPS))


def steps(model, batches, lr: float, seed: int, device):
    """Train `model` (a reference CascadedNet, in place) on `batches`
    ([(X, y)] float32 device tensors), one Adam step each; -> (losses,
    {name: |gradient of step 1|}, {name: |change after the last step|})
    as float64 norms."""
    model.train()
    names, params = zip(*model.named_parameters())
    start = [p.detach().clone() for p in params]
    opt = Adam(params, lr)
    losses, grad_norms = [], {}
    for step, (X, y) in enumerate(batches):
        mask = model(X, dropout_generator(seed, step, device))
        loss = torch.mean(torch.abs(mask * X - y))
        # a leaf the loss does not reach (aux_out) gets a zero gradient,
        # with which Adam leaves it where it is
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(
                     loss, params, allow_unused=True))]
        if step == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g.double()))
                          for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm((p.detach() - s).double()))
              for n, p, s in zip(names, params, start)}
    return losses, grad_norms, change
