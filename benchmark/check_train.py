"""Whether the first training steps of a window's trainer are correct.

The benchmark keeps, from set-up, the batches the loader handed the
trainer in its first `steps` steps (one `train_epoch` call, batches
staged ahead as in the window), each step's loss, what each step trained
on (each sample's sum of its mixture crop and of its target crop, as
the loss got them), the norm of each parameter's first gradient as Adam
holds it after step 1 (its first moment / (1 - beta1)) and the norm of
each parameter's change after the last of those steps. The reference (benchmark/reference/train.py,
float32 with TF32 off) finds where in the spectrograms each of the
program's crops lies (song, first frame, channel order, mixture or
instruments), makes that crop itself from the same cache files, and
trains its own model from the same weights on those crops, drawing the
same dropout masks. Compared, with limits in limits/<cell>.json:
  * `loss1`: the relative gap of the first step's loss (the later
    steps' losses part by Adam's sign of near-zero gradients, which a
    float32 run rounds either way: see PERF.md);
  * `grad`: the worst leaf's gap between the two norms of its first
    gradient, over the larger of the reference's norm of that leaf and
    of the median leaf;
  * `change`: the same for the norm of the parameters' change;
  * `feed`: the largest relative gap between a sum of what a step
    trained on and the same sum of the reference's crop: a batch
    staged wrong, late or twice.
Leaves whose first gradient in the reference is under a thousandth of
the median leaf's (a bias under a normalisation: moved by round-off
alone) are left out of `grad` and `change`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import train as ref_train
from benchmark.reference.precision import tf32

SMALL_LEAF = 1e-3


def fingerprint(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(2, B) float64 sums of each sample's mixture crop and target crop
    of a batch, on its device (read without a sync)."""
    return torch.stack([X.double().flatten(1).sum(1),
                        y.double().flatten(1).sum(1)])


def load_caches(training_set, device):
    """[(X, y, coef)] of the cache files both sides read: X and y the
    (2, F, T) float32 magnitudes |z| / coef on `device`, coef the song's
    largest magnitude of mixture and instruments."""
    out = []
    for x_path, y_path in training_set:
        X, y = (torch.from_numpy(np.load(p)).to(device) for p in (x_path,
                                                                   y_path))
        X, y = (ref_train.magnitudes(z) for z in (X, y))
        coef = max(float(X.max()), float(y.max()))
        out.append(((X / coef).float(), (y / coef).float(), coef))
    return out


def locate(crop: torch.Tensor, songs, cropsize: int):
    """(song, first frame, swapped, source) of a program crop (2, F, T):
    the song frame that its first column matches best, over both channel
    orders and both of a pair's spectrograms."""
    best = None
    for s, (X, y, _) in enumerate(songs):
        for source, mag in (("mixture", X), ("instruments", y)):
            cols = mag[:, :, :mag.shape[2] - cropsize + 1]
            for swapped in (False, True):
                c = crop[:, :, :1].flip(0) if swapped else crop[:, :, :1]
                err = (cols - c).abs().amax(dim=(0, 1))
                t = int(err.argmin())
                if best is None or float(err[t]) < best[0]:
                    best = (float(err[t]), s, t, swapped, source)
    return best[1:]


def reference_batches(batches, songs, cropsize: int, device):
    """The reference's own crops at the positions of the program's; ->
    ([(X, y)] device tensors, largest |program - reference| crop gap)."""
    out, gap = [], 0.0
    for X_p, y_p in batches:
        X_p, y_p = (torch.from_numpy(np.asarray(a)).to(device)
                    for a in (X_p, y_p))
        xs, ys = [], []
        for k in range(len(X_p)):
            s, t, swapped, source = locate(X_p[k], songs, cropsize)
            X, y, _ = songs[s]
            ym = y[:, :, t:t + cropsize]
            xm = ym if source == "instruments" else X[:, :, t:t + cropsize]
            if swapped:
                xm, ym = xm.flip(0), ym.flip(0)
            xs.append(xm)
            ys.append(ym)
            gap = max(gap, float((xm - X_p[k]).abs().max()),
                      float((ym - y_p[k]).abs().max()))
        out.append((torch.stack(xs).contiguous(),
                    torch.stack(ys).contiguous()))
    return out, gap


def leaf_gap(got: dict, want: dict, kept) -> float:
    med = float(np.median(list(want.values())))
    return max((abs(got[k] - want[k]) / max(want[k], med) for k in kept),
               default=0.0)


def reference_readings(config, state_dict, training_set, batches, seed, lr,
                       cropsize, device, allow_tf32=False):
    """(losses, grad norms, change norms, crop gap, feed) of the
    reference's steps on the program's batches' positions; `feed` the
    (steps, 2, B) `fingerprint`s of its own crops."""
    songs = load_caches(training_set, device)
    ref_b, crop_gap = reference_batches(batches, songs, cropsize, device)
    feed = torch.stack([fingerprint(X, y) for X, y in ref_b]).cpu().numpy()
    model = weights.reference_model(config, device, state_dict)
    with tf32(allow_tf32):
        losses, grads, change = ref_train.steps(model, ref_b, lr, seed,
                                                device)
    return losses, grads, change, crop_gap, feed


def feed_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest relative gap of the program's step fingerprints from the
    reference's (inf where the steps or batches differ in number)."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                         1e-30)))


def detail(program: dict, reference: tuple, top: int = 3) -> dict:
    """What lies behind the numbers: each step's relative loss gap, and
    the leaves with the largest gaps (name, reference norm, program's)."""
    losses, grads, change, _, feed = reference
    med = float(np.median(list(grads.values())))
    kept = [k for k, v in grads.items() if v >= SMALL_LEAF * med]
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(program["losses"], losses)],
           "feed_gaps": [feed_gap(g, w) for g, w in
                         zip(program["feed"], feed)]}
    for key, ref in (("grads", grads), ("change", change)):
        m = float(np.median(list(ref.values())))
        worst = sorted(kept, key=lambda k: -abs(program[key][k] - ref[k])
                       / max(ref[k], m))[:top]
        out[key] = [(k, ref[k], program[key][k]) for k in worst]
        out[key + "_median"] = m
    return out


def numbers(program: dict, reference: tuple) -> dict:
    """The compared numbers of the program's readings (`losses`,
    `grads`, `change`, `feed`) against the reference's."""
    losses, grads, change, _, feed = reference
    med = float(np.median(list(grads.values())))
    kept = [k for k, v in grads.items() if v >= SMALL_LEAF * med]
    if set(program["grads"]) != set(grads) or \
            len(program["losses"]) != len(losses):
        return dict.fromkeys(("loss1", "grad", "change", "feed"),
                             float("inf"))
    return {"loss1": abs(program["losses"][0] - losses[0]) / abs(losses[0]),
            "grad": leaf_gap(program["grads"], grads, kept),
            "change": leaf_gap(program["change"], change, kept),
            "feed": feed_gap(program["feed"], feed)}
