"""Loss curves of a training log (`loss_{time}.json`).

    python -m vocal_remover_tpu_torch.cli.plot_log LOSS_JSON [OUTPUT_IMAGE]

Counterpart of vocal_remover_tpu/cli/plot_log.py: reads the
[[train, val], ...] list that `cli.train` writes, prints the summary
line (epochs, best validation loss and its epoch), then plots both
curves with the best epoch marked, on a log axis, with matplotlib:
saved to OUTPUT_IMAGE when given, else shown. matplotlib is imported
after the summary; where it cannot be (not installed, or its own
dependencies missing) the tool exits non-zero with a message that names
it.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0], encoding="utf8") as f:
        log = np.asarray(json.load(f), dtype=np.float64)
    train_loss, val_loss = log[:, 0], log[:, 1]
    best = int(np.argmin(val_loss))
    print(
        f"epochs: {len(log)}  best val: {val_loss[best]:.6f} @ epoch "
        f"{best}  (train there: {train_loss[best]:.6f})"
    )

    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"plot_log: matplotlib cannot be imported ({e}); "
                         "the summary above is all it can give") from e

    if len(argv) > 1:  # non-interactive: save to file
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5))
    epochs = np.arange(len(log))
    ax.plot(epochs, train_loss, label="train", color="#4053d3", lw=1.5)
    ax.plot(epochs, val_loss, label="validation", color="#ddb310", lw=1.5)
    ax.scatter([best], [val_loss[best]], zorder=5, color="#b51d14",
               marker="o", s=28, label=f"best val (epoch {best})")
    ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("L1 spectrogram loss")
    ax.set_title("vocal-remover training")
    ax.grid(True, which="major", alpha=0.3)
    ax.legend(frameon=False)
    fig.tight_layout()
    if len(argv) > 1:
        fig.savefig(argv[1], dpi=120)
        print(f"saved {argv[1]}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
