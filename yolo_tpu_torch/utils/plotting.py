"""The validator's confusion-matrix plot (counterpart of `plot_confusion_matrix` in
yolo_tpu/utils/plotting.py; nothing else of it is ported). matplotlib is imported
only when a plot is drawn."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def plot_confusion_matrix(matrix: np.ndarray, names=None, save_path="confusion_matrix.png", normalize: bool = True) -> Path:
    """Draw an (nc + 1) square confusion matrix (rows predicted, columns true, the last background),
    each column normalized to 1 unless `normalize=False`, to a PNG → its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = matrix.astype(np.float64)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    nc = matrix.shape[0] - 1
    labels = [(names or {}).get(i, str(i)) for i in range(nc)] + ["background"]
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(m, cmap="Blues")
    ax.set_xticks(range(len(labels)), labels, rotation=90, fontsize=7)
    ax.set_yticks(range(len(labels)), labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            if m[i, j] > 0.005:
                ax.text(j, i, f"{m[i, j]:.2f}" if normalize else int(m[i, j]), ha="center", va="center", fontsize=6)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)
