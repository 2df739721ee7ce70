"""Plots of the validator and the trainer, and the box, mask and keypoint drawing of `Results.plot`
(counterpart of `plot_confusion_matrix`, `plot_labels`, `plot_images`, `feature_visualization` and the box,
text, mask and keypoint drawing of `Annotator` in yolo_tpu/utils/plotting.py; nothing else of it is ported).
matplotlib and cv2 are imported only when a plot is drawn."""

from __future__ import annotations

import math
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


_COLORS = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207),
    (10, 249, 72), (23, 204, 146), (134, 219, 61), (52, 147, 26), (187, 212, 0),
    (168, 153, 44), (255, 194, 0), (147, 69, 52), (255, 115, 100), (236, 24, 0),
    (255, 56, 132), (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def color_for(idx: int):
    return _COLORS[int(idx) % len(_COLORS)]


def box_label(im: np.ndarray, box, label: str, color, lw: int, txt_color=(255, 255, 255)) -> None:
    """Draw an xyxy box and its label on a BGR image in place (the JAX `Annotator.box_label`)."""
    import cv2

    p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    cv2.rectangle(im, p1, p2, color, lw, cv2.LINE_AA)
    if label:
        tf = max(lw - 1, 1)
        wh = cv2.getTextSize(label, 0, lw / 3, tf)[0]
        outside = p1[1] - wh[1] - 3 >= 0
        p2t = (p1[0] + wh[0], p1[1] - wh[1] - 3 if outside else p1[1] + wh[1] + 3)
        cv2.rectangle(im, p1, p2t, color, -1, cv2.LINE_AA)
        cv2.putText(im, label, (p1[0], p1[1] - 2 if outside else p1[1] + wh[1] + 2), 0, lw / 3, txt_color, tf, cv2.LINE_AA)


class Annotator:
    """Boxes and labels drawn on a BGR image (a read-only image is copied first); the line
    width defaults to 0.3% of the image's mean side, at least 2."""

    def __init__(self, im: np.ndarray, line_width: int | None = None):
        self.im = im if im.flags.writeable else im.copy()
        self.lw = line_width or max(round(sum(im.shape[:2]) / 2 * 0.003), 2)

    def box_label(self, box, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255)):
        box_label(self.im, box, label, color, self.lw, txt_color)

    def text(self, xy, text: str, txt_color=(255, 255, 255), anchor: str = "top", box_color=()):
        """A line of text with its top-left corner at `xy` (its baseline with anchor 'bottom'), on a
        filled `box_color` box where one is given (JAX `Annotator.text`)."""
        import cv2

        tf = max(self.lw - 1, 1)
        wh = cv2.getTextSize(text, 0, self.lw / 3, tf)[0]
        x, y = int(xy[0]), int(xy[1])
        y = y - 2 if anchor == "bottom" else y + wh[1] + 2
        if box_color:
            cv2.rectangle(self.im, (x, y - wh[1] - 3), (x + wh[0], y + 3), box_color, -1, cv2.LINE_AA)
        cv2.putText(self.im, text, (x, y), 0, self.lw / 3, txt_color, tf, cv2.LINE_AA)

    def masks(self, masks, colors, alpha: float = 0.5):
        """Blend each (H, W) mask (> 0.5) into the image in its BGR colour at `alpha`, in f32, then
        truncate to uint8 (JAX `Annotator.masks`)."""
        if masks is None or len(masks) == 0:
            return
        im = self.im.astype(np.float32)
        for m, c in zip(np.asarray(masks), colors):
            im = np.where((np.asarray(m) > 0.5)[..., None], im * (1 - alpha) + alpha * np.array(c, np.float32), im)
        self.im[:] = im.astype(np.uint8)

    # the COCO 17-keypoint skeleton, 1-based keypoint pairs
    SKELETON = [(16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13), (6, 7),
                (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7)]

    def kpts(self, kpts, radius: int = 5, kpt_line: bool = True, conf_thres: float = 0.25):
        """One instance's keypoints (K, 2 or 3) as green dots, those with a visibility below `conf_thres` or
        a coordinate not above 0 left out, and for K = 17 the skeleton's limbs between drawn pairs (JAX
        `Annotator.kpts`)."""
        import cv2

        kpts = np.asarray(kpts)
        has_conf = kpts.shape[-1] == 3
        for k in kpts:
            if has_conf and k[2] < conf_thres:
                continue
            if k[0] > 0 and k[1] > 0:
                cv2.circle(self.im, (int(k[0]), int(k[1])), radius, (0, 255, 0), -1, cv2.LINE_AA)
        if kpt_line and len(kpts) == 17:
            for a, b in self.SKELETON:
                ka, kb = kpts[a - 1], kpts[b - 1]
                if has_conf and (ka[2] < conf_thres or kb[2] < conf_thres):
                    continue
                if min(ka[0], ka[1], kb[0], kb[1]) > 0:
                    cv2.line(self.im, (int(ka[0]), int(ka[1])), (int(kb[0]), int(kb[1])), (255, 128, 0), 2, cv2.LINE_AA)

    def result(self):
        return self.im


def plot_images(batch, fname="train_batch.jpg", names=None, max_subplots: int = 16, conf_thres: float = 0.25, save: bool = True):
    """A mosaic of a collated batch (img (B, H, W, 3) RGB uint8, cls, bboxes normalized xywh,
    mask_gt; optional conf) with its boxes and labels → written to `fname`, or returned
    (BGR) with save=False."""
    import cv2

    imgs = np.asarray(batch["img"])[:max_subplots]
    B, H, W = imgs.shape[:3]
    ncols = int(math.ceil(B**0.5))
    nrows = int(math.ceil(B / ncols))
    canvas = np.full((nrows * H, ncols * W, 3), 255, np.uint8)
    names = names or {}
    confs = batch.get("conf")
    lw = max(round((H + W) / 2 * 0.003), 2)
    for i in range(B):
        r, c = divmod(i, ncols)
        tile = imgs[i][..., ::-1].copy()  # RGB → BGR for cv2
        m = np.asarray(batch["mask_gt"][i]) > 0
        cf = np.asarray(confs[i])[m] if confs is not None else None
        for j, (b, k) in enumerate(zip(np.asarray(batch["bboxes"][i])[m], np.asarray(batch["cls"][i])[m])):
            if cf is not None and cf[j] < conf_thres:
                continue
            cx, cy, bw, bh = b * [W, H, W, H]
            label = names.get(int(k), str(int(k))) + (f" {cf[j]:.2f}" if cf is not None else "")
            box_label(tile, (cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2), label, color_for(int(k)), lw)
        canvas[r * H : (r + 1) * H, c * W : (c + 1) * W] = tile
    if save:
        cv2.imwrite(str(fname), canvas)
        return None
    return canvas


def plot_labels(boxes, cls, names=None, save_path="labels.png"):
    """Label statistics of a dataset: the class histogram, box centres, box sizes and
    their density (normalized xywh boxes) → the PNG's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    boxes = np.asarray(boxes).reshape(-1, 4)
    cls = np.asarray(cls).reshape(-1)
    fig, axes = plt.subplots(2, 2, figsize=(10, 8), tight_layout=True)
    names = names or {}
    nc = int(cls.max()) + 1 if len(cls) else 1
    axes[0, 0].hist(cls, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0, 0].set_title("instances per class")
    if nc <= 30 and names:
        axes[0, 0].set_xticks(range(nc))
        axes[0, 0].set_xticklabels([names.get(i, i) for i in range(nc)], rotation=90, fontsize=7)
    if len(boxes):
        axes[0, 1].scatter(boxes[:, 0], boxes[:, 1], s=3, alpha=0.4)
        axes[0, 1].set_title("box centers (x, y)")
        axes[1, 0].scatter(boxes[:, 2], boxes[:, 3], s=3, alpha=0.4)
        axes[1, 0].set_title("box sizes (w, h)")
        axes[1, 1].hist2d(boxes[:, 2], boxes[:, 3], bins=32)
        axes[1, 1].set_title("w/h density")
    for ax in axes.flat:
        ax.set_xlim(0, 1)
        if ax is not axes[0, 0]:
            ax.set_ylim(0, 1)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


_MPL_WARNED = [False]


def feature_visualization(x: np.ndarray, module_type: str, stage: int, n: int = 32, save_dir=Path("runs/detect/exp")) -> None:
    """One layer's NHWC feature maps (image 0) → save_dir/stage{stage}_{module}_features.png, a grid of
    its first `n` channels, and the .npy of the map (JAX `feature_visualization`). Head outputs and
    1-pixel maps are skipped. Without matplotlib only the .npy is written, with one warning."""
    from yolo_tpu_torch.utils import LOGGER

    if any(m in module_type for m in ("Detect", "Segment", "Pose", "Classify", "OBB", "RTDETRDecoder")):
        return
    x = np.asarray(x)
    if x.ndim != 4 or x.shape[1] <= 1 or x.shape[2] <= 1:
        return
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float32)
    f = Path(save_dir) / f"stage{stage}_{module_type.rsplit('.', 1)[-1]}_features.png"
    f.parent.mkdir(parents=True, exist_ok=True)
    channels = x.shape[-1]
    n = min(n, channels)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if not _MPL_WARNED[0]:
            LOGGER.warning("visualize: matplotlib is not installed; writing the feature maps' .npy files only")
            _MPL_WARNED[0] = True
    else:
        _, ax = plt.subplots(math.ceil(n / 8), 8, tight_layout=True)
        ax = np.atleast_1d(ax).ravel()
        plt.subplots_adjust(wspace=0.05, hspace=0.05)
        for i in range(len(ax)):
            if i < n:
                ax[i].imshow(x[0, :, :, i])
            ax[i].axis("off")
        LOGGER.info(f"Saving {f}... ({n}/{channels})")
        plt.savefig(f, dpi=150, bbox_inches="tight")
        plt.close()
    np.save(str(f.with_suffix(".npy")), x[0])
