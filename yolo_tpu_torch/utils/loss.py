"""YOLOv8 detection loss: BCE classification, CIoU box and DFL terms (counterpart of
yolo_tpu/utils/loss.py `_df_loss` and `v8DetectionLoss`, its per-level compact path).

The assigner (topk 10, α 0.5, β 6) sees the decode of every anchor, held out of
the gradient. The gradient-carrying terms stay per level: the classification
BCE is summed level by level, and the box terms run on a fixed table of M = topk·N
slots gathered from the levels, which holds every foreground anchor (the assigner
gives each ground truth at most topk) and, beyond them, background anchors whose
weight is zero. Ground truths come padded to N rows, so no shape depends on the data.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from yolo_tpu_torch.ops.boxes import bbox_iou, xywh2xyxy
from yolo_tpu_torch.utils.tal import TaskAlignedAssigner


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy against the two bins that bracket each
    target distance, weighted by its distance to them. pred_dist (..., 4, reg_max)
    logits, target (..., 4) → (...), the mean over the four sides."""
    reg_max = pred_dist.shape[-1]
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    bins = torch.arange(reg_max, device=pred_dist.device)
    w = wl[..., None] * (bins == tl[..., None]) + wr[..., None] * (bins == tr.clamp(0, reg_max - 1)[..., None])
    return -(F.log_softmax(pred_dist, -1) * w).sum(-1).mean(-1)


class v8DetectionLoss:
    """The detection criterion over the per-level raw head outputs (B, H, W, no), NHWC."""

    def __init__(self, model, hyp, tal_topk: int = 10):
        self.nc = model.nc
        self.reg_max = model.head.reg_max
        self.no = self.nc + self.reg_max * 4
        self.stride = model.stride
        self.hyp = hyp  # the box / cls / dfl gains
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=self.nc, alpha=0.5, beta=6.0)

    @staticmethod
    def _fg_slots(fg_mask, weight, max_slots: int):
        """The slot table: the indices of every foreground anchor, then background ones
        (B, M), and the slots' weights (B, M), zero on background."""
        slot_idx = torch.topk(torch.where(fg_mask, weight, -1.0), max_slots, dim=1).indices
        s_fg = torch.gather(fg_mask.to(weight.dtype), 1, slot_idx)
        return slot_idx, s_fg, torch.gather(weight, 1, slot_idx) * s_fg

    @staticmethod
    def _gather(x, slot_idx):
        """(B, A, ...) → (B, M, ...) along the anchor axis."""
        idx = slot_idx.reshape(slot_idx.shape + (1,) * (x.ndim - 2)).expand(-1, -1, *x.shape[2:])
        return torch.gather(x, 1, idx)

    @staticmethod
    def _gather_levels(levels, slot_idx):
        """Gather global anchor slots from the per-level (B, A_l, C) tensors without
        concatenating them: each level gathers its clipped local index, and slots of
        other levels are zeroed before the sum → (B, M, C)."""
        out, off = None, 0
        for lv in levels:
            a_l = lv.shape[1]
            local = slot_idx - off
            inb = (local >= 0) & (local < a_l)
            g = torch.gather(lv, 1, local.clamp(0, a_l - 1)[..., None].expand(-1, -1, lv.shape[-1]))
            g = torch.where(inb[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
            out = g if out is None else out + g
            off += a_l
        return out

    def _slot_terms(self, s_distri, slot_idx, anchor_points, stride_tensor, target_bboxes, s_w, target_scores_sum, proj):
        """CIoU and DFL terms on the gathered (B, M, 4, reg_max) slot table → (loss_iou, loss_dfl)."""
        s_anchor = anchor_points[slot_idx]  # (B, M, 2)
        s_stride = stride_tensor[slot_idx]  # (B, M, 1)
        s_tb = self._gather(target_bboxes, slot_idx) / s_stride
        s_dist = (s_distri.softmax(-1) * proj).sum(-1)  # the gradient-carrying decode, slots only
        s_pred = dist2bbox(s_dist, s_anchor, xywh=False)
        iou = bbox_iou(s_pred, s_tb, xywh=False, CIoU=True)
        loss_iou = ((1.0 - iou) * s_w).sum() / target_scores_sum
        dfl = _df_loss(s_distri, bbox2dist(s_anchor, s_tb, self.reg_max - 1))  # (B, M)
        return loss_iou, (dfl * s_w).sum() / target_scores_sum

    def __call__(self, feats, batch):
        """feats: the per-level (B, H, W, no) raw head outputs; batch: 'cls' (B, N), 'bboxes'
        (B, N, 4) normalized xywh, 'mask_gt' (B, N), tensors on the device of `feats` →
        (total × B, the detached (box, cls, dfl) components (3,))."""
        B, dev = feats[0].shape[0], feats[0].device
        levels = [f.reshape(B, -1, self.no) for f in feats]
        feat_shapes = [(f.shape[1], f.shape[2]) for f in feats]
        anchor_points, stride_tensor = make_anchors(feat_shapes, self.stride, 0.5, device=dev)
        ih, iw = feat_shapes[0][0] * self.stride[0], feat_shapes[0][1] * self.stride[0]
        proj = torch.arange(self.reg_max, dtype=torch.float32, device=dev)

        gt_labels = batch["cls"][..., None].long()  # (B, N, 1)
        scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
        gt_bboxes = xywh2xyxy(batch["bboxes"].float() * scale)  # (B, N, 4) px xyxy
        mask_gt = batch["mask_gt"][..., None].float()
        gt_bboxes = gt_bboxes * mask_gt

        r4 = self.reg_max * 4
        a = sum(lv.shape[1] for lv in levels)
        M = min(self.assigner.topk * gt_labels.shape[1], a)  # every foreground anchor fits
        with torch.no_grad():
            dist = torch.cat([
                (lv[..., :r4].float().reshape(B, -1, 4, self.reg_max).softmax(-1) * proj).sum(-1) for lv in levels
            ], 1)  # (B, A, 4)
            scores = torch.cat([lv[..., r4:].float().sigmoid() for lv in levels], 1)  # (B, A, nc)
            pred_bboxes = dist2bbox(dist, anchor_points[None], xywh=False)  # grid units
            _, target_bboxes, target_scores, fg_mask, _ = self.assigner(
                scores, pred_bboxes * stride_tensor[None], anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt
            )
            target_scores_sum = target_scores.sum().clamp(min=1.0)
            weight = target_scores.sum(-1) * fg_mask.float()  # (B, A)
            slot_idx, _, s_w = self._fg_slots(fg_mask, weight, M)

        loss_cls, off = torch.zeros((), dtype=torch.float32, device=dev), 0
        for lv in levels:  # BCE with logits, level by level
            a_l = lv.shape[1]
            ps = lv[..., r4:].float()
            ts = target_scores[:, off : off + a_l]
            loss_cls = loss_cls + (ps.clamp(min=0) - ps * ts + torch.log1p(torch.exp(-ps.abs()))).sum()
            off += a_l
        loss_cls = loss_cls / target_scores_sum

        s_distri = self._gather_levels([lv[..., :r4] for lv in levels], slot_idx).float().reshape(B, M, 4, self.reg_max)
        loss_iou, loss_dfl = self._slot_terms(
            s_distri, slot_idx, anchor_points, stride_tensor, target_bboxes, s_w, target_scores_sum, proj
        )
        loss = torch.stack([loss_iou * self.hyp.box, loss_cls * self.hyp.cls, loss_dfl * self.hyp.dfl])
        return loss.sum() * B, loss.detach()
