"""Task-aligned assigner of the detection loss (counterpart of yolo_tpu/utils/tal.py
TaskAlignedAssigner): align metric score^α · IoU^β, the top-k in-box anchors of each
ground truth, an anchor claimed by several kept by the largest overlap, target scores
normalised by each ground truth's best metric and overlap.

Shapes are static: ground truths come padded to N rows with `mask_gt` marking the
real ones, so nothing here branches on the data or waits for the device.
`RotatedTaskAlignedAssigner` is the obb task's: xywhr boxes, an anchor a candidate when
its projections onto a box's edge vectors fall within the edges, probiou overlaps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tpu_torch.ops.boxes import bbox_iou, probiou, xywhr2xyxyxyxy


class TaskAlignedAssigner:
    """Assign ground truths to anchors by the task-aligned metric → dense target tensors."""

    def __init__(self, topk: int = 10, num_classes: int = 80, alpha: float = 1.0, beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt):
        """pd_scores (B, A, nc) sigmoid scores, pd_bboxes (B, A, 4) xyxy px, anc_points (A, 2) px,
        gt_labels (B, N, 1) int, gt_bboxes (B, N, 4) xyxy px (padded rows zero), mask_gt (B, N, 1)
        → target_labels (B, A), target_bboxes (B, A, 4), target_scores (B, A, nc),
        fg_mask (B, A) bool, target_gt_idx (B, A)."""
        mask_gt = mask_gt[..., 0].bool()  # (B, N)
        mask_in_gts = self._candidates_in_gts(anc_points, gt_bboxes)  # (B, N, A)
        align_metric, overlaps = self._box_metrics(pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask_in_gts & mask_gt[..., None])
        mask_pos = self._topk_mask(align_metric, mask_gt) & mask_in_gts & mask_gt[..., None]
        target_gt_idx, fg, mask_pos = self._resolve_conflicts(mask_pos, overlaps)

        tl = torch.gather(gt_labels[..., 0].long(), 1, target_gt_idx).clamp(min=0)  # (B, A)
        tb = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))  # (B, A, 4 or 5)
        target_scores = torch.where(fg[..., None] > 0, F.one_hot(tl, self.num_classes).float(), 0.0)

        align_metric = torch.where(mask_pos, align_metric, 0.0)
        pos_align = align_metric.amax(-1, keepdim=True)  # (B, N, 1)
        pos_overlaps = torch.where(mask_pos, overlaps, 0.0).amax(-1, keepdim=True)
        norm = (align_metric * pos_overlaps / (pos_align + self.eps)).amax(-2)[..., None]  # (B, A, 1)
        return tl, tb, target_scores * norm, fg > 0, target_gt_idx

    @staticmethod
    def _candidates_in_gts(anc_points, gt_bboxes, eps: float = 1e-9):
        """(B, N, A) bool: the anchor centre lies strictly inside the box."""
        ax, ay = anc_points[None, None, :, 0], anc_points[None, None, :, 1]
        x1, y1, x2, y2 = (gt_bboxes[..., None, i] for i in range(4))
        return (ax - x1 > eps) & (ay - y1 > eps) & (x2 - ax > eps) & (y2 - ay > eps)

    def _box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask):
        """(align metric, CIoU overlaps clipped at 0), both (B, N, A) and zero outside `mask`."""
        scores_t = pd_scores.transpose(1, 2)  # (B, nc, A)
        idx = gt_labels.long().clamp(min=0).expand(-1, -1, scores_t.shape[-1])
        bbox_scores = torch.where(mask, torch.gather(scores_t, 1, idx), 0.0)
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True)
        overlaps = torch.where(mask, overlaps.clamp(min=0), 0.0)
        return bbox_scores**self.alpha * overlaps**self.beta, overlaps

    def _topk_mask(self, metrics, mask_gt):
        """(B, N, A) bool: the top-k metric anchors of each valid ground truth, as k argmax
        sweeps that each take the lowest index among equal values, the order the JAX
        package's picks follow (`torch.topk` promises none among ties)."""
        m = metrics.clone()
        sel = torch.zeros_like(m, dtype=torch.bool)
        for _ in range(self.topk):
            hit = torch.zeros_like(sel).scatter_(-1, m.argmax(-1, keepdim=True), True)
            m.masked_fill_(hit, float("-inf"))
            sel |= hit
        return sel & mask_gt[..., None]

    @staticmethod
    def _resolve_conflicts(mask_pos, overlaps):
        """An anchor claimed by several ground truths keeps the one of largest overlap
        (the first of equal ones) → (target_gt_idx (B, A), claim count (B, A), mask_pos)."""
        fg = mask_pos.sum(-2)  # (B, A)
        is_max = torch.zeros_like(mask_pos).scatter_(1, overlaps.argmax(-2, keepdim=True), True)
        mask_pos = torch.where(fg[:, None, :] > 1, is_max, mask_pos)
        return mask_pos.to(torch.uint8).argmax(-2), mask_pos.sum(-2), mask_pos


class RotatedTaskAlignedAssigner(TaskAlignedAssigner):
    """The task-aligned assigner of oriented boxes (JAX RotatedTaskAlignedAssigner): pd_bboxes and gt_bboxes
    are (.., 5) xywhr in pixels; an anchor is a candidate of a box when its projections onto the box's edge
    vectors from the first corner fall within them (edges included), and the overlaps are probiou's."""

    @staticmethod
    def _candidates_in_gts(anc_points, gt_bboxes, eps: float = 1e-9):
        corners = xywhr2xyxyxyxy(gt_bboxes)  # (B, N, 4, 2)
        a, b, d = corners[..., 0:1, :], corners[..., 1:2, :], corners[..., 3:4, :]
        ab, ad = b - a, d - a  # (B, N, 1, 2)
        ap = anc_points[None, None] - a  # (B, N, A, 2)
        norm_ab, norm_ad = (ab * ab).sum(-1), (ad * ad).sum(-1)
        ap_ab, ap_ad = (ap * ab).sum(-1), (ap * ad).sum(-1)
        return (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)

    def _box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask):
        """(align metric, probiou overlaps clipped at 0), both (B, N, A) and zero outside `mask`."""
        scores_t = pd_scores.transpose(1, 2)
        idx = gt_labels.long().clamp(min=0).expand(-1, -1, scores_t.shape[-1])
        bbox_scores = torch.where(mask, torch.gather(scores_t, 1, idx), 0.0)
        overlaps = probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])[..., 0]
        overlaps = torch.where(mask, overlaps.clamp(min=0), 0.0)
        return bbox_scores**self.alpha * overlaps**self.beta, overlaps
