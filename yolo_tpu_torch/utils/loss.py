"""YOLOv8 detection, segmentation, pose and oriented-box losses: BCE classification, CIoU box and DFL
terms, the mask BCE, the keypoint OKS and objectness terms, and the probiou box term (counterpart of
yolo_tpu/utils/loss.py `_df_loss`, `v8DetectionLoss`, its per-level compact path, `v8SegmentationLoss`,
`v8PoseLoss` and `v8OBBLoss`).

The assigner (topk 10, α 0.5, β 6) sees the decode of every anchor, held out of
the gradient. The gradient-carrying terms stay per level: the classification
BCE is summed level by level, and the box terms run on a fixed table of M = topk·N
slots gathered from the levels, which holds every foreground anchor (the assigner
gives each ground truth at most topk) and, beyond them, background anchors whose
weight is zero. Ground truths come padded to N rows, so no shape depends on the data.
The mask BCE runs on the top `max_fg` foreground anchors of each image by target score,
gathered into a fixed slot table as well. The keypoint terms take the box terms' slot table
while it is smaller than the anchors (topk · N < A, JAX's compact route), and every anchor
otherwise (JAX's all-anchor route). The oriented-box loss takes the same two routes by the same test,
as JAX's does: its slot table while topk · N < A, every anchor otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import math

from yolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, dist2rbox, make_anchors
from yolo_tpu_torch.ops.boxes import bbox_iou, probiou, xywh2xyxy
from yolo_tpu_torch.utils.metrics import OKS_SIGMA
from yolo_tpu_torch.utils.tal import RotatedTaskAlignedAssigner, TaskAlignedAssigner


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
    def _fg_slots(fg_mask, weight, max_slots: int, stable: bool = False):
        """The slot table: the indices of every foreground anchor, then background ones
        (B, M), and the slots' weights (B, M), zero on background. `stable` ranks by a stable
        sort, so equal weights keep the lowest anchor index first (jax.lax.top_k's order)."""
        key = torch.where(fg_mask, weight, -1.0)
        if stable:
            slot_idx = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :max_slots]
        else:
            slot_idx = torch.topk(key, max_slots, dim=1).indices
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
        loss_iou, loss_cls, loss_dfl, _ = self._terms(feats, batch)
        loss = torch.stack([loss_iou * self.hyp.box, loss_cls * self.hyp.cls, loss_dfl * self.hyp.dfl])
        return loss.sum() * feats[0].shape[0], loss.detach()

    def _terms(self, feats, batch, mask_slots: int = 0):
        """(loss_iou, loss_cls, loss_dfl, aux): `aux` holds the assigner's targets and foreground mask,
        the anchors and their strides, the box terms' slot table ('slot_idx', 'slot_fg'; 'compact' when
        it is smaller than the anchors) and the input size. With `mask_slots`, one stable ranking of the
        anchors serves the box slots and the top `mask_slots` foreground ones ('slots', 'slot_valid')."""
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
            _, target_bboxes, target_scores, fg_mask, target_gt_idx = self.assigner(
                scores, pred_bboxes * stride_tensor[None], anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt
            )
            target_scores_sum = target_scores.sum().clamp(min=1.0)
            weight = target_scores.sum(-1) * fg_mask.float()  # (B, A)
            aux = {"target_bboxes": target_bboxes, "target_gt_idx": target_gt_idx, "imgsz": (ih, iw), "fg_mask": fg_mask,
                   "anchor_points": anchor_points, "stride_tensor": stride_tensor, "compact": self.assigner.topk * gt_labels.shape[1] < a}
            if mask_slots:
                slot_full, s_fg_full, s_w_full = self._fg_slots(fg_mask, weight, min(max(M, mask_slots), a), stable=True)
                slot_idx, s_fg, s_w = slot_full[:, :M], s_fg_full[:, :M], s_w_full[:, :M]
                aux.update(slots=slot_full[:, :mask_slots], slot_valid=s_fg_full[:, :mask_slots])
            else:
                slot_idx, s_fg, s_w = self._fg_slots(fg_mask, weight, M)
            aux.update(slot_idx=slot_idx, slot_fg=s_fg)

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
        return loss_iou, loss_cls, loss_dfl, aux


class E2EDetectLoss:
    """The dual yolov10 criterion (JAX E2EDetectLoss): `v8DetectionLoss` with the assigner's topk 10 on the
    one-to-many outputs plus one with topk 1 on the one-to-one outputs (whose head inputs were detached) →
    (the summed total × B, the six detached components: box, cls, dfl of each branch)."""

    def __init__(self, model, hyp):
        self.one2many = v8DetectionLoss(model, hyp, tal_topk=10)
        self.one2one = v8DetectionLoss(model, hyp, tal_topk=1)

    def __call__(self, preds, batch):
        many, one = preds
        l_many, c_many = self.one2many(many, batch)
        l_one, c_one = self.one2one(one, batch)
        return l_many + l_one, torch.cat([c_many, c_one])


class v8SegmentationLoss(v8DetectionLoss):
    """The detection terms plus the prototype-mask BCE (JAX `v8SegmentationLoss`) over the top
    `max_fg` foreground anchors of each image by target score (the lowest index first on ties),
    each slot's ground truth taken from the overlap-index map (instance k drawn as k + 1) or,
    with per-instance masks (B, N, h, w), by its assigned ground truth; masks of another size
    than the prototypes are nearest-downsampled by stride. The BCE is cropped to the slot's
    target box, averaged over the map, divided by the box's area in mask pixels (at least 1),
    and averaged over the valid slots."""

    def __init__(self, model, hyp, tal_topk: int = 10, max_fg: int = 64):
        super().__init__(model, hyp, tal_topk)
        self.nm = model.head.nm
        self.max_fg = max_fg

    def __call__(self, preds, batch):
        """preds: (per-level raw box + class outputs, per-level coefficients (B, H, W, nm), protos
        (B, h, w, nm)); batch: the detection keys and 'masks' → (total × B, the detached (box, seg,
        cls, dfl) components (4,)), seg weighted by the box gain as in the JAX package."""
        feats, mask_outs, protos = preds
        B = feats[0].shape[0]
        slots = min(self.max_fg, sum(f.shape[1] * f.shape[2] for f in feats))
        loss_iou, loss_cls, loss_dfl, aux = self._terms(feats, batch, mask_slots=slots)
        slot_idx, slot_valid = aux["slots"], aux["slot_valid"]
        ih, iw = aux["imgsz"]
        mh, mw = protos.shape[1:3]
        gt_masks = batch["masks"].float()  # (B, h, w) overlap map, or (B, N, h, w) per instance
        if gt_masks.shape[-2:] != (mh, mw):
            sy, sx = gt_masks.shape[-2] // mh, gt_masks.shape[-1] // mw
            gt_masks = gt_masks[..., ::sy, ::sx][..., :mh, :mw]
        coefs = self._gather_levels([m.reshape(B, -1, self.nm).float() for m in mask_outs], slot_idx)  # (B, S, nm)
        tb = self._gather(aux["target_bboxes"], slot_idx)  # (B, S, 4) px
        tgi = torch.gather(aux["target_gt_idx"], 1, slot_idx)  # (B, S)
        if gt_masks.ndim == 4:
            gt_m = torch.gather(gt_masks, 1, tgi[..., None, None].expand(-1, -1, mh, mw))
        else:
            gt_m = (gt_masks[:, None] == (tgi + 1).float()[..., None, None]).float()
        pred_m = torch.einsum("bmn,bhn->bmh", coefs, protos.reshape(B, mh * mw, self.nm).float()).reshape(B, slots, mh, mw)
        mask_bce = pred_m.clamp(min=0) - pred_m * gt_m + torch.log1p(torch.exp(-pred_m.abs()))
        bx = tb * tb.new_tensor([mw, mh, mw, mh]) / tb.new_tensor([iw, ih, iw, ih])  # px → mask pixels, JAX's order
        ys = torch.arange(mh, dtype=torch.float32, device=tb.device)[:, None]
        xs = torch.arange(mw, dtype=torch.float32, device=tb.device)[None, :]
        b = bx[..., None, None, :]
        inside = (xs >= b[..., 0]) & (xs < b[..., 2]) & (ys >= b[..., 1]) & (ys < b[..., 3])
        area = (((tb[..., 2] - tb[..., 0]) / iw) * ((tb[..., 3] - tb[..., 1]) / ih) * mh * mw).clamp(min=1.0)
        per_slot = (mask_bce * inside).mean((-2, -1)) * (mh * mw) / area
        loss_seg = (per_slot * slot_valid).sum() / slot_valid.sum().clamp(min=1.0)
        h = self.hyp
        loss = torch.stack([loss_iou * h.box, loss_seg * h.box, loss_cls * h.cls, loss_dfl * h.dfl])
        return loss.sum() * B, loss.detach()


class v8PoseLoss(v8DetectionLoss):
    """The detection terms plus the keypoint terms (JAX `v8PoseLoss`): each foreground anchor's keypoints,
    decoded to grid units (raw · 2 + anchor − 0.5; the visibility stays a logit), against its assigned
    ground truth's: the OKS loss 1 − exp(−d² / ((2σ)² · 2 · area)) over the labelled keypoints, scaled by
    K / (labelled count) (`kpt_loss_factor`), and the keypoint-objectness BCE of the visibility logit against
    labelled or not; both summed over the foreground anchors and divided by their count × K. σ is COCO's
    OKS_SIGMA for (17, 3) keypoints, else 1 / K."""

    def __init__(self, model, hyp, tal_topk: int = 10):
        super().__init__(model, hyp, tal_topk)
        self.kpt_shape = tuple(model.head.kpt_shape)
        K = self.kpt_shape[0]
        self.sigmas = torch.tensor(OKS_SIGMA, dtype=torch.float32) if self.kpt_shape == (17, 3) else torch.ones(K) / K

    def __call__(self, preds, batch):
        """preds: (per-level raw box + class outputs, per-level raw keypoints (B, H, W, K · ndim)); batch: the
        detection keys and 'keypoints' (B, N, K, ndim), x and y normalized → (total × B, the detached (box,
        pose, kobj, cls, dfl) components (5,))."""
        feats, kpt_outs = preds
        B, dev = feats[0].shape[0], feats[0].device
        loss_iou, loss_cls, loss_dfl, aux = self._terms(feats, batch)
        K, ndim = self.kpt_shape
        ih, iw = aux["imgsz"]
        levels = [k.reshape(B, -1, K * ndim).float() for k in kpt_outs]
        gt = batch.get("keypoints")
        gt = torch.zeros((B, batch["cls"].shape[1], K, ndim), device=dev) if gt is None else gt.float()
        gt = gt * torch.tensor([iw, ih] + [1.0] * (ndim - 2), dtype=torch.float32, device=dev)
        n_fg = (aux["fg_mask"].float().sum() * K).clamp(min=1.0)
        anchors, strides, tb, tgi = aux["anchor_points"], aux["stride_tensor"], aux["target_bboxes"], aux["target_gt_idx"]
        if aux["compact"]:  # the slot table (B, topk · N)
            idx = aux["slot_idx"]
            kp, fg = self._gather_levels(levels, idx), aux["slot_fg"]
            anchors, strides = anchors[idx], strides[idx]
            tb, tgi = self._gather(tb, idx) / strides, torch.gather(tgi, 1, idx)
        else:  # every anchor
            kp, fg = torch.cat(levels, 1), aux["fg_mask"].float()
            anchors, strides = anchors[None], strides[None]
            tb = tb / strides
        kp = kp.reshape(*kp.shape[:2], K, ndim)
        kx = kp[..., 0] * 2.0 + (anchors[..., None, 0] - 0.5)
        ky = kp[..., 1] * 2.0 + (anchors[..., None, 1] - 0.5)
        sel = torch.gather(gt, 1, tgi.long()[..., None, None].expand(-1, -1, K, ndim))  # each anchor's gt keypoints
        sel_xy = sel[..., :2] / strides[..., None, :]
        kpt_mask = (sel[..., 2] != 0).float() if ndim == 3 else torch.ones(sel.shape[:-1], device=dev)
        d = (kx - sel_xy[..., 0]) ** 2 + (ky - sel_xy[..., 1]) ** 2
        area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1]))[..., None]
        e = d / ((2 * self.sigmas.to(dev)) ** 2 * (area + 1e-9) * 2)
        factor = K / (kpt_mask.sum(-1) + 1e-9)
        loss_pose = (factor[..., None] * (1.0 - torch.exp(-e)) * kpt_mask * fg[..., None]).sum() / n_fg
        if ndim == 3:
            kl = kp[..., 2]
            loss_kobj = ((kl.clamp(min=0) - kl * kpt_mask + torch.log1p(torch.exp(-kl.abs()))) * fg[..., None]).sum() / n_fg
        else:
            loss_kobj = torch.zeros((), device=dev)
        h = self.hyp
        loss = torch.stack([loss_iou * h.box, loss_pose * h.pose, loss_kobj * h.kobj, loss_cls * h.cls, loss_dfl * h.dfl])
        return loss.sum() * B, loss.detach()


class v8OBBLoss(v8DetectionLoss):
    """The oriented-box criterion (JAX `v8OBBLoss`): the rotated assigner, BCE classification, the
    probiou box term and the DFL term on the distances to the target's axis-aligned extent.

    batch['bboxes'] is (B, N, 5): normalized xywh and the angle in radians (a batch of background images, which
    collates as (B, N, 4), gets a zero angle; the JAX loss takes only (B, N, 5)). Boxes under 2 px on a side
    leave `mask_gt`, w scaled by the input's height and h by its width, the JAX package's order (the
    same on a square input). The angle is (sigmoid(raw) − 0.25) · π before the loss. While topk · N < A
    the box terms run on the slot table of the foreground anchors (the assigner's decode held out of the
    gradient); otherwise on every anchor, through the assigner's own decode."""

    def __init__(self, model, hyp, tal_topk: int = 10):
        super().__init__(model, hyp, tal_topk)
        self.assigner = RotatedTaskAlignedAssigner(topk=tal_topk, num_classes=self.nc, alpha=0.5, beta=6.0)

    def __call__(self, preds, batch):
        """preds: (per-level raw box + class outputs (B, H, W, no), per-level raw angles (B, H, W, 1));
        batch: 'cls' (B, N), 'bboxes' (B, N, 5), 'mask_gt' (B, N) → (total × B, the detached (box, cls, dfl)
        components (3,))."""
        feats, angle_outs = preds
        B, dev = feats[0].shape[0], feats[0].device
        flat = torch.cat([f.reshape(B, -1, self.no) for f in feats], 1)
        r4 = self.reg_max * 4
        pred_distri, pred_scores = flat[..., :r4].float(), flat[..., r4:].float()
        pred_angle = (torch.cat([a.reshape(B, -1, 1) for a in angle_outs], 1).float().sigmoid() - 0.25) * math.pi
        feat_shapes = [(f.shape[1], f.shape[2]) for f in feats]
        anchor_points, stride_tensor = make_anchors(feat_shapes, self.stride, 0.5, device=dev)
        ih, iw = feat_shapes[0][0] * self.stride[0], feat_shapes[0][1] * self.stride[0]
        proj = torch.arange(self.reg_max, dtype=torch.float32, device=dev)

        gt_labels = batch["cls"][..., None].long()
        raw = batch["bboxes"].float()
        if raw.shape[-1] == 4:  # a batch of background images collates as (B, N, 4)
            raw = torch.cat([raw, torch.zeros_like(raw[..., :1])], -1)
        scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
        gt_rboxes = torch.cat([raw[..., :4] * scale, raw[..., 4:5]], -1)
        big_enough = (raw[..., 2] * ih >= 2) & (raw[..., 3] * iw >= 2)
        mask_gt = (batch["mask_gt"].float() * big_enough.float())[..., None]
        gt_rboxes = gt_rboxes * mask_gt

        b, a, _ = pred_distri.shape
        M = self.assigner.topk * gt_labels.shape[1]
        compact = M < a
        with torch.no_grad():
            dist = (pred_distri.reshape(b, a, 4, self.reg_max).softmax(-1) * proj).sum(-1)
            tal_rboxes = torch.cat([dist2rbox(dist, pred_angle, anchor_points[None]), pred_angle], -1)  # grid units
            _, target_rboxes, target_scores, fg_mask, _ = self.assigner(
                pred_scores.sigmoid(), torch.cat([tal_rboxes[..., :4] * stride_tensor[None], tal_rboxes[..., 4:]], -1),
                anchor_points * stride_tensor, gt_labels, gt_rboxes, mask_gt,
            )
        target_scores_sum = target_scores.sum().clamp(min=1.0)
        bce = pred_scores.clamp(min=0) - pred_scores * target_scores + torch.log1p(torch.exp(-pred_scores.abs()))
        loss_cls = bce.sum() / target_scores_sum

        fg = fg_mask.float()
        weight = target_scores.sum(-1) * fg
        if compact:
            slot_idx, _, s_w = self._fg_slots(fg_mask, weight, M, stable=True)
            s_anchor, s_stride = anchor_points[slot_idx], stride_tensor[slot_idx]
            s_trb = self._gather(target_rboxes, slot_idx)
            s_tg = torch.cat([s_trb[..., :4] / s_stride, s_trb[..., 4:]], -1)
            s_distri = self._gather(pred_distri, slot_idx).reshape(b, M, 4, self.reg_max)
            s_angle = self._gather(pred_angle, slot_idx)
            s_dist = (s_distri.softmax(-1) * proj).sum(-1)
            s_pred = torch.cat([dist2rbox(s_dist, s_angle, s_anchor), s_angle], -1)
            loss_iou = ((1.0 - probiou(s_pred, s_tg)[..., 0]) * s_w).sum() / target_scores_sum
            dfl = _df_loss(s_distri, bbox2dist(s_anchor, xywh2xyxy(s_tg[..., :4]), self.reg_max - 1))
            loss_dfl = (dfl * s_w).sum() / target_scores_sum
        else:
            dist = (pred_distri.reshape(b, a, 4, self.reg_max).softmax(-1) * proj).sum(-1)
            pred_rboxes = torch.cat([dist2rbox(dist, pred_angle, anchor_points[None]), pred_angle], -1)
            target_g = torch.cat([target_rboxes[..., :4] / stride_tensor[None], target_rboxes[..., 4:]], -1)
            loss_iou = (((1.0 - probiou(pred_rboxes, target_g)[..., 0]) * weight) * fg).sum() / target_scores_sum
            target_ltrb = bbox2dist(anchor_points[None], xywh2xyxy(target_g[..., :4]), self.reg_max - 1)
            dfl = _df_loss(pred_distri.reshape(b, a, 4, self.reg_max), target_ltrb)
            loss_dfl = ((dfl * weight) * fg).sum() / target_scores_sum
        loss = torch.stack([loss_iou * self.hyp.box, loss_cls * self.hyp.cls, loss_dfl * self.hyp.dfl])
        return loss.sum() * B, loss.detach()
