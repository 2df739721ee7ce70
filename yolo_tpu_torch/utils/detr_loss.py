"""The DETR loss of RT-DETR training (counterpart of yolo_tpu/utils/detr_loss.py).

`hungarian_match` is the optimal one-to-one assignment of queries to labels, image by image, on the host (numpy
and scipy's linear_sum_assignment over the detached predictions, as in the JAX package); `DETRLoss` scores one layer
against that assignment on the device (focal or varifocal class loss, L1 and GIoU box losses over the matched
pairs); `RTDETRDetectionLoss` stacks the encoder's selected queries ahead of the decoder layers, matches each on its
own and adds the denoising queries' terms under their fixed positional match (block g slot j ↔ label slot j),
divided by the number of groups. The host match is the step's one wait for the device before the backward.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tpu_torch.ops.boxes import bbox_iou


def hungarian_match(pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt, cost_gain=None, alpha: float = 0.25,
                    gamma: float = 2.0):
    """Per image the optimal assignment (JAX `hungarian_match`): cost 2 · focal class cost + 5 · L1 + 2 · (1 - GIoU)
    of (B, Nq, 4) normalized xywh boxes and (B, Nq, nc) logits against the (B, N, 4) labels of `gt_cls` (B, N) where
    `mask_gt` (B, N) is set (non-finite costs read 0) → src_idx (B, N) int32, the query of each label row (0 for
    padding), valid (B, N) f32. Inputs are host arrays (numpy or CPU tensors)."""
    from scipy.optimize import linear_sum_assignment

    pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt = (
        np.asarray(a) for a in (pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt))
    cost_gain = cost_gain or {"class": 2, "bbox": 5, "giou": 2}
    B, Nq, nc = pred_scores.shape
    N = gt_bboxes.shape[1]
    src_idx = np.zeros((B, N), np.int32)
    valid = np.zeros((B, N), np.float32)
    prob = 1.0 / (1.0 + np.exp(-pred_scores))
    for b in range(B):
        m = mask_gt[b] > 0
        if not m.any():
            continue
        gb = gt_bboxes[b][m]
        ps = prob[b][:, gt_cls[b][m].astype(np.int64)]  # (Nq, n)
        neg = (1 - alpha) * (ps**gamma) * (-np.log(1 - ps + 1e-8))
        pos = alpha * ((1 - ps) ** gamma) * (-np.log(ps + 1e-8))
        cost_bbox = np.abs(pred_bboxes[b][:, None] - gb[None]).sum(-1)
        giou = bbox_iou(torch.from_numpy(np.ascontiguousarray(pred_bboxes[b][:, None])),
                        torch.from_numpy(np.ascontiguousarray(gb[None])), xywh=True, GIoU=True).numpy()
        cost = cost_gain["class"] * (pos - neg) + cost_gain["bbox"] * cost_bbox + cost_gain["giou"] * (1.0 - giou)
        cost = np.where(np.isfinite(cost), cost, 0.0)
        qi, gj = linear_sum_assignment(cost)
        rows = np.where(m)[0]
        src_idx[b, rows[gj]] = qi
        valid[b, rows[gj]] = 1.0
    return src_idx, valid


class DETRLoss:
    """One layer's loss over matched query / label pairs (JAX `DETRLoss`): the class loss over every query (targets
    one-hot at the matched queries; focal, or with `use_vfl` varifocal with the matched IoU as the target score),
    normalized by the matched count · Nq, and the L1 and GIoU losses of the matched boxes over the matched count,
    scaled by `loss_gain` (class 1, bbox 5, giou 2)."""

    def __init__(self, nc: int, loss_gain=None, alpha: float = 0.25, gamma: float = 1.5, use_vfl: bool = False):
        self.nc = nc
        self.loss_gain = loss_gain or {"class": 1, "bbox": 5, "giou": 2}
        self.alpha, self.gamma, self.use_vfl = alpha, gamma, use_vfl

    def __call__(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt, src_idx, match_valid) -> dict:
        """(B, Nq, 4) normalized xywh boxes and (B, Nq, nc) logits; the padded labels; src_idx (B, N) and
        match_valid (B, N) of the matcher → {loss_class, loss_bbox, loss_giou}, 0-d tensors."""
        B, Nq, nc = pred_scores.shape
        num_gts = match_valid.sum().clamp(min=1.0)
        one_hot_t = F.one_hot(gt_cls.long(), nc).to(pred_scores.dtype)  # (B, N, nc)
        q_onehot = F.one_hot(src_idx.long(), Nq).to(pred_scores.dtype) * match_valid[..., None]  # (B, N, Nq)
        targets = torch.einsum("bnq,bnc->bqc", q_onehot, one_hot_t)
        pb = torch.gather(pred_bboxes, 1, src_idx.long()[..., None].expand(-1, -1, 4))  # (B, N, 4)
        p = torch.sigmoid(pred_scores)
        bce = pred_scores.clamp(min=0) - pred_scores * targets + torch.log1p(torch.exp(-pred_scores.abs()))
        if self.use_vfl:
            iou_m = bbox_iou(pb.detach(), gt_bboxes, xywh=True) * match_valid
            gt_scores = torch.einsum("bnq,bn->bq", q_onehot, iou_m)
            gt_map = gt_scores[..., None] * targets
            weight = self.alpha * p**self.gamma * (1 - targets) + gt_map * targets
            bce = pred_scores.clamp(min=0) - pred_scores * gt_map + torch.log1p(torch.exp(-pred_scores.abs()))
            loss_cls = (bce * weight).mean(1).sum() / num_gts * Nq
        else:
            p_t = targets * p + (1 - targets) * (1 - p)
            alpha_f = targets * self.alpha + (1 - targets) * (1 - self.alpha)
            loss_cls = (bce * (1.0 - p_t) ** self.gamma * alpha_f).mean(1).sum() / num_gts * Nq
        loss_bbox = ((pb - gt_bboxes).abs().sum(-1) * match_valid).sum() / num_gts
        loss_giou = ((1.0 - bbox_iou(pb, gt_bboxes, xywh=True, GIoU=True)) * match_valid).sum() / num_gts
        g = self.loss_gain
        return {"loss_class": loss_cls * g["class"], "loss_bbox": loss_bbox * g["bbox"], "loss_giou": loss_giou * g["giou"]}


class RTDETRDetectionLoss:
    """The RT-DETR criterion (JAX `RTDETRDetectionLoss`) of the decoder's train outputs (boxes (L, B, Q, 4), logits
    (L, B, Q, nc), the encoder's selected boxes and logits): the encoder's queries as layer 0 ahead of the L decoder
    layers, each matched on its own on the host and scored by a varifocal DETRLoss; where the batch carries `dn_cls`
    the first D = dn_cls.shape[1] queries of each decoder layer are the denoising ones, scored per group g on the
    positive block g and the negative block G + g joined, under the fixed match of slot j to label j, each group's
    terms over G. → (the total, (giou, cls, l1) of the last decoder layer, detached). `match_s` holds the last
    call's host match time."""

    def __init__(self, model, hyp=None):
        self.nc = model.nc
        self.layer_loss = DETRLoss(nc=model.nc, use_vfl=True)
        self.match_s = 0.0

    def __call__(self, preds, batch: dict):
        dec_bboxes, dec_scores, enc_bboxes, enc_scores = preds
        dn_b = dn_s = None
        if "dn_cls" in batch:
            D = batch["dn_cls"].shape[1]
            dn_b, dec_bboxes = dec_bboxes[:, :, :D], dec_bboxes[:, :, D:]
            dn_s, dec_scores = dec_scores[:, :, :D], dec_scores[:, :, D:]
        all_b = torch.cat([enc_bboxes[None], dec_bboxes], 0).float()
        all_s = torch.cat([enc_scores[None], dec_scores], 0).float()
        L, B = all_b.shape[:2]
        gt_bboxes = batch["bboxes"].float()
        gt_cls = batch["cls"].reshape(gt_bboxes.shape[:2])
        mask_gt = batch["mask_gt"].float().reshape(gt_bboxes.shape[:2])
        N = gt_bboxes.shape[1]

        t0 = time.perf_counter()
        pb, ps = all_b.detach().cpu().numpy(), all_s.detach().cpu().numpy()  # the wait for the forward
        gb, gc, gm = (t.detach().cpu().numpy() for t in (gt_bboxes, gt_cls, mask_gt))
        src = np.zeros((L, B, N), np.int32)
        val = np.zeros((L, B, N), np.float32)
        for i in range(L):
            src[i], val[i] = hungarian_match(pb[i], ps[i], gb, gc, gm)
        self.match_s = time.perf_counter() - t0
        dev = all_b.device
        src, val = torch.from_numpy(src).to(dev), torch.from_numpy(val).to(dev)

        total, main = 0.0, None
        for i in range(L):
            d = self.layer_loss(all_b[i], all_s[i], gt_bboxes, gt_cls, mask_gt, src[i], val[i])
            total = total + d["loss_class"] + d["loss_bbox"] + d["loss_giou"]
            if i == L - 1:
                main = d
        if dn_b is not None:
            G = dn_b.shape[2] // (2 * N)
            pos_src = torch.arange(N, dtype=torch.int32, device=dev)[None].expand(B, N)
            for i in range(dn_b.shape[0]):
                for g in range(G):
                    blocks = (slice(g * N, (g + 1) * N), slice((G + g) * N, (G + g + 1) * N))
                    pb_g = torch.cat([dn_b[i][:, s] for s in blocks], 1).float()
                    ps_g = torch.cat([dn_s[i][:, s] for s in blocks], 1).float()
                    d = self.layer_loss(pb_g, ps_g, gt_bboxes, gt_cls, mask_gt, pos_src, mask_gt)
                    total = total + (d["loss_class"] + d["loss_bbox"] + d["loss_giou"]) / G
        comps = torch.stack([main["loss_giou"], main["loss_class"], main["loss_bbox"]]).detach()
        return total, comps
