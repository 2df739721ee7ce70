"""SAM2 video predictor: prompt one frame, propagate its mask (counterpart of yolo_tpu/models/sam/video.py).

Each frame runs encode → memory-conditioned features → SAM heads → memory encode → the bank's
update on the model's device; only the frame goes up and the mask logits come down.
"""

from __future__ import annotations

import numpy as np
import torch


class SAM2VideoPredictor:
    """Single-prompt-frame mask propagation over a SAM2Model whose weights are installed.

    >>> vp = SAM2VideoPredictor(model, num_frames=48)
    >>> vp.add_prompt(first_frame_rgb, points=[[320, 240]], labels=[1])
    >>> masks, scores = vp.propagate(frames[1:])

    `reverse=True` propagates backward in time from the prompt frame (feed the frames in reverse order); the
    temporal encodings need no change for it, as in JAX. Frames are (H, W, 3) or (B, H, W, 3) RGB at img_size."""

    def __init__(self, model, num_frames: int, reverse: bool = False):
        self.model = model
        self.num_frames = num_frames
        self.reverse = reverse
        self.bank = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _batch(self, frame) -> torch.Tensor:
        frame = torch.as_tensor(np.asarray(frame)).to(self.device)
        frame = frame[None] if frame.ndim == 3 else frame
        s = self.model.img_size
        if tuple(frame.shape[1:3]) != (s, s):
            raise ValueError(f"video frames must be {s}x{s} (the model's img_size), got {tuple(frame.shape[1:3])}")
        return frame

    @torch.no_grad()
    def _init_step(self, frame, point_coords, point_labels, multimask: bool):
        """The conditioning frame: encode, prompt, seed the bank (no memory attention: + no_mem_embed)."""
        m = self.model
        embed, high_res = m.encode_frame(frame)
        pix = embed + m.no_mem_embed.reshape(1, 1, 1, -1)
        out = m.forward_sam_heads(pix, high_res, point_coords, point_labels, multimask_output=multimask)
        mem_feat, _ = m.encode_new_memory(embed, out["high_res_masks"][:, 0, :, :, None], out["object_score_logits"])
        bank = m.update_memory_bank(m.init_memory_bank(B=frame.shape[0]), mem_feat, out["obj_ptr"], is_cond=True)
        return out["high_res_masks"], out["object_score_logits"], bank

    @torch.no_grad()
    def _track_frame(self, bank, frame):
        """A tracked frame: multimask with the best-IoU pick (no clicks on it)."""
        m = self.model
        bank = dict(bank, frame_idx=bank["frame_idx"] + 1)
        embed, high_res = m.encode_frame(frame)
        pix = m.prepare_memory_conditioned_features(embed, bank, self.num_frames, reverse=self.reverse)
        out = m.forward_sam_heads(pix, high_res, multimask_output=True)
        mem_feat, _ = m.encode_new_memory(embed, out["high_res_masks"][:, 0, :, :, None], out["object_score_logits"])
        bank = m.update_memory_bank(bank, mem_feat, out["obj_ptr"], is_cond=False)
        return out["high_res_masks"], out["object_score_logits"], bank

    def add_prompt(self, frame, points=None, labels=None, box=None):
        """Prompt the conditioning frame with clicks (pixels) and / or a box (its corners as labels 2 / 3, before
        the clicks); multimask only with at most one click. → (mask logits (B, H, W), object score (B, 1))."""
        frame = self._batch(frame)
        pts_list, lab_list = [], []
        if box is not None:
            box = np.asarray(box, np.float32).reshape(-1, 4)
            pts_list.append(box.reshape(-1, 2, 2))
            lab_list.append(np.tile(np.array([[2, 3]], np.int64), (box.shape[0], 1)))
        if points is not None:
            pts_list.append(np.asarray(points, np.float32).reshape(frame.shape[0], -1, 2))
            lab_list.append(np.asarray(labels, np.int64).reshape(frame.shape[0], -1))
        if not pts_list:
            raise ValueError("add_prompt needs points and/or box")
        pts = np.concatenate(pts_list, axis=1)
        lab = np.concatenate(lab_list, axis=1)
        masks, scores, self.bank = self._init_step(frame, torch.from_numpy(pts).to(self.device),
                                                   torch.from_numpy(lab).to(self.device), pts.shape[1] <= 1)
        return masks[:, 0].float().cpu().numpy(), scores.float().cpu().numpy()

    def track(self, frame):
        """The next frame → (mask logits (B, H, W), object score (B, 1))."""
        if self.bank is None:
            raise RuntimeError("call add_prompt() on the conditioning frame first")
        masks, scores, self.bank = self._track_frame(self.bank, self._batch(frame))
        return masks[:, 0].float().cpu().numpy(), scores.float().cpu().numpy()

    def propagate(self, frames):
        """(T, H, W, 3) frames → ((T, B, H, W) mask logits, (T, B, 1) scores)."""
        out = [self.track(f) for f in frames]
        return np.stack([m for m, _ in out]), np.stack([s for _, s in out])
