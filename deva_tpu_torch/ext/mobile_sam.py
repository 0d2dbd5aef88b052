"""MobileSAM and Light-HQ-SAM behind the detector protocols, on the card.

Port of deva_tpu/ext/jax_sam.py (JaxMobileSAM): the TinyViT image encoder
(ext/tiny_vit.py) and the SAM prompt encoder and mask decoder
(ext/sam_decoder.py) behind the same two protocols as the HF detectors
(ext/detectors.py):

  masks_for_boxes(image_np, boxes) -> [N, H, W] bool     (text pipeline)
  generate(image_np, positive_points) -> {masks, iou_preds} (automatic)

Everything from the uint8 frame to the hard masks runs on the module's
device (`cuda` unless the caller asks for the CPU), under
torch.inference_mode(); the hard masks and IoUs come back to the host for
the fusion. The resizes are ops/resize.py's antialiased bilinear ones:
the frame's resize to the 1024 square follows PIL's uint8 passes (within
one level of deva_tpu's PIL resize), the logits' resizes follow
jax.image.resize. generate post-processes each decoder batch on its own
(the masks are independent), so a grid of 64 points per side holds one
batch of full-size logits at a time.

Weights: MobileSAM.from_checkpoint loads a released `mobile_sam.pt` or
`sam_hq_vit_tiny.pth` (the original segment_anything layout, strict) or a
deva_tpu .npz (scripts/convert_sam_checkpoint.py; ext/convert.py); without
one, init_sam_weights gives seeded random weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deva_tpu_torch.ext.sam_decoder import (SamDecoder, SamDecoderConfig,
                                            init_sam_weights)
from deva_tpu_torch.ext.tiny_vit import TinyViT
from deva_tpu_torch.ops.resize import resize_bilinear_aa, resize_image_uint8

# SAM's pixel statistics (deva_tpu/ext/jax_sam.py:34-35)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

# keys of a released MobileSAM checkpoint that the SAM encoder never runs:
# TinyViT's classifier head (tiny_vit.py's header)
UNUSED_KEYS = ("image_encoder.norm_head.", "image_encoder.head.")


class MobileSamNet(SamDecoder):
    """The whole network in the original layout: image_encoder (TinyViT),
    prompt_encoder and mask_decoder (SamDecoder, HQ with hq=True)."""

    def __init__(self, hq: bool = False):
        super().__init__(SamDecoderConfig(hq=hq))
        self.image_encoder = TinyViT()


def grid_points(n: int) -> np.ndarray:
    """The n x n grid of normalized (x, y) point prompts, row by row."""
    offset = 1 / (2 * n)
    side = np.linspace(offset, 1 - offset, n)
    xs, ys = np.meshgrid(side, side)
    return np.stack([xs.ravel(), ys.ravel()], -1)


class MobileSAM:
    def __init__(self, state_dict: Optional[Dict] = None, *,
                 points_per_side: int = 32, points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88, nms_iou: float = 0.7,
                 seed: int = 0, hq: bool = False, device="cuda"):
        """hq=True builds Light-HQ-SAM: the decoder's HQ token and fusion,
        fed by TinyViT's early features. state_dict: the network's weights
        in the original layout (strict); None for a seeded random init."""
        self.hq = hq
        self.device = torch.device(device)
        self.net = MobileSamNet(hq)
        if state_dict is None:
            init_sam_weights(self.net, seed)
        else:
            self.net.load_state_dict(state_dict, strict=True)
        self.net = self.net.to(self.device).eval()
        self.cfg = self.net.cfg
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.nms_iou = nms_iou
        self._mean = torch.tensor(PIXEL_MEAN, device=self.device)
        self._std = torch.tensor(PIXEL_STD, device=self.device)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, *, hq: bool = False,
                        **kwargs) -> "MobileSAM":
        """A released MobileSAM (`mobile_sam.pt`) or Light-HQ-SAM
        (`sam_hq_vit_tiny.pth`) checkpoint in the original segment_anything
        layout, or a deva_tpu JaxMobileSAM .npz."""
        if ckpt_path.endswith(".npz"):
            from deva_tpu_torch.ext.convert import variables_to_state_dict
            with np.load(ckpt_path) as npz:
                sd = variables_to_state_dict(dict(npz))
        else:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            sd = sd.get("model", sd)
            sd = {k: v for k, v in sd.items() if not k.startswith(UNUSED_KEYS)}
        return cls(sd, hq=hq, **kwargs)

    # -- pre/post-processing --------------------------------------------------

    def _preprocess(self, image_np: np.ndarray):
        """uint8 RGB [H, W, 3] -> the padded normalized square [1, 3, S, S]
        on the device, (nh, nw), scale: the longest side resized to S
        (segment_anything's ResizeLongestSide), bottom/right zero pad."""
        h, w = image_np.shape[:2]
        size = self.cfg.image_size
        scale = size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        img = torch.from_numpy(np.array(image_np, np.uint8)).to(self.device)
        img = resize_image_uint8(img, (nh, nw)).float()
        img = ((img - self._mean) / self._std).permute(2, 0, 1)
        img = torch.nn.functional.pad(img, (0, size - nw, 0, size - nh))
        return img[None], (nh, nw), scale

    def _embed(self, image_np: np.ndarray):
        """-> (embeddings [1, 256, 64, 64], decoder kwargs, (nh, nw),
        scale); in hq mode the kwargs carry TinyViT's early features."""
        x, (nh, nw), scale = self._preprocess(image_np)
        out = self.net.image_encoder(x, return_interm=self.hq)
        if self.hq:
            emb, interm = out
            return emb, dict(intermediate_embeddings=interm), (nh, nw), scale
        return out, {}, (nh, nw), scale

    def _decode(self, emb, dec_kw, **prompts):
        """The decoder with multimask_output -> (logits [1, P, 3, 256,
        256], IoUs [1, P, 3])."""
        return self.net(emb, multimask_output=True, **prompts, **dec_kw)

    def _masks_to_original(self, logits: torch.Tensor, nh: int, nw: int,
                           h: int, w: int) -> torch.Tensor:
        """[..., 256, 256] logits over the padded square -> [..., h, w]:
        upscale to the square, crop the pad, resize to the frame (the
        second resize shrinks, antialiased, as jax.image.resize does), in
        f32 as jax.image.resize computes."""
        size = self.cfg.image_size
        up = resize_bilinear_aa(logits, (size, size),
                                torch.float32)[..., :nh, :nw]
        return resize_bilinear_aa(up, (h, w), torch.float32)

    @staticmethod
    def _best(masks, ious):
        """The best of the 3 masks per prompt: -> ([P, 256, 256], [P])."""
        best = ious.argmax(-1)
        rows = torch.arange(len(best), device=best.device)
        return masks[rows, best], ious[rows, best]

    # -- detector protocols ---------------------------------------------------

    @torch.inference_mode()
    def masks_for_boxes(self, image_np: np.ndarray,
                        boxes: np.ndarray) -> np.ndarray:
        """Best-of-3 masks per (x1, y1, x2, y2) box -> [N, H, W] bool."""
        h, w = image_np.shape[:2]
        if len(boxes) == 0:
            return np.zeros((0, h, w), bool)
        emb, dec_kw, (nh, nw), scale = self._embed(image_np)
        boxes_r = torch.as_tensor(np.asarray(boxes, np.float32) * scale,
                                  device=self.device)[None]
        masks, ious = self._decode(emb, dec_kw, boxes=boxes_r)
        sel, _ = self._best(masks[0], ious[0])
        return (self._masks_to_original(sel, nh, nw, h, w) > 0.0) \
            .cpu().numpy()

    @torch.inference_mode()
    def generate(self, image_np: np.ndarray,
                 positive_points: Optional[np.ndarray] = None) -> Dict:
        """Grid (or supplied normalized) point prompts -> best mask per
        point -> predicted-IoU filter -> mask NMS; the contract of
        HFAutomaticSAM.generate."""
        from deva_tpu_torch.ext.detectors import _mask_nms
        h, w = image_np.shape[:2]
        pts = grid_points(self.points_per_side) if positive_points is None \
            else np.asarray(positive_points, np.float32)
        empty = {"masks": np.zeros((0, h, w), np.float32),
                 "iou_preds": np.zeros((0,), np.float32)}
        if len(pts) == 0:
            return empty
        emb, dec_kw, (nh, nw), scale = self._embed(image_np)
        pts_r = pts * np.array([w, h], np.float32) * scale

        all_masks, all_ious = [], []
        for i in range(0, len(pts_r), self.points_per_batch):
            chunk = pts_r[i:i + self.points_per_batch]
            points = torch.as_tensor(chunk, dtype=torch.float32,
                                     device=self.device)[None, :, None, :]
            labels = torch.ones((1, len(chunk), 1), device=self.device)
            masks, ious = self._decode(emb, dec_kw, points=points,
                                       labels=labels)
            sel, iou = self._best(masks[0], ious[0])
            keep = iou >= self.pred_iou_thresh
            if bool(keep.any()):
                hard = self._masks_to_original(sel[keep], nh, nw, h, w) > 0.0
                all_masks.append(hard.cpu().numpy())
                all_ious.append(iou[keep].cpu().numpy())
        if not all_masks:
            return empty
        masks = np.concatenate(all_masks)
        ious = np.concatenate(all_ious).astype(np.float32)
        keep = _mask_nms(masks, ious, self.nms_iou)
        return {"masks": masks[keep].astype(np.float32),
                "iou_preds": ious[keep]}
