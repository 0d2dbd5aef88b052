"""The port's transformers-SAM detectors (ext/detectors.py: HFAutomaticSAM.
generate and HFGroundedSAM.masks_for_boxes) against deva_tpu's, with one
tiny config-built transformers SamModel (random init, no weight downloads;
the vision encoder cut to one narrow layer, as tests/test_sam_decoder.py
does, and every width 32) and a default SamImageProcessor, device "cpu" on both sides.

The port post-processes the masks (F.interpolate to the padded square, the
crop, F.interpolate to the frame, > 0) on the model's device and brings
only the chosen masks to the host; deva_tpu post-processes on the host.
Both run the same torch operations on the same tensors, so the masks and
the IoUs must be equal exactly; and the port's post-processing must be
handed the model's own logits, not a host copy of them, and bring to the
host only chosen masks at the frame's size (a spy on .cpu() of the logits
and of every tensor computed from them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from deva_tpu.ext import detectors as jax_det

from deva_tpu_torch.ext import detectors as det

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_sam():
    from transformers import (SamConfig, SamImageProcessor, SamModel,
                              SamProcessor)
    torch.manual_seed(0)
    cfg = SamConfig()
    cfg.vision_config.num_hidden_layers = 1
    cfg.vision_config.hidden_size = 32
    cfg.vision_config.num_attention_heads = 2
    cfg.vision_config.global_attn_indexes = [0]
    # and every width 32 (the encoder's neck, the prompt encoder and the
    # decoder share it), so that the file stays well inside a minute
    cfg.vision_config.output_channels = 32
    cfg.vision_config.num_pos_feats = 16
    cfg.prompt_encoder_config.hidden_size = 32
    cfg.mask_decoder_config.hidden_size = 32
    cfg.mask_decoder_config.mlp_dim = 64
    return SamModel(cfg).eval(), SamProcessor(SamImageProcessor())


def _automatic(package, tiny_sam, thresh):
    g = package.HFAutomaticSAM.__new__(package.HFAutomaticSAM)
    g.torch, g.device = torch, "cpu"
    g.model, g.processor = tiny_sam
    g.points_per_side, g.points_per_batch = 4, 8  # two batches
    g.pred_iou_thresh, g.nms_iou = thresh, 0.7
    return g


def _grounded(package, tiny_sam):
    d = package.HFGroundedSAM.__new__(package.HFGroundedSAM)
    d.torch, d.device = torch, "cpu"
    d.sam_model, d.sam_processor = tiny_sam
    d.gd_model = d.gd_processor = d.mask_source = None
    return d


def _frame():
    img = np.random.default_rng(3).integers(0, 256, (60, 90, 3)) \
        .astype(np.uint8)
    img[10:40, 20:60] = [200, 40, 40]
    return img


def _spy_post_process(processor, seen):
    """Record, for each post_process_masks call, whether it was handed the
    model's own pred_masks tensor."""
    ip = processor.image_processor
    real = ip.post_process_masks

    def spy(masks, *a, **k):
        seen.append(masks)
        return real(masks, *a, **k)

    ip.post_process_masks = spy
    return lambda: delattr(ip, "post_process_masks")


class Watched(torch.Tensor):
    """The model's logits, and every tensor computed from them: records the
    shape of each one copied to the host."""
    copied = []

    def cpu(self, *a, **k):
        Watched.copied.append(tuple(self.shape))
        return super().cpu(*a, **k)


def _spy_model(model, outputs):
    """Record the model's outputs, their logits Watched."""
    real = model.forward

    def forward(*a, **k):
        out = real(*a, **k)
        out.pred_masks = out.pred_masks.as_subclass(Watched)
        outputs.append(out)
        return out

    Watched.copied = []
    model.forward = forward
    return lambda: delattr(model, "forward")


def _check_copies(seen, outputs, frame_shape):
    """Post-processing was handed the model's own logits, and what came to
    the host from them is chosen masks at the frame's size, never the
    logits or all of a prompt's masks."""
    assert len(seen) == len(outputs)
    assert all(m is o.pred_masks for m, o in zip(seen, outputs))
    assert Watched.copied
    for shape in Watched.copied:
        assert len(shape) <= 3 and shape[-2:] == frame_shape, shape


@pytest.mark.parametrize("positive", [False, True], ids=["grid", "points"])
def test_hf_automatic_generate_matches(tiny_sam, positive):
    img = _frame()
    points = np.array([[0.3, 0.4], [0.5, 0.5], [0.8, 0.2]], np.float32) \
        if positive else None
    everything = _automatic(jax_det, tiny_sam, -np.inf).generate(img, points)
    # a threshold that keeps about half the prompts' best masks
    middle = float(np.median(everything["iou_preds"]))
    for thresh in (-np.inf, middle):
        want = _automatic(jax_det, tiny_sam, thresh).generate(img, points)
        seen, outputs = [], []
        undo = [_spy_post_process(tiny_sam[1], seen),
                _spy_model(tiny_sam[0], outputs)]
        try:
            got = _automatic(det, tiny_sam, thresh).generate(img, points)
        finally:
            for u in undo:
                u()
        assert len(seen) == (1 if positive else 2)
        _check_copies(seen, outputs, img.shape[:2])
        assert got["masks"].dtype == want["masks"].dtype == np.float32
        assert got["masks"].shape == want["masks"].shape
        assert got["masks"].shape[1:] == img.shape[:2]
        assert np.array_equal(got["masks"], want["masks"])
        assert np.array_equal(got["iou_preds"], want["iou_preds"])
        if thresh == middle:
            assert 0 < len(got["iou_preds"]) < len(everything["iou_preds"])


def test_hf_grounded_masks_for_boxes_matches(tiny_sam):
    img = _frame()
    boxes = np.array([[20, 10, 60, 40], [0, 0, 45, 59], [50, 30, 89, 55]],
                     np.float32)
    want = _grounded(jax_det, tiny_sam).masks_for_boxes(img, boxes)
    seen, outputs = [], []
    undo = [_spy_post_process(tiny_sam[1], seen),
            _spy_model(tiny_sam[0], outputs)]
    try:
        got = _grounded(det, tiny_sam).masks_for_boxes(img, boxes)
    finally:
        for u in undo:
            u()
    assert len(seen) == len(boxes)
    _check_copies(seen, outputs, img.shape[:2])
    assert got.dtype == want.dtype == bool
    assert got.shape == want.shape == (3, *img.shape[:2])
    assert np.array_equal(got, want)
