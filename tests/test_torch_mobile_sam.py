"""deva_tpu_torch's MobileSAM (ext/mobile_sam.py) against deva_tpu's
JaxMobileSAM on the same seeded weights, and the resizes that replace PIL
and jax.image.resize (ops/resize.py) against deva_tpu's.

The weights: a seeded port network at MobileSAM's full widths and depths,
saved as a .pt in the original segment_anything layout, loaded by both
MobileSAM.from_checkpoint and deva_tpu's JaxMobileSAM.from_torch_checkpoint
(and by the port again from a deva_tpu .npz,
tests/test_torch_mobile_sam_hq.py). Frames from a numpy seed at 240x320
(SAM's input grown to 768x1024) and 480x854 (576x1024).

Tolerances, and why:
- uint8 resizes (SAM's input, get_input_frame_for_deva): equal to PIL's
  (ops/resize.py:resize_image_uint8 applies PIL's fixed-point taps), so
  the normalized inputs within 1e-6.
- float masks (detectors._resize_bilinear) within 1e-5 of PIL's mode "F";
  logits (_masks_to_original) within 3e-4 of jax.image.resize's on
  N(0, 1) logits (its f32 taps are off by ~3e-5 of a tap at 1024 wide;
  measured 1.2e-4).
- embeddings within 1e-4 (f32 summation order through TinyViT).
- logits at the frame's size within 1e-2 (the embeddings' differences
  through the decoder and the resizes); hard masks equal except where
  deva_tpu's logit lies within 1e-2 of the 0 threshold; predicted IoUs
  within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deva_tpu.ext.jax_sam import JaxMobileSAM

from deva_tpu_torch.ext.mobile_sam import MobileSAM

torch.set_num_threads(2)

SIZES = [(240, 320), (480, 854)]
LOGIT_TOL = 1e-2
KW = dict(points_per_side=4, pred_iou_thresh=-1e9, nms_iou=0.7)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    net = MobileSAM(device="cpu", seed=11).net
    path = str(tmp_path_factory.mktemp("sam") / "mobile_sam.pt")
    torch.save(net.state_dict(), path)
    return net.state_dict(), path


def _memo_embed(sam):
    """Keep each frame's _embed result on the instance: the tests call the
    encoder on the same few frames many times (the file stays well inside
    a minute); what is compared is unchanged."""
    embed, memo = sam._embed, {}

    def cached(image_np):
        key = (image_np.shape, image_np.tobytes())
        if key not in memo:
            memo[key] = embed(image_np)
        return memo[key]

    sam._embed = cached
    return sam


@pytest.fixture(scope="module")
def sams(checkpoint):
    sd, path = checkpoint
    ours = MobileSAM.from_checkpoint(path, device="cpu", **KW)
    for k, v in ours.net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    return (_memo_embed(ours),
            _memo_embed(JaxMobileSAM.from_torch_checkpoint(path, **KW)))


def _frame(h, w):
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 6:h // 2, w // 5:w // 2] = [200, 40, 40]
    return img


def _boxes(h, w):
    return np.array([[w * 0.2, h * 0.15, w * 0.5, h * 0.5],
                     [10, 10, w * 0.3, h * 0.4],
                     [w * 0.5, h * 0.5, w - 5, h - 5]], np.float32)


@pytest.mark.parametrize("h,w", SIZES)
def test_preprocess_matches_pil(sams, h, w):
    ours, ref = sams
    img = _frame(h, w)
    x, shape, scale = ours._preprocess(img)
    want, want_shape, want_scale = ref._preprocess(img)
    assert shape == want_shape and scale == want_scale
    np.testing.assert_allclose(x[0].permute(1, 2, 0).numpy(),
                               np.asarray(want[0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w", SIZES)
def test_embeddings_match(sams, h, w):
    ours, ref = sams
    img = _frame(h, w)
    want, _, _, _ = ref._embed(img)
    with torch.inference_mode():
        got, _, _, _ = ours._embed(img)
        # deva_tpu's own input: the network alone
        x = torch.from_numpy(np.asarray(ref._preprocess(img)[0])
                             .transpose(0, 3, 1, 2).copy())
        same_input = ours.net.image_encoder(x)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(same_input.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _logits_for_boxes(sam, img, boxes, port):
    """The best-of-3 logits at the frame's size (masks_for_boxes before
    its threshold)."""
    h, w = img.shape[:2]
    if port:
        with torch.inference_mode():
            emb, kw, (nh, nw), scale = sam._embed(img)
            masks, ious = sam._decode(emb, kw, boxes=torch.from_numpy(
                boxes * scale)[None])
            sel, _ = sam._best(masks[0], ious[0])
            return sam._masks_to_original(sel, nh, nw, h, w).numpy()
    emb, kw, (nh, nw), scale = sam._embed(img)
    masks, ious = sam._dec_boxes(sam.variables["decoder"], emb,
                                 boxes=jnp.asarray(boxes * scale)[None],
                                 **kw)
    masks, ious = np.asarray(masks[0]), np.asarray(ious[0])
    sel = masks[np.arange(len(boxes)), ious.argmax(-1)]
    return sam._masks_to_original(sel, nh, nw, h, w)


def _check_boxes(ours, ref, h, w):
    img, boxes = _frame(h, w), _boxes(h, w)
    tol = LOGIT_TOL
    got = _logits_for_boxes(ours, img, boxes, True)
    want = _logits_for_boxes(ref, img, boxes, False)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    masks = ours.masks_for_boxes(img, boxes)
    want_masks = ref.masks_for_boxes(img, boxes)
    assert masks.shape == (3, h, w) and masks.dtype == bool
    assert not ((masks != want_masks) & (np.abs(want) > tol)).any()
    assert ours.masks_for_boxes(img, np.zeros((0, 4))).shape == (0, h, w)


@pytest.mark.parametrize("h,w", SIZES)
def test_masks_for_boxes_match(sams, h, w):
    _check_boxes(*sams, h, w)


@pytest.mark.parametrize("h,w", SIZES)
def test_generate_matches(sams, h, w):
    """A 4x4 grid, the IoU filter off, mask NMS at 0.7: the same masks
    kept, IoUs within 1e-3, masks equal but on near-threshold pixels
    (at most 0.1% of them)."""
    ours, ref = sams
    img = _frame(h, w)
    got, want = ours.generate(img), ref.generate(img)
    assert got["masks"].shape == want["masks"].shape
    assert got["masks"].shape[1:] == (h, w) and len(got["masks"]) >= 1
    np.testing.assert_allclose(got["iou_preds"], want["iou_preds"], rtol=0,
                               atol=1e-3)
    assert (got["masks"] != want["masks"]).mean() <= 1e-3
    if h == 240:
        points = np.array([[0.3, 0.3], [0.8, 0.6]], np.float32)
        got, want = ours.generate(img, points), ref.generate(img, points)
        assert got["masks"].shape == want["masks"].shape
    assert ours.generate(img, np.zeros((0, 2)))["masks"].shape == (0, h, w)


@pytest.mark.parametrize("h,w", SIZES)
def test_masks_to_original_matches_jax_resize(sams, h, w):
    ours, ref = sams
    logits = np.random.default_rng(w).standard_normal(
        (2, 256, 256)).astype(np.float32)
    nh, nw = ref._preprocess(_frame(h, w))[1]
    got = ours._masks_to_original(torch.from_numpy(logits), nh, nw, h, w)
    want = ref._masks_to_original(logits, nh, nw, h, w)
    assert got.shape == (2, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)


@pytest.mark.parametrize("src,dst", [((64, 96), (4, 6)), ((480, 854),
                                                         (30, 53)),
                                     ((240, 320), (480, 640)),
                                     ((720, 1280), (480, 853)),
                                     ((64, 96), (64, 96))])
def test_resize_bilinear_matches_pil(src, dst):
    from deva_tpu.ext.detectors import _resize_bilinear as pil_resize

    from deva_tpu_torch.ext.detectors import _resize_bilinear
    rng = np.random.default_rng(src[1])
    for mask in (rng.random(src).astype(np.float32),
                 (rng.random(src) > 0.7).astype(np.float32)):
        got = _resize_bilinear(mask, dst)
        assert got.shape == dst and got.dtype == np.float32
        np.testing.assert_allclose(got, pil_resize(mask, dst), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("shape,min_side", [((720, 1280), 480),
                                            ((240, 320), 120),
                                            ((480, 854), 480),
                                            ((480, 854), -1)])
def test_get_input_frame_for_deva_matches_pil(shape, min_side):
    from deva_tpu.inference.demo_utils import \
        get_input_frame_for_deva as pil_frame

    from deva_tpu_torch.inference.demo_utils import get_input_frame_for_deva
    img = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 3)).astype(np.uint8)
    got = get_input_frame_for_deva(img, min_side)
    want = pil_frame(img, min_side)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((720, 1280), (480, 853)),
                                     ((720, 1280), (120, 213)),
                                     ((1080, 1920), (480, 853)),
                                     ((480, 854), (576, 1024)),
                                     ((37, 53), (5, 90))])
def test_resize_image_uint8_matches_pil(src, dst):
    """PIL's 8-bit BILINEAR resize bit for bit: shrinking by up to 6 (wide
    windows), growing, and one axis each way."""
    from PIL import Image

    from deva_tpu_torch.ops.resize import resize_image_uint8
    img = np.random.default_rng(src[0]).integers(0, 256, (*src, 3)) \
        .astype(np.uint8)
    got = resize_image_uint8(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*dst, 3)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    assert np.array_equal(got.numpy(), want)
