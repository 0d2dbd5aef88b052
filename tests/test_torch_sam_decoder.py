"""deva_tpu_torch's SAM prompt encoder and mask decoder (ext/sam_decoder.py)
against deva_tpu's flax SamDecoder, on the same seeded weights, and the
round trip of their state dicts.

A seeded port decoder (SAM's widths: 256 wide, 8 heads, 2 layers, MLP 2048;
plain and HQ) becomes its deva_tpu twin through deva_tpu's own converter
for the original segment_anything / sam-hq layout
(convert_original_sam_statedict). Inputs (image embeddings, early TinyViT
features for HQ, prompts) from a numpy seed; box and point prompts, a
dense mask prompt, multimask_output on and off, and HQ with hq_token_only
on and off.

Tolerances: logits 2e-4 absolute (max |logit| ~20; f32 summation order
through the two-way transformer and the upscaling, measured <= 1.7e-5),
predicted IoUs 1e-5 (measured <= 1e-6); the HQ channel order (best IoU
first) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deva_tpu.ext.sam_decoder import SamDecoder as JaxSamDecoder
from deva_tpu.ext.sam_decoder import SamDecoderConfig as JaxSamDecoderConfig
from deva_tpu.ext.sam_decoder import convert_original_sam_statedict

from deva_tpu_torch.ext.convert import sam_decoder_state_dict
from deva_tpu_torch.ext.sam_decoder import (SamDecoder, SamDecoderConfig,
                                            init_sam_weights)

torch.set_num_threads(2)

LOGIT_ATOL, IOU_ATOL = 2e-4, 1e-5

BOXES = np.array([[[100, 150, 500, 600], [10, 20, 200, 300],
                   [600, 40, 1000, 380]]], np.float32)
POINTS = np.array([[[[320, 240], [600, 700]], [[100, 900], [40, 80]]]],
                  np.float32)
LABELS = np.array([[[1, 0], [1, -1]]], np.float32)


_DECODERS = {}


def _decoders(hq: bool):
    """(hq, port decoder, its deva_tpu variables, jitted flax apply), made
    once per module for each form."""
    if hq in _DECODERS:
        return _DECODERS[hq]
    net = init_sam_weights(SamDecoder(SamDecoderConfig(hq=hq)),
                           seed=7).eval()
    variables = convert_original_sam_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    jdec = JaxSamDecoder(JaxSamDecoderConfig(hq=hq))
    apply = jax.jit(jdec.apply, static_argnames=("multimask_output",
                                                 "hq_token_only"))
    _DECODERS[hq] = hq, net, variables, apply
    return _DECODERS[hq]


@pytest.fixture(params=[False, True], ids=["sam", "hq"])
def decoders(request):
    return _decoders(request.param)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((1, 256, 64, 64)).astype(np.float32) * 0.5
    interm = rng.standard_normal((1, 160, 64, 64)).astype(np.float32)
    mask = rng.standard_normal((1, 1, 256, 256)).astype(np.float32)
    return emb, interm, mask


def _run(decoders, prompts, multimask, hq_token_only=False, seed=0,
         with_mask=False):
    hq, net, variables, apply = decoders
    emb, interm, mask = _inputs(seed)
    kw_t = {k: torch.from_numpy(v) for k, v in prompts.items()}
    kw_j = {k: jnp.asarray(v) for k, v in prompts.items()}
    if hq:
        kw_t["intermediate_embeddings"] = torch.from_numpy(interm)
        kw_j["intermediate_embeddings"] = jnp.asarray(
            interm.transpose(0, 2, 3, 1))
    if with_mask:
        kw_t["mask_input"] = torch.from_numpy(mask)
        kw_j["mask_input"] = jnp.asarray(mask.transpose(0, 2, 3, 1))
    with torch.no_grad():
        got, got_iou = net(torch.from_numpy(emb), multimask_output=multimask,
                           hq_token_only=hq_token_only, **kw_t)
    want, want_iou = apply(variables, jnp.asarray(emb.transpose(0, 2, 3, 1)),
                           multimask_output=multimask,
                           hq_token_only=hq_token_only, **kw_j)
    n = 3 if multimask else 1  # the HQ token's mask alone: 1 channel
    p = next(iter(prompts.values())).shape[1]
    assert got.shape == (1, p, 1 if hq_token_only else n, 256, 256)
    assert got_iou.shape == (1, p, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou),
                               rtol=0, atol=IOU_ATOL)
    return got_iou.numpy()


@pytest.mark.parametrize("multimask", [True, False])
def test_box_prompts_match(decoders, multimask):
    ious = _run(decoders, {"boxes": BOXES}, multimask, seed=1)
    if decoders[0] and multimask:  # HQ: best IoU first
        assert (np.diff(ious, axis=-1) <= 0).all()


@pytest.mark.parametrize("multimask", [True, False])
def test_point_prompts_match(decoders, multimask):
    _run(decoders, {"points": POINTS, "labels": LABELS}, multimask, seed=2)


def test_points_and_boxes_with_mask_prompt_match(decoders):
    _run(decoders, {"points": POINTS, "labels": LABELS,
                    "boxes": BOXES[:, :2]}, True, seed=3, with_mask=True)


@pytest.mark.parametrize("multimask", [True, False])
def test_hq_token_only_matches(multimask):
    _run(_decoders(True), {"boxes": BOXES}, multimask, hq_token_only=True,
         seed=4)


@pytest.mark.parametrize("hq", [False, True])
def test_sam_decoder_state_dict_round_trip(hq):
    """port state dict -> deva_tpu variables (deva_tpu's converter) -> port
    state dict (ext/convert.py): the same keys, the same tensors bit for
    bit; the keys are the original segment_anything / sam-hq names, and the
    transposed-conv kernels keep their [I, O, 2, 2] layout both ways."""
    net = init_sam_weights(SamDecoder(SamDecoderConfig(hq=hq)), seed=8)
    sd = net.state_dict()
    variables = convert_original_sam_statedict(
        {k: v.numpy() for k, v in sd.items()})
    assert np.array_equal(variables["params"]["upscale_kernel1"],
                          sd["mask_decoder.output_upscaling.0.weight"])
    back = sam_decoder_state_dict(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    names = ["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
             "prompt_encoder.point_embeddings.3.weight",
             "prompt_encoder.mask_downscaling.6.weight",
             "mask_decoder.transformer.layers.1.norm4.weight",
             "mask_decoder.transformer.norm_final_attn.bias",
             "mask_decoder.output_hypernetworks_mlps.3.layers.2.weight",
             "mask_decoder.iou_prediction_head.layers.1.bias"]
    if hq:
        names += ["mask_decoder.hf_token.weight",
                  "mask_decoder.hf_mlp.layers.2.bias",
                  "mask_decoder.compress_vit_feat.3.weight",
                  "mask_decoder.embedding_encoder.1.weight",
                  "mask_decoder.embedding_maskfeature.3.bias"]
    for key in names:
        assert key in sd, key
