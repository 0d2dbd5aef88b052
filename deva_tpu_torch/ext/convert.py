"""deva_tpu's SAM variables (flax) -> the port's SAM state dicts.

The way back of deva_tpu/ext/tiny_vit.py:convert_tiny_vit_statedict and
deva_tpu/ext/sam_decoder.py:convert_original_sam_statedict, the SAM
counterpart of models/convert.py:variables_to_state_dict, written with
numpy only. The input is deva_tpu's JaxMobileSAM variables,
{"encoder": {"params", "batch_stats"}, "decoder": {"params"}}, as nested
dicts or as the slash-joined keys of an .npz written by
scripts/convert_sam_checkpoint.py (deva_tpu/ext/jax_sam.py:
load_variables_npz reads the same). The output is the original
segment_anything layout (image_encoder.*, prompt_encoder.*,
mask_decoder.*), which mobile_sam.MobileSamNet loads with strict=True.

Layout changes:
  flax conv kernel [kh, kw, I, O]   -> torch weight [O, I, kh, kw]
  flax dense kernel [I, O]          -> torch weight [O, I]
  scale / bias (LayerNorm, BN)      -> weight / bias
  batch_stats mean / var            -> running_mean / running_var
  embedding                         -> weight
  the 2x2 transposed-conv kernels   -> as they are ([I, O, 2, 2] in both)
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def flatten(tree, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """Nested dicts, or flat slash-joined keys, -> {path tuple: array}."""
    out = {}
    for k, v in tree.items():
        path = prefix + tuple(str(k).split("/"))
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(module: str, leaf: str, value: np.ndarray):
    """(torch key, tensor) of one flax leaf under `module`."""
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        name = "weight"
    else:
        name = {"scale": "weight", "mean": "running_mean",
                "var": "running_var", "embedding": "weight"}.get(leaf, leaf)
    return f"{module}.{name}", torch.from_numpy(np.ascontiguousarray(value))


def _encoder_module(path: Path) -> str:
    """deva_tpu TinyViT module path -> tiny_vit_sam module path."""
    top, rest = path[0], list(path[1:])
    if top == "patch_embed":  # conv1/conv2 -> seq.0/seq.2
        mod = f"patch_embed.seq.{0 if rest[0] == 'conv1' else 2}"
        rest = rest[1:]
    elif top.startswith("neck_"):
        mod = "neck." + {"neck_conv1": "0", "neck_ln1": "1",
                         "neck_conv2": "2", "neck_ln2": "3"}[top]
    else:
        m = re.fullmatch(r"layer(\d+)_(block(\d+)|downsample)", top)
        if m is None:
            raise KeyError(f"unknown TinyViT module {'/'.join(path)}")
        mod = f"layers.{m.group(1)}." + (
            f"blocks.{m.group(3)}" if m.group(3) is not None
            else "downsample")
    return ".".join([mod] + rest)


def tiny_vit_state_dict(variables) -> Dict[str, torch.Tensor]:
    """deva_tpu TinyViT variables {"params", "batch_stats"} -> the port's
    TinyViT state dict (num_batches_tracked zero)."""
    sd = {}
    for path, value in flatten(variables).items():
        key, t = _leaf(_encoder_module(path[1:-1]), path[-1], value)
        sd[key] = t
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


# deva_tpu SamDecoder module -> segment_anything module (prompt encoder)
_PROMPT = {"mask_conv1": "mask_downscaling.0", "mask_ln1":
           "mask_downscaling.1", "mask_conv2": "mask_downscaling.3",
           "mask_ln2": "mask_downscaling.4", "mask_conv3":
           "mask_downscaling.6", "not_a_point_embed": "not_a_point_embed",
           "no_mask_embed": "no_mask_embed"}
# (mask decoder) nn.Sequential indices of the upscaling stacks
_STACKS = {"upscale": "output_upscaling", "compress_vit":
           "compress_vit_feat", "encoder": "embedding_encoder"}
_DECODER = {"iou_token": "iou_token", "mask_tokens": "mask_tokens",
            "hq_token": "hf_token", "maskfeat_conv1":
            "embedding_maskfeature.0", "maskfeat_ln":
            "embedding_maskfeature.1", "maskfeat_conv2":
            "embedding_maskfeature.3"}


def _ffn(name: str, sub: str, depth: int) -> str:
    """deva_tpu FeedForward layer (proj_in / layer{j} / proj_out) ->
    segment_anything MLP index."""
    if sub == "proj_in":
        j = 0
    elif sub == "proj_out":
        j = depth - 1
    else:
        j = int(sub[len("layer"):]) + 1
    return f"{name}.layers.{j}"


def sam_decoder_state_dict(variables) -> Dict[str, torch.Tensor]:
    """deva_tpu SamDecoder variables {"params"} -> the port's SamDecoder
    state dict (prompt_encoder.*, mask_decoder.*)."""
    flat = {p[1:]: v for p, v in flatten(variables).items()}
    iou_depth = 2 + sum(1 for p in flat if p[0] == "iou_head"
                        and p[1].startswith("layer") and p[-1] == "kernel")
    sd = {}
    for path, value in flat.items():
        top, leaf = path[0], path[-1]
        if top == "positional_embedding":
            sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]\
                = torch.from_numpy(np.ascontiguousarray(value))
            continue
        m = re.fullmatch(r"(upscale|compress_vit|encoder)_(kernel|bias)(\d)",
                         top)
        if m is not None:  # [I, O, 2, 2] kernels, torch's layout already
            idx = 0 if m.group(3) == "1" else 3
            sd[f"mask_decoder.{_STACKS[m.group(1)]}.{idx}."
               f"{'weight' if m.group(2) == 'kernel' else 'bias'}"] = \
                torch.from_numpy(np.ascontiguousarray(value))
            continue
        if top in ("upscale_ln", "compress_vit_ln", "encoder_ln"):
            mod = f"mask_decoder.{_STACKS[top[:-3]]}.1"
        elif top.startswith("point_embed"):
            mod = f"prompt_encoder.point_embeddings.{top[len('point_embed'):]}"
        elif top in _PROMPT:
            mod = f"prompt_encoder.{_PROMPT[top]}"
        elif top in _DECODER:
            mod = f"mask_decoder.{_DECODER[top]}"
        elif top.startswith("hyper_mlp"):
            mod = "mask_decoder." + _ffn(
                f"output_hypernetworks_mlps.{top[len('hyper_mlp'):]}",
                path[1], 3)
        elif top == "hq_mask_mlp":
            mod = "mask_decoder." + _ffn("hf_mlp", path[1], 3)
        elif top == "iou_head":
            mod = "mask_decoder." + _ffn("iou_prediction_head", path[1],
                                         iou_depth)
        elif top == "transformer":
            mod = "mask_decoder.transformer." + ".".join(
                _transformer_part(p) for p in path[1:-1])
        else:
            raise KeyError(f"unknown SamDecoder parameter {'/'.join(path)}")
        key, t = _leaf(mod, leaf, value)
        sd[key] = t
    return sd


def _transformer_part(p: str) -> str:
    m = re.fullmatch(r"layer(\d+)", p)
    if m is not None:
        return f"layers.{m.group(1)}"
    m = re.fullmatch(r"layer_norm(\d+)", p)
    if m is not None:
        return f"norm{m.group(1)}"
    return "norm_final_attn" if p == "layer_norm_final_attn" else p


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """JaxMobileSAM variables {"encoder": ..., "decoder": ...} (nested, or
    an .npz's flat keys) -> the port's MobileSamNet state dict."""
    tree: Dict[str, dict] = {"encoder": {}, "decoder": {}}
    for path, value in flatten(variables).items():
        tree[path[0]]["/".join(path[1:])] = value
    sd = {f"image_encoder.{k}": v
          for k, v in tiny_vit_state_dict(tree["encoder"]).items()}
    sd.update(sam_decoder_state_dict(tree["decoder"]))
    return sd
