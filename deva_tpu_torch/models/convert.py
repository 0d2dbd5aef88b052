"""deva_tpu (flax) variables -> a deva_tpu_torch (upstream DEVA) state dict.

The inverse of deva_tpu/models/convert.py:convert_torch_statedict, written
with numpy only. Its input is deva_tpu's variables, either as nested dicts
{'params': ..., 'batch_stats': ...} or as the flat "params/a/b/kernel" keys
of an .npz written by deva_tpu's eval_args.save_variables_npz. Its output is
a state dict for deva_tpu_torch.models.network.DEVANetwork, which loads it
with strict=True. An upstream DEVA `.pth` state dict needs no conversion.

Layout changes:
  flax conv kernel [kh, kw, I, O]     -> torch weight [O, I, kh, kw]
  flax dense kernel [I, O]            -> torch weight [O, I]
  BatchNorm scale / bias              -> weight / bias
  BatchNorm batch_stats mean / var    -> running_mean / running_var
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# deva_tpu paths whose torch module is a GConv2D (an nn.Conv2d itself), while
# the flax GConv2D wraps an inner "conv" (deva_tpu/models/convert.py)
_GCONV_PATHS = (
    ("mask_encoder", "sensory_update", "transform"),
    ("mask_decoder", "sensory_compress"),
    ("mask_decoder", "sensory_update", "g16_conv"),
    ("mask_decoder", "sensory_update", "g8_conv"),
    ("mask_decoder", "sensory_update", "g4_conv"),
    ("mask_decoder", "sensory_update", "transform"),
    ("mask_decoder", "sensory_linear_pred", "projection"),
)


def _torch_module_path(path: Tuple[str, ...]) -> str:
    """deva_tpu module path (without the leaf name) -> upstream torch module
    path. Inverse of deva_tpu/models/convert.py:_map_key."""
    top = path[0]
    parts = list(path)
    if parts[-1] == "conv" and tuple(parts[:-1]) in _GCONV_PATHS:
        parts = parts[:-1]
    out = [top]
    i = 1
    while i < len(parts):
        p = parts[i]
        if p == "trunk":
            i += 1
            continue
        if p.startswith("layer") and "_" in p and "trunk" in parts:
            stage, block = p.split("_")
            if stage == "layer1" and top == "pixel_encoder":
                stage = "res2"  # ResNet-50's stage 1 is upstream's `res2`
            out += [stage, block]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        elif p in ("mlp_fc1", "mlp_fc2"):
            out += ["ChannelGate", "mlp", "1" if p == "mlp_fc1" else "3"]
        elif p == "spatial":
            out += ["SpatialGate", "spatial", "conv"]
        elif p.startswith("transform_"):
            out += ["transforms", p[len("transform_"):]]
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        *head, leaf = key.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """deva_tpu variables (nested or flat-keyed) -> torch state dict."""
    if any(isinstance(k, str) and "/" in k for k in variables):
        variables = _unflatten(dict(variables))
    sd: Dict[str, np.ndarray] = {}
    for path, val in _leaves(variables.get("params", {})):
        arr = np.asarray(val)
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[f"{module}.weight"] = arr
        elif leaf == "scale":
            sd[f"{module}.weight"] = arr
            sd[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
        elif leaf == "bias":
            sd[f"{module}.bias"] = arr
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
    for path, val in _leaves(variables.get("batch_stats", {})):
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unexpected batch stat {'/'.join(path)}")
        sd[f"{module}.{name}"] = np.asarray(val)
    return {k: torch.from_numpy(v.copy(order="C")) for k, v in sd.items()}
