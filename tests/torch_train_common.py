"""Shared set-up of the training parity tests (tests/test_torch_train_*.py).

The tiny widths of deva_tpu's toy model (pix 64, key 16, value 32) at
32x32. Weights come from the port's seeded init_weights (upstream DEVA's
initialisation), carried into deva_tpu's variables by its
convert_torch_statedict, so both packages start from the same numbers.
Batches follow training/toy.py's moving-square recipe with two objects in
the first clip and one (the second object slot padded, selector 0) in the
second, so every loss sees a padded channel.

jax and deva_tpu are imported inside the functions that use them, so that
the DDP test's worker processes load the port alone.
"""
import numpy as np
import torch

from deva_tpu_torch.config import ModelConfig
from deva_tpu_torch.models.convert import variables_to_state_dict
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.training.toy import make_clip

TINY = dict(pix_feat_dim=64, key_dim=16, value_dim=32)
H = W = 32
MAX_OBJ = 2


def tiny_net(seed: int = 0, dtype: str = "float32"):
    """The port's tiny network with seeded weights, in eval mode."""
    return init_weights(DEVANetwork(ModelConfig(dtype=dtype, **TINY)),
                        seed).eval()


def tiny_nets(seed: int = 0, dtype: str = "float32"):
    """-> (deva_tpu model, its variables, the port's network in eval mode),
    with the same weights."""
    from deva_tpu.config import ModelConfig as JaxModelConfig
    from deva_tpu.models.convert import convert_torch_statedict
    from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork
    net = tiny_net(seed, dtype)
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    jmodel = JaxDEVANetwork(JaxModelConfig(dtype=dtype, **TINY))
    return jmodel, variables, net


def two_object_clip(rng, t: int, two: bool):
    """Frames [t, H, W, 3] and ids [t, H, W]: toy.make_clip's square, and a
    second square of another clip pasted over it when `two`; then pixel
    noise over the whole frame. make_clip paints its squares flat, and a
    flat region repeats each feature value over all its pixels: one value
    that lies within f32 rounding of a ReLU's kink then sits at every
    pixel of the region, and which side of the kink each framework's
    rounding puts it on moves whole gradient tensors by percents."""
    frames, masks = make_clip(rng, t, H, W, 10)
    if two:
        frames2, masks2 = make_clip(rng, t, H, W, 8)
        on = masks2 == 1
        frames = np.where(on[..., None], frames2, frames)
        masks = np.where(on, 2, masks).astype(np.int32)
    frames = frames + 0.02 * rng.standard_normal(frames.shape)
    return frames.astype(np.float32), masks


def make_batch(rng, b: int, t: int):
    """A trainer batch (numpy): sample i has two objects for even i, one
    (slot 2 padded) for odd i."""
    clips = [two_object_clip(rng, t, i % 2 == 0) for i in range(b)]
    rgb = np.stack([c[0] for c in clips]).astype(np.float32)
    cls_gt = np.stack([c[1] for c in clips]).astype(np.int32)
    selector = np.array([[1.0, 1.0 if i % 2 == 0 else 0.0]
                         for i in range(b)], np.float32)
    first = np.stack([cls_gt[:, 0] == j + 1 for j in range(MAX_OBJ)],
                     1).astype(np.float32) * selector[:, :, None, None]
    return {"rgb": rgb, "first_frame_gt": first, "cls_gt": cls_gt,
            "selector": selector}


def jax_draws(key, num_ref: int, deep_prob: float, b: int, t: int):
    """deva_tpu's forward_sequence draws for `key` (its trainer.py:99,
    117-122,137), in the port's form."""
    import jax
    draws = []
    for ti in range(1, t):
        key, k_ref, k_deep = jax.random.split(key, 3)
        ref = None
        if ti > num_ref:
            perm = jax.vmap(lambda kk: jax.random.permutation(kk, ti)[
                :num_ref])(jax.random.split(k_ref, b))
            ref = torch.from_numpy(np.array(perm)).long()
        deep = ti < t - 1 and bool(jax.random.uniform(k_deep) < deep_prob)
        draws.append((ref, deep))
    return draws


def jnp_batch(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def param_grads(tree) -> dict:
    """deva_tpu's gradient tree -> {port parameter name: numpy}."""
    sd = variables_to_state_dict({"params": tree})
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def grad_gaps(ref: dict, net) -> dict:
    """Each parameter's largest |port grad - ref grad| over the scale it is
    held to: its tensor's largest |ref grad|, but at least 1e-6 of the
    largest over all tensors (a tensor whose exact gradient is 0, such as
    the key projection's bias, which cancels in the similarity, carries
    rounding noise alone)."""
    floor = 1e-6 * max(np.abs(g).max() for g in ref.values())
    gaps = {}
    for name, p in net.named_parameters():
        g = ref[name]
        scale = max(np.abs(g).max(), floor)
        gaps[name] = float(np.abs(p.grad.numpy() - g).max() / scale)
    return gaps
