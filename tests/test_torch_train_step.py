"""The port's unrolled recurrence and losses against deva_tpu's: the total
and per-frame losses and every parameter's gradient, on the same weights,
batch and random draws, at T=3 with num_ref_frames=1, so that frame 2
reads one drawn earlier frame per sample (the random-reference branch).
The draws are deva_tpu's, rebuilt from its jax.random key here and handed
to the port's forward_sequence.

- Before the warm-up (it < start_warm) every pixel counts in the
  bootstrapped CE, so the comparison is strict: losses within 1e-4
  relative, each parameter's gradient within 1e-3 of its tensor's largest
  (torch_train_common.grad_gaps; f32 rounding through the recurrence and
  the two frameworks' convolution sums), with the deep update drawn and
  not drawn. One thing f32 rounding can do that no tolerance covers: put
  a ReLU input that lies within rounding of 0 on the other side of the
  kink, which moves every gradient upstream of it by up to a few percent.
  Where a tensor misses 1e-3, the port is run again in float64 on the
  same weights, batch and draws (but for its explicit f32 casts:
  read_memory's output, the bilinear upsample's stencil), and that
  gradient must then be within 1e-4 of deva_tpu's: the port's arithmetic
  is deva_tpu's, and its own f32 rounding chose the other side of a kink.
- After the warm-up the top 30% of pixels are kept, and pixels whose CE
  ties to rounding may swap at the cut: losses within 1e-4 relative and
  the cosine of the flattened gradients at least 0.999.
Port only: --remat (torch.utils.checkpoint) equals the plain recurrence
(losses and gradients within 1e-6), and a bf16 compute dtype gives finite
f32 gradients to the f32 parameters.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deva_tpu.config import TrainConfig as JaxTrainConfig
from deva_tpu.training.losses import compute_losses as jax_compute_losses
from deva_tpu.training.trainer import forward_sequence as jax_forward

from deva_tpu_torch.config import TrainConfig
from deva_tpu_torch.models.layers import set_compute_dtype
from deva_tpu_torch.training.losses import compute_losses
from deva_tpu_torch.training.trainer import forward_sequence

from torch_train_common import (grad_gaps, jax_draws, jnp_batch, make_batch,
                                param_grads, tiny_nets, torch_batch)

torch.set_num_threads(2)

B, T = 2, 3
CFG = dict(num_frames=T, num_ref_frames=1, start_warm=100, end_warm=200)


def _key_with_deep(deep: bool):
    """The first PRNGKey(seed) whose frame-1 deep-update draw is `deep`."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if jax_draws(key, 1, JaxTrainConfig().deep_update_prob, B,
                     T)[0][1] == deep:
            return key
    raise AssertionError("no key")


@pytest.fixture(scope="module")
def setup():
    jmodel, variables, net = tiny_nets(seed=0)
    batch = make_batch(np.random.default_rng(0), B, T)
    jcfg = JaxTrainConfig(**CFG)

    def loss_fn(params, it, key):
        outs = jax_forward(jmodel, {"params": params,
                                    "batch_stats": variables["batch_stats"]},
                           jnp_batch(batch), key, jcfg)
        losses = jax_compute_losses(outs, jnp.asarray(batch["cls_gt"]),
                                    jnp.asarray(batch["selector"]), it,
                                    start_warm=jcfg.start_warm,
                                    end_warm=jcfg.end_warm)
        return losses["total_loss"], losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return grad_fn, variables, net, batch


def _f(x) -> float:
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def port_losses(net, batch, draws, it, **cfg):
    cfg = TrainConfig(**{**CFG, **cfg})
    net.zero_grad(set_to_none=True)
    tb = torch_batch(batch)
    outs = forward_sequence(net, tb, cfg, draws)
    losses = compute_losses(outs, tb["cls_gt"], tb["selector"], it,
                            start_warm=cfg.start_warm, end_warm=cfg.end_warm)
    losses["total_loss"].backward()
    return losses


def port_f64(net, batch, draws, it, monkeypatch):
    """The port's network and recurrence in float64: a copy of the weights,
    the compute dtype and every explicit f32 cast (Tensor.float, patched
    for the call) made float64. -> the copy, with its gradients."""
    net64 = set_compute_dtype(copy.deepcopy(net).double(), torch.float64)
    batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in batch.items()}
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        port_losses(net64, batch64, draws, it)
    return net64


@pytest.mark.parametrize("it,deep", [(0, True), (0, False), (300, True)])
def test_step_matches_deva_tpu(setup, it, deep, monkeypatch):
    grad_fn, variables, net, batch = setup
    key = _key_with_deep(deep)
    (_, ref), ref_grads = grad_fn(variables["params"], jnp.int32(it), key)
    draws = jax_draws(key, 1, JaxTrainConfig().deep_update_prob, B, T)
    assert draws[1][0] is not None and draws[0][1] == deep
    ours = port_losses(net, batch, draws, it)

    for k in ref:
        assert _f(ours[k]) == pytest.approx(float(ref[k]), rel=1e-4), k
    ref_grads = param_grads(ref_grads)
    if it < CFG["start_warm"]:
        gaps = grad_gaps(ref_grads, net)
        missed = {n for n, gap in gaps.items() if gap >= 1e-3}
        if missed:
            gaps64 = grad_gaps(ref_grads, port_f64(net, batch, draws, it,
                                                   monkeypatch))
            assert all(gaps64[n] < 1e-4 for n in missed), \
                {n: (gaps[n], gaps64[n]) for n in missed}
    else:
        a = np.concatenate([ref_grads[n].ravel()
                            for n, _ in net.named_parameters()])
        b = np.concatenate([p.grad.numpy().ravel()
                            for _, p in net.named_parameters()])
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= 0.999, cos


def test_remat_equals_plain(setup):
    _, _, net, batch = setup
    draws = jax_draws(_key_with_deep(True), 1, 0.2, B, T)
    plain = port_losses(net, batch, draws, 0)
    plain_grads = [p.grad.clone() for p in net.parameters()]
    remat = port_losses(net, batch, draws, 0, remat=True)
    for k in plain:
        assert _f(remat[k]) == pytest.approx(_f(plain[k]), rel=1e-6), k
    for g0, p in zip(plain_grads, net.parameters()):
        scale = max(float(g0.abs().max()), 1e-30)
        assert float((p.grad - g0).abs().max()) <= 1e-6 * scale


def test_bf16_gradients_reach_f32_parameters():
    _, _, net = tiny_nets(seed=0, dtype="bfloat16")
    batch = make_batch(np.random.default_rng(1), B, T)
    draws = jax_draws(_key_with_deep(True), 1, 0.2, B, T)
    losses = port_losses(net, batch, draws, 0)
    assert np.isfinite(_f(losses["total_loss"]))
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name
        assert torch.isfinite(p.grad).all(), name
