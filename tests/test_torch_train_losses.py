"""The port's training losses against deva_tpu's compute_losses: B = 3
clips of heterogeneous difficulty (sample 0's logits scaled up, sample 2's
down, as tests/test_losses.py), the third with a padded object slot
(selector 0), at an iteration before, inside and after the warm-up of the
bootstrapped CE. Every loss, the top-p share, and the gradient of the
total with respect to each output.

Tolerances: losses within 1e-5 relative (f32 sums in another order: the
port's top-k set is deva_tpu's sorted prefix, summed unsorted); gradients
within 1e-6 of each output's largest gradient; p equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deva_tpu.training.losses import compute_losses as jax_compute_losses

from deva_tpu_torch.training.losses import compute_losses

START, END = 100, 200


@pytest.mark.parametrize("it", [50, 150, 250])
def test_losses_and_gradients_match(it):
    rng = np.random.default_rng(7)
    b, t, h, w, max_obj = 3, 3, 16, 24, 2
    c = max_obj + 1
    scale = np.array([4.0, 1.0, 0.25])[None, :, None, None, None]
    outputs = {
        "logits": (rng.standard_normal((t - 1, b, c, h, w)) * scale
                   ).astype(np.float32),
        "aux_logits": rng.standard_normal((t - 1, b, c, h, w)
                                          ).astype(np.float32),
        "masks": rng.uniform(0, 1, (t - 1, b, max_obj, h, w)
                             ).astype(np.float32)}
    selector = np.ones((b, max_obj), np.float32)
    selector[2, 1] = 0
    cls_gt = rng.integers(0, c, (b, t, h, w)).astype(np.int32)
    cls_gt[2][cls_gt[2] == 2] = 0  # the padded object is nowhere

    def ref_total(outs):
        losses = jax_compute_losses(outs, jnp.asarray(cls_gt),
                                    jnp.asarray(selector), it,
                                    start_warm=START, end_warm=END)
        return losses["total_loss"], losses

    (_, ref), ref_grads = jax.value_and_grad(ref_total, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})

    ours_in = {k: torch.tensor(v, requires_grad=True)
               for k, v in outputs.items()}
    ours = compute_losses(ours_in, torch.from_numpy(cls_gt),
                          torch.from_numpy(selector), it, start_warm=START,
                          end_warm=END)
    ours["total_loss"].backward()

    assert set(ours) == set(ref)
    assert ours["p"] == pytest.approx(float(ref["p"]), rel=1e-6)
    for key in ref:
        if key == "p":
            continue
        r = float(ref[key])
        assert float(ours[key].detach()) == pytest.approx(r, rel=1e-5), key
    for key, g in ref_grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(ours_in[key].grad.numpy(), g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(), err_msg=key)
