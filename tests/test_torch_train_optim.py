"""The port's optimizer, schedules and checkpoints.

- Trainer.apply_gradients (optax-style global-norm clip, torch AdamW, the
  schedule) against deva_tpu's make_optimizer (optax.chain(
  clip_by_global_norm, adamw)) on the same parameters and gradients for
  six updates, the gradients large enough that the clip acts on some
  updates and not on others, across the 'step' schedule's boundaries:
  parameters within 1e-6 relative (f32 rounding of the same formulas in
  another order) plus 1e-5 of the rate for each update taken: optax takes
  Adam's bias corrections 1 - beta^t in f32, where 0.999 rounds
  (1 - 0.999f = 9.9998713e-4), torch in f64, so an early update differs
  by about 6e-6 of its size, the rate, and the gaps add up over updates
  (a parameter that starts at 0, as a BatchNorm bias, shows them whole).
  The unclipped global norm within 1e-6 relative.
- Each schedule's rate at every update of a 10-iteration run with
  boundaries at 3 and 5, against optax's, read from deva_tpu's optimizer
  by an update with zero gradients (its update is then -lr * wd * param):
  within 1e-6 relative.
- A checkpoint round trip: 2 steps, save_checkpoint, a fresh trainer
  resumed by load_checkpoint and 2 more steps equal 4 straight steps,
  bitwise on the CPU, given the same batches and draws.
- save_network's .pth loads in deva_tpu (convert_torch_statedict,
  verify_converted, load_torch_checkpoint) and in eval_vos_torch's loader;
  load_network_weights reads it and a deva_tpu .npz.
"""
import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.config import TrainConfig as JaxTrainConfig
from deva_tpu.models.convert import (convert_torch_statedict,
                                     load_torch_checkpoint, verify_converted)
from deva_tpu.training.trainer import make_optimizer as jax_make_optimizer

from deva_tpu_torch.config import TrainConfig
from deva_tpu_torch.training import checkpoint as ckpt
from deva_tpu_torch.training.trainer import Trainer

from torch_train_common import TINY, jax_draws, make_batch, tiny_nets

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trainer(cfg, schedule, seed=0):
    return Trainer(tiny_nets(seed)[2], cfg, schedule=schedule)


def test_update_matches_optax():
    cfg = dict(lr=1e-3, weight_decay=0.05, clip_grad_norm=3.0,
               iterations=10, steps=(2, 4), gamma=0.1)
    trainer = _trainer(TrainConfig(**cfg), "step")
    names = [n for n, _ in trainer.net.named_parameters()]
    # copies: jnp.asarray may alias a numpy buffer, and torch updates its
    # parameters and clips its gradients in place while jax's dispatch
    # may still be reading them
    params = {n: jnp.array(p.detach().numpy(), copy=True)
              for n, p in trainer.net.named_parameters()}
    tx = jax_make_optimizer(JaxTrainConfig(**cfg), schedule="step")
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    clipped = []
    for step in range(6):
        # global norms around the clip threshold: some updates clip
        scale = (0.3, 20.0)[step % 2] / np.sqrt(sum(
            p.numel() for p in trainer.params))
        grads = {n: (rng.standard_normal(params[n].shape) * scale
                     ).astype(np.float32) for n in names}
        ref_norm = float(optax.global_norm(grads))
        clipped.append(ref_norm >= cfg["clip_grad_norm"])
        updates, state = update({n: jnp.array(g, copy=True)
                                 for n, g in grads.items()}, state, params)
        params = jax.block_until_ready(
            jax.jit(optax.apply_updates)(params, updates))
        for n, p in trainer.net.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = trainer.apply_gradients()
        assert float(norm) == pytest.approx(ref_norm, rel=1e-6)
        for n, p in trainer.net.named_parameters():
            ref = np.asarray(params[n])
            np.testing.assert_allclose(
                p.detach().numpy(), ref, rtol=1e-6,
                atol=1e-5 * cfg["lr"] * (step + 1), err_msg=f"{n} at {step}")
    assert any(clipped) and not all(clipped)
    assert trainer.it == 6


def _optax_rates(schedule, cfg, n):
    """optax's rate at updates 0..n-1 of deva_tpu's optimizer: with zero
    gradients AdamW's update is -lr * weight_decay * param."""
    tx = jax_make_optimizer(JaxTrainConfig(**cfg), schedule=schedule)
    params = {"p": jnp.ones((1,), jnp.float32)}
    state = tx.init(params)
    rates = []
    for _ in range(n):
        updates, state = tx.update({"p": jnp.zeros((1,), jnp.float32)},
                                   state, params)
        rates.append(-float(updates["p"][0]) / cfg["weight_decay"])
    return rates


@pytest.mark.parametrize("schedule", ["constant", "poly", "step"])
def test_schedule_rates_match_optax(schedule):
    cfg = dict(lr=1e-3, weight_decay=0.5, iterations=10, steps=(3, 5),
               gamma=0.1)
    ref = _optax_rates(schedule, cfg, 10)
    trainer = _trainer(TrainConfig(**cfg), schedule)
    ours = []
    for _ in range(10):
        ours.append(trainer.optimizer.param_groups[0]["lr"])
        for p in trainer.params:
            p.grad = torch.zeros_like(p)
        trainer.apply_gradients()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    if schedule == "step":  # at and around the boundaries
        assert ours[2] == pytest.approx(1e-3) and \
            ours[3] == pytest.approx(1e-4) and \
            ours[5] == pytest.approx(1e-5)


def test_checkpoint_resume_is_bitwise(tmp_path):
    cfg = TrainConfig(num_frames=3, num_ref_frames=1, lr=1e-3,
                      iterations=10, steps=(3, 5))
    rng = np.random.default_rng(4)
    batches = [make_batch(rng, 2, 3) for _ in range(4)]
    draws = [jax_draws(jax.random.PRNGKey(i), 1, 0.5, 2, 3)
             for i in range(4)]

    straight = _trainer(cfg, "step")
    for b, d in zip(batches, draws):
        last = straight.train_step(b, d)

    first = _trainer(cfg, "step")
    for b, d in zip(batches[:2], draws[:2]):
        first.train_step(b, d)
    path = ckpt.save_checkpoint(first, str(tmp_path / "run"), first.it)
    assert path.endswith("run_checkpoint_2.pth")
    resumed = _trainer(cfg, "step", seed=5)  # other weights, overwritten
    assert ckpt.load_checkpoint(resumed, path) == 2
    for b, d in zip(batches[2:], draws[2:]):
        metrics = resumed.train_step(b, d)

    assert resumed.it == straight.it == 4
    for k in last:
        assert torch.equal(metrics[k], last[k]), k
    for (n, a), b in zip(straight.net.state_dict().items(),
                         resumed.net.state_dict().values()):
        assert torch.equal(a, b), n
    assert resumed.optimizer.param_groups[0]["lr"] == \
        straight.optimizer.param_groups[0]["lr"]


def test_save_network_loads_in_deva_tpu_and_eval_vos(tmp_path):
    _, variables, net = tiny_nets(seed=6)
    path = ckpt.save_network(net, str(tmp_path / "sub" / "run"), 12345)
    assert path.endswith("run_12K.pth")
    sd = torch.load(path, weights_only=True)
    assert sd.keys() == net.state_dict().keys()

    jcfg = JaxModelConfig(**TINY)
    converted = convert_torch_statedict({k: v.numpy() for k, v in sd.items()})
    verify_converted(converted, jcfg)
    loaded = load_torch_checkpoint(path, model_config=jcfg)
    for tree in (converted, loaded):
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    try:
        import eval_vos_torch
    finally:
        sys.path.remove(os.path.join(ROOT, "evaluation"))
    args = Namespace(model=path, amp=False, **TINY)
    model = eval_vos_torch.load_model(args, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k

    # load_network_weights: the .pth, and deva_tpu's flat .npz
    for k, v in ckpt.load_network_weights(path).items():
        assert torch.equal(v, sd[k]), k
    flat = {"/".join(k): np.asarray(v) for k, v in _flat(variables)}
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **flat)
    for k, v in ckpt.load_network_weights(npz).items():
        assert torch.equal(v, sd[k]), k


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v
