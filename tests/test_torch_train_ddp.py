"""Data parallelism: two gloo processes on the CPU, each with half the
batch, against one process on the whole batch.

Each rank joins the group through training/train.py's setup_device (the
torchrun environment: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), wraps
the recurrence in DistributedDataParallel through Trainer, and takes one
train_step on its half with its rows of the whole batch's draws. BatchNorm
is frozen and every loss term is a mean over samples, so the two runs are
one function: the all-reduced (clipped) gradients and the ranks' mean
losses must equal the single process's within 1e-5 of each tensor's
largest gradient (1e-5 relative on the losses; the sums run in another
order). The updated parameters within 1e-5 of the rate (plus 1e-6 of the
parameter, its own rounding) wherever the gradient is above 1e-3 of its
tensor's largest, and within 2 * lr
everywhere (Adam's first step is about lr * sign(g): a gradient that
rounds to about 0 may change sign between the two sums). Both ranks end
with the same parameters.
"""
import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from torch_train_common import make_batch, tiny_net
from deva_tpu_torch.config import TrainConfig
from deva_tpu_torch.training.train import setup_device
from deva_tpu_torch.training.trainer import (Trainer, draw_sequence,
                                             local_draws)

out = sys.argv[1]
device, rank, world = setup_device("cpu")
cfg = TrainConfig(num_frames=4, num_ref_frames=1, lr=1e-3)
batch = make_batch(np.random.default_rng(3), 4, 4)
draws = draw_sequence(cfg, 4, 4, torch.Generator().manual_seed(2))
local = 4 // world
batch = {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}
trainer = Trainer(tiny_net(), cfg, rank=rank, world_size=world)
metrics = trainer.train_step(batch, local_draws(draws, rank, local))
torch.save({"metrics": metrics,
            "grads": {n: p.grad for n, p in trainer.net.named_parameters()},
            "params": {n: p.detach()
                       for n, p in trainer.net.named_parameters()}}, out)
if world > 1:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(world: int, tmp_path):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER,
             str(tmp_path / f"{world}_{rank}.pt"),
             os.path.join(ROOT, "tests")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    return [torch.load(tmp_path / f"{world}_{r}.pt", weights_only=True)
            for r in range(world)]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    one = _run(1, tmp_path)[0]
    two = _run(2, tmp_path)
    for k, v in one["metrics"].items():
        for r in two:
            assert abs(float(r["metrics"][k]) - float(v)) <= \
                1e-5 * max(1.0, abs(float(v))), k
    lr = 1e-3
    # a tensor whose exact gradient is 0 (the key projection's bias cancels
    # in the similarity) carries rounding noise alone: every tensor's scale
    # is at least 1e-4 of the largest gradient, so that the gaps are held
    # to at least 1e-9 of it, as torch_train_common.grad_gaps holds them
    floor = 1e-4 * max(float(g.abs().max()) for g in one["grads"].values())
    for n, g in one["grads"].items():
        scale = max(float(g.abs().max()), floor)
        clear = g.abs() > 1e-3 * scale
        for r in two:
            assert float((r["grads"][n] - g).abs().max()) <= 1e-5 * scale, n
            ref = one["params"][n]
            step_gap = (r["params"][n] - ref).abs()
            assert bool((step_gap <= 1e-5 * lr + 1e-6 * ref.abs())[clear]
                        .all()), n
            assert float(step_gap.max()) <= 2 * lr, n
        assert torch.equal(two[0]["params"][n], two[1]["params"][n]), n
