"""Training: the unrolled multi-frame recurrence, AdamW behind global-norm
clipping, and the train step.

Port of deva_tpu/training/trainer.py (reference:deva/model/trainer.py:
71-206). What changes with the framework:
  - the random draws (each sample's reference frames once a frame has more
    earlier frames than num_ref_frames, and the deep update of the sensory
    state) come from a torch.Generator on the host, so no draw waits for
    the card; `forward_sequence` also takes them precomputed, which is how
    the tests hand it deva_tpu's jax.random draws;
  - data parallelism is DistributedDataParallel over a process group:
    every rank draws the whole batch's draws from the same generator and
    keeps its own samples' rows, so the deep-update draw agrees on every
    rank and N ranks compute the same function as one process on the whole
    batch (every loss term is a mean over samples);
  - the network stays in eval() mode while its parameters take gradients,
    so BatchNorm keeps its running statistics frozen, as deva_tpu's
    train=False and upstream's trainer (reference:deva/model/trainer.py:
    265-270) do;
  - cfg.remat wraps each sub-module call in torch.utils.checkpoint
    (use_reentrant=False), as deva_tpu wraps it in jax.checkpoint;
  - the gradients are clipped as optax.clip_by_global_norm computes it
    (divided by the norm, where clip_grad_norm_ divides by norm + 1e-6),
    and torch.optim.AdamW with no parameter left out of the weight decay is
    optax.adamw; the schedules are LambdaLR / MultiStepLR, stepped once an
    update, which give optax's rate at every update.
Parameters stay f32 under a bf16 compute dtype (models/layers.py), so the
gradients come back to them in f32; there is no loss scaling, as in
deva_tpu.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from deva_tpu_torch.config import TrainConfig
from deva_tpu_torch.models.network import DEVANetwork
from deva_tpu_torch.training.losses import compute_losses

# per propagated frame ti = 1 .. T-1: (the [B, R] reference frames of each
# sample, None while ti <= num_ref_frames; whether the sensory state takes
# the deep update after frame ti, False for the last frame)
Draws = List[Tuple[Optional[torch.Tensor], bool]]

BATCH_KEYS = ("rgb", "first_frame_gt", "cls_gt", "selector")


def draw_sequence(cfg: TrainConfig, b: int, t: int,
                  generator: torch.Generator) -> Draws:
    """One step's draws for a batch of b clips of t frames
    (reference:deva/model/trainer.py:109-122,140)."""
    draws = []
    for ti in range(1, t):
        ref = None
        if ti > cfg.num_ref_frames:
            ref = torch.stack([
                torch.randperm(ti, generator=generator)[:cfg.num_ref_frames]
                for _ in range(b)])
        deep = False
        if ti < t - 1:
            deep = bool(torch.rand((), generator=generator) <
                        cfg.deep_update_prob)
        draws.append((ref, deep))
    return draws


def local_draws(draws: Draws, rank: int, local_b: int) -> Draws:
    """The rows of the samples [rank * local_b, (rank + 1) * local_b) of a
    whole batch's draws."""
    lo = rank * local_b
    return [(None if ref is None else ref[lo:lo + local_b], deep)
            for ref, deep in draws]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, h*w, C]"""
    return x.flatten(2).transpose(1, 2)


def forward_sequence(model: DEVANetwork, batch: Dict[str, torch.Tensor],
                     cfg: TrainConfig,
                     draws: Draws) -> Dict[str, torch.Tensor]:
    """The unrolled recurrence (deva_tpu/training/trainer.py:56-151).

    batch (on the model's device): rgb [B, T, H, W, 3] (deva_tpu's NHWC
    batch, as the datasets give it); first_frame_gt [B, O, H, W] one-hot;
    cls_gt [B, T, H, W] int; selector [B, O].
    -> {'logits': [T-1, B, O+1, H, W], 'masks': [T-1, B, O, H, W],
        'aux_logits': [T-1, B, O+1, H, W]}
    """
    frames = batch["rgb"].permute(0, 1, 4, 2, 3)  # [B, T, 3, H, W]
    first_gt = batch["first_frame_gt"].float()
    selector = batch["selector"]
    b, t = frames.shape[:2]
    max_obj = first_gt.shape[1]
    num_ref = cfg.num_ref_frames
    dev = frames.device

    if cfg.remat:
        def call(fn, *args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    else:
        def call(fn, *args, **kwargs):
            return fn(*args, **kwargs)

    ms, feat = call(model.encode_image, frames[:, 0])
    k, s, _ = call(model.transform_key, feat, need_ek=False)
    hq, wq = k.shape[-2:]
    sensory = torch.zeros((b, max_obj, model.config.value_dim, hq, wq),
                          dtype=model.config.compute_dtype, device=dev)
    v16, sensory = call(model.encode_mask, frames[:, 0], ms[0], sensory,
                        first_gt)
    masks = first_gt

    keys = [_tokens(k)]                           # [B, hw, Ck]
    shrinkages = [s.flatten(1)]                   # [B, hw]
    values = [v16.flatten(3).transpose(2, 3)]     # [B, O, hw, Cv]
    # the deep-update choices as one device tensor: the select below keeps
    # the deep updater in the graph whatever was drawn (DDP needs every
    # parameter in every step's graph), as deva_tpu's jnp.where
    deep = torch.tensor([d for _, d in draws], device=dev)
    rows = torch.arange(b, device=dev)[:, None]

    out_logits, out_masks, out_aux = [], [], []
    for ti in range(1, t):
        ms, feat = call(model.encode_image, frames[:, ti])
        k, s, e = call(model.transform_key, feat)
        keys.append(_tokens(k))
        shrinkages.append(s.flatten(1))

        if ti <= num_ref:
            ref_keys = torch.cat(keys[:ti], dim=1)
            ref_shrink = torch.cat(shrinkages[:ti], dim=1)
            ref_values = torch.cat(values[:ti], dim=2)
        else:
            # num_ref drawn earlier frames per sample
            ref = draws[ti - 1][0].to(dev)        # [B, R]
            ref_keys = torch.stack(keys[:ti], 1)[rows, ref].flatten(1, 2)
            ref_shrink = torch.stack(shrinkages[:ti], 1)[rows, ref].flatten(
                1, 2)
            ref_values = torch.stack(values[:ti], 1)[rows, ref]
            ref_values = ref_values.transpose(1, 2).flatten(2, 3)

        readout = call(model.read_memory, k, e, ref_keys, ref_shrink,
                       ref_values)
        sensory, logits, prob, aux_logits, _ = call(
            model.segment, ms, readout, sensory, masks, selector,
            need_aux=True)
        masks = prob[:, 1:]

        if ti < t - 1:
            v16, sensory_deep = call(model.encode_mask, frames[:, ti], ms[0],
                                     sensory, masks)
            sensory = torch.where(deep[ti - 1], sensory_deep, sensory)
            values.append(v16.flatten(3).transpose(2, 3))

        out_logits.append(logits)
        out_masks.append(masks)
        out_aux.append(aux_logits)

    return {"logits": torch.stack(out_logits),
            "masks": torch.stack(out_masks),
            "aux_logits": torch.stack(out_aux)}


class SequenceModel(nn.Module):
    """The recurrence as a module's forward, so that DistributedDataParallel
    can wrap it (DDP prepares its gradient all-reduce in forward)."""

    def __init__(self, net: DEVANetwork, cfg: TrainConfig):
        super().__init__()
        self.net = net
        self.cfg = cfg

    def forward(self, batch: Dict[str, torch.Tensor], draws: Draws):
        return forward_sequence(self.net, batch, self.cfg, draws)


def make_optimizer(params, cfg: TrainConfig, schedule: str = "step"):
    """AdamW (optax.adamw's defaults: betas 0.9/0.999, eps 1e-8, weight
    decay on every parameter) and its rate schedule
    (deva_tpu/training/trainer.py:38-53). -> (optimizer, scheduler)."""
    opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    if schedule == "constant":
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    elif schedule == "poly":
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: (1 - step / cfg.iterations) ** 0.9)
    elif schedule == "step":
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, list(cfg.steps), cfg.gamma)
    else:
        raise NotImplementedError(schedule)
    return opt, sched


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm is not
    below max_norm, every gradient becomes g / norm * max_norm. Decided on
    the device (no host sync). -> the norm before clipping."""
    norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Trainer:
    """One network, its optimizer and schedule, and the iteration count.

    rank / world_size: this process's place in an initialised default
    process group (world_size 1: no group, no DDP). The batch given to
    train_step is this rank's share of the global batch.
    """

    def __init__(self, net: DEVANetwork, cfg: TrainConfig,
                 schedule: str = "step", *, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        self.net = net.eval()  # frozen BatchNorm statistics (module note)
        self.cfg = cfg
        self.rank, self.world_size = rank, world_size
        self.device = next(net.parameters()).device
        self.module: nn.Module = SequenceModel(net, cfg)
        if world_size > 1:
            self.module = nn.parallel.DistributedDataParallel(
                self.module, broadcast_buffers=False,
                device_ids=[self.device] if self.device.type == "cuda"
                else None)
        self.params = list(net.parameters())
        self.optimizer, self.scheduler = make_optimizer(self.params, cfg,
                                                        schedule)
        self.it = 0
        self.generator = torch.Generator().manual_seed(seed)

    def draws_for(self, b: int, t: int) -> Draws:
        """The draws of the next step on this rank's b clips of t frames,
        from the trainer's generator: the whole batch's draws, the same on
        every rank, and this rank's rows of them."""
        draws = draw_sequence(self.cfg, b * self.world_size, t,
                              self.generator)
        return local_draws(draws, self.rank, b)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in BATCH_KEYS}

    def losses(self, batch, draws: Draws) -> Dict[str, torch.Tensor]:
        outputs = self.module(batch, draws)
        return compute_losses(outputs, batch["cls_gt"], batch["selector"],
                              self.it, start_warm=self.cfg.start_warm,
                              end_warm=self.cfg.end_warm)

    def train_step(self, batch, draws: Optional[Draws] = None,
                   on_phase: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        """Loss, backward, clip, AdamW step, schedule step, it += 1.
        batch: numpy arrays or tensors with BATCH_KEYS. on_phase, if given,
        is called with 'forward', 'backward' and 'update' as each part has
        been enqueued. -> metrics (device tensors, the mean over ranks):
        total_loss, p, grad_norm and the per-frame losses."""
        batch = self.to_device(batch)
        if draws is None:
            draws = self.draws_for(*batch["rgb"].shape[:2])
        self.optimizer.zero_grad(set_to_none=True)
        losses = self.losses(batch, draws)
        if on_phase:
            on_phase("forward")
        losses["total_loss"].backward()
        if on_phase:
            on_phase("backward")
        grad_norm = self.apply_gradients()
        if on_phase:
            on_phase("update")
        metrics = {k: v.detach() for k, v in losses.items() if k != "p"}
        if self.world_size > 1:
            names = sorted(metrics)
            stacked = torch.stack([metrics[k] for k in names])
            dist.all_reduce(stacked)
            metrics = dict(zip(names, stacked / self.world_size))
        metrics["p"] = torch.tensor(losses["p"])
        metrics["grad_norm"] = grad_norm
        return metrics

    def apply_gradients(self) -> torch.Tensor:
        """Clip the parameters' gradients, take the AdamW step at the
        schedule's rate, step the schedule, it += 1. -> the gradients'
        global norm before clipping."""
        grad_norm = clip_by_global_norm([p.grad for p in self.params],
                                        self.cfg.clip_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.it += 1
        return grad_norm

    @torch.no_grad()
    def eval_outputs(self, batch, draws: Draws):
        """The forward pass alone on a step's batch and draws, for the
        training visualisation grids (reference:deva/model/trainer.py:
        161-167)."""
        return forward_sequence(self.net, self.to_device(batch), self.cfg,
                                draws)

    def state_dict(self) -> Dict:
        return {"it": self.it, "network": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.net.load_state_dict(state["network"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.it = int(state["it"])

