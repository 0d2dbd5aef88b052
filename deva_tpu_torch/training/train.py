"""Multi-stage training driver.

Port of deva_tpu/training/train.py (reference:deva/train.py): the same
stage system ('0' static pretrain, '3' DAVIS + YouTube-VOS + OVIS), max_skip
curriculum, dataset mix (DAVIS x5, YouTube-VOS, OVIS x3), save cadence
(densified near the end) and in-memory handoff of the weights from one
stage to the next. Data parallelism is DistributedDataParallel when
WORLD_SIZE > 1 (NCCL on the card, gloo on the CPU), one process per card,
each with its share of the global batch; with one device there is no
process group.

Run on the card:   python -m deva_tpu_torch.training.train --stages 03 ...
on the CPU:        ... --device cpu
on N cards:        torchrun --nproc_per_node N -m deva_tpu_torch.training.train
"""
from __future__ import annotations

import datetime
import random
from os import path

import numpy as np
import torch

from deva_tpu_torch.config import ModelConfig, TrainConfig
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.parallel.mesh import init_from_env
from deva_tpu_torch.training import checkpoint as ckpt
from deva_tpu_torch.training.configuration import Configuration
from deva_tpu_torch.training.data import StaticTransformDataset, VOSDataset
from deva_tpu_torch.training.trainer import BATCH_KEYS, Trainer
from deva_tpu_torch.utils.load_subset import load_sub_davis, load_sub_yv
from deva_tpu_torch.utils.logger import Integrator, TensorboardLogger

SEED = 14159265


def _numpy_collate(batch):
    out = {k: np.stack([b[k] for b in batch]) for k in BATCH_KEYS}
    out["num_objects"] = np.array([b["info"]["num_objects"] for b in batch])
    return out


def build_loader(dataset, batch_size: int, num_workers: int, seed: int,
                 rank: int = 0):
    from torch.utils.data import DataLoader

    def worker_init_fn(worker_id):
        np.random.seed(seed + worker_id)
        random.seed(seed + worker_id)

    # deterministic shuffle, decorrelated across ranks: each rank draws an
    # independent stream over the augmented datasets, as deva_tpu's hosts do
    gen = torch.Generator()
    gen.manual_seed(1000 * seed + rank)
    return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                      num_workers=num_workers, drop_last=True,
                      collate_fn=_numpy_collate, generator=gen,
                      worker_init_fn=worker_init_fn)


def setup_device(name: str):
    """-> (device, rank, world_size). A run under torchrun (WORLD_SIZE > 1)
    joins the process group torchrun's environment describes; each process
    takes the card of its LOCAL_RANK. cuda without CUDA raises. TF32 is
    off on the card, as in every entry point of the port
    (parallel.mesh.init_from_env: NCCL on the card, gloo on the CPU)."""
    return init_from_env(name)


def main(argv=None):
    raw_config = Configuration()
    raw_config.parse(argv)
    device, rank, world = setup_device(raw_config["device"])
    print(f"Data-parallel over {world} process(es) on {device}.")

    network_in_memory = None
    stages = raw_config["stages"]
    total_iter = 0

    for si, stage in enumerate(list(stages)):
        np.random.seed(SEED)
        random.seed(SEED)

        stage_params = raw_config.get_stage_parameters(stage)
        exp_id = raw_config["exp_id"]
        if exp_id != "NULL":
            exp_id = exp_id + "-s%s" % stages[:si + 1]
        batch_size = stage_params["batch_size"]
        if batch_size % world:
            raise ValueError(f"batch {batch_size} must divide over {world} "
                             "processes")
        # the global batch divides over the processes
        # (reference:deva/train.py:59-63)
        local_batch = batch_size // world

        long_id = None
        if exp_id.lower() != "null" and rank == 0:
            long_id = "%s-%s" % (
                datetime.datetime.now().strftime("%b%d-%H.%M.%S"), exp_id)
        logger = TensorboardLogger(exp_id, long_id)
        logger.log_string("hyperparameters", str(raw_config))
        save_path = path.join("saves", long_id, exp_id) if long_id else None

        cfg = TrainConfig(
            batch_size=batch_size,
            num_frames=stage_params["num_frames"],
            num_ref_frames=stage_params["num_ref_frames"],
            lr=stage_params["lr"],
            weight_decay=raw_config["weight_decay"],
            iterations=stage_params["iterations"],
            steps=tuple(stage_params["steps"]),
            gamma=raw_config["gamma"],
            clip_grad_norm=raw_config["clip_grad_norm"],
            deep_update_prob=raw_config["deep_update_prob"],
            start_warm=stage_params["start_warm"],
            end_warm=stage_params["end_warm"],
            remat=raw_config["remat"],
        )
        mc = ModelConfig(pix_feat_dim=raw_config["pix_feat_dim"],
                         key_dim=raw_config["key_dim"],
                         value_dim=raw_config["value_dim"],
                         dtype="bfloat16" if raw_config["amp"] else
                         "float32")
        net = init_weights(DEVANetwork(mc), SEED)
        if network_in_memory is not None:
            print("Loading weights from the previous stage")
            net.load_state_dict(network_in_memory, strict=True)
            network_in_memory = None
        elif raw_config["load_network"] is not None:
            net.load_state_dict(
                ckpt.load_network_weights(raw_config["load_network"]),
                strict=True)
            raw_config["load_network"] = None
            print("Pretrained weights loaded.")

        trainer = Trainer(net.to(device), cfg,
                          schedule=stage_params["schedule"], rank=rank,
                          world_size=world)
        total_iter = 0
        if raw_config["load_checkpoint"] is not None:
            total_iter = ckpt.load_checkpoint(trainer,
                                              raw_config["load_checkpoint"])
            raw_config["load_checkpoint"] = None
        # the draws of a (resumed) stage start from its iteration, as
        # deva_tpu's PRNGKey(total_iter)
        trainer.generator.manual_seed(total_iter)

        # datasets (reference:deva/train.py:166-194)
        max_skip_values = [10, 15, 5, 5]
        increase_skip_fraction = [0.1, 0.3, 0.8, 100]
        if stage == "0":
            static_root = path.expanduser(raw_config["static_root"])
            dataset = StaticTransformDataset([
                (path.join(static_root, "fss"), 0, 1),
                (path.join(static_root, "DUTS-TR"), 1, 1),
                (path.join(static_root, "DUTS-TE"), 1, 1),
                (path.join(static_root, "ecssd"), 1, 1),
                (path.join(static_root, "BIG_small"), 1, 5),
                (path.join(static_root, "HRSOD_small"), 1, 5),
            ], num_frames=cfg.num_frames, max_num_obj=1,
               size=raw_config["crop_size"])
            loader = build_loader(dataset, local_batch,
                                  raw_config["num_workers"], seed=total_iter,
                                  rank=rank)
            renew_loader = None
        else:
            yv_root = path.join(path.expanduser(raw_config["yv_root"]),
                                "train")
            davis_root = path.join(path.expanduser(raw_config["davis_root"]),
                                   "2017", "trainval")
            ovis_root = path.expanduser(raw_config["ovis_root"])

            def renew_loader(max_skip):
                from torch.utils.data import ConcatDataset
                yv = VOSDataset(path.join(yv_root, "JPEGImages"),
                                path.join(yv_root, "Annotations"),
                                max_skip // 5, subset=load_sub_yv(),
                                num_frames=cfg.num_frames,
                                size=raw_config["crop_size"],
                                data_ratio=raw_config["video_data_ratio"])
                davis = VOSDataset(path.join(davis_root, "JPEGImages",
                                             "480p"),
                                   path.join(davis_root, "Annotations",
                                             "480p"),
                                   max_skip, subset=load_sub_davis(),
                                   num_frames=cfg.num_frames,
                                   size=raw_config["crop_size"],
                                   data_ratio=raw_config["video_data_ratio"])
                ovis = VOSDataset(path.join(ovis_root, "JPEGImages"),
                                  path.join(ovis_root, "Annotations"),
                                  max_skip // 5, subset=None,
                                  num_frames=cfg.num_frames,
                                  size=raw_config["crop_size"],
                                  data_ratio=raw_config["video_data_ratio"])
                mixed = ConcatDataset([davis] * 5 + [yv] + [ovis] * 3)
                print(f"Renewed loaders with max_skip={max_skip}; "
                      f"sizes: davis={len(davis)}, yv={len(yv)}, "
                      f"ovis={len(ovis)}")
                return build_loader(mixed, local_batch,
                                    raw_config["num_workers"],
                                    seed=total_iter, rank=rank)

            loader = renew_loader(5)

        change_skip_iter = [round(cfg.iterations * f)
                            for f in increase_skip_fraction]
        integrator = Integrator(logger)
        save_network_interval = raw_config["save_network_interval"]

        try:
            while total_iter < cfg.iterations:
                for batch in loader:
                    if stage != "0" and total_iter >= change_skip_iter[0]:
                        while total_iter >= change_skip_iter[0]:
                            cur_skip = max_skip_values.pop(0)
                            change_skip_iter.pop(0)
                        print(f"Changing skip to {cur_skip}")
                        loader = renew_loader(cur_skip)
                        break
                    if stage != "0" and \
                            (cfg.iterations - total_iter <= 5000):
                        save_network_interval = 1000

                    draws = trainer.draws_for(*batch["rgb"].shape[:2])
                    metrics = trainer.train_step(batch, draws)
                    integrator.add_dict(
                        {k: v for k, v in metrics.items()
                         if k in ("total_loss", "p", "grad_norm")})
                    total_iter += 1

                    if total_iter % raw_config["log_text_interval"] == 0:
                        integrator.finalize("train", total_iter)
                        integrator.reset_except_hooks()
                    if logger.writer is not None and total_iter % \
                            raw_config["log_image_interval"] == 0:
                        from deva_tpu_torch.utils.image_saver import \
                            pool_pairs
                        outs = trainer.eval_outputs(batch, draws)
                        logger.log_image(
                            "train/pairs",
                            pool_pairs(batch, {k: v.float().cpu().numpy()
                                               for k, v in outs.items()}),
                            total_iter)
                    if save_path and \
                            total_iter % save_network_interval == 0:
                        ckpt.save_network(net, save_path, total_iter)
                    if save_path and total_iter % \
                            raw_config["save_checkpoint_interval"] == 0:
                        ckpt.save_checkpoint(trainer, save_path, total_iter)
                    if total_iter >= cfg.iterations:
                        break
        finally:
            if save_path and not raw_config["debug"] and total_iter > 5000:
                ckpt.save_network(net, save_path, total_iter)
                ckpt.save_checkpoint(trainer, save_path, total_iter)

        network_in_memory = {k: v.detach().cpu()
                             for k, v in net.state_dict().items()}
    return network_in_memory


if __name__ == "__main__":
    main()
