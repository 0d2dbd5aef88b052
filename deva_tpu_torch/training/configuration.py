"""Training CLI: stage system with per-stage hyperparameters.

Behavioral anchor: reference:deva/utils/configuration.py:4-125 (same flags and
defaults; stage 0 = static pretrain, stage 3 = DAVIS+YouTubeVOS+OVIS main).

A copy of deva_tpu/training/configuration.py with the same flags and
defaults, but for the jax multi-host ones (--multihost,
--coordinator_address, --num_processes, --process_id, --n_devices): a
multi-process run takes its rank and world size from torchrun's
environment. Adds --device (cuda unless --device cpu).
"""
from __future__ import annotations

from argparse import ArgumentParser


class Configuration:
    def parse(self, args=None, unknown_arg_ok: bool = False):
        parser = ArgumentParser()
        parser.add_argument("--benchmark", action="store_true")
        parser.add_argument("--amp", action="store_true",
                            help="bfloat16 compute, f32 parameters, no loss "
                            "scaling (as deva_tpu)")
        parser.add_argument("--remat", action="store_true",
                            help="recompute each sub-module's activations "
                            "in the backward pass (torch.utils.checkpoint) "
                            "instead of keeping them: more operations, less "
                            "activation memory")
        parser.add_argument("--device", default="cuda",
                            help="cuda (the default; each torchrun process "
                            "takes the card of its LOCAL_RANK) or cpu")

        # data roots
        parser.add_argument("--static_root", default="../static")
        parser.add_argument("--bl_root", default="../BL30K")
        parser.add_argument("--yv_root", default="../YouTube")
        parser.add_argument("--davis_root", default="../DAVIS")
        parser.add_argument("--ovis_root", default="../OVIS-VOS-train")
        parser.add_argument("--num_workers", type=int, default=16)
        parser.add_argument("--video_data_ratio", default=1.0, type=float)

        parser.add_argument("--pix_feat_dim", default=512, type=int)
        parser.add_argument("--key_dim", default=64, type=int)
        parser.add_argument("--value_dim", default=512, type=int)
        parser.add_argument("--deep_update_prob", default=0.2, type=float)

        parser.add_argument("--stages", default="03",
                            help="0-static images, 3-DAVIS+YouTubeVOS+OVIS")
        parser.add_argument("--clip_grad_norm", default=3.0, type=float)

        # stage 0
        parser.add_argument("--s0_batch_size", default=16, type=int)
        parser.add_argument("--s0_iterations", default=80000, type=int)
        parser.add_argument("--s0_steps", nargs="*", default=[], type=int)
        parser.add_argument("--s0_lr", default=2e-5, type=float)
        parser.add_argument("--s0_num_ref_frames", default=2, type=int)
        parser.add_argument("--s0_num_frames", default=3, type=int)
        parser.add_argument("--s0_start_warm", default=10000, type=int)
        parser.add_argument("--s0_end_warm", default=35000, type=int)
        parser.add_argument("--s0_schedule", default="constant")

        # stage 3
        parser.add_argument("--s3_batch_size", default=16, type=int)
        parser.add_argument("--s3_iterations", default=150000, type=int)
        parser.add_argument("--s3_steps", nargs="*",
                            default=[120000, 140000], type=int)
        parser.add_argument("--s3_lr", default=1e-5, type=float)
        parser.add_argument("--s3_num_ref_frames", default=3, type=int)
        parser.add_argument("--s3_num_frames", default=8, type=int)
        parser.add_argument("--s3_start_warm", default=10000, type=int)
        parser.add_argument("--s3_end_warm", default=35000, type=int)
        parser.add_argument("--s3_schedule", default="step")

        parser.add_argument("--gamma", default=0.1, type=float)
        parser.add_argument("--weight_decay", default=0.001, type=float)

        parser.add_argument("--load_network",
                            help="pretrained weights (.pth or .npz)")
        parser.add_argument("--load_checkpoint",
                            help="a save_checkpoint .pth to resume "
                            "from")

        parser.add_argument("--log_text_interval", default=100, type=int)
        parser.add_argument("--log_image_interval", default=1500, type=int)
        parser.add_argument("--save_network_interval", default=50000,
                            type=int)
        parser.add_argument("--save_checkpoint_interval", default=50000,
                            type=int)
        parser.add_argument("--exp_id", default="NULL")
        parser.add_argument("--debug", action="store_true")

        parser.add_argument("--crop_size", type=int, default=384,
                            help="training crop size")
        if unknown_arg_ok:
            parsed, _ = parser.parse_known_args(args)
        else:
            parsed = parser.parse_args(args)
        self.args = vars(parsed)

        for s in list(self.args["stages"]):
            if s not in ("0", "3"):
                raise NotImplementedError(s)

    def get_stage_parameters(self, stage: str) -> dict:
        return {
            "batch_size": self.args[f"s{stage}_batch_size"],
            "iterations": self.args[f"s{stage}_iterations"],
            "steps": self.args[f"s{stage}_steps"],
            "schedule": self.args[f"s{stage}_schedule"],
            "lr": self.args[f"s{stage}_lr"],
            "num_ref_frames": self.args[f"s{stage}_num_ref_frames"],
            "num_frames": self.args[f"s{stage}_num_frames"],
            "start_warm": self.args[f"s{stage}_start_warm"],
            "end_warm": self.args[f"s{stage}_end_warm"],
        }

    def __getitem__(self, key):
        return self.args[key]

    def __setitem__(self, key, value):
        self.args[key] = value

    def __str__(self):
        return str(self.args)
