"""Weights-only exports and full checkpoints, with torch.save.

Port of deva_tpu/training/checkpoint.py, in upstream DEVA's schema
(reference:deva/model/trainer.py:208-263): `save_network` writes the
network's state dict alone, which evaluation/eval_vos_torch.py --model and
deva_tpu's load_torch_checkpoint read unchanged; `save_checkpoint` writes
{it, network, optimizer, scheduler} for a resume.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from deva_tpu_torch.models.convert import variables_to_state_dict


def _makedirs(save_path: str) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)


def save_network(net: torch.nn.Module, save_path: str, it: int) -> str:
    """-> {save_path}_{it//1000}K.pth, the network's state dict on the
    CPU."""
    _makedirs(save_path)
    out = f"{save_path}_{it // 1000}K.pth"
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               out)
    print(f"Network saved to {out}.")
    return out


def save_checkpoint(trainer, save_path: str, it: int) -> str:
    """The trainer's {it, network, optimizer, scheduler} ->
    {save_path}_checkpoint_{it}.pth."""
    _makedirs(save_path)
    out = f"{save_path}_checkpoint_{it}.pth"
    torch.save(trainer.state_dict(), out)
    print(f"Checkpoint saved to {out}.")
    return out


def load_checkpoint(trainer, path: str) -> int:
    """Restore a trainer from save_checkpoint's file; -> its iteration."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(state)
    print("Network weights, optimizer states, and step loaded.")
    return trainer.it


def load_network_weights(path: str):
    """A state dict for DEVANetwork from a weights-only .pth (save_network's,
    or upstream DEVA's) or from a deva_tpu .npz (its save_network or
    eval_args.save_variables_npz)."""
    if path.endswith(".npz"):
        with np.load(path) as npz:
            return variables_to_state_dict(dict(npz))
    return torch.load(path, map_location="cpu", weights_only=True)
