"""Process groups and device meshes for multi-GPU serving and training.

Port of deva_tpu/parallel/mesh.py on torch.distributed. deva_tpu lays its
devices out as a `jax.sharding.Mesh` with axes ('data', 'model') and lets
XLA insert the collectives; here every member of the mesh is a process of
its own (one card each under torchrun), the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the same two named
dimensions, and the code that shards a tensor calls the collectives itself
(parallel/object_sharding.py, parallel/sharded_attention.py, the batched
propagators' `mesh=`).

Backends: NCCL for CUDA ranks that each own a card, gloo on the CPU. NCCL
refuses two ranks on one card ("Duplicate GPU detected"), so ranks that
share a card ask for gloo explicitly (`init_from_env(..., backend="gloo")`).
gloo moves CUDA tensors for all_reduce, broadcast and the list form of
all_gather only, so those three are the only collectives the port calls.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def init_from_env(device="cuda", backend: Optional[str] = None):
    """-> (device, rank, world_size). Joins the process group that
    torchrun's environment describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) when WORLD_SIZE > 1; a single process joins none. `device`
    'cuda' takes the card of LOCAL_RANK; 'cuda:i' takes card i (ranks that
    share a card); cuda without CUDA raises SystemExit. TF32 is turned off
    on the card, as in every entry point of the port. backend: None picks
    NCCL for CUDA and gloo for the CPU; 'gloo' carries CUDA tensors between
    ranks that share a card."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but CUDA is not available "
                             "(pass --device cpu to run on the CPU)")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise SystemExit(
                    f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                    "card(s): run one process per card")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if world > 1 and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, rank=rank, world_size=world)
    return device, rank, world


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ('data', 'model') DeviceMesh over the processes of the group,
    n_data x n_model of them (n_data defaults to world // n_model). Rank r
    sits at (r // n_model, r % n_model). The group must be joined
    (init_from_env)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} processes, the group has "
                         f"{world}")
    # the mesh's device type only names where its tensors live: NCCL groups
    # carry CUDA tensors; gloo groups carry either
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than one process (every member of a
    port mesh is a process of its own)."""
    return mesh is not None and mesh.size() > 1


def axis_group(mesh, axis: str):
    """(process group, this process's index on `axis`, the axis size)."""
    sub = mesh[axis]
    return sub.get_group(), sub.get_local_rank(), sub.size()


def _tree_map(fn, tree):
    """fn on every leaf: dicts and tuples are containers; a tensor, an
    array or a list is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch):
    """This process's rows of every leaf's leading (batch) axis: rows
    [i * B/D, (i + 1) * B/D) for its index i on 'data' (D processes). A
    leaf is a tensor, a numpy array or a list (of videos, say); dicts and
    tuples hold leaves."""
    _, i, d = axis_group(mesh, "data")

    def rows(x):
        n = len(x)
        if n % d:
            raise ValueError(f"batch {n} does not divide over {d} processes")
        return x[i * (n // d):(i + 1) * (n // d)]
    return _tree_map(rows, batch)


def replicate(mesh, tree):
    """Broadcast from the mesh's first process: an nn.Module's parameters
    and buffers in place (returns the module), or the tensors of a tree
    (returns the broadcast copies). The mesh must cover the group."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("replicate needs a mesh over the whole group")
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            dist.broadcast(t.data, src)
        return tree

    def bcast(x):
        x = torch.as_tensor(x).clone()
        dist.broadcast(x, src)
        return x
    return _tree_map(bcast, tree)


def host_all_reduce(values: Sequence[int], op, group) -> List[int]:
    """All-reduce a few host integers (ring sizes, capacities, flags) over
    `group` with `op` (dist.ReduceOp.MAX, SUM, ...), so that every process
    takes a group-wide host decision from the same numbers. They travel on
    the current card for NCCL, on the CPU for gloo."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.as_tensor(np.asarray(values, np.int64), device=dev)
    dist.all_reduce(t, op=op, group=group)
    return [int(v) for v in t.cpu().tolist()]


def group_max(group, *values: int) -> List[int]:
    """The maxima of host integers over `group`'s processes; the values
    themselves without a group."""
    if group is None:
        return [int(v) for v in values]
    return host_all_reduce(values, dist.ReduceOp.MAX, group)


def check_even_share(group, n: int) -> None:
    """Raise unless every process of `group` holds n items (videos of a
    batch sharded over it)."""
    hi, neg_lo = group_max(group, n, -n)
    if hi != -neg_lo:
        raise ValueError(
            "the group must divide evenly over the 'data' axis "
            f"({-neg_lo} to {hi} items a process): pad it or shrink the "
            "mesh")
