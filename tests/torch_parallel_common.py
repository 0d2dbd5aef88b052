"""Shared set-up of the multi-process tests of the port's multi-GPU serving
(tests/test_torch_parallel_mesh.py, test_torch_sharded_attention.py,
test_torch_object_sharding.py, test_torch_batched_mesh.py).

The port's processes are gloo ranks on the CPU, started as subprocesses in
the manner of tests/test_torch_train_ddp.py: a free port from
socket.bind(0), torchrun's environment variables, torch.set_num_threads(1)
in each, and a timeout on the join. Run as a script, this file is the
worker:

    python tests/torch_parallel_common.py CASE OUT [ARG...]

joins the group (parallel.mesh.init_from_env('cpu')), runs CASE and saves
its result to OUT with torch.save. The inputs are made from seeds with
numpy, here, so that the test process (which runs deva_tpu, and the port
unsharded) and the workers see the same numbers. jax and deva_tpu are
imported inside the functions that the test process runs: the workers load
the port alone.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(pix_feat_dim=64, key_dim=16, value_dim=32)
H, W = 64, 96
JOIN_TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


# what a rank prints when the free port was taken before its store bound
# it (the port is free when chosen, not reserved): such a run starts anew
PORT_TAKEN = ("Address already in use", "EADDRINUSE")


def join(procs, timeout: int = JOIN_TIMEOUT) -> bool:
    """Wait for every rank; a rank that fails or hangs fails the test (and
    the others are killed). -> False (and nothing fails) when the ranks
    found their port taken, for the caller to start them anew."""
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0 and any(m in out for m in PORT_TAKEN):
                return False
            assert p.returncode == 0, out[-6000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return True


def start(world: int, case: str, tmp_path, *args):
    """Start CASE on `world` gloo ranks; finish() collects them (the test
    process computes its references meanwhile)."""
    port = free_port()
    outs = [str(tmp_path / f"{case}_{world}_{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, outs[r],
         *map(str, args)], env=rank_env(r, world, port), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, outs, (world, case, tmp_path, args)


def finish(started):
    """-> each rank's saved result of a start()ed case (started once more
    on a fresh port if its port was taken)."""
    procs, outs, again = started
    if not join(procs):
        procs, outs, _ = start(again[0], again[1], again[2], *again[3])
        assert join(procs), "the ranks' port was taken twice"
    return [torch.load(o, weights_only=False) for o in outs]


def spawn(world: int, case: str, tmp_path, *args):
    """Run CASE on `world` gloo ranks -> each rank's saved result."""
    return finish(start(world, case, tmp_path, *args))


def spawn_script(world: int, argv, timeout: int = JOIN_TIMEOUT):
    """Run a driver script on `world` gloo ranks (as torchrun would) ->
    each rank's (exit code, output); run anew on a fresh port if the
    first one was taken."""
    outs = _spawn_script(world, argv, timeout)
    if any(rc != 0 and any(m in out for m in PORT_TAKEN)
           for rc, out in outs):
        outs = _spawn_script(world, argv, timeout)
    return outs


def _spawn_script(world: int, argv, timeout: int):
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *map(str, argv)],
                              env=dict(rank_env(r, world, port),
                                       HF_HUB_OFFLINE="1"),
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


# --------------------------------------------------------------------------
# seeded inputs, the same in the test process and the workers
# --------------------------------------------------------------------------

def tiny_net(seed: int = 0):
    from deva_tpu_torch.config import ModelConfig
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    return init_weights(DEVANetwork(ModelConfig(**TINY)), seed).eval()


def jax_net(net):
    """deva_tpu's tiny model and variables with the port net's weights."""
    from deva_tpu.config import ModelConfig as JaxModelConfig
    from deva_tpu.models.convert import convert_torch_statedict
    from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return JaxDEVANetwork(JaxModelConfig(**TINY)), variables


# tests/test_object_sharding.py's configurations
CORE_CFG = dict(mem_every=2, top_k=8, enable_long_term=True,
                enable_long_term_count_usage=True, max_mid_term_frames=3,
                min_mid_term_frames=1, num_prototypes=8)
CHUNK_CFG = dict(mem_every=2, top_k=8, enable_long_term=False)
# (seed, frames) of each mode's video: 7 frames reach a long-term
# consolidation at frame 4
CORE_VIDEOS = {"step": (7, 7), "chunk": (8, 7)}


def core_video(seed: int, t: int):
    """tests/test_object_sharding.py:_video: t frames and a first mask of
    four objects."""
    rng = np.random.default_rng(seed)
    frames = [rng.standard_normal((H, W, 3)).astype(np.float32)
              for _ in range(t)]
    mask0 = np.zeros((H, W), np.int64)
    mask0[4:20, 8:40] = 1
    mask0[30:60, 50:90] = 2
    mask0[4:20, 60:90] = 3
    mask0[40:60, 4:30] = 4
    return frames, mask0


def run_core(core, frames, mask0, chunk: bool):
    """The first frame with its mask through step, the rest through step
    (or one step_chunk) -> per-frame probabilities on the host."""
    from deva_tpu_torch.detection_clips import host
    out = [host(core.step(frames[0], mask0, objects=[1, 2, 3, 4]))]
    rest = core.step_chunk(frames[1:]) if chunk else \
        [core.step(f) for f in frames[1:]]
    return out + [host(p) for p in rest]


# the detection clip: detections every 2 frames. Objects 1, 2 at frame 0;
# 3 and 4 join at frame 2 (the padded object count grows); 2, 3 and 4 are
# missed at frames 4, 6 and 8 and purged at frame 8, where 5 joins: its
# kept row lies beyond the sensory's and reads the last slot (C-2)
DET_CFG = dict(mem_every=2, top_k=8, enable_long_term=False,
               max_missed_detection_count=2)
DET_BOXES = {1: (4, 20, 8, 40), 2: (30, 60, 50, 90), 3: (4, 20, 60, 90),
             4: (40, 60, 4, 30), 5: (24, 36, 30, 60)}
DET_IDS = {0: (1, 2), 2: (1, 2, 3, 4), 4: (1,), 6: (1,), 8: (1, 5),
           10: (1, 5)}
DET_T = 12
PURGE_FRAME = 8


def det_clip(seed: int = 3):
    """-> frames [H, W, 3], detection id masks (None off detection frames)
    and segments_info dicts."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    frames, masks, infos = [], [], []
    for ti in range(DET_T):
        img = base + 0.1 * rng.standard_normal((H // 8, W // 8, 3))
        frames.append(np.kron(img, np.ones((8, 8, 1))).astype(np.float32))
        ids = DET_IDS.get(ti)
        if ids is None:
            masks.append(None)
            infos.append(None)
            continue
        m = np.zeros((H, W), np.int64)
        for i in ids:
            r0, r1, c0, c1 = DET_BOXES[i]
            m[r0:r1, c0:c1] = i
        masks.append(m)
        infos.append([{"id": i, "isthing": 1, "category_id": 3 + i}
                      for i in ids])
    return frames, masks, infos


# spatial_alignment's case: three of frame 2's detections projected from
# frame 2 onto frame 3 (three objects: the sharded core pads them to 4)
ALIGN_IDS = (1, 2, 3)


def align_inputs():
    """-> (source frame, one-hot source mask [3, H, W] f32, target
    frame) from det_clip."""
    frames, masks, _ = det_clip()
    src = np.stack([masks[2] == i for i in ALIGN_IDS]).astype(np.float32)
    return frames[2], src, frames[3]


def run_det(core, info_cls, sensory_of):
    """The online loop on det_clip with perfect forward predictions (the
    host decisions then read no device output) -> (per-frame probabilities
    [1 + n, H, W] on the host: the softmax of a detection frame's logits,
    the whole sensory [O_cap, ...] after the purge frame, the object table
    after every frame)."""
    from deva_tpu_torch.detection_clips import (host, object_table,
                                                perfect_forward,
                                                segment_infos)
    frames, masks, infos = det_clip()
    out, tables, sensory = [], [], None
    for ti, img in enumerate(frames):
        if masks[ti] is not None:
            lg = host(core.incorporate_detection(
                img, masks[ti], segment_infos(infos[ti], info_cls),
                forward_mask=perfect_forward(core, masks[ti])))
            e = np.exp(lg - lg.max(0))
            out.append(e / e.sum(0))
        else:
            out.append(host(core.step(img)))
        if ti == PURGE_FRAME:
            sensory = sensory_of(core)
        tables.append(object_table(core))
    return out, sensory, tables


# tests/test_sharded_attention.py:_inputs, with N not a multiple of the
# shard counts (pad_tokens pads it)
ATT_N, ATT_Q, ATT_O, ATT_CK, ATT_CV, ATT_VALID, ATT_K = 1001, 96, 3, 64, 64, \
    900, 30
ATT_RUNS = {"exact": ("exact", None, 0), "no_ms": ("exact", "ms", 1),
            "no_qe": ("exact", "qe", 1), "approx": ("approx", None, 2)}


def att_inputs(seed: int, n_pad: int = ATT_N):
    """mk [N, Ck], ms [N], values [O, N, Cv] (deva_tpu's layout), qk, qe
    [Q, Ck], valid [N] (the first ATT_VALID tokens), with the token axis
    zero-padded to n_pad (padding invalid)."""
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((ATT_N, ATT_CK)).astype(np.float32)
    ms = rng.uniform(1.0, 4.0, (ATT_N,)).astype(np.float32)
    v = rng.standard_normal((ATT_O, ATT_N, ATT_CV)).astype(np.float32)
    qk = rng.standard_normal((ATT_Q, ATT_CK)).astype(np.float32)
    qe = rng.uniform(0.0, 1.0, (ATT_Q, ATT_CK)).astype(np.float32)
    valid = np.arange(ATT_N) < ATT_VALID
    pad = n_pad - ATT_N
    return (np.pad(mk, ((0, pad), (0, 0))), np.pad(ms, (0, pad)),
            np.pad(v, ((0, 0), (0, pad), (0, 0))), qk, qe,
            np.pad(valid, (0, pad)))


# the batched propagators: tests/test_batched.py's and
# tests/test_batched_detection.py's videos and configurations
BATCH_OBJECTS = [[1], [1, 2], [1, 2], [1]]
BATCH_CFG = dict(mem_every=1, top_k=8, enable_long_term=True,
                 enable_long_term_count_usage=True, max_mid_term_frames=3,
                 min_mid_term_frames=1, num_prototypes=8,
                 max_long_term_elements=24)
BATCH_T = 5
BDET_CFG = dict(mem_every=2, top_k=8, enable_long_term=True,
                enable_long_term_count_usage=True, max_mid_term_frames=4,
                min_mid_term_frames=2, num_prototypes=8,
                max_missed_detection_count=5)
BDET_T = 6


def batch_videos(seed: int = 11):
    """tests/test_batched.py:_video for each of BATCH_OBJECTS."""
    rng = np.random.default_rng(seed)
    out = []
    for objs in BATCH_OBJECTS:
        base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
        frames = [np.kron(base + 0.1 * rng.standard_normal(
            (H // 8, W // 8, 3)), np.ones((8, 8, 1))).astype(np.float32)
            for _ in range(BATCH_T)]
        mask0 = np.zeros((H, W), np.int64)
        mask0[8:28, 10:40] = 1
        if len(objs) > 1:
            mask0[36:60, 50:90] = 2
        out.append((frames, mask0))
    return out


def bdet_videos(seed: int = 61):
    """tests/test_batched_detection.py:_video: two videos, the first with
    a third (stuff) object from frame 1."""
    rng = np.random.default_rng(seed)
    out = []
    for third_at in (1, None):
        frames, masks, infos = [], [], []
        base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
        for i in range(BDET_T):
            img = base + 0.1 * rng.standard_normal((H // 8, W // 8, 3))
            frames.append(np.kron(img, np.ones((8, 8, 1))).astype(
                np.float32))
            m = np.zeros((H, W), np.int64)
            m[8:28, 10 + 2 * i:40 + 2 * i] = 1
            m[36:60, 50:90] = 2
            info = [{"id": 1, "isthing": 1, "category_id": 5},
                    {"id": 2, "isthing": 1, "category_id": 7}]
            if third_at is not None and i >= third_at:
                m[2:18, 60:88] = 3
                info.append({"id": 3, "isthing": 0, "category_id": 20})
            masks.append(m)
            infos.append(info)
        out.append((frames, masks, infos))
    return out


def run_batched(bp, vids, objects):
    """initialize on the videos' first frames, then step_all -> per-frame
    probabilities [B, 1 + O_cap, H, W] on the host."""
    bp.initialize([v[0][0] for v in vids], [v[1] for v in vids], objects)
    return [np.asarray(bp.step_all([v[0][ti] for v in vids]))
            for ti in range(1, BATCH_T)]


def run_bdet(bp, cores, vids, info_cls):
    """tests/test_batched_detection.py's multibucket mesh run: two
    detections per core, attach, then step_block by plan_block ->
    (per-block probabilities [B, K, 1 + o_cap, H, W] on the host, sizes,
    long-term sizes)."""
    from deva_tpu_torch.detection_clips import segment_infos
    for core, (frames, masks, infos) in zip(cores, vids):
        core.enabled_long_id()
        core.object_manager._rng = np.random.default_rng(5)
        for ti in (0, 1):
            core.incorporate_detection(frames[ti], masks[ti],
                                       segment_infos(infos[ti], info_cls))
    bp.attach(cores)
    out = []
    ti = 2
    while ti < BDET_T:
        k = bp.plan_block(min(BDET_CFG["mem_every"], BDET_T - ti))
        out.append(np.asarray(bp.step_block(
            [np.stack(v[0][ti:ti + k]) for v in vids])))
        ti += k
    sizes, lt_sizes = bp.sizes.copy(), bp.lt_sizes.copy()
    bp.detach()
    return out, sizes, lt_sizes


# --------------------------------------------------------------------------
# the workers' cases
# --------------------------------------------------------------------------

def _obj_core(cfg: dict, method: str, world: int):
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.parallel.mesh import make_mesh
    return InferenceCore(tiny_net(), InferenceConfig(topk_method=method,
                                                     **cfg),
                         device="cpu", obj_mesh=make_mesh(1, world))


def case_core(world, method):
    """The object-sharded core on core_video, through step (long-term
    memory on) and through step_chunk -> {mode: its probabilities, its
    bookkeeping and its own slots' state}."""
    out = {}
    for mode in ("step", "chunk"):
        chunk = mode == "chunk"
        core = _obj_core(CHUNK_CFG if chunk else CORE_CFG, method, world)
        frames, mask0 = core_video(*CORE_VIDEOS[mode])
        probs = run_core(core, frames, mask0, chunk)
        (_, b), = core.memory.buckets.items()
        out[mode] = {
            "probs": probs, "curr_ti": core.curr_ti,
            "last_mem_ti": core.last_mem_ti, "size": b.size,
            "sensory_slots": core.memory.sensory.shape[0],
            "value_cols": b.value.shape[1],
            "lt_size": [lt.size for lt in core.memory.long_buckets.values()]}
    return out


def case_det(world, method):
    """The object-sharded core on det_clip, then its spatial_alignment on
    align_inputs."""
    from deva_tpu_torch.inference.object_info import ObjectInfo
    core = _obj_core(DET_CFG, method, world)
    out, sensory, tables = run_det(
        core, ObjectInfo, lambda c: c._shards.gather(c.memory.sensory))
    src_image, src_mask, tar_image = align_inputs()
    align = core.spatial_alignment(100, src_image, src_mask, 101, tar_image)
    return {"probs": out, "sensory": sensory, "tables": tables,
            "align": align,
            "o_cap": core.o_cap,
            "buckets": {bid: (b.obj_ids, b.o_cap, b.value.shape[1])
                        for bid, b in core.memory.buckets.items()}}


def case_attention(world):
    """attend_mem_sharded on this process's token shard, for each of
    ATT_RUNS -> {run: (out [O, Q, Cv], usage [N/D] or None)}."""
    from deva_tpu_torch.parallel.mesh import make_mesh
    from deva_tpu_torch.parallel.sharded_attention import (attend_mem_sharded,
                                                           pad_tokens)
    mesh = make_mesh(world, 1)
    n = pad_tokens(ATT_N, world)
    rank = torch.distributed.get_rank()
    rows = slice(rank * n // world, (rank + 1) * n // world)
    out = {}
    for run, (method, drop, seed) in ATT_RUNS.items():
        mk, ms, v, qk, qe, valid = (torch.from_numpy(a) for a in
                                    att_inputs(seed, n))
        usage = drop is None
        res = attend_mem_sharded(
            mk[rows], None if drop == "ms" else ms[rows],
            v[:, rows].transpose(0, 1).contiguous(), qk,
            None if drop == "qe" else qe, ATT_K, valid[rows], mesh,
            axis="data", method=method, return_usage=usage)
        out[run] = res if usage else (res, None)
    return out


def case_batched(world, method):
    """BatchedPropagator with a 'data' mesh on this process's videos."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched import BatchedPropagator
    from deva_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(world, 1)
    vids = shard_batch(mesh, batch_videos())
    objs = shard_batch(mesh, BATCH_OBJECTS)
    bp = BatchedPropagator(tiny_net(), InferenceConfig(
        topk_method=method, **BATCH_CFG), mesh=mesh)
    probs = run_batched(bp, vids, objs)
    return {"probs": probs, "sizes": bp.sizes, "lt_sizes": bp.lt_sizes,
            "o_cap": bp.o_cap, "cap": bp.key.shape[1],
            "lcap": bp.lt_key.shape[1]}


def case_bdet(world, method):
    """BatchedDetectionPropagator with a 'data' mesh on this process's
    videos."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched_detection import \
        BatchedDetectionPropagator
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.inference.object_info import ObjectInfo
    from deva_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(world, 1)
    vids = shard_batch(mesh, bdet_videos())
    net = tiny_net()
    cfg = InferenceConfig(topk_method=method, **BDET_CFG)
    cores = [InferenceCore(net, cfg, device="cpu") for _ in vids]
    bp = BatchedDetectionPropagator(net, cfg, mesh=mesh)
    out, sizes, lt_sizes = run_bdet(bp, cores, vids, ObjectInfo)
    return {"probs": out, "sizes": sizes, "lt_sizes": lt_sizes,
            "o_cap": bp.o_cap, "n_slots": bp.n_slots}


# the object-axis helpers' inputs: 8 object slots, with a layout change
# that moves slots across ranks (a purge of 1, 2 and 6 with a clamped row,
# then zeros)
SLOTS = 8
REGATHER_SRC = [0, 3, 4, 5, 7, 7, -1, -1]


def slot_inputs(seed: int = 4):
    """x [SLOTS, 3, 5] (a slot tensor), prob [SLOTS, 6, 7] in (0, 1) and
    logits [1 + SLOTS, 6, 7] (background first)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((SLOTS, 3, 5)).astype(np.float32),
            rng.uniform(0.01, 0.99, (SLOTS, 6, 7)).astype(np.float32),
            rng.standard_normal((1 + SLOTS, 6, 7)).astype(np.float32))


def case_mesh(world):
    """The mesh helpers and the object-axis collectives on this process ->
    their results (the test process holds them to the whole-tensor
    forms)."""
    import torch.distributed as dist
    from deva_tpu_torch.models.network import _aggregate
    from deva_tpu_torch.ops.aggregate import aggregate_logits
    from deva_tpu_torch.parallel import object_sharding as osh
    from deva_tpu_torch.parallel.mesh import (host_all_reduce,
                                              is_multiprocess, make_mesh,
                                              replicate, shard_batch)
    rank = dist.get_rank()
    out = {}
    for dims in ((1, world), (world, 1), (2, world // 2)):
        mesh = make_mesh(*dims)
        out[dims] = {
            "names": mesh.mesh_dim_names, "multi": is_multiprocess(mesh),
            "index": (mesh["data"].get_local_rank(),
                      mesh["model"].get_local_rank()),
            "sizes": (mesh["data"].size(), mesh["model"].size())}
    mesh = make_mesh(world, 1)
    batch = {"x": torch.arange(2 * world * 3).reshape(2 * world, 3),
             "videos": [f"v{i}" for i in range(2 * world)]}
    out["shard"] = shard_batch(mesh, batch)
    net = tiny_net(seed=rank)  # different weights on every process
    replicate(mesh, net)
    out["weights"] = {k: v.clone() for k, v in net.state_dict().items()}
    out["tree"] = replicate(mesh, (torch.full((2,), float(rank)),))
    out["max"] = host_all_reduce([rank, -rank], dist.ReduceOp.MAX,
                                 mesh["data"].get_group())
    out["sum"] = host_all_reduce([rank + 1], dist.ReduceOp.SUM,
                                 mesh["data"].get_group())

    shards = osh.ObjectShards(make_mesh(1, world))
    x, prob, logits = (torch.from_numpy(a) for a in slot_inputs())
    mine = shards.take(x)
    out["take"] = mine.clone()
    out["gather"] = shards.gather(mine)
    out["regather"] = shards.regather(mine, REGATHER_SRC)
    lo, hi = shards.span(SLOTS)
    out["gather_prob"] = shards.gather_prob(
        torch.cat([torch.full((1, 3, 5), float(rank)), mine]))
    out["broadcast0"] = shards.broadcast0(torch.full((3,), float(rank)))
    out["product"] = osh.object_product(1 - prob[lo:hi], 0, shards.group)
    out["softmax"] = osh.object_softmax(
        torch.cat([logits[:1], logits[1 + lo:1 + hi]]), 0, shards.group)
    out["aggregate"] = aggregate_logits(prob[lo:hi], 0, shards.group)
    sel = (torch.arange(SLOTS) < SLOTS - 1).float()[None]
    out["_aggregate"] = _aggregate(logits[None, 1 + lo:1 + hi],
                                   sel[:, lo:hi], 4, shards.group)
    return out


def case_cuda_attention(world):
    """attend_mem_sharded on the card (ranks sharing card 0 over gloo) at
    N=2000 (not a multiple of the ranks: padded), Q=300: its launches, and
    on rank 0 the single-device attend_topk -> (out, usage, launches, the
    unsharded out and usage, on the host)."""
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.parallel.mesh import make_mesh
    from deva_tpu_torch.parallel.sharded_attention import (attend_mem_sharded,
                                                           pad_tokens)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    n = pad_tokens(2001, world)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    mk, ms = t(rng.standard_normal((n, 64))), t(rng.uniform(1, 4, (n,)))
    values = t(rng.standard_normal((n, 2, 64)))
    qk, qe = t(rng.standard_normal((300, 64))), t(rng.uniform(0, 1, (300,
                                                                    64)))
    valid = torch.arange(n, device=dev) < 1900
    rank = torch.distributed.get_rank()
    rows = slice(rank * n // world, (rank + 1) * n // world)
    ak.reset_launch_counts()
    out, usage = attend_mem_sharded(mk[rows], ms[rows], values[rows], qk, qe,
                                    30, valid[rows], make_mesh(world, 1),
                                    return_usage=True)
    torch.cuda.synchronize()
    res = {"out": out.cpu(), "usage": usage.cpu(),
           "launches": dict(ak.LAUNCHES)}
    if rank == 0:
        ref, ref_u = ak.attend_topk(mk, ms, values, qk, qe, 30, valid,
                                    return_usage=True)
        res.update(ref=ref.cpu(), ref_usage=ref_u.cpu())
    return res


def case_cuda_core(world):
    """The object-sharded core on the card (ranks sharing card 0 over gloo)
    on core_video's step run, its launches; on rank 0 the unsharded core's
    run on the card too -> probabilities on the host."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    net = tiny_net().to(dev)
    cfg = InferenceConfig(**CORE_CFG)
    frames, mask0 = core_video(*CORE_VIDEOS["step"])
    res = {}
    if torch.distributed.get_rank() == 0:
        res["ref"] = run_core(InferenceCore(net, cfg), frames, mask0, False)
    torch.distributed.barrier()
    ak.reset_launch_counts()
    core = InferenceCore(net, cfg, obj_mesh=make_mesh(1, world))
    res["probs"] = run_core(core, frames, mask0, False)
    res["launches"] = dict(ak.LAUNCHES)
    res["slots"] = core.memory.sensory.shape[0]
    return res


CASES = {"cuda_attention": case_cuda_attention, "cuda_core": case_cuda_core,
         "mesh": case_mesh, "core": case_core, "det": case_det,
         "attention": case_attention, "batched": case_batched,
         "bdet": case_bdet}


def main(argv):
    case, out, args = argv[1], argv[2], argv[3:]
    torch.set_num_threads(1)
    from deva_tpu_torch.parallel.mesh import init_from_env
    # the card's cases: every rank on card 0, so gloo (NCCL refuses two
    # ranks on one card)
    _, rank, world = init_from_env("cuda:0", backend="gloo") \
        if case.startswith("cuda_") else init_from_env("cpu")
    result = CASES[case](world, *args)
    torch.save(result, out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv)
