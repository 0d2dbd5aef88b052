"""Shared set-up of tests/test_torch_batched_detection*.py: deva_tpu_torch's
BatchedDetectionPropagator (inference/batched_detection.py) against
deva_tpu's, and against the port's own sequential InferenceCore, on the
CPU, with the clips and flows of tests/test_batched_detection.py.

Both packages take the same weights (torch_batched_common.nets: a seeded
port model carried to deva_tpu by its converter) and the same frames, and
their cores draw long ids from equal seeded generators. deva_tpu's batched
body reaches attend_pallas_approx (patched to interpret mode by the
`pallas_interpret` fixture of torch_batched_common) with the approx method;
with the exact method it runs its dense exact XLA form, the same semantics
as attend_pallas. The port runs its kernels' plain twins.

`side(pkg)` wraps either package behind one interface, so each flow is
written once. Budgets are tests/test_batched_detection.py's: on every frame
at most `budget` of the pixels may differ beyond 5e-3 in any channel, and
at most `budget` may change their argmax, with budget 2% up to frame 5 and
5% (6% with long-term memory) after (the random-init recurrence amplifies
float noise in the order of sums at boundary pixels).
"""
import dataclasses

import numpy as np

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.inference.batched_detection import \
    BatchedDetectionPropagator as JaxPropagator
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.detection_clips import online_lockstep, online_sequential
from deva_tpu_torch.inference.batched_detection import \
    BatchedDetectionPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.object_info import ObjectInfo

from torch_batched_common import nets

H, W = 64, 96


def video(rng, t, third_at=None, dx_step=2):
    """tests/test_batched_detection.py:_video: frames, detection id masks
    and segments_info dicts; segment 3 (stuff) joins at `third_at`."""
    frames, det_masks, det_infos = [], [], []
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    for i in range(t):
        img = base + 0.1 * rng.standard_normal((H // 8, W // 8, 3))
        frames.append(np.kron(img, np.ones((8, 8, 1))).astype(np.float32))
        m = np.zeros((H, W), np.int64)
        dx = dx_step * i
        m[8:28, 10 + dx:40 + dx] = 1
        m[36:60, 50:90] = 2
        info = [{"id": 1, "isthing": 1, "category_id": 5},
                {"id": 2, "isthing": 1, "category_id": 7}]
        if third_at is not None and i >= third_at:
            m[2:18, 60:88] = 3
            info.append({"id": 3, "isthing": 0, "category_id": 20})
        det_masks.append(m)
        det_infos.append(info)
    return frames, det_masks, det_infos


@dataclasses.dataclass
class Side:
    """One package's core, propagator and ObjectInfo behind one interface.
    cfg: the InferenceConfig fields (both packages take the same)."""
    port: bool
    cfg: dict

    def config(self):
        if self.port:
            return InferenceConfig(**self.cfg)
        approx = self.cfg.get("topk_method") == "approx"
        return JaxInferenceConfig(use_pallas_attention=approx, **self.cfg)

    def core(self, id_seed=5):
        net, jnet, variables = nets()
        c = InferenceCore(net, self.config()) if self.port else \
            JaxInferenceCore(jnet, variables, self.config())
        c.enabled_long_id()
        c.object_manager._rng = np.random.default_rng(id_seed)
        return c

    def propagator(self):
        net, jnet, variables = nets()
        return BatchedDetectionPropagator(net, self.config()) if self.port \
            else JaxPropagator(jnet, variables, self.config())

    def segs(self, dicts):
        cls = ObjectInfo if self.port else JaxObjectInfo
        return [cls(id=d["id"], category_id=d["category_id"],
                    isthing=bool(d["isthing"])) for d in dicts]


def side(port: bool, **cfg) -> Side:
    return Side(port, cfg)


def run_sequential(s: Side, vids, det_every):
    """detection_clips.online_sequential on per-video cores. -> (per-video
    per-frame probabilities, cores)."""
    cores = [s.core(5 + vi) for vi in range(len(vids))]
    return online_sequential(cores, vids, det_every, s.segs), cores


def run_batched(s: Side, vids, det_every, block=False):
    """detection_clips.online_lockstep (tests/test_batched_detection.py:
    _run_batched): propagation frames through step_all, or (block=True)
    through step_block by plan_block. -> (per-video per-frame
    probabilities, cores, propagator)."""
    cores = [s.core(5 + vi) for vi in range(len(vids))]
    bp = s.propagator()
    probs, _ = online_lockstep(bp, cores, vids, det_every, block,
                               segs=s.segs)
    return probs, cores, bp


def check_frames(ref, got, label, tail=0.05, frames=None):
    """tests/test_batched_detection.py's budget on every frame of every
    video: at most 2% of the pixels beyond 5e-3 or with another argmax up
    to frame 5, at most `tail` after."""
    for vi in range(len(ref)):
        for ti in (range(len(ref[vi])) if frames is None else frames):
            r, o = np.asarray(ref[vi][ti]), np.asarray(got[vi][ti])
            assert r.shape == o.shape, (label, vi, ti, r.shape, o.shape)
            budget = 0.02 if ti < 6 else tail
            bad = (np.abs(o - r) > 5e-3).any(axis=0)
            assert bad.mean() <= budget, \
                f"{label}: video {vi} frame {ti}: {bad.mean():.2%} differ"
            flips = o.argmax(0) != r.argmax(0)
            assert flips.mean() <= budget, \
                f"{label}: video {vi} frame {ti}: argmax {flips.mean():.2%}"


def bucket_table(core):
    """{bucket id: (size, objects)} and {bucket id: long-term size}."""
    return ({bid: (b.size, len(b.obj_ids))
             for bid, b in core.memory.buckets.items()},
            {bid: lt.size for bid, lt in core.memory.long_buckets.items()})
