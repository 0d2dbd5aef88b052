"""Peak device memory of each top-level part of chip_smoke.py's phases 9b
and 9c (the two demos, at 854x480 and 1280x720 input, processed at 480p),
on the card.

    python scripts/torch_demo_memory.py

Wraps InferenceCore.step, incorporate_detection and
vote_in_temporary_buffer, MobileSAM.generate and masks_for_boxes, and
automatic_processor.estimate_forward_mask (none of them calls another), and
prints for each the number of calls, its largest peak above what was
allocated when it was called, and the last three (allocated MiB, peak MiB
above it) pairs.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


class MemPart:
    """Replaces owner.name by a wrapper that records, per call, the
    allocated MiB at entry and the peak MiB above it in record[name]."""

    def __init__(self, owner, name, record):
        self.owner, self.name, self.fn = owner, name, getattr(owner, name)
        fn = self.fn

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2**20
                record.setdefault(name, []).append(
                    (round(base / 2**20, 1), round(peak, 1)))
        setattr(owner, name, wrapped)


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.ext import automatic_processor as ap
    from deva_tpu_torch.ext.mobile_sam import MobileSAM
    from deva_tpu_torch.inference import core as core_mod
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.ops import cuda_build
    cuda_build.build()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    net_cpu = init_weights(DEVANetwork(), seed=0).eval()
    for mode, (h, w) in (("auto", (cs.H480, cs.W480)),
                         ("text", (cs.H720, cs.W720))):
        rec = {}
        parts = [MemPart(core_mod.InferenceCore, n, rec) for n in (
            "step", "incorporate_detection", "vote_in_temporary_buffer")]
        parts += [MemPart(MobileSAM, n, rec) for n in ("generate",
                                                       "masks_for_boxes")]
        parts.append(MemPart(ap, "estimate_forward_mask", rec))
        cs.demo_run(ak, dev, net_cpu, mode, cs.DEMO_FRAMES, h, w,
                    keep_calls=False)
        for p in parts:
            setattr(p.owner, p.name, p.fn)
        print(mode, json.dumps({k: (len(v), max(x[1] for x in v),
                                    v[-3:]) for k, v in rec.items()}),
              flush=True)


if __name__ == "__main__":
    main()
