"""Smoke test of deva_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
this checkout and drives the port's main path (semi-supervised VOS
propagation through InferenceCore.step) on the card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. Each kernel against its plain PyTorch twin on the card, at the 480p
   main-path shapes (Q=1620 queries, Ck=64, k=30, C=2*512 value columns,
   N in {1620, 8100, 16200+512} ring tokens with partial validity masks,
   plus a ring of duplicated tokens for tie order), with times from CUDA
   events.
2. The slice on the card against the slice on the CPU (the plain
   reference): seeded weights, the 8-frame 64x96 synthetic video of
   tests/test_inference_parity.py, its config with long-term memory on;
   probabilities within 5e-3; both kernels must have launched.
3. The 480p main path: the full-width model on 60 seeded synthetic 854x480
   frames with a two-object first-frame mask at the default InferenceConfig,
   so the working memory saturates and long-term consolidation and
   [long-term ; working] attention run. Checks finite probabilities and the
   kernels' launch counts; prints ms/frame, FPS and peak device memory.

The second-to-last line of output is a JSON object with each kernel's
launches (phase 3), largest error against its plain twin and times; the last
line is {"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H480, W480 = 480, 854
KERNELS = {
    "sim_topk": ("deva_tpu_torch/csrc/sim_topk.cu",
                 "deva_tpu/ops/pallas_attention.py:177"),
    "topk_readout": ("deva_tpu_torch/csrc/topk_readout.cu",
                     "deva_tpu/ops/pallas_attention.py:249"),
}


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over `iters` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phase 1: kernels against their plain twins
# --------------------------------------------------------------------------

def phase_kernels(ak, dev) -> dict:
    q, ck, k, c = 1620, 64, 30, 2 * 512
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    qk, qe = randn(q, ck), rand(q, ck)
    ar = lambda n: torch.arange(n, device=dev)
    cases = {  # ring tokens -> validity, as the memory engine lays them out
        1620: ar(1620) < 1620,                     # one memory frame
        8100: ar(8100) < 6480,                     # working ring, 4/5 full
        16712: torch.cat([ar(512) < 128,           # [long-term ; working]
                          ar(16200) < 9720]),
    }
    err = {"sim_topk": 0.0, "topk_readout": 0.0}
    times = {}
    for n, valid in cases.items():
        mk, ms = randn(n, ck), 1 + 3 * rand(n)
        values = randn(n, 2, 512)
        gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
        rv, ri = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(gv, rv, rtol=1e-5, atol=1e-5)
        mism = (gi != ri).float().mean().item()
        assert mism < 1e-3, f"sim_topk N={n}: index mismatch share {mism}"
        assert int(gi.min()) >= 0 and int(gi.max()) < n
        err["sim_topk"] = max(err["sim_topk"], (gv - rv).abs().max().item())

        w = torch.softmax(gv, dim=-1)
        v2 = values.reshape(n, c)
        out = ak.topk_readout(gi, w, v2)
        ref = ak.topk_readout_plain(gi, w, v2)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        err["topk_readout"] = max(err["topk_readout"],
                                  (out - ref).abs().max().item())

        o, u = ak.attend_topk(mk, ms, values, qk, qe, k, valid, True)
        ro, ru = ak.attend_topk_plain(mk, ms, values, qk, qe, k, valid, True)
        torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(u, ru, rtol=1e-4, atol=1e-4)

        t = {
            "sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk, ms, valid,
                                                    k)),
            "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
                qk, qe, mk, ms, valid, k)),
            "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, v2)),
            "topk_readout_plain": cuda_ms(
                lambda: ak.topk_readout_plain(gi, w, v2)),
            "attend_topk": cuda_ms(lambda: ak.attend_topk(
                mk, ms, values, qk, qe, k, valid, True)),
            "attend_topk_plain": cuda_ms(lambda: ak.attend_topk_plain(
                mk, ms, values, qk, qe, k, valid, True)),
        }
        times[n] = t
        print(f"phase 1 N={n}: sim_topk err {(gv - rv).abs().max().item():.3g}"
              f" idx-mismatch {mism:.2e}; readout err "
              f"{(out - ref).abs().max().item():.3g}; usage err "
              f"{(u - ru).abs().max().item():.3g}; ms " +
              ", ".join(f"{name} {v:.4f}" for name, v in t.items()),
              flush=True)

    # ties: 10 copies of 1620 tokens; for each query the exact top-30 is the
    # 10 copies of its best 3 base tokens, lowest copy first
    base_n = 1620
    mk = randn(base_n, ck).repeat(10, 1)
    ms = (1 + 3 * rand(base_n)).repeat(10)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, None, k)
    bv = ak.sim_topk_plain(qk, qe, mk[:base_n], ms[:base_n], None, 3)[0]
    bi = ak.sim_topk(qk, qe, mk[:base_n], ms[:base_n], None, 3)[1]
    copies = torch.arange(10, device=dev) * base_n
    expect = (bi.long()[:, :, None] + copies).reshape(q, k)
    assert torch.equal(gi.long(), expect), "tie order differs"
    torch.testing.assert_close(gv, bv.repeat_interleave(10, dim=1),
                               rtol=1e-5, atol=1e-5)
    print("phase 1 ties: duplicated ring of 16200 tokens resolves to the "
          "lowest index", flush=True)
    return {"err": err, "times": times}


# --------------------------------------------------------------------------
# phase 2: the slice on the card against the slice on the CPU
# --------------------------------------------------------------------------

def synthetic_video(rng, h, w, t):
    """Smooth random frames: 8x8 blocks of one random image plus 0.1 noise
    per frame (tests/test_inference_parity.py:25-33)."""
    base = rng.standard_normal((-(-h // 8), -(-w // 8), 3)).astype(np.float32)
    frames = []
    for _ in range(t):
        img = base + 0.1 * rng.standard_normal(base.shape)
        frames.append(img.repeat(8, 0).repeat(8, 1)[:h, :w]
                      .astype(np.float32))
    return frames


def two_object_mask(h, w, rows1, cols1, rows2, cols2):
    mask = np.zeros((h, w), np.int64)
    mask[slice(*rows1), slice(*cols1)] = 1
    mask[slice(*rows2), slice(*cols2)] = 2
    return mask


def phase_slice_parity(ak, net_cpu, dev):
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    cfg = InferenceConfig(mem_every=2, top_k=8, enable_long_term=True,
                          enable_long_term_count_usage=True,
                          max_mid_term_frames=3, min_mid_term_frames=1,
                          num_prototypes=16, max_long_term_elements=96)
    frames = synthetic_video(np.random.default_rng(7), 64, 96, 8)
    mask = two_object_mask(64, 96, (8, 28), (10, 40), (36, 60), (50, 90))
    net_gpu = copy.deepcopy(net_cpu).to(dev)
    cpu_core = InferenceCore(net_cpu, cfg)
    gpu_core = InferenceCore(net_gpu, cfg)
    ak.reset_launch_counts()
    worst = 0.0
    for ti, img in enumerate(frames):
        args = (mask, [1, 2]) if ti == 0 else ()
        p_cpu = cpu_core.step(img, *args)
        p_gpu = gpu_core.step(img, *args).cpu()
        assert p_gpu.shape == p_cpu.shape == (3, 64, 96)
        diff = (p_gpu - p_cpu).abs().max().item()
        worst = max(worst, diff)
        assert diff <= 5e-3, f"frame {ti}: |card - cpu| = {diff}"
    launches = dict(ak.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    lt = gpu_core.memory.long_buckets.get(0)
    assert lt is not None and lt.size > 0, "long-term memory never engaged"
    print(f"phase 2: card vs cpu slice max |dprob| {worst:.3g} over 8 frames "
          f"(bound 5e-3); launches {launches}; long-term tokens {lt.size}",
          flush=True)


# --------------------------------------------------------------------------
# phase 3: the 480p main path
# --------------------------------------------------------------------------

def phase_main_path(ak, net_cpu, dev, n_frames: int = 60) -> dict:
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    frames = synthetic_video(np.random.default_rng(11), H480, W480,
                             n_frames)
    # a rider above a bike, as in bmx-trees
    mask = two_object_mask(H480, W480, (60, 300), (330, 520), (260, 450),
                           (250, 620))
    frames = [torch.from_numpy(f).to(dev) for f in frames]  # set-up
    net = copy.deepcopy(net_cpu).to(dev)
    core = InferenceCore(net, InferenceConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ak.reset_launch_counts()
    step_ms = []
    for ti, img in enumerate(frames):
        args = (mask, [1, 2]) if ti == 0 else ()
        t0 = time.perf_counter()
        prob = core.step(img, *args, end=(ti == n_frames - 1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1000)
        assert prob.shape == (3, H480, W480), tuple(prob.shape)
        assert bool(torch.isfinite(prob).all()), f"frame {ti}: non-finite"
        torch.testing.assert_close(prob.sum(0), torch.ones_like(prob[0]),
                                   rtol=0, atol=1e-4)
    launches = dict(ak.LAUNCHES)

    propagated = n_frames - 1
    assert all(v >= propagated for v in launches.values()), launches
    lt = core.memory.long_buckets.get(0)
    assert lt is not None and lt.size > 0, "long-term memory never engaged"
    work = core.memory.buckets[0]
    steady = step_ms[10:]
    med = statistics.median(steady)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 3: 480p main path, {n_frames} frames, 2 objects, default "
          f"InferenceConfig: launches {launches}; long-term tokens "
          f"{lt.size}/{lt.cap}, working tokens {work.size}/{work.cap}",
          flush=True)
    print(f"phase 3: step ms/frame median {med:.3f} (frames 10-{n_frames-1};"
          f" mean {statistics.mean(steady):.3f}, min {min(steady):.3f}, max "
          f"{max(steady):.3f}); FPS {1000 / med:.2f}; first frame "
          f"{step_ms[0]:.1f} ms; peak allocated {peak / 2**20:.1f} MiB",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{os.path.relpath(lib, ROOT)}", flush=True)

    k = phase_kernels(ak, dev)
    net_cpu = init_weights(DEVANetwork(), seed=0).eval()
    phase_slice_parity(ak, net_cpu, dev)
    launches = phase_main_path(ak, net_cpu, dev)

    main_shape = k["times"][16712]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": k["err"][name],
         "ms": main_shape[name], "plain_ms": main_shape[name + "_plain"]}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
