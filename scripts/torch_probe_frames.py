"""Frame-time probes of deva_tpu_torch's 480p path on a CUDA device, around
chip_smoke.py's phases (run from the repository root):

    python scripts/torch_probe_frames.py weight-cache
        bf16 phases 3 and 4 with models/layers.py casting every weight on
        every call against keeping one bf16 copy of each weight (keyed on
        its storage and version), alternating cached / uncached /
        uncached / cached / cached / uncached;
    python scripts/torch_probe_frames.py order
        the bf16 phase 3 in one process after other work (an f32 run, the
        CPU slice, a sleep, one CPU thread), to see what moves its frame;
    python scripts/torch_probe_frames.py kernels ROOT OUT
        the f32 kernel outputs of the tree at ROOT (another checkout, or
        this one) at phase 1's rings N = 1620 and 16712, saved to OUT.pt,
        and that tree's phase 3 (f32, exact) frame time;
    python scripts/torch_probe_frames.py compare A.pt B.pt
        whether two such sets of outputs are bitwise the same;
    python scripts/torch_probe_frames.py kernel-times ROOT
        the single-video device ms of the four kernels of the tree at ROOT
        at phase 1's shapes (N = 1620 and 16712, f32 and bf16 rings;
        chip_smoke.cuda_ms), and the registers ptxas gave each instance of
        its denom_readout kernel.

Each run line prints chip_smoke's median, mean and peak allocated memory.
"""
from __future__ import annotations

import contextlib
import io
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("sim_topk values", "sim_topk indices", "topk_readout",
           "topk_readout two segments", "segmax", "denom_readout out",
           "rmax", "th")


def _setup(root: str):
    sys.path.insert(0, root)
    import chip_smoke as cs
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.ops import attention_kernels as ak
    assert ak.__file__.startswith(os.path.abspath(root)), ak.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return cs, ak, init_weights(DEVANetwork(), seed=0).eval()


def _run(label: str, fn) -> None:
    """fn() with its output captured; prints its last frame-time line."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = [ln for ln in buf.getvalue().splitlines()
             if "ms/frame median" in ln]
    tail = lines[-1].split("ms/frame")[1].strip() if lines else ""
    print(f"{label} ({time.perf_counter() - t0:.1f} s): {tail}", flush=True)


def weight_cache() -> None:
    cs, ak, net = _setup(ROOT)
    from deva_tpu_torch.models import layers
    dev = torch.device("cuda", 0)
    net16 = cs.with_dtype(net, "bfloat16")
    uncached, copies = layers._cast, {}

    def cached(p, dtype):
        if p is None or p.dtype == dtype:
            return p
        key = (p.data_ptr(), p._version, dtype)
        if key not in copies:
            copies[key] = p.to(dtype)
        return copies[key]

    for variant in ("cached", "uncached", "uncached", "cached", "cached",
                    "uncached"):
        layers._cast = cached if variant == "cached" else uncached
        # each phase copies the model to the card anew: its parameters may
        # take the storage of the last phase's, so the copies start empty
        copies.clear()
        _run(f"{variant} exact", lambda: cs.phase_main_path(
            ak, net16, dev, ring_dtype="bfloat16"))
        copies.clear()
        _run(f"{variant} approx", lambda: cs.phase_main_path_approx(
            ak, net16, dev, ring_dtype="bfloat16"))
    layers._cast = uncached


def order() -> None:
    cs, ak, net = _setup(ROOT)
    dev = torch.device("cuda", 0)
    net16 = cs.with_dtype(net, "bfloat16")
    bf16 = lambda: cs.phase_main_path(ak, net16, dev, ring_dtype="bfloat16")
    _run("bf16, fresh process", bf16)
    _run("f32", lambda: cs.phase_main_path(ak, net, dev))
    _run("bf16 after f32", bf16)
    _run("bf16 again", bf16)
    _run("bf16 CPU slice", lambda: cs.phase_slice_parity(
        ak, net16, dev, "bfloat16", cs.BF16_SLICE_TOL))
    _run("bf16 after the CPU slice", bf16)
    time.sleep(5)
    _run("bf16 after a 5 s sleep", bf16)
    torch.set_num_threads(1)
    _run("bf16 with one CPU thread", bf16)


def kernels(root: str, out: str) -> None:
    cs, ak, net = _setup(root)
    from deva_tpu_torch.ops import approx_kernels as apx
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, ck, k, c = 1620, 64, 30, 1024
    qk = torch.randn((q, ck), generator=gen, device=dev)
    qe = torch.rand((q, ck), generator=gen, device=dev)
    res = {}
    for n in (1620, 16712):
        valid = cs.ring_validity(n, dev)
        mk = torch.randn((n, ck), generator=gen, device=dev)
        ms = 1 + 3 * torch.rand((n,), generator=gen, device=dev)
        v = torch.randn((n, c), generator=gen, device=dev)
        gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
        w = torch.softmax(gv, -1)
        ops = apx.prep2(qk, qe, mk, ms, valid)
        geom = apx.Geometry.of(n, 512)
        seg = apx.segmax(ops, geom)
        o, _, rm, th = apx.denom_readout(ops, geom, seg, v, k)
        outs = (gv, gi, ak.topk_readout(gi, w, v),
                ak.topk_readout(gi, w, (v[:512], v[512:])), seg, o, rm, th)
        torch.cuda.synchronize()
        res[n] = [t.cpu() for t in outs]
    torch.save(res, out + ".pt")
    _run(f"phase 3 f32 of {root}", lambda: cs.phase_main_path(ak, net, dev))


def kernel_times(root: str) -> None:
    cs, ak, _ = _setup(root)
    from deva_tpu_torch.ops import approx_kernels as apx
    from deva_tpu_torch.ops import cuda_build
    lib = cuda_build.build()
    log = (cuda_build.BUILD_DIR / (lib.stem + ".log")).read_text() \
        .splitlines()
    regs = [re.search(r"Used (\d+) registers", log[i + 3]).group(1)
            for i, line in enumerate(log)
            if "Compiling entry" in line and "denom_readout_kernel" in line]
    print(f"{root}: denom_readout registers per instance {regs}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, ck, k, c = 1620, 64, 30, 1024
    qk = torch.randn((q, ck), generator=gen, device=dev)
    qe = torch.rand((q, ck), generator=gen, device=dev)
    for n in (1620, 16712):
        valid = cs.ring_validity(n, dev)
        mk = torch.randn((n, ck), generator=gen, device=dev)
        ms = 1 + 3 * torch.rand((n,), generator=gen, device=dev)
        v = torch.randn((n, c), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            mk_, ms_, v_ = mk.to(dt), ms.to(dt), v.to(dt)
            ops = apx.prep2(qk, qe, mk_, ms_, valid)
            geom = apx.Geometry.of(n, apx.default_n_tile(c, v_.element_size()))
            seg = apx.segmax(ops, geom)
            gv, gi = ak.sim_topk(qk, qe, mk_, ms_, valid, k)
            w = torch.softmax(gv, -1)
            t = {"sim_topk": lambda: ak.sim_topk(qk, qe, mk_, ms_, valid, k),
                 "topk_readout": lambda: ak.topk_readout(gi, w, v_),
                 "segmax": lambda: apx.segmax(ops, geom),
                 "denom_readout": lambda: apx.denom_readout(ops, geom, seg,
                                                            v_, k)}
            print(f"{root} N={n} {str(dt)[6:]} ms: " + ", ".join(
                f"{name} {cs.cuda_ms(fn):.4f}" for name, fn in t.items()),
                flush=True)


def compare(a_path: str, b_path: str) -> None:
    a, b = torch.load(a_path), torch.load(b_path)
    for n in a:
        for name, x, y in zip(OUTPUTS, a[n], b[n]):
            same = torch.equal(x.view(torch.int32), y.view(torch.int32)) \
                if x.dtype == torch.float32 else torch.equal(x, y)
            print(f"N={n} {name}: {'bitwise' if same else 'DIFFERS'}")


def main() -> int:
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd != "compare" and not torch.cuda.is_available():
        print("torch_probe_frames: CUDA is not available", file=sys.stderr)
        return 1
    {"weight-cache": weight_cache, "order": order, "kernels": kernels,
     "compare": compare, "kernel-times": kernel_times}[cmd](*args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
