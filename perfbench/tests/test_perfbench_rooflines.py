"""The operation and byte counts of the rooflines and of step_mfu, against
counts made by hand at small shapes, and the per-layer readers on a record
written by hand."""
import pytest
import torch

from harness import manifest, readers
from harness.trace import Tracer, read_events


def test_sim_topk_counts():
    # 2 videos, 3 queries, 10 slots of which 7 valid, 4 key channels, k 2
    launch = {"b": 2, "q": 3, "n": 10, "ck": 4, "k": 2, "isz": 4, "nv": 7}
    flops, nbytes = manifest.roofline("sim_topk").cost(launch)
    assert flops == 4 * 3 * 7 * 4
    # qk, qe: 2 * 2*3*4 floats; valid keys 7*4 and shrinkage 7 floats;
    # validity 2*10 bytes; values and indices 2 * 2*3*2 * 4 bytes
    assert nbytes == 2 * 2 * 3 * 4 * 4 + 7 * 5 * 4 + 20 + 2 * 3 * 2 * 8


def test_topk_readout_counts():
    launch = {"b": 1, "q": 2, "k": 3, "c": 5, "isz": 2, "rows": 4}
    flops, nbytes = manifest.roofline("topk_readout").cost(launch)
    assert flops == 2 * 2 * 3 * 5
    # indices and weights 2*3*(4+4), output 2*5*4, rows 4*5 bf16
    assert nbytes == 2 * 3 * 8 + 2 * 5 * 4 + 4 * 5 * 2


def test_segmax_and_denom_readout_counts():
    seg = {"b": 1, "q": 2, "n": 8, "kc": 4, "nseg": 3, "nv": 6}
    flops, nbytes = manifest.roofline("segmax").cost(seg)
    assert flops == 2 * 2 * 4 * 6
    assert nbytes == 4 * (2 * 4 + 2) + 8 + 4 * 2 * 3 + 4 * 6 * 5
    den = dict(seg, c=5, isz=2, entries=7, rows=3)
    flops, nbytes = manifest.roofline("denom_readout").cost(den)
    assert flops == 2 * 7 * (4 + 5)
    # group maxima, operands, offset and output per query; valid tokens'
    # scales; each row's value, operands, scale and validity byte
    assert nbytes == 4 * 2 * (3 + 4 + 1 + 5) + 4 * 6 + \
        3 * (2 * 5 + 4 * 4 + 4 + 1)


def test_flops_hook_counts_a_convolution_and_a_dense_layer():
    tr = Tracer(True)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, groups=1)
    dense = torch.nn.Linear(6, 4)
    conv.register_forward_hook(tr.flops_hook)
    dense.register_forward_hook(tr.flops_hook)
    conv(torch.zeros(2, 3, 5, 7))
    dense(torch.zeros(9, 6))
    assert tr.flops == 2 * (2 * 8 * 5 * 7) * 3 * 9 + 2 * 9 * 4 * 6


def _record(**over):
    rec = {"window_s": 2.0, "busy_s": 1.5, "frames": 10,
           "kernel_s": {"pb.mode.segment": 0.3, "pb.mode.encode_image": 0.1,
                        "pb.attention": 0.05, "pb.kernel.sim_topk": 0.02},
           "host_s": {"pb.step": 0.4}, "calls": {"pb.step": 5},
           "launches": {"sim_topk": [{"b": 1, "q": 100, "n": 1000,
                                      "ck": 64, "k": 30, "isz": 4,
                                      "nv": 1000}]},
           "flops": 1e12, "peak_flops": 67e12}
    rec.update(over)
    return rec


def test_readers_on_a_record():
    read = lambda name, rec: manifest.metric_reader(name)(rec)
    rec = _record()
    assert read("device_idle_pct", rec) == pytest.approx(25.0)
    assert read("model_ms", rec) == pytest.approx(40.0)
    assert read("attention_ms", rec) == pytest.approx(5.0)
    assert read("enqueue_ms", rec) == pytest.approx(40.0)
    kflops = 4 * 100 * 1000 * 64
    assert read("step_mfu", rec) == pytest.approx(
        100 * (1e12 + kflops) / (2.0 * 67e12))
    peaks = manifest.peaks()
    nbytes = 2 * 100 * 64 * 4 + 1000 + 8 * 100 * 30 + 4 * 1000 * 65
    bound = max(kflops / peaks["float32"], nbytes / peaks["hbm_bytes_per_s"])
    assert read("sim_topk_roofline", rec) == pytest.approx(
        100 * bound / 0.02)
    # nothing to read: nothing returned, never a 0
    empty = _record(kernel_s={}, host_s={}, calls={}, launches={},
                    busy_s=0.0, flops=0.0)
    for m in ("device_idle_pct", "step_mfu", "model_ms", "attention_ms",
              "enqueue_ms", "sim_topk_roofline", "segmax_roofline"):
        assert read(m, empty) is None, m


class _Ev:
    def __init__(self, name, start, dur, device=False, corr=0, linked=0):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._l = device, corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_read_events_places_kernels_by_their_launch():
    ev = [_Ev("pb.attention", 100, 50, corr=1),
          _Ev("cudaLaunchKernel", 110, 5, corr=77),
          _Ev("pb.count", 120, 10, corr=2),
          _Ev("cudaLaunchKernel", 125, 2, corr=78),
          _Ev("cudaLaunchKernel", 200, 2, corr=79),
          _Ev("kern_a", 300, 40, device=True, corr=77),
          _Ev("count_k", 340, 10, device=True, corr=78),
          _Ev("kern_b", 400, 20, device=True, corr=79),
          _Ev("pb.attention", 300, 40, device=True)]  # its device shadow
    rec = read_events(ev)
    assert rec["kernel_s"]["pb.attention"] == pytest.approx(40e-9)
    assert rec["busy_s"] == pytest.approx(60e-9)  # the count is left out
    assert rec["by_runtime"] == 3 and rec["unlinked"] == 0
    assert dict(rec["idle_gaps"]) == {"host": pytest.approx(60e-9)}
    assert rec["device_ops"][0] == ["kern_a", pytest.approx(40e-9)]
