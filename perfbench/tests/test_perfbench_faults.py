"""A whole run of a cell cut small, on the CPU (the harness's look for a
card skipped): sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false. One run for each fault a batched VOS
cell can have: a step that leaves its state unchanged (no memory write),
half of the batch left out (their frames never reach the model), an answer
altered where it is produced (two probability maps swapped); and the
bf16 configuration's control (fp8) in the program's place."""
import time

import pytest
import torch

from conftest import tiny_cell
from harness import cli

torch.set_num_threads(2)


def _run(cell, driver_cls=None):
    return cli.run(cell, 11, 0.1, False, torch.device("cpu"),
                   time.perf_counter(), driver_cls)


@pytest.fixture(params=["vos-f32-b4", "vos-bf16-b4"])
def cell(request):
    return tiny_cell(request.param)


def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"  # the compared numbers come last
    assert res["attempted"] == 28 and res["failed"] == 0


def _no_write(self, *args, **kwargs):
    return None


def _half_left_out(real):
    def images(self, frames):
        x = real(self, frames)
        x[x.shape[0] // 2:] = 0.0
        return x
    return images


def _swapped(real):
    def body(self, images, **kwargs):
        prob = real(self, images, **kwargs)
        return prob[:, [1, 0] + list(range(2, prob.shape[1]))]
    return body


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from deva_tpu_torch.inference.batched import BatchedPropagator as BP
    if fault == "state_unchanged":
        monkeypatch.setattr(BP, "_write", _no_write)
    elif fault == "half_batch":
        monkeypatch.setattr(BP, "_images", _half_left_out(BP._images))
    else:
        monkeypatch.setattr(BP, "_body", _swapped(BP._body))
    res = _run(cell)
    assert not res["correct"], (fault, res["checks"])


def test_bf16_control_in_the_programs_place_is_not_correct(monkeypatch):
    """The fp8 control as the program: the kept outputs replaced by the
    control's (reference/vos_check.py)."""
    from harness.batched_vos import BatchedVOS
    from reference import vos_check

    class Control(BatchedVOS):
        def check(self):
            control = vos_check.outputs(
                self.cell.config, self.first, sorted(self.keep.buffers),
                self.inputs, self.weights, self.device, "control")
            return vos_check.check(self.cell.config, self.first, control,
                                   self.inputs, self.weights, self.device)

    res = _run(tiny_cell("vos-bf16-b4"), Control)
    assert not res["correct"], res["checks"]
