"""The control of each configuration on the card, at a size a test run can
hold (240x432, videos of 12-20 frames): the reference one precision step
below the configuration's, put in the program's place, is not correct: a
compared number passes its limit (TF32
for the float32 configuration, fp8 for the bfloat16 one; reference/
vos_check.py). The benchmark's own runs do not run it. On the card:
    python -m pytest perfbench/tests/test_perfbench_control.py -q"""
import pytest

from conftest import tiny_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["vos-f32-b4", "vos-bf16-b4"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_is_not_correct(card, name, seed):
    from deva_tpu_torch.config import InferenceConfig
    from harness.batched_vos import Inputs, passes
    from harness import weights
    from reference import vos_check
    cell = tiny_cell(name, height=240, width=432, lengths=[12, 14, 16, 20])
    group, = next(passes(cell.traffic, seed,
                         InferenceConfig().pad_objects))
    lanes = list(range(len(group.names)))
    inputs = Inputs(cell.traffic, seed, card)
    sd = {k: v.cpu() for k, v in
          weights.make_state_dict(cell.config["model"], seed, card).items()}
    control = vos_check.outputs(cell.config, group, lanes, inputs, sd, card,
                                "control")
    got = vos_check.check(cell.config, group, control, inputs, sd, card)
    limits = cell.config["limits"]
    assert any(got[n] > limit for n, limit in limits.items()), (got, limits)
