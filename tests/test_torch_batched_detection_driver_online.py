"""evaluation/eval_with_detections_batched_torch.py in the online setting
(a detection every 2 frames, so run_group_online's incorporate and
step_block branches both run), against deva_tpu's batched driver and the
port's sequential driver, as test_torch_batched_detection_driver.py sets
it out (tests/test_batched_detection_driver.py::test_batched_online_
driver_matches_sequential's case).

On the last frame of this clip and these weights deva_tpu's own batched
driver differs from its sequential driver (eval_with_detections.py) on
15% of the pixels: unmatched detections become near copies of tracked
objects whose probabilities tie, and the two flows sum in another order.
So the port's batched-vs-sequential budget is, per frame, 2% or deva_tpu's
own batched-vs-sequential share on that frame plus 0.5%, whichever is
larger; against deva_tpu's batched driver the 2% budget holds as it is."""
import pytest

from test_torch_batched_detection_driver import (PORT_BATCHED, PORT_SEQ,
                                                 mismatch, run_drivers,
                                                 same_per_video)

ONLINE = ["--temporal_setting", "online", "--detection_every", "2"]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return run_drivers(tmp_path_factory.mktemp("online"), [
        ("deva_tpu", "eval_with_detections_batched.py",
         ["--batch", "2", "--raise_on_error"]),
        ("deva_tpu_sequential", "eval_with_detections.py",
         ["--raise_on_error"]),
        ("batched", *PORT_BATCHED), ("sequential", *PORT_SEQ)], ONLINE)


def test_batched_online_driver_matches_sequential(outputs):
    gap = mismatch(outputs["deva_tpu_sequential"], outputs["deva_tpu"])
    same_per_video(outputs["sequential"], outputs["batched"],
                   {key: max(0.02, share + 0.005)
                    for key, share in gap.items()})


def test_batched_online_driver_matches_deva_tpu(outputs):
    same_per_video(outputs["deva_tpu"], outputs["batched"])
