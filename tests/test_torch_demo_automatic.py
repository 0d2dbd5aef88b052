"""deva_tpu_torch's automatic demo (demo/demo_automatic_torch.py) against
deva_tpu's (demo/demo_automatic.py), both mains in process on
example/vipseg at --size 120 on the CPU, each with its package's
ReplayDetector (tests/fixtures/replay_dets_vipseg.npz) as the generator,
on the same propagation weights; the set-up and the budget (at least 99%
of each frame's pixels under a one-to-one id matching, the segments
matched with equal category_id) are tests/test_torch_demo_drivers.py's.
Both also count the feature store's image encodes of each frame: the port
must make as many as deva_tpu.
"""
from test_torch_demo_drivers import (CLIP, FRAMES, _compare,  # noqa: F401
                                     _run_jax, _run_port, weights)


def test_demo_automatic_torch_matches(tmp_path, weights):
    """Online, a detection every 2 frames: frame 2's forward estimate
    (estimate_forward_mask) restricts the generator (the replay ignores
    the restriction, as deva_tpu's does) and its encode is the one that
    incorporate_detection reuses; the same encodes on every frame."""
    common = ["--img_path", CLIP, "--size", "120", "--model", weights,
              "--temporal_setting", "online", "--detection_every", "2"]
    ref_encodes, encodes = [], []
    _run_jax("demo_automatic.py", "build_auto_generator",
             common + ["--output", str(tmp_path / "jax")], ref_encodes,
             "process_frame_automatic")
    _run_port("demo_automatic_torch.py", "build_auto_generator",
              common + ["--output", str(tmp_path / "torch")], encodes,
              "process_frame_automatic")
    assert encodes == ref_encodes and len(encodes) == len(FRAMES)
    _compare(tmp_path)
