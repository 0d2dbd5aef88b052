"""eval_vos_batched_torch.py --dataset Y18 --batch 2 against
eval_vos_batched.py on the synthetic YouTube-VOS layout of
torch_vos_common.youtube_layout: both videos' masks arrive after frame 0,
so the two run in one lockstep group (run_group_midstream).

Budget: each PNG at least 99% equal to deva_tpu's; the same files and zip
members.
"""
from torch_vos_common import check_youtube_outputs, youtube_outputs


def test_eval_vos_batched_torch_youtube_layout(tmp_path):
    """The batched driver on the same layout, both videos in one lockstep
    group (their masks arrive after frame 0: run_group_midstream)."""
    out = youtube_outputs(tmp_path, "eval_vos_batched", "--batch", "2")
    assert "mid-stream group" in out
    check_youtube_outputs(tmp_path)
