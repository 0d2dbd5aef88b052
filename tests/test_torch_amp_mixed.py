"""The two mixed dtype configurations of deva_tpu_torch's InferenceCore
against deva_tpu's, over the golden clip, with the runner and budget of
tests/test_torch_amp_clip.py: f32 compute with bf16 rings (the ring write
rounds; measured on the CPU: per-frame mean |dprob| up to 3.4e-5, max
0.0012) and bf16 compute with f32 rings (the ring write widens; mean up to
0.0036, max 0.107), both with exact top-k. No confident pixel flipped.
"""
import pytest

from test_torch_amp_clip import run_clip


@pytest.mark.parametrize("dtype,ring_dtype", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
def test_clip_mixed_configuration_against_deva_tpu(dtype, ring_dtype):
    run_clip(dtype, ring_dtype, "exact")
