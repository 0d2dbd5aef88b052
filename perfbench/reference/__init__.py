"""The benchmark's plain reference: a frozen copy of deva_tpu_torch's plain
single-stream VOS path (models, ops, inference), with `deva_tpu_torch.`
imports renamed to `reference.`. It imports nothing of the port. Its
docstrings are the port's. Where they speak of CUDA kernels, this copy runs
the plain PyTorch twins instead.

The copy's departures, each marked where it is made:
- ops/attention_kernels.py and ops/approx_kernels.py keep only the plain
  twins;
- inference/core.py keeps the single-stream path of semi-supervised VOS
  (the first frame's mask, then the fused step), without detection fusion,
  block stepping or object sharding; inference/fused_step.py and
  inference/memory.py keep what that path runs;
- models/network.py keeps the four modes of inference (no training
  readout or aux head);
- models/layers.py:set_fp8 and inference/memory.py:Bucket.quantize serve
  the fp8 control.

vos_check.py runs it and decides `correct` for the VOS cells.
"""
