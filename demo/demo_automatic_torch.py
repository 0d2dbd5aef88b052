"""Automatic (SAM grid-prompted) tracking over an image folder, with
deva_tpu_torch (PyTorch + CUDA).

The port's counterpart of demo/demo_automatic.py: the same flags, the same
per-frame state machine (ext/automatic_processor.py: a forward prediction
first, so that SAM is prompted only where no tracked object is, then the
fusion with incremental=True) and the same outputs (Annotations/ RGB id
PNGs, Visualizations/ overlays and pred.json under --output).

  python demo/demo_automatic_torch.py --img_path ./frames --output ./out \\
      --sam_variant mobile [--SAM_NUM_POINTS_PER_SIDE 16]

--sam_variant mobile/sam_hq_light run the port's MobileSAM / Light-HQ-SAM
on --device (seeded random weights unless --MOBILE_SAM_CHECKPOINT_PATH /
--LIGHT_HQ_SAM_CHECKPOINT_PATH exists); original/sam_hq run the HF SAM at
--SAM_HF_PATH through `transformers`, which must be installed. The model,
device and barrier flags are demo/demo_with_text_torch.py's. Not carried
over from deva_tpu's demo: --obj_shards and --profile.
"""
from __future__ import annotations

import sys
from os import path

import numpy as np

sys.path.insert(0, path.dirname(path.abspath(__file__)))

from demo_with_text_torch import drive, make_parser  # noqa: E402

from deva_tpu_torch.ext.automatic_processor import \
    process_frame_automatic  # noqa: E402
from deva_tpu_torch.ext.detectors import build_auto_generator  # noqa: E402
from deva_tpu_torch.ext.ext_eval_args import \
    add_auto_default_args  # noqa: E402
from deva_tpu_torch.inference.demo_utils import flush_buffer  # noqa: E402
from eval_vos_torch import setup_device  # noqa: E402


def run_demo(deva, generator, reader, saver, ext_cfg, timer) -> None:
    """The video through the automatic processor, frame by frame, then the
    frames left in the semi-online buffer; reader, saver and timer as in
    demo_with_text_torch.run_demo."""
    for ti in range(len(reader)):
        frame, _, im_path = reader[ti]
        with timer:
            process_frame_automatic(deva, generator, ext_cfg, im_path, saver,
                                    ti, image_np=frame)
    if deva.frame_buffer:
        with timer.frames_of(len(deva.frame_buffer)):
            flush_buffer(deva, saver)


def main(argv=None):
    np.random.seed(42)
    args = make_parser(add_auto_default_args).parse_args(argv)
    device = setup_device(args)
    drive(args, build_auto_generator(args), run_demo, device)


if __name__ == "__main__":
    main()
