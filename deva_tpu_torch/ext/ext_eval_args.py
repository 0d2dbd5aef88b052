"""CLI flags for the external-detector layer.

A copy of deva_tpu/ext/ext_eval_args.py: the same flags and defaults; the
help strings name the port's SAM. Detector checkpoints are local paths;
hugging-face model directories are also accepted (the detectors go through
`transformers` instead of the groundingdino / segment_anything packages —
see deva_tpu_torch/ext/detectors.py). The --sam_variant values mobile and
sam_hq_light run the port's MobileSAM / Light-HQ-SAM (ext/mobile_sam.py)
from MOBILE_SAM_CHECKPOINT_PATH / LIGHT_HQ_SAM_CHECKPOINT_PATH (the
original .pt/.pth layout or a deva_tpu .npz; seeded random weights when
the file is absent).

Behavioral anchor: reference:deva/ext/ext_eval_args.py:5-86 (same knobs).
"""
from argparse import ArgumentParser


def add_ext_eval_args(parser: ArgumentParser) -> None:
    # Grounded Segment Anything
    parser.add_argument("--GROUNDING_DINO_CONFIG_PATH",
                        default="./saves/GroundingDINO_SwinT_OGC.py")
    parser.add_argument("--GROUNDING_DINO_CHECKPOINT_PATH",
                        default="./saves/groundingdino_swint_ogc.pth")
    parser.add_argument("--GROUNDING_DINO_HF_PATH",
                        default="IDEA-Research/grounding-dino-tiny",
                        help="transformers model id or local dir")
    parser.add_argument("--DINO_THRESHOLD", default=0.35, type=float)
    parser.add_argument("--DINO_NMS_THRESHOLD", default=0.8, type=float)

    # SAM variants
    parser.add_argument("--SAM_ENCODER_VERSION", default="vit_h")
    parser.add_argument("--SAM_CHECKPOINT_PATH",
                        default="./saves/sam_vit_h_4b8939.pth")
    parser.add_argument("--SAM_HF_PATH", default="facebook/sam-vit-huge",
                        help="transformers model id or local dir")
    parser.add_argument("--HQ_SAM_CHECKPOINT_PATH",
                        default="./saves/sam_hq_vit_h.pth")
    parser.add_argument("--LIGHT_HQ_SAM_CHECKPOINT_PATH",
                        default="./saves/sam_hq_vit_tiny.pth")
    parser.add_argument("--MOBILE_SAM_CHECKPOINT_PATH",
                        default="./saves/mobile_sam.pt")

    # SAM prompting parameters
    parser.add_argument("--SAM_NUM_POINTS_PER_SIDE", type=int, default=64)
    parser.add_argument("--SAM_NUM_POINTS_PER_BATCH", type=int, default=64)
    parser.add_argument("--SAM_PRED_IOU_THRESHOLD", type=float, default=0.88)
    parser.add_argument("--SAM_OVERLAP_THRESHOLD", type=float, default=0.8)


def add_text_default_args(parser: ArgumentParser) -> ArgumentParser:
    parser.add_argument("--img_path", default="./example/vipseg")
    parser.add_argument("--detection_every", type=int, default=5)
    parser.add_argument("--num_voting_frames", type=int, default=3)
    parser.add_argument("--temporal_setting", default="semionline",
                        help="semionline/online")
    parser.add_argument("--max_missed_detection_count", type=int, default=10)
    parser.add_argument("--max_num_objects", type=int, default=-1)
    parser.add_argument("--prompt", type=str,
                        help="Separate classes with a single fullstop")
    parser.add_argument("--sam_variant", default="original",
                        help="original/sam_hq (HF SAM at SAM_HF_PATH; needs "
                             "transformers) | mobile/sam_hq_light (the "
                             "port's MobileSAM / Light-HQ-SAM, on --device)")
    return parser


def add_auto_default_args(parser: ArgumentParser) -> ArgumentParser:
    parser.add_argument("--img_path", default="./example/vipseg")
    parser.add_argument("--detection_every", type=int, default=5)
    parser.add_argument("--num_voting_frames", type=int, default=3)
    parser.add_argument("--temporal_setting", default="semionline",
                        help="semionline/online")
    parser.add_argument("--max_missed_detection_count", type=int, default=5)
    parser.add_argument("--max_num_objects", type=int, default=200)
    parser.add_argument("--sam_variant", default="original",
                        help="original/sam_hq (HF SAM at SAM_HF_PATH; needs "
                             "transformers) | mobile/sam_hq_light (the "
                             "port's MobileSAM / Light-HQ-SAM, on --device)")
    parser.add_argument("--suppress_small_objects", action="store_true")
    return parser
