"""Text-prompted or automatic tracking over a video with a streamed
visualization, with deva_tpu_torch (PyTorch + CUDA).

The port's counterpart of demo/demo_gradio.py. Without --serve it is that
demo's command line: decode the --video with cv2, track, and encode the
blended frames to <--output>/tracked.mp4 (mp4v):

  python demo/demo_gradio_torch.py --video input.mp4 --prompt "person.car" \\
      --output ./out [--sam_variant mobile] [--max_frames 100]

With --serve it lays out deva_tpu's two gradio tabs (text-prompted and
automatic, the same sliders, ranges and defaults) and launches the app;
gradio is imported then, and cv2 only where a video is decoded or encoded,
so the module imports on a machine with neither. The core, track_frames,
takes frames from memory (what chip_smoke.py drives on the card);
track_video wraps it with the cv2 decoder and writer; run_text and run_auto
are the two tabs' callbacks at module level.

The model, device and sharding conventions are demo/demo_with_text_torch.py's
(--device defaults to cuda and fails without CUDA, TF32 off; --model takes
an upstream .pth or a deva_tpu .npz, else seeded random weights;
--obj_shards N under torchrun: process 0 runs the detector, broadcasts its
detections and alone writes). The automatic tab's SAM variants carry the
port's names: mobile and sam_hq_light run the port's MobileSAM /
Light-HQ-SAM (seeded random weights unless their checkpoint flag names a
file), hf-sam the HF SAM at --SAM_HF_PATH; deva_tpu's jax-mobile /
jax-light-hq labels would be false here.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from os import path
from typing import Callable, Iterable, Optional

import numpy as np

ROOT = path.dirname(path.dirname(path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, path.join(ROOT, "evaluation"))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from demo_with_text_torch import demo_config, make_parser  # noqa: E402

from deva_tpu_torch.ext.detectors import (  # noqa: E402
    _mobile_sam_from_args, build_text_detector)
from deva_tpu_torch.ext.with_text_processor import \
    process_frame_with_text  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.demo_utils import (  # noqa: E402
    SharedSource, flush_buffer)
from deva_tpu_torch.inference.eval_args import (  # noqa: E402
    NullSaver, apply_obj_sharding, is_writer)
from deva_tpu_torch.inference.result_saver import ResultSaver  # noqa: E402
from eval_vos_torch import count_usage, load_model, setup_device  # noqa

SAM_VARIANTS = ("mobile", "sam_hq_light", "hf-sam")


@dataclasses.dataclass
class Demo:
    """What main sets up once and every run shares: the propagation
    network, the base InferenceConfig (long-term usage counting is set per
    video), the flags as a dict, the parsed flags, the device, the object
    mesh (None unless --obj_shards) and the text detector (None on the
    processes of a sharded run that do not run it)."""
    net: object
    cfg: object
    ext_cfg: dict
    args: object
    device: object
    obj_mesh: object = None
    detector: object = None

    @property
    def writer(self) -> bool:
        return is_writer(self.args)

    def source(self, source):
        """The detector or generator as this process uses it: shared from
        process 0 in an object-sharded run."""
        return SharedSource(source) if self.obj_mesh is not None else source


def track_frames(demo: Demo, cfg, ext_cfg, source, frames: Iterable,
                 vid_length: int, writer,
                 process_fn: Optional[Callable] = None,
                 tick: Optional[Callable] = None) -> InferenceCore:
    """The video's uint8 RGB frames (at most vid_length of them) through the
    frame processor (process_fn, by default the text one) with `source`,
    on one InferenceCore with long ids whose long-term usage counting
    follows the video's length, then the frames left in the semi-online
    buffer; a ResultSaver in "gradio" mode hands each blended frame (BGR
    uint8, the frame's size) to writer.write, on the writing process.
    tick() follows each frame. Returns the core
    (reference:demo/demo_gradio.py:36-92)."""
    cfg = dataclasses.replace(cfg, enable_long_term_count_usage=count_usage(
        cfg, vid_length))
    deva = InferenceCore(demo.net, cfg, device=demo.device,
                         obj_mesh=demo.obj_mesh)
    deva.enabled_long_id()
    if demo.writer:
        saver = ResultSaver(None, None, dataset="gradio",
                            object_manager=deva.object_manager)
        saver.writer = writer
    else:
        saver = NullSaver()
    process = process_fn or process_frame_with_text
    for ti, frame in zip(range(vid_length), frames):
        process(deva, source, ext_cfg, f"{ti:07d}.jpg", saver, ti,
                image_np=frame)
        if tick is not None:
            tick()
    prompt = ext_cfg.get("prompt")
    flush_buffer(deva, saver, prompts=[p for p in prompt.split(".")
                                       if p.strip()] if prompt else None)
    saver.end()
    return deva


def track_video(demo: Demo, cfg, ext_cfg, source, video_path: str,
                out_dir: str, max_frames: int = -1,
                process_fn: Optional[Callable] = None,
                progress=None) -> str:
    """Decode the video with cv2, track_frames, and encode the blended
    frames to out_dir/tracked.mp4 (mp4v, the input's rate), with a tqdm
    bar or gradio's progress. Returns the output video's path. Raises
    where cv2 cannot open the input or the mp4v writer, or decodes no
    frame (cv2 signals none of these itself: the run would end with no
    output)."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cv2 cannot open the video {video_path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    n_total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    vid_length = n_total if max_frames <= 0 else min(n_total, max_frames)
    if progress is None:
        from tqdm import tqdm
        bar = tqdm(total=vid_length)
        tick = bar.update
    else:
        it = iter(progress.tqdm(range(vid_length)))
        tick = lambda: next(it, None)  # noqa: E731
    out_video = path.join(out_dir, "tracked.mp4")

    class Writer:
        """cv2.VideoWriter opened at the first frame's size."""
        video = None

        def write(self, frame):
            if self.video is None:
                os.makedirs(out_dir, exist_ok=True)
                h, w = frame.shape[:2]
                self.video = cv2.VideoWriter(
                    out_video, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
                if not self.video.isOpened():
                    raise RuntimeError(f"cv2 cannot write {out_video} with "
                                       "the mp4v codec")
            self.video.write(np.ascontiguousarray(frame))

    decoded = []

    def frames():
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                return
            decoded.append(None)
            yield cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)

    writer = Writer()
    try:
        track_frames(demo, cfg, ext_cfg, source, frames(), vid_length,
                     writer, process_fn, tick)
    finally:
        cap.release()
        if writer.video is not None:
            writer.video.release()
    if not decoded:
        raise ValueError(f"cv2 decoded no frame of {video_path!r}")
    return out_video


def _per_run_cfg(demo: Demo, size, det_every, max_missed, temporal):
    """The InferenceConfig and flags of one run of a tab
    (reference:demo/demo_gradio.py:180-356's knobs)."""
    cfg = dataclasses.replace(
        demo.cfg, size=int(size), detection_every=int(det_every),
        max_missed_detection_count=int(max_missed),
        enable_long_term_count_usage=True)
    ext_cfg = dict(demo.ext_cfg, size=int(size),
                   detection_every=int(det_every), temporal_setting=temporal)
    return cfg, ext_cfg


def text_setup(demo: Demo, prompt, threshold, size, det_every, max_missed,
               temporal):
    """The text tab's (cfg, ext_cfg) for a run."""
    cfg, ext_cfg = _per_run_cfg(demo, size, det_every, max_missed, temporal)
    ext_cfg.update(prompt=prompt, DINO_THRESHOLD=float(threshold))
    return cfg, ext_cfg


def auto_setup(demo: Demo, iou_threshold, points_per_side, size, det_every,
               max_missed, temporal, sam_variant, suppress_small):
    """The automatic tab's (cfg, ext_cfg, generator) for a run: the SAM
    variant's grid generator on this process (process 0 alone in a sharded
    run), shared as demo.source shares it."""
    if sam_variant not in SAM_VARIANTS:
        raise ValueError(f"SAM variant {sam_variant!r} not in {SAM_VARIANTS}")
    generator = None
    if demo.writer:
        kw = dict(points_per_side=int(points_per_side),
                  pred_iou_thresh=float(iou_threshold))
        if sam_variant == "hf-sam":
            from deva_tpu_torch.ext.detectors import HFAutomaticSAM
            generator = HFAutomaticSAM(demo.args.SAM_HF_PATH,
                                       device=demo.device.type, **kw)
        else:
            generator = _mobile_sam_from_args(demo.args, sam_variant, **kw)
    cfg, ext_cfg = _per_run_cfg(demo, size, det_every, max_missed, temporal)
    ext_cfg.update(suppress_small_objects=bool(suppress_small),
                   SAM_NUM_POINTS_PER_SIDE=int(points_per_side),
                   SAM_PRED_IOU_THRESHOLD=float(iou_threshold))
    return cfg, ext_cfg, demo.source(generator)


def run_text(demo: Demo, video, prompt, threshold, size, det_every,
             max_missed, temporal, max_frames, progress=None) -> str:
    """The text-prompted tab: Grounding DINO + SAM (--sam_variant) on the
    uploaded video; returns the tracked video's path (in a temporary
    directory that gradio copies from)."""
    cfg, ext_cfg = text_setup(demo, prompt, threshold, size, det_every,
                              max_missed, temporal)
    out_dir = tempfile.mkdtemp()
    return track_video(demo, cfg, ext_cfg, demo.source(demo.detector), video,
                       out_dir, int(max_frames), progress=progress)


def run_auto(demo: Demo, video, iou_threshold, points_per_side, size,
             det_every, max_missed, temporal, sam_variant, suppress_small,
             max_frames, progress=None) -> str:
    """The automatic tab: SAM's grid prompts (the automatic processor) on
    the uploaded video; returns the tracked video's path."""
    from deva_tpu_torch.ext.automatic_processor import \
        process_frame_automatic
    cfg, ext_cfg, generator = auto_setup(
        demo, iou_threshold, points_per_side, size, det_every, max_missed,
        temporal, sam_variant, suppress_small)
    out_dir = tempfile.mkdtemp()
    return track_video(demo, cfg, ext_cfg, generator, video, out_dir,
                       int(max_frames), process_fn=process_frame_automatic,
                       progress=progress)


def serve(demo: Demo, gr):
    """deva_tpu's two tabs over run_text and run_auto (the same sliders,
    ranges and defaults; the port's SAM variant names). -> the gr.Blocks
    app."""

    def text_tab(video, prompt, threshold, size, det_every, max_missed,
                 temporal, max_frames, progress=gr.Progress()):
        return run_text(demo, video, prompt, threshold, size, det_every,
                        max_missed, temporal, max_frames, progress)

    def auto_tab(video, iou_threshold, points_per_side, size, det_every,
                 max_missed, temporal, sam_variant, suppress_small,
                 max_frames, progress=gr.Progress()):
        return run_auto(demo, video, iou_threshold, points_per_side, size,
                        det_every, max_missed, temporal, sam_variant,
                        suppress_small, max_frames, progress)

    common = lambda: [  # noqa: E731
        gr.Slider(384, 1080, value=480, step=1,
                  label="Internal resolution"),
        gr.Slider(1, 100, value=5, step=1,
                  label="Incorporate detection every [X] frames"),
        gr.Slider(1, 100, value=10, step=1,
                  label="Delete segment if undetected for [X] times"),
        gr.Dropdown(choices=["semionline", "online"],
                    value="semionline", label="Temporal setting"),
    ]
    with gr.Blocks(title="deva_tpu_torch: Tracking Anything "
                         "(DEVA on PyTorch + CUDA)") as app:
        with gr.Tab("Text-prompted"):
            gr.Interface(
                fn=text_tab,
                inputs=[gr.Video(), gr.Text(label="Prompt (class1.class2)"),
                        gr.Slider(0.01, 0.99, value=0.35,
                                  label="Detection threshold"),
                        *common(), gr.Number(value=-1,
                                             label="Max frames (-1=all)")],
                outputs=gr.Video(),
                title="Text-prompted open-vocabulary tracking "
                      "(Grounding DINO + SAM)")
        with gr.Tab("Automatic"):
            gr.Interface(
                fn=auto_tab,
                inputs=[gr.Video(),
                        gr.Slider(0.01, 0.99, value=0.88,
                                  label="IoU threshold"),
                        gr.Slider(4, 256, value=32, step=1,
                                  label="Num. points per side for SAM"),
                        *common(),
                        gr.Dropdown(
                            choices=list(SAM_VARIANTS), value="mobile",
                            label="SAM variant (mobile / sam_hq_light run "
                                  "the port's MobileSAM / Light-HQ-SAM)"),
                        gr.Checkbox(label="Suppress small objects"),
                        gr.Number(value=-1, label="Max frames (-1=all)")],
                outputs=gr.Video(),
                title="Automatic grid-prompted tracking")
    return app


def make_demo(args) -> Demo:
    """main's set-up: the device, the network (replicated from process 0
    under --obj_shards), the base config, the flags and the text detector
    (built on the writing process only)."""
    device = setup_device(args)
    net = load_model(args, device)
    obj_mesh, net = apply_obj_sharding(args, net)
    demo = Demo(net, demo_config(args, 0), vars(args), args, device, obj_mesh)
    demo.detector = build_text_detector(args) if demo.writer else None
    return demo


def main(argv=None):
    np.random.seed(42)
    parser = make_parser()
    parser.add_argument("--video", help="input video file (CLI mode)")
    parser.add_argument("--max_frames", type=int, default=-1)
    parser.add_argument("--serve", action="store_true",
                        help="launch the gradio UI (requires gradio)")
    args = parser.parse_args(argv)
    demo = make_demo(args)
    if args.serve:
        try:
            import gradio as gr
        except ImportError:
            raise SystemExit("gradio is not installed; run in CLI mode with "
                             "--video instead")
        serve(demo, gr).launch()
    else:
        if not args.video:
            raise SystemExit("--video is required in CLI mode")
        if args.output is None:
            raise SystemExit("--output is required")
        out = track_video(demo, demo.cfg, demo.ext_cfg,
                          demo.source(demo.detector), args.video,
                          args.output, args.max_frames)
        print(f"Output video: {out}")


if __name__ == "__main__":
    main()
