"""Smoke test of deva_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
this checkout and drives the port's main paths (semi-supervised VOS
propagation through InferenceCore.step with exact top-k, and through
InferenceCore.step_chunk with threshold-approx top-k; four videos in
lockstep through BatchedPropagator; detection fusion through
InferenceCore.incorporate_detection and vote_in_temporary_buffer, and four
detection or mid-stream videos in lockstep through
BatchedDetectionPropagator) on the card, in f32 and in deva_tpu's serving
dtypes (bf16 compute, bf16 memory rings); and the evaluation drivers
(eval_vos_torch with flips and score maps, the referring and saliency
drivers' soft-mask bidirectional propagation); and the detector layer
(MobileSAM, Light-HQ-SAM, the frame processors) with the two demos; and
the training stack (the train step card against CPU, the stage-3 step at
full width, learn-to-track served by InferenceCore, the stage driver); and
multi-GPU serving over two ranks (object-sharded VOS and detection
drivers, memory-sharded attention, video-sharded batched propagation);
and the native host library (the consensus integer program, the RLE codec)
and the video demo's core; and the command lines (each driver and demo
from argv on the repo's clips, with files, against the same command on
the CPU).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. Each of the four kernels against its plain PyTorch twin on the card, at
   the 480p main-path shapes (Q=1620 queries, Ck=64, k=30, C=2*512 value
   columns, N in {1620, 3240, 6480, 8100, 512+16200} ring tokens with the
   validity masks the memory engine gives them), with device times from
   CUDA events, each beside its bound (`bound`: the larger of its f32
   operations over 67 TFLOP/s and the bytes it must move over 3.35 TB/s,
   counted from this run's inputs), topk_readout beside the one PyTorch
   call with its function (embedding_bag, never used by the port), and
   sim_topk and segmax beside cuBLAS's f32 product of their operands.
   Exact pair: plus a ring of duplicated tokens for tie order,
   sim_topk's host time per call, and topk_readout on each ring split at
   the long-term ring's 512 slots (two segments read in place, bitwise the
   one-segment call, timed beside it), with the distinct rows U of each
   tile of its queries and the L2 bytes they imply. Approx pair: segmax bitwise the max of
   sim2_at over each group on sampled rows; denom_readout's rmax and th
   bitwise `threshold` (torch.topk); plus a ring of duplicated tokens whose
   tied group maxima admit more than 4k entries, rows with fewer valid
   tokens than k and with none, and a check that every row's support
   contains the exact top-k of sim_topk.
   bf16 rings (N = 1620 and 16712): sim_topk, topk_readout (one and two
   segments) and segmax bitwise their f32 launches on the widened rings
   (and, for the readout, on the weights rounded to bf16); denom_readout's
   rmax and th bitwise and its usage within f32 atomics noise of the
   f32-ring launch, its output within the bf16 rounding of the normalised
   weights of that launch (2^-8 * sum aff |V|), and within 1e-5 of its twin
   on 99% of the outputs (one bf16 ulp of the weights everywhere); each
   timed beside a bound counted for bf16.
2. The slice on the card against the slice on the CPU (the plain twins),
   seeded weights, long-term memory on, probabilities within 5e-3: with
   exact top-k on 8 frames of the 64x96 synthetic video of
   tests/test_inference_parity.py through step and through step_chunk;
   with approx top-k on 10
   frames of 128x192, whose [long-term ; working] ring exceeds 512 tokens so
   that groups of 4 occur, through step and through step_chunk. The
   kernels of each method must have launched. Then, for each method, a
   third object appears: its mask frame and the next frame run the composed
   path (MemoryEngine.match_memory over two buckets) on the card, within
   5e-3 of the CPU; with exact top-k both exact kernels launch inside it,
   with approx it takes the dense threshold form, as deva_tpu does. Then
   the same with bf16 compute and bf16 rings, within BF16_SLICE_TOL.
3. The exact 480p main path: the full-width model on 60 seeded synthetic
   854x480 frames with a two-object first-frame mask at the default
   InferenceConfig, through step (the fused step), so the working memory
   saturates and long-term consolidation and [long-term ; working]
   attention run. Checks finite probabilities that sum to 1 and that both
   exact kernels launched on every propagated frame, reading the
   [long-term ; working] value rings as two segments; prints ms/frame,
   FPS, peak device memory, and U per tile on frame 50.
4. The approx 480p main path: the same, with topk_method='approx', the
   first frame through step and the other 59 through step_chunk in chunks
   of 5 (as eval_vos_torch.py --chunk 5 drives it); both approx kernels
   must launch on every propagated frame. Then again with the pre-encoded
   block body (preencode_blocks=True: a block's frames encoded as one
   batch, one attention per block), held to the per-frame body's
   probabilities within tests/test_step_chunk.py's budget for it.
Phases 3 and 4 then run again with bf16 compute and bf16 rings on the same
frames and weights: each bf16 kernel of the method launches once per
propagated frame (59 in 59), and the probabilities meet
tests/test_amp.py's whole-clip budget against the f32 run, frame by frame.
1b. The kernels' video axis (the batched propagator's launches): B4 = 4
   videos in one launch at N = 1620 and 16712 per video, with per-video
   long-term sizes 512, 384, 0 and 512 at 16712, on f32 and bf16 rings:
   sim_topk, topk_readout (one and two segments) and segmax bitwise four
   single-video launches, denom_readout's rmax and th bitwise and its out
   and usage within 1e-5; each against its batched twin at phase 1's
   budgets; timed beside four single launches, with four times the
   single-video bound.
2b. The batched slice (inference/batched.py) on the card against the CPU,
   both methods, long-term memory on (three 64x96 videos exact, through
   step_all and step_block by 2; two 128x192 videos approx), within phase
   2's tolerances, one launch of each kernel of the method per lockstep
   step; then the same in bf16.
5. Four 480p videos in lockstep at the default InferenceConfig (video 0
   is phase 3's clip; video 1 has one object): f32 exact through
   step_all, f32 approx and bf16 approx through step_block by 5. Each
   kernel of the method launches once per lockstep frame (59 for 59);
   each video meets tests/test_batched.py's budgets against its own
   single-stream run; the bf16 run meets tests/test_amp.py's budget
   against the f32 run. Prints the median ms per lockstep step, the
   aggregate video-frames/s and the peak memory beside the single stream.
6. Detection fusion (InferenceCore.spatial_alignment,
   vote_in_temporary_buffer, incorporate_detection), f32, exact top-k.
   6a: card against CPU at 64x96 (detection_clips.small_clip,
   tests/test_detection_parity.py's configuration, equal seeded object-id
   generators): spatial_alignment within 5e-3 with one launch of each
   exact kernel; online (a detection every other frame, a segment purged)
   and semi-online (3 voting frames, a vote every 3), each twice. As the
   driver runs them, the forward predictions and alignments within 5e-3,
   and a detection frame or consensus mask may differ beyond it only where
   the two runs' forward predictions or projections have another argmax,
   on at most 5% of the frame (the shares are printed). With a perfect
   forward mask and alignment, no such allowance: every frame within
   5e-3, consensus masks equal, every sensory row within 5e-3. Equal
   object tables and selections throughout.
   6b: online at 480p through eval_with_detections_torch.run_video (an
   in-memory reader, a saver that writes nothing and checks each frame)
   at the driver's defaults (max_missed_detection_count 5), 60 synthetic
   frames with 12 VIPSeg-style segments every 5th frame (one appears at
   20, one vanishes at 25 and is purged): ms per propagation and per
   detection frame from the driver's StepTimer (host part apart), objects
   and buckets over time, launches, peak memory. 6c: semi-online at 480p
   through run_video, 20 frames: ms per spatial alignment and per host
   vote, segments in and selected. The exact pair is held to its plain
   twins on the arguments that 6b's last frame (composed match_memory,
   one call per bucket) and 6c's last alignment gave it. With random
   weights each detection frame opens a bucket whose objects are purged
   after 6 misses, before it holds the 10 memory frames that start
   long-term memory: 6b's calls each read one segment.
7. Batched detection fusion and mid-stream VOS
   (inference/batched_detection.py: every (video, bucket) pair on the
   kernels' video axis, one launch of each kernel of the method per
   lockstep frame). 7a: card against CPU at 64x96 (two clips of
   tests/test_batched_detection.py's kind, video 1 opening a bucket at
   the second detection): online through step_all and step_block, exact
   and approx, long-term memory off and on (detection_clips.
   online_lockstep); semi-online through eval_with_detections_batched_
   torch.run_group (align_consensus_batched); frames within DET_TOL but
   where the forward predictions paint another id (<= DET_FLIP_SHARE),
   alignment ids equal but where the CPU's top two channels tie within
   ALIGN_TIE; a perfect forward mask strict, sensory rows too; the
   card's batched runs within tests/test_batched_detection.py's budgets
   of its sequential runs. 7b:
   four 480p videos of online detection fusion (4 segments a detection,
   BDET_SEGMENTS) through eval_with_detections_batched_torch.
   run_group_online, 60 frames: ms per lockstep propagation frame and
   detection step (host part apart), objects, buckets, S, o_slot and o_cap
   over time, device-to-host copies, launches, peak memory. 7c: four 480p
   mid-stream VOS videos (a third object at frame MID_THIRD_AT[v])
   through eval_vos_batched_torch.run_group_midstream, exact then approx,
   with lockstep consolidation (one call over two pairs at least); each
   video held to its own sequential card run.
   The exact pair on 7b's and 7c's last lockstep frame, and the approx
   pair on 7c's, held to the twins on those arguments (the batched launch
   bitwise each pair's own launch) and timed: rows `.bdet` and `.bmid`.
8. The evaluation drivers, through their own per-video functions with
   in-memory readers and savers that write nothing, so that each step's
   probabilities can be held to the CPU's (phase 13 runs the same drivers
   from argv with files). 8a: card against CPU at 64x96
   (detection_clips.small_clip's frames, phase 6a's configuration given as
   the drivers' flags):
   eval_vos_torch.run_video with --flip --save_scores (exact, and approx
   by chunks of 2; the frames read as if resized) and on a YouTube-VOS-style
   reader whose second object appears at frame 3; eval_ref_davis_torch
   (consensus with rising scores, run_bidirectional) and
   eval_saliency_torch.run_video on 6 frames of soft masks. Every step's
   probabilities within DET_TOL, score maps within 1/255 (the uint8 cast
   truncates), backward maps and keyframes equal, masks that differ only
   at near-ties (binary masks: where both runs' prob[1] - prob[0] lie
   within DET_TOL of 0), and J and F of the card's masks against the CPU's
   at least 0.99 (deva_tpu_torch/metrics/jf.py). 8b: run_video with --flip
   --save_scores at 480p on phase 3's frames and weights, exact per frame
   and approx by chunks of 5, each kernel of the method on every
   propagated frame; each run's steps bitwise those of a run on the
   mirrored clip without --flip, its score maps and masks their mirror
   images; ms/frame from the driver's StepTimer, peak memory. 8c:
   eval_ref_davis_torch at 480p (60 frames, one soft-mask object, 5 voting
   frames, the keyframe at frame 6 so that both passes run and the forward
   pass consolidates into long-term memory): ms per consensus and per
   propagated frame in each direction, the image feature store at the end
   (the passes keep every frame's features), peak memory; the exact pair
   held to its twins on the arguments of the last frame's composed
   match_memory and of the consensus' last alignment: rows `.ref` and
   `.ref.align`.
9. The detector layer and the two demos (deva_tpu_torch/ext, demo/), with
   seeded random weights. 9a: MobileSAM and Light-HQ-SAM at full width
   (TinyViT-5M at 1024, the SAM decoder 256 wide) on one synthetic 854x480
   frame, the card against the CPU: embeddings, the best-of-3 logits for 3
   boxes and an 8x8 point grid within DET_TOL, masks_for_boxes and
   generate equal but where the CPU's logit lies within DET_TOL of 0, and
   the card's generate peak memory; then the text and automatic frame
   processors, semi-online and online, on 7 frames of 64x96 with box-mask
   detectors, by phase 6a's rule. 9b: demo_automatic_torch.run_demo on 30
   synthetic 854x480 frames (three moving rectangles, demo_clip),
   --sam_variant mobile, semi-online, a detection every 5, 3 voting
   frames, max_num_objects 200, but SAM_NUM_POINTS_PER_SIDE 8 and the IoU
   filter off (both printed); 9c: demo_with_text_torch.run_demo on the
   same frames with RectDetector's 3 boxes for Grounding DINO's and
   Light-HQ-SAM (--sam_variant sam_hq_light) as the mask source. Each
   prints ms per propagation, detection and voting frame (its StepTimer),
   a detection frame's parts (SAM encode, decoder, mask post-processing,
   _mask_nms, the host fusion, the vote), the objects over time, the
   launches and the peak memory; the exact pair on the arguments of 9b's
   last frame and last spatial alignment: rows `.demo` and `.demo.align`.

10. Training (deva_tpu_torch/training), f32 with TF32 off unless said.
   10a: one train step of the full-width network at 64x64 (B=2, T=4,
   num_ref_frames 2, 3 objects, it 0 so every pixel counts) on the card
   and on the CPU from the same weights, batch and draws: the total loss
   within 1e-4 relative, each gradient within 1e-3 of its tensor's
   largest, the updates within 1e-2 * lr where the gradient is clear of 0
   and 2 * lr anywhere, each gap printed; a tensor that misses in f32
   (ReLU inputs within f32 rounding of the kink: at full width both
   devices' f32 gradients lie up to a few percent from float64 in some
   tensors) must agree in float64 between the two devices, within 1e-4
   (F64_GRAD_REL). 10b: the
   full-width step at stage-3 shapes (384x384, T=8, num_ref_frames 3, 3
   objects, synthetic moving squares): f32 B=2, f32 B=2 --remat (losses
   within 1e-5 of the plain run's at the first step, 1e-3 after it, where
   the backward's atomics have rounded the updates apart) and bf16
   --remat B=4 (first loss finite and within 5% of f32's on its batch),
   each 2 warm-up and 5 timed steps: ms/step, clips/s, forward, backward
   and update ms (CUDA events), peak memory. 10c: toy.train_toy (the tiny
   model, 120 steps) on the card, then the held-out IoU through
   InferenceCore above 0.5 and the random init's + 0.3, with the exact
   pair launched during the evaluation; the weights saved by save_network
   and reloaded give one clip the same IoU. 10d: training.train.main
   --stages 3 at the tiny widths on the card, 2 iterations with a
   checkpoint, then a resume to 4, VOSDataset replaced by an in-memory
   synthetic dataset.
11. Multi-GPU serving (deva_tpu_torch/parallel), two ranks started as
   subprocesses of this script with torchrun's environment: on a machine
   with one card both share it over gloo (NCCL refuses two ranks on one
   card; every time of a collective is then gloo's, through host copies,
   and no number is a scaling number), with two or more each takes its own
   over NCCL; a rank that fails or passes RANK_TIMEOUT fails the phase.
   Full-width ModelConfig(), seeded weights identical on both ranks, TF32
   off; each sharded run is held to the unsharded run on the same card
   (rank 0, while rank 1 waits), by phase 3's card-against-CPU budget
   (DET_TOL), an argmax flipping only where the unsharded run's top two
   channels tie within ALIGN_TIE (the detection phases' rule). 11a: eval_vos_torch.run_video with
   --obj_shards 2 (InferenceCore(obj_mesh=)) on an 854x480 clip with 16
   objects, 30 frames, mem_every 5, long-term on (a 5-frame working
   memory, so that it consolidates), exact and approx by chunks of 5:
   each rank's peak allocated memory and ms/frame beside the unsharded
   run's, every propagated frame launching both kernels of the method.
   11b: eval_with_detections_torch.run_video online with --obj_shards 2,
   30 frames, a detection every 5th (two stuff bands and things 1-5, 7, 8
   of phase 6b's detections), merged against perfect forward predictions
   so that no host decision reads device output; thing 8 joins at frame
   20 (o_cap 8 -> 16), thing 7 is purged at 25: equal object tables at
   every frame. 11c: parallel.
   attend_mem_sharded at N=16712 (phase 1's validity) over the 'data'
   axis, Q=1620, Ck=64, k=30, C=1024, one launch of each exact kernel per
   rank, against the single-device attend_topk on the rows whose k-th
   value is unique (within 1e-5 of each row's largest output), timed.
   11d: BatchedPropagator(mesh=) at B=4 480p (phase 5's clips), two videos
   a rank, 20 frames with long-term memory engaged, each video within
   phase 5's budgets of the unsharded B=4 group, ring and long-term sizes
   equal. Alone: a script under a git-ignored profiles*/ directory that
   builds the kernels and calls phase11() (README).
12. The native host library and the video demo's core. 12a: the library
   (deva_tpu_torch/utils/native.py: csrc/host/devac.cpp built with this
   machine's g++; its path and a fresh build's time printed) against its
   Python twins: the consensus integer program on NATIVE_GRAPHS seeded
   consensus-style graphs of at most 150 segments
   (detection_clips.consensus_graphs), selections equal where no equal
   weights meet in a component of three or more, objectives equal where
   they do, brute force for n <= 12; RLE strings and decodes on 854x480
   masks (noise, three rectangles, all zero, all one, starting with 1);
   joint_hist against np.add.at. Host ms of both, the integer program at
   n = 30, 70, 150, RLE encode and decode at 854x480; and phase 6c's host
   votes split into the IoU tables (consensus.pairwise_support) and the
   integer program, every solve of which ran through the library. 12b:
   demo/demo_gradio_torch.track_frames on phase 9's 30 synthetic 854x480
   frames, run_auto's path (mobile, 9b's settings) and run_text's
   (RectDetector's boxes, Light-HQ-SAM, 9c's settings): one BGR uint8
   854x480 frame to the writer per input frame, the objects after each
   saved frame equal to the demo's run_demo on the same clip (9b's run;
   for the text path a run of demo_with_text_torch.run_demo at 854x480,
   since 9c runs 1280x720), both exact kernels on every frame propagated
   outside a voting window while objects are held; ms per frame.
13. The command lines: each evaluation driver and demo as a user runs it
   (`python <script> ...` from the repo root, a subprocess; --device left
   at its default, cuda; --raise_on_error wherever the driver has it), on
   the repo's clips and layouts built from them, reading and writing real
   files, with one set of full-width weights written once as an upstream
   .pth (init_weights seed 42, the drivers' own seed) and passed with
   --model. Each command's CPU twin, the same command with --device cpu on
   the same files, runs meanwhile (CLI_CPU_WORKERS at a time); the two
   output trees are then compared. 13a: eval_vos_torch.py on example/vos
   (854x480, 4 frames, 2 objects): exact per frame; --chunk 5
   --topk_method approx --amp --save_scores; --flip --save_scores, then
   scripts/merge_multi_scale_torch.py over each side's Scores/; and on a
   YouTube-VOS (Y19) layout of three synthetic 854x480 JPEG videos of 8,
   10 and 12 frames whose second object's mask arrives mid-video, with
   meta.json (memory frames, per-object first frames, the zip); then
   evaluation/eval_jf_torch.py scores the card's exact PNGs against the
   CPU's. 13b: eval_vos_batched_torch.py --batch 4 on four copies of the
   clip, each video also held to 13a's single-stream card run
   (tests/test_batched.py: at most 2% flips). 13c:
   eval_with_detections_torch.py --dataset vipseg on example/vipseg
   (1280x720 at --size 480: the saver's need_resize branch), semi-online
   and online, and eval_with_detections_batched_torch.py --batch 2 on the
   clip and a copy. 13d: demo_automatic_torch.py --sam_variant mobile
   (seeded SAM weights) at 9b's SAM_NUM_POINTS_PER_SIDE and IoU filter,
   online (semi-online's vote admits none of the seeded SAM's masks on
   this clip). 13e, in this process on each device (the card's machine
   has transformers but no hub): demo_with_text_torch.drive and
   demo_gradio_torch.track_video (main's command-line path: the clip as
   an mp4 written by cv2, decoded by cv2, tracked.mp4 encoded with mp4v),
   with ext/detectors.py's ReplayDetector on
   tests/fixtures/replay_dets_vipseg.npz in Grounding DINO's and SAM's
   place (NearestReplay for the decoded frames) and seeded object ids.
   13f: eval_ref_davis_torch.py and eval_saliency_torch.py on example/vos's
   frames with moving soft-mask boxes. Budgets, card against CPU: the same
   file tree; PNG labels equal on at least 99% of each frame (under a
   one-to-one id matching where ids are drawn per run), and in the --flip
   --save_scores run differing only where the CPU's top two scores lie
   within DET_TOL; score maps within 1/255; the bf16 run's score maps by
   tests/test_amp.py's budget (random weights leave every pixel below its
   0.25 margin, so labels alone say little); equal backward.npy, key.txt
   and zip members; pred.json with the same segments under the matching,
   equal categories, areas apart by no more than the differing pixels, and
   at least one segment; J and F at least 0.99; tracked.mp4 with the same
   frame count and size and a PSNR of at least CLI_PSNR_DB. A non-zero exit
   code, a "Skipping" line (the fault barrier exits 0 after a skipped
   video) or a missing file fails the phase. The commands of 13a and 13d
   run again in this process on the card with the launch counts at 0:
   each kernel of the method on every maskless frame (13d, 13e: the exact
   pair at least once), none of the other pair's. Prints each command's
   wall seconds, FPS line and peak memory, its twin's, and what held. 13g:
   host ms per frame of data/video_reader.py's reader at 854x480 and
   1280x720, and of ResultSaver per saved frame (need_resize branch and
   device argmax branch apart), with the device drained.

The second-to-last line of output is a JSON object with each kernel's
launches (phase 3 for the exact pair, phase 4 for the approx pair), largest
error against its plain twin, and its time, its plain twin's, its bound and
what sets it, the library call's (null where no single call computes the
function) and the product's (null where none applies) at N=16712, once on
f32 rings and once on bf16 rings (names suffixed ".bf16", launches from
the bf16 runs), and again for the batched launch (names suffixed ".b4",
and ".bf16.b4" for the approx pair on bf16 rings; launches from phase 5,
with the time of four single launches as singles_ms), and for the exact
pair on the detection path, timed on the arguments the path gave it: at
6b's last frame (names suffixed ".det", launches of 6b and 6c outside the
alignments) and at 6c's last alignment (Q = N = 1620, C = 16 x 512; names
suffixed ".det.align", launches of the alignments), each with its
"shape", and for the batched detection path (".bdet": the exact pair at
7b's last lockstep frame, launches of 7b; ".bmid": both pairs at 7c's,
launches of 7c), and for the bidirectional referring driver (".ref": the
exact pair at 8c's last frame, launches of 8c outside the consensus;
".ref.align": at the consensus' last alignment, launches of the
alignments), and for the demos (".demo": the exact pair at 9b's last
frame, launches of 9b and 9c outside the alignments; ".demo.align": at
9b's last spatial alignment, launches of both demos' alignments), and for
object and memory sharding (".osh": the exact pair at 11a's last exact
frame on rank 0's object slots, launches of rank 0's 11a exact run;
".msh": at 11c's call on rank 0's token shard, launches of that call);
the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
from __future__ import annotations

import copy
import gc
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H480, W480 = 480, 854
KERNELS = {
    "sim_topk": ("deva_tpu_torch/csrc/sim_topk.cu",
                 "deva_tpu/ops/pallas_attention.py:177"),
    "topk_readout": ("deva_tpu_torch/csrc/topk_readout.cu",
                     "deva_tpu/ops/pallas_attention.py:249"),
    "segmax": ("deva_tpu_torch/csrc/segmax.cu",
               "deva_tpu/ops/pallas_attention.py:451"),
    "denom_readout": ("deva_tpu_torch/csrc/denom_readout.cu",
                      "deva_tpu/ops/pallas_attention.py:491"),
}
# ring tokens of phase 1: the working ring grows 1620 -> 3240 -> 6480 as
# memory frames arrive, and with long-term memory it is read beside 512
# long-term slots
RING_CASES = (1620, 3240, 6480, 8100, 16712)
# the long-term ring's slots at 480p: phase 1 splits every ring there for
# the two-segment readout
LT_SLOTS = 512
# phase 1's rings on bf16: one memory frame, and [long-term ; working]
BF16_RINGS = (1620, 16712)
# the kernels of topk_method 'exact'; the other two are 'approx''s
EXACT_PAIR = ("sim_topk", "topk_readout")
# phase 2's budget for the bf16 slice, card against CPU: the two run bf16
# convolutions that sum in different orders (cuDNN, oneDNN), each layer a
# few bf16 ulps apart; about three times the largest |dprob| the H100 gave
# (tests/test_torch_cuda.py: 0.0126 exact, 0.0172 approx at 64x96)
BF16_SLICE_TOL = 0.05
# phase 1b and phase 5: videos in one lockstep batch (deva_tpu's --batch
# default), and phase 1b's per-video long-term tokens in the 512 long-term
# slots of the N=16712 ring (video 2 attends over an all-invalid segment)
B4 = 4
BATCH_LT_SIZES = (512, 384, 0, 512)
# NVIDIA H100 SXM data sheet: f32 FFMA peak outside the tensor cores, and
# HBM3 bandwidth (both at the 700 W limit)
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for work of
    `flops` f32 operations that must move `nbytes` bytes (each input read
    once, each output written once), and which of the two sets it."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ring_validity(n, dev):
    """Validity of each phase-1 ring, as the memory engine lays them out."""
    ar = lambda m: torch.arange(m, device=dev)
    return {1620: ar(1620) < 1620,                  # one memory frame
            3240: ar(3240) < 3240,                  # two, full
            6480: ar(6480) < 4860,                  # three of four
            8100: ar(8100) < 6480,                  # working ring, 4/5 full
            16712: torch.cat([ar(512) < 128,        # [long-term ; working]
                              ar(16200) < 9720])}[n]


def readout_tiles():
    """(QT, CS, CAP) of csrc/topk_readout.cu, read from the source."""
    with open(os.path.join(ROOT, KERNELS["topk_readout"][0])) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in ("QT", "CS", "CAP"))


def readout_rows(gi, c: int):
    """What topk_readout.cu reads for indices gi [Q, k] and C value
    columns: the distinct rows U of each tile of QT queries, and the value
    bytes it reads from L2 (per tile, CAP distinct rows once and every pair
    whose row has a later slot by itself; the kernel's threads claim slots
    in any order, counted here by first occurrence in pair order), beside
    Q*k*C*4 of one gather per pair. Returns (U per tile, bytes, gather
    bytes)."""
    qt, _, cap = readout_tiles()
    q, k = gi.shape
    flat = gi.long().reshape(-1)
    per_tile, rows_read = [], 0
    for q0 in range(0, q, qt):
        rows = flat[q0 * k:min(q, q0 + qt) * k]
        uniq, inv = torch.unique(rows, return_inverse=True)
        first = torch.full((len(uniq),), rows.numel(), device=rows.device)
        first.scatter_reduce_(0, inv, torch.arange(rows.numel(),
                                                   device=rows.device),
                              "amin")
        slot = torch.argsort(torch.argsort(first))[inv]
        per_tile.append(len(uniq))
        rows_read += min(len(uniq), cap) + int((slot >= cap).sum())
    return per_tile, rows_read * c * 4, q * k * c * 4


def rows_line(label, gi, c: int) -> str:
    per_tile, nbytes, gather = readout_rows(gi, c)
    qt = readout_tiles()[0]
    return (f"{label}: topk_readout rows per tile of {qt} queries mean "
            f"{statistics.mean(per_tile):.1f} max {max(per_tile)} (of "
            f"{gi.shape[1] * qt} pairs); "
            f"L2 value bytes {nbytes / 1e6:.1f} MB against {gather / 1e6:.1f}"
            f" MB gathered per pair")


def cuda_ms(fn, iters: int = 20, windows: int = 3) -> float:
    """Device time of fn() in ms: the mean over `iters` runs, after a
    warm-up, in the fastest of `windows` windows. A sleeping kernel ahead of
    each window lets the host queue its runs before the first starts, so
    host time per call does not enter. A host stall longer than the sleep
    would, hence the fastest window."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(windows):
        torch.cuda._sleep(5_000_000)  # ~2.5 ms at the H100's boost clock
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def host_us(fn, calls: int = 100) -> float:
    """Host time of one fn() call in us: `calls` calls with no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


# --------------------------------------------------------------------------
# phase 1: kernels against their plain twins
# --------------------------------------------------------------------------

def phase_kernels(ak, apx, dev) -> dict:
    q, ck, k, c = 1620, 64, 30, 2 * 512
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    qk, qe = randn(q, ck), rand(q, ck)
    err = {"sim_topk": 0.0, "topk_readout": 0.0}
    times, bounds = {}, {}
    for n in RING_CASES:
        valid = ring_validity(n, dev)
        mk, ms = randn(n, ck), 1 + 3 * rand(n)
        values = randn(n, 2, 512)
        gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
        rv, ri = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(gv, rv, rtol=1e-5, atol=1e-5)
        mism = (gi != ri).float().mean().item()
        assert mism < 1e-3, f"sim_topk N={n}: index mismatch share {mism}"
        assert int(gi.min()) >= 0 and int(gi.max()) < n
        err["sim_topk"] = max(err["sim_topk"], (gv - rv).abs().max().item())

        w = torch.softmax(gv, dim=-1)
        v2 = values.reshape(n, c)
        out = ak.topk_readout(gi, w, v2)
        ref = ak.topk_readout_plain(gi, w, v2)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        # the ring as [long-term ; working] segments, read in place
        pair = (v2[:LT_SLOTS], v2[LT_SLOTS:])
        assert same_bits(ak.topk_readout(gi, w, pair), out), \
            f"topk_readout N={n}: two segments differ from one"
        err["topk_readout"] = max(err["topk_readout"],
                                  (out - ref).abs().max().item())

        # the library call with topk_readout's function (never used by the
        # port): one bag of k weighted rows per query
        gl = gi.long()
        bag = torch.nn.functional.embedding_bag(gl, v2, mode="sum",
                                                per_sample_weights=w)
        torch.testing.assert_close(bag, ref, rtol=1e-4, atol=1e-4)
        # cuBLAS's f32 product of the one-product similarity's operands: the
        # reference for sim_topk's FFMA part, not for its whole function
        ops2 = apx.prep2(qk, qe, mk, ms, valid)

        o, u = ak.attend_topk(mk, ms, values, qk, qe, k, valid, True)
        ro, ru = ak.attend_topk_plain(mk, ms, values, qk, qe, k, valid, True)
        torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(u, ru, rtol=1e-4, atol=1e-4)

        rows = int(torch.unique(gi).numel())  # value rows the readout needs
        bounds[n] = {
            "sim_topk": bound(4 * q * n * ck, 4 * (2 * q * ck + n * ck + n)
                              + n + 8 * q * k),
            "topk_readout": bound(2 * q * k * c, 8 * q * k + 4 * rows * c
                                  + 4 * q * c)}
        t = {
            "sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk, ms, valid,
                                                    k)),
            "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
                qk, qe, mk, ms, valid, k)),
            "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, v2)),
            "topk_readout_two_segments": cuda_ms(
                lambda: ak.topk_readout(gi, w, pair)),
            "topk_readout_plain": cuda_ms(
                lambda: ak.topk_readout_plain(gi, w, v2)),
            "topk_readout_library": cuda_ms(
                lambda: torch.nn.functional.embedding_bag(
                    gl, v2, mode="sum", per_sample_weights=w)),
            "sim_topk_product": cuda_ms(
                lambda: torch.mm(ops2.qcat, ops2.mcat.T)),
            "attend_topk": cuda_ms(lambda: ak.attend_topk(
                mk, ms, values, qk, qe, k, valid, True)),
            "attend_topk_plain": cuda_ms(lambda: ak.attend_topk_plain(
                mk, ms, values, qk, qe, k, valid, True)),
        }
        times[n] = t
        print(f"phase 1 N={n}: sim_topk host us per call "
              f"{host_us(lambda: ak.sim_topk(qk, qe, mk, ms, valid, k)):.1f}"
              f" (device {t['sim_topk'] * 1000:.1f})", flush=True)
        print(f"phase 1 N={n}: sim_topk err {(gv - rv).abs().max().item():.3g}"
              f" idx-mismatch {mism:.2e}; readout err "
              f"{(out - ref).abs().max().item():.3g}; usage err "
              f"{(u - ru).abs().max().item():.3g}; ms " +
              ", ".join(f"{name} {v:.4f}" for name, v in t.items()) +
              f"; readout rows {rows}; bound ms " +
              ", ".join(f"{name} {b:.4f} ({by})"
                        for name, (b, by) in bounds[n].items()),
              flush=True)
        print(rows_line(f"phase 1 N={n}", gi, c) + "; two segments split "
              f"at {LT_SLOTS} bitwise one", flush=True)

    # ties: 10 copies of 1620 tokens; for each query the exact top-30 is the
    # 10 copies of its best 3 base tokens, lowest copy first
    base_n = 1620
    mk = randn(base_n, ck).repeat(10, 1)
    ms = (1 + 3 * rand(base_n)).repeat(10)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, None, k)
    bv = ak.sim_topk_plain(qk, qe, mk[:base_n], ms[:base_n], None, 3)[0]
    bi = ak.sim_topk(qk, qe, mk[:base_n], ms[:base_n], None, 3)[1]
    copies = torch.arange(10, device=dev) * base_n
    expect = (bi.long()[:, :, None] + copies).reshape(q, k)
    assert torch.equal(gi.long(), expect), "tie order differs"
    torch.testing.assert_close(gv, bv.repeat_interleave(10, dim=1),
                               rtol=1e-5, atol=1e-5)
    print("phase 1 ties: duplicated ring of 16200 tokens resolves to the "
          "lowest index", flush=True)
    return {"err": err, "times": times, "bounds": bounds}


def check_composite(apx, rings, qk, qe, k, eps: float, label: str):
    """attend_approx_multi against its plain twin. Rows may differ only
    where a similarity lies within eps of the row's threshold: the two sum
    the similarity in another order, so such an entry can fall on either
    side. Returns the kernel's result."""
    out, us = apx.attend_approx_multi(rings, qk, qe, k, return_usage=True)
    ref, rus = apx.attend_approx_multi_plain(rings, qk, qe, k,
                                             return_usage=True)
    usage, ref_usage = torch.cat(us), torch.cat(rus)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()), f"{label}: non-finite readout"
    row_err = (out - ref).abs().amax(dim=(0, 2))
    moved = row_err > 1e-4 + 1e-4 * ref.abs().amax(dim=(0, 2))
    if bool(moved.any()):
        mk, ms, _, valid = apx._concat_rings(rings)
        ops = apx.prep2(qk, qe, mk, ms, valid)
        seg = apx.segmax_plain(ops, apx.Geometry.of(
            mk.shape[0], apx.default_n_tile(out.shape[0] * out.shape[2], 4)))
        _, th = apx.threshold(seg, k)
        near = ((apx.similarity2_plain(ops) - th).abs() <= eps).any(-1)
        assert bool(near[moved].all()), \
            f"{label}: rows differ with no similarity near the threshold"
        assert float((usage - ref_usage).abs().sum()) <= \
            2 * int(moved.sum()) + 1e-2, f"{label}: usage moved too far"
    else:
        torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)
    print(f"phase 1 {label}: attend_approx_multi max row err "
          f"{row_err.max().item():.3g}, {int(moved.sum())} near-threshold "
          f"rows of {out.shape[1]}", flush=True)
    return out


def same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def check_segmax_bits(apx, ops, geom, seg, rows):
    """segmax at query rows `rows` is bitwise the max, over each group's
    members, of sim2_at (the fmaf chain denom_readout recomputes); padded
    tokens are -inf."""
    sub = ops._replace(qcat=ops.qcat[rows].contiguous(),
                       bsq=None if ops.bsq is None else
                       ops.bsq[rows].contiguous())
    idx = torch.arange(geom.tiles * geom.n_tile, dtype=torch.int32,
                       device=seg.device).expand(len(rows), -1).contiguous()
    at = apx.sim2_at(sub, idx).reshape(len(rows), geom.tiles, geom.group,
                                       geom.width)
    ref = at.amax(2).reshape(len(rows), geom.nseg)
    assert same_bits(seg[rows], ref), "segmax is not the max of sim2_at"


def support_check(ak, apx, mk, ms, valid, values2d, qk, qe, k, n_tile=512):
    """The kernels' support contains the exact top-k: at every exact top-k
    token of sim_topk, the pair's similarity (the float the kernels compare)
    is at least the threshold denom_readout used, and that threshold and
    its row max are bitwise `threshold` of the group maxima. Returns the
    support sizes per row of the plain twin, for the record."""
    ops = apx.prep2(qk, qe, mk, ms, valid)
    geom = apx.Geometry.of(mk.shape[0], n_tile)
    seg = apx.segmax(ops, geom)
    _, _, rmax, th = apx.denom_readout(ops, geom, seg, values2d, k)
    rmax_ref, th_ref = apx.threshold(seg, k)
    assert same_bits(th, th_ref) and same_bits(rmax, rmax_ref), \
        "denom_readout's rmax or th differs from threshold()"
    _, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
    at = apx.sim2_at(ops, gi)
    torch.cuda.synchronize()
    miss = int((at < th).sum())
    assert miss == 0, f"{miss} exact top-k entries outside the support"
    _, th_plain = apx.threshold(apx.segmax_plain(ops, geom), k)
    return (apx.similarity2_plain(ops) >= th_plain).sum(-1)


def phase_approx_kernels(ak, apx, dev) -> dict:
    """segmax, denom_readout and attend_approx_multi against their twins."""
    q, ck, k, o, cv = 1620, 64, 30, 2, 512
    c, kc = o * cv, 2 * ck
    n_tile = apx.default_n_tile(o * cv, 4)
    assert n_tile == 512
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    qk, qe = randn(q, ck), rand(q, ck)
    eps = 1e-3  # well above the kernel-vs-matmul rounding of sim (~1e-5)
    err = {"segmax": 0.0, "denom_readout": 0.0}
    times, bounds = {}, {}
    sample = torch.randperm(q, generator=gen, device=dev)[:64]
    for n in RING_CASES:
        valid = ring_validity(n, dev)
        mk, ms, values = randn(n, ck), 1 + 3 * rand(n), randn(n, o, cv)
        v2 = values.reshape(n, c)
        ops = apx.prep2(qk, qe, mk, ms, valid)
        geom = apx.Geometry.of(n, n_tile)
        assert geom.group == 4 and geom.width == 128

        seg = apx.segmax(ops, geom)
        seg_ref = apx.segmax_plain(ops, geom)
        torch.cuda.synchronize()
        assert torch.equal(torch.isfinite(seg), torch.isfinite(seg_ref))
        fin = torch.isfinite(seg_ref)
        torch.testing.assert_close(seg[fin], seg_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        err["segmax"] = max(err["segmax"],
                            (seg[fin] - seg_ref[fin]).abs().max().item())
        check_segmax_bits(apx, ops, geom, seg, sample)

        rmax, th = apx.threshold(seg, k)
        sim = apx.similarity2_plain(ops)
        th_gap = apx.gap_threshold(sim, th, eps)
        out, usage, rmax_k, th_k = apx.denom_readout(ops, geom, seg, v2, k,
                                                     th_gap)
        ref, ref_usage = apx.denom_readout_plain(ops, geom, seg, rmax,
                                                 th_gap, v2)
        torch.cuda.synchronize()
        assert same_bits(rmax_k, rmax) and same_bits(th_k, th_gap)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)
        err["denom_readout"] = max(err["denom_readout"],
                                   (out - ref).abs().max().item(),
                                   (usage - ref_usage).abs().max().item())

        rings = [(mk, ms, values, valid)] if n != 16712 else \
            [(mk[:512], ms[:512], values[:512], valid[:512]),
             (mk[512:], ms[512:], values[512:], valid[512:])]
        check_composite(apx, rings, qk, qe, k, eps, f"N={n}")
        sizes = support_check(ak, apx, mk, ms, valid, v2, qk, qe, k)

        # the support of the plain twin at the kernel's threshold: the
        # entries whose similarity and value row the readout needs
        support = (sim >= th) & torch.isfinite(sim)
        entries = int(support.sum())
        rows = int(support.any(0).sum())
        bounds[n] = {
            "segmax": bound(2 * q * n * kc, 4 * (q * kc + n * kc + n + q)
                            + n + 4 * q * geom.nseg),
            "denom_readout": bound(
                2 * entries * (kc + c),
                4 * q * (geom.nseg + kc + 1 + c) + rows * (4 * (c + kc + 1)
                                                           + 1) + 4 * n)}
        del sim, support
        t = {
            "segmax": cuda_ms(lambda: apx.segmax(ops, geom)),
            "segmax_plain": cuda_ms(lambda: apx.segmax_plain(ops, geom)),
            "segmax_product": cuda_ms(lambda: torch.mm(ops.qcat,
                                                       ops.mcat.T)),
            "denom_readout": cuda_ms(lambda: apx.denom_readout(
                ops, geom, seg, v2, k)),
            "denom_readout_plain": cuda_ms(lambda: apx._denom_readout_twin(
                ops, geom, seg, v2, k)),
            "attend_approx_multi": cuda_ms(lambda: apx.attend_approx_multi(
                rings, qk, qe, k, return_usage=True)),
            "attend_approx_multi_plain": cuda_ms(
                lambda: apx.attend_approx_multi_plain(
                    rings, qk, qe, k, return_usage=True)),
        }
        times[n] = t
        print(f"phase 1 N={n}: segmax err {err['segmax']:.3g}, bitwise "
              f"the max of sim2_at on {len(sample)} rows; denom_readout err "
              f"{err['denom_readout']:.3g}, rmax and th bitwise threshold(); "
              f"support min/median/max {int(sizes.min())}/"
              f"{int(sizes.median())}/{int(sizes.max())} (k={k}) holds "
              f"the exact top-k; {entries} support entries over {rows} "
              f"tokens; ms " +
              ", ".join(f"{name} {v:.4f}" for name, v in t.items()) +
              "; bound ms " +
              ", ".join(f"{name} {b:.4f} ({by})"
                        for name, (b, by) in bounds[n].items()),
              flush=True)

    # ties: 54 base tokens, 300 copies each; the tied group maxima admit
    # every copy of a row's best base token (> 4k entries)
    base = 54
    mk = randn(base, ck).repeat(300, 1)
    ms = (1 + 3 * rand(base)).repeat(300)
    values = randn(base * 300, o, cv)
    sizes = support_check(ak, apx, mk, ms, None, values.reshape(-1, c), qk,
                          qe, k)
    assert int(sizes.min()) > 4 * k, int(sizes.min())
    check_composite(apx, [(mk, ms, values, None)], qk, qe, k, eps,
                    "duplicated ring")
    print(f"phase 1 ties: support of {int(sizes.min())}-{int(sizes.max())} "
          f"tied entries per row holds the exact top-k", flush=True)

    # rows with fewer valid tokens than k (th = -inf), and with none
    for n_valid in (20, 0):
        n = 1620
        valid = torch.arange(n, device=dev) < n_valid
        ring = [(randn(n, ck), 1 + 3 * rand(n), randn(n, o, cv), valid)]
        out = check_composite(apx, ring, qk, qe, k, eps,
                              f"{n_valid} valid tokens")
        mk_, ms_, values_, _ = ring[0]
        support_check(ak, apx, mk_, ms_, valid, values_.reshape(n, c), qk,
                      qe, k)
        if n_valid == 0:
            assert not bool(out.abs().gt(0).any()), "empty rows must be 0"
    return {"err": err, "times": times, "bounds": bounds}


def phase_kernels_bf16(ak, apx, dev) -> dict:
    """Phase 1 on bf16 rings (InferenceConfig(ring_dtype='bfloat16')), at
    N = 1620 and 16712: each kernel against its f32 launch on the widened
    rings, with the relation its design gives, and against its plain twin
    on the same bf16 rings; timed beside a bound counted for bf16 (the key
    and value bytes halve, the similarity's f32 FFMAs do not; segmax reads
    the f32 mcat that prep2 builds from the widened keys, so its bound does
    not change)."""
    q, ck, k, o, cv = 1620, 64, 30, 2, 512
    c, kc = o * cv, 2 * ck
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    qk, qe = randn(q, ck), rand(q, ck)
    n_tile = apx.default_n_tile(c, 2)
    assert n_tile == 1024  # deva_tpu's tile for bf16 rows of 1024 values
    err = dict.fromkeys(KERNELS, 0.0)
    times, bounds = {}, {}
    for n in BF16_RINGS:
        valid = ring_validity(n, dev)
        mk16, ms16 = randn(n, ck).bfloat16(), (1 + 3 * rand(n)).bfloat16()
        v16 = randn(n, c).bfloat16()
        mk32, ms32, v32 = mk16.float(), ms16.float(), v16.float()

        # sim_topk: bitwise the f32 launch on the widened ring
        gv, gi = ak.sim_topk(qk, qe, mk16, ms16, valid, k)
        rv, ri = ak.sim_topk(qk, qe, mk32, ms32, valid, k)
        pv, pi = ak.sim_topk_plain(qk, qe, mk16, ms16, valid, k)
        torch.cuda.synchronize()
        assert same_bits(gv, rv) and torch.equal(gi, ri), \
            f"sim_topk bf16 N={n}: not bitwise the widened ring"
        torch.testing.assert_close(gv, pv, rtol=1e-5, atol=1e-5)
        assert (gi != pi).float().mean().item() < 1e-3
        err["sim_topk"] = max(err["sim_topk"], (gv - pv).abs().max().item())

        # topk_readout: bitwise the f32 launch on (w rounded, V widened),
        # one segment and two
        w = torch.softmax(gv, dim=-1)
        out = ak.topk_readout(gi, w, v16)
        ref = ak.topk_readout(gi, w.bfloat16().float(), v32)
        pair = (v16[:LT_SLOTS], v16[LT_SLOTS:])
        plain = ak.topk_readout_plain(gi, w, v16)
        torch.cuda.synchronize()
        assert same_bits(out, ref), f"topk_readout bf16 N={n}: not bitwise"
        assert same_bits(ak.topk_readout(gi, w, pair), out), \
            f"topk_readout bf16 N={n}: two segments differ from one"
        torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
        err["topk_readout"] = max(err["topk_readout"],
                                  (out - plain).abs().max().item())

        # segmax: bitwise on the widened keys
        ops = apx.prep2(qk, qe, mk16, ms16, valid)
        ops32 = apx.prep2(qk, qe, mk32, ms32, valid)
        geom = apx.Geometry.of(n, n_tile)
        seg = apx.segmax(ops, geom)
        seg_ref = apx.segmax_plain(ops, geom)
        torch.cuda.synchronize()
        assert same_bits(seg, apx.segmax(ops32, geom)), \
            f"segmax bf16 N={n}: not bitwise the widened keys"
        fin = torch.isfinite(seg_ref)
        assert torch.equal(torch.isfinite(seg), fin)
        torch.testing.assert_close(seg[fin], seg_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        err["segmax"] = max(err["segmax"],
                            (seg[fin] - seg_ref[fin]).abs().max().item())

        # denom_readout: rmax and th bitwise, usage within atomics noise,
        # out within the bf16 rounding of the normalised weights, of the
        # f32-ring launch; against the twin on the same bf16 ring
        o16, u16, rmax16, th16 = apx.denom_readout(ops, geom, seg, v16, k)
        o32, u32, rmax32, th32 = apx.denom_readout(ops, geom, seg, v32, k)
        torch.cuda.synchronize()
        assert same_bits(rmax16, rmax32) and same_bits(th16, th32), \
            f"denom_readout bf16 N={n}: rmax or th differ"
        usage_bits = same_bits(u16, u32)
        torch.testing.assert_close(u16, u32, rtol=1e-5, atol=1e-6)
        sim = apx.similarity2_plain(ops)
        aff = apx._support_weights(sim, rmax32, th32)
        slack = 2.0 ** -8 * (aff @ v32.abs()) + 1e-6
        excess = ((o16 - o32).abs() / slack).max().item()
        assert excess <= 1.0, f"denom_readout bf16 N={n}: {excess} of bound"
        th_gap = apx.gap_threshold(sim, th32, 1e-3)
        og, _, _, _ = apx.denom_readout(ops, geom, seg, v16, k, th_gap)
        rg, _ = apx.denom_readout_plain(ops, geom, seg, rmax32, th_gap, v16)
        diff = (og - rg).abs()
        tight = (diff <= 1e-5 + 1e-5 * rg.abs()).float().mean().item()
        aff_gap = apx._support_weights(sim, rmax32, th_gap)
        assert tight >= 0.99 and bool(
            (diff <= 2.0 ** -7 * (aff_gap @ v32.abs()) + 1e-5).all()), \
            f"denom_readout bf16 N={n}: twin {tight:.4f} within 1e-5"
        err["denom_readout"] = max(err["denom_readout"], diff.max().item())
        support = (sim >= th32) & torch.isfinite(sim)
        entries, rows = int(support.sum()), int(support.any(0).sum())
        del sim, aff, aff_gap, support, slack
        rows_r = int(torch.unique(gi).numel())

        bounds[n] = {
            "sim_topk": bound(4 * q * n * ck, 4 * 2 * q * ck
                              + 2 * (n * ck + n) + n + 8 * q * k),
            "topk_readout": bound(2 * q * k * c, 8 * q * k + 2 * rows_r * c
                                  + 4 * q * c),
            "segmax": bound(2 * q * n * kc, 4 * (q * kc + n * kc + n + q)
                            + n + 4 * q * geom.nseg),
            "denom_readout": bound(
                2 * entries * (kc + c),
                4 * q * (geom.nseg + kc + 1 + c) + rows * (2 * c + 4 * kc
                                                           + 4 + 1) + 4 * n)}
        t = {
            "sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk16, ms16,
                                                    valid, k)),
            "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
                qk, qe, mk16, ms16, valid, k)),
            "sim_topk_product": cuda_ms(lambda: torch.mm(ops.qcat,
                                                         ops.mcat.T)),
            "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, v16)),
            "topk_readout_two_segments": cuda_ms(
                lambda: ak.topk_readout(gi, w, pair)),
            "topk_readout_plain": cuda_ms(
                lambda: ak.topk_readout_plain(gi, w, v16)),
            "segmax": cuda_ms(lambda: apx.segmax(ops, geom)),
            "segmax_plain": cuda_ms(lambda: apx.segmax_plain(ops, geom)),
            "segmax_product": cuda_ms(lambda: torch.mm(ops.qcat,
                                                       ops.mcat.T)),
            "denom_readout": cuda_ms(lambda: apx.denom_readout(
                ops, geom, seg, v16, k)),
            "denom_readout_plain": cuda_ms(lambda: apx._denom_readout_twin(
                ops, geom, seg, v16, k)),
            "denom_readout_f32_ring": cuda_ms(lambda: apx.denom_readout(
                ops, geom, seg, v32, k)),
        }
        times[n] = t
        print(f"phase 1 bf16 rings N={n}: sim_topk, topk_readout (one and "
              f"two segments) and segmax bitwise their f32 launches on the "
              f"widened rings; denom_readout rmax, th bitwise, usage "
              f"{'bitwise' if usage_bits else 'within 1e-5'}, out at most "
              f"{excess:.3f} of the 2^-8 bound, twin within 1e-5 on "
              f"{tight:.4%}; err vs twins " +
              ", ".join(f"{name} {v:.3g}" for name, v in err.items()) +
              "; ms " + ", ".join(f"{name} {v:.4f}" for name, v in t.items())
              + "; bound ms " +
              ", ".join(f"{name} {b:.4f} ({by})"
                        for name, (b, by) in bounds[n].items()), flush=True)
    return {"err": err, "times": times, "bounds": bounds}


# --------------------------------------------------------------------------
# phase 1b: the kernels' video axis (the batched propagator's launches)
# --------------------------------------------------------------------------

def batched_validity(n, dev):
    """[B4, n] validity of phase 1b's rings: at N=16712 each video's
    [long-term ; working] ring holds BATCH_LT_SIZES long-term tokens beside
    ring_validity's working part; at N=1620 every video one memory frame."""
    if n != 16712:
        return ring_validity(n, dev).repeat(B4, 1)
    lt = torch.arange(LT_SLOTS, device=dev)
    work = ring_validity(n, dev)[LT_SLOTS:]
    return torch.stack([torch.cat([lt < s, work]) for s in BATCH_LT_SIZES])


def per_video(x, b):
    """Video b's part of a batched argument: a tensor's row b, each field
    of an Operands or tuple, None as it is."""
    if isinstance(x, tuple):
        return type(x)(*(per_video(t, b) for t in x)) \
            if hasattr(x, "_fields") else tuple(per_video(t, b) for t in x)
    return None if x is None else x[b]


def singles(fn, *args):
    """fn once per video on its part of args (B4 single-video launches),
    each output stacked over the videos."""
    outs = [fn(*(per_video(a, b) for a in args)) for b in range(B4)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def phase_kernels_batched(ak, apx, dev, ring: str = "float32") -> dict:
    """The four kernels' video axis: B4 videos in one launch at phase 1's
    shapes (N = 1620 and 16712 per video, per-video long-term sizes
    BATCH_LT_SIZES at 16712, so one video attends over an all-invalid
    long-term segment), on `ring` rings. sim_topk, topk_readout (one and
    two segments) and segmax bitwise B4 single-video launches;
    denom_readout's rmax and th bitwise, its out and usage within 1e-5
    (the usage atomics add in another order). Each held to its batched
    plain twin at phase 1's budgets. Timed beside B4 single launches, the
    twin and (f32, N=16712) the library call and the product, with B4 times
    the single-video bound."""
    q, ck, k, o, cv = 1620, 64, 30, 2, 512
    c, kc = o * cv, 2 * ck
    dt = getattr(torch, ring)
    isz = torch.finfo(dt).bits // 8  # ring bytes per element
    gen = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    qk, qe = randn(B4, q, ck), rand(B4, q, ck)
    n_tile = apx.default_n_tile(c, isz)
    err = dict.fromkeys(KERNELS, 0.0)
    times, bounds = {}, {}
    for n in (1620, 16712):
        valid = batched_validity(n, dev)
        mk, ms = randn(B4, n, ck).to(dt), (1 + 3 * rand(B4, n)).to(dt)
        v2 = randn(B4, n, c).to(dt)
        # [long-term ; working] value rings, each its own tensor (as the
        # propagator keeps them)
        pair = (v2[:, :LT_SLOTS].contiguous(), v2[:, LT_SLOTS:].contiguous())

        gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
        sv, si = singles(lambda *a: ak.sim_topk(*a, k), qk, qe, mk, ms,
                         valid)
        pv, pi = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
        torch.cuda.synchronize()
        assert same_bits(gv, sv) and torch.equal(gi, si), \
            f"sim_topk B={B4} N={n}: not bitwise the single launches"
        torch.testing.assert_close(gv, pv, rtol=1e-5, atol=1e-5)
        mism = (gi != pi).float().mean().item()
        assert mism < 1e-3, f"sim_topk B={B4} N={n}: mismatch {mism}"
        assert int(gi.min()) >= 0 and int(gi.max()) < n
        err["sim_topk"] = max(err["sim_topk"], (gv - pv).abs().max().item())

        w = torch.softmax(gv, dim=-1)
        out = ak.topk_readout(gi, w, v2)
        out2 = ak.topk_readout(gi, w, pair)
        so = singles(ak.topk_readout, gi, w, v2)
        so2 = singles(ak.topk_readout, gi, w, pair)
        plain = ak.topk_readout_plain(gi, w, v2)
        torch.cuda.synchronize()
        assert same_bits(out, so) and same_bits(out2, so2) and \
            same_bits(out2, out), f"topk_readout B={B4} N={n}: not bitwise"
        torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
        err["topk_readout"] = max(err["topk_readout"],
                                  (out - plain).abs().max().item())

        ops = apx.prep2(qk, qe, mk, ms, valid)
        geom = apx.Geometry.of(n, n_tile)
        seg = apx.segmax(ops, geom)
        sseg = singles(lambda x: apx.segmax(x, geom), ops)
        seg_ref = apx.segmax_plain(ops, geom)
        torch.cuda.synchronize()
        assert same_bits(seg, sseg), f"segmax B={B4} N={n}: not bitwise"
        fin = torch.isfinite(seg_ref)
        assert torch.equal(torch.isfinite(seg), fin)
        torch.testing.assert_close(seg[fin], seg_ref[fin], rtol=1e-5,
                                   atol=1e-5)
        err["segmax"] = max(err["segmax"],
                            (seg[fin] - seg_ref[fin]).abs().max().item())

        dr = apx.denom_readout(ops, geom, seg, v2, k)
        sdr = singles(lambda x, s_, v: apx.denom_readout(x, geom, s_, v, k),
                      ops, seg, v2)
        torch.cuda.synchronize()
        out_d, u_d, rmax, th = dr
        assert same_bits(rmax, sdr[2]) and same_bits(th, sdr[3]), \
            f"denom_readout B={B4} N={n}: rmax or th not bitwise"
        torch.testing.assert_close(out_d, sdr[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(u_d, sdr[1], rtol=1e-5, atol=1e-5)
        # against the twin at a threshold no similarity lies near
        sim = apx.similarity2_plain(ops)
        th_gap = apx.gap_threshold(sim, th, 1e-3)
        og, ug, _, _ = apx.denom_readout(ops, geom, seg, v2, k, th_gap)
        rg, rug = apx.denom_readout_plain(ops, geom, seg, rmax, th_gap, v2)
        torch.cuda.synchronize()
        torch.testing.assert_close(ug, rug, rtol=1e-4, atol=1e-4)
        diff = (og - rg).abs()
        if ring == "float32":
            torch.testing.assert_close(og, rg, rtol=1e-4, atol=1e-4)
        else:  # one bf16 ulp of the weights (phase 1's bf16 budget)
            aff_gap = apx._support_weights(sim, rmax, th_gap)
            tight = (diff <= 1e-5 + 1e-5 * rg.abs()).float().mean().item()
            assert tight >= 0.99 and bool((diff <= 2.0 ** -7 * (
                aff_gap @ v2.float().abs()) + 1e-5).all()), \
                f"denom_readout bf16 B={B4} N={n}: twin {tight:.4f}"
            del aff_gap
        err["denom_readout"] = max(err["denom_readout"], diff.max().item(),
                                   (ug - rug).abs().max().item())
        support = (sim >= th) & torch.isfinite(sim)
        entries, rows = int(support.sum()), int(support.any(-2).sum())
        del sim, support
        rows_r = sum(int(torch.unique(gi[b]).numel()) for b in range(B4))

        # B4 times the single-video work (rows and support summed over the
        # videos); bf16: ring bytes halve, as in phase 1
        bounds[n] = {
            "sim_topk": bound(B4 * 4 * q * n * ck, B4 * (
                4 * 2 * q * ck + isz * (n * ck + n) + n + 8 * q * k)),
            "topk_readout": bound(B4 * 2 * q * k * c, B4 * (
                8 * q * k + 4 * q * c) + isz * rows_r * c),
            "segmax": bound(B4 * 2 * q * n * kc, B4 * (
                4 * (q * kc + n * kc + n + q) + n + 4 * q * geom.nseg)),
            "denom_readout": bound(
                2 * entries * (kc + c),
                B4 * (4 * q * (geom.nseg + kc + 1 + c) + 4 * n) +
                rows * (isz * c + 4 * kc + 4 + 1))}
        run_singles = lambda fn, *a: [fn(*(per_video(x, b) for x in a))
                                      for b in range(B4)]
        # B4 launches a call: 3 calls a window keep the host's enqueueing
        # (up to ~0.13 ms a launch) inside the sleeping kernel's ~2.5 ms lead
        singles_ms = lambda fn: cuda_ms(fn, iters=3)
        t = {
            "sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk, ms, valid,
                                                    k)),
            "sim_topk_singles": singles_ms(lambda: run_singles(
                lambda *a: ak.sim_topk(*a, k), qk, qe, mk, ms, valid)),
            "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, v2)),
            "topk_readout_two_segments": cuda_ms(
                lambda: ak.topk_readout(gi, w, pair)),
            "topk_readout_singles": singles_ms(lambda: run_singles(
                ak.topk_readout, gi, w, v2)),
            "segmax": cuda_ms(lambda: apx.segmax(ops, geom)),
            "segmax_singles": singles_ms(lambda: run_singles(
                lambda x: apx.segmax(x, geom), ops)),
            "denom_readout": cuda_ms(lambda: apx.denom_readout(
                ops, geom, seg, v2, k)),
            "denom_readout_singles": singles_ms(lambda: run_singles(
                lambda x, s_, v: apx.denom_readout(x, geom, s_, v, k), ops,
                seg, v2)),
        }
        if n == 16712:  # the twins and yardsticks at the main shape
            t.update({
                "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
                    qk, qe, mk, ms, valid, k), iters=5),
                "sim_topk_product": cuda_ms(lambda: torch.bmm(
                    ops.qcat, ops.mcat.transpose(1, 2))),
                "topk_readout_plain": cuda_ms(
                    lambda: ak.topk_readout_plain(gi, w, v2), iters=5),
                "segmax_plain": cuda_ms(lambda: apx.segmax_plain(ops, geom),
                                        iters=5),
                "segmax_product": cuda_ms(lambda: torch.bmm(
                    ops.qcat, ops.mcat.transpose(1, 2))),
                "denom_readout_plain": cuda_ms(
                    lambda: apx._denom_readout_twin(ops, geom, seg, v2, k),
                    iters=5),
            })
            if ring == "float32":
                # the library call with topk_readout's function over all
                # the videos: one bag of k weighted rows per query, the
                # rings as one table
                flat_idx = (gi.long() + n * torch.arange(
                    B4, device=dev)[:, None, None]).reshape(B4 * q, k)
                table = v2.reshape(B4 * n, c)
                bag = torch.nn.functional.embedding_bag(
                    flat_idx, table, mode="sum",
                    per_sample_weights=w.reshape(B4 * q, k))
                torch.testing.assert_close(bag.reshape(B4, q, c), plain,
                                           rtol=1e-4, atol=1e-4)
                t["topk_readout_library"] = cuda_ms(
                    lambda: torch.nn.functional.embedding_bag(
                        flat_idx, table, mode="sum",
                        per_sample_weights=w.reshape(B4 * q, k)))
        times[n] = t
        print(f"phase 1b B={B4} {ring} rings N={n} per video (long-term "
              f"tokens {BATCH_LT_SIZES if n == 16712 else 'none'}): "
              "sim_topk, topk_readout (one and two segments) and segmax "
              "bitwise four single launches; denom_readout rmax, th bitwise, "
              "out and usage within 1e-5; err vs batched twins " +
              ", ".join(f"{name} {v:.3g}" for name, v in err.items()) +
              "; ms " + ", ".join(f"{name} {v:.4f}" for name, v in t.items())
              + "; bound ms " +
              ", ".join(f"{name} {b:.4f} ({by})"
                        for name, (b, by) in bounds[n].items()), flush=True)
    return {"err": err, "times": times, "bounds": bounds}


# --------------------------------------------------------------------------
# phase 2: the slice on the card against the slice on the CPU
# --------------------------------------------------------------------------

def synthetic_video(rng, h, w, t):
    """Smooth random frames: 8x8 blocks of one random image plus 0.1 noise
    per frame (tests/test_inference_parity.py:25-33)."""
    base = rng.standard_normal((-(-h // 8), -(-w // 8), 3)).astype(np.float32)
    frames = []
    for _ in range(t):
        img = base + 0.1 * rng.standard_normal(base.shape)
        frames.append(img.repeat(8, 0).repeat(8, 1)[:h, :w]
                      .astype(np.float32))
    return frames


def two_object_mask(h, w, rows1, cols1, rows2, cols2):
    mask = np.zeros((h, w), np.int64)
    mask[slice(*rows1), slice(*cols1)] = 1
    mask[slice(*rows2), slice(*cols2)] = 2
    return mask


def composed_frames(ak, cpu_core, gpu_core, frames, rows, cols,
                    label: str, tol: float = 5e-3):
    """A third object appears mid-stream: its mask frame and the next frame
    take the composed path (MemoryEngine.match_memory; the next frame over
    two buckets) on the card, against the CPU within tol. Returns a
    summary and, per match_memory call, the kernel launches made inside
    it."""
    h, w = frames[0].shape[:2]
    mask = np.zeros((h, w), np.int64)
    mask[slice(*rows), slice(*cols)] = 3
    real = gpu_core.memory.match_memory
    calls = []

    def counted(*args):
        before = dict(ak.LAUNCHES)
        out = real(*args)
        assert out.device == gpu_core.device, "match_memory ran elsewhere"
        calls.append({k: ak.LAUNCHES[k] - before[k] for k in before})
        return out

    gpu_core.memory.match_memory = counted
    worst = 0.0
    for i, img in enumerate(frames):
        args = (mask, [3]) if i == 0 else ()
        ran = len(calls)
        p_cpu = cpu_core.step(img, *args)
        p_gpu = gpu_core.step(img, *args).cpu()
        assert len(calls) > ran, f"{label} frame {i}: no composed path"
        assert p_gpu.shape == p_cpu.shape == (4, h, w), p_gpu.shape
        diff = (p_gpu - p_cpu).abs().max().item()
        worst = max(worst, diff)
        assert diff <= tol, f"{label} composed frame {i}: |card - cpu| = " \
            f"{diff}"
    assert len(gpu_core.memory.buckets) == 2
    return (f"new object: {len(calls)} match_memory calls on the card over "
            f"its mask frame and the next, max |dprob| {worst:.3g}; launches "
            f"inside them {calls}"), calls


def phase_slice_parity(ak, net_cpu, dev, ring_dtype="float32",
                       tol: float = 5e-3):
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    cfg = InferenceConfig(mem_every=2, top_k=8, enable_long_term=True,
                          enable_long_term_count_usage=True,
                          max_mid_term_frames=3, min_mid_term_frames=1,
                          num_prototypes=16, max_long_term_elements=96,
                          ring_dtype=ring_dtype)
    frames = synthetic_video(np.random.default_rng(7), 64, 96, 10)
    mask = two_object_mask(64, 96, (8, 28), (10, 40), (36, 60), (50, 90))
    net_gpu = copy.deepcopy(net_cpu).to(dev)
    cpu_core = InferenceCore(net_cpu, cfg)
    gpu_core = InferenceCore(net_gpu, cfg)
    ak.reset_launch_counts()
    worst = 0.0
    p_cpu = []
    for ti, img in enumerate(frames[:8]):
        args = (mask, [1, 2]) if ti == 0 else ()
        p_cpu.append(cpu_core.step(img, *args))
        p_gpu = gpu_core.step(img, *args).cpu()
        assert p_gpu.shape == p_cpu[-1].shape == (3, 64, 96)
        diff = (p_gpu - p_cpu[-1]).abs().max().item()
        worst = max(worst, diff)
        assert diff <= tol, f"frame {ti}: |card - cpu| = {diff}"
    launches = dict(ak.LAUNCHES)
    # the same frames through step_chunk on the card (a memory period per
    # call of the fused block body)
    chunk_core = InferenceCore(net_gpu, cfg)
    p_chunk = [chunk_core.step(frames[0], mask, [1, 2])]
    p_chunk += chunk_core.step_chunk(frames[1:8])
    worst_chunk = max((g.cpu() - c).abs().max().item()
                      for g, c in zip(p_chunk, p_cpu))
    assert worst_chunk <= tol, f"step_chunk: |card - cpu| = {worst_chunk}"
    assert launches["sim_topk"] > 0 and launches["topk_readout"] > 0, \
        launches
    lt = gpu_core.memory.long_buckets.get(0)
    assert lt is not None and lt.size > 0, "long-term memory never engaged"
    assert lt.key.dtype == getattr(torch, ring_dtype)
    composed, calls = composed_frames(ak, cpu_core, gpu_core, frames[8:],
                                      (4, 20), (60, 88), "exact", tol)
    assert all(c["sim_topk"] > 0 and c["topk_readout"] > 0
               for c in calls), f"exact kernels not in match_memory: {calls}"
    print(f"phase 2 exact{dtype_label(net_cpu, ring_dtype)}: card vs cpu "
          f"slice max |dprob| step {worst:.3g}, step_chunk "
          f"{worst_chunk:.3g} over 8 frames (bound {tol:g}); launches "
          f"{launches}; long-term tokens {lt.size}; {composed}", flush=True)


def phase_slice_parity_approx(ak, apx, net_cpu, dev, ring_dtype="float32",
                              tol: float = 5e-3):
    """The approx slice, card against CPU, through step and step_chunk:
    128x192 frames (96 tokens), a memory frame every frame and long-term
    memory consolidating at 7 frames, so the [long-term ; working] ring
    holds 64 + 672 tokens: groups of 4."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    h, w = 128, 192
    cfg = InferenceConfig(mem_every=1, top_k=30, enable_long_term=True,
                          enable_long_term_count_usage=True,
                          max_mid_term_frames=7, min_mid_term_frames=2,
                          num_prototypes=16, max_long_term_elements=96,
                          topk_method="approx", ring_dtype=ring_dtype)
    frames = synthetic_video(np.random.default_rng(21), h, w, 12)
    mask = two_object_mask(h, w, (16, 56), (20, 80), (72, 120), (100, 180))
    net_gpu = copy.deepcopy(net_cpu).to(dev)
    cpu_core = InferenceCore(net_cpu, cfg)
    p_cpu = [cpu_core.step(frames[0], mask, [1, 2])]
    p_cpu += [cpu_core.step(f) for f in frames[1:10]]
    ak.reset_launch_counts()
    step_core = InferenceCore(net_gpu, cfg)
    p_step = [step_core.step(frames[0], mask, [1, 2])]
    p_step += [step_core.step(f) for f in frames[1:10]]
    chunk_core = InferenceCore(net_gpu, cfg)
    p_chunk = [chunk_core.step(frames[0], mask, [1, 2])]
    p_chunk += chunk_core.step_chunk(frames[1:10])
    launches = dict(ak.LAUNCHES)
    worst = {}
    for name, probs in (("step", p_step), ("step_chunk", p_chunk)):
        diff = max((g.cpu() - c).abs().max().item()
                   for g, c in zip(probs, p_cpu))
        assert diff <= tol, f"approx {name}: |card - cpu| = {diff}"
        worst[name] = diff
    assert launches["segmax"] >= 18 and launches["denom_readout"] >= 18, \
        launches
    for core in (step_core, chunk_core):
        lt, work = core.memory.long_buckets[0], core.memory.buckets[0]
        geom = apx.Geometry.of(lt.cap + work.cap, apx.default_n_tile(
            work.value.shape[1] * work.value.shape[2],
            work.value.element_size()))
        # groups of 4 on f32 rings (512-token tiles); bf16 rings take
        # deva_tpu's 1024-token tiles, one tile of 768 here: groups of 2
        assert lt.size > 0 and geom.group > 1, (lt.cap, work.cap, geom)
    composed, calls = composed_frames(ak, cpu_core, step_core, frames[10:],
                                      (8, 48), (110, 180), "approx", tol)
    # the composed path takes the dense threshold form, as deva_tpu does
    assert not any(any(c.values()) for c in calls), calls
    print(f"phase 2 approx{dtype_label(net_cpu, ring_dtype)}: card vs cpu "
          f"slice max |dprob| step "
          f"{worst['step']:.3g}, step_chunk {worst['step_chunk']:.3g} over "
          f"10 frames of {h}x{w} (bound {tol:g}); [long-term ; working] ring "
          f"{lt.cap}+{work.cap} tokens in groups of {geom.group}; launches "
          f"{launches}; {composed}", flush=True)


def batched_slice_videos(h, w, t, seeds):
    """Phase 2b's videos: phase 2's clip (the first seed) and others, the
    second of them with one object. Returns (frames [B, t, h, w, 3] numpy,
    masks, objects)."""
    frames, masks, objects = [], [], []
    for i, seed in enumerate(seeds):
        frames.append(np.stack(synthetic_video(np.random.default_rng(seed),
                                               h, w, t)))
        mask = two_object_mask(h, w, (h // 8, h * 7 // 16),
                               (w // 10, w * 5 // 12), (h * 9 // 16,
                                                        h * 15 // 16),
                               (w * 25 // 48, w * 15 // 16))
        if i == 1:
            mask[mask == 2] = 0
        masks.append(mask)
        objects.append([1] if i == 1 else [1, 2])
    return np.stack(frames), masks, objects


def phase_batched_slice(ak, net_cpu, dev, ring_dtype="float32",
                        tol: float = 5e-3):
    """Phase 2b: the batched slice (inference/batched.py) on the card
    against the same batched slice on the CPU, long-term memory on, for
    both methods: exact on three videos of 64x96 (phase 2's clip and two
    more, one with a single object) through step_all, and through step_block
    by 2 on the card; approx on two videos of 128x192 through step_all,
    with a [long-term ; working] ring in groups of tokens. Probabilities
    within tol; one launch of each kernel of the method per lockstep step;
    ring and long-term sizes equal on both devices."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched import BatchedPropagator
    net_gpu = copy.deepcopy(net_cpu).to(dev)
    cases = (
        ("exact", 64, 96, 9, (7, 8, 9), dict(
            mem_every=2, top_k=8, max_mid_term_frames=3,
            min_mid_term_frames=1, num_prototypes=16,
            max_long_term_elements=96)),
        ("approx", 128, 192, 10, (21, 22), dict(
            mem_every=1, top_k=30, max_mid_term_frames=7,
            min_mid_term_frames=2, num_prototypes=16,
            max_long_term_elements=96)))
    for method, h, w, t, seeds, kw in cases:
        cfg = InferenceConfig(enable_long_term=True,
                              enable_long_term_count_usage=True,
                              topk_method=method, ring_dtype=ring_dtype, **kw)
        frames, masks, objects = batched_slice_videos(h, w, t, seeds)
        runs = {}
        for name, net, device in (("cpu", net_cpu, "cpu"),
                                  ("card", net_gpu, dev)):
            bp = BatchedPropagator(net, cfg)
            bp.initialize(frames[:, 0], masks, objects)
            ak.reset_launch_counts()
            probs = [bp.step_all(frames[:, ti]).cpu() for ti in range(1, t)]
            runs[name] = (bp, probs, dict(ak.LAUNCHES))
        cpu_bp, p_cpu, _ = runs["cpu"]
        card_bp, p_card, launches = runs["card"]
        worst = max((a - b).abs().max().item() for a, b in zip(p_card, p_cpu))
        assert worst <= tol, f"batched {method}: |card - cpu| = {worst}"
        pair = ("sim_topk", "topk_readout") if method == "exact" else \
            ("segmax", "denom_readout")
        assert all(launches[k] == t - 1 for k in pair) and \
            sum(launches.values()) == 2 * (t - 1), launches
        assert np.array_equal(card_bp.sizes, cpu_bp.sizes) and \
            np.array_equal(card_bp.lt_sizes, cpu_bp.lt_sizes)
        assert card_bp._lt_engaged, "long-term memory never engaged"
        note = ""
        if method == "exact":
            # the same frames through step_block by 2 (a memory period per
            # block) on the card
            blk = BatchedPropagator(net_gpu, cfg)
            blk.initialize(frames[:, 0], masks, objects)
            p_blk = []
            for t0 in range(1, t, 2):
                p_blk += list(blk.step_block(frames[:, t0:t0 + 2])
                              .cpu().unbind(1))
            worst_blk = max((a - b).abs().max().item()
                            for a, b in zip(p_blk, p_cpu))
            assert worst_blk <= tol, f"step_block: |card - cpu| {worst_blk}"
            assert np.array_equal(blk.lt_sizes, cpu_bp.lt_sizes)
            note = f", step_block by 2 {worst_blk:.3g}"
        print(f"phase 2b batched {method}{dtype_label(net_cpu, ring_dtype)}: "
              f"B={len(seeds)} videos of {h}x{w}, card vs cpu max |dprob| "
              f"step_all {worst:.3g}{note} over {t - 1} lockstep frames "
              f"(bound {tol:g}); launches {launches}; long-term tokens "
              f"{card_bp.lt_sizes.tolist()}", flush=True)


# --------------------------------------------------------------------------
# phase 3: the 480p main path
# --------------------------------------------------------------------------

def main_path_setup(net_cpu, dev, n_frames):
    # earlier phases leave reference cycles (a core whose match_memory
    # was wrapped) that hold device memory until a collection: collect
    # them, so that a run's peak counts its own memory only
    gc.collect()
    frames = synthetic_video(np.random.default_rng(11), H480, W480,
                             n_frames)
    # a rider above a bike, as in bmx-trees
    mask = two_object_mask(H480, W480, (60, 300), (330, 520), (260, 450),
                           (250, 620))
    frames = [torch.from_numpy(f).to(dev) for f in frames]  # set-up
    return frames, mask, copy.deepcopy(net_cpu).to(dev)


def check_prob(prob, ti):
    assert prob.shape == (3, H480, W480), tuple(prob.shape)
    assert bool(torch.isfinite(prob).all()), f"frame {ti}: non-finite"
    torch.testing.assert_close(prob.sum(0), torch.ones_like(prob[0]),
                               rtol=0, atol=1e-4)


def dtype_label(net, ring_dtype: str) -> str:
    """', bf16 compute, bf16 rings' and the like; '' for all-f32."""
    compute = net.config.compute_dtype
    if compute == torch.float32 and ring_dtype == "float32":
        return ""
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    return (f", {short[compute]} compute, "
            f"{short[getattr(torch, ring_dtype)]} rings")


def with_dtype(net, dtype: str):
    """The same weights in a DEVANetwork of another compute dtype."""
    import dataclasses
    from deva_tpu_torch.models.network import DEVANetwork
    out = DEVANetwork(dataclasses.replace(net.config, dtype=dtype)).eval()
    out.load_state_dict(net.state_dict())
    return out


def check_device() -> torch.device:
    """Where the phases compare kept probability maps: the card where there
    is one (the host takes ~0.2 s a 480p frame for an argmax, a top-2 and a
    difference, which made the comparisons of phases 3-5 and 7c cost about
    200 s; on the card the same f32 arithmetic gives the same verdicts),
    else the CPU (a rehearsal)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def compare_dtypes(f32_probs, bf16_probs, label: str):
    """The bf16 480p run against the f32 run of the same frames and weights
    on the card, with tests/test_amp.py's whole-clip budget per frame:
    mean |dprob| < 0.03, argmax flips at confident pixels (f32 margin
    > 0.25) under 2%, and none where the f32 margin exceeds 0.6."""
    worst_mean = worst_conf = worst_margin = 0.0
    cd = check_device()
    for ti, (pe, pa) in enumerate(zip(f32_probs, bf16_probs)):
        pe, pa = pe.to(cd), pa.to(cd)
        mean = (pa - pe).abs().mean().item()
        flips = pa.argmax(0) != pe.argmax(0)
        top2 = pe.topk(2, dim=0).values
        margin = top2[0] - top2[1]
        conf = (flips & (margin > 0.25)).float().mean().item()
        flipped = margin[flips].max().item() if bool(flips.any()) else 0.0
        assert mean < 0.03, f"{label} frame {ti}: mean |dprob| {mean}"
        assert conf < 0.02, f"{label} frame {ti}: confident flips {conf}"
        assert flipped <= 0.6, f"{label} frame {ti}: flip at margin " \
            f"{flipped}"
        worst_mean = max(worst_mean, mean)
        worst_conf = max(worst_conf, conf)
        worst_margin = max(worst_margin, flipped)
    print(f"{label} vs the f32 run: per-frame mean |dprob| at most "
          f"{worst_mean:.4g} (budget 0.03), confident-pixel flips at most "
          f"{worst_conf:.3%} (budget 2%), largest flipped f32 margin "
          f"{worst_margin:.3g} (budget 0.6), over {len(f32_probs)} frames",
          flush=True)


def report_main_path(label, core, step_ms, launches, dev, n_frames):
    lt = core.memory.long_buckets.get(0)
    assert lt is not None and lt.size > 0, "long-term memory never engaged"
    work = core.memory.buckets[0]
    steady = step_ms[10:]
    med = statistics.median(steady)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: {n_frames} frames, 2 objects: launches {launches}; "
          f"long-term tokens {lt.size}/{lt.cap}, working tokens "
          f"{work.size}/{work.cap}", flush=True)
    print(f"{label}: ms/frame median {med:.3f} (frames 10-{n_frames-1};"
          f" mean {statistics.mean(steady):.3f}, min {min(steady):.3f}, max "
          f"{max(steady):.3f}); FPS {1000 / med:.2f}; first frame "
          f"{step_ms[0]:.1f} ms; peak allocated {peak / 2**20:.1f} MiB",
          flush=True)
    return {"median_ms": med, "peak_mib": peak / 2**20}


def phase_main_path(ak, net_cpu, dev, n_frames: int = 60,
                    ring_dtype: str = "float32"):
    """Phase 3: exact top-k through step (the fused step) at 480p. Returns
    the launch counts, the probabilities (on the host) and the run's median
    ms/frame and peak memory."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    frames, mask, net = main_path_setup(net_cpu, dev, n_frames)
    core = InferenceCore(net, InferenceConfig(ring_dtype=ring_dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the readout's indices on one steady-state frame, for the rows its
    # tiles share on real data
    real_readout, seen = ak.topk_readout, []

    def keep_indices(indices, weights, values):
        seen.append((indices.clone(), values))
        return real_readout(indices, weights, values)

    ak.reset_launch_counts()
    step_ms, out = [], []
    for ti, img in enumerate(frames):
        args = (mask, [1, 2]) if ti == 0 else ()
        ak.topk_readout = keep_indices if ti == n_frames - 10 else \
            real_readout
        t0 = time.perf_counter()
        try:
            prob = core.step(img, *args, end=(ti == n_frames - 1))
        finally:
            ak.topk_readout = real_readout
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1000)
        check_prob(prob, ti)
        out.append(prob.cpu())  # kept on the host, out of the peak memory
    launches = dict(ak.LAUNCHES)
    assert len(seen) == 1 and isinstance(seen[0][1], tuple), \
        f"frame {n_frames - 10} did not read the [long-term ; working] " \
        "pair once"
    gi, (v_lt, v_work) = seen[0]
    label = "phase 3 exact, step" + dtype_label(net, ring_dtype)
    print(rows_line(f"{label}, frame {n_frames - 10} (ring "
                    f"{v_lt.shape[0]} + {v_work.shape[0]})", gi,
                    v_lt.shape[1]), flush=True)

    propagated = n_frames - 1
    assert launches["sim_topk"] >= propagated and \
        launches["topk_readout"] >= propagated, launches
    return launches, out, report_main_path(label, core, step_ms, launches,
                                           dev, n_frames)


def phase_main_path_approx(ak, net_cpu, dev, n_frames: int = 60,
                           chunk: int = 5, preencode: bool = False,
                           ring_dtype: str = "float32"):
    """Phase 4: approx top-k at 480p, the first frame through step and the
    rest through step_chunk in chunks of `chunk` (the last one ending the
    video), as eval_vos_torch.py --chunk buffers them. A chunk's time is
    shared equally by its frames. preencode: the pre-encoded block body
    (InferenceConfig.preencode_blocks), one attention per block. Returns
    the launch counts, the probabilities and the run's median ms/frame and
    peak memory."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    frames, mask, net = main_path_setup(net_cpu, dev, n_frames)
    core = InferenceCore(net, InferenceConfig(topk_method="approx",
                                              preencode_blocks=preencode,
                                              ring_dtype=ring_dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ak.reset_launch_counts()
    t0 = time.perf_counter()
    prob = core.step(frames[0], mask, [1, 2])
    torch.cuda.synchronize()
    step_ms = [(time.perf_counter() - t0) * 1000]
    check_prob(prob, 0)
    out = [prob.cpu()]  # kept on the host, out of the peak device memory
    for start in range(1, n_frames, chunk):
        block = frames[start:start + chunk]
        t0 = time.perf_counter()
        probs = core.step_chunk(block,
                                end=start + len(block) == n_frames)
        torch.cuda.synchronize()
        step_ms += [(time.perf_counter() - t0) * 1000 / len(block)] * \
            len(block)
        assert len(probs) == len(block)
        for i, prob in enumerate(probs):
            check_prob(prob, start + i)
        out += [prob.cpu() for prob in probs]
    launches = dict(ak.LAUNCHES)

    # per frame, or (pre-encoded) per block and the end frame
    calls = -(-(n_frames - 1) // chunk) + 1 if preencode else n_frames - 1
    assert launches["segmax"] >= calls and \
        launches["denom_readout"] >= calls, launches
    body = ", pre-encoded blocks" if preencode else ""
    return launches, out, report_main_path(
        f"phase 4 approx, step_chunk by {chunk}{body}"
        f"{dtype_label(net, ring_dtype)}", core, step_ms, launches, dev,
        n_frames)


def compare_preencoded(per_frame, preencoded):
    """The pre-encoded block body against the per-frame one at 480p, with
    the budget of tests/test_step_chunk.py for it: batched convolutions
    round differently, so per frame at most 2% of the pixels may move by
    more than 5e-3 and at most 2% may change their argmax."""
    worst = moved = flips = 0.0
    cd = check_device()
    for ti, (a, b) in enumerate(zip(per_frame, preencoded)):
        a, b = a.to(cd), b.to(cd)
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        m = (diff > 5e-3).any(0).float().mean().item()
        f = (a.argmax(0) != b.argmax(0)).float().mean().item()
        assert m <= 0.02 and f <= 0.02, (ti, m, f)
        moved, flips = max(moved, m), max(flips, f)
    print(f"phase 4 pre-encoded vs per-frame body: max |dprob| {worst:.3g}, "
          f"pixels moved > 5e-3 at most {moved:.2%}, argmax changed at most "
          f"{flips:.2%} of a frame (budget 2%)", flush=True)


# --------------------------------------------------------------------------
# phase 5: B4 videos at 480p in lockstep
# --------------------------------------------------------------------------

# phase 5's videos: video 0 is phases 3 and 4's clip (seed 11, its mask),
# the others have their own seeds and boxes, and video 1 one object
PHASE5_SEEDS = (11, 12, 13, 14)
PHASE5_BOXES = (((60, 300), (330, 520), (260, 450), (250, 620)),
                ((100, 380), (200, 500), (0, 0), (0, 0)),
                ((40, 240), (100, 400), (250, 470), (450, 800)),
                ((150, 420), (500, 820), (20, 140), (30, 300)))


def batched_main_setup(dev, n_frames):
    """Phase 5's frames [B4, T, H, W, 3] on the card (set-up), masks and
    objects."""
    gc.collect()
    frames = torch.stack([
        torch.from_numpy(np.stack(synthetic_video(
            np.random.default_rng(seed), H480, W480, n_frames)))
        for seed in PHASE5_SEEDS]).to(dev)
    masks = [two_object_mask(H480, W480, *boxes) for boxes in PHASE5_BOXES]
    objects = [[int(o) for o in np.unique(m) if o] for m in masks]
    return frames, masks, objects


def single_stream(net, frames, mask, objects, method: str):
    """One video through InferenceCore at the default InferenceConfig, as
    phases 3 (exact, step) and 4 (approx, step_chunk by 5) drive it. Returns
    the propagated frames' probabilities on the host."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    core = InferenceCore(net, InferenceConfig(topk_method=method))
    core.step(frames[0], mask, objects)
    n = frames.shape[0]
    if method == "exact":
        return [core.step(frames[t], end=t == n - 1).cpu()
                for t in range(1, n)]
    out = []
    for start in range(1, n, 5):
        block = list(frames[start:start + 5])
        out += [p.cpu() for p in core.step_chunk(
            block, end=start + len(block) == n)]
    return out


def batched_run(ak, net, frames, masks, objects, dev, method: str,
                chunk: int, ring_dtype: str):
    """The B4 videos through BatchedPropagator at the default
    InferenceConfig (long-term memory on): step_all per lockstep frame
    (chunk 1) or step_block by `chunk`. Returns the launch counts of the
    run, each video's propagated probabilities (on the host, live channels)
    and the per-frame wall ms (a block's time shared by its frames)."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched import BatchedPropagator
    bp = BatchedPropagator(net, InferenceConfig(topk_method=method,
                                                ring_dtype=ring_dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ak.reset_launch_counts()
    bp.initialize(frames[:, 0], masks, objects)
    n = frames.shape[1]
    step_ms, out = [], [[] for _ in objects]
    t = 1
    while t < n:
        k = min(chunk, n - t)
        t0 = time.perf_counter()
        if chunk == 1:
            probs = bp.step_all(frames[:, t], end=t == n - 1)[:, None]
        else:
            probs = bp.step_block(frames[:, t:t + k], end=t + k == n)
        torch.cuda.synchronize()
        step_ms += [(time.perf_counter() - t0) * 1000 / k] * k
        assert probs.shape == (B4, k, 1 + bp.o_cap, H480, W480)
        assert bool(torch.isfinite(probs).all()), f"frame {t}: non-finite"
        torch.testing.assert_close(probs.sum(2), torch.ones_like(
            probs[:, :, 0]), rtol=0, atol=1e-4)
        for b, objs in enumerate(objects):  # on the host, out of the peak
            out[b] += list(probs[b, :, :len(objs) + 1].cpu().unbind(0))
        t += k
    launches = dict(ak.LAUNCHES)
    assert bp._lt_engaged, "long-term memory never engaged"
    return launches, out, step_ms, bp


def compare_single(batched, single, label: str) -> str:
    """A video's batched run against its single-stream run, with
    tests/test_batched.py's budgets per frame: at most 2% of the pixels
    off by more than 5e-3, at most 2% argmax flips (batch-4 convolutions
    round differently from batch-1 ones)."""
    worst = moved = flips = 0.0
    assert len(batched) == len(single)
    cd = check_device()
    for ti, (g, w) in enumerate(zip(batched, single), start=1):
        assert g.shape == w.shape, (label, ti, g.shape, w.shape)
        g, w = g.to(cd), w.to(cd)
        diff = (g - w).abs()
        m = (diff > 5e-3).any(0).float().mean().item()
        f = (g.argmax(0) != w.argmax(0)).float().mean().item()
        assert m <= 0.02 and f <= 0.02, (label, ti, m, f)
        worst = max(worst, diff.max().item())
        moved, flips = max(moved, m), max(flips, f)
    return f"{label} max |dprob| {worst:.3g}, moved {moved:.2%}, argmax " \
        f"{flips:.2%}"


def phase_batched_main(ak, net_cpu, net_cpu16, dev, single_runs,
                       n_frames: int = 60) -> dict:
    """Phase 5: B4 synthetic 480p videos in lockstep, long-term memory on,
    at full width: f32 exact through step_all, f32 approx through
    step_block by 5, bf16 approx through step_block by 5. Each kernel of
    the method launches once per lockstep frame (59 for 59 frames, not
    4 x 59); each video meets tests/test_batched.py's budgets against its
    own single-stream run (video 0: phases 3 and 4, `single_runs`
    {method: (probabilities, stats)}); the bf16 run meets
    tests/test_amp.py's whole-clip budget against the f32 run. Prints the
    median ms per lockstep step, the aggregate video-frames/s and the peak
    memory beside the single-stream figures of this call. Returns each
    run's launch counts."""
    frames, masks, objects = batched_main_setup(dev, n_frames)
    frame_mib = frames.numel() * 4 / 2**20
    launches, probs = {}, {}
    for key, method, chunk, ring in (
            ("exact", "exact", 1, "float32"),
            ("approx", "approx", 5, "float32"),
            ("approx.bf16", "approx", 5, "bfloat16")):
        # one model on the card at a time, so a run's peak holds its own
        model = copy.deepcopy(net_cpu if ring == "float32" else net_cpu16) \
            .to(dev)
        runs, out, step_ms, bp = batched_run(ak, model, frames, masks,
                                             objects, dev, method, chunk,
                                             ring)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        pair = EXACT_PAIR if method == "exact" else \
            tuple(k for k in KERNELS if k not in EXACT_PAIR)
        assert all(runs[k] == n_frames - 1 for k in pair) and \
            sum(runs.values()) == 2 * (n_frames - 1), \
            f"phase 5 {key}: not one launch per lockstep frame: {runs}"
        launches[key], probs[key] = runs, out
        steady = step_ms[9:]  # frames 10 onwards
        med = statistics.median(steady)
        how = "step_all" if chunk == 1 else f"step_block by {chunk}"
        label = f"phase 5 {method}, {how}{dtype_label(model, ring)}"
        counts = "/".join(str(len(objs)) for objs in objects)
        print(f"{label}: B={B4} videos ({counts} objects), {n_frames} "
              f"frames: launches {runs}; long-term "
              f"tokens {bp.lt_sizes.tolist()}, working {bp.sizes.tolist()}",
              flush=True)
        line = (f"{label}: median {med:.3f} ms per lockstep step (frames "
                f"10-{n_frames - 1}; mean {statistics.mean(steady):.3f}, min "
                f"{min(steady):.3f}, max {max(steady):.3f}), aggregate "
                f"{B4 * 1000 / med:.2f} video-frames/s; peak allocated "
                f"{peak:.1f} MiB ({frame_mib:.1f} of it the {B4} videos' "
                f"input frames)")
        if ring == "float32":
            single = single_runs[method][1]
            line += (f"; single stream in this call (phase "
                     f"{3 if method == 'exact' else 4}): "
                     f"{single['median_ms']:.3f} ms/frame, "
                     f"{1000 / single['median_ms']:.2f} frames/s, peak "
                     f"{single['peak_mib']:.1f} MiB ({frame_mib / B4:.1f} of "
                     f"it input frames): aggregate x"
                     f"{B4 * single['median_ms'] / med:.2f}")
        print(line, flush=True)
        del bp, model
        gc.collect()
    # each video against its own single-stream run
    net = copy.deepcopy(net_cpu).to(dev)
    for method in ("exact", "approx"):
        notes = [compare_single(probs[method][0], single_runs[method][0][1:],
                                "video 0")]
        for b in range(1, B4):
            single = single_stream(net, frames[b], masks[b], objects[b],
                                   method)
            notes.append(compare_single(probs[method][b], single,
                                        f"video {b}"))
        print(f"phase 5 {method} batched vs single stream "
              f"(tests/test_batched.py's budgets: moved > 5e-3 <= 2%, "
              f"argmax <= 2%): " + "; ".join(notes), flush=True)
    compare_dtypes([p for v in probs["approx"] for p in v],
                   [p for v in probs["approx.bf16"] for p in v],
                   "phase 5 approx, bf16")
    return launches


# --------------------------------------------------------------------------
# phase 6: detection fusion
# --------------------------------------------------------------------------

# phase 6's tolerance, card against CPU (phase 2's)
DET_TOL = 5e-3
# the share of a detection frame (or a consensus mask) whose painted ids may
# differ, card against CPU, because the two runs' forward predictions (or
# projections), each within DET_TOL of the other, have another argmax
# there. With random weights the objects that the unmatched detections add
# are near copies of one another, whose probabilities tie to ~1e-5, and
# cuDNN's convolutions (FFT and implicit GEMM, TF32 off) sum in other
# orders than the CPU's: the H100 flipped 3.66% of 6a's online frame 6
# (nine objects), and 0.2% with cuDNN turned off. The CPU tests hold the
# port to deva_tpu at 2% (tests/torch_detection_common.py:MAX_FLIP_SHARE).
DET_FLIP_SHARE = 0.05


def det_core_pair(net_cpu, dev, cfg):
    """A CPU core and a card core on the same weights with equal seeded
    object-id generators."""
    from deva_tpu_torch.inference.core import InferenceCore
    cpu = InferenceCore(net_cpu, cfg)
    gpu = InferenceCore(copy.deepcopy(net_cpu).to(dev), cfg)
    for core in (cpu, gpu):
        core.object_manager._rng = np.random.default_rng(5)
    return cpu, gpu


def det_step_pair(cpu, gpu, image, worst, key, label, end=False):
    """One propagated frame on both cores, within DET_TOL."""
    diff = (gpu.step(image, end=end).cpu() -
            cpu.step(image, end=end)).abs().max().item()
    worst[key] = max(worst.get(key, 0.0), diff)
    assert diff <= DET_TOL, f"{label}: |card - cpu| = {diff}"


def det_incorporate_pair(cpu, gpu, images, masks, segments, perfect, worst,
                         key, label, given=None):
    """incorporate_detection on both cores (images, masks, segments: the
    CPU's and the card's). perfect: pass detection_clips.perfect_forward
    as forward_mask=. Otherwise the two forward predictions must agree
    within DET_TOL, and the probabilities may differ beyond it only where
    those predictions' argmaxes differ or `given` (pixels whose detection
    masks differ) is set, on at most DET_FLIP_SHARE of the frame. -> that
    share."""
    from deva_tpu_torch import detection_clips as dc
    out = []
    for core, image, mask, segs in zip((cpu, gpu), images, masks, segments):
        kw = {"forward_mask": dc.perfect_forward(core, mask)} if perfect \
            else {}
        out.append(dc.incorporate_seen(core, image, mask, segs, **kw))
    (l_cpu, f_cpu), (l_gpu, f_gpu) = out
    allowed = given
    if f_cpu is not None:
        diff = float(np.abs(f_gpu - f_cpu).max())
        worst[key + " forward"] = max(worst.get(key + " forward", 0.0), diff)
        assert diff <= DET_TOL, f"{label}: forward |card - cpu| = {diff}"
        flips = dc.paint_flips(f_cpu, f_gpu)
        allowed = flips if given is None else flips | given
    _, share = dc.check_detection_frame(
        torch.softmax(l_cpu, 0), torch.softmax(l_gpu, 0), allowed, DET_TOL,
        DET_FLIP_SHARE, label)
    assert dc.object_table(gpu) == dc.object_table(cpu), label
    return share


def det_online_pair(cpu, gpu, clip, perfect, worst, key):
    """The online setting on both cores (a detection every other frame):
    frames within DET_TOL, detection frames by det_incorporate_pair, equal
    object tables; segment 4 purged and equal buckets at the end. -> the
    detection frames' shares."""
    from deva_tpu_torch import detection_clips as dc
    frames, masks, infos = clip
    shares = []
    for ti, img in enumerate(frames):
        label = f"phase 6a {key} frame {ti}"
        if ti % 2:
            det_step_pair(cpu, gpu, img, worst, key, label)
            continue
        segs = [dc.segment_infos(infos[ti]) for _ in range(2)]
        shares.append(det_incorporate_pair(
            cpu, gpu, (img, img), (masks[ti], masks[ti]), segs, perfect,
            worst, key, label))
    ids = [row[0] for row in dc.object_table(gpu)]
    assert 4 not in ids, f"{key}: segment 4 was not purged: {ids}"
    assert [b.obj_ids for b in gpu.memory.buckets.values()] == \
        [b.obj_ids for b in cpu.memory.buckets.values()], key
    return shares


def vote_recorded(core, precomputed_proj=None):
    """core.vote_in_temporary_buffer(keyframe_selection='first') -> (its
    result, the projections its spatial alignments returned)."""
    out = []
    align = core.spatial_alignment

    def spy(*args):
        out.append(align(*args))
        return out[-1]

    core.spatial_alignment = spy
    try:
        return core.vote_in_temporary_buffer(
            keyframe_selection="first",
            precomputed_proj=precomputed_proj), out
    finally:
        del core.spatial_alignment


def det_semionline_pair(cpu, gpu, clip, perfect, worst, key):
    """The semi-online setting on both cores (3 voting frames, a vote every
    3). perfect: vote with detection_clips.aligned_proj (no alignment runs:
    the consensus masks must be equal) and incorporate with
    perfect_forward. Otherwise the vote's alignments within DET_TOL, and
    the consensus masks may differ only where two projections' argmaxes
    differ, on at most DET_FLIP_SHARE of the frame. Selections equal,
    frames within DET_TOL, detection frames by det_incorporate_pair, equal
    object tables. -> (selected ids per vote, shares)."""
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.inference.frame_utils import FrameInfo
    frames, masks, infos = clip
    n = len(frames)
    votes, shares = [], []
    next_voting, num_voting, every = 2, 3, 3
    for ti, img in enumerate(frames):
        label = f"phase 6a {key} frame {ti}"
        if ti + num_voting <= next_voting:
            det_step_pair(cpu, gpu, img, worst, key, label, end=ti == n - 1)
            continue
        info = {"frame": f"{ti:05d}.jpg", "shape": img.shape[:2],
                "save": True}
        for core in (cpu, gpu):
            core.add_to_temporary_buffer(FrameInfo(
                img, masks[ti], dc.segment_infos(infos[ti]), ti, info))
        if ti != next_voting:
            continue
        res = [vote_recorded(core, dc.aligned_proj(core.frame_buffer)
                             if perfect else None) for core in (cpu, gpu)]
        ((_, m_cpu, s_cpu), proj_cpu), ((_, m_gpu, s_gpu), proj_gpu) = res
        votes.append([o.id for o in s_gpu])
        assert votes[-1] == [o.id for o in s_cpu], (
            f"{label}: selected {votes[-1]} on the card, "
            f"{[o.id for o in s_cpu]} on the cpu")
        flips = np.zeros(m_cpu.shape, bool)
        for p_c, p_g in zip(proj_cpu, proj_gpu):
            diff = float(np.abs(p_g - p_c).max())
            worst[key + " alignment"] = max(
                worst.get(key + " alignment", 0.0), diff)
            assert diff <= DET_TOL, f"{label}: alignment {diff}"
            flips |= dc.paint_flips(p_c, p_g)
        differ = m_cpu != m_gpu
        assert not (differ & ~flips).any() and \
            flips.mean() <= DET_FLIP_SHARE, (
                f"{label}: consensus masks differ on {int(differ.sum())} "
                f"pixels, {int((differ & ~flips).sum())} where the "
                f"projections paint alike; those differ on "
                f"{flips.mean():.2%}")
        shares.append(float(flips.mean()))
        shares.append(det_incorporate_pair(
            cpu, gpu, (cpu.frame_buffer[0].image, gpu.frame_buffer[0].image),
            (m_cpu, m_gpu), (s_cpu, s_gpu), perfect, worst, key,
            f"{label} (vote)", given=differ if differ.any() else None))
        for fc, fg in zip(cpu.frame_buffer[1:], gpu.frame_buffer[1:]):
            diff = (gpu.step(fg.image, end=fg.ti == n - 1).cpu() -
                    cpu.step(fc.image, end=fc.ti == n - 1)).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), diff)
            assert diff <= DET_TOL, f"{key} frame {fc.ti}: {diff}"
        for core in (cpu, gpu):
            core.clear_buffer()
        next_voting += every
        if next_voting >= n:
            next_voting = n + num_voting
    assert dc.object_table(gpu) == dc.object_table(cpu), f"{key} tables"
    return votes, shares


def phase_detection_parity(ak, net_cpu, dev):
    """Phase 6a: detection fusion on the card against the CPU at 64x96
    (detection_clips.small_clip, tests/test_detection_parity.py's
    configuration: top_k 8, mem_every 2, equal seeded id generators).
    spatial_alignment (top_k 8 and 30 > the 24 tokens) within DET_TOL with
    one launch of each exact kernel. Online (a detection every other frame
    over 8 frames; segment 4 is poked at 2, 4 and 6 and purged at 6) and
    semi-online (3 voting frames, a vote every 3), each twice:
    - as the driver runs them, the cores predicting the forward mask and
      aligning the vote's frames: the forward predictions and alignments
      within DET_TOL, and a detection frame or consensus mask may differ
      beyond it only where two of them have another argmax (their painted
      id differs), on at most DET_FLIP_SHARE of the frame (printed);
    - with a perfect forward mask and a perfect alignment
      (detection_clips.perfect_forward, aligned_proj), where nothing on the
      host depends on a device output: every frame within DET_TOL with no
      such allowance, consensus masks equal, and after the online run every
      sensory row within DET_TOL.
    Frames within DET_TOL, equal object tables and selections throughout."""
    import dataclasses
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.config import InferenceConfig
    cfg = InferenceConfig(mem_every=2, top_k=8, enable_long_term=False,
                          max_missed_detection_count=2)
    clip = dc.small_clip(np.random.default_rng(4), 8)
    frames, masks, infos = clip

    worst = {}
    for top_k in (8, 30):
        cpu, gpu = det_core_pair(net_cpu, dev,
                                 dataclasses.replace(cfg, top_k=top_k))
        one_hot = np.stack([masks[0] == d["id"] for d in infos[0]]
                           ).astype(np.float32)
        ak.reset_launch_counts()
        p_gpu = gpu.spatial_alignment(0, frames[0], one_hot, 2, frames[2])
        torch.cuda.synchronize()
        runs = {k: v for k, v in ak.LAUNCHES.items() if v}
        assert runs == dict.fromkeys(EXACT_PAIR, 1), \
            f"spatial_alignment top_k {top_k}: launches {runs}"
        p_cpu = cpu.spatial_alignment(0, frames[0], one_hot, 2, frames[2])
        assert p_gpu.shape == p_cpu.shape == (len(one_hot) + 1, 64, 96)
        worst[f"alignment k={top_k}"] = float(np.abs(p_gpu - p_cpu).max())
        assert worst[f"alignment k={top_k}"] <= DET_TOL, worst

    shares, votes = {}, {}
    for perfect in (False, True):
        key = "online" + (" perfect" if perfect else "")
        cpu, gpu = det_core_pair(net_cpu, dev, cfg)
        shares[key] = det_online_pair(cpu, gpu, clip, perfect, worst, key)
        if perfect:
            diff = (gpu.memory.sensory.cpu() -
                    cpu.memory.sensory).abs().max().item()
            worst["sensory perfect"] = diff
            assert diff <= DET_TOL, f"sensory rows: |card - cpu| = {diff}"
        key = "semionline" + (" perfect" if perfect else "")
        cpu, gpu = det_core_pair(net_cpu, dev, cfg)
        votes[key], shares[key] = det_semionline_pair(
            cpu, gpu, clip, perfect, worst, key)
    assert all(votes["semionline perfect"]), votes
    assert not any(any(s) for k, s in shares.items() if "perfect" in k)
    print(f"phase 6a detection fusion, card vs cpu at 64x96: max |dprob| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (bound {DET_TOL:g}); share of each detection frame (and "
          f"consensus mask) whose painted ids may differ, where the two "
          f"runs' forward predictions or projections have another argmax "
          f"(bound {DET_FLIP_SHARE:g}): "
          + "; ".join(f"{k} " + ", ".join(f"{s:.4f}" for s in v)
                      for k, v in shares.items())
          + f"; object tables equal; votes selected {votes} on both",
          flush=True)


class HostTimer:
    """Host ms spent in one function, patched on an object for a run."""

    def __init__(self, owner, name):
        self.owner, self.name, self.fn = owner, name, getattr(owner, name)
        self.ms, self.calls = 0.0, 0
        setattr(owner, name, self)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.ms += (time.perf_counter() - t0) * 1000
            self.calls += 1

    def take(self) -> float:
        ms, self.ms = self.ms, 0.0
        return ms

    def restore(self):
        setattr(self.owner, self.name, self.fn)


class KernelTap:
    """The arguments of every call of the exact pair's wrappers
    (attention_kernels.sim_topk and topk_readout, patched for a run), as
    (name, args) under the current `tag`. frame() keeps the calls made
    since the last frame() as `last_frame` and starts anew."""

    def __init__(self, ak):
        self.ak, self.tag, self.calls, self.last_frame = ak, "memory", {}, []
        self.fns = {name: getattr(ak, name) for name in EXACT_PAIR}
        for name in EXACT_PAIR:
            setattr(ak, name, self._spy(name))

    def _spy(self, name):
        fn = self.fns[name]

        def spy(*args):
            self.calls.setdefault(self.tag, []).append((name, args))
            return fn(*args)
        return spy

    def frame(self):
        self.last_frame = self.calls.pop("memory", [])

    def restore(self):
        for name, fn in self.fns.items():
            setattr(self.ak, name, fn)


class DetReader:
    """An in-memory video for eval_with_detections_torch.run_video: its
    frames [H, W, 3] f32 and detection id masks, read as the driver's
    DetectionVideoReader items are."""

    def __init__(self, frames, masks, name):
        self.frames, self.masks, self.vid_name = frames, masks, name

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"rgb": self.frames[i], "mask": self.masks[i], "info": {
            "frame": f"{i:05d}.jpg", "shape": self.frames[i].shape[:2],
            "need_resize": False, "save": True, "is_rgb": False}}


class DetSaver:
    """run_video's result saver for phases 6 and 7: writes nothing. Checks
    each frame's output (finite, [1 + objects, H, W]; a propagated frame's
    probabilities sum to 1), keeps the frame order (and with keep, each
    frame's output on the host in `kept`), and calls after(ti)."""

    def __init__(self, core, detection_frame, after=None, keep=False):
        self.core, self.detection_frame, self.after = \
            core, detection_frame, after
        self.order, self.kept = [], {} if keep else None

    def save_mask(self, prob, frame, need_resize=False, shape=None,
                  path_to_image=None):
        ti = int(frame[:5])
        self.order.append(ti)
        n = self.core.object_manager.num_obj
        assert prob.shape == (n + 1, *shape), (ti, tuple(prob.shape))
        assert bool(torch.isfinite(prob).all()), f"frame {ti}"
        if not self.detection_frame(ti):  # logits on detection frames
            torch.testing.assert_close(prob.sum(0), torch.ones_like(
                prob[0]), rtol=0, atol=1e-4)
        if self.kept is not None:
            self.kept[ti] = prob.cpu().numpy()
        if self.after is not None:
            self.after(ti)


def det_driver(setting: str):
    """eval_with_detections_torch's module and its flags for phase 6b/6c:
    the defaults (long-term on, exact top-k, a detection every 5 frames, 3
    voting frames, max_missed_detection_count 5), `setting` temporal."""
    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    import eval_with_detections_torch as drv
    args = drv.make_parser().parse_args(
        ["--temporal_setting", setting, "--device", "cuda"])
    return drv, args


def det_run(drv, args, net, dev, frames, masks, infos, after=None):
    """One video through the driver's run_video, as its main() runs a
    video: video_processor, segments_info from the detections' JSON (long
    ids), timed by a StepTimer. -> (processor, saver, timer, a function
    that runs the video); `after`, if given, gets the processor and
    returns the saver's callback."""
    core = drv.video_processor(net, drv.detection_config(args), len(frames),
                               dev)
    core.object_manager._rng = np.random.default_rng(5)
    timer = drv.StepTimer(dev)
    # detection frames return logits: in both settings the frames
    # 0, detection_every, ... (semi-online: each vote's first buffered frame)
    saver = DetSaver(core, lambda ti: ti % args.detection_every == 0,
                     after(core) if after else None)
    return core, saver, timer, lambda: drv.run_video(
        DetReader(frames, masks, "det480"), core, saver, args, timer,
        "vipseg", lambda ti, mask, info: (infos[ti], True))


def phase_detection_online(ak, net_cpu, dev, n_frames: int = 60,
                           h: int = H480, w: int = W480):
    """Phase 6b: the online setting at 480p, timed, through
    eval_with_detections_torch.run_video (DetReader, DetSaver): 60
    synthetic frames (seed 31) with detection_clips.detections,
    incorporate_detection every 5 frames and step otherwise, at the
    driver's defaults (long-term on, exact top-k, max_missed_detection_count
    5, long ids). Checks each frame's output (DetSaver), the object made
    from thing 7 at frame 0 purged by the last frame, and both exact
    kernels launched. Prints, from the driver's StepTimer (CUDA
    events), the median ms per propagation frame (frames 10 onwards) and
    per detection frame, the detection frame's host time in match_and_merge
    and purge_inactive_objects and the rest, its transfers, the objects and
    buckets over time, the launches and the peak memory. Returns the
    launch counts and the exact pair's calls of the last frame (a composed
    match_memory, one call per bucket)."""
    import deva_tpu_torch.inference.core as core_mod
    from deva_tpu_torch.detection_clips import DET_THINGS, detections
    gc.collect()
    frames = synthetic_video(np.random.default_rng(31), h, w, n_frames)
    masks, infos = detections(n_frames, h, w)
    drv, args = det_driver("online")
    net = copy.deepcopy(net_cpu).to(dev)
    category7 = next(cat for tid, cat, *_ in DET_THINGS if tid == 7)
    history, watch = [], []

    def after(core):
        def record(ti):
            table = core.object_manager.obj_to_tmp_id
            if ti == 0:  # the object made from thing 7
                watch.extend(o.id for o in table
                             if o.vote_category_id() == category7)
                assert len(watch) == 1, watch
            if ti % args.detection_every == 0:
                history.append((ti, len(table), len(core.memory.buckets),
                                core.o_cap, sum(
                                    lt.size for lt in
                                    core.memory.long_buckets.values()),
                                watch[0] in core.object_manager.all_obj_ids))
            tap.frame()
        return record

    core, saver, timer, run = det_run(drv, args, net, dev, frames, masks,
                                      infos, after)
    merge = HostTimer(core_mod, "match_and_merge")
    purge = HostTimer(core.object_manager, "purge_inactive_objects")
    ids = HostTimer(core_mod, "argmax_ids")
    host_ms = {}
    incorporate = core.incorporate_detection

    def timed_incorporate(*a, **kw):
        out = incorporate(*a, **kw)
        host_ms[core.curr_ti] = merge.take() + purge.take()
        return out

    core.incorporate_detection = timed_incorporate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ak.reset_launch_counts()
    tap = KernelTap(ak)
    try:
        run()
    finally:
        tap.restore()
        for t in (merge, purge, ids):
            t.restore()
    launches = dict(ak.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    assert saver.order == list(range(n_frames)), saver.order
    assert all(launches[k] > 0 for k in EXACT_PAIR), launches
    seen7 = [ti for ti, *_, has7 in history if has7]
    assert not history[-1][-1] and seen7, \
        f"thing 7 (gone at frame 25) not purged: in the table at {seen7}"
    det_ti = range(0, n_frames, args.detection_every)
    ms = dict(zip(saver.order, timer.steps_ms))
    prop = [ms[ti] for ti in range(10, n_frames) if ti not in det_ti]
    det = [ms[ti] for ti in det_ti]
    steady = [ti for ti in det_ti if ti >= 10]
    med = statistics.median(ms[ti] for ti in steady)
    host = statistics.median(host_ms[ti] for ti in steady)
    print(f"phase 6b online detection fusion at {h}x{w}, {n_frames} frames "
          f"through eval_with_detections_torch.run_video, a detection every "
          f"{args.detection_every} ({min(len(i) for i in infos)}-"
          f"{max(len(i) for i in infos)} segments), ms from its StepTimer "
          f"(CUDA events): propagation frames median "
          f"{statistics.median(prop):.3f} ms (frames 10+, mean "
          f"{statistics.mean(prop):.3f}, max {max(prop):.3f}); detection "
          f"frames median {med:.3f} ms (10+; each: "
          + ", ".join(f"{m:.1f}" for m in det)
          + f"), of it on the host in match_and_merge and "
          f"purge_inactive_objects median {host:.3f} ms, the rest (device "
          f"work and its launches) {med - host:.3f} ms; device-to-host "
          f"copies {ids.calls} of forward ids ({h}x{w} uint8 padded), one "
          f"host-to-device copy of the merged one-hot per detection frame, "
          f"one of each frame", flush=True)
    print(f"phase 6b (frame, objects, buckets, o_cap, long-term tokens) at "
          f"detection frames: {[row[:5] for row in history]}; the object "
          f"made from thing 7 at frame 0 last in the table at frame "
          f"{seen7[-1]} (random weights match no detection again, so every "
          f"object of a detection frame goes after 6 misses); launches "
          f"{launches}; peak allocated {peak:.1f} MiB", flush=True)
    return launches, tap.last_frame


def phase_detection_semionline(ak, net_cpu, dev, n_frames: int = 20,
                               h: int = H480, w: int = W480):
    """Phase 6c: the semi-online setting at 480p through
    eval_with_detections_torch.run_video at the driver's defaults (3
    voting frames, a vote every 5) over 20 synthetic frames (seed 32) with
    detection_clips.detections. Prints the ms per spatial_alignment and its
    launches (one of each exact kernel), the ms of the host vote (IoU table
    and integer program: the vote's time less its alignments), the ms of
    the timed vote-and-incorporate step, and the segments in and selected.
    A second line splits each host vote into the IoU tables
    (consensus.pairwise_support) and the integer program, and counts the
    integer programs that ran through the native library. Returns the
    launch counts, those of the alignments, and the exact pair's calls in
    the last alignment."""
    gc.collect()
    frames = synthetic_video(np.random.default_rng(32), h, w, n_frames)
    from deva_tpu_torch.detection_clips import detections
    masks, infos = detections(n_frames, h, w)
    drv, args = det_driver("semionline")
    net = copy.deepcopy(net_cpu).to(dev)
    core, saver, timer, run = det_run(drv, args, net, dev, frames, masks,
                                      infos)
    align_ms, align_runs, vote_ms, vote_segs, vote_ti = [], [], [], [], []
    real_align, real_vote = core.spatial_alignment, \
        core.vote_in_temporary_buffer
    from deva_tpu_torch.inference import consensus
    from deva_tpu_torch.utils import native
    # the host vote's two parts, and the native solver under the integer
    # program
    tables = HostTimer(consensus, "pairwise_support")
    program = HostTimer(consensus, "solve_consensus_ilp")
    solver = HostTimer(native, "mwis_solve")
    vote_split = []

    def timed_align(*a):
        before = dict(ak.LAUNCHES)
        tap.tag, tap.calls["align"] = "align", []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = real_align(*a)  # a host array: synchronised
        finally:
            tap.tag = "memory"
        align_ms.append((time.perf_counter() - t0) * 1000)
        align_runs.append({k: ak.LAUNCHES[k] - before[k] for k in before
                           if ak.LAUNCHES[k] > before[k]})
        return out

    def timed_vote(*a, **kw):
        n_align = len(align_ms)
        t0 = time.perf_counter()
        out = real_vote(*a, **kw)
        vote_ms.append((time.perf_counter() - t0) * 1000 -
                       sum(align_ms[n_align:]))
        vote_segs.append((sum(len(f.segments_info)
                              for f in core.frame_buffer), len(out[2])))
        vote_ti.append(core.frame_buffer[0].ti)
        vote_split.append((tables.take(), program.take()))
        return out

    core.spatial_alignment = timed_align
    core.vote_in_temporary_buffer = timed_vote
    ak.reset_launch_counts()
    tap = KernelTap(ak)
    try:
        run()
    finally:
        tap.restore()
        for part in (tables, program, solver):
            part.restore()
    torch.cuda.synchronize()
    assert solver.calls == program.calls, (solver.calls, program.calls)
    launches = dict(ak.LAUNCHES)
    assert sorted(saver.order) == list(range(n_frames)), saver.order
    assert align_runs and all(r == dict.fromkeys(EXACT_PAIR, 1)
                              for r in align_runs), align_runs
    step_ms = dict(zip(saver.order, timer.steps_ms))
    print(f"phase 6c semi-online detection fusion at {h}x{w}, {n_frames} "
          f"frames through eval_with_detections_torch.run_video, "
          f"{args.num_voting_frames} voting frames, a vote every "
          f"{args.detection_every}: {len(align_ms)} spatial alignments, "
          f"median {statistics.median(align_ms):.3f} ms (each: "
          + ", ".join(f"{m:.1f}" for m in align_ms)
          + f"), one launch of each exact kernel per alignment; host vote "
          f"(IoU table and integer program) median "
          f"{statistics.median(vote_ms):.3f} ms per vote; vote and "
          f"incorporate, as the driver times them (StepTimer, CUDA events): "
          + ", ".join(f"{step_ms[ti]:.1f}" for ti in vote_ti)
          + f" ms; segments in / selected per vote {vote_segs} (random "
          f"weights align noise, so few or no segments find support: a zero "
          f"selection is expected); launches {launches}", flush=True)
    print(f"phase 6c host vote split ({program.calls} integer programs, "
          f"{solver.calls} of them solved by the native library "
          f"utils/native.py): per vote, host ms "
          + ", ".join(f"{v:.3f}" for v in vote_ms)
          + " of which IoU tables (consensus.pairwise_support) "
          + ", ".join(f"{t:.3f}" for t, _ in vote_split)
          + " and the integer program "
          + ", ".join(f"{p:.4f}" for _, p in vote_split), flush=True)
    aligned = {k: sum(r.get(k, 0) for r in align_runs) for k in EXACT_PAIR}
    return launches, aligned, tap.calls["align"]


# the unit roundoff of f32
F32_U = 2.0 ** -24


def gamma(n: int) -> float:
    """The classic bound on the relative error of an f32 sum of n products
    (Higham's gamma_n = n u / (1 - n u)) against the sum of their absolute
    values."""
    return n * F32_U / (1 - n * F32_U)


def sim_scale(qk, qe, mk, ms, valid):
    """[Q, N]: the similarity's terms in absolute value, |qe| . mk^2 +
    2 |qk qe| . |mk| + sum |qe qk^2|, times |ms| / sqrt(Ck) (without qe,
    |mk|^2 + 2 |qk| . |mk| + |qk|^2): what the rounding error of an f32
    evaluation is relative to; 0 on invalid slots."""
    qk, mk = qk.float(), mk.float()
    qe = torch.ones_like(qk) if qe is None else qe.float()
    t = (qe.abs() @ (mk * mk).T + 2 * (qk * qe).abs() @ mk.abs().T
         + (qe * qk * qk).abs().sum(-1, keepdim=True))
    if ms is not None:
        t = t * ms.float().abs()[None]
    t = t / mk.shape[-1] ** 0.5
    return t if valid is None else t.masked_fill(~valid[None], 0.0)


def check_pair_on_path(ak, sim_args, read_args, label):
    """The exact pair against its plain twins on arguments the main path
    gave it. There the keys come from the network and may be large: the
    similarity sums terms that cancel, so phase 1's absolute budgets on
    unit-scale inputs do not apply. Each f32 evaluation of a similarity is
    within gamma(2 Ck + 4) of its terms' scale (sim_scale), so the j-th
    largest values of the kernel and the twin lie within twice the row's
    largest such bound (+1e-5) of each other, and so do the kernel's values
    and the twin's similarity at the kernel's indices; those indices are
    distinct and valid. Each readout output is a sum of k products: kernel
    and twin within 2 gamma(k + 1) sum |w| |V| (+1e-6). -> (max |kernel -
    twin| of each, and its largest share of the bound)."""
    from deva_tpu_torch.ops import memory_attention as ma
    qk, qe, mk, ms, valid, k = sim_args
    gi, w, values = read_args
    gv, gx = ak.sim_topk(qk, qe, mk, ms, valid, k)
    rv, _ = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
    scale = sim_scale(qk, qe, mk, ms, valid)
    tol = 2 * gamma(2 * mk.shape[-1] + 4) * scale.amax(-1, keepdim=True) \
        + 1e-5
    sim = ma.mask_invalid(ma.get_similarity(mk, ms, qk, qe), valid)
    both_inf = lambda a, b: torch.isinf(a) & (a == b)
    d_sorted = torch.where(both_inf(gv, rv), 0.0, (gv - rv).abs())
    at = sim.gather(-1, gx.long())
    d_at = torch.where(both_inf(gv, at), 0.0, (gv - at).abs())
    assert bool((d_sorted <= tol).all()) and bool((d_at <= tol).all()), (
        f"{label}: sim_topk off its twin by {d_sorted.max().item():.3g} "
        f"(sorted) / {d_at.max().item():.3g} (at its indices), over "
        f"{((torch.maximum(d_sorted, d_at)) / tol).max().item():.3g} of "
        "the f32 bound")
    srt = gx.sort(-1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all()), f"{label}: repeats"
    if valid is not None and int(valid.sum()) >= gx.shape[-1]:
        assert bool(valid[gx.long()].all()), f"{label}: invalid slot"
    segs = tuple(values) if isinstance(values, (tuple, list)) else (values,)
    out = ak.topk_readout(gi, w, values)
    ref = ak.topk_readout_plain(gi, w, values)
    mag = ak.topk_readout_plain(gi, w.abs(), tuple(v.abs() for v in segs)
                                if len(segs) > 1 else values.abs())
    rtol = 2 * gamma(gi.shape[-1] + 1) * mag + 1e-6
    d_read = (out - ref).abs()
    assert bool((d_read <= rtol).all()), (
        f"{label}: topk_readout off its twin by {d_read.max().item():.3g}, "
        f"over {(d_read / rtol).max().item():.3g} of the f32 bound")
    return ({"sim_topk": d_sorted.max().item(),
             "topk_readout": d_read.max().item()},
            {"sim_topk": (torch.maximum(d_sorted, d_at) / tol).max().item(),
             "topk_readout": (d_read / rtol).max().item()})


def det_kernel_rows(ak, apx, dev, suffix, calls, launches, label):
    """The exact pair on the arguments the main path gave it (`calls`, as
    KernelTap recorded them): every call held to its plain twin
    (check_pair_on_path); of the calls with the most value segments
    ([long-term ; working] read in place), the one with the most work
    (Q x N) timed beside its plain twin, its bound (phase 1's form, from
    these inputs), the library call (embedding_bag, on the ring
    concatenated outside the timing) and cuBLAS's product.
    -> the kernels line's rows, named with `suffix`, with `launches`."""
    sims = [a for name, a in calls if name == "sim_topk"]
    reads = [a for name, a in calls if name == "topk_readout"]
    assert sims and len(sims) == len(reads), (len(sims), len(reads))
    err = {name: 0.0 for name in EXACT_PAIR}
    share = dict(err)
    for j, (sim_args, read_args) in enumerate(zip(sims, reads)):
        e, f = check_pair_on_path(ak, sim_args, read_args,
                                  f"{label}, call {j}")
        err = {name: max(err[name], e[name]) for name in EXACT_PAIR}
        share = {name: max(share[name], f[name]) for name in EXACT_PAIR}
    n_segs = [len(v) if isinstance(v, (tuple, list)) else 1
              for _, _, v in reads]
    i = max(range(len(sims)), key=lambda j: (
        n_segs[j], sims[j][0].shape[-2] * sims[j][2].shape[-2]))
    (qk, qe, mk, ms, valid, k), (gi, w, values) = sims[i], reads[i]
    segs = tuple(values) if n_segs[i] > 1 else (values,)
    ring = torch.cat(segs) if len(segs) > 1 else segs[0]
    q, ck = qk.shape
    n, c, kk = mk.shape[0], ring.shape[1], gi.shape[1]
    nbytes = lambda *ts: sum(t.numel() * t.element_size()
                             for t in ts if t is not None)
    rows = int(torch.unique(gi).numel())  # value rows the readout needs
    bounds = {
        "sim_topk": bound(4 * q * n * ck, nbytes(qk, qe, mk, ms, valid)
                          + 8 * q * kk),
        "topk_readout": bound(2 * q * kk * c, nbytes(gi, w)
                              + rows * c * ring.element_size() + 4 * q * c)}
    ops2 = apx.prep2(qk, qe, mk, ms, valid)
    gl = gi.long()
    t = {"sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk, ms, valid, k)),
         "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
             qk, qe, mk, ms, valid, k)),
         "sim_topk_product": cuda_ms(lambda: torch.mm(ops2.qcat,
                                                      ops2.mcat.T)),
         "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, values)),
         "topk_readout_plain": cuda_ms(lambda: ak.topk_readout_plain(
             gi, w, values)),
         "topk_readout_library": cuda_ms(
             lambda: torch.nn.functional.embedding_bag(
                 gl, ring, mode="sum", per_sample_weights=w))}
    shape = (f"Q={q} N={n} C={c} ({len(segs)} segment"
             f"{'s' if len(segs) > 1 else ''})")
    print(f"kernels on the path, {label}, {len(sims)} calls of each held to "
          f"the plain twins (value segments per call {n_segs}); timed at "
          f"{shape}, the largest with the most segments: ms "
          + ", ".join(f"{name} {v:.4f}" for name, v in t.items())
          + "; bound ms " + ", ".join(f"{name} {b:.4f} ({by})"
                                      for name, (b, by) in bounds.items())
          + f"; readout rows {rows}; max |kernel - twin| {err}, at most "
          + ", ".join(f"{name} {v:.3g}" for name, v in share.items())
          + f" of the f32 bound; launches {launches}",
          flush=True)
    out_rows = []
    for name in EXACT_PAIR:
        src, tpu = KERNELS[name]
        bound_ms, bound_by = bounds[name]
        out_rows.append({
            "name": name + suffix, "ring_dtype": str(ring.dtype)[6:],
            "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "shape": shape,
            "max_abs_err": err[name], "ms": t[name],
            "plain_ms": t[name + "_plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t.get(name + "_library"),
            "product_ms": t.get(name + "_product")})
    return out_rows


# --------------------------------------------------------------------------
# phase 7: batched detection fusion and mid-stream VOS
# --------------------------------------------------------------------------

# phase 7a's long-term configuration at 64x96 (24 tokens a frame):
# consolidation at 4 writes, 8 prototypes
BDET_LT = dict(enable_long_term=True, enable_long_term_count_usage=True,
               max_mid_term_frames=4, min_mid_term_frames=2,
               num_prototypes=8)
# tests/test_batched_detection.py's budgets, a batched video against its
# sequential run: pixels beyond 5e-3 (or argmax flips) on at most 2% of a
# frame up to frame 5, then 5% (6% with long-term memory)
BDET_BUDGET = (0.02, 0.05, 0.06)
# phase 7a: where the CPU's top two channels of an alignment lie within
# this, the card's id may differ
ALIGN_TIE = 3e-3
# phase 7b/7c: videos in one lockstep group, and 7b's segments a detection
# frame (4, not 6b's 12: four videos piling random-weight objects up to
# o_cap 128 each would need about 84 GiB, PERF.md section 4)
B7 = 4
BDET_SEGMENTS = 4


def bdet_clips(seed, t, third_at):
    """Phase 7a's two 64x96 clips (tests/test_batched_detection.py:_video,
    drawn from one generator): segments 1 and 2, and in video 1 segment 3
    from frame third_at."""
    from deva_tpu_torch import detection_clips as dc
    rng = np.random.default_rng(seed)
    return [dc.small_clip(rng, t, appear=10 ** 6, show=0, vanish=0),
            dc.small_clip(rng, t, appear=third_at, show=0, vanish=0)]


def bdet_cores(net, cfg, n):
    from deva_tpu_torch.inference.core import InferenceCore
    cores = []
    for vi in range(n):
        core = InferenceCore(net, cfg)
        core.enabled_long_id()
        core.object_manager._rng = np.random.default_rng(5 + vi)
        cores.append(core)
    return cores


def bdet_sequential(net, cfg, clips, det_every):
    """detection_clips.online_sequential on fresh cores -> per-video
    frames."""
    from deva_tpu_torch import detection_clips as dc
    return dc.online_sequential(bdet_cores(net, cfg, len(clips)), clips,
                                det_every)


def launches_per_frame(fn, ak, record):
    """A propagator's forward_probs, step_all or step_block that appends
    the kernel launches of each of its lockstep frames to `record`."""
    def counted(*args, **kwargs):
        before = dict(ak.LAUNCHES)
        out = fn(*args, **kwargs)
        k = out.shape[1] if fn.__name__ == "step_block" else 1
        record.extend([{n: (ak.LAUNCHES[n] - before[n]) / k
                        for n in before}] * k)
        return out
    return counted


def bdet_online(ak, net, cfg, clips, det_every, block, perfect=False):
    """detection_clips.online_lockstep on fresh cores, each lockstep frame's
    launches counted. -> (per-video frames, {ti: per-video forward
    predictions [1 + n, H, W]}, cores, per-frame launch counts)."""
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.inference.batched_detection import \
        BatchedDetectionPropagator
    cores = bdet_cores(net, cfg, len(clips))
    bp = BatchedDetectionPropagator(net, cfg)
    per_frame = []
    for name in ("forward_probs", "step_all", "step_block"):
        setattr(bp, name, launches_per_frame(getattr(bp, name), ak,
                                             per_frame))
    frames, forwards = dc.online_lockstep(bp, cores, clips, det_every,
                                          block, perfect)
    return frames, forwards, cores, per_frame


def bdet_budget(ref, out, label, lt):
    """A video's frames against its sequential run, with BDET_BUDGET. ->
    the largest share moved."""
    worst = 0.0
    for ti, (r, o) in enumerate(zip(ref, out)):
        assert r.shape == o.shape, (label, ti, r.shape, o.shape)
        budget = BDET_BUDGET[0] if ti < 6 else BDET_BUDGET[2 if lt else 1]
        moved = float((np.abs(o - r) > 5e-3).any(0).mean())
        flips = float((o.argmax(0) != r.argmax(0)).mean())
        assert moved <= budget and flips <= budget, (label, ti, moved, flips)
        worst = max(worst, moved, flips)
    return worst


def bdet_card_vs_cpu(cpu, gpu, det_every, strict, label, worst):
    """One flow on the card against the CPU: propagation frames within
    DET_TOL; the forward predictions within DET_TOL; a detection frame may
    differ beyond DET_TOL only where the two forward predictions' argmaxes
    differ (none with strict), on at most DET_FLIP_SHARE of it; equal
    object tables. -> the detection frames' shares."""
    from deva_tpu_torch import detection_clips as dc
    (f_cpu, fw_cpu, c_cpu, _), (f_gpu, fw_gpu, c_gpu, _) = cpu, gpu
    shares = []
    for vi in range(len(f_cpu)):
        for ti, (r, o) in enumerate(zip(f_cpu[vi], f_gpu[vi])):
            if ti % det_every:
                diff = float(np.abs(o - r).max())
                worst[label] = max(worst.get(label, 0.0), diff)
                assert diff <= DET_TOL, f"{label} video {vi} frame {ti}: " \
                    f"|card - cpu| = {diff}"
                continue
            allowed = None
            if fw_cpu.get(ti):
                a, b = fw_cpu[ti][vi], fw_gpu[ti][vi]
                diff = float(np.abs(b - a).max())
                worst[label + " forward"] = max(
                    worst.get(label + " forward", 0.0), diff)
                assert diff <= DET_TOL, f"{label}: forward {diff}"
                allowed = None if strict else dc.paint_flips(a, b)
            shares.append(dc.check_detection_frame(
                r, o, allowed, DET_TOL, DET_FLIP_SHARE,
                f"{label} video {vi} frame {ti}")[1])
    for a, b in zip(c_cpu, c_gpu):
        assert dc.object_table(a) == dc.object_table(b), label
    return shares


def bdet_semionline(net, cfg, clips, every=3, num_voting=3):
    """The semi-online setting in lockstep through eval_with_detections_
    batched_torch.run_group (BdetReader; DetSaver keeping every frame), a
    vote every `every` frames over num_voting: at a voting frame the
    forward predictions (forward_ids, before detach), every alignment in
    one align_consensus_batched call, the votes on those alignments,
    incorporate_detection, attach, and the rest of the buffer through
    step_block; past the last vote the tails. -> (per-video {ti: frame},
    [per-video alignment id maps per vote], [per-video consensus masks per
    vote], [selections per vote], cores, {keyframe: the forward
    predictions [B, 1 + o_cap, H, W] that forward_ids took its argmax
    of})."""
    import types
    import deva_tpu_torch.inference.batched_detection as bd
    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    import eval_with_detections_batched_torch as bdrv
    cores = bdet_cores(net, cfg, len(clips))
    aligns, votes, probs = [], [[] for _ in cores], []
    cls = bd.BatchedDetectionPropagator
    align, forward_ids = cls.align_consensus_batched, cls.forward_ids
    argmax_ids = bd.argmax_ids

    def align_kept(bp, cs, **kwargs):
        aligns.append(align(bp, cs, **kwargs))
        return aligns[-1]

    def ids_kept(prob, dim):  # within forward_ids only
        probs.append(prob.cpu().numpy())
        return argmax_ids(prob, dim=dim)

    def forward_kept(bp, frames):
        bd.argmax_ids = ids_kept
        try:
            return forward_ids(bp, frames)
        finally:
            bd.argmax_ids = argmax_ids

    def vote_kept(core, kept):
        vote = core.vote_in_temporary_buffer

        def kept_vote(**kwargs):
            kept.append(vote(**kwargs))
            return kept[-1]
        return kept_vote

    states = []
    for vi, (core, (frames, masks, infos)) in enumerate(zip(cores, clips)):
        core.vote_in_temporary_buffer = vote_kept(core, votes[vi])
        states.append(bdrv._VideoState(
            BdetReader(frames, masks, infos, f"semi{vi}"), core,
            DetSaver(core, lambda ti: ti % every == 0, keep=True)))
    args = types.SimpleNamespace(detection_every=every,
                                 num_voting_frames=num_voting,
                                 save_all=False)
    cls.align_consensus_batched, cls.forward_ids = align_kept, forward_kept
    try:
        bdrv.run_group(net, cfg, states, args, "vipseg",
                       bdrv.StepTimer(next(net.parameters()).device))
    finally:
        cls.align_consensus_batched, cls.forward_ids = align, forward_ids
        for core in cores:
            del core.vote_in_temporary_buffer
    n = len(clips[0][0])
    for vs in states:
        assert sorted(vs.saver.order) == list(range(n)), vs.saver.order
    n_votes = len(votes[0])
    # the first vote makes no forward prediction: nothing is attached yet
    assert len(probs) == n_votes - 1, (len(probs), n_votes)
    return ([vs.saver.kept for vs in states], aligns,
            [[v[j][1] for v in votes] for j in range(n_votes)],
            [[[o.id for o in v[j][2]] for v in votes]
             for j in range(n_votes)], cores,
            {every * (j + 1): p for j, p in enumerate(probs)})


def align_ties(net_cpu, cfg, clips):
    """The CPU's per-item spatial_alignment of the first vote (keyframe 0,
    frames 1 and 2), for the tie map: {(video, frame): pixels whose top two
    channels lie within ALIGN_TIE}."""
    from deva_tpu_torch import detection_clips as dc
    out = {}
    for vi, (frames, masks, infos) in enumerate(clips):
        core = bdet_cores(net_cpu, cfg, 1)[0]
        for i in (1, 2):
            one_hot = np.stack([masks[i] == d["id"] for d in infos[i]]
                               ).astype(np.float32)
            p = dc.host(core.spatial_alignment(i, frames[i], one_hot, 0,
                                               frames[0]))
            top2 = np.sort(p, axis=0)[-2:]
            out[vi, i] = (top2[1] - top2[0]) <= ALIGN_TIE
        for ti in (0, 1, 2):
            core.image_feature_store.delete(ti)
    return out


def phase_batched_detection_parity(ak, net_cpu, dev):
    """Phase 7a: BatchedDetectionPropagator on the card against the CPU at
    64x96 (bdet_clips: video 1 gains a third segment at the second
    detection, so it opens a new bucket), top_k 8, mem_every 2, a detection
    every 3 frames over 10. Online through step_all and through step_block,
    exact and approx, long-term memory off and on (BDET_LT: consolidation
    runs); semi-online through eval_with_detections_batched_torch.
    run_group (align_consensus_batched), exact and approx.
    Card against CPU (bdet_card_vs_cpu): frames within DET_TOL, a detection
    frame beyond it only where the two forward predictions paint another
    id; alignment ids equal but where the CPU's top two channels tie within
    ALIGN_TIE (that share printed and bounded by DET_FLIP_SHARE), consensus
    masks equal where the alignments are. The card's batched run against
    its own sequential run per video: BDET_BUDGET. One launch of each
    kernel of the method per lockstep frame. Strict: a perfect forward
    mask, no allowance at all, sensory rows too."""
    import dataclasses
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.config import InferenceConfig
    net = copy.deepcopy(net_cpu).to(dev)
    base = InferenceConfig(mem_every=2, top_k=8, enable_long_term=False,
                           max_missed_detection_count=3)
    worst, shares, seq_moved, launch_rows, most_pairs = {}, {}, {}, {}, {}
    det_every, t = 3, 10
    clips = bdet_clips(21, t, det_every)
    for method, lt, block in (("exact", False, False),
                              ("exact", True, True),
                              ("approx", False, False),
                              ("approx", True, True)):
        cfg = dataclasses.replace(base, topk_method=method,
                                  **(BDET_LT if lt else {}))
        label = f"online {method} {'lt ' if lt else ''}" + \
            ("step_block" if block else "step_all")
        cpu = bdet_online(ak, net_cpu, cfg, clips, det_every, block)
        ak.reset_launch_counts()
        tap = ConsolidationTap()
        try:
            gpu = bdet_online(ak, net, cfg, clips, det_every, block)
            torch.cuda.synchronize()
        finally:
            tap.restore()
        pair = EXACT_PAIR if method == "exact" else \
            tuple(k for k in KERNELS if k not in EXACT_PAIR)
        assert all(f[k] == 1 for f in gpu[3] for k in pair) and \
            all(f[k] == 0 for f in gpu[3] for k in KERNELS if k not in pair),\
            f"{label}: not one launch of each kernel per lockstep frame"
        launch_rows[label] = len(gpu[3])
        shares[label] = bdet_card_vs_cpu(cpu, gpu, det_every, False, label,
                                         worst)
        if lt:
            assert any(lt_b.size > 0 for c in gpu[2]
                       for lt_b in c.memory.long_buckets.values()), \
                f"{label}: no consolidation"
            most_pairs[label] = tap.most_pairs()
        if method == "exact":
            seq = bdet_sequential(net, cfg, clips, det_every)
            seq_moved[label] = max(bdet_budget(s, b, f"{label} video {vi}",
                                               lt)
                                   for vi, (s, b) in enumerate(
                                       zip(seq, gpu[0])))
    assert any(len(c.memory.buckets) >= 2 for c in gpu[2])

    # strict: a perfect forward mask, no allowance, sensory rows too
    cfg = dataclasses.replace(base, topk_method="exact")
    cpu = bdet_online(ak, net_cpu, cfg, clips, det_every, False,
                      perfect=True)
    gpu = bdet_online(ak, net, cfg, clips, det_every, False, perfect=True)
    shares["online perfect"] = bdet_card_vs_cpu(cpu, gpu, det_every, True,
                                                "online perfect", worst)
    worst["sensory perfect"] = max(
        (b.memory.sensory.cpu() - a.memory.sensory).abs().max().item()
        for a, b in zip(cpu[2], gpu[2]))
    assert worst["sensory perfect"] <= DET_TOL, worst

    # semi-online through align_consensus_batched
    align_share = {}
    for method in ("exact", "approx"):
        cfg = dataclasses.replace(base, topk_method=method)
        label = f"semionline {method}"
        cpu = bdet_semionline(net_cpu, cfg, clips)
        gpu = bdet_semionline(net, cfg, clips)
        ties = align_ties(net_cpu, cfg, clips)
        share = 0.0
        for vote, (a_cpu, a_gpu) in enumerate(zip(cpu[1], gpu[1])):
            for vi in range(len(clips)):
                assert sorted(a_cpu[vi]) == sorted(a_gpu[vi])
                differ = np.zeros(clips[0][1][0].shape, bool)
                for i, ids in a_gpu[vi].items():
                    d = ids != a_cpu[vi][i]
                    if vote == 0:  # the tie map is the first vote's
                        assert not (d & ~ties[vi, i]).any(), (
                            f"{label} video {vi} frame {i}: alignment ids "
                            f"differ on {int((d & ~ties[vi, i]).sum())} "
                            f"pixels where the CPU's top two channels are "
                            f"more than {ALIGN_TIE} apart")
                        share = max(share, float(ties[vi, i].mean()))
                    differ |= d
                assert differ.mean() <= DET_FLIP_SHARE, (label, vote, vi)
                c_differ = cpu[2][vote][vi] != gpu[2][vote][vi]
                assert not (c_differ & ~differ).any(), \
                    f"{label} vote {vote} video {vi}: consensus masks differ"
        align_share[label] = share
        assert cpu[3] == gpu[3], f"{label}: selections {cpu[3]} {gpu[3]}"
        det_tis = [3 * vote for vote in range(len(cpu[2]))]
        for vi in range(len(clips)):
            for ti in sorted(gpu[0][vi]):
                r, o = cpu[0][vi][ti], gpu[0][vi][ti]
                if ti not in det_tis:
                    diff = float(np.abs(o - r).max())
                    worst[label] = max(worst.get(label, 0.0), diff)
                    assert diff <= DET_TOL, f"{label} video {vi} frame {ti}"
                    continue
                vote = det_tis.index(ti)
                allowed = cpu[2][vote][vi] != gpu[2][vote][vi]
                if ti in cpu[5]:
                    a, b = cpu[5][ti][vi], gpu[5][ti][vi]
                    assert float(np.abs(b - a).max()) <= DET_TOL, label
                    allowed = allowed | dc.paint_flips(a, b)
                shares.setdefault(label, []).append(dc.check_detection_frame(
                    r, o, allowed, DET_TOL, DET_FLIP_SHARE,
                    f"{label} video {vi} frame {ti}")[1])
        for a, b in zip(cpu[4], gpu[4]):
            assert dc.object_table(a) == dc.object_table(b), label
    print(f"phase 7a batched detection fusion, card vs cpu at 64x96, "
          f"2 videos, {t} frames: max |dprob| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (bound {DET_TOL:g}); share of each detection frame whose "
          f"painted ids may differ (bound {DET_FLIP_SHARE:g}): "
          + "; ".join(f"{k} " + ", ".join(f"{s:.4f}" for s in v)
                      for k, v in shares.items())
          + "; alignment ids may differ where the CPU's top two channels "
          f"tie within {ALIGN_TIE:g}, on at most "
          + ", ".join(f"{k} {v:.4f}" for k, v in align_share.items())
          + " of an item; card batched vs card sequential, largest share "
          f"moved (budget {BDET_BUDGET}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in seq_moved.items())
          + f"; one launch of each kernel of the method per lockstep frame "
          f"({launch_rows}); the most (video, slot) pairs one lockstep "
          f"consolidation took: {most_pairs}", flush=True)


class LastCallTap:
    """The arguments of the last call of each named wrapper of a module
    (patched for a run), under the current `tag`, and the number of calls."""

    def __init__(self, module, names):
        self.module, self.tag, self.last, self.calls = module, "path", {}, {}
        self.fns = {name: getattr(module, name) for name in names}
        for name, fn in self.fns.items():
            setattr(module, name, self._spy(name, fn))

    def _spy(self, name, fn):
        def spy(*args):
            self.last[self.tag, name] = args
            self.calls[self.tag, name] = self.calls.get(
                (self.tag, name), 0) + 1
            return fn(*args)
        return spy

    def restore(self):
        for name, fn in self.fns.items():
            setattr(self.module, name, fn)


class BdetReader(DetReader):
    """DetReader with the segments_info in each frame's info (how
    eval_with_detections_batched_torch._frame_record reads them when no
    JSON file exists)."""

    def __init__(self, frames, masks, infos, name):
        super().__init__(frames, masks, name)
        self.infos = infos

    def __getitem__(self, i):
        data = super().__getitem__(i)
        data["info"]["segments_info"] = self.infos[i]
        return data


def phase_batched_detection_online(ak, net_cpu, dev, n_frames: int = 60,
                                   h: int = H480, w: int = W480):
    """Phase 7b: B7 videos of online detection fusion at 480p, 60 frames,
    through eval_with_detections_batched_torch.run_group_online (BdetReader,
    DetSaver), at the driver's defaults (long-term on, exact, a detection
    every 5 frames, max_missed_detection_count 5): detection_clips.
    detections with BDET_SEGMENTS segments, a frame seed per video (41+v).
    Checks every frame (DetSaver) and one launch of each exact kernel per
    lockstep frame (every step_block frame and every forward_ids). Prints,
    from the driver's StepTimer, the ms per lockstep propagation frame and
    per detection step (the host part, match_and_merge and the purge,
    apart), the device-to-host copies, per video objects, buckets and
    o_cap and the propagator's S, o_slot and o_cap over time, and the peak
    memory. Returns the launch counts and the exact pair's arguments of the
    last lockstep frame."""
    import dataclasses
    import deva_tpu_torch.inference.batched_detection as bd
    import deva_tpu_torch.inference.core as core_mod
    from deva_tpu_torch.detection_clips import detections
    from deva_tpu_torch.inference.core import InferenceCore
    gc.collect()
    masks, infos = detections(n_frames, h, w, BDET_SEGMENTS)
    videos = [synthetic_video(np.random.default_rng(41 + v), h, w, n_frames)
              for v in range(B7)]
    drv, args = det_driver("online")
    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    import eval_with_detections_batched_torch as bdrv
    net = copy.deepcopy(net_cpu).to(dev)
    cfg = drv.detection_config(args)
    cfg = dataclasses.replace(
        cfg, enable_long_term_count_usage=drv.count_usage(cfg, n_frames))
    timer = drv.StepTimer(dev)
    states = []
    for v in range(B7):
        core = InferenceCore(net, cfg)
        core.enabled_long_id()
        core.object_manager._rng = np.random.default_rng(5 + v)
        states.append(bdrv._VideoState(
            BdetReader(videos[v], masks, infos, f"bdet{v}"),
            core, DetSaver(core, lambda ti: ti % args.detection_every == 0)))
    history, blocks = [], []
    attach, step_block = bd.BatchedDetectionPropagator.attach, \
        bd.BatchedDetectionPropagator.step_block

    def attach_rec(bp, cores):
        attach(bp, cores)
        history.append((int(cores[0].curr_ti), [
            (c.object_manager.num_obj, len(c.memory.buckets), c.o_cap)
            for c in cores], bp.n_slots, bp.o_slot, bp.o_cap))

    bd.BatchedDetectionPropagator.attach = attach_rec
    bd.BatchedDetectionPropagator.step_block = block_timer(blocks, ak)
    merge = HostTimer(core_mod, "match_and_merge")
    purge = [HostTimer(vs.core.object_manager, "purge_inactive_objects")
             for vs in states]
    ids = HostTimer(bd, "argmax_ids")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ak.reset_launch_counts()
    tap = LastCallTap(ak, EXACT_PAIR)
    try:
        bdrv.run_group_online(net, cfg, states, args, "vipseg", timer)
        torch.cuda.synchronize()
        launches = dict(ak.LAUNCHES)
    finally:
        tap.restore()
        bd.BatchedDetectionPropagator.attach = attach
        bd.BatchedDetectionPropagator.step_block = step_block
        for t_ in [merge, ids] + purge:
            t_.restore()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    for vs in states:
        assert sorted(vs.saver.order) == list(range(n_frames)), \
            vs.saver.order
    n_det = len(range(0, n_frames, args.detection_every))
    assert blocks and all(f[k] == 1 for _, f in blocks for k in EXACT_PAIR)
    # one launch of each exact kernel per lockstep frame: every block frame
    # and every forward prediction (each detection frame but the first)
    assert launches["sim_topk"] == launches["topk_readout"] == \
        n_frames - 1, launches
    host_ms = (merge.ms + sum(p.ms for p in purge)) / n_det
    # the timer's steps alternate: a detection step (B7 frames), then its
    # span's one block (plan_block cuts none: the next write is due at the
    # next detection frame)
    assert len(timer.steps_ms) == 2 * n_det == 2 * len(blocks), \
        (len(timer.steps_ms), n_det, len(blocks))
    det_ms = timer.steps_ms[0::2]
    prop_ms = [ms for ms, _ in blocks[2:]]  # frames 10 onwards
    print(f"{smi_line()} phase 7b batched online detection fusion at "
          f"{h}x{w}, B={B7} videos, {n_frames} frames through eval_with_"
          f"detections_batched_torch.run_group_online, a detection every "
          f"{args.detection_every} ({BDET_SEGMENTS} segments), ms from its "
          f"StepTimer (CUDA events): propagation median "
          f"{statistics.median(prop_ms):.3f} ms per lockstep frame (frames "
          f"10+, mean {statistics.mean(prop_ms):.3f}; CUDA events around "
          f"step_block), {B7 * 1000 / statistics.median(prop_ms):.2f} "
          f"video-frames/s;"
          f" detection steps median {statistics.median(det_ms[2:]):.3f} ms "
          f"(10+; each " + ", ".join(f"{m:.1f}" for m in det_ms)
          + f"), of it on the host in match_and_merge and the purge "
          f"{host_ms:.3f} ms a detection step (all {B7} videos); "
          f"device-to-host copies {ids.calls} (forward_ids, uint8 id maps), "
          f"launches per lockstep propagation frame {blocks[-1][1]}, total "
          f"{launches}; peak allocated {peak:.1f} MiB", flush=True)
    print(f"phase 7b at each attach (frame, per video (objects, buckets, "
          f"o_cap), S, o_slot, o_cap): {history}", flush=True)
    return launches, {name: tap.last["path", name] for name in EXACT_PAIR}


def block_timer(record, ak=None):
    """A BatchedDetectionPropagator.step_block that appends the device ms
    per lockstep frame of each call (CUDA events) to `record`, and with
    `ak` the launches per lockstep frame as a second entry."""
    import deva_tpu_torch.inference.batched_detection as bd
    step_block = bd.BatchedDetectionPropagator.step_block

    def timed(bp, frames, end=False):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        before = dict(ak.LAUNCHES) if ak else None
        start.record()
        out = step_block(bp, frames, end)
        stop.record()
        stop.synchronize()
        k = out.shape[1]
        record.append(start.elapsed_time(stop) / k if ak is None else (
            start.elapsed_time(stop) / k,
            {n: (ak.LAUNCHES[n] - before[n]) / k for n in before}))
        return out
    return timed


class ConsolidationTap:
    """While installed, records each lockstep consolidation of every
    BatchedDetectionPropagator: (frame, the (video, slot) pairs whose
    long-term ring grew)."""

    def __init__(self):
        import deva_tpu_torch.inference.batched_detection as bd
        self.cls = bd.BatchedDetectionPropagator
        self.fn = fn = self.cls._maybe_consolidate
        self.triggered = []

        def recorded(bp):
            before = bp.lt_sizes.copy()
            fn(bp)
            grew = np.argwhere(bp.lt_sizes > before)
            if len(grew):
                self.triggered.append((int(bp.curr_ti.max()),
                                       [tuple(map(int, p)) for p in grew]))

        self.cls._maybe_consolidate = recorded

    def most_pairs(self) -> int:
        return max((len(p) for _, p in self.triggered), default=0)

    def restore(self):
        self.cls._maybe_consolidate = self.fn


class MidReader:
    """An in-memory mid-stream VOS video for eval_vos_batched_torch: its
    frames, and {frame: id mask} of the frames that carry masks."""

    def __init__(self, frames, masks, name):
        self.frames, self.masks, self.vid_name = frames, masks, name

    def __len__(self):
        return len(self.frames)

    def mask_frame_indices(self):
        return sorted(self.masks)

    def __getitem__(self, i):
        data = {"rgb": self.frames[i], "info": {
            "frame": f"{i:05d}.jpg", "save": True,
            "shape": self.frames[i].shape[:2], "need_resize": False}}
        if i in self.masks:
            data["mask"] = self.masks[i]
            data["valid_labels"] = np.asarray(
                [o for o in np.unique(self.masks[i]) if o])
        return data


# phase 7c: the frame of each video's third object's mask. Videos 0 and 1
# take it on a regular write (mem_every 5), so their bucket 0 stays on one
# cadence and consolidates in one lockstep call over both pairs; videos 2
# and 3 take it off the cadence, so the videos' writes diverge
MID_THIRD_AT = (10, 15, 16, 19)


def mid_videos(n_frames, h=H480, w=W480):
    """Phase 7c's videos: phase 5's frames, two objects at frame 0, and
    a third object's mask at frame MID_THIRD_AT[v] in video v (the
    YouTube-VOS convention: a later mask holds only the new object)."""
    sy, sx = h / 480, w / 854
    vids = []
    for v, seed in enumerate(PHASE5_SEEDS):
        frames = synthetic_video(np.random.default_rng(seed), h, w, n_frames)
        m0 = np.zeros((h, w), np.int64)
        m0[int(10 * sy):int(200 * sy), int(20 * sx):int(300 * sx)] = 1
        m0[int(250 * sy):int(470 * sy), int(400 * sx):int(800 * sx)] = 2
        third = np.zeros((h, w), np.int64)
        third[int(300 * sy):int(460 * sy),
              int((60 + 40 * v) * sx):int((300 + 40 * v) * sx)] = 3
        vids.append(MidReader(frames, {0: m0, MID_THIRD_AT[v]: third},
                              f"mid{v}"))
    return vids


def phase_batched_midstream(ak, apx, net_cpu, dev, n_frames: int = 60,
                            h: int = H480, w: int = W480):
    """Phase 7c: B7 mid-stream VOS videos at 480p, 60 frames, through
    eval_vos_batched_torch.run_group_midstream at the default
    InferenceConfig (long-term memory on), exact and then approx: each
    video's bucket 0 consolidates in lockstep over the triggered pairs
    (one call takes videos 0 and 1, whose cadences stay together:
    MID_THIRD_AT), so the [long-term ; working] slot rings run on the
    card. Each video is
    held to its own sequential card run (the driver's run_sequential):
    exact within phase 5's budgets (compare_single), approx within
    tests/test_batched_midstream.py's 5% of the pixels' labels (the
    sequential multi-bucket path takes the dense threshold form there).
    Outputs go to a checking save_frame (no PNG). Prints the triggered
    pairs and the ms per lockstep frame. Returns per method the launch
    counts and the kernels' arguments of the last lockstep frame."""
    import dataclasses
    import deva_tpu_torch.inference.batched_detection as bd
    from deva_tpu_torch.config import InferenceConfig
    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    import eval_vos_batched_torch as drv
    gc.collect()
    readers = mid_videos(n_frames, h, w)
    net = copy.deepcopy(net_cpu).to(dev)
    out = {}
    save_frame = drv.save_frame
    step_block = bd.BatchedDetectionPropagator.step_block
    try:
        for method in ("exact", "approx"):
            cfg = InferenceConfig(topk_method=method)
            got, ref = {}, {}

            def saver(store):
                def save(out_path, reader, info, prob, om):
                    assert prob.shape == (om.num_obj + 1, h, w), prob.shape
                    assert bool(torch.isfinite(prob).all())
                    store[reader.vid_name, info["frame"]] = prob.cpu()
                return save

            drv.save_frame = saver(ref)
            for r in readers:
                drv.run_sequential(net, cfg, r, "", True,
                                   drv.StepTimer(dev))
            consolidations = ConsolidationTap()
            blocks = []
            bd.BatchedDetectionPropagator.step_block = block_timer(blocks, ak)
            drv.save_frame = saver(got)
            timer = drv.StepTimer(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ak.reset_launch_counts()
            names = EXACT_PAIR if method == "exact" else \
                ("segmax", "denom_readout")
            tap = LastCallTap(ak if method == "exact" else apx, names)
            try:
                drv.run_group_midstream(net, cfg, readers, "", True, timer)
                torch.cuda.synchronize()
                launches = dict(ak.LAUNCHES)
            finally:
                tap.restore()
                consolidations.restore()
                bd.BatchedDetectionPropagator.step_block = step_block
            peak = torch.cuda.max_memory_allocated(dev) / 2**20
            assert sorted(got) == sorted(ref), "output frames differ"
            triggered = consolidations.triggered
            assert consolidations.most_pairs() >= 2, \
                f"{method}: no lockstep consolidation of two or more " \
                f"pairs: {triggered}"
            assert all(f[k] == (k in names) for _, f in blocks
                       for k in KERNELS), \
                f"{method}: not one launch of each kernel per lockstep frame"
            notes = []
            for v, r in enumerate(readers):
                keys = sorted(k for k in ref if k[0] == r.vid_name)[1:]
                g = [got[k] for k in keys]
                s = [ref[k] for k in keys]
                if method == "exact":
                    notes.append(compare_single(g, s, f"video {v}"))
                else:
                    cd = check_device()
                    labels = max(float((a.to(cd).argmax(0) !=
                                        b.to(cd).argmax(0)).float().mean())
                                 for a, b in zip(g, s))
                    assert labels <= 0.05, (method, v, labels)
                    notes.append(f"video {v} labels differ on at most "
                                 f"{labels:.2%}")
            print(f"{smi_line()} phase 7c mid-stream VOS at {h}x{w}, B={B7} "
                  f"videos, {n_frames} frames through eval_vos_batched_torch"
                  f".run_group_midstream, {method} (third objects at "
                  f"{list(MID_THIRD_AT)}): launches {launches}; "
                  f"consolidations (frame, triggered (video, slot) pairs) "
                  f"{triggered}, at most {consolidations.most_pairs()} "
                  f"pairs in one call; device time of its steps "
                  f"{timer.total_s * 1000:.1f} ms for {timer.frames} "
                  f"video-frames ({timer.frames / timer.total_s:.2f} "
                  f"video-frames/s), median "
                  f"{statistics.median(ms for ms, _ in blocks):.3f} ms per "
                  f"lockstep frame of step_block (one launch of each kernel "
                  f"of the method each); peak allocated {peak:.1f} MiB; "
                  f"against "
                  f"each video's sequential card run: " + "; ".join(notes),
                  flush=True)
            out[method] = (launches, {name: tap.last["path", name]
                                      for name in names})
    finally:
        drv.save_frame = save_frame
    return out


def pair_rows_exact(ak, apx, dev, suffix, last, launches, label,
                    videos=B7):
    """The exact pair on the batched arguments the path gave it (`last`:
    the last lockstep frame's sim_topk and topk_readout calls, one launch
    each for all P (video, slot) pairs): the batched launch bitwise P
    single launches on the pairs' slices, each pair held to the plain twins
    (check_pair_on_path); timed beside its plain twin, the library call
    (embedding_bag over all pairs' rows as one table) and cuBLAS's batched
    product, with the bound summed over the pairs' valid tokens (their
    share of the padded P x N printed). Also times what the path does
    around the launch for all pairs: the queries repeated per pair
    (`videos` videos' qk and qe) and the [long-term ; working] keys,
    shrinkage and validity concatenated for sim_topk. -> kernels-line
    rows."""
    qk, qe, mk, ms, valid, k = last["sim_topk"]
    gi, w, values = last["topk_readout"]
    segs = tuple(values) if isinstance(values, (tuple, list)) else (values,)
    p_, q, ck = qk.shape
    n = mk.shape[1]
    slots = p_ // videos
    per_video = (qk[::slots].contiguous(), qe[::slots].contiguous())
    assert torch.equal(per_video[0].repeat_interleave(slots, 0), qk)
    around = {"repeat": cuda_ms(lambda: [t.repeat_interleave(slots, 0)
                                         for t in per_video])}
    if len(segs) > 1:
        n_lt = segs[0].shape[1]
        parts = [(t[:, :n_lt].contiguous(), t[:, n_lt:].contiguous())
                 for t in (mk, ms, valid)]
        around["concatenate"] = cuda_ms(lambda: [torch.cat(pr, 1)
                                                 for pr in parts])
    gv, gx = ak.sim_topk(qk, qe, mk, ms, valid, k)
    out = ak.topk_readout(gi, w, values)
    err = dict.fromkeys(EXACT_PAIR, 0.0)
    share = dict(err)
    for p in range(p_):
        sv, sx = ak.sim_topk(qk[p], qe[p], mk[p], ms[p], valid[p], k)
        assert same_bits(gv[p], sv) and torch.equal(gx[p], sx), \
            f"{label}: sim_topk pair {p} not bitwise its single launch"
        vp = tuple(s[p] for s in segs) if len(segs) > 1 else segs[0][p]
        so = ak.topk_readout(gi[p], w[p], vp)
        assert same_bits(out[p], so), \
            f"{label}: topk_readout pair {p} not bitwise its single launch"
        e, f = check_pair_on_path(ak, (qk[p], qe[p], mk[p], ms[p], valid[p],
                                       k), (gi[p], w[p], vp),
                                  f"{label}, pair {p}")
        err = {nm: max(err[nm], e[nm]) for nm in EXACT_PAIR}
        share = {nm: max(share[nm], f[nm]) for nm in EXACT_PAIR}
    ring = torch.cat(segs, 1) if len(segs) > 1 else segs[0]
    c, kk = ring.shape[-1], gi.shape[-1]
    nbytes = lambda *ts: sum(t.numel() * t.element_size()
                             for t in ts if t is not None)
    rows = sum(int(torch.unique(gi[p]).numel()) for p in range(p_))
    # the similarity needs only each pair's valid tokens ([long-term ;
    # working]; an empty slot's one-token floor): its operations and key
    # bytes count those, the validity mask whole
    valid_share = int(valid.sum()) / (p_ * n)
    bounds = {
        "sim_topk": bound(4 * p_ * q * n * ck * valid_share,
                          nbytes(qk, qe, valid) + nbytes(mk, ms) * valid_share
                          + 8 * p_ * q * kk),
        "topk_readout": bound(2 * p_ * q * kk * c, nbytes(gi, w)
                              + rows * c * ring.element_size()
                              + 4 * p_ * q * c)}
    ops2 = apx.prep2(qk, qe, mk, ms, valid)
    flat = (gi.long() + n * torch.arange(p_, device=dev)[:, None, None]
            ).reshape(p_ * q, kk)
    table = ring.reshape(p_ * n, c)
    t = {"sim_topk": cuda_ms(lambda: ak.sim_topk(qk, qe, mk, ms, valid, k)),
         "sim_topk_plain": cuda_ms(lambda: ak.sim_topk_plain(
             qk, qe, mk, ms, valid, k), iters=3),
         "sim_topk_product": cuda_ms(lambda: torch.bmm(
             ops2.qcat, ops2.mcat.transpose(1, 2))),
         "topk_readout": cuda_ms(lambda: ak.topk_readout(gi, w, values)),
         "topk_readout_plain": cuda_ms(lambda: ak.topk_readout_plain(
             gi, w, values), iters=3),
         "topk_readout_library": cuda_ms(
             lambda: torch.nn.functional.embedding_bag(
                 flat, table, mode="sum",
                 per_sample_weights=w.reshape(p_ * q, kk)))}
    shape = (f"P={p_} pairs, Q={q} N={n} C={c} ({len(segs)} segment"
             f"{'s' if len(segs) > 1 else ''}), {valid_share:.4f} of the "
             f"P x N tokens valid")
    print(f"{smi_line()} phase 7 kernels {suffix}, {label}: {shape}; the "
          f"batched launch bitwise {p_} single launches, each pair held to "
          f"the plain twins, max |kernel - twin| "
          + ", ".join(f"{nm} {v:.3g}" for nm, v in err.items())
          + " (at most " + ", ".join(f"{nm} {v:.3g}" for nm, v in
                                      share.items())
          + " of the f32 bound); ms " + ", ".join(
              f"{nm} {v:.4f}" for nm, v in t.items()) + "; bound ms "
          + ", ".join(f"{nm} {b:.4f} ({by})" for nm, (b, by) in
                      bounds.items()) + f"; launches {launches}; around the "
          f"launch, ms per lockstep frame: queries repeated per pair "
          f"({videos} videos x {slots} slots) {around['repeat']:.4f}"
          + (f", [long-term ; working] keys, shrinkage and validity "
             f"concatenated {around['concatenate']:.4f}"
             if "concatenate" in around else ""), flush=True)
    rows_out = []
    for name in EXACT_PAIR:
        src, tpu = KERNELS[name]
        b_ms, b_by = bounds[name]
        rows_out.append({
            "name": name + suffix, "ring_dtype": str(ring.dtype)[6:],
            "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "shape": shape,
            "valid_share": valid_share,
            "max_abs_err": err[name], "ms": t[name],
            "plain_ms": t[name + "_plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t.get(name + "_library"),
            "product_ms": t.get(name + "_product")})
    return rows_out


def pair_rows_approx(apx, dev, suffix, last, launches, label):
    """The approx pair on the batched arguments the path gave it (`last`:
    the last lockstep frame's segmax and denom_readout calls): segmax
    within the f32 bound of the similarity's terms (gamma(Kc + 2) times
    their absolute scale, as check_pair_on_path holds sim_topk) of its
    plain twin, with the same finite pattern; denom_readout's rmax and th
    bitwise `threshold` of the kernel's group maxima, and its out and usage
    within 1e-4 (relative to sum aff |V|, and absolute) of the twin at a
    threshold that no similarity lies near (gap_threshold). Timed beside
    the twins and cuBLAS's product; bounds as phase 1b's, summed over the
    pairs' valid tokens (their share of the padded P x N printed). ->
    kernels-line rows."""
    ops, geom = last["segmax"]
    _, _, seg, v2, k = last["denom_readout"][:5]
    p_, q, kc = ops.qcat.shape
    n, c = v2.shape[1:]
    ref = apx.segmax_plain(ops, geom)
    got = apx.segmax(ops, geom)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin), f"{label}: segmax -inf"
    sub = ops.bsq[..., :, None] if ops.bsq is not None else \
        ops.msq[..., None, :]
    scale = ((ops.qcat.abs() @ ops.mcat.abs().transpose(1, 2) + sub.abs())
             * ops.msv.abs()[:, None, :]).amax(-1, keepdim=True)
    tol = 2 * gamma(kc + 2) * scale + 1e-5
    d_seg = torch.where(fin, (got - ref).abs(), 0.0)
    assert bool((d_seg <= tol).all()), \
        f"{label}: segmax off its twin by {d_seg.max().item():.3g}"
    out, usage, rmax, th = apx.denom_readout(ops, geom, got, v2, k)
    rmax_t, th_t = apx.threshold(got, k)
    assert same_bits(rmax, rmax_t) and same_bits(th, th_t), \
        f"{label}: denom_readout's rmax or th is not threshold()'s"
    sim = apx.similarity2_plain(ops)
    th_gap = apx.gap_threshold(sim, th, float(tol.max()))
    og, ug, _, _ = apx.denom_readout(ops, geom, got, v2, k, th_gap)
    rg, rug = apx.denom_readout_plain(ops, geom, got, rmax, th_gap, v2)
    aff = apx._support_weights(sim, rmax, th_gap)
    mag = aff @ v2.float().abs()
    d_out = (og - rg).abs()
    assert bool((d_out <= 1e-4 * mag + 1e-5).all()), \
        f"{label}: denom_readout off its twin by {d_out.max().item():.3g}"
    torch.testing.assert_close(ug, rug, rtol=1e-4, atol=1e-4)
    support = (sim >= th) & torch.isfinite(sim)
    entries, rows = int(support.sum()), int(support.any(-2).sum())
    del sim, aff, mag, support
    isz = v2.element_size()
    # the similarity needs only each pair's valid tokens of the
    # concatenated ring: segmax's operations and token bytes count those
    nv = int(ops.valid.sum()) if ops.valid is not None else p_ * n
    valid_share = nv / (p_ * n)
    bounds = {
        "segmax": bound(2 * q * kc * nv, p_ * (
            4 * (q * kc + q) + n + 4 * q * geom.nseg) + 4 * nv * (kc + 1)),
        "denom_readout": bound(2 * entries * (kc + c), p_ * 4 * q * (
            geom.nseg + kc + 1 + c) + 4 * nv + rows * (
            isz * c + 4 * kc + 4 + 1))}
    err = {"segmax": d_seg.max().item(),
           "denom_readout": max(d_out.max().item(),
                                (ug - rug).abs().max().item())}
    t = {"segmax": cuda_ms(lambda: apx.segmax(ops, geom)),
         "segmax_plain": cuda_ms(lambda: apx.segmax_plain(ops, geom),
                                 iters=3),
         "segmax_product": cuda_ms(lambda: torch.bmm(
             ops.qcat, ops.mcat.transpose(1, 2))),
         "denom_readout": cuda_ms(lambda: apx.denom_readout(
             ops, geom, got, v2, k)),
         "denom_readout_plain": cuda_ms(lambda: apx._denom_readout_twin(
             ops, geom, got, v2, k), iters=3)}
    shape = (f"P={p_} pairs, Q={q} N={n} C={c} (one concatenated ring), "
             f"{valid_share:.4f} of the P x N tokens valid")
    print(f"{smi_line()} phase 7 kernels {suffix}, {label}: {shape}; "
          f"max |kernel - twin| " + ", ".join(
              f"{nm} {v:.3g}" for nm, v in err.items()) + "; ms "
          + ", ".join(f"{nm} {v:.4f}" for nm, v in t.items()) + "; bound ms "
          + ", ".join(f"{nm} {b:.4f} ({by})" for nm, (b, by) in
                      bounds.items()) + f"; launches {launches}",
          flush=True)
    rows_out = []
    for name in ("segmax", "denom_readout"):
        src, tpu = KERNELS[name]
        b_ms, b_by = bounds[name]
        rows_out.append({
            "name": name + suffix, "ring_dtype": str(v2.dtype)[6:],
            "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "shape": shape,
            "valid_share": valid_share,
            "max_abs_err": err[name], "ms": t[name],
            "plain_ms": t[name + "_plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "product_ms": t.get(name + "_product")})
    return rows_out


# --------------------------------------------------------------------------
# phase 8: the VOS driver (flips, score maps, the YouTube-VOS layout) and
# the referring and saliency drivers (soft-mask bidirectional propagation)
# --------------------------------------------------------------------------

# phase 6a's small_clip configuration, as the drivers' flags
SMALL_FLAGS = ["--mem_every", "2", "--top_k", "8", "--disable_long_term"]
# 8a's frames are read as if resized from this shape, so that the VOS
# driver resizes its probabilities before it mirrors them back
SMALL_SHAPE = (80, 120)
# 8c: the scores of the referring clip's sampled frames (num_voting_frames
# 5 over 60 frames samples 6, 18, 30, 42 and 54). The highest picks frame
# 6: the backward pass takes 7 frames and the forward pass 54, which write
# the 10 memory frames that start long-term consolidation
REF_SCORES = (0.9, 0.5, 0.6, 0.4, 0.3)
REF_VOTING = 5


def drivers():
    """eval_vos_torch, eval_ref_davis_torch and eval_saliency_torch."""
    sys.path.insert(0, os.path.join(ROOT, "evaluation"))
    import eval_ref_davis_torch
    import eval_saliency_torch
    import eval_vos_torch
    return eval_vos_torch, eval_ref_davis_torch, eval_saliency_torch


class VosReader:
    """An in-memory video for eval_vos_torch.run_video, read as
    VideoReader's items are: frames [H, W, 3] f32, masks {ti: (id mask,
    labels)} on the frames that carry one; shape, if given, the frames'
    shape before a resize (need_resize); to_save the frames written (None:
    every frame)."""

    def __init__(self, frames, masks, name, shape=None, to_save=None):
        self.frames, self.masks, self.vid_name = frames, masks, name
        self.shape, self.to_save = shape, to_save

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        data = {"rgb": self.frames[i], "info": {
            "frame": f"{i:05d}.jpg",
            "shape": self.shape or self.frames[i].shape[:2],
            "need_resize": self.shape is not None,
            "save": self.to_save is None or i in self.to_save}}
        if i in self.masks:
            data["mask"], data["valid_labels"] = self.masks[i]
        return data

    def get_palette(self):
        return None


class VosSaver:
    """run_video's saver for phase 8: writes nothing; keeps each written
    frame's mask and score map by frame index, and the backward map."""

    def __init__(self):
        self.masks, self.scores, self.backward = {}, {}, None

    def save_mask(self, out_mask, frame):
        self.masks[int(frame[:5])] = np.array(out_mask)

    def save_scores(self, scores, frame):
        self.scores[int(frame[:5])] = np.array(scores)

    def save_backward(self, mapping):
        self.backward = dict(mapping)


class StepTap:
    """The probabilities that a core's step and step_chunk calls return, on
    the host, in frame order (a step that step_chunk makes is kept once)."""

    def __init__(self, core):
        self.probs, self.inside = [], 0
        step, chunk = core.step, core.step_chunk

        def tapped_step(*args, **kwargs):
            prob = step(*args, **kwargs)
            if not self.inside:
                self.probs.append(prob.cpu())
            return prob

        def tapped_chunk(*args, **kwargs):
            self.inside += 1
            try:
                probs = chunk(*args, **kwargs)
            finally:
                self.inside -= 1
            self.probs += [prob.cpu() for prob in probs]
            return probs

        core.step, core.step_chunk = tapped_step, tapped_chunk


def vos_run(drv, net, dev, reader, flags):
    """One video through eval_vos_torch.run_video, as its main() runs one:
    the flags through its parser, the processor made as main makes it,
    timed by its StepTimer. -> (saver, probabilities, timer, processor)."""
    import dataclasses
    from deva_tpu_torch.inference.core import InferenceCore
    args = drv.get_args(flags + ["--device", dev.type])
    cfg = drv.base_config(args)
    core = InferenceCore(net, dataclasses.replace(
        cfg, enable_long_term_count_usage=drv.count_usage(cfg, len(reader))),
        device=dev)
    tap, saver, timer = StepTap(core), VosSaver(), drv.StepTimer(dev)
    drv.run_video(core, reader, args, saver, timer)
    return saver, tap.probs, timer, core


def final_probs(drv, prob, shape, flip):
    """The driver's output probabilities of a step's: resized to shape,
    then mirrored back under --flip (eval_vos_torch.run_video's emit)."""
    out = drv.resize_prob_to(prob.numpy(), shape)
    return out[..., ::-1] if flip else out


def jf_floor(ours, ref):
    """The least per-object mean J and F of the card's label maps scored
    against the CPU's by deva_tpu_torch/metrics/jf.py, over every frame."""
    from deva_tpu_torch.metrics import jf
    res = jf.evaluate_masks(ours, ref, skip_first_last=False)
    return (min(float(v.mean()) for v in res.j_per_object.values()),
            min(float(v.mean()) for v in res.f_per_object.values()))


def compare_vos(drv, cpu, gpu, reader, flip, label, report):
    """A card run of run_video against the CPU run: the probabilities of
    every step within DET_TOL; score maps within 1 (1/255: the uint8 cast
    truncates); backward maps equal; the written masks equal but where
    the CPU's final probabilities have their top two within 2 DET_TOL (the
    card's within DET_TOL of them may have another argmax there); J and F
    of the card's masks against the CPU's at least 0.99."""
    (s_cpu, p_cpu, _, _), (s_gpu, p_gpu, _, _) = cpu, gpu
    assert len(p_cpu) == len(p_gpu) == len(reader), (len(p_cpu), len(p_gpu))
    diff = max((a - b).abs().max().item() for a, b in zip(p_cpu, p_gpu))
    assert diff <= DET_TOL, f"{label}: |dprob| {diff}"
    assert s_cpu.backward == s_gpu.backward and s_cpu.backward, \
        (s_cpu.backward, s_gpu.backward)
    assert sorted(s_cpu.masks) == sorted(s_gpu.masks) == \
        sorted(s_cpu.scores) == sorted(s_gpu.scores), label
    d_scores = max(int(np.abs(s_cpu.scores[t].astype(int) -
                              s_gpu.scores[t].astype(int)).max())
                   for t in s_cpu.scores)
    assert d_scores <= 1, f"{label}: score maps off by {d_scores}"
    moved = 0
    for t, mask in s_cpu.masks.items():
        shape = reader[t]["info"]["shape"]
        top2 = np.sort(final_probs(drv, p_cpu[t], shape, flip), 0)[-2:]
        near = top2[1] - top2[0] <= 2 * DET_TOL
        off = mask != s_gpu.masks[t]
        assert not (off & ~near).any(), f"{label} frame {t}: mask differs " \
            "away from a near-tie"
        moved = max(moved, float(off.mean()))
    frames = sorted(s_cpu.masks)
    j, f = jf_floor([s_gpu.masks[t] for t in frames],
                    [s_cpu.masks[t] for t in frames])
    assert j >= 0.99 and f >= 0.99, f"{label}: J {j}, F {f}"
    report.append(f"{label}: |dprob| {diff:.3g}, score maps within "
                  f"{d_scores}/255, backward {s_gpu.backward}, masks differ "
                  f"on at most {moved:.4%} of a frame (near-ties only), J "
                  f"{j:.4f} F {f:.4f} over frames {frames}")


class SoftMaskVideos:
    """An in-memory meta-dataset of one video for eval_ref_davis_torch's
    consensus and run_bidirectional (and eval_saliency_torch.run_video),
    read as ReferringDAVISTestDataset's VideoReaders read it: frames [H,
    W, 3] f32, soft masks [1, H, W] f32, scores by frame or None."""

    def __init__(self, frames, masks, scores=None):
        self.frames, self.masks, self.scores = frames, masks, scores

    def _reader(self, idx, with_mask):
        frames, masks = self.frames, self.masks

        class Reader:
            def __len__(self):
                return len(idx)

            def __getitem__(self, i):
                t = idx[i]
                data = {"rgb": frames[t], "info": {
                    "frame": f"{t:05d}.jpg", "shape": frames[t].shape[:2],
                    "need_resize": False, "save": True, "time_index": t}}
                if with_mask:
                    data["mask"] = masks[t]
                return data
        return Reader()

    def get_offline_sampled_frames(self, vid, num_sampled_frames):
        return self._reader(sampled_frames(len(self.frames),
                                           num_sampled_frames), True)

    def get_partial_video_loader(self, vid, *, start, end, reverse):
        idx = list(range(len(self.frames)))
        if start >= 0:
            idx = idx[start:end] if end >= 0 else idx[start:]
        elif end >= 0:
            idx = idx[:end]
        return self._reader(idx[::-1] if reverse else idx, False)

    def get_scores(self, vid):
        return {f"{t:05d}": s for t, s in self.scores.items()}


def sampled_frames(n: int, num_sampled_frames: int) -> list:
    """The frames that VideoReader(num_sampled_frames=...) reads of n."""
    m = min(num_sampled_frames, n)
    return [i * n // m + n // (2 * m) for i in range(m)]


def soft_masks(h, w, t, value):
    """t soft masks [1, h, w]: a box of `value` that moves down a row each
    frame (tests/test_ref_drivers_smoke.py's clip, at any size)."""
    out = []
    for i in range(t):
        m = np.zeros((1, h, w), np.float32)
        m[0, h // 6 + i:h * 5 // 8 + i, w // 5:w * 5 // 8] = value
        out.append(m)
    return out


def bidirectional(drv_ref, drv_sal, net, dev, cfg, meta, n_voting,
                  saliency, save=None, timer=None):
    """The referring driver's video (consensus with scores, then
    run_bidirectional) or the saliency protocol's (eval_saliency_torch.
    run_video); save(processor, prob, info), if given, runs after each
    step. -> (keyframe, [(pass, time index, probabilities on the host)],
    the consensus core, the timer, the two passes' cores)."""
    from deva_tpu_torch.inference.core import InferenceCore
    store_core = InferenceCore(net, cfg, device=dev)
    timer = timer or drv_ref.StepTimer(dev)
    record, cores = [], []

    def save_fn(processor, prob, info):
        if not cores or cores[-1] is not processor:
            cores.append(processor)
        record.append((len(cores) - 1, info["time_index"], prob.cpu()))
        if save is not None:
            save(processor, prob, info)

    if saliency:
        _, keyframe = drv_sal.run_video(store_core, meta, "soft", n_voting,
                                        save_fn, timer)
    else:
        _, keyframe, projected = drv_ref.consensus(
            store_core, meta, "soft", n_voting, meta.get_scores("soft"),
            timer)
        drv_ref.run_bidirectional(store_core, meta, "soft", keyframe,
                                  projected, save_fn, timer)
    return keyframe, record, store_core, timer, cores


def compare_bidirectional(cpu, gpu, label, report):
    """The card's bidirectional run against the CPU's: the same keyframe
    and frames; probabilities within DET_TOL; the binary masks (prob[1] >
    prob[0]) differ only where both runs' prob[1] - prob[0] lie within
    DET_TOL of 0; J and F of the card's final masks against the CPU's at
    least 0.99."""
    (k_cpu, r_cpu, *_), (k_gpu, r_gpu, *_) = cpu, gpu
    assert k_cpu == k_gpu, f"{label}: keyframe {k_gpu} on the card, " \
        f"{k_cpu} on the CPU"
    assert [r[:2] for r in r_cpu] == [r[:2] for r in r_gpu], label
    diff, moved, final = 0.0, 0.0, {}
    for (_, t, a), (_, _, b) in zip(r_cpu, r_gpu):
        diff = max(diff, (a - b).abs().max().item())
        ma, mb = a[1] - a[0], b[1] - b[0]
        off = (ma > 0) != (mb > 0)
        assert not bool((off & ~((ma.abs() <= DET_TOL) &
                                 (mb.abs() <= DET_TOL))).any()), \
            f"{label} frame {t}: binary mask differs away from 0.5"
        moved = max(moved, off.float().mean().item())
        final[t] = ((ma > 0).numpy(), (mb > 0).numpy())  # the last pass's
    assert diff <= DET_TOL, f"{label}: |dprob| {diff}"
    frames = sorted(final)
    j, f = jf_floor([final[t][1].astype(np.uint8) for t in frames],
                    [final[t][0].astype(np.uint8) for t in frames])
    assert j >= 0.99 and f >= 0.99, f"{label}: J {j}, F {f}"
    report.append(f"{label}: keyframe {k_gpu}, {len(r_gpu)} steps, |dprob| "
                  f"{diff:.3g}, binary masks differ on at most {moved:.4%} "
                  f"of a frame (both margins within {DET_TOL:g}), J {j:.4f} "
                  f"F {f:.4f}")


def phase_drivers_parity(ak, net_cpu, dev):
    """Phase 8a: the drivers on the card against the CPU at 64x96
    (detection_clips.small_clip's frames, phase 6a's configuration:
    mem_every 2, top_k 8, long-term off, given as the drivers' flags). Through
    eval_vos_torch.run_video: the generic layout with --flip --save_scores
    (exact, then --topk_method approx --chunk 2), the frames read as if
    resized from SMALL_SHAPE; a YouTube-VOS-style reader whose second
    object appears at frame 3 in its own mask, every other frame written,
    with --save_scores. Through eval_ref_davis_torch (consensus with
    rising scores, run_bidirectional) and eval_saliency_torch.run_video: 6
    frames of soft masks at 0.9, far from the 0.5 of a claimed pixel
    (compare_vos, compare_bidirectional). The kernels of each method launch
    on the card."""
    from deva_tpu_torch.detection_clips import small_clip
    drv, ref, sal = drivers()
    frames, masks, _ = small_clip(np.random.default_rng(4), 8)
    net_gpu = copy.deepcopy(net_cpu).to(dev)
    cpu = torch.device("cpu")
    generic = VosReader(frames, {0: (masks[0], np.array([1, 2]))}, "g",
                        shape=SMALL_SHAPE)
    youtube = VosReader(frames, {
        0: ((masks[0] == 1).astype(np.int64), np.array([1])),
        3: (np.where(masks[3] == 3, 2, 0), np.array([2]))}, "y",
        to_save=set(range(0, 8, 2)))
    report = []
    for label, reader, flags, used in (
            ("G --flip --save_scores", generic,
             ["--flip", "--save_scores"], EXACT_PAIR),
            ("G --flip --save_scores --topk_method approx --chunk 2",
             generic, ["--flip", "--save_scores", "--topk_method", "approx",
                       "--chunk", "2"], ("segmax", "denom_readout")),
            ("Y, object 2 from frame 3, --save_scores", youtube,
             ["--save_scores"], EXACT_PAIR)):
        run_cpu = vos_run(drv, net_cpu, cpu, reader, SMALL_FLAGS + flags)
        ak.reset_launch_counts()
        run_gpu = vos_run(drv, net_gpu, dev, reader, SMALL_FLAGS + flags)
        torch.cuda.synchronize()
        assert all(ak.LAUNCHES[k] > 0 for k in used), (label, ak.LAUNCHES)
        compare_vos(drv, run_cpu, run_gpu, reader, "--flip" in flags,
                    f"{label} (launches {dict(ak.LAUNCHES)})", report)
    assert len(run_gpu[3].memory.buckets) == 2, \
        "the object of frame 3 did not open a second bucket"

    soft = soft_masks(64, 96, 6, 0.9)
    meta = SoftMaskVideos(frames[:6], soft,
                          {t: 0.5 + 0.05 * t for t in range(6)})
    args = ref.make_parser().parse_args(SMALL_FLAGS)
    cfg = ref.base_config(args)
    for label, saliency in (("referring (consensus with scores)", False),
                            ("saliency (consensus without scores)", True)):
        run_cpu = bidirectional(ref, sal, net_cpu, cpu, cfg, meta, 3,
                                saliency)
        ak.reset_launch_counts()
        run_gpu = bidirectional(ref, sal, net_gpu, dev, cfg, meta, 3,
                                saliency)
        torch.cuda.synchronize()
        assert all(ak.LAUNCHES[k] > 0 for k in EXACT_PAIR), ak.LAUNCHES
        compare_bidirectional(run_cpu, run_gpu, f"{label} (launches "
                              f"{dict(ak.LAUNCHES)})", report)
    print("phase 8a drivers, card vs cpu at 64x96:\n  "
          + "\n  ".join(report), flush=True)


def phase_vos_driver(ak, net_cpu, dev, n_frames: int = 60, h: int = H480,
                     w: int = W480):
    """Phase 8b: eval_vos_torch.run_video with --flip --save_scores at 480p
    on phase 3's frames, mask and weights, at the driver's defaults: exact
    per frame (sim_topk and topk_readout on every propagated frame), then
    approx with --chunk 5 (segmax and denom_readout on every propagated
    frame). Each run again without --flip on the mirrored clip: the same
    steps, bitwise, and the flip run's score maps and masks are the
    mirrored run's mirrored back. Prints ms/frame from the driver's
    StepTimer (CUDA events; frames 10 onwards) and the peak memory."""
    drv, _, _ = drivers()
    frames = synthetic_video(np.random.default_rng(11), h, w, n_frames)
    mask = two_object_mask(h, w, (60, 300), (330, 520), (260, 450),
                           (250, 620)) if h == H480 else \
        two_object_mask(h, w, (8, 30), (10, 40), (30, 50), (45, 80))
    mirrored = [f[:, ::-1].copy() for f in frames]
    net = copy.deepcopy(net_cpu).to(dev)
    used = {"exact": EXACT_PAIR, "approx": ("segmax", "denom_readout")}
    for method, flags in (("exact", []),
                          ("approx", ["--topk_method", "approx",
                                      "--chunk", "5"])):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ak.reset_launch_counts()
        saver, probs, timer, _ = vos_run(
            drv, net, dev, VosReader(frames, {0: (mask, np.array([1, 2]))},
                                     "v480"),
            ["--flip", "--save_scores"] + flags)
        torch.cuda.synchronize()
        launches = dict(ak.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        assert all(launches[k] >= n_frames - 1 for k in used[method]), \
            launches
        assert len(saver.scores) == n_frames and saver.backward == \
            {1: 1, 2: 2}, (len(saver.scores), saver.backward)
        for prob in probs:
            assert bool(torch.isfinite(prob).all())
        # per frame: a step each (exact) or a chunk's time shared by its
        # frames (approx); frame 0 steps alone
        sizes = [1] + ([1] * (n_frames - 1) if method == "exact" else
                       [min(5, n_frames - s) for s in range(1, n_frames, 5)])
        per_frame = [ms / k for ms, k in zip(timer.steps_ms, sizes)
                     for _ in range(k)]
        steady = per_frame[10:]
        m_saver, m_probs, _, _ = vos_run(
            drv, net, dev, VosReader(mirrored, {
                0: (mask[:, ::-1].copy(), np.array([1, 2]))}, "m480"),
            ["--save_scores"] + flags)
        same = all(torch.equal(a, b) for a, b in zip(probs, m_probs))
        assert same and len(probs) == len(m_probs), \
            f"{method}: the flip run's steps are not the mirrored run's"
        for t in range(n_frames):
            assert np.array_equal(saver.scores[t],
                                  m_saver.scores[t][..., ::-1]), t
            assert np.array_equal(saver.masks[t],
                                  m_saver.masks[t][..., ::-1]), t
        print(f"phase 8b eval_vos_torch.run_video --flip --save_scores "
              f"{' '.join(flags) or '(exact, per frame)'} at {h}x{w}, "
              f"{n_frames} frames: ms/frame from its StepTimer median "
              f"{statistics.median(steady):.3f} (frames 10+, mean "
              f"{statistics.mean(steady):.3f}, max {max(steady):.3f}; first "
              f"frame {per_frame[0]:.1f}); launches {launches}; peak "
              f"allocated {peak:.1f} MiB; the steps bitwise those of the "
              f"run on the mirrored clip, score maps and masks its mirror "
              f"images", flush=True)


def phase_ref_driver(ak, net_cpu, dev, n_frames: int = 60,
                     h: int = H480, w: int = W480):
    """Phase 8c: eval_ref_davis_torch at 480p: consensus over
    REF_VOTING sampled frames with REF_SCORES, then run_bidirectional, at
    the default InferenceConfig with one soft-mask object (0.9) on 60
    synthetic frames; the keyframe falls at frame 6, so the backward pass
    takes 7 frames and the forward pass 54, whose 10th memory frame starts
    long-term consolidation. Prints the ms of the consensus and per
    propagated frame in each direction (the driver's StepTimer), the
    keyframe, the image feature store at the end (the passes keep every
    frame's features: delete_buffer=False) and the peak memory. Returns
    the exact pair's calls on the last frame (a composed match_memory over
    [long-term ; working]) and in the consensus' last alignment, and the
    launch counts, for the .ref rows."""
    _, ref, sal = drivers()
    gc.collect()
    frames = synthetic_video(np.random.default_rng(41), h, w, n_frames)
    scores = dict(zip(sampled_frames(n_frames, REF_VOTING), REF_SCORES))
    meta = SoftMaskVideos(frames, soft_masks(h, w, n_frames, 0.9), scores)
    cfg = ref.base_config(ref.make_parser().parse_args([]))
    net = copy.deepcopy(net_cpu).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ak.reset_launch_counts()
    tap = KernelTap(ak)
    align_runs, aligned = [], dict.fromkeys(EXACT_PAIR, 0)
    from deva_tpu_torch.inference import core as core_mod
    real_align = core_mod.InferenceCore.spatial_alignment

    def tapped_align(self, *a):
        before = dict(ak.LAUNCHES)
        tap.tag, tap.calls["align"] = "align", []
        try:
            return real_align(self, *a)
        finally:
            tap.tag = "memory"
            align_runs.append({k: ak.LAUNCHES[k] - before[k]
                               for k in EXACT_PAIR})

    core_mod.InferenceCore.spatial_alignment = tapped_align
    try:
        keyframe, record, store_core, timer, cores = bidirectional(
            ref, sal, net, dev, cfg, meta, REF_VOTING, False,
            save=lambda *a: tap.frame())
    finally:
        core_mod.InferenceCore.spatial_alignment = real_align
        tap.restore()
    torch.cuda.synchronize()
    launches = dict(ak.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    store = store_core.image_feature_store
    store_mib = sum(t.numel() * t.element_size() for feats in
                    store._store.values() for t in _tensors(feats)) / 2**20
    backward, forward = cores
    lt = forward.memory.long_buckets.get(0)
    assert keyframe == 6, keyframe
    assert [p for p, *_ in record] == [0] * 7 + [1] * (n_frames - 6)
    assert lt is not None and lt.size > 0, \
        "the forward pass never consolidated"
    assert len(store) == n_frames, len(store)
    assert all(r == dict.fromkeys(EXACT_PAIR, 1) for r in align_runs), \
        align_runs
    for _, t, prob in record:
        assert prob.shape == (2, h, w) and bool(torch.isfinite(prob).all())
        torch.testing.assert_close(prob.sum(0), torch.ones_like(prob[0]),
                                   rtol=0, atol=1e-4)
    for k in EXACT_PAIR:
        aligned[k] = sum(r[k] for r in align_runs)
    steps = timer.steps_ms
    print(f"phase 8c eval_ref_davis_torch at {h}x{w}, {n_frames} frames, "
          f"one soft-mask object, {REF_VOTING} voting frames "
          f"({sorted(scores)}, scores {REF_SCORES}): keyframe {keyframe}; "
          f"consensus {steps[0]:.3f} ms ({len(align_runs)} alignments); "
          f"ms per propagated frame (StepTimer, CUDA events) backward "
          f"median {statistics.median(steps[2:8]):.3f} (7 frames, the "
          f"keyframe's {steps[1]:.1f}), forward median "
          f"{statistics.median(steps[9:]):.3f} ({n_frames - 6} frames, the "
          f"keyframe's {steps[8]:.1f}); long-term tokens at the end "
          f"{lt.size}/{lt.cap}; image feature store {len(store)} frames, "
          f"{store_mib:.1f} MiB; launches {launches}; peak allocated "
          f"{peak:.1f} MiB (with --topk_method approx these composed steps "
          f"take the dense threshold form, no kernel, as deva_tpu's do)",
          flush=True)
    memory_launches = {k: launches[k] - aligned[k] for k in EXACT_PAIR}
    return (tap.last_frame, memory_launches, tap.calls["align"], aligned)


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    return [t for item in x for t in _tensors(item)]


def phase8(ak, apx, net_cpu, dev) -> list:
    """Phases 8a-8c; -> the kernels line's .ref and .ref.align rows."""
    phase_drivers_parity(ak, net_cpu, dev)
    phase_vos_driver(ak, net_cpu, dev)
    last, launches, align_calls, aligned = phase_ref_driver(ak, net_cpu,
                                                            dev)
    rows = det_kernel_rows(ak, apx, dev, ".ref", last, launches,
                           "8c's last frame (composed match_memory)")
    del last
    rows += det_kernel_rows(ak, apx, dev, ".ref.align", align_calls,
                            aligned, "8c's last consensus alignment")
    return rows


# --------------------------------------------------------------------------
# phase 9: the detector layer (MobileSAM, Light-HQ-SAM) and the two demos
# --------------------------------------------------------------------------

# 9b's and 9c's clip length
DEMO_FRAMES = 30
# 9c's input frames: the example clip's 1280x720, so that the frame resize
# to --size 480 (get_input_frame_for_deva) and the detections' resize run
# on the measured path (9b's 854x480 frames need neither)
H720, W720 = 720, 1280
# the demos' --size (their default): the shorter side the core works at
DEMO_SIZE = 480
# 9b's SAM_NUM_POINTS_PER_SIDE: 64 prompts, one decoder batch of the
# default 64 (the default 64 per side would push 4096 masks through the
# O(n^2) numpy _mask_nms on every detection frame)
DEMO_POINTS = 8
# the rectangles that move over the demo clips; 9c's detect() finds them
# by colour (the background never reaches these values)
RECT_COLORS = ((255, 24, 24), (24, 255, 24), (24, 24, 255))
# 9a's processor clip (7 frames of 64x96) runs at
# tests/test_ext_processors.py's configuration
PROC_CFG = dict(mem_every=2, top_k=8, enable_long_term=False,
                detection_every=3, num_voting_frames=2,
                max_missed_detection_count=3, size=-1)


def demo_clip(h, w, t, seed=41):
    """t uint8 RGB frames [h, w, 3]: a smooth seeded background (8x8
    blocks, a little noise per frame) with three rectangles of RECT_COLORS
    moving over it (2 pixels a frame); and their boxes (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, (-(-h // 8), -(-w // 8), 3))
    bg = base.repeat(8, 0).repeat(8, 1)[:h, :w]
    frames, boxes = [], []
    for ti in range(t):
        img = np.clip(bg + rng.integers(-6, 7, bg.shape), 0, 255) \
            .astype(np.uint8)
        frame_boxes = []
        for k, color in enumerate(RECT_COLORS):
            bh, bw = h // (3 + k), w // (4 + k)
            y0 = int((h - bh) * (0.15 + 0.3 * k))
            x0 = min(w - bw, int((w - bw) * (0.05 + 0.3 * k)) + 2 * ti)
            img[y0:y0 + bh, x0:x0 + bw] = color
            frame_boxes.append([x0, y0, x0 + bw, y0 + bh])
        frames.append(img)
        boxes.append(np.asarray(frame_boxes, np.float32))
    return frames, boxes


class RectDetector:
    """A text detector for demo_clip's frames: detect() returns the boxes
    of the RECT_COLORS rectangles it finds (scores 0.9, 0.8, 0.7, class
    ids 0-2); masks_for_boxes is the mask source's (Light-HQ-SAM in 9c),
    or the boxes filled without one. generate() (the automatic protocol)
    gives the box masks with IoUs 0.95, 0.9, 0.85, as
    tests/test_ext_processors.py's SyntheticGenerator."""

    def __init__(self, mask_source=None):
        self.mask_source = mask_source

    def detect(self, image_np, prompts, box_threshold, text_threshold):
        boxes, scores, ids = [], [], []
        for k, color in enumerate(RECT_COLORS):
            ys, xs = np.nonzero((image_np == color).all(-1))
            if len(ys):
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                scores.append(0.9 - 0.1 * k)
                ids.append(k)
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(scores, np.float32), np.asarray(ids, np.int64))

    def masks_for_boxes(self, image_np, boxes):
        if self.mask_source is not None:
            return self.mask_source.masks_for_boxes(image_np, boxes)
        masks = np.zeros((len(boxes), *image_np.shape[:2]), bool)
        for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
            masks[i, y1:y2, x1:x2] = True
        return masks

    def generate(self, image_np, positive_points=None):
        boxes, _, _ = self.detect(image_np, None, 0, 0)
        return {"masks": self.masks_for_boxes(image_np, boxes)
                .astype(np.float32),
                "iou_preds": np.asarray([0.95, 0.9, 0.85][:len(boxes)],
                                        np.float32)}


def sam_best_logits(sam, emb, dec_kw, prompts, shape, hw):
    """MobileSAM's best-of-3 logits at the frame's size, and their IoUs,
    for `prompts` (pixels of the padded square), on the host: what
    masks_for_boxes and generate threshold."""
    with torch.inference_mode():
        masks, ious = sam._decode(emb, dec_kw, **prompts)
        sel, iou = sam._best(masks[0], ious[0])
        return sam._masks_to_original(sel, *shape, *hw).cpu(), iou.cpu()


def check_hard(cpu_logits, hard_cpu, hard_gpu, label) -> int:
    """Hard masks of the card and the CPU equal but where the CPU's logit
    lies within DET_TOL of the 0 threshold. -> the pixels that differ."""
    near = cpu_logits.abs().numpy() <= DET_TOL
    differ = np.asarray(hard_cpu) != np.asarray(hard_gpu)
    assert not (differ & ~near).any(), (
        f"{label}: {int((differ & ~near).sum())} mask pixels differ away "
        "from the threshold")
    return int(differ.sum())


def phase_sam_parity(dev) -> None:
    """Phase 9a, MobileSAM and Light-HQ-SAM, the card against the CPU at
    full width (TinyViT-5M: 64/128/160/320 wide, depths 2/2/6/2, at 1024;
    the decoder 256 wide, 8 heads, 2 layers, MLP 2048) on one synthetic
    854x480 frame, the same seeded weights on both sides: the embeddings
    (and Light-HQ-SAM's early features), and the best-of-3 logits at the
    frame's size and their IoUs for the frame's 3 boxes and for the 8x8
    point grid, within DET_TOL (phase 2's f32 budget); masks_for_boxes and
    generate (IoU filter off, mask NMS 0.7) each equal to what its logits
    give, the same masks kept, and hard masks equal but where the CPU's
    logit lies within DET_TOL of 0. Prints the device memory that the
    card's generate allocates at its peak."""
    from deva_tpu_torch.ext.detectors import _mask_nms
    from deva_tpu_torch.ext.mobile_sam import MobileSAM, grid_points
    h, w = H480, W480
    frames, boxes = demo_clip(h, w, 1)
    img, bxs = frames[0], boxes[0]
    kw = dict(points_per_side=DEMO_POINTS, pred_iou_thresh=float("-inf"))
    worst, moved, peaks = {}, {}, {}
    for hq in (False, True):
        name = "light-hq" if hq else "mobile"
        cpu = MobileSAM(device="cpu", seed=21 + hq, hq=hq, **kw)
        gpu = MobileSAM(cpu.net.state_dict(), device=dev, hq=hq, **kw)
        with torch.inference_mode():
            e_cpu, kw_cpu, shape, scale = cpu._embed(img)
            e_gpu, kw_gpu, _, _ = gpu._embed(img)
        worst[f"{name} embeddings"] = (e_gpu.cpu() - e_cpu).abs().max().item()
        for key in kw_cpu:
            worst[f"{name} early features"] = (
                kw_gpu[key].cpu() - kw_cpu[key]).abs().max().item()
        pts = (grid_points(DEMO_POINTS) * np.array([w, h]) * scale) \
            .astype(np.float32)
        prompts = {"boxes": {"boxes": torch.from_numpy(bxs * scale)[None]},
                   "grid": {"points": torch.from_numpy(pts)[None, :, None],
                            "labels": torch.ones(1, len(pts), 1)}}
        out = {}
        for pname, p in prompts.items():
            lc, ic = sam_best_logits(cpu, e_cpu, kw_cpu, p, shape, (h, w))
            lg, ig = sam_best_logits(gpu, e_gpu, kw_gpu, {
                k: v.to(dev) for k, v in p.items()}, shape, (h, w))
            worst[f"{name} {pname} logits"] = (lg - lc).abs().max().item()
            worst[f"{name} {pname} IoUs"] = (ig - ic).abs().max().item()
            out[pname] = lc, ic, lg, ig
        bad = {k: v for k, v in worst.items() if v > DET_TOL}
        assert not bad, f"phase 9a: beyond {DET_TOL}: {bad}"

        lc, _, lg, _ = out["boxes"]
        m_cpu = cpu.masks_for_boxes(img, bxs)
        m_gpu = gpu.masks_for_boxes(img, bxs)
        assert np.array_equal(m_cpu, (lc > 0).numpy()) and \
            np.array_equal(m_gpu, (lg > 0).numpy()), name
        moved[f"{name} masks_for_boxes"] = check_hard(
            lc, m_cpu, m_gpu, f"phase 9a {name} masks_for_boxes")

        lc, ic, lg, ig = out["grid"]
        keep = _mask_nms((lc > 0).numpy(), ic.numpy(), cpu.nms_iou)
        assert _mask_nms((lg > 0).numpy(), ig.numpy(), gpu.nms_iou) == keep
        g_cpu = cpu.generate(img)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        g_gpu = gpu.generate(img)
        peaks[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        for g, logits, iou in ((g_cpu, lc, ic), (g_gpu, lg, ig)):
            assert np.array_equal(g["masks"], (logits[keep] > 0).numpy()
                                  .astype(np.float32)), name
            assert np.array_equal(g["iou_preds"], iou[keep].numpy()), name
        moved[f"{name} generate ({len(keep)} kept)"] = check_hard(
            lc[keep], g_cpu["masks"] > 0, g_gpu["masks"] > 0,
            f"phase 9a {name} generate")
        del cpu, gpu, e_gpu, kw_gpu, out
    print(f"phase 9a MobileSAM and Light-HQ-SAM, card vs cpu at full width "
          f"on one {h}x{w} frame (3 boxes; a {DEMO_POINTS}x{DEMO_POINTS} "
          f"grid, IoU filter off, mask NMS 0.7): max |card - cpu| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (bound {DET_TOL:g}); hard-mask pixels that differ, all where "
          f"the CPU's logit lies within {DET_TOL:g} of 0: {moved}; the "
          f"card's generate ({DEMO_POINTS ** 2} prompts in one decoder "
          f"batch) peaks "
          + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items())
          + " MiB above what it found allocated", flush=True)


def processor_run(core, mode, setting, frames):
    """The text or the automatic processor over the frames on one core
    (detection_clips.run_processor), RectDetector as the source (box
    masks). -> (outputs by frame index, the forward prediction of each
    incorporate_detection by frame index, object tables per frame)."""
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.ext.automatic_processor import \
        process_frame_automatic
    from deva_tpu_torch.ext.with_text_processor import \
        process_frame_with_text
    from deva_tpu_torch.inference.demo_utils import flush_buffer
    ext_cfg = {"temporal_setting": setting, "detection_every": 3,
               "prompt": "a.b.c", "DINO_THRESHOLD": 0.35,
               "DINO_NMS_THRESHOLD": 0.8, "suppress_small_objects": False,
               "SAM_NUM_POINTS_PER_SIDE": 8, "SAM_OVERLAP_THRESHOLD": 0.8}
    process = process_frame_with_text if mode == "text" else \
        process_frame_automatic
    forwards, saver = {}, dc.RecordingSaver()
    tables = dc.run_processor(core, process, flush_buffer, RectDetector(),
                              ext_cfg, frames, saver, forwards)
    return {int(k[:5]): v for k, v in saver.probs.items()}, forwards, tables


def phase_processors_parity(net_cpu, dev) -> None:
    """Phase 9a, the frame processors: the text and the automatic processor
    (ext/with_text_processor.py, ext/automatic_processor.py), each
    semi-online and online, on 7 frames of 64x96 of demo_clip's kind at
    PROC_CFG, the card against the CPU (det_core_pair: the same weights and
    object-id generators). Propagated frames within DET_TOL; a detection
    frame (logits) by phase 6a's rule: the two forward predictions within
    DET_TOL, and its probabilities beyond DET_TOL only where those
    predictions' argmaxes differ (paint_flips), on at most DET_FLIP_SHARE
    of the frame; equal object tables after every frame."""
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.config import InferenceConfig
    n = 7
    frames, _ = demo_clip(64, 96, n, seed=42)
    result = {}
    for mode in ("text", "auto"):
        for setting in ("semionline", "online"):
            label = f"phase 9a {mode} {setting}"
            cpu, gpu = det_core_pair(net_cpu, dev,
                                     InferenceConfig(**PROC_CFG))
            p_cpu, f_cpu, t_cpu = processor_run(cpu, mode, setting, frames)
            p_gpu, f_gpu, t_gpu = processor_run(gpu, mode, setting, frames)
            assert t_gpu == t_cpu, f"{label}: object tables"
            assert sorted(p_gpu) == sorted(p_cpu) == list(range(n)), label
            assert sorted(f_gpu) == sorted(f_cpu), label
            worst, share = 0.0, 0.0
            for ti in range(n):
                r, o = p_cpu[ti], p_gpu[ti]
                if ti not in f_cpu:
                    d = float(np.abs(o - r).max())
                    assert d <= DET_TOL, f"{label} frame {ti}: {d}"
                    worst = max(worst, d)
                    continue
                allowed = None
                if f_cpu[ti] is not None:
                    d = float(np.abs(f_gpu[ti] - f_cpu[ti]).max())
                    assert d <= DET_TOL, f"{label} frame {ti} forward: {d}"
                    worst = max(worst, d)
                    allowed = dc.paint_flips(f_cpu[ti], f_gpu[ti])
                share = max(share, dc.check_detection_frame(
                    torch.softmax(torch.from_numpy(r), 0),
                    torch.softmax(torch.from_numpy(o), 0), allowed, DET_TOL,
                    DET_FLIP_SHARE, f"{label} frame {ti}")[1])
            assert gpu.object_manager.num_obj >= 2, label
            result[f"{mode} {setting}"] = (worst, share)
    print("phase 9a frame processors, card vs cpu at 64x96 (7 frames, "
          "box-mask detectors): max |dprob| (propagated frames, forward "
          "predictions) and the largest share of a detection frame allowed "
          "to differ where the forward predictions paint another id, "
          f"bounds {DET_TOL:g} and {DET_FLIP_SHARE:g}: "
          + "; ".join(f"{k} {v[0]:.3g}, {v[1]:.4f}"
                      for k, v in result.items())
          + "; object tables equal", flush=True)


class DemoReader:
    """The demos' reader (SimpleVideoReader's items) from memory: (uint8
    RGB frame, name, path)."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i], f"{i:05d}.jpg", f"{i:05d}.jpg"


class DemoSaver:
    """The demos' result saver for phases 9b and 9c: writes nothing (phase
    13 runs the demos with their own savers); checks each saved frame
    (finite, [1 + objects, H, W] at the size the core processed the frame
    at: the
    frame's, or its --size resize), keeps the frame order and the objects
    as each frame was saved, and calls after(ti)."""

    def __init__(self, core, after=None):
        self.core, self.after = core, after
        self.order, self.objects = [], []

    def save_mask(self, prob, frame_name, need_resize=False, shape=None,
                  image_np=None, prompts=None, path_to_image=None):
        from deva_tpu_torch.ext.detectors import _target_shape
        ti = int(frame_name[:5])
        n = self.core.object_manager.num_obj
        size = _target_shape(*shape, self.core.cfg.size) if need_resize \
            else shape
        assert tuple(prob.shape) == (n + 1, *size), (ti, tuple(prob.shape))
        assert bool(torch.isfinite(prob).all()), f"frame {ti}"
        self.order.append(ti)
        self.objects.append(n)
        if self.after is not None:
            self.after(ti)


class DeviceTimer(HostTimer):
    """HostTimer whose calls drain the device before and after, so that a
    call's time includes its device work."""

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1000
            self.calls += 1


def demo_driver(script: str):
    """demo/<script> as a module (demo/ and evaluation/ on sys.path)."""
    import importlib
    for sub in ("evaluation", "demo"):
        if os.path.join(ROOT, sub) not in sys.path:
            sys.path.insert(0, os.path.join(ROOT, sub))
    return importlib.import_module(script)


def demo_schedule(args, n_frames):
    """The semi-online schedule of the frame processors: the voting frames
    (num_voting_frames - 1, then every detection_every) and the frames of
    their windows (each voting frame and the num_voting_frames - 1 before
    it), within n_frames."""
    votes = list(range(args.num_voting_frames - 1, n_frames,
                       args.detection_every))
    window = {v - k for v in votes for k in range(args.num_voting_frames)}
    return votes, window


def demo_run(ak, dev, net_cpu, mode, n_frames, h, w, keep_calls=True,
             name=None):
    """Phase 9b (mode "auto") or 9c ("text"): the demo's run_demo on
    n_frames of demo_clip at h x w, as the demo's main drives it (its
    flags, demo_config, one InferenceCore with long ids, its StepTimer), an
    in-memory reader and a checking saver; the propagation model phase 3's.
    9b: demo_automatic_torch with --sam_variant mobile (seeded random
    MobileSAM) at the demo's defaults (semi-online, a detection every 5
    frames, 3 voting frames, max_num_objects 200) but
    SAM_NUM_POINTS_PER_SIDE DEMO_POINTS and SAM_PRED_IOU_THRESHOLD -inf;
    9c: demo_with_text_torch at its defaults with RectDetector's boxes and
    Light-HQ-SAM (--sam_variant sam_hq_light, seeded random) as the mask
    source. Each frame's output is checked (DemoSaver); objects must be
    admitted; the exact pair's calls are tapped (KernelTap: the last
    frame's, and the last spatial alignment's; with keep_calls False they
    are dropped, and the rings they hold with them). Prints ms per frame
    by kind (StepTimer, CUDA events), the parts of a detection frame (each
    timed with the device drained around it), the objects over time, the
    launches and the peak memory above what was allocated before the run.
    Returns (the last frame's calls, the launches outside the alignments,
    the last alignment's calls, the alignments' launches, the objects after
    each saved frame). name: the phase in the printed line."""
    from deva_tpu_torch.ext import automatic_processor as ap
    from deva_tpu_torch.ext import detectors as dets
    from deva_tpu_torch.ext import with_text_processor as wp
    from deva_tpu_torch.ext.ext_eval_args import (add_auto_default_args,
                                                  add_text_default_args)
    from deva_tpu_torch.inference.core import InferenceCore
    gc.collect()
    text = demo_driver("demo_with_text_torch")
    if mode == "auto":
        drv = demo_driver("demo_automatic_torch")
        args = text.make_parser(add_auto_default_args).parse_args([
            "--sam_variant", "mobile", "--MOBILE_SAM_CHECKPOINT_PATH", "",
            "--SAM_NUM_POINTS_PER_SIDE", str(DEMO_POINTS),
            "--SAM_PRED_IOU_THRESHOLD=-inf", "--size", str(DEMO_SIZE),
            "--device", dev.type])
        source = dets.build_auto_generator(args)
        sam = source
        fusion = (ap, "auto_segment")
        deviations = (f"SAM_NUM_POINTS_PER_SIDE {DEMO_POINTS} (default 64), "
                      "SAM_PRED_IOU_THRESHOLD -inf (default 0.88)")
    else:
        drv = text
        args = text.make_parser(add_text_default_args).parse_args([
            "--prompt", "red.green.blue", "--sam_variant", "sam_hq_light",
            "--LIGHT_HQ_SAM_CHECKPOINT_PATH", "", "--size", str(DEMO_SIZE),
            "--device", dev.type])
        sam = dets._mobile_sam_from_args(args, "sam_hq_light")
        source = RectDetector(sam)
        fusion = (wp, "segment_with_text")
        deviations = "none (RectDetector's boxes for Grounding DINO's)"
    frames, _ = demo_clip(h, w, n_frames)
    net = copy.deepcopy(net_cpu).to(dev)
    core = InferenceCore(net, text.demo_config(args, n_frames), device=dev)
    core.enabled_long_id()
    core.object_manager._rng = np.random.default_rng(5)
    timer = text.StepTimer(dev)
    tap = KernelTap(ak)
    history = []

    def after(ti):
        history.append((ti, core.object_manager.num_obj))
        tap.frame()

    saver = DemoSaver(core, after)
    parts = {"SAM encode": DeviceTimer(sam, "_embed"),
             "SAM decoder": DeviceTimer(sam, "_decode"),
             "mask post-processing": DeviceTimer(sam, "_masks_to_original"),
             "_mask_nms": DeviceTimer(dets, "_mask_nms"),
             "_resize_bilinear (masks to --size; 9b: the forward mask's blur)":
                 DeviceTimer(dets, "_resize_bilinear"),
             "fusion": DeviceTimer(*fusion),
             "vote": DeviceTimer(core, "vote_in_temporary_buffer")}
    # every frame's host resize to --size (uint8, PIL's taps), in the
    # processor's module
    frame_resize = HostTimer(fusion[0], "get_input_frame_for_deva")
    if mode == "auto":
        parts["generate"] = DeviceTimer(sam, "generate")
        parts["forward estimate"] = DeviceTimer(ap, "estimate_forward_mask")
    else:
        parts["masks_for_boxes"] = DeviceTimer(sam, "masks_for_boxes")
    align_launches = dict.fromkeys(EXACT_PAIR, 0)
    align_ms = []
    real_align = core.spatial_alignment

    def tapped_align(*a):
        before = dict(ak.LAUNCHES)
        tap.tag, tap.calls["align"] = "align", []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real_align(*a)  # a host array: synchronised
        finally:
            tap.tag = "memory"
            align_ms.append((time.perf_counter() - t0) * 1000)
            for k in EXACT_PAIR:
                align_launches[k] += ak.LAUNCHES[k] - before[k]

    core.spatial_alignment = tapped_align
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        drv.run_demo(core, source, DemoReader(frames), saver, vars(args),
                     timer)
    finally:
        tap.restore()
        frame_resize.restore()
        for part in parts.values():
            part.restore()
    wall = time.perf_counter() - t0
    launches = dict(ak.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    assert sorted(saver.order) == list(range(n_frames)), saver.order
    assert history[-1][1] > 0, f"{mode}: no object admitted"
    votes, window = demo_schedule(args, n_frames)
    step_ms = timer.steps_ms
    assert len(step_ms) == n_frames, len(step_ms)
    prop = [m for ti, m in enumerate(step_ms) if ti not in window]
    det = [m for ti, m in enumerate(step_ms) if ti in window
           and ti not in votes]
    vote = [step_ms[ti] for ti in votes]
    n_det = len(window)
    per_det = {k: t.ms / n_det for k, t in parts.items()}
    calls = {k: t.calls for k, t in parts.items()}
    name = name or ("9b automatic" if mode == "auto" else "9c text")
    script = "demo_automatic_torch" if mode == "auto" else \
        "demo_with_text_torch"
    size = dets._target_shape(h, w, args.size)
    print(f"phase {name} demo on {n_frames} frames of {h}x{w} "
          f"(--size {args.size}: processed at {size[0]}x{size[1]}) through "
          f"{script}.run_demo (semi-online, a detection every "
          f"{args.detection_every}, {args.num_voting_frames} voting frames, "
          f"max_num_objects {args.max_num_objects}; --sam_variant "
          f"{args.sam_variant}; deviations from the demo's defaults: "
          f"{deviations}), ms from its StepTimer (CUDA events): "
          f"propagation frames median "
          + (f"{statistics.median(prop):.3f} (mean "
             f"{statistics.mean(prop):.3f}, {len(prop)} frames)"
             if prop else "none")
          + f"; detection frames (SAM and fusion, buffered) median "
          f"{statistics.median(det):.3f} ({len(det)}); voting frames (SAM, "
          f"fusion, vote, incorporate_detection, the buffer's steps) "
          + ", ".join(f"{m:.1f}" for m in vote)
          + f"; frame resize to --size (get_input_frame_for_deva, host) "
          f"{frame_resize.ms / max(frame_resize.calls, 1):.3f} ms per frame "
          f"({frame_resize.calls} calls)"
          + f"; per detection frame ({n_det}), each part timed with the "
          f"device drained around it: "
          + ", ".join(f"{k} {v:.3f} ms ({calls[k]} calls)"
                      for k, v in per_det.items())
          + f"; spatial alignments {len(align_ms)}, median "
          + (f"{statistics.median(align_ms):.3f} ms" if align_ms else "-")
          + f"; objects after each saved frame {history}; launches "
          f"{launches} (alignments {align_launches}); peak allocated "
          f"{peak:.1f} MiB ({held:.1f} MiB held before the run); wall "
          f"{wall:.1f} s", flush=True)
    memory = {k: launches[k] - align_launches[k] for k in EXACT_PAIR}
    if not keep_calls:
        return [], memory, [], align_launches, history
    return tap.last_frame, memory, tap.calls.get("align", []), \
        align_launches, history


def phase9(ak, apx, net_cpu, dev):
    """Phases 9a-9c; -> (the kernels line's .demo and .demo.align rows, on
    the arguments of 9b's last frame and of its last spatial alignment,
    with the launches of both demos (9b and 9c run the same pair); 9b's
    objects after each saved frame, which phase 12b's run_auto path must
    repeat)."""
    phase_sam_parity(dev)
    phase_processors_parity(net_cpu, dev)
    last, mem_b, align_calls, align_b, history_b = demo_run(
        ak, dev, net_cpu, "auto", DEMO_FRAMES, H480, W480)
    _, mem_c, _, align_c, _ = demo_run(ak, dev, net_cpu, "text", DEMO_FRAMES,
                                       H720, W720, keep_calls=False)
    total = lambda a, b: {k: a[k] + b[k] for k in EXACT_PAIR}
    rows = det_kernel_rows(ak, apx, dev, ".demo", last, total(mem_b, mem_c),
                           "9b's last frame")
    del last
    rows += det_kernel_rows(ak, apx, dev, ".demo.align", align_calls,
                            total(align_b, align_c),
                            "9b's last spatial alignment")
    return rows, history_b


# --------------------------------------------------------------------------
# phase 10: training (deva_tpu_torch/training)
# --------------------------------------------------------------------------

# TrainConfig's stage-3 frames and objects at the stage driver's crop: the
# shape of deva_tpu's bench.py --train step
TRAIN_CROP, TRAIN_T, TRAIN_REF, TRAIN_OBJ = 384, 8, 3, 3
# 10b's runs: (label, compute dtype, remat, batch)
TRAIN_RUNS = (("f32", "float32", False, 2), ("f32 remat", "float32", True, 2),
              ("bf16 remat", "bfloat16", True, 4))
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# 10a's budgets, card against CPU: the total loss, each
# gradient against its tensor's largest, each update against the rate
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_STEP_REL = 1e-4, 1e-3, 1e-2
# a tensor whose exact gradient is 0 (the key projection's bias cancels in
# the similarity) carries rounding noise alone: each tensor's scale is at
# least this share of the largest gradient of all
GRAD_FLOOR = 1e-6
# 10a's float64 second opinion, card against CPU: the f64 runs still round
# to f32 where the port casts explicitly (read_memory's output to the
# config's compute dtype, upsample_bilinear's f32 stencil), which left
# 9.1e-7 and 2.9e-6 of a tensor's largest on the H100; 30x that, and ten
# times below the f32 budget
F64_GRAD_REL = 1e-4


def train_batch(rng, b, t, h, w, n_obj):
    """A trainer batch (numpy) of b clips: n_obj of toy.make_clip's moving
    squares per clip, each pasted over the last, then pixel noise over the
    whole frame (a flat square repeats each feature value over its pixels,
    and one that lies within rounding of a ReLU's kink would move whole
    gradients between the two devices)."""
    from deva_tpu_torch.training.toy import make_clip
    rgb = np.zeros((b, t, h, w, 3), np.float32)
    cls_gt = np.zeros((b, t, h, w), np.int32)
    for i in range(b):
        for j in range(n_obj):
            frames, masks = make_clip(rng, t, h, w, size=h // 5)
            on = masks == 1
            rgb[i] = frames if j == 0 else np.where(on[..., None], frames,
                                                    rgb[i])
            cls_gt[i][on] = j + 1
    rgb += 0.02 * rng.standard_normal(rgb.shape).astype(np.float32)
    first = np.stack([cls_gt[:, 0] == j + 1 for j in range(n_obj)],
                     1).astype(np.float32)
    return {"rgb": rgb, "first_frame_gt": first, "cls_gt": cls_gt,
            "selector": np.ones((b, n_obj), np.float32)}


def to_dev(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def grad_gap(ref: dict, other: dict) -> dict:
    """Each tensor's largest |other - ref| over its scale: its largest |ref|,
    at least GRAD_FLOOR of the largest of all."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    return {n: float((other[n].double() - g.double()).abs().max()) /
            max(float(g.abs().max()), floor) for n, g in ref.items()}


def grads_f64(net_cpu, batch, cfg, draws, dev):
    """The gradients of the training loss in float64 on `dev`, clipped as
    train_step clips them: a copy of the weights, the compute dtype and the
    port's explicit f32 casts (Tensor.float, patched for the call) made
    float64."""
    from deva_tpu_torch.models.layers import set_compute_dtype
    from deva_tpu_torch.training.trainer import Trainer, clip_by_global_norm
    net = set_compute_dtype(copy.deepcopy(net_cpu).double().to(dev),
                            torch.float64)
    trainer = Trainer(net, cfg)
    b64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                               else v).to(dev) for k, v in batch.items()}
    f32_cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        trainer.losses(b64, draws)["total_loss"].backward()
    finally:
        torch.Tensor.float = f32_cast
    clip_by_global_norm([p.grad for p in net.parameters()],
                        cfg.clip_grad_norm)  # as train_step's gradients
    return {n: p.grad.cpu() for n, p in net.named_parameters()}


def phase_train_parity(net_cpu, dev) -> None:
    """10a: one train step of the full-width network at 64x64, B=2, T=4,
    num_ref_frames 2, 3 objects, it 0 (every pixel counts), on the card and
    on the CPU from the same weights, batch and draws. The total loss within
    TRAIN_LOSS_REL, each gradient within TRAIN_GRAD_REL of its tensor's
    largest, each update (new - old) within TRAIN_STEP_REL * lr where the
    CPU's gradient is above 1e-3 of its tensor's largest and within 2 * lr
    everywhere (Adam's first step is about lr * sign(g)). A tensor whose
    f32 gradients miss must show that the miss is f32 rounding (a ReLU
    input within rounding of 0 takes the other side on the other device
    and moves every gradient upstream of it; at full width both devices'
    f32 gradients lie up to a few percent from float64 in some tensors):
    then the float64 gradients of the card and of the CPU agree within
    F64_GRAD_REL in every tensor."""
    from deva_tpu_torch.config import TrainConfig
    from deva_tpu_torch.training.trainer import Trainer, draw_sequence
    cfg = TrainConfig(num_frames=4, num_ref_frames=2)
    batch = train_batch(np.random.default_rng(21), 2, 4, 64, 64, TRAIN_OBJ)
    draws = draw_sequence(cfg, 2, 4, torch.Generator().manual_seed(21))
    assert draws[2][0] is not None  # frame 3 reads drawn frames
    runs = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        net = copy.deepcopy(net_cpu).to(device)
        old = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
        trainer = Trainer(net, cfg)
        metrics = trainer.train_step(to_dev(batch, device), draws)
        runs[name] = (float(metrics["total_loss"]),
                      {n: p.grad.cpu() for n, p in net.named_parameters()},
                      {n: p.detach().cpu() - old[n]
                       for n, p in net.named_parameters()})
    (loss_c, grads_c, steps_c), (loss_g, grads_g, steps_g) = \
        runs["cpu"], runs["card"]
    loss_gap = abs(loss_g - loss_c) / abs(loss_c)
    gaps = grad_gap(grads_c, grads_g)
    worst = max(gaps, key=gaps.get)
    lr = cfg.lr
    step_clear, step_all = 0.0, 0.0
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in grads_c.values())
    for n, g in grads_c.items():
        d = (steps_g[n] - steps_c[n]).abs()
        clear = g.abs() > 1e-3 * max(float(g.abs().max()), floor)
        step_clear = max(step_clear, float(torch.where(clear, d, 0).max()))
        step_all = max(step_all, float(d.max()))
    print(f"phase 10a train step card vs CPU (full width, 64x64, B=2, T=4, "
          f"{TRAIN_OBJ} objects, it 0): total loss {loss_g:.6f} vs "
          f"{loss_c:.6f} (rel gap {loss_gap:.2e}); worst gradient gap "
          f"{gaps[worst]:.2e} of its tensor's largest ({worst}); update "
          f"gaps {step_clear / lr:.2e} lr where the gradient is clear, "
          f"{step_all / lr:.2e} lr anywhere", flush=True)
    assert loss_gap <= TRAIN_LOSS_REL, loss_gap
    assert step_all <= 2 * lr, step_all
    missed = {n for n, gap in gaps.items() if gap > TRAIN_GRAD_REL}
    if missed or step_clear > TRAIN_STEP_REL * lr:
        g64_cpu = grads_f64(net_cpu, batch, cfg, draws, torch.device("cpu"))
        g64_card = grads_f64(net_cpu, batch, cfg, draws, dev)
        gaps64 = grad_gap(g64_cpu, g64_card)
        vs_cpu, vs_card = grad_gap(g64_cpu, grads_c), grad_gap(g64_cpu,
                                                               grads_g)
        worst = sorted(missed, key=gaps.get)[-5:]
        print(f"phase 10a: {len(missed)} tensor(s) above {TRAIN_GRAD_REL} "
              f"in f32; float64 card vs CPU worst gap "
              f"{max(gaps64.values()):.2e}; the worst five (f32 gap, CPU "
              f"f32 vs f64, card f32 vs f64): "
              f"{[(n, gaps[n], vs_cpu[n], vs_card[n]) for n in worst]}",
              flush=True)
        assert max(gaps64.values()) <= F64_GRAD_REL, gaps64
    del runs


def train_timed(net_cpu, dev, dtype, remat, batches, draws) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED train steps of a fresh copy of the weights
    on the device batches; -> per-step total losses, CUDA-event ms of the
    forward (losses), backward and update of each timed step, and the peak
    allocated memory."""
    from deva_tpu_torch.config import TrainConfig
    from deva_tpu_torch.training.trainer import Trainer
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    net = with_dtype(net_cpu, dtype).to(dev)
    trainer = Trainer(net, TrainConfig(num_frames=TRAIN_T,
                                       num_ref_frames=TRAIN_REF,
                                       remat=remat))
    losses, parts = [], []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record()
        order = iter(marks[1:])
        metrics = trainer.train_step(batch, d,
                                     on_phase=lambda _: next(order).record())
        marks[3].synchronize()
        losses.append(float(metrics["total_loss"]))
        if i >= TRAIN_WARMUP:
            parts.append([marks[k].elapsed_time(marks[k + 1])
                          for k in range(3)])
    peak = torch.cuda.max_memory_allocated(dev)
    del trainer, net
    return {"losses": losses, "parts": parts, "peak": peak}


def phase_train_stage3(net_cpu, dev) -> list:
    """10b: the full-width train step at stage-3 shapes, three runs (f32 at
    B=2, the same with --remat, bf16 with --remat at B=4), each 2 warm-up
    and 5 timed steps on the same batches and draws; the remat run's losses
    within 1e-5 of the plain run's at the first step (1e-3 after it), and
    bf16's first-step loss finite and within 5% of f32's on the same
    weights, batch and draws."""
    from deva_tpu_torch.config import TrainConfig
    from deva_tpu_torch.training.trainer import Trainer, draw_sequence
    n = TRAIN_WARMUP + TRAIN_TIMED
    rng = np.random.default_rng(22)
    host = [train_batch(rng, 4, TRAIN_T, TRAIN_CROP, TRAIN_CROP, TRAIN_OBJ)
            for _ in range(n)]
    cfg = TrainConfig(num_frames=TRAIN_T, num_ref_frames=TRAIN_REF)
    gen = torch.Generator().manual_seed(22)
    draws4 = [draw_sequence(cfg, 4, TRAIN_T, gen) for _ in range(n)]
    batches4 = [to_dev(b, dev) for b in host]  # set-up
    del host
    rows, results = [], {}
    for label, dtype, remat, b in TRAIN_RUNS:
        batches = [{k: v[:b] for k, v in x.items()} for x in batches4]
        draws = [[(None if r is None else r[:b], deep) for r, deep in d]
                 for d in draws4]
        res = train_timed(net_cpu, dev, dtype, remat, batches, draws)
        results[label] = res
        fwd, bwd, upd = (statistics.median(p[k] for p in res["parts"])
                         for k in range(3))
        step = statistics.median(sum(p) for p in res["parts"])
        row = {"run": label, "batch": b, "ms_per_step": step,
               "clips_per_s": b * 1000 / step, "forward_ms": fwd,
               "backward_ms": bwd, "update_ms": upd,
               "steps_ms": [sum(p) for p in res["parts"]],
               "peak_gib": res["peak"] / 2 ** 30,
               "losses": res["losses"]}
        rows.append(row)
        print(f"phase 10b {label} B={b} ({TRAIN_CROP}x{TRAIN_CROP}, "
              f"T={TRAIN_T}, {TRAIN_OBJ} objects, full width): "
              f"{step:.1f} ms/step (median of {TRAIN_TIMED}), "
              f"{b * 1000 / step:.2f} clips/s, forward {fwd:.1f} ms, "
              f"backward {bwd:.1f} ms, update {upd:.1f} ms, peak "
              f"{res['peak'] / 2 ** 30:.2f} GiB; losses "
              f"{[round(x, 5) for x in res['losses']]} {smi_line()}",
              flush=True)
        assert all(np.isfinite(res["losses"])), res["losses"]
    # the first step starts from the same weights: the same function, to
    # rounding (equal on the H100). Later steps start from weights that the
    # backward's atomics (the bilinear upsample's, cuDNN's) rounded apart,
    # as they would two plain runs: 5.4e-6 and 3.9e-5 by the seventh step
    # on the H100, so those are held to 1e-3 only
    plain, remat = results["f32"]["losses"], results["f32 remat"]["losses"]
    gaps = [abs(a - b) / abs(a) for a, b in zip(plain, remat)]
    remat_gap = max(gaps)
    assert gaps[0] <= 1e-5 and remat_gap <= 1e-3, (plain, remat)
    # f32 on bf16's batch and draws, forward only, for its first loss
    net = with_dtype(net_cpu, "float32").to(dev)
    with torch.no_grad():
        ref = float(Trainer(net, cfg).losses(batches4[0], draws4[0])[
            "total_loss"])
    del net
    bf16_first = results["bf16 remat"]["losses"][0]
    bf16_gap = abs(bf16_first - ref) / abs(ref)
    print(f"phase 10b: remat vs plain losses, rel gap {gaps[0]:.2e} at "
          f"the first step, worst {remat_gap:.2e}; bf16 first-step loss {bf16_first:.5f} vs f32 "
          f"{ref:.5f} on its batch (rel gap {bf16_gap:.2e})", flush=True)
    assert bf16_gap <= 0.05, (bf16_first, ref)
    print("phase 10b json " + json.dumps({"train": rows}), flush=True)
    return rows


def phase_train_toy(ak, dev, tmp) -> None:
    """10c: toy.train_toy (the tiny model, 120 steps, deva_tpu's
    calibration) on the card, then eval_iou on held-out clips through
    InferenceCore on the card, against the random-init IoU; the exact pair
    must launch during the evaluation. save_network, load_network_weights
    and one clip again: the same IoU."""
    from deva_tpu_torch.training import checkpoint as ckpt
    from deva_tpu_torch.training import toy
    net0 = toy.tiny_model().to(dev).eval()
    iou0 = toy.eval_iou(net0)
    del net0
    t0 = time.perf_counter()
    net, losses = toy.train_toy(device=dev, log=lambda *_: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ak.reset_launch_counts()
    iou = toy.eval_iou(net)
    launches = {k: ak.LAUNCHES[k] for k in EXACT_PAIR}
    print(f"phase 10c learn-to-track: 120 steps in {train_s:.1f} s, total "
          f"loss every 10 steps {[round(x, 4) for x in losses]}; held-out "
          f"IoU {iou:.4f} (random init {iou0:.4f}); launches during the "
          f"evaluation {launches}", flush=True)
    assert iou > 0.5 and iou > iou0 + 0.3, (iou, iou0)
    assert all(launches[k] > 0 for k in EXACT_PAIR), launches
    path = ckpt.save_network(net, os.path.join(tmp, "toy"), 120)
    again = toy.tiny_model()
    again.load_state_dict(ckpt.load_network_weights(path), strict=True)
    again = again.to(dev).eval()
    one, one_again = (toy.eval_iou(m, n_clips=1) for m in (net, again))
    print(f"phase 10c: {os.path.basename(path)} reloaded, one clip's IoU "
          f"{one_again:.4f} (trained network {one:.4f})", flush=True)
    assert one_again == one, (one, one_again)


class NullSummaryWriter:
    """Stand-in for tensorboardX.SummaryWriter (the card's machine has no
    tensorboardX): takes what the logger writes and keeps nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def add_scalar(self, *args, **kwargs):
        pass

    add_image = add_text = add_scalar


class SyntheticVOS:
    """In-memory stand-in for training/data.VOSDataset (the card's machine
    has no PIL): the constructor's arguments, and items of its format,
    moving squares from train_batch, with up to max_num_obj objects."""

    def __init__(self, im_root, gt_root, max_jump, *, size=384, subset=None,
                 num_frames=3, max_num_obj=3, data_ratio=1.0):
        self.size, self.num_frames = size, num_frames
        self.max_num_obj = max_num_obj

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        rng = np.random.default_rng(1000 + idx)
        n_obj = 1 + idx % self.max_num_obj
        b = train_batch(rng, 1, self.num_frames, self.size, self.size,
                        n_obj)
        first = np.zeros((self.max_num_obj, self.size, self.size),
                         np.float32)
        first[:n_obj] = b["first_frame_gt"][0]
        selector = (np.arange(self.max_num_obj) < n_obj).astype(np.float32)
        return {"rgb": b["rgb"][0], "first_frame_gt": first,
                "cls_gt": b["cls_gt"][0], "selector": selector,
                "info": {"name": f"synthetic{idx}", "num_objects": n_obj}}


def phase_train_driver(dev, tmp) -> None:
    """10d: training.train.main --stages 3 on the card at the tiny widths
    for 4 iterations, a checkpoint at 2 and a resume to 4, with VOSDataset
    replaced by SyntheticVOS (as 9c replaces Grounding DINO's detect()) and,
    where tensorboardX is missing, its SummaryWriter by
    NullSummaryWriter."""
    from deva_tpu_torch.training import train
    flags = ["--stages", "3", "--pix_feat_dim", "64", "--key_dim", "16",
             "--value_dim", "32", "--crop_size", "64", "--num_workers", "0",
             "--device", dev.type,
             "--s3_batch_size", "4", "--s3_num_frames", "4",
             "--s3_num_ref_frames", "2", "--log_text_interval", "1",
             "--save_network_interval", "2",
             "--save_checkpoint_interval", "2"]
    real, cwd = train.VOSDataset, os.getcwd()
    train.VOSDataset = SyntheticVOS
    stub = None
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        stub = type(sys)("tensorboardX")
        stub.SummaryWriter = NullSummaryWriter
        sys.modules["tensorboardX"] = stub
    os.chdir(tmp)
    try:
        train.main(flags + ["--exp_id", "phase10d", "--s3_iterations", "2"])
        ckpts = glob.glob(os.path.join("saves", "*", "*_checkpoint_2.pth"))
        assert len(ckpts) == 1, ckpts
        final = train.main(flags + ["--exp_id", "NULL", "--s3_iterations",
                                    "4", "--load_checkpoint", ckpts[0]])
        saved = sorted(os.path.relpath(p) for p in glob.glob(
            os.path.join("saves", "**", "*.pth"), recursive=True))
    finally:
        train.VOSDataset = real
        os.chdir(cwd)
        if stub is not None:
            del sys.modules["tensorboardX"]
    assert all(bool(torch.isfinite(v.float()).all()) for v in final.values())
    print(f"phase 10d: train.main --stages 3 on {dev}: saved {saved}, "
          f"resumed at 2 and finished at 4", flush=True)


def phase10(ak, net_cpu, dev) -> list:
    """Phases 10a-10d (training), each timed on the host clock; -> 10b's
    rows."""
    t0 = time.perf_counter()
    times = {}

    def lap(name):
        nonlocal t0
        times[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    phase_train_parity(net_cpu, dev)
    lap("10a")
    rows = phase_train_stage3(net_cpu, dev)
    lap("10b")
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_toy(ak, dev, tmp)
        lap("10c")
        phase_train_driver(dev, tmp)
        lap("10d")
    print(f"phase 10 took {sum(times.values()):.1f} s: {times}", flush=True)
    return rows


SMI = []


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi printed them."""
    return f"[{SMI[0]}]" if SMI else ""


def phase7(ak, apx, net_cpu, dev) -> list:
    """Phases 7a-7c; -> the kernels line's .bdet and .bmid rows."""
    phase_batched_detection_parity(ak, net_cpu, dev)
    launches7b, last7b = phase_batched_detection_online(ak, net_cpu, dev)
    rows = pair_rows_exact(ak, apx, dev, ".bdet", last7b, launches7b,
                           "7b's last lockstep frame")
    del last7b
    mid = phase_batched_midstream(ak, apx, net_cpu, dev)
    rows += pair_rows_exact(ak, apx, dev, ".bmid", mid["exact"][1],
                            mid["exact"][0], "7c's last lockstep frame")
    rows += pair_rows_approx(apx, dev, ".bmid", mid["approx"][1],
                             mid["approx"][0], "7c's last lockstep frame")
    return rows


# --------------------------------------------------------------------------
# phase 11: multi-GPU serving (object, memory and video sharding, 2 ranks)
# --------------------------------------------------------------------------

# 11a's clip: 854x480, 16 objects in a 4 x 4 grid of boxes, 30 frames;
# the driver's flags but a working memory of 5 frames (2 kept), so that
# long-term memory consolidates at frame 20 (the default 10 would not
# within 30 frames)
P11_OBJECTS, P11_FRAMES = 16, 30
P11_LT_FLAGS = ["--max_mid_term_frames", "5", "--min_mid_term_frames", "2"]
# 11b: online detection fusion, a detection every 5 frames, of two stuff
# bands and things 1-5, 7 and 8 of detection_clips.detections: 8 objects,
# thing 8 joins at frame 20 (o_cap 8 -> 16), thing 7 is gone from frame 25
# and, with max_missed_detection_count 0, purged there
P11_DET_FRAMES, P11_MISSED = 30, 0
P11_DET_IDS = (21, 22, 1, 2, 3, 4, 5, 7, 8)
# 11c: the memory-sharded attention's shapes (phase 1's at N=16712)
P11_N, P11_Q, P11_CK, P11_K, P11_O, P11_CV = 16712, 1620, 64, 30, 2, 512
# 11d: B=4 480p videos, 20 frames, long-term memory engaged by frame 9
P11_BATCH_FRAMES = 20
P11_BATCH_CFG = dict(mem_every=2, max_mid_term_frames=5,
                     min_mid_term_frames=2)
# each rank's time limit, and the phase's ranks
RANK_TIMEOUT, P11_WORLD = 600, 2


def p11_clip():
    """11a's frames and first mask (16 boxes, ids 1-16)."""
    frames = synthetic_video(np.random.default_rng(51), H480, W480,
                             P11_FRAMES)
    mask = np.zeros((H480, W480), np.int64)
    dh, dw = H480 // 4, W480 // 4
    for i in range(P11_OBJECTS):
        r, c = divmod(i, 4)
        mask[r * dh + dh // 8:(r + 1) * dh - dh // 8,
             c * dw + dw // 8:(c + 1) * dw - dw // 8] = i + 1
    return frames, mask


class TapSaver(VosSaver):
    """VosSaver that calls after() on each written frame."""

    def __init__(self, after):
        super().__init__()
        self.after = after

    def save_mask(self, out_mask, frame):
        super().save_mask(out_mask, frame)
        self.after()


def p11_vos(drv, net, dev, frames, mask, flags, obj_mesh, keep: bool,
            after=lambda: None):
    """11a's run through eval_vos_torch.run_video with --obj_shards's
    core (obj_mesh; None unsharded). -> (probabilities on the host if keep,
    the StepTimer's ms per frame, the peak allocated MiB)."""
    import dataclasses
    from deva_tpu_torch.inference.core import InferenceCore
    args = drv.get_args(flags + ["--device", "cuda"])
    cfg = drv.base_config(args)
    core = InferenceCore(net, dataclasses.replace(
        cfg, enable_long_term_count_usage=drv.count_usage(cfg, len(frames))),
        device=dev, obj_mesh=obj_mesh)
    probs = StepTap(core).probs if keep else None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = drv.StepTimer(dev)
    drv.run_video(core, VosReader(frames, {0: (mask, np.arange(
        1, P11_OBJECTS + 1))}, "v480"), args, TapSaver(after), timer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    chunk = int(flags[flags.index("--chunk") + 1]) if "--chunk" in flags \
        else 1
    sizes = [1] + [min(chunk, P11_FRAMES - s)
                   for s in range(1, P11_FRAMES, chunk)]
    per_frame = [ms / k for ms, k in zip(timer.steps_ms, sizes)
                 for _ in range(k)]
    assert core.memory.long_buckets, "11a: long-term memory never engaged"
    return probs, per_frame, peak


def p11_hold(ref, got, label):
    """A sharded run's frames against the unsharded run's on the same card,
    phase 3's card-against-CPU budget (DET_TOL) on every pixel, and the
    labels as the detection phases hold them: an argmax may flip only
    where the unsharded run's top two channels tie within ALIGN_TIE
    (random weights give near-flat probabilities). -> (max |dprob|, the
    largest share of a frame flipped)."""
    worst = flips = 0.0
    assert len(ref) == len(got), (label, len(ref), len(got))
    for ti, (a, b) in enumerate(zip(ref, got)):
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        assert a.shape == b.shape, (label, ti, a.shape, b.shape)
        assert bool(torch.isfinite(b).all()), (label, ti)
        diff = (a - b).abs()
        flip = a.argmax(0) != b.argmax(0)
        top2 = a.topk(min(2, a.shape[0]), dim=0).values
        odd = flip & ((top2[0] - top2[-1]) > ALIGN_TIE)
        beyond = (diff > DET_TOL).any(0)
        assert not bool(beyond.any()) and not bool(odd.any()), (
            f"{label} frame {ti}: {int(beyond.sum())} pixels beyond "
            f"{DET_TOL}, {int(odd.sum())} argmax flips off a tie")
        worst = max(worst, diff.max().item())
        flips = max(flips, flip.float().mean().item())
    return worst, flips


def p11_gather_floats(values, dev):
    """Each rank's list of floats, on every rank (one list all_gather)."""
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [p.tolist() for p in parts]


def p11_vos_phase(ak, apx, drv, net, dev, rank, obj_mesh, report):
    """11a: the VOS driver's run_video with --obj_shards 2, exact and
    approx by chunks of 5, against the unsharded core on the same card
    (rank 0, while rank 1 waits). -> the .osh rows (rank 0)."""
    import torch.distributed as dist
    frames, mask = p11_clip()
    rows = []
    for method, flags in (("exact", P11_LT_FLAGS),
                          ("approx", P11_LT_FLAGS + [
                              "--topk_method", "approx", "--chunk", "5"])):
        ref = ref_ms = ref_peak = None
        if rank == 0:
            ref, ref_ms, ref_peak = p11_vos(drv, net, dev, frames, mask,
                                            flags, None, True)
        dist.barrier()
        ak.reset_launch_counts()
        tap = KernelTap(ak) if method == "exact" and rank == 0 else None
        try:
            got, ms, peak = p11_vos(drv, net, dev, frames, mask, flags,
                                    obj_mesh, rank == 0,
                                    tap.frame if tap else lambda: None)
        finally:
            if tap:
                tap.restore()
        launches = dict(ak.LAUNCHES)
        used = EXACT_PAIR if method == "exact" else ("segmax",
                                                     "denom_readout")
        assert all(launches[k] >= P11_FRAMES - 1 for k in used), launches
        peaks = p11_gather_floats([peak, statistics.median(ms[10:])], dev)
        if rank != 0:
            continue
        worst, flips = p11_hold(ref, got, f"11a {method}")
        report[f"11a.{method}"] = {
            "ms_per_frame": [p[1] for p in peaks],
            "unsharded_ms_per_frame": statistics.median(ref_ms[10:]),
            "peak_mib": [p[0] for p in peaks], "unsharded_peak_mib": ref_peak,
            "max_abs_dprob": worst, "max_flip_share": flips,
            "launches": launches}
        print(f"{smi_line()} phase 11a eval_vos_torch.run_video "
              f"--obj_shards {P11_WORLD} {' '.join(flags)} at "
              f"{H480}x{W480}, {P11_OBJECTS} objects, {P11_FRAMES} frames: "
              f"ms/frame (StepTimer, frames 10+, median) per rank "
              + ", ".join(f"{p[1]:.3f}" for p in peaks)
              + f" vs unsharded {statistics.median(ref_ms[10:]):.3f}; peak "
              f"allocated MiB per rank " + ", ".join(f"{p[0]:.1f}"
                                                     for p in peaks)
              + f" vs unsharded {ref_peak:.1f}; against the unsharded core "
              f"max |dprob| {worst:.3g}, argmax flips at most {flips:.3%}; "
              f"launches {launches}", flush=True)
        if method == "exact":
            rows += det_kernel_rows(
                ak, apx, dev, ".osh", tap.last_frame,
                {k: launches[k] for k in EXACT_PAIR},
                "11a's last exact frame, rank 0's object slots")
        del ref, got
    return rows


class P11DetSaver(DetSaver):
    """DetSaver that keeps each frame's output on the device (11b compares
    them there) and the object table at each frame."""

    def __init__(self, core, detection_frame):
        super().__init__(core, detection_frame)
        self.on_card, self.tables = {}, {}

    def save_mask(self, prob, frame, **kw):
        super().save_mask(prob, frame, **kw)
        ti = int(frame[:5])
        self.on_card[ti] = prob.clone()
        om = self.core.object_manager
        self.tables[ti] = ([(o.id, t) for o, t in om.obj_to_tmp_id.items()],
                           self.core.o_cap)


def p11_det_run(drv, args, net, dev, frames, masks, infos, obj_mesh):
    """11b's video through eval_with_detections_torch.run_video, each
    detection merged against a perfect forward prediction once objects
    exist (detection_clips.perfect_forward: the detection's segment ids
    are the object ids), so that the host decisions read no device output.
    -> (the saver, the StepTimer's ms per frame)."""
    from deva_tpu_torch.detection_clips import perfect_forward
    core = drv.video_processor(net, drv.detection_config(args), len(frames),
                               dev, obj_mesh)
    real = core.incorporate_detection

    def incorporate(image, mask, segments, **kw):
        if core.object_manager.num_obj:
            kw["forward_mask"] = perfect_forward(core, mask)
        return real(image, mask, segments, **kw)

    core.incorporate_detection = incorporate
    timer = drv.StepTimer(dev)
    saver = P11DetSaver(core, lambda ti: ti % args.detection_every == 0)
    drv.run_video(DetReader(frames, masks, "det480"), core, saver, args,
                  timer, "vipseg", lambda ti, mask, info: (infos[ti], False))
    torch.cuda.synchronize()
    return saver, dict(zip(saver.order, timer.steps_ms))


def p11_det_phase(net, dev, rank, obj_mesh, report):
    """11b: online detection fusion through eval_with_detections_torch.
    run_video with --obj_shards 2 at 480p, against the unsharded run on the
    same card: equal object tables at every frame, every frame by
    p11_hold. The detections insert an object at frame 20, growing the
    padded object count from 8 to 16, and one object is purged at frame
    25."""
    import torch.distributed as dist
    from deva_tpu_torch.detection_clips import detections
    frames = synthetic_video(np.random.default_rng(31), H480, W480,
                             P11_DET_FRAMES)
    masks, infos = detections(P11_DET_FRAMES, H480, W480)
    keep = np.asarray(P11_DET_IDS)
    masks = [np.where(np.isin(m, keep), m, 0) for m in masks]
    infos = [[d for d in info if d["id"] in P11_DET_IDS] for info in infos]
    drv, args = det_driver("online")
    args.max_missed_detection_count = P11_MISSED
    ref = None
    if rank == 0:
        ref, ref_ms = p11_det_run(drv, args, net, dev, frames, masks, infos,
                                  None)
    dist.barrier()
    got, ms = p11_det_run(drv, args, net, dev, frames, masks, infos,
                          obj_mesh)
    if rank != 0:
        return
    assert got.tables == ref.tables, "11b: the object tables differ"
    caps = [got.tables[t][1] for t in range(P11_DET_FRAMES)]
    ids = [sorted(i for i, _ in got.tables[t][0])
           for t in range(P11_DET_FRAMES)]
    assert caps[0] == 8 and caps[-1] == 16 and 8 in ids[20] and \
        8 not in ids[19] and 7 in ids[24] and 7 not in ids[25], (caps, ids)
    worst, flips = p11_hold([ref.on_card[t] for t in range(P11_DET_FRAMES)],
                            [got.on_card[t] for t in range(P11_DET_FRAMES)],
                            "11b")
    det = [t for t in range(P11_DET_FRAMES) if t % args.detection_every == 0]
    prop = [t for t in range(10, P11_DET_FRAMES) if t not in det]
    report["11b"] = {
        "objects": [len(i) for i in ids], "o_cap": caps,
        "max_abs_dprob": worst, "max_flip_share": flips,
        "prop_ms": statistics.median(ms[t] for t in prop),
        "unsharded_prop_ms": statistics.median(ref_ms[t] for t in prop),
        "det_ms": statistics.median(ms[t] for t in det[1:]),
        "unsharded_det_ms": statistics.median(ref_ms[t] for t in det[1:])}
    print(f"{smi_line()} phase 11b eval_with_detections_torch.run_video "
          f"online --obj_shards {P11_WORLD} at {H480}x{W480}, "
          f"{P11_DET_FRAMES} frames, perfect forward predictions, "
          f"max_missed_detection_count {P11_MISSED}: objects per frame "
          f"{report['11b']['objects']}, o_cap {caps[0]} -> {caps[-1]} at "
          f"frame 20, object 7 purged at 25; object tables equal to the "
          f"unsharded run's at every frame, max |dprob| {worst:.3g}, argmax "
          f"flips at most {flips:.3%} (at near-ties); rank 0 ms (StepTimer, "
          f"median) per propagation frame {report['11b']['prop_ms']:.3f} "
          f"(unsharded {report['11b']['unsharded_prop_ms']:.3f}), per "
          f"detection frame {report['11b']['det_ms']:.3f} (unsharded "
          f"{report['11b']['unsharded_det_ms']:.3f})", flush=True)


class ShardedAttentionTap:
    """The exact pair's calls inside parallel/sharded_attention.py (it
    binds the wrappers at import), recorded as KernelTap records them."""

    def __init__(self):
        from deva_tpu_torch.parallel import sharded_attention as sa
        self.sa, self.calls = sa, []
        self.fns = {name: getattr(sa, name) for name in EXACT_PAIR}
        for name, fn in self.fns.items():
            setattr(sa, name, self._spy(name, fn))

    def _spy(self, name, fn):
        def spy(*args):
            self.calls.append((name, args))
            return fn(*args)
        return spy

    def restore(self):
        for name, fn in self.fns.items():
            setattr(self.sa, name, fn)


def p11_attention_phase(ak, apx, dev, rank, report):
    """11c: attend_mem_sharded at N=16712 (phase 1's [long-term ; working]
    validity; padded by pad_tokens) over the 'data' axis of 2 ranks, against
    the single-device attend_topk: on the rows whose k-th value is unique
    (there the supports are equal) within 1e-5 of each row's largest
    output. -> the .msh rows (rank 0, on its shard's arguments)."""
    import torch.distributed as dist
    from deva_tpu_torch.parallel.mesh import make_mesh
    from deva_tpu_torch.parallel.sharded_attention import (attend_mem_sharded,
                                                           pad_tokens)
    g = torch.Generator(device="cpu").manual_seed(61)
    n = pad_tokens(P11_N, P11_WORLD)
    mk = torch.randn(n, P11_CK, generator=g).to(dev)
    ms = (torch.rand(n, generator=g) * 3 + 1).to(dev)
    values = torch.randn(n, P11_O, P11_CV, generator=g).to(dev)
    qk = torch.randn(P11_Q, P11_CK, generator=g).to(dev)
    qe = torch.rand(P11_Q, P11_CK, generator=g).to(dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    valid[:P11_N] = ring_validity(P11_N, dev)
    mesh = make_mesh(P11_WORLD, 1)
    per = n // P11_WORLD
    sl = slice(rank * per, (rank + 1) * per)
    shard = (mk[sl].contiguous(), ms[sl].contiguous(),
             values[sl].contiguous(), valid[sl].contiguous())
    run = lambda: attend_mem_sharded(shard[0], shard[1], shard[2], qk, qe,
                                     P11_K, shard[3], mesh, axis="data")
    ak.reset_launch_counts()
    tap = ShardedAttentionTap()
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        tap.restore()
    launches = dict(ak.LAUNCHES)
    assert all(launches[k] == 1 for k in EXACT_PAIR), launches
    sharded_ms = cuda_ms(run, iters=10)
    dist.barrier()
    if rank != 0:
        return []
    ref = ak.attend_topk(mk, ms, values, qk, qe, P11_K, valid)
    single_ms = cuda_ms(lambda: ak.attend_topk(mk, ms, values, qk, qe,
                                               P11_K, valid), iters=10)
    vals, _ = ak.sim_topk(qk, qe, mk, ms, valid, P11_K + 1)
    unique = vals[:, P11_K - 1] > vals[:, P11_K]  # [Q]
    scale = ref.abs().amax(dim=(0, 2))  # each row's largest output
    gap = ((out - ref).abs().amax(dim=(0, 2)) / scale)[unique]
    assert bool((gap <= 1e-5).all()), \
        f"11c: {int((gap > 1e-5).sum())} rows beyond 1e-5, worst {gap.max()}"
    report["11c"] = {"ms": sharded_ms, "single_ms": single_ms,
                     "unique_rows": int(unique.sum()),
                     "max_rel_gap": gap.max().item()}
    print(f"{smi_line()} phase 11c attend_mem_sharded N={P11_N} over "
          f"{P11_WORLD} ranks ({per} tokens each), Q={P11_Q} Ck={P11_CK} "
          f"k={P11_K} C={P11_O * P11_CV}: {sharded_ms:.4f} ms on rank 0 "
          f"(CUDA events; the all_gather and two all_reduces included, "
          f"carried by {dist.get_backend()}) vs single-device attend_topk "
          f"{single_ms:.4f} ms; {int(unique.sum())} of {P11_Q} rows with a "
          f"unique k-th value within {gap.max().item():.3g} of their "
          f"largest output", flush=True)
    return det_kernel_rows(ak, apx, dev, ".msh", tap.calls, launches,
                           "11c, rank 0's token shard")


def p11_batched_phase(net, dev, rank, report):
    """11d: BatchedPropagator(mesh=) at B=4 480p over the 'data' axis of 2
    ranks (2 videos each) against the unsharded B=4 group on the same card
    (rank 0), 20 frames, long-term memory engaged: each video within
    phase 5's budgets (compare_single), equal ring and long-term sizes."""
    import torch.distributed as dist
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched import BatchedPropagator
    from deva_tpu_torch.parallel.mesh import make_mesh
    frames, masks, objects = batched_main_setup(dev, P11_BATCH_FRAMES)
    cfg = InferenceConfig(**P11_BATCH_CFG)

    def run(bp, fr, mk, objs):
        bp.initialize(fr[:, 0], mk, objs)
        out, ms = [], []
        for t in range(1, P11_BATCH_FRAMES):
            t0 = time.perf_counter()
            out.append(bp.step_all(fr[:, t]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1000)
        assert bp._lt_engaged, "11d: long-term memory never engaged"
        return out, ms

    ref = None
    if rank == 0:
        ref_bp = BatchedPropagator(net, cfg)
        ref, ref_ms = run(ref_bp, frames, masks, objects)
    dist.barrier()
    mesh = make_mesh(P11_WORLD, 1)
    per = B4 // P11_WORLD
    mine = slice(rank * per, (rank + 1) * per)
    bp = BatchedPropagator(net, cfg, mesh=mesh)
    got, ms = run(bp, frames[mine], masks[mine], objects[mine])
    sizes = p11_gather_floats([*bp.sizes, *bp.lt_sizes], dev)
    gathered = []
    for p in got:
        parts = [torch.empty_like(p) for _ in range(P11_WORLD)]
        dist.all_gather(parts, p.contiguous())
        gathered.append(torch.cat(parts) if rank == 0 else None)
    if rank != 0:
        return
    assert [s for r in sizes for s in r[:per]] == ref_bp.sizes.tolist()
    assert [s for r in sizes for s in r[per:]] == ref_bp.lt_sizes.tolist()
    lines = [compare_single([gathered[t][b, :len(o) + 1].cpu()
                             for t in range(len(got))],
                            [ref[t][b, :len(o) + 1].cpu()
                             for t in range(len(ref))], f"video {b}")
             for b, o in enumerate(objects)]
    report["11d"] = {"ms": statistics.median(ms[5:]),
                     "unsharded_ms": statistics.median(ref_ms[5:])}
    print(f"{smi_line()} phase 11d BatchedPropagator(mesh=) B={B4} at "
          f"{H480}x{W480} over {P11_WORLD} ranks, {P11_BATCH_FRAMES} frames, "
          f"{P11_BATCH_CFG}, long-term engaged: ms per lockstep step "
          f"(wall, median of 5+) rank 0 {report['11d']['ms']:.3f} vs the "
          f"unsharded group {report['11d']['unsharded_ms']:.3f}; ring and "
          f"long-term sizes equal; " + "; ".join(lines), flush=True)


def phase11_rank(out_path: str) -> None:
    """One rank of phase 11 (started by phase11 with torchrun's
    environment): joins the group, runs 11a-11d and writes its report
    (rank 0: the numbers and the kernels line's rows) to out_path."""
    sys.path.insert(0, ROOT)
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.ops import approx_kernels as apx
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.ops import cuda_build
    from deva_tpu_torch.parallel.mesh import init_from_env, make_mesh
    shared = torch.cuda.device_count() < P11_WORLD
    dev, rank, world = init_from_env("cuda:0" if shared else "cuda",
                                     backend="gloo" if shared else None)
    assert world == P11_WORLD
    SMI.append(os.environ.get("CHIP_SMOKE_SMI", ""))
    cuda_build.load()
    net = init_weights(DEVANetwork(), seed=0).to(dev).eval()
    drv, _, _ = drivers()
    report, laps, t0 = {}, {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        laps[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    rows = p11_vos_phase(ak, apx, drv, net, dev, rank, make_mesh(1, world),
                         report)
    lap("11a")
    p11_det_phase(net, dev, rank, make_mesh(1, world), report)
    lap("11b")
    rows += p11_attention_phase(ak, apx, dev, rank, report)
    lap("11c")
    p11_batched_phase(net, dev, rank, report)
    lap("11d")
    report["laps_s"] = laps
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "report": report, "rows": rows}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def phase11() -> list:
    """Phase 11: two ranks as subprocesses of this script with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT on
    localhost). One card: both share it over gloo (NCCL refuses two ranks
    on one card); two or more: a card each over NCCL. A rank that fails or
    passes RANK_TIMEOUT fails the phase. -> the .osh and .msh rows."""
    import socket
    shared = torch.cuda.device_count() < P11_WORLD
    print(f"phase 11: {P11_WORLD} ranks "
          + ("sharing card 0 over gloo (collectives are gloo's host copies, "
             "no NCCL time)" if shared else "on cards 0-1 over NCCL"),
          flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(P11_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase11-rank",
             outs[r]], env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                                WORLD_SIZE=str(P11_WORLD),
                                MASTER_ADDR="localhost",
                                MASTER_PORT=str(port),
                                CHIP_SMOKE_SMI=SMI[0] if SMI else ""))
            for r in range(P11_WORLD)]
        try:
            deadline = time.time() + RANK_TIMEOUT
            for r, p in enumerate(procs):
                p.wait(timeout=max(1.0, deadline - time.time()))
            codes = [p.returncode for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert codes == [0] * P11_WORLD, f"phase 11: rank exit codes {codes}"
        with open(outs[0]) as f:
            res = json.load(f)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s: "
          f"{res['report']['laps_s']}", flush=True)
    print(f"phase 11 json {json.dumps(res['report'])}", flush=True)
    return res["rows"]


# --------------------------------------------------------------------------
# phase 12: the native host library and the video demo's core
# --------------------------------------------------------------------------

# 12a: seeded consensus-style graphs (detection_clips.consensus_graphs, at
# most 150 segments), and the sizes of the timed integer programs
NATIVE_GRAPHS, NATIVE_SEED = 200, 12
NATIVE_TIMED_N = (30, 70, 150)
NATIVE_CALLS = 20


def host_ms(fn, calls: int = NATIVE_CALLS) -> float:
    """Median host ms of fn() over `calls` calls (host code alone)."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def ilp_objective(iou, sel) -> float:
    x = np.asarray(sel, np.float64)
    return float(2 * (iou @ x).sum() - x.sum())


def brute_force_objective(iou, conflict) -> float:
    """The integer program's optimum over every feasible subset."""
    n = len(iou)
    best = -np.inf
    for m in range(2 ** n):
        sel = np.array([(m >> i) & 1 for i in range(n)], bool)
        if not (conflict & np.outer(sel, sel) & ~np.eye(n, dtype=bool)).any():
            best = max(best, ilp_objective(iou, sel))
    return best


def rle_masks(h, w):
    """Phase 12a's masks at h x w: seeded pixel noise (a run every few
    pixels), demo_clip's three rectangles on a frame, all zero, all one,
    and noise that starts with 1 (the first run of zeros is empty)."""
    rng = np.random.default_rng(13)
    frame = demo_clip(h, w, 1)[0][0]
    start1 = rng.uniform(size=(h, w)) > 0.5
    start1[0, 0] = True
    return {"noise": rng.uniform(size=(h, w)) > 0.7,
            "rectangles": (frame[:, :, None] == np.array(RECT_COLORS))
            .all(-1).any(-1),
            "zeros": np.zeros((h, w), bool), "ones": np.ones((h, w), bool),
            "starts with 1": start1}


def phase_native() -> None:
    """Phase 12a, the native host library (utils/native.py, built with this
    machine's g++ from csrc/host/devac.cpp) against its Python twins: the
    integer program on NATIVE_GRAPHS seeded consensus-style graphs (n <=
    150, built as the vote builds them): selections equal where no equal
    weights meet in a component of three or more segments
    (detection_clips.has_ties), the objective equal where they do, the
    brute-force optimum for n <= 12, every selection feasible; RLE strings
    and decodes equal on 854x480 masks (rle_masks); joint_hist equal to
    np.add.at. Times both on this host: the integer program at
    NATIVE_TIMED_N segments, RLE encode and decode at 854x480. (Phase 6c
    prints its host votes split into the IoU tables and the integer
    program, whose solves run through the library.)"""
    from deva_tpu_torch import detection_clips as dc
    from deva_tpu_torch.inference import ilp
    from deva_tpu_torch.utils import native, rle
    lib = native.get_lib()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        native.build(tmp)
        build_s = time.perf_counter() - t0
    counts = dict(graphs=0, tie_free=0, tied=0, tied_differ=0, brute=0)
    largest = 0
    for iou, conflict in dc.consensus_graphs(NATIVE_SEED, NATIVE_GRAPHS):
        sel = ilp.solve_consensus_ilp(iou, conflict)
        twin = ilp.solve_consensus_ilp_python(iou, conflict)
        chosen = np.nonzero(sel)[0]
        assert not conflict[np.ix_(chosen, chosen)].any()
        counts["graphs"] += 1
        largest = max(largest, len(iou))
        if dc.has_ties(iou, conflict):
            counts["tied"] += 1
            counts["tied_differ"] += sel != twin
            assert abs(ilp_objective(iou, sel) -
                       ilp_objective(iou, twin)) < 1e-6
        else:
            counts["tie_free"] += 1
            assert sel == twin, len(iou)
        if len(iou) <= 12:
            counts["brute"] += 1
            assert abs(ilp_objective(iou, sel) -
                       brute_force_objective(iou, conflict)) < 1e-6
    assert largest <= 150 and counts["tie_free"] and counts["tied"], counts
    h, w = H480, W480
    masks = rle_masks(h, w)
    for name, m in masks.items():
        enc = rle.encode(m)
        assert enc == rle.encode_python(m), name
        for out in (rle.decode(enc), rle.decode_python(enc),
                    native.rle_decode(enc["counts"], h, w)):
            assert np.array_equal(out, m.astype(np.uint8)), name
    ids = np.random.default_rng(14).integers(0, 13, (2, h * w))
    ref = np.zeros((13, 13), np.int64)
    np.add.at(ref, (ids[0], ids[1]), 1)
    assert np.array_equal(native.joint_hist(ids[0], ids[1], 13), ref)
    timed = {}
    for n in NATIVE_TIMED_N:
        iou, conflict = dc.consensus_graph_of_size(n, n)
        assert ilp.solve_consensus_ilp(iou, conflict) == \
            ilp.solve_consensus_ilp_python(iou, conflict) or \
            dc.has_ties(iou, conflict)
        timed[f"integer program n={n}"] = (
            host_ms(lambda: ilp.solve_consensus_ilp_python(iou, conflict)),
            host_ms(lambda: ilp.solve_consensus_ilp(iou, conflict)))
    for name in ("rectangles", "noise"):
        m = masks[name]
        enc = rle.encode(m)
        timed[f"RLE encode {name}"] = (host_ms(lambda: rle.encode_python(m)),
                                       host_ms(lambda: rle.encode(m)))
        timed[f"RLE decode {name}"] = (
            host_ms(lambda: rle.decode_python(enc)),
            host_ms(lambda: rle.decode(enc)))
    print(f"phase 12a native host library {os.path.relpath(lib._name, ROOT)} "
          f"(g++ -O3 -shared -fPIC; a fresh build on this host took "
          f"{build_s:.2f} s): {counts['graphs']} consensus-style graphs "
          f"(n <= {largest}): {counts['tie_free']} tie-free, selections equal "
          f"to the Python solver's; {counts['tied']} with equal weights in a "
          f"component of 3 or more, objectives equal ({counts['tied_differ']} "
          f"of them another optimum); {counts['brute']} with n <= 12 at the "
          f"brute-force optimum; RLE strings and decodes equal to the Python "
          f"codec's on {h}x{w} masks {list(masks)}; joint_hist equal to "
          f"np.add.at. Host ms, median of {NATIVE_CALLS} calls, Python -> "
          f"native: " + ", ".join(f"{k} {a:.4f} -> {b:.4f}"
                                  for k, (a, b) in timed.items())
          + " " + smi_line(), flush=True)


class FrameRecorder:
    """The video demo's writer for phase 12b (the card's machine encodes no
    video): keeps each frame's shape and dtype."""

    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append((frame.shape, frame.dtype))


def gradio_run(ak, dev, net_cpu, mode, n_frames, h, w, reference) -> None:
    """Phase 12b: demo_gradio_torch.track_frames on n_frames of demo_clip at
    h x w, with the setup of one of the demo's tabs (its module-level
    auto_setup / text_setup; the propagation model phase 3's, object ids
    seeded as in phase 9): "auto" as run_auto with --sam_variant mobile
    at 9b's settings (SAM_NUM_POINTS_PER_SIDE DEMO_POINTS, the IoU filter
    off, --size DEMO_SIZE, a detection every 5, max missed 5,
    semi-online); "text" as run_text with RectDetector's boxes and
    Light-HQ-SAM at 9c's (prompt red.green.blue, threshold 0.35, max
    missed 10). The writer (FrameRecorder) must get exactly one BGR uint8
    frame of h x w per input frame; the objects after each saved frame must
    equal reference, those of the demo's run_demo on the same clip (9b's
    run, or for "text" a run_demo of demo_with_text_torch at h x w);
    the exact pair must launch on every frame propagated outside a voting
    window (with objects held: a core without objects has no memory to
    attend). Prints ms per propagation frame and per frame in all."""
    from deva_tpu_torch.ext import automatic_processor as ap
    from deva_tpu_torch.ext import detectors as dets
    from deva_tpu_torch.ext import with_text_processor as wp
    gc.collect()
    gd = demo_driver("demo_gradio_torch")
    text = demo_driver("demo_with_text_torch")
    args = text.make_parser().parse_args([
        "--device", dev.type, "--MOBILE_SAM_CHECKPOINT_PATH", "",
        "--LIGHT_HQ_SAM_CHECKPOINT_PATH", ""])
    net = copy.deepcopy(net_cpu).to(dev)
    demo = gd.Demo(net, text.demo_config(args, 0), vars(args), args, dev)
    if mode == "auto":
        cfg, ext_cfg, source = gd.auto_setup(
            demo, float("-inf"), DEMO_POINTS, DEMO_SIZE, 5, 5, "semionline",
            "mobile", False)
        process = ap.process_frame_automatic
    else:
        cfg, ext_cfg = gd.text_setup(demo, "red.green.blue", 0.35, DEMO_SIZE,
                                     5, 10, "semionline")
        source = RectDetector(dets._mobile_sam_from_args(args,
                                                         "sam_hq_light"))
        process = wp.process_frame_with_text
    frames, _ = demo_clip(h, w, n_frames)
    history, frame_ms, frame_launches, held = [], {}, {}, {}
    real_saver, real_core = gd.ResultSaver, gd.InferenceCore

    class HistorySaver(real_saver):
        def save_mask(self, prob, frame_name, *a, **kw):
            super().save_mask(prob, frame_name, *a, **kw)
            history.append((int(frame_name[:7]),
                            self.object_manager.num_obj))

    def seeded_core(*a, **kw):
        core = real_core(*a, **kw)
        core.object_manager._rng = np.random.default_rng(5)
        return core

    def timed(deva, src, ext, frame_path, saver, ti, **kw):
        held[ti] = deva.object_manager.num_obj
        before = dict(ak.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process(deva, src, ext, frame_path, saver, ti, **kw)
        torch.cuda.synchronize()
        frame_ms[ti] = (time.perf_counter() - t0) * 1000
        frame_launches[ti] = {k: ak.LAUNCHES[k] - before[k]
                              for k in EXACT_PAIR}

    writer = FrameRecorder()
    gd.ResultSaver, gd.InferenceCore = HistorySaver, seeded_core
    ak.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        core = gd.track_frames(demo, cfg, ext_cfg, source, frames, n_frames,
                               writer, timed)
        torch.cuda.synchronize()
    finally:
        gd.ResultSaver, gd.InferenceCore = real_saver, real_core
    wall = time.perf_counter() - t0
    launches = dict(ak.LAUNCHES)
    label = "phase 12b video demo core (" + (
        "run_auto, mobile)" if mode == "auto" else "run_text, Light-HQ-SAM)")
    assert writer.frames == [((h, w, 3), np.dtype(np.uint8))] * n_frames, \
        (label, len(writer.frames), writer.frames[:2])
    assert history == reference, (label, history, reference)
    votes, window = demo_schedule(cfg, n_frames)
    prop = [ti for ti in range(n_frames) if ti not in window]
    tracked = [ti for ti in prop if held[ti]]  # a core with memory attends
    missing = [ti for ti in tracked if min(frame_launches[ti].values()) < 1]
    assert tracked and not missing, (label, missing, frame_launches)
    print(f"{label}: demo_gradio_torch.track_frames on {n_frames} frames of "
          f"{h}x{w} (--size {cfg.size}, a detection every "
          f"{cfg.detection_every}, {cfg.num_voting_frames} voting frames, "
          f"semi-online): {len(writer.frames)} BGR uint8 {h}x{w} frames to "
          f"the writer; objects after each saved frame equal to the demo's "
          f"run_demo on this clip (last {history[-1][1]}); both exact "
          f"kernels on each of the {len(tracked)} frames propagated outside "
          f"a voting window with objects held ({len(prop)} outside a "
          f"window); ms per propagation frame median "
          f"{statistics.median(frame_ms[ti] for ti in prop):.3f}, per frame "
          f"in all (the buffer's flush and the saver's blends included) "
          f"{wall * 1000 / n_frames:.3f}; launches {launches}; objects "
          f"{core.object_manager.num_obj} " + smi_line(), flush=True)
    del core, net, demo, source


def phase12(ak, net_cpu, dev, history_b) -> None:
    """Phases 12a (the native host library) and 12b (the video demo's
    core, run_auto's path held to 9b's objects over time, history_b, and
    run_text's to a run_demo of demo_with_text_torch on the same 480p clip
    (9c runs at 720p)), each timed on the host clock."""
    t0 = time.perf_counter()
    phase_native()
    t1 = time.perf_counter()
    gradio_run(ak, dev, net_cpu, "auto", DEMO_FRAMES, H480, W480, history_b)
    history_text = demo_run(
        ak, dev, net_cpu, "text", DEMO_FRAMES, H480, W480, keep_calls=False,
        name=f"12b reference, demo_with_text_torch.run_demo at "
             f"{H480}x{W480}")[4]
    gradio_run(ak, dev, net_cpu, "text", DEMO_FRAMES, H480, W480,
               history_text)
    t2 = time.perf_counter()
    print(f"phase 12 took {t2 - t0:.1f} s: 12a {t1 - t0:.1f}, 12b "
          f"{t2 - t1:.1f}", flush=True)


# --------------------------------------------------------------------------
# phase 13: the command lines (the drivers and demos from argv, with files)
# --------------------------------------------------------------------------

# 13's budgets, the card's outputs against the CPU twin's: the share of a
# PNG's pixels whose labels agree (tests/test_torch_driver.py's budget); a
# score map's largest step (prob * 255 truncated: 1/255); J and F of the
# card's masks scored against the CPU's; the PSNR of the two decoded
# tracked.mp4 (blends of the same decoded frames, so only the pixels whose
# label differs, and the mp4v encoder's response to them, set it)
CLI_LABEL_SHARE = 0.99
CLI_SCORE_STEP = 1
CLI_JF_FLOOR = 0.99
CLI_PSNR_DB = 30.0
# 13b: a batched video's PNGs against the single-stream card run's
# (tests/test_batched.py: at most 2% argmax flips a frame)
CLI_BATCH_FLIPS = 0.02
# a command's time limit (s); the CPU twins, which run while the card's
# commands run: two at a time (the twins' queue, not the card's commands,
# sets the phase's length), at 3 threads each, on the card's 8-core host
CLI_TIMEOUT = 900
CLI_CPU_THREADS = 3
CLI_CPU_WORKERS = 2
# a rehearsal's runs at a time (about 0.75 GiB of host memory each at
# --size 120)
CLI_REHEARSAL_RUNS = 14
# 13a's YouTube-VOS layout: each video's frames and the frame on which its
# second object's mask arrives
CLI_YT = ((8, 3), (10, 5), (12, 6))
# 13c-13e: example/vipseg's clip (4 frames of 1280x720 with PNG and JSON
# detections), the recorded text detections of its frames and their prompt
VIPSEG = os.path.join(ROOT, "example", "vipseg")
VIPSEG_CLIP = "12_1mWNahzcsAc"
REPLAY_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "replay_dets_vipseg.npz")
REPLAY_PROMPT = "person.bench.tree"
# 13g: timed rounds of a reader's frames, saved frames a saver branch, and
# the channels of the saved probabilities (background and 10 objects)
IO_ROUNDS = 5
IO_SAVES = 20
IO_CHANNELS = 11


def cli_number(text: str, key: str):
    """The number on a driver's last `<key>: <number>` line, or None."""
    found = re.findall(rf"^{re.escape(key)}: (\S+)$", text, re.M)
    return float(found[-1]) if found else None


def check_cli(label: str, rc: int, text: str) -> None:
    """A command's run: exit code 0 and no "Skipping" line (the per-video
    fault barrier logs a failed video and exits 0)."""
    assert rc == 0, f"{label}: exit code {rc}\n{text[-4000:]}"
    skipped = [ln for ln in text.splitlines() if ln.startswith("Skipping ")]
    assert not skipped, f"{label}: a skipped video {skipped}\n{text[-4000:]}"


def cli(script: str, args, threads=None) -> dict:
    """`python <script> <args>` from the repo root, as a user types it (a
    CPU twin at `threads` threads). The hub stays offline: no command of
    phase 13 loads a model by its hub id. Fails as check_cli says. -> the
    wall seconds, the FPS and peak-memory lines' numbers (None where the
    command prints none) and its standard output."""
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    check_cli(f"{script} {' '.join(args)}", proc.returncode,
              proc.stdout + proc.stderr)
    return {"wall_s": wall, "fps": cli_number(proc.stdout, "FPS"),
            "peak_mb": cli_number(proc.stdout, "Max allocated memory (MB)"),
            "stdout": proc.stdout}


class CliPairs:
    """Phase 13's commands: each runs on the card in the caller's thread,
    as a user runs it (--device defaults to cuda), while its CPU twin, the
    same command with --device cpu on the same files, runs on one of
    CLI_CPU_WORKERS threads at CLI_CPU_THREADS threads. A rehearsal names
    another device as `card`; then both sides of every command run on
    CLI_REHEARSAL_RUNS threads, one thread each. The two write under
    <tmp>/out/card/<name> and <tmp>/out/cpu/<name> (one name: the
    YouTube-VOS zip takes the output directory's)."""

    def __init__(self, tmp: str, card: str, commands: int):
        from concurrent.futures import ThreadPoolExecutor
        self.tmp, self.card = tmp, card
        rehearsal = card != "cuda"
        self.threads = 1 if rehearsal else CLI_CPU_THREADS
        self.pool = ThreadPoolExecutor(min(2 * commands, CLI_REHEARSAL_RUNS)
                                       if rehearsal else CLI_CPU_WORKERS)
        self.runs = {}

    def out(self, name: str, side: str) -> str:
        return os.path.join(self.tmp, "out", side, name)

    def run(self, name: str, script: str, args, twin: bool = True) -> None:
        """Starts the command (and its twin, unless twin is False);
        result(name, side) waits for a side's run."""
        def argv(side, device):
            extra = [] if device == "cuda" else ["--device", device]
            return [*args, "--output", self.out(name, side), *extra]

        cpu = self.pool.submit(cli, script, argv("cpu", "cpu"),
                               self.threads) if twin else None
        card = cli(script, argv("card", self.card)) if self.card == "cuda" \
            else self.pool.submit(cli, script, argv("card", self.card),
                                  self.threads)
        self.runs[name] = {"card": card, "cpu": cpu}

    def result(self, name: str, side: str) -> dict:
        """cli's result, and the output directory as "out"."""
        run = self.runs[name][side]
        return dict(run if isinstance(run, dict) else run.result(),
                    out=self.out(name, side))

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def file_tree(root: str) -> list:
    """The files under root, as sorted relative paths."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def same_tree(ref: str, got: str, label: str) -> list:
    """The same files, and at least one, under both roots. -> their paths."""
    a, b = file_tree(ref), file_tree(got)
    assert a and a == b, (f"{label}: the file trees differ: only the CPU's "
                          f"{sorted(set(a) - set(b))[:8]}, only the card's "
                          f"{sorted(set(b) - set(a))[:8]}")
    return a


def read_labels(p: str) -> np.ndarray:
    """A PNG's labels: RGB id PNGs (the long-id layouts) as ids, palette
    and grey PNGs as their values."""
    from PIL import Image
    from deva_tpu_torch.utils.pano_utils import rgb_to_id
    with Image.open(p) as im:
        a = np.asarray(im)
    return rgb_to_id(a) if a.ndim == 3 else a.astype(np.int64)


def id_matching(ref_frames, got_frames) -> dict:
    """The one-to-one matching of two runs' ids over a video's frames that
    maximises the pixels they share (the long-id layouts draw ids per run):
    {got id: ref id}; a got id left over maps to -1."""
    from scipy.optimize import linear_sum_assignment
    ua = np.unique(np.concatenate([f.ravel() for f in ref_frames]))
    ub = np.unique(np.concatenate([f.ravel() for f in got_frames]))
    shared = np.zeros(len(ua) * len(ub), np.int64)
    for a, b in zip(ref_frames, got_frames):
        shared += np.bincount(np.searchsorted(ua, a.ravel()) * len(ub) +
                              np.searchsorted(ub, b.ravel()),
                              minlength=len(shared))
    rows, cols = linear_sum_assignment(-shared.reshape(len(ua), len(ub)))
    pairs = {int(ub[c]): int(ua[r]) for r, c in zip(rows, cols)}
    return {int(u): pairs.get(int(u), -1) for u in ub}


def compare_labels(ref: str, got: str, names, label: str,
                   matched: bool = False, share: float = CLI_LABEL_SHARE,
                   near_tie=None, got_name=None) -> dict:
    """The label PNGs among `names` under two roots (got_name(name) names
    the got run's file, by default the same path), frame by frame: the same
    shape and at least `share` of the pixels equal; matched: the got run's
    ids first mapped to the ref run's (id_matching, per directory).
    near_tie(name, differing) checks the pixels that differ. -> the worst
    share, each frame's differing pixels ("differ"), each directory's
    matching ("matchings") and the PNGs ("frames")."""
    pngs = [n for n in names if n.endswith(".png")]
    assert pngs, f"{label}: no PNG"
    by_dir = {}
    for n in pngs:
        by_dir.setdefault(os.path.dirname(n), []).append(n)
    worst, differ, matchings = 1.0, {}, {}
    for d, group in by_dir.items():
        a = [read_labels(os.path.join(ref, n)) for n in group]
        b = [read_labels(os.path.join(got, got_name(n) if got_name else n))
             for n in group]
        if matched:
            m = matchings[d] = id_matching(a, b)
            keys = np.array(sorted(m))
            lut = np.array([m[k] for k in keys])
            b = [lut[np.searchsorted(keys, x)] for x in b]
        for n, x, y in zip(group, a, b):
            assert x.shape == y.shape, (label, n, x.shape, y.shape)
            off = x != y
            agree = 1.0 - off.mean()
            assert agree >= share, \
                f"{label}: {n} labels agree on {agree:.4%} < {share:.0%}"
            if near_tie is not None and off.any():
                near_tie(n, off)
            worst = min(worst, agree)
            differ[n] = int(off.sum())
    return {"worst": worst, "differ": differ, "matchings": matchings,
            "frames": len(pngs)}


def compare_scores(ref: str, got: str, names, label: str) -> int:
    """Scores/<video>/<frame>.npy (uint8 prob * 255, truncated) within
    CLI_SCORE_STEP everywhere; backward.npy equal. -> the score maps."""
    maps = 0
    for n in names:
        if not n.endswith(".npy"):
            continue
        a = np.load(os.path.join(ref, n), allow_pickle=True)
        b = np.load(os.path.join(got, n), allow_pickle=True)
        if n.endswith("backward.npy"):
            assert a.item() == b.item(), (label, n, a.item(), b.item())
            continue
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, \
            (label, n, a.dtype, b.dtype, a.shape, b.shape)
        step = int(np.abs(a.astype(np.int16) - b).max())
        assert step <= CLI_SCORE_STEP, f"{label}: {n} scores apart by {step}"
        maps += 1
    assert maps, f"{label}: no score map"
    return maps


def compare_amp_scores(ref: str, got: str, names, label: str) -> str:
    """A bf16 run's score maps (uint8 prob * 255) against its CPU twin's, by
    tests/test_amp.py's whole-clip budget per frame (compare_dtypes'): mean
    |dprob| < 0.03, label flips where the CPU's top two lie more than 0.25
    apart under 2% of the frame, none where they lie more than 0.6 apart.
    (The two sum bf16 products in other orders, and with random weights
    every pixel lies below the 0.25 margin: labels alone say little.)
    backward.npy equal. -> what held."""
    worst_mean = worst_conf = worst_margin = 0.0
    for n in names:
        if not n.endswith(".npy"):
            continue
        a = np.load(os.path.join(ref, n), allow_pickle=True)
        b = np.load(os.path.join(got, n), allow_pickle=True)
        if n.endswith("backward.npy"):
            assert a.item() == b.item(), (label, n, a.item(), b.item())
            continue
        pa, pb = a / 255.0, b / 255.0
        top = np.sort(pa, axis=0)
        margin = top[-1] - top[-2]
        flips = pa.argmax(0) != pb.argmax(0)
        mean = float(np.abs(pa - pb).mean())
        conf = float((flips & (margin > 0.25)).mean())
        flipped = float(margin[flips].max()) if flips.any() else 0.0
        assert mean < 0.03 and conf < 0.02 and flipped <= 0.6, \
            (label, n, mean, conf, flipped)
        worst_mean, worst_conf = max(worst_mean, mean), max(worst_conf, conf)
        worst_margin = max(worst_margin, flipped)
    return (f"score maps by tests/test_amp.py's budget: mean |dprob| at "
            f"most {worst_mean:.4g} (0.03), confident flips at most "
            f"{worst_conf:.3%} (2%), largest flipped margin "
            f"{worst_margin:.3g} (0.6); backward.npy equal")


def score_near_tie(scores_root: str, label: str,
                   max_gap: float = DET_TOL * 255 + 1):
    """near_tie for a --save_scores run: a pixel whose label differs must
    lie where the top two channels of the score map under scores_root
    (Scores/<video>/<frame>.npy, uint8 prob * 255 truncated) are at most
    max_gap apart; by default the CPU run's within DET_TOL (DET_TOL * 255
    + 1 in the truncated maps)."""
    def check(name, differ):
        rel = name[len("Annotations/"):] if name.startswith("Annotations/") \
            else name
        scores = np.load(os.path.join(scores_root, "Scores", rel[:-4] +
                                      ".npy"))
        top = np.sort(scores.astype(np.int16), axis=0)
        gap = int((top[-1] - top[-2])[differ].max())
        assert gap <= max_gap, f"{label}: {name} differs where the top " \
            f"two scores are {gap} / 255 apart"
    return check


def compare_pred_json(ref: str, got: str, png_of, labels: dict,
                      label: str) -> int:
    """pred.json (VIPSeg's or the demo's): the same videos and frames, each
    frame's segments one to one under the id matching with the same fields,
    each but the id and the area equal (a float score within DET_TOL), and
    each area (where the file has one) apart by no more than the frame's
    differing pixels. png_of(video_id,
    file_name) names the frame's PNG among compare_labels' ("differ",
    "matchings"). -> the segments compared."""
    def videos(root):
        with open(os.path.join(root, "pred.json")) as f:
            anns = json.load(f)["annotations"]
        if anns and "video_id" in anns[0]:
            return [(v["video_id"], v["annotations"]) for v in anns]
        return [(None, anns)]

    a, b = videos(ref), videos(got)
    assert [v for v, _ in a] == [v for v, _ in b], label
    segments = 0
    assert any(s["segments_info"] for _, frames in a for s in frames), \
        f"{label}: pred.json holds no segment"
    for (vid, fa), (_, fb) in zip(a, b):
        assert [f["file_name"] for f in fa] == [f["file_name"] for f in fb], \
            (label, vid)
        for x, y in zip(fa, fb):
            png = png_of(vid, x["file_name"])
            match = labels["matchings"][os.path.dirname(png)]
            mine = {match.get(s["id"], -1): s for s in y["segments_info"]}
            theirs = {s["id"]: s for s in x["segments_info"]}
            assert sorted(mine) == sorted(theirs), \
                f"{label}: {png} segments {sorted(theirs)} vs {sorted(mine)}"
            for sid, s in theirs.items():
                t = mine[sid]
                assert sorted(s) == sorted(t), (label, png, s, t)
                for k in set(s) - {"id", "area"}:
                    # a detector's float score within DET_TOL, else equal
                    assert abs(s[k] - t[k]) <= DET_TOL \
                        if isinstance(s[k], float) else s[k] == t[k], \
                        (label, png, k, s, t)
                assert abs(s.get("area", 0) - t.get("area", 0)) <= \
                    labels["differ"][png], (label, png, s, t)
                segments += 1
    return segments


def video_frames(p: str) -> list:
    """A video's frames, decoded by cv2."""
    import cv2
    cap = cv2.VideoCapture(p)
    frames = []
    try:
        ok, frame = cap.read()
        while ok:
            frames.append(frame)
            ok, frame = cap.read()
    finally:
        cap.release()
    return frames


def compare_videos(ref: str, got: str, label: str) -> float:
    """Two tracked.mp4: the same frame count and size, and a PSNR between
    their decoded frames of at least CLI_PSNR_DB. -> the PSNR in dB."""
    a, b = video_frames(ref), video_frames(got)
    assert a and len(a) == len(b), (label, len(a), len(b))
    assert all(x.shape == y.shape for x, y in zip(a, b)), label
    mse = np.mean([np.mean((x.astype(np.float64) - y) ** 2)
                   for x, y in zip(a, b)])
    psnr = float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 /
                                                              mse))
    assert psnr >= CLI_PSNR_DB, f"{label}: PSNR {psnr:.2f} dB"
    return psnr


def save_image(p: str, array: np.ndarray, palette=None) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(p), exist_ok=True)
    img = Image.fromarray(array)
    if palette is not None:
        img.putpalette(palette)
    img.save(p)


def cli_layouts(tmp: str, parts: str) -> dict:
    """Phase 13's inputs under <tmp>/data, for the parts named: "yt" (a),
    a YouTube-VOS layout (Y19) of synthetic 854x480 JPEG videos (CLI_YT:
    object 1 from frame 0, object 2's own mask mid-video, meta.json listing
    every other frame from each object's first); "g4" (b), four copies of
    example/vos's clip; "vip2" (c), example/vipseg and a copy (images/,
    source/); "mp4" (e), example/vipseg's frames ("rgb") as an mp4 (cv2,
    mp4v); "ref" and "sal" (f), example/vos's frames with a soft-mask box
    that moves down each frame (per object with scores.csv for the
    referring driver, per video for saliency); "mask720" (g), a
    first-frame palette mask for the 1280x720 frames."""
    import shutil
    from PIL import Image
    from deva_tpu_torch.utils.palette import davis_palette
    data = os.path.join(tmp, "data")
    vos = os.path.join(ROOT, "example", "vos")
    clip = os.path.join(VIPSEG, "images", VIPSEG_CLIP)
    palette = davis_palette()
    lay = {}
    if "a" in parts:
        yt = lay["yt"] = os.path.join(data, "yt")
        rng, meta = np.random.default_rng(16), {}
        for v, (t, second) in enumerate(CLI_YT):
            vid = f"v{v}"
            for i, f in enumerate(synthetic_video(rng, H480, W480, t)):
                save_image(os.path.join(yt, "all_frames", "valid_all_frames",
                                        "JPEGImages", vid, f"{i:05d}.jpg"),
                           np.clip(128 + 48 * f, 0, 255).astype(np.uint8))
            for obj, ti, rows, cols in (
                    (1, 0, (60, 300), (100 + 40 * v, 400 + 40 * v)),
                    (2, second, (260, 450), (480, 760))):
                m = np.zeros((H480, W480), np.uint8)
                m[slice(*rows), slice(*cols)] = obj
                save_image(os.path.join(yt, "valid", "Annotations", vid,
                                        f"{ti:05d}.png"), m, palette)
            meta[vid] = {"objects": {
                str(obj): {"category": "x", "frames": [
                    f"{i:05d}" for i in range(start, t, 2)]}
                for obj, start in ((1, 0), (2, second))}}
        with open(os.path.join(yt, "valid", "meta.json"), "w") as f:
            json.dump({"videos": meta}, f)
    if "b" in parts:
        lay["g4"] = os.path.join(data, "g4")
        for k in range(B4):
            for sub in ("JPEGImages", "Annotations"):
                shutil.copytree(os.path.join(vos, sub, "bmx-trees"),
                                os.path.join(lay["g4"], sub,
                                             f"bmx-trees-{k}"))
    if "c" in parts:
        lay["vip2"] = os.path.join(data, "vip2")
        for sub in ("images", "source"):
            for name in (VIPSEG_CLIP, VIPSEG_CLIP + "-copy"):
                shutil.copytree(os.path.join(VIPSEG, sub, VIPSEG_CLIP),
                                os.path.join(lay["vip2"], sub, name))
    if "e" in parts:
        import cv2
        lay["rgb"] = [np.asarray(Image.open(os.path.join(clip, n))
                                 .convert("RGB"))
                      for n in sorted(os.listdir(clip))]
        h, w = lay["rgb"][0].shape[:2]
        os.makedirs(data, exist_ok=True)
        lay["mp4"] = os.path.join(data, "clip.mp4")
        writer = cv2.VideoWriter(lay["mp4"], cv2.VideoWriter_fourcc(*"mp4v"),
                                 6, (w, h))
        for frame in lay["rgb"]:
            writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
        writer.release()
    if "f" in parts:
        frames = sorted(os.listdir(os.path.join(vos, "JPEGImages",
                                                "bmx-trees")))
        for kind in ("ref", "sal"):
            root = lay[kind] = os.path.join(data, kind)
            shutil.copytree(os.path.join(vos, "JPEGImages", "bmx-trees"),
                            os.path.join(root, "JPEGImages", "bmx-trees"))
            mask_dir = os.path.join(root, "masks", "bmx-trees")
            obj_dir = os.path.join(mask_dir, "1") if kind == "ref" \
                else mask_dir
            for i, n in enumerate(frames):
                m = np.zeros((H480, W480), np.uint8)
                m[120 + 12 * i:360 + 12 * i, 300:560] = 255
                save_image(os.path.join(obj_dir, n[:-4] + ".png"), m)
            if kind == "ref":
                with open(os.path.join(mask_dir, "scores.csv"), "w") as f:
                    f.write("\n".join(f"{n[:-4]}.png,1,{0.5 + 0.1 * i:.2f}"
                                      for i, n in enumerate(frames)))
    if "g" in parts:
        m = np.zeros((720, 1280), np.uint8)
        m[200:500, 300:700], m[100:300, 800:1100] = 1, 2
        lay["mask720"] = os.path.join(data, "mask720")
        save_image(os.path.join(lay["mask720"], sorted(os.listdir(clip))[0]
                                [:-4] + ".png"), m, palette)
    return lay


def write_weights(tmp: str) -> str:
    """The full-width propagation model (ModelConfig()) with the weights
    the drivers init when they find none (init_weights seed 42), as an
    upstream .pth (the state-dict layout --model takes), written once for
    every command. With these the semi-online vote on example/vipseg admits
    objects (with phase 3's seed 0 it admits none, and pred.json would
    hold no segment to compare)."""
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    out = os.path.join(tmp, "weights.pth")
    torch.save(init_weights(DEVANetwork(), seed=42).state_dict(), out)
    return out


def cli_commands(weights: str, lay: dict, size_args, parts: str) -> list:
    """Phase 13's subprocess commands of the parts named, each as (name,
    label, script, flags without --output and --device); the flags pass
    --raise_on_error wherever the driver has it."""
    common = ["--model", weights, "--raise_on_error", *size_args]
    g = ["--dataset", "G", "--generic_path",
         os.path.join(ROOT, "example", "vos"), *common]
    vip = ["--dataset", "vipseg", "--no_metrics", *common]
    one = ["--img_path", os.path.join(VIPSEG, "images"), "--mask_path",
           os.path.join(VIPSEG, "source"), *vip]
    vos, det = "evaluation/eval_vos_torch.py", \
        "evaluation/eval_with_detections_torch.py"
    cmds = []
    if "a" in parts:
        cmds += [
            ("a-exact", "13a eval_vos_torch.py G exact", vos, g),
            # --save_scores: bf16 is held to tests/test_amp.py's budget,
            # which reads probabilities (compare_amp_scores)
            ("a-approx", "13a eval_vos_torch.py G --chunk 5 --topk_method "
             "approx --amp --save_scores", vos,
             g + ["--chunk", "5", "--topk_method", "approx", "--amp",
                  "--save_scores"]),
            ("a-flip", "13a eval_vos_torch.py G --flip --save_scores", vos,
             g + ["--flip", "--save_scores"]),
            ("a-yt", "13a eval_vos_torch.py Y19", vos,
             ["--dataset", "Y19", "--y19_path", lay["yt"], *common])]
    if "b" in parts:
        cmds.append(("b-batched", f"13b eval_vos_batched_torch.py --batch "
                     f"{B4}", "evaluation/eval_vos_batched_torch.py",
                     ["--dataset", "G", "--generic_path", lay["g4"],
                      "--batch", str(B4), *common]))
    if "c" in parts:
        cmds += [
            ("c-semi", "13c eval_with_detections_torch.py semi-online", det,
             one),
            ("c-online", "13c eval_with_detections_torch.py online", det,
             one + ["--temporal_setting", "online"]),
            ("c-batched", "13c eval_with_detections_batched_torch.py "
             "--batch 2", "evaluation/eval_with_detections_batched_torch.py",
             ["--img_path", os.path.join(lay["vip2"], "images"),
              "--mask_path", os.path.join(lay["vip2"], "source"), *vip,
              "--batch", "2"])]
    if "d" in parts:
        # online: semi-online's vote admits none of the seeded SAM's masks
        # on this clip, and the outputs would hold no object
        cmds.append(("d-auto", "13d demo_automatic_torch.py --sam_variant "
                     f"mobile --SAM_NUM_POINTS_PER_SIDE {DEMO_POINTS} "
                     "--SAM_PRED_IOU_THRESHOLD=-inf (9b's; defaults 64 and "
                     "0.88) --temporal_setting online",
                     "demo/demo_automatic_torch.py",
                     ["--img_path", os.path.join(VIPSEG, "images",
                                                 VIPSEG_CLIP),
                      "--sam_variant", "mobile",
                      "--MOBILE_SAM_CHECKPOINT_PATH", "",
                      "--SAM_NUM_POINTS_PER_SIDE", str(DEMO_POINTS),
                      "--SAM_PRED_IOU_THRESHOLD=-inf",
                      "--temporal_setting", "online", *common]))
    if "f" in parts:
        for name, script, kind in (("f-ref", "eval_ref_davis_torch.py", "ref"),
                                   ("f-sal", "eval_saliency_torch.py", "sal")):
            cmds.append((name, f"13f {script}", f"evaluation/{script}",
                         ["--img_path", os.path.join(lay[kind], "JPEGImages"),
                          "--mask_path", os.path.join(lay[kind], "masks"),
                          "--num_voting_frames", "3", *common]))
    return cmds


def cli_tools(pairs: CliPairs, names) -> dict:
    """Phase 13's scoring commands over the runs' files, queued on the
    twins' workers (each waits for the runs it reads): for 13a's --flip
    --save_scores run, scripts/merge_multi_scale_torch.py over each side's
    Scores/ ("merge card", "merge cpu"); for 13a's exact run,
    evaluation/eval_jf_torch.py scoring a copy of the card's PNGs (it
    writes its tables beside them) against the CPU's ("jf"). -> futures of
    cli's results."""
    import shutil

    def merge(side):
        out = pairs.result("a-flip", side)["out"]
        return cli("scripts/merge_multi_scale_torch.py",
                   ["--dataset", "D", "--list", out, "--output",
                    pairs.out("a-merge", side), "--num_proc", "1"])

    def jf():
        ref = pairs.result("a-exact", "cpu")["out"]
        got = pairs.out("a-jf", "card")
        shutil.copytree(pairs.result("a-exact", "card")["out"], got)
        return cli("evaluation/eval_jf_torch.py",
                   ["--results_path", got, "--gt_path", ref])

    tools = {}
    if "a-flip" in names:
        for side in ("card", "cpu"):
            tools[f"merge {side}"] = pairs.pool.submit(merge, side)
    if "a-exact" in names:
        tools["jf"] = pairs.pool.submit(jf)
    return tools


def check_batched_vos(label: str, card: dict, pairs: CliPairs) -> str:
    """13b, which has no CPU twin: four copies of example/vos's clip, so
    each video's PNGs are the files of 13a's exact card run (itself held to
    its CPU twin), with labels agreeing on at least 1 - CLI_BATCH_FLIPS of
    each frame (tests/test_batched.py: batch-4 convolutions round
    otherwise). -> what held."""
    exact = pairs.out("a-exact", "card")
    single = [n for n in file_tree(exact) if n.endswith(".png")]
    names = file_tree(card["out"])
    assert names == sorted(n.replace("bmx-trees", f"bmx-trees-{k}")
                           for k in range(B4) for n in single), (label, names)
    worst = min(compare_labels(
        exact, card["out"], single, f"{label} video {k} against 13a",
        share=1 - CLI_BATCH_FLIPS,
        got_name=lambda n, k=k: n.replace("bmx-trees", f"bmx-trees-{k}"))
        ["worst"] for k in range(B4))
    return (f"{len(names)} PNGs, 13a's files for each video; each video's "
            f"labels agree with 13a's single-stream card run on >= "
            f"{worst:.4%}")


def check_command(name: str, label: str, card: dict, twin: dict,
                  pairs: CliPairs, tools: dict) -> str:
    """The card's output tree of command `name` against its CPU twin's, by
    phase 13's budgets (and, for 13a's --flip --save_scores, the merge of
    each side's score maps; for 13a's exact run, J and F). -> what held."""
    ref, got = twin["out"], card["out"]
    names = same_tree(ref, got, label)
    matched = name[0] in "cd"
    near = score_near_tie(ref, label) if name == "a-flip" else None
    amp = name == "a-approx"
    labels = compare_labels(ref, got, names, label, matched=matched,
                            near_tie=near, share=0.0 if amp else
                            CLI_LABEL_SHARE)
    held = [f"same {len(names)} files, {labels['frames']} PNGs with labels "
            f"agreeing on >= {labels['worst']:.4%}"
            + (" under a one-to-one id matching" if matched else "")]
    if amp:
        held.append(compare_amp_scores(ref, got, names, label))
    if name == "a-flip":
        held.append(f"{compare_scores(ref, got, names, label)} score maps "
                    f"within {CLI_SCORE_STEP}/255, backward.npy equal, "
                    f"differing labels only at near-ties")
        merged = {}
        for side in ("card", "cpu"):
            tools[f"merge {side}"].result()
            merged[side] = pairs.out("a-merge", side)
        m_names = same_tree(merged["cpu"], merged["card"], "13a merge")
        m = compare_labels(merged["cpu"], merged["card"], m_names,
                           "13a merge")
        # the merge's argmax of the truncated maps departs from the run's
        # own labels only where two channels tie in the map
        own = compare_labels(
            merged["card"], got, m_names, "13a merge against the run's PNGs",
            share=0.0, near_tie=score_near_tie(got, "13a merge", 0),
            got_name=lambda n: os.path.join("Annotations", n))
        held.append(f"merge_multi_scale_torch.py: {m['frames']} PNGs, card "
                    f"vs CPU >= {m['worst']:.4%}; against the run's own "
                    f"PNGs >= {own['worst']:.4%}, differing only where the "
                    f"score map ties")
    if name == "a-yt":
        import zipfile
        zips = []
        for out in (ref, got):
            with zipfile.ZipFile(os.path.join(
                    out, os.path.basename(out) + ".zip")) as z:
                zips.append(sorted(z.namelist()))
        assert zips[0] == zips[1] and zips[1], (label, zips)
        second = [n for n in names if n.endswith(".png") and
                  2 in read_labels(os.path.join(got, n))]
        assert second, f"{label}: object 2 never painted"
        held.append(f"zip members equal ({len(zips[1])}), object 2 painted "
                    f"on {len(second)} saved frames")
    if name[0] == "c" or name == "d-auto":
        def png_of(vid, file_name):
            return os.path.join("pan_pred", vid, file_name[:-4] + ".png") \
                if vid is not None else \
                os.path.join("Annotations", file_name[:-4] + ".png")
        segments = compare_pred_json(ref, got, png_of, labels, label)
        held.append(f"pred.json: {segments} segments equal under the "
                    f"matching")
    if name[0] == "f":
        from pathlib import Path
        keys = [n for n in names if n.endswith("key.txt")]
        texts = [[Path(r, n).read_text() for n in keys] for r in (ref, got)]
        assert keys and texts[0] == texts[1], (label, texts)
        held.append(f"key.txt equal ({texts[1][0]!r})")
    if name == "a-exact":
        scores = dict(kv.split("=") for kv in tools["jf"].result()
                      ["stdout"].strip().splitlines()[-1].split())
        j, f = float(scores["J_mean"]), float(scores["F_mean"])
        assert min(j, f) >= CLI_JF_FLOOR, (label, scores)
        held.append(f"eval_jf_torch.py, the card's PNGs against the CPU's: "
                    f"J {j:.4f}, F {f:.4f}")
    return "; ".join(held)


def cli_line(label: str, card: dict, twin, held: str) -> None:
    def fmt(x, spec):
        return "none" if x is None else format(x, spec)
    twin = "no CPU twin" if twin is None else \
        f"CPU twin {twin['wall_s']:.2f} s wall, FPS {fmt(twin['fps'], '.3f')}"
    print(f"phase {label}: card {card['wall_s']:.2f} s wall, FPS "
          f"{fmt(card['fps'], '.3f')}, peak {fmt(card['peak_mb'], '.1f')} "
          f"MiB; {twin}; {held} " + smi_line(), flush=True)


class NearestReplay:
    """The replay detector (ext/detectors.py:ReplayDetector, keyed by a
    frame's exact bytes) for frames decoded from a lossy video of the
    recorded frames: each frame takes the record of the recorded frame
    nearest to it (mean absolute difference). `gaps` keeps, for each call,
    the nearest and the second nearest distance."""

    def __init__(self, replay, frames):
        self.replay, self.frames, self.gaps = replay, frames, []

    def _nearest(self, image_np):
        d = sorted((float(np.abs(image_np.astype(np.int16) - f).mean()), i)
                   for i, f in enumerate(self.frames))
        self.gaps.append((d[0][0], d[1][0]))
        return self.frames[d[0][1]]

    def detect(self, image_np, *args):
        return self.replay.detect(self._nearest(image_np), *args)

    def masks_for_boxes(self, image_np, boxes):
        return self.replay.masks_for_boxes(self._nearest(image_np), boxes)


def run_in_process(fn, label: str) -> dict:
    """fn() with its standard output and error kept, timed (the device
    drained after it); -> cli's keys, checked as check_cli checks a
    command."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_cli(label, 0, out.getvalue() + err.getvalue())
    return {"wall_s": wall, "fps": cli_number(out.getvalue(), "FPS"),
            "peak_mb": cli_number(out.getvalue(),
                                  "Max allocated memory (MB)"),
            "stdout": out.getvalue()}


class SeededIds:
    """The demo modules' InferenceCore, patched for a run so that each core
    draws its object ids from a seeded generator (as phases 9 and 12 do):
    then two runs that admit the same objects paint the same ids and blend
    the same colours."""

    def __init__(self, *modules):
        self.modules = modules
        self.real = modules[0].InferenceCore

    def __enter__(self):
        real = self.real

        def seeded_core(*a, **kw):
            core = real(*a, **kw)
            core.object_manager._rng = np.random.default_rng(5)
            return core

        for mod in self.modules:
            mod.InferenceCore = seeded_core
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            mod.InferenceCore = self.real
        return False


def demo_flags(device: str, weights: str, size_args, *extra):
    """The text demo's parsed flags with 13e's prompt and weights."""
    return demo_driver("demo_with_text_torch").make_parser().parse_args([
        "--prompt", REPLAY_PROMPT, "--model", weights, "--device", device,
        "--raise_on_error", *size_args, *extra])


def text_demo_run(device: str, weights: str, out: str, size_args) -> dict:
    """13e's text demo on `device`, in this process:
    demo_with_text_torch.drive on example/vipseg's clip, as main drives it
    (its reader, a demo ResultSaver under out), with ReplayDetector in
    Grounding DINO's and SAM's place (the hub is never reached), object ids
    seeded (SeededIds). -> run_in_process's result."""
    from deva_tpu_torch.ext.detectors import ReplayDetector
    text = demo_driver("demo_with_text_torch")

    def text_demo():
        np.random.seed(42)
        args = demo_flags(device, weights, size_args, "--img_path",
                          os.path.join(VIPSEG, "images", VIPSEG_CLIP),
                          "--output", out)
        text.drive(args, ReplayDetector(REPLAY_FIXTURE), text.run_demo,
                   text.setup_device(args))

    with SeededIds(text):
        return run_in_process(text_demo, "13e text demo")


def video_demo_run(device: str, weights: str, lay: dict, out: str,
                   size_args) -> dict:
    """13e's video demo on `device`, in this process:
    demo_gradio_torch.track_video as its main runs it without --serve (the
    flags' Demo, cv2's decode of the clip's mp4, tracked.mp4 under out),
    with NearestReplay in the detector's place, object ids seeded
    (SeededIds). -> run_in_process's result, with the NearestReplay gaps
    under "gaps"."""
    from deva_tpu_torch.ext.detectors import ReplayDetector
    text = demo_driver("demo_with_text_torch")
    gd = demo_driver("demo_gradio_torch")
    source = NearestReplay(ReplayDetector(REPLAY_FIXTURE), lay["rgb"])

    def video_demo():
        np.random.seed(42)
        args = demo_flags(device, weights, size_args, "--output", out)
        dev = text.setup_device(args)
        demo = gd.Demo(text.load_model(args, dev), text.demo_config(args, 0),
                       vars(args), args, dev)
        gd.track_video(demo, demo.cfg, demo.ext_cfg, source, lay["mp4"],
                       args.output)

    with SeededIds(text, gd):
        return dict(run_in_process(video_demo, "13e video demo"),
                    gaps=source.gaps)


def check_demos(card: dict, cpu: dict, card_out: str, cpu_out: str) -> None:
    """13e's budgets: the text demo's tree, labels under the id matching
    and pred.json; the two tracked.mp4 (compare_videos); each decoded frame
    nearest its own recorded frame by a clear margin."""
    label = "13e demo_with_text_torch.drive (ReplayDetector)"
    ref, got = os.path.join(cpu_out, "text"), os.path.join(card_out, "text")
    names = same_tree(ref, got, label)
    labels = compare_labels(ref, got, names, label, matched=True)
    match = labels["matchings"]["Annotations"]
    assert all(k == v for k, v in match.items()), (label, match)
    segs = compare_pred_json(
        ref, got, lambda _, fn: os.path.join("Annotations", fn[:-4] + ".png"),
        labels, label)
    cli_line(label, card["text"], cpu["text"],
             f"same {len(names)} files, {labels['frames']} PNGs with labels "
             f"agreeing on >= {labels['worst']:.4%}, the same {len(match)} "
             f"ids; pred.json: {segs} segments equal")
    label = "13e demo_gradio_torch.track_video (mp4 in, tracked.mp4 out)"
    gaps = card["video"]["gaps"]
    for side in (gaps, cpu["video"]["gaps"]):
        assert side and all(a < 0.5 * b for a, b in side), (label, side)
    psnr = compare_videos(os.path.join(cpu_out, "video", "tracked.mp4"),
                          os.path.join(card_out, "video", "tracked.mp4"),
                          label)
    n = len(video_frames(os.path.join(card_out, "video", "tracked.mp4")))
    cli_line(label, card["video"], cpu["video"],
             f"{n} frames of the decoded tracked.mp4 each, PSNR card vs CPU "
             f"{psnr:.2f} dB; {len(gaps)} detector calls, each decoded frame "
             f"nearest its recorded frame (mean |diff| at most "
             f"{max(a for a, _ in gaps):.2f} against >= "
             f"{min(b for _, b in gaps):.2f} to the next)")


def phase13_host_io(dev, lay: dict, tmp: str) -> None:
    """13g: host ms per frame of data/video_reader.py's reader (__getitem__:
    the JPEG decode and resize to --size 480, and on frame 0 the mask's) at
    854x480 (example/vos) and 1280x720 (example/vipseg's frames), the
    median of IO_ROUNDS rounds of every frame; and host ms per saved frame
    of ResultSaver in VIPSeg's layout (save_mask, then the drain in end(),
    over IO_SAVES frames; the device drained first) on IO_CHANNELS
    probabilities at 480x853 on the card: the need_resize branch (the f32
    probabilities to the host, resized to 1280x720 there) and the device
    argmax branch (uint8 ids to the host) apart."""
    from deva_tpu_torch.data.video_reader import VideoReader
    from deva_tpu_torch.inference.object_info import ObjectInfo
    from deva_tpu_torch.inference.object_manager import ObjectManager
    from deva_tpu_torch.inference.result_saver import ResultSaver
    vos = os.path.join(ROOT, "example", "vos")
    readers = {
        "854x480": VideoReader("bmx-trees",
                               os.path.join(vos, "JPEGImages", "bmx-trees"),
                               os.path.join(vos, "Annotations", "bmx-trees"),
                               size=480),
        "1280x720": VideoReader(VIPSEG_CLIP, os.path.join(
            VIPSEG, "images", VIPSEG_CLIP), lay["mask720"], size=480)}
    read = {}
    for key, reader in readers.items():
        times = {}
        for _ in range(IO_ROUNDS):
            for i in range(len(reader)):
                t0 = time.perf_counter()
                data = reader[i]
                times.setdefault(i, []).append(
                    (time.perf_counter() - t0) * 1000)
                assert data["rgb"].shape[0] == 480, data["rgb"].shape
        read[key] = (statistics.median(t for i in times if i for t in
                                       times[i]),
                     statistics.median(times[0]))
    objects = ObjectManager(np.random.default_rng(0))
    objects.use_long_id = True
    objects.add_new_objects([ObjectInfo(id=1000 + 7 * k, category_id=k,
                                        isthing=True, score=0.5)
                             for k in range(IO_CHANNELS - 1)])
    gen = torch.Generator().manual_seed(17)
    prob = torch.softmax(4 * torch.randn(IO_CHANNELS, 480, 853,
                                         generator=gen), 0).to(dev)
    saved = {}
    for branch, kw in (("need_resize", dict(need_resize=True,
                                            shape=(720, 1280))),
                       ("device argmax", {})):
        out = os.path.join(tmp, "io", branch.replace(" ", "_"))
        saver = ResultSaver(out, VIPSEG_CLIP, dataset="vipseg",
                            object_manager=objects)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        caller = 0.0
        t0 = time.perf_counter()
        for i in range(IO_SAVES):
            t1 = time.perf_counter()
            saver.save_mask(prob, f"{i:08d}.jpg", **kw)
            caller += time.perf_counter() - t1
        saver.end()
        total = time.perf_counter() - t0
        pngs = file_tree(os.path.join(out, "pan_pred"))
        assert len(pngs) == IO_SAVES, (branch, pngs)
        saved[branch] = (total * 1000 / IO_SAVES, caller * 1000 / IO_SAVES)
    print("phase 13g host I/O on this machine: data/video_reader.py's "
          "__getitem__ (decode, resize to --size 480), ms per frame, median "
          f"of {IO_ROUNDS} rounds: " + ", ".join(
              f"{k} {a:.3f} (frame 0 with its mask {b:.3f})"
              for k, (a, b) in read.items())
          + f"; ResultSaver (VIPSeg layout, {IO_CHANNELS} channels of "
          f"480x853 on the {dev.type} device), ms per saved frame over "
          f"{IO_SAVES} frames, save_mask plus end()'s drain (save_mask "
          "alone): " + ", ".join(f"{k} {a:.3f} ({b:.3f})"
                                 for k, (a, b) in saved.items())
          + " " + smi_line(), flush=True)


def maskless_frames(name: str) -> int:
    """The frames of command `name` that propagate without a mask (each
    reads the memory through the kernels of its method): example/vos's
    frames after its first, the YouTube-VOS layout's frames but the two of
    each video that bring a mask; 1 for the demo (a tracked frame)."""
    if name == "a-yt":
        return sum(t - 2 for t, _ in CLI_YT)
    if name[0] == "a":
        return len(os.listdir(os.path.join(ROOT, "example", "vos",
                                           "JPEGImages", "bmx-trees"))) - 1
    return 1


def inproc_launches(ak, run, pair, at_least: int, label: str) -> dict:
    """run() on the card in this process with the launch counts at 0: each
    kernel of `pair` at least `at_least` times, none of the other pair's.
    -> the counts."""
    ak.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    counts = dict(ak.LAUNCHES)
    assert all(counts[k] >= at_least for k in pair) and not any(
        counts[k] for k in counts if k not in pair), (label, counts, at_least)
    return counts


def phase13(ak, dev, card: str = "cuda", parts: str = "abcdefg",
            size_args=()) -> None:
    """Phase 13, the command lines (see the header): the parts named (of
    "abcdefg"), with write_weights' model. card: the device of the card
    side ("cpu" rehearses the phase with two CPU runs of each command; then
    no launch is counted); size_args: extra flags of every command (a
    rehearsal's --size)."""
    on_card = card == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        weights = write_weights(tmp)
        lay = cli_layouts(tmp, parts)
        cmds = cli_commands(weights, lay, list(size_args), parts)
        pairs = CliPairs(tmp, card, len(cmds))
        try:
            for name, _, script, args in cmds:
                pairs.run(name, script, args, twin=name != "b-batched")
            tools = cli_tools(pairs, [name for name, *_ in cmds])
            cards = {name: pairs.result(name, "card") for name, *_ in cmds}
            launched = {}
            if on_card:
                vos = demo_driver("eval_vos_torch")
                auto = demo_driver("demo_automatic_torch")
                for name, label, script, args in cmds:
                    if name[0] not in "ad":
                        continue
                    out = pairs.out(name, "inproc")
                    main = vos.main if name[0] == "a" else auto.main
                    pair = ("segmax", "denom_readout") if name == "a-approx" \
                        else EXACT_PAIR
                    names = file_tree(cards[name]["out"])
                    launched[name] = inproc_launches(
                        ak, lambda: run_in_process(
                            lambda: main([*args, "--output", out]), label),
                        pair, maskless_frames(name), label)
                    same_tree(cards[name]["out"], out, label + " in process")
                    compare_labels(cards[name]["out"], out, names,
                                   label + " in process",
                                   matched=name[0] == "d")
            if "e" in parts:
                demos = {}
                for side, device in (("card", card), ("cpu", "cpu")):
                    out = pairs.out("e", side)

                    def run(side=side, device=device, out=out):
                        demos[side] = {
                            "text": text_demo_run(
                                device, weights, os.path.join(out, "text"),
                                size_args),
                            "video": video_demo_run(device, weights, lay,
                                                    os.path.join(out, "video"),
                                                    size_args)}

                    if side == "card" and on_card:
                        launched["e"] = inproc_launches(ak, run, EXACT_PAIR, 1,
                                                        "13e")
                    else:
                        run()
            for name, label, script, args in cmds:
                if name == "b-batched":
                    twin = None
                    held = check_batched_vos(label, cards[name], pairs)
                else:
                    twin = pairs.result(name, "cpu")
                    held = check_command(name, label, cards[name], twin,
                                         pairs, tools)
                if name in launched:
                    held += (f"; the same command in this process on the "
                             f"card: the same files and labels, launches "
                             f"{launched[name]}")
                cli_line(label, cards[name], twin, held)
            if "e" in parts:
                check_demos(demos["card"], demos["cpu"],
                            pairs.out("e", "card"), pairs.out("e", "cpu"))
                if on_card:
                    print(f"phase 13e launches on the card (both demos): "
                          f"{launched['e']}", flush=True)
        finally:
            pairs.close()
        commands = time.perf_counter() - t0
        if "g" in parts:
            phase13_host_io(dev, lay, tmp)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s (the commands "
          f"and their checks {commands:.1f})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--phase11-rank"]:
        phase11_rank(sys.argv[2])
        return 0
    sys.path.insert(0, ROOT)
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.ops import approx_kernels as apx
    from deva_tpu_torch.ops import attention_kernels as ak
    from deva_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    SMI.append(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t_start = t0 = time.perf_counter()
    lib = cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{os.path.relpath(lib, ROOT)}", flush=True)

    net_cpu = init_weights(DEVANetwork(), seed=0).eval()
    laps = [time.perf_counter()]

    def lap(phases: str) -> None:
        """Prints the seconds since the last lap (what a later slice reads
        to choose the depth it cuts)."""
        laps.append(time.perf_counter())
        print(f"phase {phases} took {laps[-1] - laps[-2]:.1f} s", flush=True)

    exact = phase_kernels(ak, apx, dev)
    approx = phase_approx_kernels(ak, apx, dev)
    bf16 = phase_kernels_bf16(ak, apx, dev)
    batched = phase_kernels_batched(ak, apx, dev)
    batched16 = phase_kernels_batched(ak, apx, dev, "bfloat16")
    lap("1, 1b")
    net_cpu16 = with_dtype(net_cpu, "bfloat16")
    phase_slice_parity(ak, net_cpu, dev)
    phase_slice_parity_approx(ak, apx, net_cpu, dev)
    phase_slice_parity(ak, net_cpu16, dev, "bfloat16", BF16_SLICE_TOL)
    phase_slice_parity_approx(ak, apx, net_cpu16, dev, "bfloat16",
                              BF16_SLICE_TOL)
    phase_batched_slice(ak, net_cpu, dev)
    phase_batched_slice(ak, net_cpu16, dev, "bfloat16", BF16_SLICE_TOL)
    lap("2, 2b")
    launches, probs_exact, single_exact = phase_main_path(ak, net_cpu, dev)
    launches16, probs16, _ = phase_main_path(ak, net_cpu16, dev,
                                             ring_dtype="bfloat16")
    compare_dtypes(probs_exact, probs16, "phase 3 exact, bf16")
    del probs16
    launches_approx, probs_approx, single_approx = phase_main_path_approx(
        ak, net_cpu, dev)
    compare_preencoded(probs_approx, phase_main_path_approx(
        ak, net_cpu, dev, preencode=True)[1])
    launches_approx16, probs16, _ = phase_main_path_approx(
        ak, net_cpu16, dev, ring_dtype="bfloat16")
    compare_dtypes(probs_approx, probs16, "phase 4 approx, bf16")
    del probs16
    for runs in (launches16, launches_approx16):
        used = [name for name, count in runs.items() if count]
        assert all(runs[name] == 59 for name in used) and len(used) == 2, \
            f"bf16 run: not one launch per propagated frame: {runs}"
    lap("3, 4")
    launches5 = phase_batched_main(
        ak, net_cpu, net_cpu16, dev,
        {"exact": (probs_exact, single_exact),
         "approx": (probs_approx, single_approx)})
    del probs_exact, probs_approx
    lap("5")
    phase_detection_parity(ak, net_cpu, dev)
    launches6b, memory_calls = phase_detection_online(ak, net_cpu, dev)
    launches6c, aligned, align_calls = phase_detection_semionline(
        ak, net_cpu, dev)
    det_rows = det_kernel_rows(
        ak, apx, dev, ".det", memory_calls,
        {k: launches6b[k] + launches6c[k] - aligned[k] for k in EXACT_PAIR},
        "6b's last frame (composed match_memory)")
    del memory_calls
    det_rows += det_kernel_rows(ak, apx, dev, ".det.align", align_calls,
                                aligned, "6c's last spatial alignment")
    lap("6")
    det_rows += phase7(ak, apx, net_cpu, dev)
    lap("7")
    det_rows += phase8(ak, apx, net_cpu, dev)
    lap("8")
    demo_rows, history_b = phase9(ak, apx, net_cpu, dev)
    det_rows += demo_rows
    lap("9")
    phase10(ak, net_cpu, dev)
    lap("10")
    del net_cpu16
    gc.collect()
    torch.cuda.empty_cache()
    det_rows += phase11()
    lap("11")
    phase12(ak, net_cpu, dev, history_b)
    lap("12")
    del net_cpu
    phase13(ak, dev)
    lap("13")

    rows = []
    for ring, res_exact, res_approx, run_exact, run_approx, suffix in (
            ("float32", exact, approx, launches, launches_approx, ""),
            ("bfloat16", bf16, bf16, launches16, launches_approx16, ".bf16"),
            ("float32", batched, batched, launches5["exact"],
             launches5["approx"], f".b{B4}"),
            ("bfloat16", batched16, batched16, None,
             launches5["approx.bf16"], f".bf16.b{B4}")):
        for name, (src, tpu) in KERNELS.items():
            res, runs = (res_exact, run_exact) if name in EXACT_PAIR \
                else (res_approx, run_approx)
            if runs is None:  # phase 5 runs the bf16 exact pair nowhere
                continue
            main_shape = res["times"][16712]
            bound_ms, bound_by = res["bounds"][16712][name]
            row = {
                "name": name + suffix,
                "ring_dtype": ring, "route": "cuda", "source": src,
                "replaces": tpu, "launches": runs[name],
                "max_abs_err": res["err"][name], "ms": main_shape[name],
                "plain_ms": main_shape[name + "_plain"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": main_shape.get(name + "_library"),
                "product_ms": main_shape.get(name + "_product")}
            if suffix.endswith(f".b{B4}"):
                row.update(videos=B4,
                           singles_ms=main_shape[name + "_singles"])
            rows.append(row)
    rows += det_rows
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
