"""deva_tpu_torch's VOS driver against deva_tpu's, end to end on
example/vos, and the port's independence from JAX and PIL.

Both drivers load the same .npz weights (deva_tpu's export format, made
here from a seeded port model through deva_tpu's converter) and write
palette PNGs for the clip at --size 120. Budget: at least 99% of the pixel
labels agree (the two differ by f32 summation order only; a near-tie pixel
may flip).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deva_tpu.models.convert import convert_torch_statedict

from deva_tpu_torch.models.network import DEVANetwork, init_weights

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(ROOT, "example", "vos")


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    return env


def _run(script, *args):
    cmd = [sys.executable, os.path.join(ROOT, "evaluation", script), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _read_pngs(out_dir):
    from PIL import Image
    vid = os.path.join(out_dir, "bmx-trees")
    names = sorted(os.listdir(vid))
    return names, [np.asarray(Image.open(os.path.join(vid, n)))
                   for n in names]


def _weights(tmp_path) -> str:
    """A seeded port model, as a deva_tpu .npz export."""
    net = init_weights(DEVANetwork(), seed=3)
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    flat = {}

    def flatten(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    flatten(variables, ())
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **flat)
    return weights


def _compare_pngs(tmp_path, share: float = 0.99):
    names_j, masks_j = _read_pngs(tmp_path / "jax")
    names_t, masks_t = _read_pngs(tmp_path / "torch")
    assert names_t == names_j == ["00000.png", "00001.png", "00002.png",
                                  "00003.png"]
    for mj, mt in zip(masks_j, masks_t):
        assert mt.shape == mj.shape == (480, 854)
        assert set(np.unique(mt)) <= {0, 1, 2}
        agree = (mj == mt).mean()
        assert agree >= share, f"label agreement {agree}"


def test_eval_vos_torch_matches_eval_vos(tmp_path):
    common = ["--dataset", "G", "--generic_path", CLIP, "--size", "120",
              "--model", _weights(tmp_path)]
    _run("eval_vos.py", *common, "--output", str(tmp_path / "jax"))
    out = _run("eval_vos_torch.py", *common, "--output",
               str(tmp_path / "torch"), "--device", "cpu")
    assert "FPS:" in out
    _compare_pngs(tmp_path)


def test_eval_vos_torch_chunk_matches_eval_vos_chunk(tmp_path):
    """--chunk 4: both drivers step the maskless frames through step_chunk
    (the clip's three propagated frames in one chunk that ends the video)."""
    weights = _weights(tmp_path)
    common = ["--dataset", "G", "--generic_path", CLIP, "--size", "120",
              "--model", weights, "--chunk", "4"]
    _run("eval_vos.py", *common, "--output", str(tmp_path / "jax"))
    out = _run("eval_vos_torch.py", *common, "--output",
               str(tmp_path / "torch"), "--device", "cpu")
    assert "Total processed frames: 4" in out
    _compare_pngs(tmp_path)


def test_eval_vos_torch_amp_matches_eval_vos_amp(tmp_path):
    """--amp: bf16 compute and bf16 rings in both scripts. The two round
    bf16 at other places (oneDNN and XLA-CPU convolutions sum in other
    orders), and this random-init model's probabilities are nearly flat
    between its two objects over much of the frame, so near-tie pixels
    flip: budget 75% of the labels per frame. Measured on the CPU: 78.2%,
    82.1% and 82.0% on the three propagated frames, where deva_tpu's own
    --amp run agrees with its f32 run on 87.7%, 85.4% and 85.2%, and the
    two scripts' f32 runs on 99.99% or more."""
    common = ["--dataset", "G", "--generic_path", CLIP, "--size", "120",
              "--model", _weights(tmp_path), "--amp"]
    _run("eval_vos.py", *common, "--output", str(tmp_path / "jax"))
    out = _run("eval_vos_torch.py", *common, "--output",
               str(tmp_path / "torch"), "--device", "cpu")
    assert "FPS:" in out
    _compare_pngs(tmp_path, share=0.75)


def test_eval_vos_torch_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cmd = [sys.executable, os.path.join(ROOT, "evaluation",
                                        "eval_vos_torch.py"),
           "--dataset", "G", "--generic_path", CLIP, "--model", "",
           "--output", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_port_imports_without_jax_or_pil():
    """The port runs where neither jax nor PIL is installed: importing every
    module of deva_tpu_torch (the detection-fusion modules, the batched
    detection propagator, the copied readers, saver, VIPSeg and J&F metrics
    and the fault barrier among them), the batched driver
    (evaluation/eval_vos_batched_torch.py, by path, which also loads
    eval_vos_torch.py, with run_video and run_group_midstream), the
    detection drivers (evaluation/eval_with_detections_torch.py and
    eval_with_detections_batched_torch.py), the referring and saliency
    drivers (eval_ref_davis_torch.py, eval_ref_youtubevos_torch.py,
    eval_saliency_torch.py), the scorer (eval_jf_torch.py),
    scripts/merge_multi_scale_torch.py, the detector layer (ext/: TinyViT,
    the SAM decoder, MobileSAM, the detectors, both frame processors, the
    flags) with demo_utils and simple_video_reader, and the two demos
    (demo/demo_with_text_torch.py, demo/demo_automatic_torch.py), and the
    training stack (training/: the trainer, losses, checkpoints, the stage
    driver, the toy, the datasets and their transforms; utils/logger.py,
    utils/image_saver.py), and the multi-GPU layer (parallel/: the mesh,
    the memory-sharded attention, object sharding), and the native host
    library's bindings (utils/native.py, nothing built at import), the
    video demo (demo/demo_gradio_torch.py) and the two toy-training
    scripts (scripts/train_toy_torch.py,
    scripts/train_fullwidth_proof_torch.py), with both blocked, and
    transformers, cv2, gradio and tensorboardX blocked too, must work."""
    code = """
import sys
sys.modules['jax'] = None
sys.modules['PIL'] = None
sys.modules['transformers'] = None
sys.modules['cv2'] = None
sys.modules['tensorboardX'] = None
sys.modules['gradio'] = None
import importlib, importlib.util, pkgutil
import deva_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deva_tpu_torch.__path__,
                                                'deva_tpu_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    'eval_vos_batched_torch', 'evaluation/eval_vos_batched_torch.py')
driver = importlib.util.module_from_spec(spec)
spec.loader.exec_module(driver)
assert callable(driver.run_group) and callable(driver.run_sequential)
assert callable(driver.run_group_midstream)
spec = importlib.util.spec_from_file_location(
    'eval_with_detections_torch', 'evaluation/eval_with_detections_torch.py')
det = importlib.util.module_from_spec(spec)
spec.loader.exec_module(det)
assert callable(det.run_video) and callable(det.main)
sys.path.insert(0, 'evaluation')
spec = importlib.util.spec_from_file_location(
    'eval_with_detections_batched_torch',
    'evaluation/eval_with_detections_batched_torch.py')
bdet = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bdet)
assert callable(bdet.run_group) and callable(bdet.run_group_online)
import eval_vos_torch
assert callable(eval_vos_torch.run_video)
for script, fns in (('evaluation/eval_ref_davis_torch.py',
                     ('consensus', 'run_bidirectional', 'main')),
                    ('evaluation/eval_ref_youtubevos_torch.py', ('main',)),
                    ('evaluation/eval_saliency_torch.py',
                     ('run_video', 'main')),
                    ('evaluation/eval_jf_torch.py', ('main',)),
                    ('scripts/merge_multi_scale_torch.py',
                     ('process_vid', 'main')),
                    ('demo/demo_with_text_torch.py',
                     ('run_demo', 'drive', 'main')),
                    ('demo/demo_automatic_torch.py', ('run_demo', 'main')),
                    ('demo/demo_gradio_torch.py',
                     ('track_frames', 'track_video', 'run_text', 'run_auto',
                      'serve', 'main')),
                    ('scripts/train_toy_torch.py', ('main',)),
                    ('scripts/train_fullwidth_proof_torch.py', ('main',))):
    spec = importlib.util.spec_from_file_location(
        script.split('/')[-1][:-3], script)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    assert all(callable(getattr(mod, fn)) for fn in fns), script
for name in ('deva_tpu_torch.inference.batched_detection',
             'deva_tpu_torch.inference.eval_args',
             'deva_tpu_torch.metrics.jf',
             'deva_tpu_torch.data.referring_test_datasets',
             'deva_tpu_torch.data.saliency_test_datasets',
             'deva_tpu_torch.utils.load_subset',
             'deva_tpu_torch.inference.consensus',
             'deva_tpu_torch.inference.result_saver',
             'deva_tpu_torch.metrics.eval_vpq_vipseg',
             'deva_tpu_torch.data.vps_test_datasets',
             'deva_tpu_torch.ext.tiny_vit',
             'deva_tpu_torch.ext.sam_decoder',
             'deva_tpu_torch.ext.convert',
             'deva_tpu_torch.ext.mobile_sam',
             'deva_tpu_torch.ext.detectors',
             'deva_tpu_torch.ext.ext_eval_args',
             'deva_tpu_torch.ext.with_text_processor',
             'deva_tpu_torch.ext.automatic_processor',
             'deva_tpu_torch.inference.demo_utils',
             'deva_tpu_torch.data.simple_video_reader',
             'deva_tpu_torch.training.trainer',
             'deva_tpu_torch.training.losses',
             'deva_tpu_torch.training.checkpoint',
             'deva_tpu_torch.training.configuration',
             'deva_tpu_torch.training.train',
             'deva_tpu_torch.training.toy',
             'deva_tpu_torch.training.data.utils',
             'deva_tpu_torch.training.data.transforms',
             'deva_tpu_torch.training.data.tps',
             'deva_tpu_torch.training.data.static_dataset',
             'deva_tpu_torch.training.data.vos_dataset',
             'deva_tpu_torch.utils.logger',
             'deva_tpu_torch.utils.image_saver',
             'deva_tpu_torch.parallel',
             'deva_tpu_torch.parallel.mesh',
             'deva_tpu_torch.parallel.sharded_attention',
             'deva_tpu_torch.parallel.object_sharding',
             'deva_tpu_torch.utils.native'):
    assert name in names, name
from deva_tpu_torch.utils import native
assert native._lib is None  # nothing is built at import
from deva_tpu_torch.parallel import (ObjectShards, attend_mem_sharded,
                                     init_from_env, make_mesh, pad_tokens,
                                     replicate, shard_batch)
assert all(callable(f) for f in (ObjectShards, attend_mem_sharded,
                                 init_from_env, make_mesh, pad_tokens,
                                 replicate, shard_batch))
assert not any(m == 'deva_tpu' or m.startswith(('deva_tpu.', 'jax', 'flax'))
               for m in sys.modules if sys.modules[m] is not None), \\
    sorted(m for m in sys.modules if m.startswith(('deva_tpu.', 'jax')))
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
