"""Shared set-up of the VOS driver tests (tests/test_torch_vos_*.py): one
seeded model as a deva_tpu .npz export, the two packages' drivers run as
the commands a user types (in parallel, one thread each), and the
comparisons of their outputs, and the synthetic YouTube-VOS layout of the
Y18 tests."""
import json
import os
import subprocess
import sys
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deva_tpu.models.convert import convert_torch_statedict

from deva_tpu_torch.models.network import DEVANetwork, init_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(ROOT, "example", "vos")


def weights(tmp_path) -> str:
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
    out = str(tmp_path / "weights.npz")
    np.savez(out, **flat)
    return out


def run(script, *args, expect_ok=True):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    if expect_ok:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def run_both(jax_script, torch_script, common, out_jax, out_torch):
    """deva_tpu's driver and the port's (--device cpu) on the same flags,
    at once. -> their standard outputs."""
    with ThreadPoolExecutor(2) as pool:
        jax = pool.submit(run, jax_script, *common, "--output", str(out_jax))
        ours = pool.submit(run, torch_script, *common, "--output",
                           str(out_torch), "--device", "cpu")
        return jax.result(), ours.result()


def read_png(p) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(p))


def tree(root) -> list:
    """The files under root, as sorted relative paths."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def compare_pngs(root_jax, root_torch, share: float = 0.99) -> int:
    """Every PNG under root_torch at least `share` equal, pixel for pixel,
    to deva_tpu's; the same files on both sides. -> how many PNGs."""
    names = [n for n in tree(root_jax) if n.endswith(".png")]
    assert names == [n for n in tree(root_torch) if n.endswith(".png")]
    for n in names:
        a, b = read_png(os.path.join(root_jax, n)), \
            read_png(os.path.join(root_torch, n))
        assert a.shape == b.shape, n
        agree = (a == b).mean()
        assert agree >= share, f"{n}: label agreement {agree}"
    return len(names)


def compare_scores(root_jax, root_torch, share: float = 0.99) -> int:
    """Scores/<video>/<frame>.npy (uint8 prob * 255): the same files, each
    within 1 (1/255 of a probability: the uint8 cast truncates, so a 1e-6
    difference can cross an integer) on at least `share` of its values;
    backward.npy equal. -> how many score maps."""
    names = [n for n in tree(root_jax) if n.endswith(".npy")]
    assert names == [n for n in tree(root_torch) if n.endswith(".npy")]
    maps = 0
    for n in names:
        a = np.load(os.path.join(root_jax, n), allow_pickle=True)
        b = np.load(os.path.join(root_torch, n), allow_pickle=True)
        if n.endswith("backward.npy"):
            assert a.item() == b.item(), n
            continue
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, n
        close = np.abs(a.astype(int) - b.astype(int)) <= 1
        assert close.mean() >= share, f"{n}: within 1/255 {close.mean()}"
        maps += 1
    return maps


YT_H, YT_W, YT_T = 128, 192, 8


def _palette_png(path, mask):
    from PIL import Image
    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
    img.save(path)


def youtube_layout(root):
    """A synthetic YouTube-VOS layout (all_frames/valid_all_frames/
    JPEGImages, valid/Annotations, valid/meta.json), 128x192 frames read
    at --size -1: video
    'a' has object 1 from frame 0 and object 2 from frame 3 (its own PNG, as
    YouTube-VOS gives it; the composed path takes it in), video 'b' its
    first mask at frame 2 (the frames before it are skipped). meta.json
    lists every other frame, so only those are written, under
    Annotations/, and the submission zip is made."""
    from PIL import Image
    rng = np.random.default_rng(8)
    meta = {}
    first = {"a": {0: [1], 3: [2]}, "b": {2: [1]}}
    for vid, masks in first.items():
        img_dir = root / "all_frames" / "valid_all_frames" / "JPEGImages" / vid
        ann_dir = root / "valid" / "Annotations" / vid
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        base = rng.integers(0, 255, (YT_H // 8, YT_W // 8, 3)).astype(
            np.uint8)
        for i in range(YT_T):
            img = np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)
            Image.fromarray(img).save(img_dir / f"{i:05d}.jpg")
        for t, objs in masks.items():
            m = np.zeros((YT_H, YT_W), np.uint8)
            for o in objs:
                m[16 + 40 * (o - 1):56 + 40 * (o - 1), 20 + 8 * t:90 + 8 * t] \
                    = o
            _palette_png(ann_dir / f"{t:05d}.png", m)
        every_other = [f"{i:05d}" for i in range(0, YT_T, 2)]
        meta[vid] = {"objects": {str(o): {"category": "x",
                                          "frames": every_other}
                                 for objs in masks.values() for o in objs}}
    with open(root / "valid" / "meta.json", "w") as f:
        json.dump({"videos": meta}, f)


def youtube_outputs(tmp_path, driver, *extra):
    """deva_tpu's `driver` and the port's twin on the layout. -> the port's
    standard output."""
    data = tmp_path / "yv"
    youtube_layout(data)
    common = ["--dataset", "Y18", "--y18_path", str(data), "--size", "-1",
              "--model", weights(tmp_path), *extra]
    _, out = run_both(f"evaluation/{driver}.py",
                      f"evaluation/{driver}_torch.py", common,
                      tmp_path / "jax", tmp_path / "torch")
    return out


def check_youtube_outputs(tmp_path):
    """The outputs of youtube_outputs' two runs: the PNGs, the file tree,
    object 2 painted after it joins, the zips' members."""
    assert compare_pngs(tmp_path / "jax" / "Annotations",
                        tmp_path / "torch" / "Annotations") == 7
    assert [n for n in tree(tmp_path / "torch") if n.endswith(".png")] == \
        [f"Annotations/a/{i:05d}.png" for i in (0, 2, 4, 6)] + \
        [f"Annotations/b/{i:05d}.png" for i in (2, 4, 6)]
    # object 2, which joined at frame 3, is painted after it
    labels = np.unique(read_png(tmp_path / "torch" / "Annotations" / "a" /
                                "00004.png"))
    assert 2 in labels, labels
    zips = [zipfile.ZipFile(tmp_path / p / f"{p}.zip").namelist()
            for p in ("jax", "torch")]
    assert sorted(zips[0]) == sorted(zips[1]) and len(zips[1]) >= 7
