"""The port's native host library (deva_tpu_torch/utils/native.py, built from
deva_tpu_torch/csrc/host/devac.cpp) against deva_tpu's
(deva_tpu/utils/native.py, built from native/devac.cpp with the same flags)
and against the port's Python twins (ilp.solve_consensus_ilp_python,
rle.encode_python / decode_python), on the CPU. Every comparison with
deva_tpu is exact: equal selections, strings, masks and tables.
"""
import os
import subprocess

import numpy as np
import pytest

from deva_tpu.inference.ilp import solve_consensus_ilp as jax_ilp
from deva_tpu.utils import native as jax_native
from deva_tpu.utils import rle as jax_rle

from deva_tpu_torch import detection_clips as dc
from deva_tpu_torch.inference import ilp
from deva_tpu_torch.ops.cuda_build import BUILD_DIR, KernelError
from deva_tpu_torch.utils import native, rle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _objective(iou, sel):
    x = np.asarray(sel, np.float64)
    return float(2 * (iou @ x).sum() - x.sum())


def _random_tied_graph(rng, n):
    """A random conflict graph with one component of n >= 17 nodes (a
    path through every node, then random chords) and supports drawn from
    three values, so that many equal weights meet in a range std::sort
    introsorts."""
    iou = np.zeros((n, n), np.float32)
    order = rng.permutation(n)
    for a, b in zip(order[:-1], order[1:]):
        iou[a, b] = iou[b, a] = 0.6
    chords = np.triu(rng.uniform(size=(n, n)) < 0.08, 1)
    iou[chords] = rng.choice(np.float32([0.6, 0.75, 0.9]), int(chords.sum()))
    iou = np.maximum(iou, iou.T)
    conflict = iou > 0.49
    return iou * conflict, conflict


def _graphs(kind):
    if kind == "consensus":
        return dc.consensus_graphs(3, 120)
    rng = np.random.default_rng(4)
    return [_random_tied_graph(rng, int(rng.integers(17, 41)))
            for _ in range(40)]


@pytest.mark.parametrize("kind", ["consensus", "random_tied"])
def test_mwis_bitwise_deva_tpu(kind):
    """The port's solve_consensus_ilp returns deva_tpu's default solver's
    selection (its native mwis_solve) on every graph, tied ones with
    components of 17 or more nodes included; the two libraries' mwis_solve
    agree directly too."""
    big_tied = 0
    for iou, conflict in _graphs(kind):
        sel = ilp.solve_consensus_ilp(iou, conflict)
        assert list(map(bool, sel)) == list(map(bool, jax_ilp(iou, conflict)))
        w = 2.0 * iou.sum(axis=0) - 1.0
        clean = conflict.copy()
        np.fill_diagonal(clean, False)
        np.testing.assert_array_equal(native.mwis_solve(w, clean),
                                      jax_native.mwis_solve(w, clean))
        largest = max(map(len, dc.components(conflict)))
        big_tied += dc.has_ties(iou, conflict) and largest >= 17
    assert big_tied >= 10, big_tied


@pytest.mark.parametrize("kind", ["consensus", "random_tied"])
def test_mwis_against_python_twin(kind):
    """Tie-free graphs: the native and the Python solver select the same
    segments. Tied graphs: the same objective (and some selections differ,
    so the ties reach the solvers' orders). Every selection is feasible;
    for n <= 12 its objective is brute force's."""
    differ = tie_free = 0
    for iou, conflict in _graphs(kind):
        n = len(iou)
        sel = ilp.solve_consensus_ilp(iou, conflict)
        twin = ilp.solve_consensus_ilp_python(iou, conflict)
        if dc.has_ties(iou, conflict):
            assert abs(_objective(iou, sel) - _objective(iou, twin)) < 1e-6
            differ += sel != twin
        else:
            assert sel == twin
            tie_free += 1
        chosen = np.nonzero(sel)[0]
        assert not conflict[np.ix_(chosen, chosen)].any()
        if n <= 12:
            best = max(_objective(iou, [(m >> i) & 1 for i in range(n)])
                       for m in range(2 ** n)
                       if not any(conflict[i, j] and (m >> i) & (m >> j) & 1
                                  for i in range(n) for j in range(n)))
            assert abs(_objective(iou, sel) - best) < 1e-6
    assert differ > 0
    if kind == "consensus":
        assert tie_free >= 60, tie_free


def _masks():
    rng = np.random.default_rng(5)
    start1 = (rng.uniform(size=(33, 17)) > 0.5).astype(np.uint8)
    start1[0, 0] = 1
    return {"seeded": (rng.uniform(size=(48, 64)) > 0.7).astype(np.uint8),
            "blocky": np.kron(rng.integers(0, 2, (12, 16)),
                              np.ones((4, 4), np.int64)).astype(bool),
            "480p": (rng.uniform(size=(480, 854)) > 0.9).astype(np.uint8),
            "empty": np.zeros((20, 30), np.uint8),
            "full": np.ones((20, 30), np.uint8),
            "starts_with_1": start1,
            "1xN": (rng.uniform(size=(1, 57)) > 0.5).astype(np.uint8),
            "Nx1": (rng.uniform(size=(57, 1)) > 0.5).astype(np.uint8)}


@pytest.mark.parametrize("name", list(_masks()))
def test_rle_bitwise_deva_tpu(name):
    """The port's RLE strings equal deva_tpu's (its native and its Python
    codec) and the port's Python twin's; every decoder gives the mask."""
    m = _masks()[name]
    enc = rle.encode(m)
    assert enc == jax_rle.encode(m) == rle.encode_python(m)
    assert enc["counts"] == jax_native.rle_encode(m)
    for out in (rle.decode(enc), rle.decode_python(enc), jax_rle.decode(enc),
                native.rle_decode(enc["counts"], *m.shape)):
        np.testing.assert_array_equal(out, m.astype(np.uint8))
    assert rle.area(enc) == int(m.astype(bool).sum())


def test_rle_malformed_decode(monkeypatch):
    """A string whose runs do not cover h * w pixels: the native decoder
    reports it (None), and decode takes the Python decoder's answer, as
    deva_tpu's does. deva_tpu's answer is its decode's Python branch, taken
    with its native decoder turned off: on a string whose runs pass h * w
    (the [3, 5] case) deva_tpu's native decoder writes past its buffer
    before it reports the length, so the test does not call it."""
    monkeypatch.setattr(jax_native, "rle_decode", lambda *a: None)
    m = (np.random.default_rng(6).uniform(size=(4, 5)) > 0.5).astype(np.uint8)
    counts = rle.encode(m)["counts"]
    for size in ([4, 6], [3, 5]):
        assert native.rle_decode(counts, *size) is None
        bad = {"size": size, "counts": counts}
        out = rle.decode(bad)
        np.testing.assert_array_equal(out, rle.decode_python(bad))
        np.testing.assert_array_equal(out, jax_rle.decode(bad))
        assert out.shape == tuple(size)


def _leb(counts):
    return rle._leb_encode(np.asarray(counts, np.int64))


# malformed strings for a 4x5 mask (20 pixels)
_BAD_STRINGS = {
    # a 4x5 mask's runs decoded at 3x5: a run of ones ends at pixel 20
    "ones_past_end": _leb([0, 20]),
    "zeros_past_end": _leb([25]),
    # a negative delta: the runs 2, -5, 3, 20 sum to 20, and the ones run
    # after the negative one would start before the buffer
    "negative_run": _leb([2, -5, 3, 20]),
    # a count of 12 digits (continuation bit on 11 of them)
    "twelve_digits": chr(48 + 0x20) * 11 + "0",
    "unterminated": chr(48 + 0x20),
    "not_ascii": "\u00e9" + _leb([0, 20]),
}


@pytest.mark.parametrize("name", list(_BAD_STRINGS))
def test_rle_decode_writes_within_buffer(name):
    """The library rejects a malformed string (-1, or a length other than
    h * w) before it writes outside its h * w bytes: the guard bytes on
    both sides of the buffer keep their value. decode then answers with the
    Python decoder, as for any malformed string."""
    counts = _BAD_STRINGS[name]
    h, w = (3, 5) if name == "ones_past_end" else (4, 5)
    guard = 64
    buf = np.full(guard + h * w + guard, 0xAB, np.uint8)
    raw = counts.encode("utf-8")
    total = native.get_lib().rle_decode(raw, len(raw), h, w,
                                        native._u8p(buf[guard:]))
    assert total != h * w
    assert (buf[:guard] == 0xAB).all() and (buf[guard + h * w:] == 0xAB).all()
    if name == "unterminated":
        return  # the Python decoder raises IndexError on it, as deva_tpu's
    assert native.rle_decode(counts, h, w) is None
    bad = {"size": [h, w], "counts": counts}
    np.testing.assert_array_equal(rle.decode(bad), rle.decode_python(bad))


def test_rle_unterminated_string_raises():
    """A string that ends inside a count: the native decoder reports it, and
    decode raises as the Python decoder (and deva_tpu's) does."""
    counts = _BAD_STRINGS["unterminated"]
    assert native.rle_decode(counts, 4, 5) is None
    with pytest.raises(IndexError):
        rle.decode({"size": [4, 5], "counts": counts})
    with pytest.raises(IndexError):
        jax_rle.decode({"size": [4, 5], "counts": counts})


def test_joint_hist():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 7, 5000)
    b = rng.integers(0, 11, 5000)
    out = native.joint_hist(a, b, 11)
    ref = np.zeros((a.max() + 1, 11), np.int64)
    np.add.at(ref, (a, b), 1)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jax_native.joint_hist(a, b, 11))
    ids = rng.integers(0, 5, (24, 32))
    np.testing.assert_array_equal(native.joint_hist(ids, ids.T.ravel(), 5),
                                  jax_native.joint_hist(ids, ids.T.ravel(), 5))


@pytest.mark.parametrize("a,b,k", [([0, -1], [0, 1], 3), ([0, 1], [0, 3], 3),
                                   ([0, 1], [-1, 0], 3), ([0, 1], [0], 3)])
def test_joint_hist_rejects_out_of_range(a, b, k):
    """Ids the table has no cell for raise ValueError before the library
    indexes with them."""
    with pytest.raises(ValueError):
        native.joint_hist(np.int64(a), np.int64(b), k)


def test_mwis_rejects_mismatched_shapes():
    """A conflict matrix that is not [n, n] raises ValueError before the
    library reads it."""
    with pytest.raises(ValueError):
        native.mwis_solve(np.ones(4), np.zeros((3, 3), bool))
    with pytest.raises(ValueError):
        native.mwis_solve(np.ones(4), np.zeros((4, 3), bool))


def _tree(top):
    out = set()
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {(os.path.join(d, f), os.stat(os.path.join(d, f)).st_mtime_ns)
                for f in files if f != "libdevac.so"}
    return out


def test_library_lands_in_build_dir(tmp_path, monkeypatch):
    """The default library lies in deva_tpu_torch/_build/ under a hashed
    name; a build compiles csrc/host/devac.cpp with deva_tpu's flags into
    the build directory alone (through a temporary file there), and writes
    nothing under deva_tpu/ or native/ (deva_tpu's own library aside, which
    deva_tpu's tests build)."""
    assert native.library_path().parent == BUILD_DIR
    assert native.library_path().name.startswith("libdevac_")
    assert native.get_lib()._name == str(native.library_path())
    before = _tree(os.path.join(ROOT, "deva_tpu")) | \
        _tree(os.path.join(ROOT, "native"))
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(cmd)
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    out = native.build(tmp_path / "build")
    assert out == native.library_path(tmp_path / "build") and out.exists()
    assert os.listdir(tmp_path / "build") == [out.name]
    (cmd,) = calls
    assert cmd[1:4] == ["-O3", "-shared", "-fPIC"]
    target = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(os.path.dirname(target)) == str(tmp_path / "build")
    assert cmd[-1] == str(native.SOURCE)
    assert native.SOURCE.parent.name == "host"
    after = _tree(os.path.join(ROOT, "deva_tpu")) | \
        _tree(os.path.join(ROOT, "native"))
    assert after == before
    assert native.build(tmp_path / "build") == out and len(calls) == 1


def test_failed_build_raises(tmp_path, monkeypatch):
    """With PATH emptied (no g++) and a fresh build directory, a build
    raises KernelError, and so does the solver and the codec that need it:
    nothing returns None or falls back to Python."""
    monkeypatch.setenv("PATH", "")
    with pytest.raises(KernelError, match="g\\+\\+"):
        native.build(tmp_path / "fresh")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(native, "_lib", None)
    iou = np.float32([[0, 0.8], [0.8, 0]])
    with pytest.raises(KernelError):
        ilp.solve_consensus_ilp(iou, iou > 0.49)
    with pytest.raises(KernelError):
        rle.encode(np.ones((3, 4), np.uint8))
    assert not (tmp_path / "fresh").exists() or \
        not list((tmp_path / "fresh").glob("*.so"))


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises KernelError with the compiler's
    message."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(KernelError, match="g\\+\\+ failed"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
