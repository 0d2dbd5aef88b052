"""deva_tpu_torch in bf16 (ModelConfig(dtype='bfloat16'),
InferenceConfig(ring_dtype='bfloat16')) against deva_tpu in bf16, and
against itself in f32.

- config: 'auto' resolves to f32, 'bfloat16' is taken, 'float16' raises;
- per module, port-bf16 against deva_tpu-bf16 with the same weights
  (a seeded port model carried to deva_tpu by its converter), at 64x64
  frames, two objects, full channel widths (tests/test_amp.py's sizes), with
  flax's output dtypes: bf16 features, f32 sensory state, f32 prob;
- port-bf16 against port-f32 on shared weights, under tests/test_amp.py's
  budgets;
- attention on bf16 rings: the plain twins against deva_tpu's Pallas
  composites in interpret mode, on the same rings;
- the bf16 kernel paths' grid coverage (from csrc/topk_readout.cu's own
  constants) and the wrappers' dtype checks, which run before the kernel
  library is built. The kernels themselves run only on a card
  (tests/test_torch_cuda.py).

Tolerances. deva_tpu's XLA-CPU and the port's oneDNN bf16 convolutions both
round their outputs to bf16, but sum in different orders, and deva_tpu's
bilinear stencil rounds after each multiply and add where F.interpolate
rounds once; so the two packages differ by a few bf16 ulps per layer
(2^-8 relative each). Each module's bound below is about twice what this
CPU run gave, stated beside it, relative to the output's largest
magnitude.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork
from deva_tpu.ops import pallas_attention as pa
from deva_tpu.ops.resize import upsample_bilinear as jax_upsample

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak
from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.resize import upsample_bilinear

torch.set_num_threads(2)

B, O, H, W = 1, 2, 64, 64
h, w = H // 16, W // 16
CV = 512


@pytest.fixture(scope="module")
def nets():
    """(port f32, port bf16, deva_tpu bf16, deva_tpu variables), one set of
    weights."""
    net32 = init_weights(DEVANetwork(), seed=0).eval()
    net16 = DEVANetwork(ModelConfig(dtype="bfloat16")).eval()
    net16.load_state_dict(net32.state_dict())
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net32.state_dict().items()})
    return net32, net16, JaxDEVANetwork(JaxModelConfig(dtype="bfloat16")), \
        variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def _rel_err(ours, ref) -> float:
    """max |ours - ref| over the reference's largest magnitude (>= 1)."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(ours, np.float32) - ref).max() /
                 max(1.0, np.abs(ref).max()))


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

def test_dtype_config():
    assert ModelConfig().compute_dtype == torch.float32
    assert InferenceConfig().ring_torch_dtype == torch.float32
    assert ModelConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert InferenceConfig(ring_dtype="bfloat16").ring_torch_dtype == \
        torch.bfloat16
    assert ModelConfig(dtype="float32").compute_dtype == torch.float32
    for bad in ("float16", "bf16", "float64"):
        with pytest.raises(NotImplementedError):
            ModelConfig(dtype=bad)
        with pytest.raises(NotImplementedError):
            InferenceConfig(ring_dtype=bad)


def test_bf16_model_keeps_f32_parameters_and_state_dict(nets):
    net32, net16, _, _ = nets
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    assert net16.state_dict().keys() == net32.state_dict().keys()
    # the prediction conv stays f32; every other conv and dense layer casts
    assert not hasattr(net16.mask_decoder.pred, "compute_dtype")
    assert net16.mask_decoder.fuser.block1.conv1.compute_dtype == \
        torch.bfloat16
    assert net32.mask_decoder.fuser.block1.conv1.compute_dtype == \
        torch.float32


# --------------------------------------------------------------------------
# per module: port bf16 against deva_tpu bf16
# --------------------------------------------------------------------------

def test_encode_image_and_transform_key(nets):
    """Measured on the CPU (this file's inputs): f16 0.0083, f8 0.0055,
    f4 0, key_feat 0.0100; key 0, shrinkage 0.0011, selection 0.0039 of the
    output scale."""
    _, net16, jmodel, variables = nets
    img = np.random.default_rng(0).standard_normal(
        (B, H, W, 3)).astype(np.float32)
    (f16, f8, f4), feat = jmodel.apply(variables, jnp.asarray(img),
                                       method=JaxDEVANetwork.encode_image)
    with torch.no_grad():
        ms, tfeat = net16.encode_image(_nchw(img))
    for name, r, o, tol in [("f16", f16, ms[0], 0.02), ("f8", f8, ms[1], 0.02),
                            ("f4", f4, ms[2], 0.02),
                            ("key_feat", feat, tfeat, 0.02)]:
        assert r.dtype == jnp.bfloat16 and o.dtype == torch.bfloat16, name
        assert _rel_err(_nhwc(o), r) < tol, (name, _rel_err(_nhwc(o), r))

    # the key projection on the same bf16 features in both packages
    k, s, e = jmodel.apply(variables, feat,
                           method=JaxDEVANetwork.transform_key)
    with torch.no_grad():
        tk, ts, te = net16.transform_key(
            _nchw(np.asarray(feat, np.float32)).bfloat16())
    for name, r, o, tol in [("key", k, tk, 0.01), ("shrinkage", s, ts, 0.005),
                            ("selection", e, te, 0.01)]:
        assert o.dtype == torch.bfloat16, name
        assert _rel_err(_nhwc(o), r) < tol, (name, _rel_err(_nhwc(o), r))


def test_encode_mask_deep_update(nets):
    """Measured on the CPU: value 0.0120, sensory 0.0087 of the output
    scale."""
    _, net16, jmodel, variables = nets
    rng = np.random.default_rng(1)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    f16 = rng.standard_normal((B, h, w, 512)).astype(np.float32)
    sensory = rng.standard_normal((B, O, h, w, CV)).astype(np.float32)
    masks = (rng.uniform(0, 1, (B, O, H, W)) > 0.5).astype(np.float32)
    f16_16 = jnp.asarray(f16, jnp.bfloat16)  # the encoder's own output dtype
    value, new_s = jmodel.apply(variables, jnp.asarray(img), f16_16,
                                jnp.asarray(sensory), jnp.asarray(masks),
                                deep_update=True,
                                method=JaxDEVANetwork.encode_mask)
    with torch.no_grad():
        tvalue, tnew_s = net16.encode_mask(
            _nchw(img), _nchw(np.asarray(f16_16, np.float32)).bfloat16(),
            _nchw(sensory), torch.from_numpy(masks), deep_update=True)
    assert tvalue.dtype == torch.bfloat16 and value.dtype == jnp.bfloat16
    assert tnew_s.dtype == torch.float32 and new_s.dtype == jnp.float32
    assert _rel_err(_nhwc(tvalue), value) < 0.025, _rel_err(_nhwc(tvalue),
                                                            value)
    assert _rel_err(_nhwc(tnew_s), new_s) < 0.02, _rel_err(_nhwc(tnew_s),
                                                           new_s)


def test_segment(nets):
    """Measured on the CPU: sensory 0.0087, logits 0.0028 of the output
    scale, prob 0.0013 absolute."""
    _, net16, jmodel, variables = nets
    rng = np.random.default_rng(2)
    ms = tuple(jnp.asarray(rng.standard_normal(s), jnp.bfloat16) for s in
               ((B, h, w, 512), (B, 2 * h, 2 * w, 512),
                (B, 4 * h, 4 * w, 256)))
    readout = rng.standard_normal((B, O, h, w, CV)).astype(np.float32)
    sensory = rng.standard_normal((B, O, h, w, CV)).astype(np.float32)
    last_mask = rng.uniform(0, 1, (B, O, H, W)).astype(np.float32)
    selector = np.array([[1.0, 1.0]], np.float32)
    new_s, logits, prob = jmodel.apply(
        variables, ms, jnp.asarray(readout), jnp.asarray(sensory),
        jnp.asarray(last_mask), selector=jnp.asarray(selector),
        method=JaxDEVANetwork.segment)
    with torch.no_grad():
        tnew_s, tlogits, tprob = net16.segment(
            tuple(_nchw(np.asarray(m, np.float32)).bfloat16() for m in ms),
            _nchw(readout), _nchw(sensory), torch.from_numpy(last_mask),
            selector=torch.from_numpy(selector))
    assert tprob.dtype == torch.float32 and prob.dtype == jnp.float32
    assert tnew_s.dtype == torch.float32 and new_s.dtype == jnp.float32
    assert _rel_err(_nhwc(tnew_s), new_s) < 0.02
    assert _rel_err(tlogits.numpy(), logits) < 0.006
    assert float(np.abs(tprob.numpy() - np.asarray(prob)).max()) < 0.003


def test_upsample_bilinear_bf16():
    """bf16 in, bf16 out, computed in bf16 in both packages: deva_tpu's
    stencil rounds after each multiply and add, F.interpolate once, so they
    agree within tests/test_amp.py's 0.02 for this op (measured on the CPU:
    0.0156, one bf16 ulp at the inputs' scale); f32 is unchanged."""
    x = np.random.default_rng(3).standard_normal((2, 6, 10, 8)).astype(
        np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_upsample(x16, 2), np.float32)
    ours = upsample_bilinear(_nchw(np.asarray(x16, np.float32)).bfloat16(), 2)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(ours), ref, rtol=0.02, atol=0.02)
    ours32 = upsample_bilinear(_nchw(x), 2)
    assert ours32.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(ours32),
                               np.asarray(jax_upsample(jnp.asarray(x), 2)),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# port bf16 against port f32: tests/test_amp.py's budgets
# --------------------------------------------------------------------------

def _forward(net, image, masks, sensory):
    """tests/test_amp.py's forward: encode, key, mask encode, the dense
    training readout (deva_tpu's read_memory: full softmax, readout cast to
    the compute dtype), segment."""
    ms, feat = net.encode_image(image)
    key, shrinkage, selection = net.transform_key(feat)
    value, sensory2 = net.encode_mask(image, ms[0], sensory, masks)
    qk = key[0].flatten(1).T
    qe = selection[0].flatten(1).T
    mv = value[0].flatten(2).transpose(1, 2)  # [O, HW, Cv]
    aff = ma.full_softmax(ma.get_similarity(qk, shrinkage[0].flatten(), qk,
                                            qe))
    rd = ma.readout(aff, mv)  # [O, HW, Cv] f32
    rd = rd.transpose(1, 2).reshape(1, masks.shape[1], -1, *key.shape[2:])
    rd = rd.to(net.config.compute_dtype)
    new_sensory, _, prob = net.segment(ms, rd, sensory2, masks)
    return prob, new_sensory


def test_bf16_against_f32_within_test_amp_budgets(nets):
    """Measured on the CPU: prob max 0.0157, mean 0.0027, argmax flips
    9.2% (near-flat random-init probabilities), sensory drift 1.2%."""
    net32, net16, _, _ = nets
    rng = np.random.default_rng(0)
    image = _nchw(rng.standard_normal((1, H, W, 3)).astype(np.float32))
    masks = torch.from_numpy(
        (rng.uniform(0, 1, (1, O, H, W)) > 0.5).astype(np.float32))
    sensory = _nchw((0.1 * rng.standard_normal((1, O, h, w, CV)))
                    .astype(np.float32))
    with torch.no_grad():
        p32, s32 = _forward(net32, image, masks, sensory)
        p16, s16 = _forward(net16, image, masks, sensory)
    assert p16.dtype == s16.dtype == torch.float32
    diff = (p32 - p16).abs()
    assert diff.max().item() < 0.35 and diff.mean().item() < 0.02, \
        (diff.max().item(), diff.mean().item())
    flips = (p32.argmax(1) != p16.argmax(1)).float().mean().item()
    assert flips < 0.2, flips
    d = (s32 - s16).abs().mean().item()
    assert d / (s32.abs().mean().item() + 1e-6) < 0.05


# --------------------------------------------------------------------------
# attention on bf16 rings: the twins against deva_tpu's Pallas composites
# --------------------------------------------------------------------------

def _rings(seed, n, q, n_valid, o=2, cv=32, ck=16):
    rng = np.random.default_rng(seed)
    r16 = lambda a: np.asarray(jnp.asarray(a.astype(np.float32),
                                           jnp.bfloat16))
    mk = r16(rng.standard_normal((n, ck)))
    ms = r16(rng.uniform(1, 4, (n,)))
    values = r16(rng.standard_normal((n, o, cv)))
    qk = rng.standard_normal((q, ck)).astype(np.float32)
    qe = rng.uniform(0, 1, (q, ck)).astype(np.float32)
    valid = np.arange(n) < n_valid
    return mk, ms, values, qk, qe, valid


def _t16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("split", [None, 200])
def test_attend_topk_plain_bf16_rings_against_attend_pallas(split):
    """The exact twin on bf16 rings (one ring, and [long-term ; working]
    segments read in place) against attend_pallas in interpret mode on the
    same rings: the weights are rounded to bf16 before the product on both
    sides, so out agrees within f32 summation noise (measured on the CPU:
    6e-8; usage 2.4e-7)."""
    mk, ms, values, qk, qe, valid = _rings(40, 700, 90, 650)
    k = 12
    ref, ref_u = pa.attend_pallas(
        jnp.asarray(mk, jnp.bfloat16), jnp.asarray(ms, jnp.bfloat16),
        jnp.asarray(values, jnp.bfloat16), jnp.asarray(qk), jnp.asarray(qe),
        k, jnp.asarray(valid), return_usage=True, interpret=True)
    v = _t16(values)
    v_arg = v if split is None else (v[:split], v[split:])
    out, usage = ak.attend_topk_plain(_t16(mk), _t16(ms), v_arg,
                                      torch.from_numpy(qk),
                                      torch.from_numpy(qe), k,
                                      torch.from_numpy(valid),
                                      return_usage=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_u), rtol=1e-5,
                               atol=1e-6)


def test_attend_approx_twin_bf16_rings_against_pallas_approx_multi():
    """The approx twin on bf16 [long-term ; working] rings against
    attend_pallas_approx_multi in interpret mode (exact threshold there),
    the same rings: the normalised weights are rounded to bf16 before the
    product on both sides. deva_tpu sums the similarity on the MXU in
    another order, so a weight at a bf16 rounding boundary may round the
    other way: outputs within 1e-5 on 99% and within one bf16 ulp of the
    weights (2^-7 * sum aff |V|) everywhere (measured on the CPU: all
    within 6e-8)."""
    mk, ms, values, qk, qe, valid = _rings(41, 1400, 90, 1300)
    k, cut = 30, 256
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    jrings = [(j16(mk[:cut]), j16(ms[:cut]), j16(values[:cut]),
               jnp.asarray(valid[:cut])),
              (j16(mk[cut:]), j16(ms[cut:]), j16(values[cut:]),
               jnp.asarray(valid[cut:]))]
    ref, ref_u = pa.attend_pallas_approx_multi(
        jrings, jnp.asarray(qk), jnp.asarray(qe), k, return_usage=True,
        interpret=True)
    t = lambda i: (_t16(mk[i]), _t16(ms[i]), _t16(values[i]),
                   torch.from_numpy(valid[i]))
    rings = [t(slice(0, cut)), t(slice(cut, None))]
    out, usage = apx.attend_approx_multi_plain(
        rings, torch.from_numpy(qk), torch.from_numpy(qe), k,
        return_usage=True)
    ref = np.asarray(ref)
    diff = np.abs(out.numpy() - ref)
    assert (diff <= 1e-5 + 1e-5 * np.abs(ref)).mean() >= 0.99
    # the weights of the twin's own support, for the bound
    mk_all, ms_all, v_all, valid_all = apx._concat_rings(rings)
    ops = apx.prep2(torch.from_numpy(qk), torch.from_numpy(qe), mk_all,
                    ms_all, valid_all)
    geom = apx.Geometry.of(mk_all.shape[0], apx.default_n_tile(64, 2))
    rmax, th = apx.threshold(apx.segmax_plain(ops, geom), k)
    aff = apx._support_weights(apx.similarity2_plain(ops), rmax, th)
    bound = 2.0 ** -7 * torch.einsum("qn,noc->oqc", aff,
                                     v_all.float().abs()) + 1e-5
    assert bool((torch.from_numpy(diff) <= bound).all())
    for u, r in zip(usage, ref_u):
        np.testing.assert_allclose(u.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the bf16 kernel paths' index logic and argument checks (CPU)
# --------------------------------------------------------------------------

READOUT_SOURCE = (Path(ak.__file__).resolve().parents[1] / "csrc" /
                  "topk_readout.cu").read_text()
RD = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                          READOUT_SOURCE).group(1))
      for name in ("QT", "CS", "THREADS")}


@pytest.mark.parametrize("q", [1, 17, 1620])
@pytest.mark.parametrize("c", [1024, 1536, 1028, 30])
def test_topk_readout_bf16_launch_covers_queries_and_columns(q, c):
    """topk_readout.cu's grid on a bf16 ring: ceil(Q/QT) x ceil(C/CS)
    blocks, a thread's items tid + i * THREADS of 16-byte vectors of 8
    elements (C % 8 == 0) or single elements, give every (query, column)
    exactly one item; a slice of CS columns holds whole vectors."""
    qt, cs, threads = RD["QT"], RD["CS"], RD["THREADS"]
    assert cs % 8 == 0
    for vw in ((8, 1) if c % 8 == 0 else (1,)):
        sv = cs // vw
        items = -(-qt * sv // threads)
        seen = np.zeros((q, c), np.int64)
        for q0 in range(0, q, qt):
            qn = min(qt, q - q0)
            for col0 in range(0, c, cs):
                units = min(cs, c - col0) // vw
                ql, u = np.divmod(np.arange(items * threads), sv)
                keep = (ql < qn) & (u < units)
                cols = col0 + u[keep, None] * vw + np.arange(vw)
                np.add.at(seen, (q0 + ql[keep, None], cols), 1)
        assert (seen == 1).all(), (q, c, vw)


def test_bf16_wrappers_reject_before_building():
    """The CUDA wrappers take one ring dtype per call, float32 or bfloat16,
    and raise before the kernel library is built for a mix or another
    dtype; a bf16 query side is widened, any other dtype there raises."""
    q, n, ck = 4, 40, 8
    qk, qe = torch.zeros((q, ck)), torch.zeros((q, ck))
    mk, ms = torch.zeros((n, ck)), torch.ones((n,))
    with pytest.raises(TypeError):
        ak._sim_topk_cuda(qk, qe, mk.bfloat16(), ms, None, 4)
    with pytest.raises(TypeError):
        ak._sim_topk_cuda(qk, qe, mk.half(), ms.half(), None, 4)
    with pytest.raises(TypeError):
        ak._sim_topk_cuda(qk.double(), qe, mk, ms, None, 4)
    idx = torch.zeros((q, 3), dtype=torch.int32)
    w = torch.zeros((q, 3))
    v = torch.zeros((n, 16))
    with pytest.raises(TypeError):
        ak._topk_readout_cuda(idx, w, (v[:5].bfloat16(), v[5:]))
    with pytest.raises(TypeError):
        ak._topk_readout_cuda(idx, w, v.half())
    ops = apx.prep2(qk, qe, mk.bfloat16(), ms.bfloat16(), None)
    assert ops.mcat.dtype == torch.float32  # built from the widened keys
    geom = apx.Geometry.of(n, 512)
    seg = apx.segmax_plain(ops, geom)
    with pytest.raises(TypeError):
        apx._denom_readout_cuda(ops, geom, seg, v.half(), 4)
