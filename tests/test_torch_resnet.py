"""repro_torch.models.resnet against the JAX reference, on the CPU.

The committed checkpoint (results/resnet_baseline, widths 16/32/64, two
blocks per stage) is read by both packages and driven on the same
synthetic eval images.

Tolerances and why:
  * im2col and every macro conv output for identical activations: bit
    for bit (exact integer macro arithmetic, same float32 epilogue).
  * logits: the digital layers (stem conv, BatchNorm's rsqrt, the fc
    matmul, the pooling mean) sum in another order than XLA, so logits
    differ in the last float32 bits; the 4-bit activation quantizer then
    moves a code where a value sits on a rounding boundary. Logits are
    held to 1e-4 relative in fp and cim-exact, 2e-2 absolute (logits are
    O(10)) under the ADC modes, and top-1 must be equal.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import CIMPolicy as JPolicy
from repro.core import engine as jengine
from repro.core.params import CIMConfig as JConfig
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.configs import resnet as tcfg
from repro_torch.core import engine as tengine
from repro_torch.kernels import cim_mac, dispatch
from repro_torch.models import resnet as tresnet

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_IMAGES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(policy):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common
    finally:
        sys.path.remove(str(ROOT))
    return dataclasses.replace(common.RESNET_CFG, cim=policy), common


def _tpolicy(jpolicy: JPolicy):
    c = jpolicy.cim
    return tcfg.cim_policy(mode=jpolicy.mode, rows=c.rows_active,
                           cutoff=c.cutoff, adc_bits=c.adc_bits,
                           vdd=c.vdd, act_clip_pct=jpolicy.act_clip_pct)


@pytest.fixture(scope="module")
def checkpoint():
    jcfg, common = _jcfg(JPolicy(mode="fp", act_symmetric=True))
    target = jax.eval_shape(
        lambda: jresnet.init(jax.random.PRNGKey(0), jcfg))
    jtree = jstore.restore(ROOT / "results" / "resnet_baseline",
                           {"params": target[0], "bn": target[1]})
    tparams, tbn = tcfg.load_baseline(device="cpu")
    batch = tcfg.dataset().batch(N_IMAGES, step=0, train=False)
    return dict(jparams=jtree["params"], jbn=jtree["bn"], tparams=tparams,
                tbn=tbn, batch=batch, common=common)


def _policies(ck, mode):
    jpol = ck["common"].cim_policy(mode=mode)
    jcfg, _ = _jcfg(jpol)
    tpol = _tpolicy(jpol)
    return jpol, jcfg, tpol, dataclasses.replace(tcfg.RESNET_CFG, cim=tpol)


def _jit_plan(params, jpol):
    """The reference's plans, traced once: the codes equal the eager
    ones; XLA rounds some scales (max|w| / 127) one ulp apart."""
    return jax.jit(lambda p: jresnet.plan_params(p, jpol))(params)


def _port_logits(ck, mode):
    _, _, tpol, tc = _policies(ck, mode)
    tp = ck["tparams"]
    if mode != "fp":
        tp = tresnet.plan_params(tp, tpol)
    with torch.no_grad():
        tlogits, _ = tresnet.forward(tp, ck["tbn"],
                                     torch.from_numpy(ck["batch"]["image"]),
                                     tc)
    return tlogits.numpy()


def _forward_both(ck, mode):
    """Logits of both packages; the reference plans and runs in one jit,
    which is several times cheaper here than eager execution."""
    jpol, jcfg, _, _ = _policies(ck, mode)

    def ref(p, b, img):
        if mode != "fp":
            p = jresnet.plan_params(p, jpol)
        return jresnet.forward(p, b, img, jcfg)[0]

    jlogits = jax.jit(ref)(ck["jparams"], ck["jbn"],
                           jnp.asarray(ck["batch"]["image"]))
    return np.asarray(jlogits), _port_logits(ck, mode)


def _torch_plan(jplan):
    """A reference PlannedWeights carried across field for field."""
    fields = ("codes", "scale", "colsum", "w", "planes", "slots")
    return tengine.PlannedWeights(
        **{f: None if getattr(jplan, f) is None
           else convert.to_torch(getattr(jplan, f), device="cpu")
           for f in fields},
        weight_bits=jplan.weight_bits)


def test_config_matches_benchmark_config():
    jcfg, common = _jcfg(JPolicy(mode="fp", act_symmetric=True))
    assert tcfg.RESNET_CFG.widths == jcfg.widths
    assert tcfg.RESNET_CFG.blocks_per_stage == jcfg.blocks_per_stage
    assert tcfg.RESNET_CFG.n_classes == jcfg.n_classes
    assert tcfg.RESNET_CFG.bn_momentum == jcfg.bn_momentum
    for mode in ("cim", "cim-kernel"):
        jp, tp = common.cim_policy(mode=mode), tcfg.cim_policy(mode=mode)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    img_t = tcfg.dataset().batch(4, step=3, train=False)
    img_j = common.SyntheticCIFAR(n_classes=10, seed=0, noise=2.2).batch(
        4, step=3, train=False)
    for k in ("image", "label"):
        np.testing.assert_array_equal(img_t[k], img_j[k])


# (kh, stride) over the 32 x 32 x 5 input, an odd non-square 7 x 9 (the
# asymmetric "SAME" pads at stride 2) and a batch of 4 with 24 channels.
IM2COL_SHAPES = {"": (2, 32, 32, 5), "-7x9": (2, 7, 9, 5),
                 "-b4c24": (4, 16, 16, 24)}
IM2COL_CASES = [pytest.param(kh, stride, shape, id=f"{kh}-{stride}{tag}")
                for tag, shape in IM2COL_SHAPES.items()
                for kh in (1, 3) for stride in (1, 2)]


@pytest.mark.parametrize("kh,stride,shape", IM2COL_CASES)
def test_im2col_matches_conv_patches_bit_exact(kh, stride, shape):
    x = np.random.default_rng(0).standard_normal(shape)
    x = x.astype(np.float32)
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (kh, kh), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tresnet.im2col(torch.from_numpy(x), (kh, kh), stride)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = np.random.default_rng(1).standard_normal((kh, kh, shape[-1], 7))
    w = w.astype(np.float32)
    conv_j = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv_t = tresnet.conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                                 stride)
    np.testing.assert_allclose(conv_t.numpy(), np.asarray(conv_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tresnet._im2col_weight(torch.from_numpy(w)).numpy(),
        np.asarray(jresnet._im2col_weight(jnp.asarray(w))))


def _unfold_im2col(x, kh, stride):
    """The oracle: ATen's ``F.unfold`` on the NCHW view padded "SAME"."""
    h, w = x.shape[1:3]
    ph = tresnet._same_pads(h, kh, stride)
    pw = tresnet._same_pads(w, kh, stride)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (pw[0], pw[1], ph[0], ph[1]))
    cols = torch.nn.functional.unfold(xp, (kh, kh), stride=stride)
    return cols.transpose(1, 2).reshape(x.shape[0], -(-h // stride),
                                        -(-w // stride), -1)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kh", [1, 3])
def test_im2col_gradient_matches_unfold(kh, stride):
    """The input gradient under a seeded upstream gradient (QAT's path
    through the patches) against ``F.unfold``'s. Windows that do not
    overlap (1 x 1) give each input one term, so the gradients are
    equal; overlapping 3 x 3 windows sum up to nine terms in another
    order, held to the QAT tests' float32 tolerance."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((3, 7, 9, 6), generator=gen).requires_grad_()
    got = tresnet.im2col(x, (kh, kh), stride)
    want = _unfold_im2col(x, kh, stride)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    (dx,) = torch.autograd.grad(got, x, g)
    (dx_want,) = torch.autograd.grad(want, x, g)
    if kh == 1:
        assert torch.equal(dx, dx_want)
    else:
        np.testing.assert_allclose(dx.numpy(), dx_want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_checkpoint_fp_and_exact_match_reference(checkpoint):
    labels = checkpoint["batch"]["label"]
    for mode in ("fp", "cim-exact"):
        jl, tl = _forward_both(checkpoint, mode)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4,
                                   err_msg=mode)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        assert (tl.argmax(-1) == labels).mean() == 1.0  # fp and exact: 8/8


def test_checkpoint_cim_per_conv_bit_exact_and_top1(checkpoint,
                                                   monkeypatch):
    """The reference's own forward under the paper policy taps every
    macro conv's im2col activations and records its macro output; the
    port executes the same activations against the same plan, carried
    across, through the kernel path, and must give the reference's
    output bit for bit. The reference's convs run eagerly (its jitted
    activation quantizer and ADC divide round differently). Then the
    whole network (port: its own plans and the scan twin)."""
    taps, outs = [], []
    real_execute = jengine.execute

    def recording_execute(x, plan, policy, **kw):
        y = real_execute(x, plan, policy, **kw)
        outs.append(np.asarray(y))
        return y

    def tap(name, x2, plan):
        taps.append((name, np.array(x2), plan))

    ck = checkpoint
    jpol, jcfg, tpol, _ = _policies(ck, "cim")
    monkeypatch.setattr(jengine, "execute", recording_execute)
    jl, _ = jresnet.forward(_jit_plan(ck["jparams"], jpol), ck["jbn"],
                            jnp.asarray(ck["batch"]["image"]), jcfg, tap=tap)
    assert len(taps) == len(outs) == 14  # stem digital; 14 macro convs
    tplanned = tresnet.plan_params(ck["tparams"], tpol)
    kernel_pol = dataclasses.replace(tpol, mode="cim-kernel")
    for (name, x2, jplan), want in zip(taps, outs, strict=True):
        node = tplanned
        for part in name.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.plan.codes.numpy(),
                                      np.asarray(jplan.codes), err_msg=name)
        got = tengine.execute(torch.from_numpy(x2), _torch_plan(jplan),
                              kernel_pol)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    tl = _port_logits(ck, "cim")
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(tl, jl, atol=2e-2)


def test_narrow_resnet_cim_kernel_matches_pallas_reference():
    """Random-init widths (8, 16, 32), one block per stage, under
    cim-kernel: the reference's Pallas kernel (interpret mode) against
    the port's kernel path (its plain version on the CPU). The
    reference plans under jit (same codes) and runs its forward eagerly:
    under jit, XLA rewrites its divisions by
    constants and folds the percentile position, which moves activation
    codes in this untrained net's large activations. (Widths
    (8, 16, 16) cannot run in the reference: a stride-2 stage without a
    width change has no projection, so its identity shortcut keeps the
    input's spatial size and the residual add fails.)"""
    jpol = JPolicy(mode="cim-kernel", cim=JConfig(), act_symmetric=True,
                   act_clip_pct=0.995)
    jcfg = jresnet.ResNetConfig(widths=(8, 16, 32), blocks_per_stage=1,
                                cim=jpol)
    # Fan-in scaled normal weights from numpy (the reference's init
    # draws them eagerly, one compile per shape).
    shapes, bn_shapes = jax.eval_shape(
        lambda: jresnet.init(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)

    def draw(path, s):
        name = str(path[-1])
        if "scale" in name or "var" in name:
            return np.ones(s.shape, s.dtype)
        if "bias" in name or "mean" in name or s.ndim == 1:
            return np.zeros(s.shape, s.dtype)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            s.dtype)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    bn = jax.tree_util.tree_map_with_path(draw, bn_shapes)
    tpol = _tpolicy(jpol)
    tc = tresnet.ResNetConfig(widths=(8, 16, 32), blocks_per_stage=1,
                              cim=tpol)
    tparams = convert.to_torch(params, device="cpu")
    tbn = convert.to_torch(bn, device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 32, 32, 3))
    x = x.astype(np.float32)
    jl, _ = jresnet.forward(_jit_plan(params, jpol), bn, jnp.asarray(x),
                            jcfg)
    before = cim_mac.LAUNCHES["gpq_matmul"]
    with dispatch.record_resolutions() as log, torch.no_grad():
        tl, _ = tresnet.forward(tresnet.plan_params(tparams, tpol), tbn,
                                torch.from_numpy(x), tc)
    assert cim_mac.LAUNCHES["gpq_matmul"] == before  # CPU: plain version
    assert len(log) == 8  # 2 + 3 (with proj) + 3 macro convs
    assert {(r.key.variant, r.key.backend, r.source) for r in log} == {
        ("p8t", "cuda", "explicit")}
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(tl.numpy(), jl, atol=2e-2)


def test_unplanned_cim_conv_raises_naming_the_slice(checkpoint):
    """An unplanned (fresh-weight) CIM conv raised before training was
    ported, hence the name. It now plans per call through engine.matmul
    (the QAT path) and gives the planned forward's logits bit for bit."""
    pol = tcfg.cim_policy(mode="cim")
    c = dataclasses.replace(tcfg.RESNET_CFG, cim=pol)
    x = torch.from_numpy(checkpoint["batch"]["image"][:2])
    fresh, _ = tresnet.forward(checkpoint["tparams"], checkpoint["tbn"], x, c)
    planned, _ = tresnet.forward(
        tresnet.plan_params(checkpoint["tparams"], pol), checkpoint["tbn"],
        x, c)
    assert torch.equal(fresh, planned)
