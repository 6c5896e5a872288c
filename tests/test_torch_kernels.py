"""repro_torch.kernels against the JAX reference, on the CPU.

The hand-written CUDA kernel cannot run here; its plain PyTorch version
(``cim_mac.gpq_matmul_plain``, what ``gpq_matmul`` runs on CPU tensors
and what ``chip_smoke.py`` holds the kernel to on the card) is held to
the reference's Pallas kernel in interpret mode and to its vectorized
oracle, bit for bit: every code, sum and product is an exact integer
multiple of the ADC step in float32.
"""

import ctypes
import ctypes.util
import functools
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _grouped_planes as j_grouped_planes
from repro.core import quant as jquant
from repro.core.variants import merged_transfer_int as j_merged_transfer_int
from repro.core.params import CIMConfig as JConfig
from repro.kernels import ref as jref
from repro.kernels.cim_mac import adder_tree_gpq_matmul as j_adder_tree_gpq
from repro.kernels.cim_mac import cell_adc_gpq_matmul as j_cell_adc_gpq
from repro.kernels.cim_mac import gpq_matmul as j_gpq_matmul
from repro_torch.core.engine import _grouped_planes as t_grouped_planes
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.variants import merged_quant, merged_transfer_int
from repro_torch.core import quant
from repro_torch.core.quant import spread_slots
from repro_torch.kernels import build, cim_mac, dispatch, ops
from repro_torch.kernels import ref as tref

# rows {4, 8, 16} x ADC bits {3, 4, 5} at cutoff 0.5 (the certified
# geometries), plus the step-12 point (16 rows, cutoff 0.25, 4-bit).
GRID = [dict(rows_active=r, adc_bits=a, cutoff=0.5)
        for r in (4, 8, 16) for a in (3, 4, 5)]
GRID.append(dict(rows_active=16, adc_bits=4, cutoff=0.25))
GRID_IDS = [f"r{g['rows_active']}-adc{g['adc_bits']}-cut{g['cutoff']}"
            for g in GRID]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, w


def _packed_bytes(w: np.ndarray) -> np.ndarray:
    """int8 codes -> the uint8 bytes a plan's packed planes hold."""
    return w.view(np.uint8).copy()


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_plain_gpq_matches_pallas_interpret(kw, mode):
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    x, w = _codes(kw["rows_active"] * 10 + kw["adc_bits"], 37, 100, 21)
    want = np.asarray(j_gpq_matmul(jnp.asarray(x), jnp.asarray(w), jc,
                                   bm=32, bn=32, bk=48, interpret=True))
    tx = torch.from_numpy(x)
    got_i8 = cim_mac.gpq_matmul(tx, torch.from_numpy(w), tc)
    got_u8 = cim_mac.gpq_matmul(tx, torch.from_numpy(_packed_bytes(w)), tc)
    assert got_i8.dtype == torch.float32 and got_i8.shape == (37, 21)
    np.testing.assert_array_equal(got_i8.numpy(), want)
    np.testing.assert_array_equal(got_u8.numpy(), want)


REF_SHAPES = [(1, 16, 1), (9, 144, 16), (13, 35, 70)]


@functools.cache
def _oracle(grid_index: int, mode: str):
    """The reference's vectorized and spread-slot oracles at every shape
    of REF_SHAPES, traced in one jit per operating point."""
    jc = JConfig(adc_mode=mode, **GRID[grid_index])
    args = []
    for m, k, n in REF_SHAPES:
        x, w = _codes(m * k + n, m, k, n)
        slots = jquant.spread_slots(jnp.asarray(w, jnp.int32),
                                    jc.rows_active, 4, 8)
        args.append((jnp.asarray(x), jnp.asarray(w), slots))

    def run(args):
        return [(jref.cim_matmul_ref(x, w, jc),
                 jref.cim_matmul_slots(x, s, jc)) for x, w, s in args]

    out = jax.jit(run)(args)
    return {shape: tuple(np.asarray(o) for o in pair)
            for shape, pair in zip(REF_SHAPES, out, strict=True)}


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("gi", [1, 5, len(GRID) - 1],
                         ids=[GRID_IDS[1], GRID_IDS[5], GRID_IDS[-1]])
@pytest.mark.parametrize("m,k,n", REF_SHAPES)
def test_plain_and_ref_forms_match_reference_oracle(gi, mode, m, k, n):
    tc = TConfig(adc_mode=mode, **GRID[gi])
    x, w = _codes(m * k + n, m, k, n)
    want, want_slots = _oracle(gi, mode)[(m, k, n)]
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(cim_mac.gpq_matmul(tx, tw, tc).numpy(),
                                  want)
    np.testing.assert_array_equal(tref.cim_matmul_ref(tx, tw, tc).numpy(),
                                  want)
    for packed in (False, True):
        planes = t_grouped_planes(tw.to(torch.int32), tc, packed=packed)
        np.testing.assert_array_equal(
            tref.cim_matmul_ref(tx, tw, tc, planes=planes).numpy(), want)
    slots = spread_slots(tw.to(torch.int32), tc.rows_active, 4, 8)
    np.testing.assert_array_equal(
        tref.cim_matmul_slots(tx, slots, tc).numpy(), want_slots)


def test_packed_plane_flatten_slice_is_kernel_operand():
    """A plan's packed planes, flatten-sliced to [K, N], feed the kernel
    as its uint8 operand (what dispatch's cuda backend passes)."""
    tc, jc = TConfig(rows_active=8), JConfig(rows_active=8)
    x, w = _codes(3, 11, 50, 9)
    planes = t_grouped_planes(torch.from_numpy(w).to(torch.int32), tc,
                              packed=True)
    jplanes = j_grouped_planes(jnp.asarray(w, jnp.int32), jc, packed=True)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    flat = planes.reshape(-1, planes.shape[-1])[:50]
    got = ops.cim_matmul_kernel(torch.from_numpy(x), flat, tc)
    want = cim_mac.gpq_matmul(torch.from_numpy(x), torch.from_numpy(w), tc)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_extreme_codes_and_zero_inputs():
    cfg = TConfig()
    x = torch.full((4, 32), 15, dtype=torch.int32)
    w = torch.full((32, 4), -128, dtype=torch.int8)
    want = np.asarray(j_gpq_matmul(jnp.asarray(x.numpy()),
                                   jnp.asarray(w.numpy()), JConfig(),
                                   bm=4, bn=4, bk=32, interpret=True))
    got = cim_mac.gpq_matmul(x, w, cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < 0).all()
    zero = cim_mac.gpq_matmul(torch.zeros((8, 64), dtype=torch.int32),
                              w.repeat(2, 1), cfg)
    assert torch.equal(zero, torch.zeros(8, 4))


def test_depth_guard_raises_like_reference():
    cfg = TConfig()
    k = 1 << 22
    x = torch.zeros((1, k), dtype=torch.int32)
    w = torch.zeros((k, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="too deep"):
        cim_mac.gpq_matmul(x, w, cfg)
    with pytest.raises(ValueError, match="too deep"):
        j_gpq_matmul(jnp.zeros((1, k), jnp.int32), jnp.zeros((k, 1), jnp.int8),
                     JConfig(), interpret=True)
    # The edge at the paper point: G * 128 * 128 < 2**23 * 8, so 4095
    # groups pass and 4096 raise, in both packages.
    spec = cfg.to_spec()
    cim_mac._depth_guard(4095 * 16, spec)
    with pytest.raises(ValueError, match="too deep"):
        cim_mac._depth_guard(4096 * 16, spec)
    with pytest.raises(ValueError, match="too deep"):
        j_gpq_matmul(jnp.zeros((1, 4096 * 16), jnp.int32),
                     jnp.zeros((4096 * 16, 1), jnp.int8), JConfig(),
                     interpret=True)


def _refuse_plain(*_a, **_k):
    raise AssertionError("the plain version ran on a non-CPU tensor")


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU launches the kernel or raises, never the plain
    version: here (no CUDA device) meta tensors take the shape-only path
    (the launch's checks, an empty meta output, nothing launched), and a
    meta tensor beside a CPU one is refused by the operand check before
    any build."""
    monkeypatch.setattr(cim_mac, "gpq_matmul_plain", _refuse_plain)
    x = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    before = cim_mac.LAUNCHES["gpq_matmul"]
    y = cim_mac.gpq_matmul(x, w, TConfig())
    assert y.is_meta and y.shape == (4, 4) and y.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        cim_mac.gpq_matmul(x, torch.zeros((16, 4), dtype=torch.int8),
                           TConfig())
    assert cim_mac.LAUNCHES["gpq_matmul"] == before


def test_plain_path_does_not_count_launches():
    before = cim_mac.LAUNCHES["gpq_matmul"]
    x, w = _codes(0, 3, 16, 2)
    cim_mac.gpq_matmul(torch.from_numpy(x), torch.from_numpy(w), TConfig())
    assert cim_mac.LAUNCHES["gpq_matmul"] == before


def test_build_finds_source_and_reports_missing_nvcc(monkeypatch):
    srcs = build.sources()
    assert set(srcs) == {"gpq_matmul", "adder_tree_gpq_matmul",
                         "cell_adc_gpq_matmul"}
    for name, src in srcs.items():
        text = src.read_text()
        assert f"repro/kernels/cim_mac.py::{name}" in text
        assert 'extern "C"' in text and f"{name}_launch" in text
        assert '#include "gpq_launch.cuh"' in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.pathlib.Path, "is_file", lambda self: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.nvcc_path()


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/*.cuh names a new library, so it is rebuilt."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "adder_tree_gpq_matmul.cu"
    before = build._lib_path(src)
    assert build._lib_path(src) == before
    header = tmp_path / "gpq_launch.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build._lib_path(src) != before


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_plain_b2_b3_match_pallas_interpret(kw, mode):
    """B2's and B3's plain versions (what the wrappers run on the CPU)
    against the reference's Pallas kernels in interpret mode and its
    eager oracles.

    One known difference, on the reference side: inside jit, XLA turns
    ``floor(merged / step + 1/2)`` into an FMA with f32(1/step), and
    f32(1/12) rounds up, so at the step-12 point in nearest mode a
    NEGATIVE merged value at an exact half step reads one code lower in
    the Pallas kernel than in the reference's own eager oracle (ROADMAP
    C). The port follows the eager oracle (true division) everywhere and
    the Pallas kernel wherever the two reference forms agree.
    """
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    x, w = _codes(kw["rows_active"] * 10 + kw["adc_bits"], 37, 100, 21)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx = torch.from_numpy(x)
    for jfn, jeager, tfn in (
        (j_adder_tree_gpq, jref.adder_tree_matmul_ref,
         cim_mac.adder_tree_gpq_matmul),
        (j_cell_adc_gpq, jref.cim_matmul_ref, cim_mac.cell_adc_gpq_matmul),
    ):
        pallas = np.asarray(jfn(jx, jw, jc, bm=32, bn=32, bk=48,
                                interpret=True))
        eager = np.asarray(jeager(jx, jw, jc))
        agree = pallas == eager
        if not agree.all():
            assert tfn is cim_mac.adder_tree_gpq_matmul
            assert (kw["cutoff"], mode) == (0.25, "nearest")
            assert (np.abs(pallas - eager)[~agree] == 12).all()
        for tw in (torch.from_numpy(w), torch.from_numpy(w.view(np.uint8))):
            got = tfn(tx, tw, tc)
            assert got.shape == (37, 21) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), eager,
                                          err_msg=tfn.__name__)
            np.testing.assert_array_equal(got.numpy()[agree], pallas[agree],
                                          err_msg=tfn.__name__)
    np.testing.assert_array_equal(
        cim_mac.cell_adc_gpq_matmul(tx, torch.from_numpy(w), tc).numpy(),
        cim_mac.gpq_matmul(tx, torch.from_numpy(w), tc).numpy())


def test_b2_b3_depth_guards_raise_at_the_reference_depth():
    """B3 keeps B1's guard (4096 groups at the paper point); B2 raises
    when G * 2048 reaches 2**24 (8192 groups), in both packages."""
    jc = JConfig()
    spec = TConfig().to_spec()
    cim_mac._merged_depth_guard(8191 * 16, spec)
    with pytest.raises(cim_mac.DepthGuardError, match="merged codes"):
        cim_mac._merged_depth_guard(8192 * 16, spec)
    cim_mac._depth_guard(4095 * 16, spec)
    for groups, jfn, tfn in (
        (8192, j_adder_tree_gpq, cim_mac.adder_tree_gpq_matmul),
        (4096, j_cell_adc_gpq, cim_mac.cell_adc_gpq_matmul),
    ):
        k = groups * 16
        with pytest.raises(ValueError, match="too deep"):
            jfn(jnp.zeros((1, k), jnp.int32), jnp.zeros((k, 1), jnp.int8),
                jc, interpret=True)
        with pytest.raises(ValueError, match="too deep"):
            tfn(torch.zeros((1, k), dtype=torch.int32),
                torch.zeros((k, 1), dtype=torch.int8), TConfig())


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.fmaf.argtypes = [ctypes.c_float] * 3
_LIBM.fmaf.restype = ctypes.c_float


def _b2_kernel_codes(merged: np.ndarray, mq, nearest: bool) -> np.ndarray:
    """adder_tree_gpq_matmul.cu MergedConversion::code in float32: r =
    RN(1 / step), q0 = RN(m r), q = fma(fma(-q0, step, m), r, q0) (libm's
    fmaf rounds once, as __fmaf_rn does), t = clamp(RN(q + half),
    code_min, code_max), code = floor(t) (the kernel's magic-number int
    <-> float conversions are exact in its range)."""
    step = np.float32(mq.step)
    recip = np.float32(1.0) / step
    half = np.float32(0.5 if nearest else 0.0)
    m = merged.astype(np.float32)
    q0 = m * recip
    q = np.array([_LIBM.fmaf(_LIBM.fmaf(-a, step, b), recip, a)
                  for a, b in zip(q0.tolist(), m.tolist())],
                 dtype=np.float32)
    t = np.clip(q + half, np.float32(mq.code_min), np.float32(mq.code_max))
    return np.floor(t).astype(np.int64)


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("cutoff", [0.5, 0.25, 0.3, 0.35, 0.4])
def test_b2_conversion_equals_both_merged_transfers(cutoff, mode):
    """B2's float32 conversion (a reciprocal with one FMA correction, in
    place of a divide) gives the port's and the reference's (eager)
    merged_transfer_int code for every merged value in [m_min, m_max], on
    and off the grid (steps that are not whole)."""
    tc = TConfig(adc_mode=mode, cutoff=cutoff)
    mq = merged_quant(tc)
    assert float(np.float32(mq.step)) == mq.step  # the kernel's f32 step
    merged = np.arange(mq.m_min, mq.m_max + 1, dtype=np.int32)
    got = _b2_kernel_codes(merged, mq, mode == "nearest")
    port = merged_transfer_int(torch.from_numpy(merged), tc).numpy()
    ref = np.asarray(j_merged_transfer_int(jnp.asarray(merged),
                                           JConfig(adc_mode=mode,
                                                   cutoff=cutoff)))
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, ref)


def _b2_old_integer_code(m: int, mq, nearest: bool) -> int:
    """The integer form B2's kernel used before its float32 conversion:
    the exact floor((merged 2^(bits_eff+1) + nearest T) / 2T), T =
    step 2^bits_eff, with merged clamped to the window where codes
    saturate."""
    m_lo = math.floor((mq.code_min - 1) * mq.step)
    m_hi = math.ceil((mq.code_max + 1) * mq.step)
    t = round(mq.step * (1 << mq.bits_eff))
    q = ((min(max(m, m_lo), m_hi) * (2 << mq.bits_eff) + nearest * t)
         // (2 * t))
    return min(max(q, mq.code_min), mq.code_max)


@pytest.mark.parametrize("cutoff,mode,merged,ref_code,old_code", [
    (0.4, "floor", -19613, -2043, -2044),
    (0.4, "nearest", -19637, -2045, -2046),
    (0.35, "floor", 21247, 2043, 2042),
    (0.35, "nearest", 21273, 2046, 2045),
])
def test_b2_old_integer_conversion_parts_from_the_reference(
        cutoff, mode, merged, ref_code, old_code):
    """Where the step is not whole, merged / step can land within half an
    ulp of an integer: float32 rounds onto it, exact arithmetic does not.
    The old integer form read one code off there; the kernel's float32
    form reads the reference's."""
    tc = TConfig(adc_mode=mode, cutoff=cutoff)
    mq = merged_quant(tc)
    m = np.array([merged], dtype=np.int32)
    ref = np.asarray(j_merged_transfer_int(
        jnp.asarray(m), JConfig(adc_mode=mode, cutoff=cutoff)))
    assert ref.tolist() == [ref_code]
    assert merged_transfer_int(torch.from_numpy(m), tc).tolist() == [ref_code]
    assert _b2_kernel_codes(m, mq, mode == "nearest").tolist() == [ref_code]
    assert _b2_old_integer_code(merged, mq, mode == "nearest") == old_code


@pytest.mark.parametrize("variant,kernel", [
    ("adder-tree", "adder_tree_gpq_matmul"),
    ("cell-adc", "cell_adc_gpq_matmul")])
def test_b2_b3_non_cpu_tensor_never_takes_the_plain_version(
        variant, kernel, monkeypatch):
    monkeypatch.setattr(cim_mac, f"{kernel}_plain", _refuse_plain)
    x = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    w_cpu = torch.zeros((16, 4), dtype=torch.int8)
    before = cim_mac.LAUNCHES[kernel]
    for y in (getattr(cim_mac, kernel)(x, w, TConfig()),
              dispatch.dispatch(x, w, TConfig(), variant=variant,
                                backend="cuda")):
        assert y.is_meta and y.shape == (4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cim_mac, kernel)(x, w_cpu, TConfig())
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.dispatch(x, w_cpu, TConfig(), variant=variant,
                          backend="cuda")
    assert cim_mac.LAUNCHES[kernel] == before


# -- Mirrors of the per-plane kernels' integer arithmetic (csrc/
# plane_mma.cuh, gpq_matmul.cu, cell_adc_gpq_matmul.cu), held to the plain
# versions' codes: the card cannot run here, these operations can.

CERT = (pathlib.Path(__file__).resolve().parent.parent
        / "results" / "analysis" / "range-certificate.json")


def _certificate_geometries():
    out = []
    for g in json.loads(CERT.read_text())["geometries"].values():
        out.append(pytest.param(dict(
            rows_per_group=g["rows_per_group"], rows_active=g["rows_active"],
            act_bits=g["act_bits"], weight_bits=g["weight_bits"],
            adc_bits=g["adc_bits"], cutoff=g["cutoff"],
            adc_coarse_bits=g["coarse_bits"]), id=g["ident"]))
    out.append(pytest.param(dict(rows_active=16, cutoff=0.25, adc_bits=4),
                            id="step12/r16/cut0.25/adc4"))
    return out


CERT_GEOMETRIES = _certificate_geometries()
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


U32 = (1 << 32) - 1


def _table_code(p, adc_bits, threshold, code_max, nearest):
    """FlashTable's entry for pMAC p (gpq_matmul.cu adc_code): 0 at or
    below 0, the top code at or above the threshold, else the integer
    floor of the flash's quotient."""
    if p <= 0:
        return 0
    if p >= threshold:
        return code_max
    c = (((2 * p) << adc_bits) + threshold) // (2 * threshold) if nearest \
        else (p << adc_bits) // threshold
    return min(c, code_max)


def _shift2_constants(spec, nearest):
    """gpq_matmul.cu flash_shift2: (s, h, top) where the kernel converts
    two pMACs per register (a power-of-two step of s pMACs, a group's sum
    within a signed half), else None (it reads its table)."""
    if spec.threshold % (1 << spec.adc_bits) or 255 * spec.threshold >= 1 << 15:
        return None
    s = spec.threshold >> spec.adc_bits
    if s & (s - 1):
        return None
    return s, s // 2 if nearest else 0, spec.adc_codes * s - 1


def _s16(u):
    return u - 0x10000 if u & 0x8000 else u


def _per_half(fn, *regs):
    """A Hopper DPX 16x2 instruction: fn on each 16-bit half of the
    registers (signed or unsigned as fn reads them), halves kept apart."""
    out = 0
    for i in (0, 1):
        out |= (fn(*[(r >> 16 * i) & 0xFFFF for r in regs]) & 0xFFFF) << 16 * i
    return out


def _pair(lo, hi):
    """__byte_perm(lo, hi, 0x5410): two pMACs in the halves of one
    register."""
    return (lo & 0xFFFF) | (hi & 0xFFFF) << 16


def _halves(v):
    return v & 0xFFFF, (v >> 16) & 0xFFFF


def _flash_shift2(p2, s, h, top):
    """FlashShift2::code2: __viaddmin_s16x2_relu(p2, h, top) per half,
    then the low log2(s) bits of each half cleared: code * s."""
    q2 = _per_half(lambda a, b, c: max(min(_s16((a + b) & 0xFFFF), _s16(c)),
                                       0), p2, h * 0x10001, top * 0x10001)
    return q2 & ((0xFFFF & ~(s - 1)) * 0x10001)


def _sar2(p2, adc_bits, s, nearest):
    """SarSearch<kBits>::code2: q = __viaddmax_s16x2(p2, h, 0), then from
    the MSB down r = __viaddmin_u16x2(r, -(s 2^bit), r) (keep when r
    covers the level), per half; returns q - r, code * s in each half."""
    h = s // 2 if nearest else 0
    q2 = _per_half(lambda a, b, c: max(_s16((a + b) & 0xFFFF), _s16(c)),
                   p2, h * 0x10001, 0)
    r2 = q2
    for bit in range(adc_bits - 1, -1, -1):
        neg = ((-(s << bit)) & 0xFFFF) * 0x10001
        r2 = _per_half(lambda a, b, c: min((a + b) & 0xFFFF, c), r2, neg, r2)
    return (q2 - r2) & U32


def _sar_residual(q, levels):
    """SarSearch<0>'s steps: from the MSB down, r = min(r - level, r) in
    unsigned 32-bit arithmetic (keep when r covers the level); returns
    q - r, the kept levels' sum."""
    r = q
    for level in reversed(levels):
        r = min((r - level) & U32, r)
    return q - r


def _sar_scaled(p, adc_bits, threshold, nearest):
    """SarSearch<0>::code: q = max(p 2^(adc_bits+1) + nearest t, 0),
    levels 2t 2^bit, code = umulhi(q - r, ceil(2^32 / 2t))."""
    scaled = p * (2 << adc_bits)
    assert INT32_MIN <= scaled <= INT32_MAX
    q = max(scaled + nearest * threshold, 0)
    kept = _sar_residual(q, [2 * threshold << bit for bit in range(adc_bits)])
    return (kept * -(-(1 << 32) // (2 * threshold))) >> 32


def _packs(spec):
    """Whether the kernels convert two pMACs per register here: a whole
    step and a group's shift-add sum within a signed half."""
    return (spec.threshold % (1 << spec.adc_bits) == 0
            and 255 * spec.threshold < 1 << 15)


def _all_pmacs(spec):
    return torch.arange(-1, spec.pmac_max + 1, dtype=torch.float32)


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("kw", CERT_GEOMETRIES)
def test_b1_flash_codes_equal_plain_codes(kw, mode):
    """B1's conversion gives the plain version's code for every pMAC from
    -1 to pmac_max: at the 27 certified geometries (power-of-two steps)
    two per register by clamp-then-mask (FlashShift2, each pMAC paired
    with another), at the step-12 point from the shared-memory table."""
    spec = TConfig(adc_mode=mode, **kw).to_spec()
    nearest = mode == "nearest"
    pmacs = [int(p) for p in _all_pmacs(spec)]
    want = cim_mac._flash_codes(_all_pmacs(spec), spec).to(torch.int64)
    want = want.tolist()
    consts = _shift2_constants(spec, nearest)
    assert (consts is None) == (spec.adc_step == 12)
    if consts is None:
        got = [_table_code(p, spec.adc_bits, spec.threshold,
                           spec.adc_codes - 1, nearest) for p in pmacs]
        assert got == want
        return
    s = consts[0]
    assert s == spec.adc_step
    for p, other in zip(pmacs, reversed(pmacs)):
        lo, hi = _halves(_flash_shift2(_pair(p, other), *consts))
        assert (lo, hi) == (want[p + 1] * s, want[other + 1] * s)


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("kw", CERT_GEOMETRIES)
def test_b3_integer_sar_codes_equal_plain_codes(kw, mode):
    """B3's residual SAR gives the plain SAR's code (and B1's) for every
    pMAC from -1 to pmac_max: two per register (code * s in each half,
    the launch scaling by adc_step / s = 1) where a group's sum fits a
    half, and in its scaled run-time form everywhere."""
    spec = TConfig(adc_mode=mode, **kw).to_spec()
    nearest = int(mode == "nearest")
    pmacs = [int(p) for p in _all_pmacs(spec)]
    want = cim_mac._sar_codes(_all_pmacs(spec), spec).tolist()
    assert want == cim_mac._flash_codes(_all_pmacs(spec),
                                        spec).to(torch.int64).tolist()
    assert [_sar_scaled(p, spec.adc_bits, spec.threshold, nearest)
            for p in pmacs] == want
    if _packs(spec):
        s = int(spec.adc_step)
        for p, other in zip(pmacs, reversed(pmacs)):
            lo, hi = _halves(_sar2(_pair(p, other), spec.adc_bits, s,
                                   nearest))
            assert (lo, hi) == (want[p + 1] * s, want[other + 1] * s)


def test_packed_group_sums_unpack_exactly():
    """The packed path's per-group sum of s_b 2^b (code * s) over both
    halves, at its extremes (the launch takes it up to 255 t < 2^15) and
    at random, unpacks into the two exact sums: hi = (sum + 2^15) >> 16,
    lo = sum - hi 2^16."""
    rng = np.random.default_rng(0)
    pw = [1 << b for b in range(7)] + [-(1 << 7)]
    top = (1 << 15) // 255  # the largest code * s a group may hold
    cases = [([top] * 8, [0] * 8), ([0] * 8, [top] * 8),
             ([0] * 7 + [top], [top] * 7 + [0]), ([top] * 8, [top] * 8)]
    cases += [(list(rng.integers(0, top + 1, 8)),
               list(rng.integers(0, top + 1, 8))) for _ in range(200)]
    for lo_vals, hi_vals in cases:
        total = 0
        for b in range(8):
            total = (total + _pair(int(lo_vals[b]), int(hi_vals[b]))
                     * (pw[b] & U32)) & U32
        t = (total + 0x8000) & U32
        hi = (t - (1 << 32) if t >> 31 else t) >> 16  # int32 >> 16
        lo = (total - (hi << 16)) & U32
        lo = lo - (1 << 32) if lo & (1 << 31) else lo
        assert lo == sum(p * int(v) for p, v in zip(pw, lo_vals))
        assert hi == sum(p * int(v) for p, v in zip(pw, hi_vals))


@pytest.mark.parametrize("mode", ["floor", "nearest"])
def test_off_grid_step_takes_the_table_and_the_scaled_sar(mode):
    """At cutoff 0.3 the step (179 / 16 pMACs) is not whole: B1 reads its
    shared-memory table and B3 runs its scaled run-time search, and both
    give the plain version's codes."""
    spec = TConfig(adc_mode=mode, cutoff=0.3).to_spec()
    nearest = int(mode == "nearest")
    assert _shift2_constants(spec, nearest) is None and not _packs(spec)
    pmacs = [int(p) for p in _all_pmacs(spec)]
    want = cim_mac._sar_codes(_all_pmacs(spec), spec).tolist()
    assert [_sar_scaled(p, spec.adc_bits, spec.threshold, nearest)
            for p in pmacs] == want
    assert [_table_code(p, spec.adc_bits, spec.threshold,
                        spec.adc_codes - 1, nearest) for p in pmacs] == want


def _vsub4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """__vsub4: per-byte a - b of uint32 words, each byte mod 2^8."""
    out = np.zeros_like(a)
    for e in range(4):
        sh = np.uint32(8 * e)
        out |= (((a >> sh) - (b >> sh)) & np.uint32(0xFF)) << sh
    return out


@pytest.mark.parametrize("weight_bits", range(1, 9))
def test_b2_staged_bytes_are_twos_complement_codes(weight_bits):
    """B2's weight staging (plane_mma.cuh SignedPlane::staged): the
    masked code bits u of each byte of a word become (u ^ s) - s, s =
    2^(weight_bits - 1), per byte; read as int8, every byte 0 .. 255
    gives quant's two's-complement reading of its low weight_bits, from
    uint8 packed bytes and int8 codes alike."""
    raw = np.arange(256, dtype=np.uint8)
    mask = np.uint32(((1 << weight_bits) - 1) * 0x01010101)
    s4 = np.uint32((1 << (weight_bits - 1)) * 0x01010101)
    words = raw.view(np.uint32)  # 4 bytes a word, lowest k lowest
    staged = _vsub4((words & mask) ^ s4, np.full_like(words, s4))
    got = staged.view(np.int8).astype(np.int32)
    for w in (torch.from_numpy(raw), torch.from_numpy(raw.view(np.int8))):
        want = quant.unslice_weights(
            quant.bitslice_weights(w, weight_bits), weight_bits)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("weight_bits", range(1, 9))
def test_plane_fragment_bits_equal_unpacked_planes(weight_bits):
    """The weights staged as 32-bit words of 4 k-consecutive masked bytes
    of one column (stage_plane_weights, weight_bits_of<false>) give, as
    (word >> b) & 0x01010101, every plane bit of _unpacked_planes, from
    int8 codes and from uint8 packed bytes alike."""
    rng = np.random.default_rng(weight_bits)
    k, n = 32, 12
    raw = rng.integers(0, 256, (k, n)).astype(np.uint8)
    for w in (torch.from_numpy(raw), torch.from_numpy(raw.view(np.int8))):
        planes = cim_mac._unpacked_planes(w, weight_bits)  # [K, B, N]
        masked = w.numpy().view(np.uint8).astype(np.uint32) & (
            (1 << weight_bits) - 1)
        for q in range(k // 4):
            word = (masked[4 * q] | masked[4 * q + 1] << 8
                    | masked[4 * q + 2] << 16 | masked[4 * q + 3] << 24)
            for b in range(weight_bits):
                frag = (word >> b) & 0x01010101
                for e in range(4):
                    np.testing.assert_array_equal(
                        (frag >> (8 * e)) & 0xFF,
                        planes[4 * q + e, b].numpy().astype(np.uint32))


@pytest.mark.parametrize("kernel", ["gpq_matmul", "cell_adc_gpq_matmul",
                                    "adder_tree_gpq_matmul"])
def test_per_plane_wrappers_raise_for_act_bits_over_8(kernel):
    """Off the CPU, B1, B3 and B2 refuse act_bits > 8 (the tensor-core
    kernel's A operand is an unsigned byte) before any build or
    launch."""
    x = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    before = cim_mac.LAUNCHES[kernel]
    with pytest.raises(ValueError, match="act_bits <= 8"):
        getattr(cim_mac, kernel)(x, w, TConfig(act_bits=9))
    getattr(cim_mac, kernel)(torch.zeros((4, 16), dtype=torch.int32),
                             torch.zeros((16, 4), dtype=torch.int8),
                             TConfig(act_bits=9))  # the CPU path takes it
    assert cim_mac.LAUNCHES[kernel] == before
