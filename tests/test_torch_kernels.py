"""repro_torch.kernels against the JAX reference, on the CPU.

The hand-written CUDA kernel cannot run here; its plain PyTorch version
(``cim_mac.gpq_matmul_plain``, what ``gpq_matmul`` runs on CPU tensors
and what ``chip_smoke.py`` holds the kernel to on the card) is held to
the reference's Pallas kernel in interpret mode and to its vectorized
oracle, bit for bit: every code, sum and product is an exact integer
multiple of the ADC step in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _grouped_planes as j_grouped_planes
from repro.core import quant as jquant
from repro.core.params import CIMConfig as JConfig
from repro.kernels import ref as jref
from repro.kernels.cim_mac import adder_tree_gpq_matmul as j_adder_tree_gpq
from repro.kernels.cim_mac import cell_adc_gpq_matmul as j_cell_adc_gpq
from repro.kernels.cim_mac import gpq_matmul as j_gpq_matmul
from repro_torch.core.engine import _grouped_planes as t_grouped_planes
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.variants import merged_quant, merged_transfer_int
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


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) the operand check refuses a meta tensor before any build."""
    x = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    before = cim_mac.LAUNCHES["gpq_matmul"]
    with pytest.raises(ValueError, match="CUDA"):
        cim_mac.gpq_matmul(x, w, TConfig())
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
        assert '#include "gpq_tile.cuh"' in text
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
    header = tmp_path / "gpq_tile.cuh"
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


def test_b2_integer_window_bounds_every_grid_point():
    """B2 clamps merged values to a window outside which its code
    saturates; the window's numerator fits int32 on the whole grid, and
    clamping changes no code."""
    for kw in GRID:
        for mode in ("floor", "nearest"):
            tc = TConfig(adc_mode=mode, **kw)
            mq = merged_quant(tc)
            threshold, m_lo, m_hi = cim_mac._merged_window(mq)
            assert threshold / (1 << mq.bits_eff) == mq.step
            edge = torch.tensor([m_lo, m_lo - 1000, m_hi, m_hi + 1000],
                                dtype=torch.float32)
            codes = merged_transfer_int(edge, tc).tolist()
            assert codes == [mq.code_min, mq.code_min, mq.code_max,
                             mq.code_max]


@pytest.mark.parametrize("variant,kernel", [
    ("adder-tree", "adder_tree_gpq_matmul"),
    ("cell-adc", "cell_adc_gpq_matmul")])
def test_b2_b3_non_cpu_tensor_never_takes_the_plain_version(variant, kernel):
    x = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    before = cim_mac.LAUNCHES[kernel]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cim_mac, kernel)(x, w, TConfig())
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.dispatch(x, w, TConfig(), variant=variant, backend="cuda")
    assert cim_mac.LAUNCHES[kernel] == before
