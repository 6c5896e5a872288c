"""The port's package-level API against the JAX reference's, on the CPU.

Every name of a reference package's ``__all__`` is in the port
package's. The deprecated one-shot ``cim_matmul`` and
``cim_matmul_ste`` shims and ``dequantize_*`` equal the reference's bit
for bit (noiseless, numpy-seeded inputs); ``register_variant`` replaces a
variant only when asked; ``launch.dryrun.validate_cell`` equals the
reference's on every arch x shape and raises the same messages.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

PACKAGES = ("core", "kernels", "models", "configs", "checkpoint", "serve",
            "sweep", "data", "optim", "train", "distributed")
MODES = ("fp", "cim-exact", "cim", "cim-kernel")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_dryrun():
    """The reference's launch.dryrun, with the XLA_FLAGS its import sets
    (512 host devices) taken out of the environment again, so processes
    spawned by later tests do not inherit it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        yield importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("package", PACKAGES)
def test_reference_all_resolves_in_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = set(ref.__all__)
    assert want <= set(port.__all__)
    missing = [n for n in sorted(want) if not hasattr(port, n)]
    assert not missing


def _inputs(seed=0, m=8, k=96, n=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("act_symmetric", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cim_matmul_shims_match_reference(mode, act_symmetric):
    x, w = _inputs(seed=1 + MODES.index(mode))
    kw = dict(act_symmetric=act_symmetric, act_clip_pct=0.99)
    want = np.asarray(jcore.cim_matmul(
        jnp.asarray(x), jnp.asarray(w), jcore.PAPER_OP_16ROWS, mode=mode,
        **kw))
    got = tcore.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           tcore.PAPER_OP_16ROWS, mode=mode, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "fp":
        return
    want_ste = np.asarray(jcore.cim_matmul_ste(
        jnp.asarray(x), jnp.asarray(w), jcore.PAPER_OP_8ROWS, mode, **kw))
    got_ste = tcore.cim_matmul_ste(
        torch.from_numpy(x).requires_grad_(), torch.from_numpy(w),
        tcore.PAPER_OP_8ROWS, mode, **kw)
    np.testing.assert_array_equal(got_ste.detach().numpy(), want_ste)


def test_cim_matmul_needs_a_config_in_cim_modes():
    x, w = _inputs()
    with pytest.raises(ValueError, match="CIMConfig"):
        tcore.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         mode="cim")


@pytest.mark.parametrize("symmetric", [False, True])
def test_dequantize_matches_reference(symmetric):
    x, w = _inputs(seed=7)
    jq = jcore.quantize_acts(jnp.asarray(x), 4, symmetric=symmetric)
    tq = tcore.quantize_acts(torch.from_numpy(x), 4, symmetric=symmetric)
    np.testing.assert_array_equal(tcore.dequantize_acts(tq).numpy(),
                                  np.asarray(jcore.dequantize_acts(jq)))
    jw = jcore.quantize_weights(jnp.asarray(w), 8)
    tw = tcore.quantize_weights(torch.from_numpy(w), 8)
    np.testing.assert_array_equal(tcore.dequantize_weights(tw).numpy(),
                                  np.asarray(jcore.dequantize_weights(jw)))


def test_register_variant_overwrite():
    """Without ``overwrite`` a taken name raises the reference's
    ValueError; with it, the variant is replaced."""
    original = tcore.get_variant("p8t")
    twin = dataclasses.replace(original, title="a replaced p8t")
    with pytest.raises(ValueError, match=r"already registered "
                       r"\(overwrite=True to replace\)"):
        tcore.register_variant(twin)
    with pytest.raises(ValueError) as ref_err:
        jcore.register_variant(jcore.get_variant("p8t"))
    try:
        tcore.register_variant(twin, overwrite=True)
        assert tcore.get_variant("p8t") is twin
        assert tcore.variant_names() == tuple(jcore.variant_names())
    finally:
        tcore.register_variant(original, overwrite=True)
    assert tcore.get_variant("p8t") is original
    with pytest.raises(ValueError) as port_err:
        tcore.register_variant(original)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("smoke", [False, True])
def test_resnet20_cifar_config_matches_reference(smoke):
    """``get_config("resnet20_cifar")`` gives the reference's ResNet-20
    records (CONFIG and SMOKE), field for field, nested policy included."""
    from repro.configs.base import get_config as jget
    from repro_torch.configs.base import get_config as tget
    from repro_torch.models.resnet import ResNetConfig

    want = jget("resnet20_cifar", smoke=smoke)
    got = tget("resnet20_cifar", smoke=smoke)
    assert isinstance(got, ResNetConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tget("resnet20-cifar", smoke=smoke) == got


def test_validate_cell_matches_reference(reference_dryrun):
    from repro.configs.base import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    for arch in ARCH_IDS:
        assert dryrun.validate_cell(arch) == {}
        for shape in SHAPES:
            assert dryrun.validate_cell(arch, shape) == \
                reference_dryrun.validate_cell(arch, shape)
    assert dryrun.validate_cell(None, "train_4k") == {}
    for args in (("bogus_arch", "train_4k"), ("qwen2_0_5b", "bogus_shape"),
                 ("resnet20_cifar", None)):
        with pytest.raises(ValueError) as want:
            reference_dryrun.validate_cell(*args)
        with pytest.raises(ValueError) as got:
            dryrun.validate_cell(*args)
        assert str(got.value) == str(want.value)
