"""repro_torch's checkpoint reader, weight conversion and import guards.

The reader is held to the JAX package's ``checkpoint.store.restore`` on
the committed ResNet checkpoint, tensor for tensor, bit for bit; its
msgpack decoder to the ``msgpack`` library. The guards check that the
port and ``chip_smoke.py`` never import ``jax`` or ``repro``, and that
``chip_smoke.py`` refuses to run without a CUDA device.
"""

import ast
import os
import pathlib
import subprocess
import sys
import zlib

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.checkpoint import store as tstore

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "results" / "resnet_baseline"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


def test_restore_matches_reference_bit_exact():
    cfg = jresnet.ResNetConfig(widths=(16, 32, 64), blocks_per_stage=2)
    p, b = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), cfg))
    want = dict(_leaves(jstore.restore(CKPT, {"params": p, "bn": b})))
    got = dict(_leaves(tstore.restore(CKPT, device="cpu")))
    assert tstore.latest_step(CKPT) == jstore.latest_step(CKPT) == 400
    assert sorted(got) == sorted(want) and len(got) == 77
    for name, t in got.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("obj", [
    {"step": 400, "compression": "zlib", "tensors": [
        {"name": "a/b", "dtype": "float32", "shape": [3, 4], "offset": 0,
         "nbytes": 48}]},
    [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32,
     2**63, -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
     -2**63, 1.5, -2.25e300, "", "x" * 31, "y" * 32, "z" * 300,
     "w" * 70000, b"", b"\x00" * 300, [], list(range(20)),
     list(range(70000)), {str(i): i for i in range(20)}],
])
def test_msgpack_decoder_matches_library(obj):
    packed = msgpack.packb(obj, use_bin_type=True)
    assert tstore.unpackb(packed) == msgpack.unpackb(packed)


def test_msgpack_decoder_rejects_ext_and_trailing_bytes():
    with pytest.raises(ValueError, match="unsupported"):
        tstore.unpackb(msgpack.packb(msgpack.ExtType(1, b"ab")))
    with pytest.raises(ValueError, match="trailing"):
        tstore.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        tstore.unpackb(msgpack.packb("abcdef")[:-1])


def _write_ckpt(d, compression, payload, nbytes):
    step = d / "step_00000007"
    step.mkdir(parents=True)
    (d / "LATEST").write_text("7")
    (step / "data.bin.zst").write_bytes(payload)
    (step / "manifest.msgpack").write_bytes(msgpack.packb({
        "step": 7, "compression": compression, "tensors": [
            {"name": "x/y", "dtype": "int8", "shape": [nbytes],
             "offset": 0, "nbytes": nbytes}]}))


def test_zlib_round_trip_and_zstd_refused(tmp_path):
    raw = np.arange(-5, 5, dtype=np.int8).tobytes()
    _write_ckpt(tmp_path / "z", "zlib", zlib.compress(raw), len(raw))
    got = tstore.restore(tmp_path / "z", device="cpu")
    np.testing.assert_array_equal(got["x"]["y"].numpy(),
                                  np.arange(-5, 5, dtype=np.int8))
    _write_ckpt(tmp_path / "s", "zstd", b"\x28\xb5\x2f\xfd", len(raw))
    with pytest.raises(ValueError, match="zstd"):
        tstore.restore(tmp_path / "s", device="cpu")
    with pytest.raises(FileNotFoundError):
        tstore.restore(tmp_path / "missing", device="cpu")


def test_convert_keeps_names_layouts_dtypes():
    cfg = jresnet.ResNetConfig(widths=(8, 16, 32), blocks_per_stage=1)
    shapes, bn_shapes = jax.eval_shape(
        lambda: jresnet.init(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    bn = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), bn_shapes)
    tp = convert.to_torch(params, device="cpu")
    want = dict(_leaves(params))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape  # HWIO, [K, N]
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]))
    assert convert.to_torch(bn, device="cpu")["bn_stem"]["var"].shape == (8,)


# ---------------------------------------------------------------------------
# Import guards
# ---------------------------------------------------------------------------


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_the_port_loads_no_jax_or_repro():
    mods = ["repro_torch." + m for m in (
        "configs.resnet", "core.engine", "kernels.dispatch", "kernels.ops",
        "models.resnet", "checkpoint.store", "convert")]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_cuda():
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "CUDA" in r.stderr
