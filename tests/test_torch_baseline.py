"""repro_torch.configs.resnet.train_resnet_baseline against the JAX
package's benchmarks/common.py::train_resnet_baseline, on the CPU.

Both start from the reference's ``resnet.init(PRNGKey(0), RESNET_CFG)``
(the port's ``resnet.init`` is monkeypatched to return it through
``convert``) and take 3 AdamW steps at batch 8 over the same
``SyntheticCIFAR`` batches.

Tolerances and why:
  * each step's loss within rtol 1e-5: the reference's step is one jitted
    XLA program (fused, FMA'd, its convolution sums in another order) and
    the port's is eager PyTorch, so the forward parts in the last float32
    bits;
  * parameters and BatchNorm state after 3 steps, per leaf, within 1e-4
    of the leaf's norm: AdamW divides each gradient by its own running
    root mean square, so a last-bit difference in a gradient near zero
    becomes a visible fraction of that element's step (the step is
    lr * warm-up = 3e-4 at most here);
  * a checkpoint the port writes restores in the reference's
    ``store.restore`` bit for bit.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.configs import resnet as tcfg
from repro_torch.models import resnet as tresnet

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS, BATCH = 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common
    finally:
        sys.path.remove(str(ROOT))
    return common


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _port_init(monkeypatch, common, losses):
    """The port's init returns the reference's weights; its loss_fn
    records each step's loss."""
    jparams, jbn = jresnet.init(jax.random.PRNGKey(0), common.RESNET_CFG)
    monkeypatch.setattr(tresnet, "init", lambda seed, cfg, *, device: (
        convert.to_torch(jparams, device=device),
        convert.to_torch(jbn, device=device)))
    loss_fn = tresnet.loss_fn

    def recording(*a, **k):
        out = loss_fn(*a, **k)
        losses.append(out[0].item())
        return out

    monkeypatch.setattr(tresnet, "loss_fn", recording)


@pytest.fixture(scope="module")
def reference():
    """The reference's losses per step and its trained (params, bn)."""
    common = _common()
    losses = []

    def loss_fn(*a, **k):
        out = jresnet.loss_fn(*a, **k)
        jax.debug.callback(lambda v: losses.append(float(v)), out[0])
        return out

    orig = common.resnet
    common.resnet = type("resnet", (), {"init": staticmethod(jresnet.init),
                                        "loss_fn": staticmethod(loss_fn)})
    try:
        params, bn, _ = common.train_resnet_baseline(
            steps=STEPS, batch=BATCH, cache=False)
        jax.effects_barrier()
    finally:
        common.resnet = orig
    return dict(common=common, losses=losses, params=_numpy(params),
                bn=_numpy(bn))


def test_steps_match_the_reference(reference, monkeypatch, tmp_path):
    losses = []
    _port_init(monkeypatch, reference["common"], losses)
    monkeypatch.setattr(tcfg, "BUILD_DIR", tmp_path / "build")
    params, bn = tcfg.train_resnet_baseline(steps=STEPS, batch=BATCH,
                                            cache=False, device="cpu")
    assert len(reference["losses"]) == len(losses) == STEPS
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-5)
    assert not (tmp_path / "build").exists()  # cache=False writes nothing
    for got, want in ((params, reference["params"]), (bn, reference["bn"])):
        g, w = dict(_leaves(_numpy(got))), dict(_leaves(want))
        assert g.keys() == w.keys()
        for name in w:
            scale = max(float(np.linalg.norm(w[name])), 1e-12)
            rel = float(np.linalg.norm(g[name] - w[name])) / scale
            assert rel <= 1e-4, (name, rel)


def test_trained_checkpoint_saved_under_build_and_read_by_reference(
        reference, monkeypatch, tmp_path):
    """No committed checkpoint: train, save under BUILD_DIR at step
    ``steps`` as {"params", "bn"}; the reference restores it bit for bit;
    the next call loads it and trains nothing."""
    losses = []
    _port_init(monkeypatch, reference["common"], losses)
    build = tmp_path / "build"
    monkeypatch.setattr(tcfg, "CHECKPOINT_DIR", tmp_path / "none")
    monkeypatch.setattr(tcfg, "BUILD_DIR", build)
    params, bn = tcfg.train_resnet_baseline(steps=STEPS, batch=BATCH,
                                            device="cpu")
    assert len(losses) == STEPS
    assert jstore.latest_step(build) == STEPS
    common = reference["common"]
    target = jax.eval_shape(
        lambda: jresnet.init(jax.random.PRNGKey(0), common.RESNET_CFG))
    jtree = jstore.restore(build, {"params": target[0], "bn": target[1]})
    for got, want in ((params, jtree["params"]), (bn, jtree["bn"])):
        g, w = dict(_leaves(_numpy(got))), dict(_leaves(_numpy(want)))
        assert g.keys() == w.keys()
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)

    again = tcfg.train_resnet_baseline(steps=STEPS, batch=BATCH,
                                       device="cpu")
    assert len(losses) == STEPS  # loaded, not trained
    for got, want in zip(again, (params, bn)):
        for (n1, a), (n2, b) in zip(_leaves(_numpy(got)),
                                    _leaves(_numpy(want))):
            assert n1 == n2
            np.testing.assert_array_equal(a, b, err_msg=n1)


def test_committed_checkpoint_wins(monkeypatch, tmp_path):
    """With the committed checkpoint present, cache=True loads it and
    neither trains nor writes."""
    monkeypatch.setattr(tcfg, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tresnet, "loss_fn", None)  # training would fail
    params, bn = tcfg.train_resnet_baseline(device="cpu")
    want_p, want_bn = tcfg.load_baseline(device="cpu")
    for got, want in ((params, want_p), (bn, want_bn)):
        for (n1, a), (n2, b) in zip(_leaves(_numpy(got)),
                                    _leaves(_numpy(want))):
            assert n1 == n2
            np.testing.assert_array_equal(a, b, err_msg=n1)
    assert not (tmp_path / "build").exists()
