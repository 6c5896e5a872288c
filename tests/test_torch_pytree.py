"""repro_torch.pytree, the port's one tree walker, against JAX's flattening.

The checkpoint store names tensors by the walker's leaf paths and the
sharding rules walk parameter, plan, cache and sharding trees with it,
so its order and names must be those of ``jax.tree_util`` as the JAX
package's checkpoint store turns them into names
(``repro.checkpoint.store._leaf_names``): dict keys sorted, NamedTuple
and dataclass fields in order, ``None`` and static dataclass fields as
structure.
"""

import typing

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import get_config as jget
from repro.core import engine as jengine
from repro.models import transformer as jt
from repro_torch import convert, pytree
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as tengine
from repro_torch.models import transformer as tt


class Pair(typing.NamedTuple):
    x: typing.Any
    y: typing.Any


def _nested(leaf=lambda a: a):
    rng = np.random.default_rng(0)
    a = [leaf(rng.standard_normal((2, 3)).astype(np.float32))
         for _ in range(5)]
    return {"b": {"z": a[0], "a": a[1]}, "a": [a[2], (a[3], None)],
            "c": Pair(x=a[4], y=None)}


def _planned():
    rng = np.random.default_rng(1)
    tree = {"blk": {"w": rng.standard_normal((32, 16)).astype(np.float32),
                    "bias": np.ones(16, np.float32)},
            "emb": rng.standard_normal((8, 4)).astype(np.float32)}
    return (jengine.plan_params(jax.tree.map(jax.numpy.asarray, tree),
                                policy=None),
            tengine.plan_params(convert.to_torch(tree, device="cpu"),
                                policy=None))


def _caches(arch):
    return (jt.init_caches(jget(arch, smoke=True), 2, 8),
            tt.init_caches(tget(arch, smoke=True), 2, 8, device="cpu"))


TREES = {
    "nested": lambda: (_nested(), _nested(torch.from_numpy)),
    "planned": _planned,
    "kv_caches": lambda: _caches("qwen2_0_5b"),
    "hybrid_caches": lambda: _caches("jamba_1_5_large"),
}


@pytest.mark.parametrize("which", list(TREES))
def test_leaf_names_and_order_match_jax(which):
    ref, port = TREES[which]()
    names = [n for n, _ in pytree.leaves_with_names(port)]
    assert names == jstore._leaf_names(ref)
    want = [tuple(np.shape(x)) for x in jax.tree.leaves(ref)]
    assert [tuple(t.shape) for t in pytree.leaves(port)] == want


def test_map_keeps_structure_and_walks_matching_trees():
    """Containers keep their types and dict order, None stays None,
    ``rest`` trees are read at each leaf's path, ``is_leaf`` stops the
    walk, and a dataclass keeps its static fields."""
    _, port = TREES["nested"]()
    doubled = pytree.tree_map(lambda t: 2 * t, port)
    assert list(doubled) == ["b", "a", "c"]
    assert list(doubled["b"]) == ["z", "a"]
    assert isinstance(doubled["c"], Pair) and doubled["c"].y is None
    assert isinstance(doubled["a"], list)
    assert isinstance(doubled["a"][1], tuple) and doubled["a"][1][1] is None
    summed = pytree.tree_map(lambda x, y: x + y, port, doubled)
    for x, s in zip(pytree.leaves(port), pytree.leaves(summed), strict=True):
        assert torch.equal(s, 3 * x)
    named = pytree.map_with_names(lambda n, t: n, port)
    assert named["b"]["z"] == "b/z" and named["a"][1][0] == "a/1/0"
    axes = {"w": ("embed", "mlp"), "n": (None,)}
    assert pytree.tree_map(
        lambda ax: ax[::-1], axes,
        is_leaf=lambda x: isinstance(x, tuple)) == {"w": ("mlp", "embed"),
                                                    "n": (None,)}
    _, planned = _planned()
    kept = pytree.tree_map(torch.clone, planned)
    assert kept["blk"]["w"].weight_bits == planned["blk"]["w"].weight_bits
    assert torch.equal(kept["blk"]["w"].codes, planned["blk"]["w"].codes)
    assert pytree.leaves(None) == [] and pytree.tree_map(str, None) is None
