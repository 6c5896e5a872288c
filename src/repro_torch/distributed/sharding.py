"""Logical-axis sharding rules (MaxText-style, one source of truth).

Every parameter/cache/batch tensor carries a tuple of *logical* axis
names (assigned in the model specs); this module maps them onto mesh
axes with divisibility-aware fallback, as the JAX package does:

  vocab/heads/kv_heads/mlp -> 'model'   (tensor parallel)
  embed                    -> 'data'    (FSDP: weights sharded over DP)
  batch                    -> ('pod', 'data')
  cache_seq                -> ('pod', 'data')  (sequence-parallel KV for
                              batch=1 long-context decode; only applies
                              when 'batch' could not use those axes)
  experts/layers           -> unsharded

A mesh axis is consumed at most once per tensor; a logical axis whose
dim is not divisible by the mesh axis size degrades to replicated.

Meshes. The spec functions read only the mesh's axis names and sizes, so
they take any mesh that maps names to sizes: ``launch.mesh``'s abstract
production mesh (no devices), a duck-typed object whose ``.shape`` is a
dict, or a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and sizes). A spec is a :class:`PartitionSpec` (per
tensor dim: None, a mesh-axis name or a tuple of names) and a sharding a
:class:`NamedSharding` (a mesh and a spec), which yields the DTensor
placements of each mesh dim.

One device. This port serves on one card: :func:`shard_planned` places
tensors with ``torch.distributed.tensor.distribute_tensor`` on a
``DeviceMesh`` of world size 1, where each local shard is the whole
tensor, and raises ``NotImplementedError`` for a mesh of more devices
rather than run unsharded. :func:`constrain`, :func:`constrain_query`
(and MoE's expert-buffer constraint) are the identity without an active
mesh; under :func:`use_mesh` (the counterpart of ``with mesh:``), at
world size 1, each computes the JAX package's spec and returns the
tensor unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch import pytree
from repro_torch.core.engine import PlannedWeights

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "embed": ("data",),
    "experts": (),
    "layers": (),
    "batch": ("pod", "data"),
    "cache_seq": ("pod", "data"),
    "seq": (),
}

# Inference (prefill/decode) parameter rules: weights stay stationary (TP
# over 'model' only, replicated over 'data'); MoE expert banks are
# expert-parallel over 'data'.
INFERENCE_RULES: dict[str, tuple[str, ...]] = {
    **DEFAULT_RULES,
    "embed": (),
    "experts": ("data",),
}


class PartitionSpec(tuple):
    """One tensor's partition: per dim None (replicated), a mesh-axis
    name, or a tuple of names (the dim split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a mesh: a ``DeviceMesh``'s dim names and
    sizes, else the mapping its ``.shape`` is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape), strict=True))
    return dict(mesh.shape)


def mesh_size(mesh: Any) -> int:
    """The number of devices a mesh spans."""
    return math.prod(axis_sizes(mesh).values())


def check_one_device(mesh: Any, what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh of more than one device."""
    n = mesh_size(mesh)
    if n > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {n} devices: the port runs on one device "
            "(world size 1); a mesh of more devices is not supported, and "
            "it is not run unsharded in its place")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one tensor's :class:`PartitionSpec` on it."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """The DTensor placement of each mesh dim, in the mesh's order:
        ``Shard(d)`` where the spec splits tensor dim d over that axis,
        else ``Replicate()``. (A dim split over several axes shards in the
        mesh's order; at world size 1 every order is the same.)"""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for ax in axis_sizes(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def spec_for(
    axes: tuple[str | None, ...],
    shape: tuple[int, ...],
    mesh: Any,
    rules: Mapping[str, tuple[str, ...]] | None = None,
) -> PartitionSpec:
    """PartitionSpec for one tensor, divisibility-aware, no axis reuse."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, ax in zip(shape, axes, strict=False):
        if ax is None or ax not in rules:
            entries.append(None)
            continue
        entries.append(_entry(_greedy_axes(dim, rules[ax], sizes, used)))
    return PartitionSpec(*entries)


def sharding_for(
    axes: tuple[str | None, ...],
    shape: tuple[int, ...],
    mesh: Any | None,
    rules: Mapping[str, tuple[str, ...]] | None = None,
) -> NamedSharding | None:
    if mesh is None:  # probe/unsharded path
        return None
    return NamedSharding(mesh, spec_for(axes, shape, mesh, rules))


# ---------------------------------------------------------------------------
# Trees (``repro_torch.pytree``): dicts, NamedTuples, dataclasses, None
# ---------------------------------------------------------------------------


def _is_axes(x) -> bool:
    return type(x) is tuple and all(a is None or isinstance(a, str)
                                    for a in x)


def is_sharding(x) -> bool:
    """Whether ``x`` is a leaf of a sharding tree (``is_leaf=`` of
    ``pytree``'s walkers)."""
    return isinstance(x, NamedSharding)


def _map_named(fn, tree):
    """``fn(name, leaf)``, ``name`` the leaf's last path part."""
    return pytree.map_with_names(
        lambda path, leaf: fn(path.rsplit(pytree.SEP, 1)[-1], leaf), tree)


def tree_shardings(
    axes_tree: Any,
    shape_tree: Any,
    mesh: Any | None,
    rules: Mapping[str, tuple[str, ...]] | None = None,
) -> Any:
    """Map matching (axes, tensor) trees -> NamedSharding tree."""
    if mesh is None:
        return None
    return pytree.tree_map(
        lambda ax, t: sharding_for(ax, tuple(t.shape), mesh, rules),
        axes_tree, shape_tree, is_leaf=_is_axes)


# ---------------------------------------------------------------------------
# Name-based axes for caches and batches (leaf-name conventions)
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", None),
    "v": ("batch", "cache_seq", "kv_heads", None),
    "conv": ("batch", None, "mlp"),
    "ssm": ("batch", "mlp", None),
    "state": ("batch", "heads", None, None),
    "shift_tm": ("batch", None),
    "shift_cm": ("batch", None),
}

_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frontend_embeds": ("batch", None, None),
    "encoder_frames": ("batch", None, None),
    "image": ("batch", None, None, None),
    "label": ("batch",),
}


def cache_axes(cache_tree: Any) -> Any:
    """Logical axes for a cache tree by leaf-name convention.

    Caches stacked under the 'units' group gain a leading 'layers' axis
    (detected by ndim excess).
    """

    def one(name, leaf):
        base = _CACHE_AXES.get(name)
        if base is None:
            raise KeyError(f"unknown cache leaf '{name}'")
        if len(leaf.shape) == len(base) + 1:
            return ("layers",) + base
        if len(leaf.shape) != len(base):
            raise ValueError(f"cache leaf '{name}' of shape "
                             f"{tuple(leaf.shape)}: want {len(base)} dims")
        return base

    return _map_named(one, cache_tree)


def batch_axes(batch: Any) -> Any:
    def one(name, leaf):
        base = _BATCH_AXES.get(name)
        if base is None:
            base = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return base

    return _map_named(one, batch)


def _greedy_axes(dim: int, candidates: tuple[str, ...],
                 sizes: Mapping[str, int], used: set[str]) -> list[str]:
    got: list[str] = []
    factor = 1
    for ax in candidates:
        if ax in used or ax not in sizes:
            continue
        if dim % (factor * sizes[ax]) == 0:
            got.append(ax)
            used.add(ax)
            factor *= sizes[ax]
    return got


def _entry(axs: list[str]):
    if not axs:
        return None
    return axs[0] if len(axs) == 1 else tuple(axs)


def kv_cache_spec(shape: tuple[int, ...], mesh: Any) -> PartitionSpec:
    """KV cache [(layers,) B, S, KVH, hd] with cross-dim fallback.

    Priority: batch <- (pod, data); kv_heads <- model; seq <- whatever
    mesh axes remain (the fallback for archs whose kv-head count does not
    divide the model axis: qwen1.5's 20, yi-34b's 8).
    """
    sizes = axis_sizes(mesh)
    lead = len(shape) - 4
    b, s, kvh, _ = shape[lead:]
    used: set[str] = set()
    b_ax = _greedy_axes(b, ("pod", "data"), sizes, used)
    h_ax = _greedy_axes(kvh, ("model",), sizes, used)
    s_ax = _greedy_axes(s, ("model", "pod", "data"), sizes, used)
    return PartitionSpec(
        *((None,) * lead), _entry(b_ax), _entry(s_ax), _entry(h_ax), None
    )


def cache_shardings(cache_tree: Any, mesh: Any | None) -> Any:
    """NamedShardings for a serving-cache tree: k/v leaves get the
    cross-dim-fallback spec above; SSM/RWKV state leaves the generic rule
    table."""
    if mesh is None:
        return None

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            return NamedSharding(mesh, kv_cache_spec(shape, mesh))
        base = _CACHE_AXES[name]
        if len(shape) == len(base) + 1:
            base = ("layers",) + base
        return sharding_for(base, shape, mesh)

    return _map_named(one, cache_tree)


# ---------------------------------------------------------------------------
# Planned-weight (PlannedWeights) sharding: plan-aware serving
# ---------------------------------------------------------------------------


def _last_dim_model(shape: tuple[int, ...], mesh: Any) -> NamedSharding:
    """Shard the trailing (output-channel) dim over 'model' if divisible."""
    axs = _greedy_axes(shape[-1], ("model",), axis_sizes(mesh), set())
    return NamedSharding(
        mesh, PartitionSpec(*((None,) * (len(shape) - 1)), _entry(axs))
    )


def plan_shardings(plan: PlannedWeights, mesh: Any) -> PlannedWeights:
    """NamedShardings for one ``engine.PlannedWeights``.

    Every stored-weight tensor is tensor-parallel over the model axis on
    its output-channel (N) dim: codes [..., K, N], kept fp weights, the
    [..., 1, N] epilogue vectors and the pre-grouped ``planes`` in both
    storage forms (the group/plane/row dims are the contraction structure
    and stay local to a shard). Spread ``slots``, which the JAX package's
    rule leaves out (the stacked plans it shards carry none), replicate.
    """

    def one(v):
        return None if v is None else _last_dim_model(tuple(v.shape), mesh)

    return dataclasses.replace(
        plan,
        codes=one(plan.codes),
        scale=one(plan.scale),
        colsum=one(plan.colsum),
        w=one(plan.w),
        planes=one(plan.planes),
        slots=None if plan.slots is None else replicated(mesh),
    )


def _is_plan(x) -> bool:
    return isinstance(x, PlannedWeights)


def planned_param_shardings(planned_tree: Any, mesh: Any | None) -> Any:
    """Shardings for a whole ``engine.plan_params`` tree: PlannedWeights
    leaves get :func:`plan_shardings`; unplanned leaves (norms,
    embeddings, biases) replicate (weight-stationary inference)."""
    if mesh is None:
        return None

    def one(node):
        if isinstance(node, PlannedWeights):
            return plan_shardings(node, mesh)
        return replicated(mesh)

    return pytree.tree_map(one, planned_tree, is_leaf=_is_plan)


def shard_planned(planned_tree: Any, mesh: Any | None) -> Any:
    """Place a planned tree under :func:`planned_param_shardings`: every
    tensor becomes a ``DTensor`` on ``mesh`` (a ``DeviceMesh``) through
    ``distribute_tensor`` with its sharding's placements. At world size 1
    each local shard (``local_shards``) is the whole tensor; a mesh of
    more devices raises ``NotImplementedError``."""
    if mesh is None:
        return planned_tree
    check_one_device(mesh, "shard_planned")
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError("shard_planned places tensors on a torch DeviceMesh "
                        "(launch.mesh.make_host_mesh); got "
                        f"{type(mesh).__name__}")
    from torch.distributed.tensor import distribute_tensor

    shardings = planned_param_shardings(planned_tree, mesh)
    return pytree.tree_map(
        lambda t, sh: distribute_tensor(t, mesh, sh.placements()),
        planned_tree, shardings)


def local_shards(tree: Any) -> Any:
    """Each ``DTensor`` of a tree as its local shard (what the engine
    computes on: the ctypes kernels read plain tensors' pointers)."""
    from torch.distributed.tensor import DTensor

    return pytree.tree_map(
        lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def opt_state_axes(param_axes: Any, opt_state) -> Any:
    """AdamW m/v inherit the param axes; the step count is replicated."""
    from repro_torch.optim.adamw import AdamWState

    del opt_state
    return AdamWState(step=(), m=param_axes,
                      v=pytree.tree_map(lambda a: a, param_axes,
                                          is_leaf=_is_axes))


def replicated(mesh: Any | None) -> NamedSharding | None:
    if mesh is None:
        return None
    return NamedSharding(mesh, PartitionSpec())


# ---------------------------------------------------------------------------
# Activation sharding constraints (annotations inside model code)
# ---------------------------------------------------------------------------

_ACT_RULES: dict[str, tuple[str, ...]] = {
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_vocab": ("model",),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_embed": (),
}

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Make ``mesh`` the active mesh of the model code's constraints
    inside the block (the JAX package's ``with mesh:``). World size 1
    only: a mesh of more devices raises ``NotImplementedError``."""
    check_one_device(mesh, "use_mesh")
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def _ctx_mesh():
    return _ACTIVE_MESH.get()


def activation_spec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                    mesh: Any) -> PartitionSpec:
    """The spec :func:`constrain` puts on an activation of ``shape``:
    each logical activation axis takes its mesh axes while they divide
    the dim."""
    sizes = axis_sizes(mesh)
    entries = []
    for dim, ax in zip(shape, axes, strict=False):
        names = []
        factor = 1
        if ax is not None:
            for mesh_ax in _ACT_RULES.get(ax, ()):
                if mesh_ax not in sizes:
                    continue
                if dim % (factor * sizes[mesh_ax]) == 0:
                    names.append(mesh_ax)
                    factor *= sizes[mesh_ax]
        entries.append(_entry(names))
    return PartitionSpec(*entries)


def constrain(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """A sharding constraint by logical activation axes: the identity
    without an active mesh; under one (world size 1) its spec is
    computed and ``x`` returned unchanged. Model code calls this at the
    propagation cliffs (logits, embed output)."""
    mesh = _ctx_mesh()
    if mesh is None:
        return x
    activation_spec(tuple(x.shape), axes, mesh)
    return x


def query_spec(shape: tuple[int, ...], mesh: Any) -> PartitionSpec:
    """The spec of a query [B, S, H, hd]: batch over (pod, data); heads on
    'model' when they divide it, else the query sequence (context
    parallel; qwen2-0.5b's 14 heads on a 16-wide axis)."""
    sizes = axis_sizes(mesh)
    b, s, h, _ = shape
    b_ax = []
    factor = 1
    for ax in ("pod", "data"):
        if ax in sizes and b % (factor * sizes[ax]) == 0:
            b_ax.append(ax)
            factor *= sizes[ax]
    model = sizes.get("model", 1)
    spec = [_entry(b_ax), None, None, None]
    if model > 1:
        if h % model == 0:
            spec[2] = "model"
        elif s % model == 0:
            spec[1] = "model"
    return PartitionSpec(*spec)


def constrain_query(q: torch.Tensor) -> torch.Tensor:
    """Shard the query [B, S, H, hd] for the attention core
    (:func:`query_spec`): the identity without an active mesh; under one
    (world size 1) the spec is computed and ``q`` returned unchanged."""
    mesh = _ctx_mesh()
    if mesh is None:
        return q
    query_spec(tuple(q.shape), mesh)
    return q


def expert_buffer_spec(shape: tuple[int, ...], mesh: Any) -> PartitionSpec:
    """The spec of MoE's [G, E, C, d] dispatch buffer: routing groups over
    the data axes when G divides, else expert-parallel over them."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    g_ax = _greedy_axes(shape[0], ("pod", "data"), sizes, used)
    e_ax = _greedy_axes(shape[1], ("pod", "data"), sizes, used)
    return PartitionSpec(_entry(g_ax), _entry(e_ax), None, None)
