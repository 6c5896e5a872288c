"""Weight-stationary plan/execute CIM API and the backend registry.

The paper's macro is weight-stationary: 8-bit weights are written into
the P-8T SRAM arrays once and reused for every input vector.

  plan_weights(w, cfg)        -> PlannedWeights   (once per weight)
  execute(x, plan, policy)    -> y                (per input batch)

``PlannedWeights`` holds everything the macro "stores": signed integer
weight codes, optional bit-sliced planes and spread slots, the
per-column code sums of the digital zero-point correction, and the
per-output-channel dequantization scales. ``execute`` performs only the
per-input work: activation quantization, the integer macro matmul and
the digital dequant.

Execution backends by string key:

  "fp"          plain floating-point matmul (framework baseline)
  "exact"       integer-exact quantized matmul (paper w/o ADC + noise)
  "behavioral"  the ADC behavioral model through ``kernels.dispatch``
  "cuda"        the same semantics through the hand-written GPQ kernel

``core.calibrate.CalibrationResult.register`` adds a backend that runs
each layer at its calibrated operating point and macro variant.

The mode names ('cim-exact', 'cim', 'cim-kernel') resolve to the same
backends, so a ``CIMPolicy.mode`` string is a valid backend key.

``plan_params`` lifts planning over whole parameter trees (used by
``serve.quantized`` and ``serve.engine.ServeEngine``), unifying the CIM
path and the digital int8 weight-only serving path behind one
representation. ``matmul`` is the one-shot plan-and-execute entry point
for weights that change every step (QAT): its forward is the planned
path, its backward the straight-through estimator when ``policy.ste``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

import torch

from repro_torch.core import matmul as matmul_lib
from repro_torch.core import quant
from repro_torch.core.params import CIMConfig


class CIMPolicyLike(Protocol):
    """Structural type for repro_torch.configs.base.CIMPolicy."""

    mode: str
    cim: CIMConfig
    act_symmetric: bool
    act_clip_pct: float
    ste: bool
    backend: str


# ---------------------------------------------------------------------------
# PlannedWeights
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlannedWeights:
    """Persistent stored-weight state of one (stack of) linear layer(s).

    Fields (all but ``codes``/``scale`` optional):
      codes:   [..., K, N] signed weight codes (int8 when weight_bits<=8).
      scale:   [..., 1, N] f32 per-output-channel dequant scale.
      colsum:  [..., 1, N] f32 per-column sum of codes (zero-point fix).
      w:       original full-precision weights, kept when the plan must
               also serve non-CIM (fp / digitally-exempt) matmuls.
      planes:  pre-grouped bit planes in the macro's row-group layout
               (zero-padded along K), either unpacked [G, B, rows, N]
               int8 0/1 planes or packed [G, rows, N] uint8 with 8
               planes per byte (bit b is plane b).
      slots:   [G, rows, S*N] f32 spread-slot planes
               (``quant.spread_slots``); grouping is baked in, so unlike
               ``planes`` this form cannot be regrouped.
      weight_bits: weight precision (structure: not a checkpoint leaf).
    """

    codes: Any
    scale: Any
    colsum: Any = None
    w: Any = None
    planes: Any = None
    slots: Any = None
    weight_bits: int = dataclasses.field(default=8,
                                         metadata={"static": True})

    @property
    def k(self) -> int:
        return self.codes.shape[-2]

    @property
    def n(self) -> int:
        return self.codes.shape[-1]

    @property
    def codes_i32(self) -> torch.Tensor:
        c = self.codes
        return c if c.dtype == torch.int32 else c.to(torch.int32)

    def dequantized(self, dtype=torch.float32) -> torch.Tensor:
        """w ~= scale * codes (the digital int8 serving read path)."""
        return self.codes.to(dtype) * self.scale.to(dtype)

    def best_weights(self, dtype=torch.float32) -> torch.Tensor:
        """Full-precision weights if kept, else the dequantized codes."""
        if self.w is not None:
            return self.w.to(dtype)
        return self.dequantized(dtype)

    def layer(self, i: int) -> "PlannedWeights":
        """The plan of layer ``i`` of a stacked [U, K, N] plan, or of
        expert ``i`` of an [E, K, N] bank (of a [U, E, K, N] one, take
        the unit first): a view of each field's slice ``i``, as the JAX
        package's ``lax.scan`` over stacked units slices the plan's
        pytree. Stacked plans carry no planes or slots (those are built
        for 2-D weights only)."""
        if self.planes is not None or self.slots is not None:
            raise ValueError("a plan with planes or slots is not stacked")
        return dataclasses.replace(
            self,
            codes=self.codes[i],
            scale=self.scale[i],
            colsum=None if self.colsum is None else self.colsum[i],
            w=None if self.w is None else self.w[i],
        )


# Above this reduction depth the behavioral planes are stored bit-packed
# (8 planes per byte).
PACK_PLANES_MIN_K = 4096


# Spread-slot operands are kept for layers of up to this many weights
# (the form costs 4 * n_slots bytes per weight).
SLOTS_MAX_ELEMS = 1 << 22


def _grouped_planes(
    codes: torch.Tensor, cfg: CIMConfig, packed: bool = False,
    rows: int | None = None,
) -> torch.Tensor:
    """[K, N] signed codes -> grouped bit planes.

    Group g holds rows g*rows..(g+1)*rows of every bit plane, zero-padded
    along K. packed=False: [G, B, rows, N] int8 0/1 planes. packed=True:
    [G, rows, N] uint8 whose bit b is plane b (the low ``weight_bits``
    two's-complement bits of the code). ``rows`` overrides the grouping
    row count (a layer's calibrated ``rows_active``).
    """
    k, n = codes.shape
    rows = rows or cfg.rows_active
    g = -(-k // rows)
    if packed:
        mask = (1 << cfg.weight_bits) - 1
        u = torch.bitwise_and(codes.to(torch.int32), mask).to(torch.uint8)
        u = torch.nn.functional.pad(u, (0, 0, 0, g * rows - k))
        return u.reshape(g, rows, n)
    b = cfg.weight_bits
    p = quant.bitslice_weights(codes, b, dtype=torch.int8)  # [B, K, N]
    p = torch.nn.functional.pad(p, (0, 0, 0, g * rows - k))
    return p.reshape(b, g, rows, n).permute(1, 0, 2, 3).contiguous()


def regroup_planes(
    planes: torch.Tensor, k: int, to_rows: int
) -> torch.Tensor:
    """Regroup planned bit planes to a different ``rows_active``.

    Ungroup along K, trim the old zero padding, re-pad and re-group at
    ``to_rows``; both storage forms.
    """
    g2 = -(-k // to_rows)
    if planes.ndim == 3:  # packed, 8 planes/byte
        g, rows, n = planes.shape
        flat = planes.reshape(g * rows, n)[:k]
        flat = torch.nn.functional.pad(flat, (0, 0, 0, g2 * to_rows - k))
        return flat.reshape(g2, to_rows, n)
    g, b, rows, n = planes.shape
    flat = planes.permute(1, 0, 2, 3).reshape(b, g * rows, n)[:, :k]
    flat = torch.nn.functional.pad(flat, (0, 0, 0, g2 * to_rows - k))
    return flat.reshape(b, g2, to_rows, n).permute(1, 0, 2, 3).contiguous()


def plan_weights(
    w: torch.Tensor,
    cfg: CIMConfig | None = None,
    policy: CIMPolicyLike | None = None,
    *,
    keep_fp: bool = True,
    with_planes: bool | None = None,
    group_rows: int | None = None,
) -> PlannedWeights:
    """Precompute the weight-stationary state for ``execute``.

    Args:
      w: [..., K, N] float weights (last axis = output channels).
      cfg: macro operating point; defaults to ``policy.cim`` or the
        paper operating point.
      policy: optional CIMPolicy; sets the default of ``with_planes``.
      keep_fp: retain the original float weights (False: the digital
        int8 serving form).
      with_planes: keep the grouped bit planes of a 2-D weight, bit-packed
        from K >= PACK_PLANES_MIN_K, and its spread-slot operand when the
        packing is feasible and the layer has at most SLOTS_MAX_ELEMS
        weights. Default: under the behavioral mode ("cim") only.
      group_rows: group the planes at this row count instead of
        ``cfg.rows_active`` (a layer's calibrated ``rows_active``).
    """
    if cfg is None:
        cfg = policy.cim if policy is not None else CIMConfig()
    mode = policy.mode if policy is not None else None
    if with_planes is None:
        with_planes = mode in ("cim", "behavioral")

    bits = cfg.weight_bits
    # Quantize in f32 regardless of the storage dtype of w.
    qw = quant.quantize_weights(w.to(torch.float32), bits)
    codes = qw.codes.to(cfg.codes_dtype)
    colsum = torch.sum(qw.codes, dim=-2, keepdim=True).to(torch.float32)
    planes = slots = None
    if with_planes:
        if qw.codes.ndim != 2:
            raise ValueError(
                "planes need a 2-D [K, N] weight; got shape "
                f"{tuple(qw.codes.shape)}"
            )
        k, n = qw.codes.shape
        rows = group_rows or cfg.rows_active
        packed = k >= PACK_PLANES_MIN_K and bits <= 8
        planes = _grouped_planes(qw.codes, cfg, packed=packed, rows=rows)
        if k * n <= SLOTS_MAX_ELEMS and quant.slot_spec(
            rows, cfg.act_bits, bits
        ) is not None:
            slots = quant.spread_slots(qw.codes, rows, cfg.act_bits, bits)
    return PlannedWeights(
        codes=codes,
        scale=qw.scale.to(torch.float32),
        colsum=colsum,
        w=w if keep_fp else None,
        planes=planes,
        slots=slots,
        weight_bits=bits,
    )


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

# fn(x2 [M, K] float, plan, policy, generator) -> y2 [M, N] float
BackendFn = Callable[..., torch.Tensor]

_BACKENDS: dict[str, BackendFn] = {}

# CIMPolicy.mode strings -> canonical backend keys.
_MODE_ALIASES = {
    "cim-exact": "exact",
    "cim": "behavioral",
    "cim-kernel": "cuda",
}


def register_backend(
    name: str, fn: BackendFn, *, overwrite: bool = False
) -> None:
    """Register an execution backend under a string key.

    ``overwrite=True`` replaces an existing registration (a calibration
    result re-registered under the same name).
    """
    if name in _MODE_ALIASES:
        raise ValueError(
            f"'{name}' is a reserved mode alias for "
            f"'{_MODE_ALIASES[name]}'; register under the canonical key"
        )
    if name in _BACKENDS and not overwrite:
        raise ValueError(
            f"backend '{name}' already registered (overwrite=True to "
            "replace)"
        )
    _BACKENDS[name] = fn


def get_backend(name: str) -> BackendFn:
    """Resolve a backend key (canonical name or mode alias)."""
    key = _MODE_ALIASES.get(name, name)
    try:
        return _BACKENDS[key]
    except KeyError:
        raise KeyError(
            f"unknown CIM backend '{name}'; registered: "
            f"{sorted(_BACKENDS)}"
        ) from None


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def quantized_backend(int_fn) -> BackendFn:
    """Wrap ``int_fn(x_codes, plan, cfg, generator) -> y_int`` with the
    shared quantized-execution epilogue (the digital periphery of the
    macro): dynamic activation quantization in, dequantization +
    zero-point column correction out."""

    def run(x2, plan, policy, generator):
        cfg = policy.cim
        qa = quant.quantize_acts(
            x2,
            cfg.act_bits,
            symmetric=policy.act_symmetric,
            clip_pct=policy.act_clip_pct,
        )
        y_int = int_fn(qa.codes, plan, cfg, generator)
        colsum = plan.colsum
        if colsum is None:  # minimal plans: recover digitally (free)
            colsum = torch.sum(
                plan.codes_i32, dim=-2, keepdim=True
            ).to(torch.float32)
        y = y_int - qa.zero_point.to(torch.float32) * colsum
        return y * qa.scale * plan.scale

    return run


def _fp_backend(x2, plan, policy, generator):
    del policy, generator
    return x2 @ plan.best_weights(x2.dtype)


def _exact_int(x_codes, plan, cfg, generator):
    del cfg, generator
    return matmul_lib.cim_matmul_exact_int(x_codes, plan.codes_i32)


def _behavioral_int(x_codes, plan, cfg, generator):
    # Route through the dispatch table: the backend resolves per shape
    # from the heuristics (noise -> scan; the kernel on a CUDA device
    # when the plan keeps no unpacked planes; else scan).
    from repro_torch.kernels import dispatch  # dispatch imports engine

    return dispatch.dispatch(
        x_codes, plan.codes, cfg, generator=generator, planes=plan.planes,
        slots=plan.slots,
    )


def _cuda_int(x_codes, plan, cfg, generator):
    # The kernels are noiseless: dispatch refuses a noise request to them
    # rather than drop the generator.
    from repro_torch.kernels import dispatch

    return dispatch.dispatch(
        x_codes, plan.codes, cfg, backend="cuda", generator=generator,
        planes=plan.planes
    )


# The built-in execution backends. Serving a calibration registers it
# under the policy's backend name, never over one of these.
BUILTIN_BACKENDS = frozenset({"fp", "exact", "behavioral", "cuda"})


def is_builtin_backend(name: str) -> bool:
    return name in BUILTIN_BACKENDS or name in _MODE_ALIASES


register_backend("fp", _fp_backend)
register_backend("exact", quantized_backend(_exact_int))
register_backend("behavioral", quantized_backend(_behavioral_int))
register_backend("cuda", quantized_backend(_cuda_int))


# ---------------------------------------------------------------------------
# execute
# ---------------------------------------------------------------------------


def execute(
    x: torch.Tensor,
    plan: PlannedWeights,
    policy: CIMPolicyLike,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Run one input batch against a precomputed weight plan.

    The backend is ``policy.backend`` when set, else derived from
    ``policy.mode`` through the registry aliases. Inputs of any rank are
    flattened to [M, K] and restored afterwards.
    """
    name = getattr(policy, "backend", "") or policy.mode
    fn = get_backend(name)
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    y = fn(x2, plan, policy, generator)
    y = y.reshape(*orig_shape[:-1], plan.n)
    if policy.mode != "fp":
        y = y.to(x.dtype)
    return y


def _plan_and_execute(x, w, policy, generator):
    return execute(x, plan_weights(w, policy=policy), policy,
                   generator=generator)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the JAX package's promoted dtype: a product of mixed
    dtypes runs in the wider one (torch refuses mixed operands), and a
    bfloat16 or float16 product sums in float32 and rounds once, as XLA
    runs it."""
    out = torch.promote_types(a.dtype, b.dtype)
    if out in (torch.bfloat16, torch.float16):
        return (a.float() @ b.float()).to(out)
    return a.to(out) @ b.to(out)


class _MatmulSTE(torch.autograd.Function):
    """Forward: plan ``w`` and execute ``x`` against it (the macro path;
    B1 under ``cim-kernel`` on the card). Backward: the straight-through
    estimator, the underlying linear map: dx = g @ w^T, dw = x^T @ g, as
    the JAX package's ``_matmul_ste_bwd`` computes them (plain products,
    no kernel)."""

    @staticmethod
    def forward(ctx, x, w, policy, generator):
        ctx.save_for_backward(x, w)
        return _plan_and_execute(x, w, policy, generator)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = _dot(g2, w.T).reshape(x.shape).to(x.dtype)
        dw = _dot(x2.T, g2).to(w.dtype)
        return dx, dw, None, None


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    policy: CIMPolicyLike | None,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One-shot plan+execute for weights that change every step (QAT).

    The forward runs the full planned path. Its gradient is the
    straight-through estimator when ``policy.ste`` (the default), else
    what autograd gives through plan and execute: the integer codes carry
    none, so only the dequantization scales do (the activation range's
    min and max, each column's largest |w|).
    """
    if policy is None or policy.mode == "fp":
        return _dot(x, w)
    if getattr(policy, "ste", True):
        return _MatmulSTE.apply(x, w, policy, generator)
    return _plan_and_execute(x, w, policy, generator)


# ---------------------------------------------------------------------------
# Whole-tree planning
# ---------------------------------------------------------------------------

# Leaves that are never weight-planned.
DEFAULT_EXEMPT_KEYS = frozenset(
    {"scale", "bias", "b", "table", "a_log", "d_skip", "conv_w",
     "conv_b", "mu_x", "decay_w0", "bonus_u", "pos_emb"}
)
# Modules kept high-precision by design: the MoE router and the
# shared-expert gate.
DEFAULT_EXEMPT_MODULES = frozenset({"router", "shared_gate"})
# Keys carrying matmul weight leaves ([K, N] linears, [E, K, N] banks,
# [U, K, N] stacked units).
DEFAULT_WEIGHT_KEYS = frozenset({"w", "gate", "up", "down"})
_PLAN_MIN_DIM = 2


def plan_params(
    params: Any,
    cfg: CIMConfig | None = None,
    policy: CIMPolicyLike | None = None,
    *,
    keep_fp: bool | None = None,
    with_planes: bool | None = None,
    calibration: Any | None = None,
) -> Any:
    """Rewrite every eligible weight leaf of a nested dict into a
    PlannedWeights; other leaves pass through.

    A leaf is eligible when its key is one of DEFAULT_WEIGHT_KEYS (and
    not of DEFAULT_EXEMPT_KEYS), it is a tensor of two or more dims, and
    no enclosing module is one of DEFAULT_EXEMPT_MODULES. Stacked leaves
    ([U, K, N]) are planned per slice of the leading dims, without planes.

    One transform serves both serving representations: digital int8
    weight-only (policy None or mode 'fp': the plans drop the float
    weights) and CIM execution (other modes: the plans keep them, so
    digitally-exempt matmuls stay exact). ``calibration`` (a
    ``core.calibrate.CalibrationResult``) groups each 2-D layer's planes
    at its calibrated ``rows_active``, looked up by [K, N] shape, and
    turns planes on.
    """
    if cfg is None:
        cfg = policy.cim if policy is not None else CIMConfig()
    mode = policy.mode if policy is not None else "fp"
    if keep_fp is None:
        keep_fp = mode != "fp"
    if with_planes is None:
        with_planes = mode in ("cim", "behavioral") or calibration is not None

    def rows_for(shape) -> int | None:
        if calibration is None or len(shape) != 2:
            return None
        lc = calibration.layer_for(shape[-2], shape[-1])
        return None if lc is None else lc.spec.rows_active

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = v if k in DEFAULT_EXEMPT_MODULES else walk(v)
            elif (k in DEFAULT_WEIGHT_KEYS and k not in DEFAULT_EXEMPT_KEYS
                  and isinstance(v, torch.Tensor)
                  and v.ndim >= _PLAN_MIN_DIM):
                out[k] = plan_weights(
                    v, cfg, policy, keep_fp=keep_fp,
                    with_planes=with_planes and v.ndim == 2,
                    group_rows=rows_for(v.shape),
                )
            else:
                out[k] = v
        return out

    return walk(params)


def planned_axes(
    axes: Any,
    *,
    keep_fp: bool = False,
    weight_keys: frozenset[str] = DEFAULT_WEIGHT_KEYS,
    exempt_modules: frozenset[str] = DEFAULT_EXEMPT_MODULES,
) -> Any:
    """Transform a logical-axes tree to match ``plan_params``' output.

    Codes (and kept fp weights) inherit the weight's axes; the [..., 1, N]
    epilogue vectors (scale, colsum) keep only the out-channel axis.
    Planes are None, as in the JAX package (the trees it shards plan
    without them).
    """

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = v if k in exempt_modules else walk(v)
            elif (k in weight_keys and isinstance(v, tuple)
                  and len(v) >= _PLAN_MIN_DIM):
                epi = v[:-2] + (None,) + v[-1:]
                out[k] = PlannedWeights(codes=v, scale=epi, colsum=epi,
                                        w=v if keep_fp else None,
                                        planes=None)
            else:
                out[k] = v
        return out

    return walk(axes)
