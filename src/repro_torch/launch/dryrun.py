"""Launch cells on one card: the reference's dry run, on meta tensors.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The JAX package's ``repro.launch.dryrun`` lowers and compiles every
(arch x shape x mesh) cell for a TPU pod of 256 or 512 chips. The port
builds the same cells on ``meta`` tensors, which carry shapes and dtypes
and allocate nothing (yi-34b and gemma3-27b at ``train_4k`` need no
device memory), against the abstract production mesh of
``launch.mesh``. Per cell ``run_cell`` records:

  * success (the deliverable): the step, its argument specs and its
    shardings build, and the step runs on meta tensors;
  * per-device argument and output bytes under the production mesh's
    specs (``distributed.sharding``), from the shapes: a tensor's bytes
    over the product of the mesh axes its spec splits it across;
  * FLOPs of the step's meta run, counted by
    ``torch.utils.flop_counter.FlopCounterMode``;
  * with the probe, the FLOPs of unrolled 1-unit and 2-unit variants,
    extrapolated to the full depth as the reference's probe does.

A compiler's temp and alias bytes and its collective inventory have no
counterpart here; ``run_cell`` records them as null. Records go to
``build/dryrun.json`` by default (the reference's ``results/dryrun.json``
is its own).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import pytree
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    shape_cells,
)
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO_ROOT / "build" / "dryrun.json"


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, never allocated)
# ---------------------------------------------------------------------------


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((b, s), I32),
        "labels": sds((b, s), I32),
    }
    if cfg.frontend == "vision_patches":
        # Patch tokens are part of the assigned seq budget.
        batch["tokens"] = sds((b, s - cfg.frontend_seq), I32)
        batch["labels"] = sds((b, s - cfg.frontend_seq), I32)
        batch["frontend_embeds"] = sds((b, cfg.frontend_seq, cfg.d_model),
                                       F32)
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = sds((b, cfg.frontend_seq, cfg.d_model),
                                      F32)
    return batch


def params_specs(cfg: ModelConfig) -> dict:
    return transformer.abstract_params(cfg)


def state_specs(cfg: ModelConfig) -> trainer_lib.TrainState:
    p = params_specs(cfg)
    opt_dtype = getattr(torch, cfg.opt_state_dtype)
    return trainer_lib.TrainState(
        params=p,
        opt=adamw.AdamWState(
            step=sds((), I32),
            m=adamw.tree_map(lambda t: sds(t.shape, opt_dtype), p),
            v=adamw.tree_map(lambda t: sds(t.shape, opt_dtype), p)),
        comp=None,
        rng=sds((2,), torch.uint32),
    )


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return transformer.init_caches(cfg, batch, max_len, dtype=BF16,
                                   device="meta")


# ---------------------------------------------------------------------------
# Step builders: (fn, args, in_shardings, out_shardings, kw)
# ---------------------------------------------------------------------------
# ``kw`` holds the reference's donated arguments, as information only:
# PyTorch has no buffer donation (the port's caches are written in place).


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh):
    opt_cfg = adamw.OptimizerConfig()

    def loss(params, batch, generator):
        return transformer.loss_fn(params, batch, cfg, generator=generator)

    step = trainer_lib.make_train_step(
        loss, opt_cfg,
        microbatches=cfg.microbatches,
        accum_dtype=getattr(torch, cfg.grad_accum_dtype),
    )

    st = state_specs(cfg)
    bt = batch_specs(cfg, shape)
    ax = transformer.model_axes(cfg)
    p_sh = shd.tree_shardings(ax, st.params, mesh)
    opt_sh = adamw.AdamWState(
        step=shd.replicated(mesh),
        m=shd.tree_shardings(ax, st.opt.m, mesh),
        v=shd.tree_shardings(ax, st.opt.v, mesh),
    )
    st_sh = trainer_lib.TrainState(
        params=p_sh, opt=opt_sh, comp=None, rng=shd.replicated(mesh)
    )
    b_sh = shd.tree_shardings(shd.batch_axes(bt), bt, mesh)
    in_sh = (st_sh, b_sh)
    # metrics replicated; out state shardings mirror input.
    out_sh = (st_sh, None)
    return step, (st, bt), in_sh, out_sh, {"donate_argnums": (0,)}


def _serving_params(cfg: ModelConfig, serve_quant: bool):
    ps = params_specs(cfg)
    ax = transformer.model_axes(cfg)
    if serve_quant:  # int8 weight-only serving
        from repro_torch.serve import quantized as sq

        ps = sq.quantize_params_for_serving(ps)
        ax = sq.quantize_axes_for_serving(ax)
    return ps, ax


def _memory_spec(cfg: ModelConfig, b: int):
    if not cfg.is_encoder_decoder:
        return None
    return sds((b, cfg.frontend_seq, cfg.d_model), BF16)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       serve_quant: bool = False):
    b, s = shape.global_batch, shape.seq_len
    memory_spec = _memory_spec(cfg, b)

    @torch.no_grad()
    def fn(params, tokens, caches, memory=None):
        return transformer.prefill(params, tokens, caches, cfg,
                                   memory=memory)

    ps, ax = _serving_params(cfg, serve_quant)
    cs = cache_specs(cfg, b, s)
    tok = sds((b, s), I32)
    p_sh = shd.tree_shardings(ax, ps, mesh, shd.INFERENCE_RULES)
    c_sh = shd.cache_shardings(cs, mesh)
    t_sh = shd.sharding_for(("batch", "seq"), (b, s), mesh)
    args = (ps, tok, cs) + ((memory_spec,) if memory_spec is not None
                            else ())
    in_sh = (p_sh, t_sh, c_sh) + (
        (shd.sharding_for(("batch", None, None), memory_spec.shape, mesh),)
        if memory_spec is not None else ()
    )
    out_sh = (
        shd.sharding_for(("batch", "vocab"), (b, cfg.padded_vocab), mesh),
        c_sh,
    )
    return fn, args, in_sh, out_sh, {"donate_argnums": (2,)}


def _position(pos: torch.Tensor) -> int:
    """A decode position as ``transformer.decode_step`` takes it (a Python
    int). A meta position holds no value and reads as 0: no shape depends
    on it."""
    return 0 if pos.is_meta else int(pos)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      serve_quant: bool = False):
    b, s = shape.global_batch, shape.seq_len
    memory_spec = _memory_spec(cfg, b)

    @torch.no_grad()
    def fn(params, token, pos, caches, memory=None):
        return transformer.decode_step(params, token, _position(pos),
                                       caches, cfg, memory=memory)

    ps, ax = _serving_params(cfg, serve_quant)
    cs = cache_specs(cfg, b, s)
    p_sh = shd.tree_shardings(ax, ps, mesh, shd.INFERENCE_RULES)
    c_sh = shd.cache_shardings(cs, mesh)
    tok = sds((b,), I32)
    pos = sds((), I32)
    args = (ps, tok, pos, cs) + ((memory_spec,) if memory_spec is not None
                                 else ())
    in_sh = (
        p_sh,
        shd.sharding_for(("batch",), (b,), mesh),
        shd.replicated(mesh),
        c_sh,
    ) + (
        (shd.sharding_for(("batch", None, None), memory_spec.shape, mesh),)
        if memory_spec is not None else ()
    )
    out_sh = (
        shd.sharding_for(("batch", "vocab"), (b, cfg.padded_vocab), mesh),
        c_sh,
    )
    return fn, args, in_sh, out_sh, {"donate_argnums": (3,)}


_BUILDERS = {
    "train": build_train_step,
    "prefill": build_prefill_step,
    "decode": build_decode_step,
}


# ---------------------------------------------------------------------------
# Bytes and FLOPs
# ---------------------------------------------------------------------------


def per_device_bytes(tree, shardings) -> int:
    """Bytes of ``tree``'s tensors on one device under ``shardings`` (the
    matching tree of NamedShardings): each tensor's bytes over the product
    of the mesh axes its spec splits it across. Where ``shardings`` is
    None the subtree is replicated."""
    if shardings is None:
        return sum(t.numel() * t.element_size() for t in pytree.leaves(tree))
    if isinstance(shardings, shd.NamedSharding):
        sizes = shd.axis_sizes(shardings.mesh)
        split = math.prod(
            sizes[ax] for e in shardings.spec if e is not None
            for ax in (e if isinstance(e, tuple) else (e,)))
        return tree.numel() * tree.element_size() // split
    return sum(per_device_bytes(c, pytree.child(shardings, k))
               for k, c in pytree.children(tree))


def step_flops(fn, args) -> tuple[float, object]:
    """(FLOPs, outputs) of one call of ``fn(*args)`` under
    ``FlopCounterMode``. It counts the matmul-like ops (mm, bmm, addmm,
    baddbmm, convolutions, scaled-dot-product attention) at 2 per
    multiply-add, forward and backward; XLA's cost analysis, which the
    reference's numbers come from, also counts elementwise work
    (normalisation, activations, softmax, rotary embedding, the
    optimizer's update) and reductions. A GPQ kernel's call on meta is
    counted by neither (a Pallas call has no cost estimate)."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return float(fc.get_total_flops()), out


def _probe_variant(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    # microbatches=1: the probe's reduced batch need not divide the
    # production microbatch count (flops are linear in batch anyway).
    return cfg.replace(n_layers=n_layers, scan_layers=False, remat="none",
                       microbatches=1)


def _single_chunk(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """A mamba config whose chunked scan runs one chunk of the sequence
    (128 steps at decode), as the reference's probe builds it."""
    if cfg.mamba is None:
        return cfg
    return cfg.replace(mamba=dataclasses.replace(
        cfg.mamba, scan_impl="chunked",
        chunk_size=shape.seq_len if shape.kind != "decode" else 128))


def flops_probe(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> dict:
    """Per-unit FLOPs from unrolled 1-unit / 2-unit steps on meta.

    Uses a reduced global batch (FLOPs scale linearly; rescaled after),
    as the reference's probe does: per_unit = f(2u) - f(1u), total =
    f(1u) + (n_units_effective - 1) * per_unit. The counts are
    ``step_flops``'s (matmul-like ops only), where the reference's are
    XLA's.
    """
    p = cfg.pattern_len
    probe_batch = max(1, min(shape.global_batch, 4))
    scale = shape.global_batch / probe_batch
    pshape = ShapeConfig(shape.name, shape.seq_len, probe_batch, shape.kind)
    cfg = _single_chunk(cfg, pshape)

    def flops_for(n_layers: int) -> float:
        vcfg = _probe_variant(cfg, n_layers)
        fn, args, _, _, _ = _BUILDERS[kind](vcfg, pshape, None)
        return step_flops(fn, args)[0]

    f1 = flops_for(p)
    f2 = flops_for(2 * p)
    per_unit = max(f2 - f1, 0.0)
    n_units_eff = cfg.n_layers / p
    total = f1 + (n_units_eff - 1.0) * per_unit
    return {
        "probe_batch": probe_batch,
        "flops_1unit": f1,
        "flops_per_unit": per_unit,
        "hlo_flops_total": total * scale,
    }


# ---------------------------------------------------------------------------
# Analytic model FLOPs (roofline numerator)
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = new tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def validate_cell(
    arch: str | None, shape_name: str | None = None
) -> dict:
    """Name + analytic feasibility of one launch cell, nothing built.

    The ``repro_torch.sweep --dry-run`` hook. Raises ``ValueError`` with
    the known names on an unknown arch or shape; returns {} unless both
    are given.
    """
    if arch is not None and arch not in ARCH_IDS:
        raise ValueError(
            f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}"
        )
    if shape_name is not None and shape_name not in SHAPES:
        raise ValueError(
            f"unknown shape {shape_name!r}; known: {sorted(SHAPES)}"
        )
    if arch is None or shape_name is None:
        return {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape),
    }


def _outputs(kind: str, args, out) -> tuple:
    """The step's outputs at full depth: the new state (the state
    argument's shapes) and the metrics of a train step; the logits and
    the caches (written in place: the cache argument) of a serving step."""
    if kind == "train":
        return args[0], out[1]
    return out[0], args[2] if kind == "prefill" else args[3]


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    do_probe: bool = True,
    cim_mode: str | None = None,
    serve_quant: bool = False,
    kv_cache_dtype: str | None = None,
) -> dict:
    """Build one cell against the production mesh and run it on meta.

    The record has the reference's fields:
      * ``memory``: ``argument_bytes`` and ``output_bytes`` per device
        (``per_device_bytes`` under the builder's shardings);
        ``temp_bytes`` and ``alias_bytes`` are null: they are a compiled
        program's buffer assignment, which eager PyTorch has none of;
      * ``cost.flops_per_device``: ``step_flops`` of the step built at one
        pattern unit of depth (unrolled, one microbatch, one mamba chunk:
        the probe's 1-unit variant) at the cell's full batch and
        sequence, split evenly over the mesh's devices. The reference's
        XLA cost analysis likewise counts a scanned layer stack's body
        once; ``flops_probe`` extrapolates to the full depth.
        ``bytes_accessed_per_device`` is null (a compiler's count);
      * ``collectives`` is null: without a compiled SPMD program there is
        no collective to list;
      * ``lower_s``: seconds to build the step, its specs and shardings;
        ``compile_s`` is null;
      * ``status``, ``error`` and ``traceback`` as the reference catches
        a failure.
    """
    cfg = get_config(arch)
    if cim_mode:
        cfg = cfg.replace(cim=cfg.cim.__class__(mode=cim_mode))
    if kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    builder = _BUILDERS[shape.kind]
    if serve_quant:
        if shape.kind == "train":
            raise ValueError("--serve-quant applies to serving cells")
        builder = functools.partial(builder, serve_quant=True)
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "cim_mode": cfg.cim.mode,
        "serve_quant": serve_quant,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
    }
    t0 = time.time()  # noqa: CIM201 timing
    try:
        fn, args, in_sh, out_sh, _ = builder(cfg, shape, mesh)
        t_lower = time.time() - t0  # noqa: CIM201 timing
        one_unit = _single_chunk(_probe_variant(cfg, cfg.pattern_len), shape)
        run_fn, run_args, _, _, _ = builder(one_unit, shape, None)
        flops, out = step_flops(run_fn, run_args)
        rec.update(
            status="ok",
            lower_s=round(t_lower, 1),
            compile_s=None,
            memory={
                "argument_bytes": per_device_bytes(args, in_sh),
                "output_bytes": per_device_bytes(
                    _outputs(shape.kind, args, out), out_sh),
                "temp_bytes": None,
                "alias_bytes": None,
            },
            cost={
                "flops_per_device": flops / shd.mesh_size(mesh),
                "bytes_accessed_per_device": None,
            },
            collectives=None,
            model_flops=model_flops(cfg, shape),
        )
        if do_probe:
            try:
                rec["flops_probe"] = flops_probe(cfg, shape, shape.kind)
            except Exception as e:  # noqa: BLE001
                rec["flops_probe"] = {"error": repr(e)}
    except Exception as e:  # noqa: BLE001
        rec.update(status="fail", error=repr(e),
                   traceback=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 1)  # noqa: CIM201 timing
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--cim-mode", default=None)
    ap.add_argument("--serve-quant", action="store_true",
                    help="int8 weight-only serving params (W8A16)")
    ap.add_argument("--kv-cache-dtype", default=None,
                    help="KV cache storage dtype (e.g. float8_e4m3fn)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument(
        "--skip-existing", action="store_true",
        help="skip cells already recorded ok in --out (crash-resume)",
    )
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for sh in shape_cells(arch):
                cells.append((arch, sh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]

    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    existing: dict[str, dict] = {}
    if out_path.exists():
        existing = json.loads(out_path.read_text())

    for arch, sh in cells:
        for mp in meshes:
            key = f"{arch}|{sh}|{'multi' if mp else 'single'}"
            if args.cim_mode:
                key += f"|{args.cim_mode}"
            if args.serve_quant:
                key += "|w8"
            if args.kv_cache_dtype:
                key += f"|kv-{args.kv_cache_dtype}"
            if (
                args.skip_existing
                and existing.get(key, {}).get("status") == "ok"
            ):
                print(f"[{key}] skip (existing ok)", flush=True)
                continue
            rec = run_cell(arch, sh, multi_pod=mp,
                           do_probe=not args.no_probe,
                           cim_mode=args.cim_mode,
                           serve_quant=args.serve_quant,
                           kv_cache_dtype=args.kv_cache_dtype)
            existing[key] = rec
            out_path.write_text(
                json.dumps(existing, indent=1, sort_keys=True)
            )
            mem = rec.get("memory", {})
            print(
                f"[{key}] {rec['status']} wall={rec['wall_s']}s "
                f"args={mem.get('argument_bytes', 0) / 2**30:.2f}GiB "
                f"out={mem.get('output_bytes', 0) / 2**30:.2f}GiB",
                flush=True,
            )


if __name__ == "__main__":
    main()
