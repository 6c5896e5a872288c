"""Serving engine: prefill + greedy decode with continuous batching.

``ServeEngine`` drives the transformer serving path (init_caches ->
prefill -> decode_step); its caches are written in place. The slot-based
``ContinuousBatcher`` admits new requests into finished slots between
decode steps.

Weight-stationary serving: ``ServeEngine(..., plan=True)`` runs
``core.engine.plan_params`` over the parameters once at construction, so
every prefill and decode step reuses precomputed weight codes, colsums
and scales. Under a CIM-mode policy the planned codes equal the per-call
ones (``plan=False`` plans each matmul per call through
``engine.matmul``), so the token streams are the same; under an 'fp'
policy planning means digital int8 weight-only serving (the plans drop
the float weights).

``restore_planned`` warm-starts a server from a checkpointed planned
tree (the train -> serve handoff). The JAX package's ``donate_plan``
(XLA buffer donation, which PyTorch has no counterpart of) is not ported
and raises.

Sharded planes: ``mesh=`` (a ``DeviceMesh`` from
``launch.mesh.make_host_mesh``) places the planned tree under
``distributed.sharding.shard_planned``: every stored-weight tensor is
tensor-parallel over the model axis on its output-channel dim, the rest
replicated (``self.placed`` holds the DTensors). The steps compute on
each tensor's local shard, which at world size 1 is the whole tensor; a
mesh of more devices raises ``NotImplementedError`` (one card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as cim_engine
from repro_torch.distributed import sharding
from repro_torch.models import transformer


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, max_len: int,
                 batch: int, plan: bool = False, donate_plan: bool = False,
                 mesh=None, calibration=None, device="cuda"):
        if donate_plan:
            raise NotImplementedError(
                "donate_plan is XLA buffer donation, which PyTorch has no "
                "counterpart of (ROADMAP.md A11)")
        device = torch.device(device)
        if mesh is not None:
            sharding.check_one_device(mesh, "ServeEngine(mesh=)")
            mesh_device = getattr(mesh, "device_type", device.type)
            if mesh_device != device.type:
                raise ValueError(f"mesh on {mesh_device}, engine on "
                                 f"{device.type}")
        if calibration is not None and cfg.cim.backend and \
                not cim_engine.is_builtin_backend(cfg.cim.backend):
            # The explicitly passed result wins: registered under the
            # policy's backend name, over any earlier registration there.
            calibration.register(cfg.cim.backend)
        if plan:
            params = cim_engine.plan_params(
                params, policy=cfg.cim, calibration=calibration
            )
        self.placed = None
        if mesh is not None:
            self.placed = sharding.shard_planned(params, mesh)
            params = sharding.local_shards(self.placed)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.batch = batch
        self.mesh = mesh
        self.device = device
        self.caches = transformer.init_caches(
            cfg, batch, max_len, dtype=getattr(torch, cfg.activation_dtype),
            device=self.device,
        )

    @classmethod
    def restore_planned(
        cls, directory, cfg: ModelConfig, *, max_len: int, batch: int,
        step: int | None = None, calibration=None, device="cuda",
    ) -> "ServeEngine":
        """Warm-start a server from a checkpointed planned tree: what
        ``store.save(plan_params(params, policy=cfg.cim), dir, step)`` or
        ``Trainer.planned_params`` wrote, in the port or the JAX package.

        The restore target is built from shapes alone (``plan_params``
        over ``transformer.abstract_params``' meta tensors), so no weight
        is drawn, quantized or bit-sliced here: the plans come back as
        the saver wrote them. ``calibration`` must be the saver's (it
        groups each layer's planes at its calibrated ``rows_active``) and
        is registered as ``cfg.cim.backend``, as the constructor does.
        """
        from repro_torch.checkpoint import store

        target = cim_engine.plan_params(
            transformer.abstract_params(cfg), policy=cfg.cim,
            calibration=calibration)
        planned = store.restore(directory, target, step=step, device=device)
        return cls(planned, cfg, max_len=max_len, batch=batch, plan=False,
                   calibration=calibration, device=device)

    @torch.no_grad()
    def _prefill(self, prompts: torch.Tensor) -> torch.Tensor:
        logits, self.caches = transformer.prefill(
            self.params, prompts, self.caches, self.cfg)
        return logits

    @torch.no_grad()
    def _decode_step(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        """One decode step of the whole batch at position ``pos``."""
        logits, self.caches = transformer.decode_step(
            self.params, tok, pos, self.caches, self.cfg)
        return logits

    def generate(self, prompts: torch.Tensor, n_tokens: int) -> np.ndarray:
        """Greedy-decode ``n_tokens`` after the prompt batch [B, S]."""
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"prompt batch {b} != engine batch {self.batch}")
        logits = self._prefill(prompts.to(self.device))
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for i in range(n_tokens - 1):
            tok = torch.argmax(self._decode_step(tok, s + i), dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S]
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed decode batch.

    Each slot holds one in-flight request; finished slots are refilled
    from the queue between decode steps. A new request is prefilled token
    by token through whole-batch decode steps at its own positions. As in
    the JAX package, every such step writes all slots' cache rows at that
    position, so slots in flight together perturb each other's caches
    (ROADMAP.md C records the token streams).
    """

    def __init__(self, engine: ServeEngine, eos_token: int = 0):
        self.engine = engine
        self.eos = eos_token
        self.slots: list[Request | None] = [None] * engine.batch
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self._positions = np.zeros(engine.batch, dtype=np.int64)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                for t, tok in enumerate(req.prompt):
                    self._step_slot(i, int(tok), t)
                self._positions[i] = len(req.prompt)

    def _step_slot(self, slot: int, token: int, pos: int) -> int:
        toks = torch.zeros((self.engine.batch,), dtype=torch.long,
                           device=self.engine.device)
        toks[slot] = token
        logits = self.engine._decode_step(toks, pos)
        return int(torch.argmax(logits[slot]))

    def step(self):
        """One scheduler tick: admit, decode each active slot, retire."""
        self._admit()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            last = (req.generated[-1] if req.generated
                    else int(req.prompt[-1]))
            nxt = self._step_slot(i, last, int(self._positions[i]))
            req.generated.append(nxt)
            self._positions[i] += 1
            if len(req.generated) >= req.max_new or nxt == self.eos:
                req.done = True
                self.completed.append(req)
                self.slots[i] = None

    def run_until_done(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed
