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

One CUDA graph per decode step: where ``graphs_decode`` holds (a CUDA
device, attention layers with dense MLPs, a noiseless policy) the engine
runs its first decode step eagerly and captures it into a
``torch.cuda.CUDAGraph``, then replays that graph for every later step
with the token and the position copied into its input buffers. The
graph runs the eager step's kernels in the same order, so the tokens are
the eager engine's bit for bit; a replay only skips the host's work
between launches. Every other engine (MoE, recurrent, encoder-decoder,
noisy, the CPU) runs each step eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as cim_engine
from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch
from repro_torch.models import attention, transformer


def graphs_decode(cfg: ModelConfig, device) -> bool:
    """Whether ``ServeEngine`` runs ``cfg``'s decode steps as one captured
    CUDA graph on ``device``: a CUDA device, a decoder whose every layer
    is attention with a dense MLP (a MoE layer reads its routing on the
    host; recurrent and encoder-decoder steps stay eager), and a
    noiseless operating point (no generator is drawn)."""
    return (torch.device(device).type == "cuda"
            and not cfg.is_encoder_decoder
            and not cfg.cim.cim.noisy
            and all(cfg.layer_kind(i) in ("attn", "attn_local")
                    and not cfg.layer_uses_moe(i)
                    for i in range(cfg.n_layers)))


class DecodeGraph:
    """A decode step run as one CUDA graph: captured at the first call,
    replayed at every later one.

    The first call runs ``step(tok, pos)`` eagerly on a side stream, as
    capture asks (its logits are that call's result), then captures the
    same step on fixed token and position buffers. A later call copies
    its token and position in and replays the graph; its ``step`` is not
    run, since the graph holds the captured step's buffers, the caches
    among them. The dispatch decisions made at capture reach
    ``dispatch``'s listeners at each replay instead, as an eager step's
    do. A replay calls no kernel wrapper, so ``cim_mac.LAUNCHES`` counts
    the capture's launches once and no replay's: the replayed kernels
    show in a device trace.
    """

    def __init__(self):
        self.graph: torch.cuda.CUDAGraph | None = None

    def __call__(self, step, tok: torch.Tensor, pos: int) -> torch.Tensor:
        if self.graph is None:
            with tracing.span("repro_torch.serve.decode_capture"):
                return self._capture(step, tok, pos)
        with tracing.span("repro_torch.serve.decode_graph"):
            self.tok.copy_(tok)
            self.pos.fill_(pos)
            self.graph.replay()
            dispatch.renotify(self.resolutions)
            return self.logits.clone()  # the next replay overwrites it

    def _capture(self, step, tok: torch.Tensor, pos: int) -> torch.Tensor:
        self.tok = tok.clone()
        self.pos = attention.as_position(pos, tok.device)
        main = torch.cuda.current_stream(tok.device)
        side = torch.cuda.Stream(tok.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = step(self.tok, self.pos)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with dispatch.held_resolutions() as self.resolutions, \
                torch.cuda.graph(graph):
            self.logits = step(self.tok, self.pos)
        self.graph = graph
        return logits


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
        self.decode_graph = DecodeGraph() if graphs_decode(cfg, device) \
            else None

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
        with tracing.span("repro_torch.serve.prefill"):
            logits, self.caches = transformer.prefill(
                self.params, prompts, self.caches, self.cfg)
        return logits

    @torch.no_grad()
    def _decode_step(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        """One decode step of the whole batch at position ``pos``: the
        engine's graph where it has one, else eager."""
        with tracing.span("repro_torch.serve.decode_step"):
            if self.decode_graph is not None:
                return self.decode_graph(self._step, tok, pos)
            return self._step(tok, pos)

    def _step(self, tok: torch.Tensor, pos) -> torch.Tensor:
        logits, self.caches = transformer.decode_step(
            self.params, tok, pos, self.caches, self.cfg)
        return logits

    def generate(self, prompts: torch.Tensor, n_tokens: int) -> np.ndarray:
        """Greedy-decode ``n_tokens`` after the prompt batch [B, S]."""
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"prompt batch {b} != engine batch {self.batch}")
        with tracing.span("repro_torch.serve.generate"):
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
