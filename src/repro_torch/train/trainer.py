"""Training loop: the train-step factory and the fault-tolerant Trainer.

``make_train_step`` builds one step: loss -> gradients (autograd; under
a CIM policy every projection's forward is the planned macro path and
its backward the straight-through estimator) -> [int8 compression] ->
global-norm clip -> AdamW. Microbatches accumulate their gradients in
``accum_dtype``. There is no jit and no buffer donation (the JAX
package's are XLA's); the step is functional: it returns a new
``TrainState`` and changes none of the one it was given.

``TrainState.rng`` is a [2] uint32 tensor, the JAX package's PRNG key
layout (``make_key(seed)`` gives ``PRNGKey(seed)``'s words), so a
checkpoint names and shapes it as the reference does. Each step derives
the seed of its ``torch.Generator`` from it and advances it (splitmix64
over the 64-bit word pair); the stream differs from ``jax.random``'s,
and matters only to noisy operating points and router jitter. Every
microbatch of a step draws from a generator seeded alike, as the
reference passes each the same key.

The ``Trainer`` adds what lives above the step: periodic async
checkpoints, resume, a straggler watchdog (EMA wall time; slow-shard
re-issue through the loader) and clean abort/restart semantics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint import store
from repro_torch.core.quant import true_divide
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    comp: adamw.CompressionState | None
    rng: torch.Tensor  # [2] uint32


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    log_every: int = 10
    microbatches: int = 1  # gradient-accumulation factor
    compress_grads: bool = False
    # straggler watchdog
    straggler_factor: float = 3.0  # flag steps slower than f x EMA
    straggler_ema: float = 0.9


_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1


def make_key(seed: int, device="cpu") -> torch.Tensor:
    """The [2] uint32 key of ``seed``: ``jax.random.PRNGKey(seed)``'s
    words."""
    seed &= _MASK64
    return torch.tensor([seed >> 32, seed & _MASK32], dtype=torch.uint32,
                        device=device)


def _mix64(z: int) -> int:
    """splitmix64: one 64-bit output of the counter ``z``."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def split_key(rng: torch.Tensor) -> tuple[int, torch.Tensor]:
    """(this step's generator seed, the advanced key)."""
    hi, lo = (int(v) for v in rng.tolist())
    k = (hi << 32) | lo
    nxt = _mix64((2 * k + 1) & _MASK64)
    return _mix64((2 * k) & _MASK64), make_key(nxt, rng.device)


def init_train_state(key: torch.Tensor, params: Any, *,
                     compress: bool = False) -> TrainState:
    return TrainState(
        params=params,
        opt=adamw.init_state(params),
        comp=adamw.init_compression(params) if compress else None,
        rng=key.to(adamw.tree_leaves(params)[0].device),
    )


def _value_and_grad(loss_fn, params, batch, generator):
    """(loss, metrics, gradients): the gradient of every floating leaf
    (zeros where the loss does not reach it, as ``jax.grad`` gives)."""
    p = adamw.tree_map(
        lambda t: t.detach().requires_grad_(t.is_floating_point()), params)
    loss, metrics = loss_fn(p, batch, generator)
    leaves = [t for t in adamw.tree_leaves(p) if t.requires_grad]
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad(t):
        if not t.requires_grad:
            return torch.zeros_like(t)
        g = next(got)
        return torch.zeros_like(t) if g is None else g

    grads = adamw.tree_map(grad, p)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(
    loss_fn: Callable[..., tuple[torch.Tensor, dict]],
    opt_cfg: adamw.OptimizerConfig,
    *,
    microbatches: int = 1,
    accum_dtype=torch.float32,
    compress: bool = False,
):
    """loss_fn(params, batch, generator) -> (loss, metrics dict of
    scalars). Returns step(state, batch) -> (state, metrics)."""

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        device = state.rng.device
        if device.type == "meta":
            # A shape-only step (launch.dryrun): a meta key holds no value,
            # so the step draws nothing and the key passes through.
            new_rng = state.rng

            def gen():
                return None
        else:
            seed, new_rng = split_key(state.rng)

            def gen():
                return torch.Generator(device=device).manual_seed(seed)

        if microbatches > 1:
            # batch leaves are [mb * b, ...] -> microbatch i's [b, ...]
            g_acc = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                      device=p.device), state.params)
            loss_acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                mb = adamw.tree_map(
                    lambda x, i=i: x.reshape(microbatches, -1,
                                             *x.shape[1:])[i], batch)
                loss, metrics, g = _value_and_grad(loss_fn, state.params,
                                                   mb, gen())
                g_acc = adamw.tree_map(lambda a, b: a + b.to(a.dtype),
                                       g_acc, g)
                loss_acc = loss_acc + loss
            grads = adamw.tree_map(lambda g: true_divide(g, microbatches),
                                   g_acc)
            loss = true_divide(loss_acc, microbatches)
        else:
            loss, metrics, grads = _value_and_grad(loss_fn, state.params,
                                                   batch, gen())

        comp = state.comp
        cmetrics = {}
        if compress and comp is not None:
            grads, comp, cmetrics = adamw.compress_decompress(grads, comp)

        params, opt, ometrics = adamw.apply_updates(
            state.params, grads, state.opt, opt_cfg)
        out_metrics = {"loss": loss, **metrics, **ometrics, **cmetrics}
        return TrainState(params, opt, comp, new_rng), out_metrics

    return step


class StragglerWatchdog:
    """EMA wall-time monitor; reports shards that should be re-issued.

    In one process there is no peer host, so the watchdog's policy
    (detection and the re-issue decision) is what runs and is tested.
    """

    def __init__(self, cfg: TrainerConfig, n_shards: int = 1):
        self.cfg = cfg
        self.ema: float | None = None
        self.flagged: list[tuple[int, int, float]] = []
        self.n_shards = n_shards

    def observe(self, step: int, seconds: float,
                shard_times: dict[int, float] | None = None) -> list[int]:
        """Returns shard ids to re-issue (empty in the common case)."""
        slow: list[int] = []
        if self.ema is None:
            self.ema = seconds
        limit = self.cfg.straggler_factor * self.ema
        if shard_times:
            for shard, t in shard_times.items():
                if t > limit:
                    slow.append(shard)
                    self.flagged.append((step, shard, t))
        elif seconds > limit:
            self.flagged.append((step, -1, seconds))
        a = self.cfg.straggler_ema
        self.ema = a * self.ema + (1 - a) * seconds
        return slow


class Trainer:
    def __init__(self, train_step, state: TrainState, loader,
                 cfg: TrainerConfig):
        self.train_step = train_step
        self.state = state
        self.loader = loader
        self.cfg = cfg
        self.step = 0
        self.watchdog = StragglerWatchdog(cfg)
        self.ckpt = store.AsyncCheckpointer()
        self.history: list[dict] = []

    def _payload(self) -> dict:
        return {"state": self.state, "step": self.step}

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint if one exists (onto the devices
        of the current state's tensors); returns the step."""
        if not self.cfg.checkpoint_dir:
            return 0
        last = store.latest_step(self.cfg.checkpoint_dir)
        if last is None:
            return 0
        payload = store.restore(self.cfg.checkpoint_dir,
                                {"state": self.state, "step": 0}, step=last)
        self.state = payload["state"]
        self.step = int(payload["step"])
        return self.step

    def run(self, n_steps: int, *, abort_at: int | None = None):
        """Train ``n_steps``; ``abort_at`` simulates a node failure after
        that step (its checkpoint, if due, is written first)."""
        target = self.step + n_steps
        for step_id, batch in self.loader:
            if self.step >= target:
                break
            t0 = time.monotonic()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])  # waits for the device
            dt = time.monotonic() - t0
            for shard in self.watchdog.observe(self.step, dt):
                self.loader.reissue(step_id, shard)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == target:
                self.history.append(
                    {"step": self.step, "loss": loss, "sec": dt})
            if (self.cfg.checkpoint_dir
                    and self.step % self.cfg.checkpoint_every == 0):
                self.ckpt.save(self._payload(), self.cfg.checkpoint_dir,
                               self.step)
            if abort_at is not None and self.step >= abort_at:
                self.ckpt.wait()
                raise RuntimeError(f"simulated failure at step {self.step}")
        self.ckpt.wait()
        return self.history

    def planned_params(self, policy=None):
        """Weight-stationary export of the live params for serving (the
        train -> serve handoff): ``core.engine.plan_params`` over them,
        the codes, colsums and scales ``ServeEngine`` reuses every
        decode step. policy=None exports the digital int8 weight-only
        form."""
        from repro_torch.core import engine as cim_engine

        return cim_engine.plan_params(self.state.params, policy=policy)

    def final_checkpoint(self):
        if self.cfg.checkpoint_dir:
            self.ckpt.save(self._payload(), self.cfg.checkpoint_dir,
                           self.step)
            self.ckpt.wait()
