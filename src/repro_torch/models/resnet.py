"""ResNet (CIFAR) -- the paper's own evaluation network.

Convolutions execute as im2col + the core.engine CIM matmul, so the
whole network runs through the macro model as the paper's system
simulations do (4-bit unsigned post-ReLU activations, 8-bit weights,
grouped ADC readout with cutoff quantization).

Layouts follow the JAX reference at every public function: NHWC
activations, HWIO filters, [K, N] weight matrices, and im2col features
in (cin, kh, kw) order. Padding is JAX's "SAME": for a 3x3 stride-2
conv on an even input that is (0, 1), not a symmetric (1, 1), so the
port pads the NHWC activation explicitly and takes the windows as
strided views of it.

Weight-stationary evaluation: ``plan_params(params, policy)`` converts
every conv/fc weight into its im2col matrix's ``engine.PlannedWeights``
once. Functional with explicit BatchNorm state:

  init(seed, cfg, device=)                -> (params, bn_state)
  forward(params, bn_state, x, cfg)       -> (logits, new_bn_state)
  loss_fn(params, bn_state, batch, cfg)   -> (loss, (bn_state, metrics))
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import CIMPolicy
from repro_torch.core import engine
from repro_torch.core.engine import PlannedWeights
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class PlannedConv:
    """A conv filter's weight-stationary plan + its spatial geometry.

    The im2col plan alone cannot recover (kh, kw), so the filter window
    rides along.
    """

    plan: PlannedWeights
    kernel_hw: tuple[int, int] = dataclasses.field(
        metadata={"static": True})


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    n_classes: int = 10
    widths: tuple[int, ...] = (16, 32, 64)
    blocks_per_stage: int = 3  # ResNet-20 = 1 + 2*3*3 + 1 layers
    bn_momentum: float = 0.9
    cim: CIMPolicy = dataclasses.field(
        default_factory=lambda: CIMPolicy(mode="fp", act_symmetric=True)
    )


def _conv_spec(kh, kw, cin, cout):
    return ParamSpec((kh, kw, cin, cout), (None, None, "embed", "mlp"),
                     "fanin")


def _bn_spec(c):
    return {
        "scale": ParamSpec((c,), (None,), "ones"),
        "bias": ParamSpec((c,), (None,), "zeros"),
    }


def _block_spec(cin, cout):
    spec = {
        "conv1": _conv_spec(3, 3, cin, cout),
        "bn1": _bn_spec(cout),
        "conv2": _conv_spec(3, 3, cout, cout),
        "bn2": _bn_spec(cout),
    }
    if cin != cout:
        spec["proj"] = _conv_spec(1, 1, cin, cout)
        spec["bn_proj"] = _bn_spec(cout)
    return spec


def model_spec(cfg: ResNetConfig) -> dict:
    w = cfg.widths
    spec: dict = {"stem": _conv_spec(3, 3, 3, w[0]), "bn_stem": _bn_spec(w[0])}
    cin = w[0]
    for si, cout in enumerate(w):
        for bi in range(cfg.blocks_per_stage):
            spec[f"s{si}b{bi}"] = _block_spec(cin, cout)
            cin = cout
    spec["fc"] = common.linear_spec(w[-1], cfg.n_classes, "embed", "vocab",
                                    bias=True)
    return spec


def init(seed: int, cfg: ResNetConfig, *, device="cuda"):
    """(params, bn_state): random parameters at ``cfg``'s widths from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, BatchNorm
    running statistics at mean 0, variance 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = common.init_params(gen, model_spec(cfg))
    return params, _init_bn_state(params)


def _init_bn_state(params):
    state = {}
    for k, v in params.items():
        if k.startswith("bn"):
            c = v["scale"].shape[0]
            dev = v["scale"].device
            state[k] = {"mean": torch.zeros((c,), device=dev),
                        "var": torch.ones((c,), device=dev)}
        elif isinstance(v, dict) and not {"w", "b"} >= set(v.keys()):
            sub = _init_bn_state(v)
            if sub:
                state[k] = sub
    return state


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX "SAME" padding (lo, hi) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int):
    """NHWC x zero-padded "SAME" -> (padded NHWC, Ho, Wo)."""
    h, w = x.shape[1:3]
    ph, pw = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    return x, -(-h // stride), -(-w // stride)


def im2col(
    x: torch.Tensor, kernel_hw: tuple[int, int], stride: int
) -> torch.Tensor:
    """NHWC x -> [B, Ho, Wo, cin*kh*kw] patches, features in (cin, kh, kw)
    order: ``jax.lax.conv_general_dilated_patches`` with "SAME" padding.

    The windows are strided views of the padded input and the one
    reshape copies them out, so a conv is the pad and one gather
    whatever the batch (ATen's ``F.unfold`` loops over the images)."""
    with tracing.span("repro_torch.resnet.im2col"):
        kh, kw = kernel_hw
        xp, ho, wo = _pad_same(x, kh, kw, stride)
        win = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # [B,H,W,C,kh,kw]
        return win[:, :ho, :wo].reshape(x.shape[0], ho, wo, -1)


def conv2d_same(
    x: torch.Tensor, w_hwio: torch.Tensor, stride: int
) -> torch.Tensor:
    """Digital NHWC x HWIO conv with JAX "SAME" padding -> NHWC."""
    kh, kw = w_hwio.shape[:2]
    xp, _, _ = _pad_same(x, kh, kw, stride)
    y = F.conv2d(xp.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _im2col_weight(params_w: torch.Tensor) -> torch.Tensor:
    """[kh, kw, cin, cout] -> the [cin*kh*kw, cout] im2col matrix."""
    kh, kw, cin, cout = params_w.shape
    return params_w.permute(2, 0, 1, 3).reshape(kh * kw * cin, cout)


def _conv(params_w, x, stride, policy: CIMPolicy | None,
          generator=None, cim_enabled: bool = True, *, name: str = "",
          tap=None):
    """Conv as im2col + (CIM) matmul. x: [B, H, W, C] NHWC.

    params_w is either the raw [kh, kw, cin, cout] filter or a
    PlannedConv over its im2col matrix (see plan_params). A raw filter
    under a CIM policy runs through ``engine.matmul`` (QAT).

    ``tap(name, x2, w)`` observes the im2col activations [M, K] and the
    weight (im2col matrix or PlannedWeights) of every macro-eligible
    conv.
    """
    planned = isinstance(params_w, PlannedConv)
    want_tap = tap is not None and cim_enabled
    digital = policy is None or policy.mode == "fp" or not cim_enabled
    if not planned and digital and not want_tap:
        return conv2d_same(x, params_w, stride)
    kernel_hw = params_w.kernel_hw if planned else tuple(params_w.shape[:2])
    patches = im2col(x, kernel_hw, stride)
    b, ho, wo, pf = patches.shape
    x2 = patches.reshape(-1, pf)
    if planned:
        plan = params_w.plan
        if plan.k != pf:
            raise ValueError(f"plan K={plan.k} != patch features {pf} "
                             f"for window {kernel_hw}")
        if want_tap:
            tap(name, x2, plan)
        if digital:
            y = x2 @ plan.best_weights(x2.dtype)
        else:
            y = engine.execute(x2, plan, policy, generator=generator)
        cout = plan.n
    else:
        wmat = _im2col_weight(params_w)
        if want_tap:
            tap(name, x2, wmat)
        # Fresh weights (training / QAT): planned per call, straight-
        # through gradients through the im2col matrix and the window
        # gather (``Tensor.unfold``'s backward, no per-image loop).
        y = x2 @ wmat if digital else engine.matmul(x2, wmat, policy,
                                                    generator=generator)
        cout = wmat.shape[-1]
    return y.reshape(b, ho, wo, cout)


def plan_params(params: dict, policy: CIMPolicy) -> dict:
    """Precompute weight-stationary plans for every conv/fc weight.

    Conv filters are planned as their im2col matrices; the fc layer's
    'w' leaf as a plain matrix. BatchNorm / bias leaves pass through,
    and an exempt stem (policy.apply_to_stem=False) keeps its raw filter
    so the digital conv path stays as it is. Plans keep the float
    weights, so digitally-exempt layers are exact.
    """

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "stem" and not policy.apply_to_stem:
                out[k] = v
            elif k.startswith(("conv", "stem", "proj")) and v.ndim == 4:
                out[k] = PlannedConv(
                    plan=engine.plan_weights(
                        _im2col_weight(v), policy.cim, policy
                    ),
                    kernel_hw=tuple(v.shape[:2]),
                )
            elif k == "w" and v.ndim == 2:
                out[k] = engine.plan_weights(v, policy.cim, policy)
            else:
                out[k] = v
        return out

    return walk(params)


def _bn(params, state, x, train: bool, momentum: float):
    if train:
        mu = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mu,
            "var": momentum * state["var"] + (1 - momentum) * var,
        }
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    y = (x - mu) * torch.rsqrt(var + 1e-5)
    return y * params["scale"] + params["bias"], new_state


def forward(
    params: dict,
    bn_state: dict,
    x: torch.Tensor,  # [B, 32, 32, 3]
    cfg: ResNetConfig,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    tap=None,
) -> tuple[torch.Tensor, dict]:
    with tracing.span("repro_torch.resnet.forward"):
        policy = cfg.cim
        new_state: dict[str, Any] = {}

        h = _conv(params["stem"], x, 1, policy, generator=generator,
                  cim_enabled=policy.apply_to_stem, name="stem", tap=tap)
        h, new_state["bn_stem"] = _bn(params["bn_stem"], bn_state["bn_stem"],
                                      h, train, cfg.bn_momentum)
        h = torch.relu(h)

        for si, _ in enumerate(cfg.widths):
            for bi in range(cfg.blocks_per_stage):
                name = f"s{si}b{bi}"
                bp, bs = params[name], bn_state[name]
                ns = {}
                stride = 2 if (bi == 0 and si > 0) else 1
                r = _conv(bp["conv1"], h, stride, policy, generator=generator,
                          name=f"{name}/conv1", tap=tap)
                r, ns["bn1"] = _bn(bp["bn1"], bs["bn1"], r, train,
                                   cfg.bn_momentum)
                r = torch.relu(r)
                r = _conv(bp["conv2"], r, 1, policy, generator=generator,
                          name=f"{name}/conv2", tap=tap)
                r, ns["bn2"] = _bn(bp["bn2"], bs["bn2"], r, train,
                                   cfg.bn_momentum)
                if "proj" in bp:
                    sc = _conv(bp["proj"], h, stride, policy,
                               generator=generator, name=f"{name}/proj",
                               tap=tap)
                    sc, ns["bn_proj"] = _bn(bp["bn_proj"], bs["bn_proj"], sc,
                                            train, cfg.bn_momentum)
                else:
                    sc = h
                h = torch.relu(r + sc)
                new_state[name] = ns

        h = torch.mean(h, dim=(1, 2))  # global average pool
        logits = common.linear_apply(params["fc"], h, policy,
                                     cim_enabled=policy.apply_to_logits,
                                     generator=generator)
        return logits, new_state


@torch.no_grad()
def top1_accuracy(
    params: dict,
    bn_state: dict,
    images: torch.Tensor,
    labels: torch.Tensor,
    cfg: ResNetConfig,
    *,
    generator: torch.Generator | None = None,
    batch_size: int | None = None,
) -> float:
    """Held-out top-1 accuracy of (possibly planned) params, every conv
    on its real execution path under ``cfg.cim``. A ``generator`` (the
    reference's ``key``) feeds a noisy operating point's hardware errors,
    batch after batch, so a seeded generator makes the result
    deterministic."""
    n = int(images.shape[0])
    bs = n if batch_size is None else int(batch_size)
    correct = 0
    for s in range(0, n, bs):
        logits, _ = forward(params, bn_state, images[s:s + bs], cfg,
                            train=False, generator=generator)
        pred = torch.argmax(logits, dim=-1)
        correct += int((pred == labels[s:s + bs].to(pred.device)).sum())
    return correct / n


def loss_fn(params, bn_state, batch, cfg: ResNetConfig, *, train=True,
            generator=None):
    """Cross entropy of ``batch["image"]`` against ``batch["label"]``.
    Returns (loss, (new BatchNorm state, {"loss", "acc"})); the state and
    metrics are detached (the JAX package returns them as aux)."""
    logits, new_state = forward(params, bn_state, batch["image"], cfg,
                                train=train, generator=generator)
    labels = batch["label"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, (_detach(new_state), {"loss": loss.detach(), "acc": acc})


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
