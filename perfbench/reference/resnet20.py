"""ResNet-20 for CIFAR (He et al. 2016, arXiv:1512.03385 section 4.2) in
plain PyTorch, every conv but the stem through the reference macro.

The network: a 3x3 stem conv to widths[0], then len(widths) stages of
``blocks_per_stage`` basic blocks (conv3x3-BN-ReLU-conv3x3-BN, plus the
shortcut, then ReLU); the first block of every stage after the first
strides by 2 and projects its shortcut with a 1x1 conv and BN; global
average pooling and a linear classifier. Activations are NHWC, filters
HWIO, padding is "SAME" (for a stride-2 3x3 conv on an even input: 0
before, 1 after). BatchNorm runs in eval mode on the running statistics.

A macro conv is im2col (features in (cin, kh, kw) order, zero padding
included in the quantizer's statistic) and ``macro.linear`` under the
configuration's symmetric (post-ReLU) activation quantizer with its
percentile range. The stem and the classifier stay digital in float32.

``tf32=True`` is the control of the benchmark's check: the digital
float32 products (the stem conv, the classifier) take their operands
rounded to TF32's 10-bit significand, as the tensor cores do with TF32
on.

The tree of weights is the benchmark's (``adapters/resnet.py`` makes it
from the seed): {"stem": [3, 3, 3, C0], "bn_stem": {scale, bias},
"s{i}b{j}": {"conv1", "bn1", "conv2", "bn2"[, "proj", "bn_proj"]},
"fc": {"w": [C, classes], "b": [classes]}} and the BN state
{"bn_stem": {mean, var}, "s{i}b{j}": {"bn1": ..., ...}}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import macro


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to nearest (ties away) at TF32's 10 significand
    bits, as the tensor cores read TF32 operands."""
    bits = x.contiguous().view(torch.int32)
    bits = torch.bitwise_and(bits + (1 << 12), ~((1 << 13) - 1))
    return bits.view(torch.float32)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int):
    """NHWC x zero-padded "SAME" -> (padded NHWC, Ho, Wo)."""
    h, w = x.shape[1:3]
    ph, pw = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    return x, -(-h // stride), -(-w // stride)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """NHWC x -> [B * Ho * Wo, cin * kh * kw], features (cin, kh, kw)."""
    b, c = x.shape[0], x.shape[3]
    xp, ho, wo = _pad_same(x, kh, kw, stride)
    # [B, Ho, Wo, C, kh, kw] windows
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    return win[:, :ho, :wo].reshape(b * ho * wo, c * kh * kw)


def _filter_matrix(w_hwio: torch.Tensor) -> torch.Tensor:
    kh, kw, cin, cout = w_hwio.shape
    return w_hwio.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)


class ResNet20:
    """The reference network over one set of raw weights; plans its own
    macro weights once."""

    def __init__(self, params: dict, bn_state: dict, cfg: dict, *,
                 tf32: bool = False):
        self.params, self.bn, self.cfg = params, bn_state, cfg
        self.op = macro.OperatingPoint.from_json(cfg["cim"])
        self.tf32 = tf32
        self.plans = {}
        for name, blk in params.items():
            if name in ("bn_stem", "fc") or not isinstance(blk, dict):
                continue
            for key in ("conv1", "conv2", "proj"):
                if key in blk:
                    self.plans[(name, key)] = macro.plan(
                        _filter_matrix(blk[key]), self.op)

    def _digital(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self.tf32 else t

    def _macro_conv(self, x, name, key, stride):
        w = self.params[name][key]
        kh, kw = w.shape[:2]
        b, h, wd = x.shape[:3]
        ho, wo = -(-h // stride), -(-wd // stride)
        y = macro.linear(im2col(x, kh, kw, stride), self.plans[(name, key)],
                         self.op, symmetric=self.cfg["act_symmetric"],
                         clip_pct=self.cfg["act_clip_pct"])
        return y.reshape(b, ho, wo, -1)

    def _bn(self, p, s, x):
        y = (x - s["mean"]) * torch.rsqrt(s["var"] + 1e-5)
        return y * p["scale"] + p["bias"]

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float32 -> [B, classes] float32 logits."""
        p, s = self.params, self.bn
        w = p["stem"]
        ph = _same_pads(images.shape[1], w.shape[0], 1)
        pw = _same_pads(images.shape[2], w.shape[1], 1)
        xp = F.pad(images.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        h = F.conv2d(self._digital(xp), self._digital(w.permute(3, 2, 0, 1)))
        h = torch.relu(self._bn(p["bn_stem"], s["bn_stem"],
                                h.permute(0, 2, 3, 1)))
        for si in range(len(self.cfg["widths"])):
            for bi in range(self.cfg["blocks_per_stage"]):
                name = f"s{si}b{bi}"
                bp, bs = p[name], s[name]
                stride = 2 if (bi == 0 and si > 0) else 1
                r = self._macro_conv(h, name, "conv1", stride)
                r = torch.relu(self._bn(bp["bn1"], bs["bn1"], r))
                r = self._macro_conv(r, name, "conv2", 1)
                r = self._bn(bp["bn2"], bs["bn2"], r)
                if "proj" in bp:
                    sc = self._macro_conv(h, name, "proj", stride)
                    sc = self._bn(bp["bn_proj"], bs["bn_proj"], sc)
                else:
                    sc = h
                h = torch.relu(r + sc)
        h = torch.mean(h, dim=(1, 2))
        fc = p["fc"]
        return self._digital(h) @ self._digital(fc["w"]) + fc["b"]


def conv_shapes(cfg: dict, batch: int) -> list[dict]:
    """Every conv of one forward at ``batch``: its [M, K] x [K, N] product
    (M = batch * Ho * Wo, K = cin * kh * kw, N = cout), the input feature
    map's element count and whether the macro runs it."""
    hw = cfg["image_hw"]
    widths = cfg["widths"]
    out = [dict(m=batch * hw * hw, k=cfg["in_channels"] * 9, n=widths[0],
                in_elems=batch * hw * hw * cfg["in_channels"], macro=False)]
    cin, size = widths[0], hw
    for si, cout in enumerate(widths):
        for bi in range(cfg["blocks_per_stage"]):
            stride = 2 if (bi == 0 and si > 0) else 1
            so = -(-size // stride)
            m = batch * so * so
            out.append(dict(m=m, k=cin * 9, n=cout,
                            in_elems=batch * size * size * cin, macro=True))
            out.append(dict(m=m, k=cout * 9, n=cout,
                            in_elems=m * cout, macro=True))
            if cin != cout:
                out.append(dict(m=m, k=cin, n=cout,
                                in_elems=batch * size * size * cin,
                                macro=True))
            cin, size = cout, so
    return out


def model_macs(cfg: dict, batch: int) -> int:
    """Multiply-accumulates one forward's outputs need: every conv and
    the classifier."""
    convs = sum(c["m"] * c["k"] * c["n"] for c in conv_shapes(cfg, batch))
    return convs + batch * cfg["widths"][-1] * cfg["n_classes"]
