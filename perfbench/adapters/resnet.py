"""The ResNet family's cell: the program's ``models.resnet.forward`` on
``resnet.plan_params`` output, batch after batch of a pool of seeded
images, logits to the host and top-1 there.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``pool``
(distinct batches, cycled), ``noise`` (SyntheticCIFAR's), ``warmup``
(calls before the window). One call is one forward of one batch; its
work is ``batch`` images.
"""

from __future__ import annotations

import torch

from perfbench import generate
from perfbench.reference import resnet20


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, BN state) in the program's tree, from ``seed`` on the
    device: every filter in one draw (He fan-in scale), every BN vector
    in one more."""
    gen = torch.Generator(device=device).manual_seed(
        generate.sub_seed(seed, 10))
    widths, blocks = cfg["widths"], cfg["blocks_per_stage"]
    filters = [("stem", None, (3, 3, cfg["in_channels"], widths[0]))]
    bns = [("bn_stem", None, widths[0])]
    cin = widths[0]
    for si, cout in enumerate(widths):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            filters += [(name, "conv1", (3, 3, cin, cout)),
                        (name, "conv2", (3, 3, cout, cout))]
            bns += [(name, "bn1", cout), (name, "bn2", cout)]
            if cin != cout:
                filters.append((name, "proj", (1, 1, cin, cout)))
                bns.append((name, "bn_proj", cout))
            cin = cout
    sizes = [h * w * i * o for _, _, (h, w, i, o) in filters]
    flat = torch.randn(sum(sizes) + cin * cfg["n_classes"], generator=gen,
                       device=device)
    n_bn = sum(c for _, _, c in bns)
    vec = torch.randn(4, n_bn, generator=gen, device=device)
    params: dict = {}
    state: dict = {}
    off = 0
    for (blk, key, shape), size in zip(filters, sizes, strict=True):
        fan_in = shape[0] * shape[1] * shape[2]
        w = flat[off:off + size].reshape(shape) * (2.0 / fan_in) ** 0.5
        off += size
        if key is None:
            params[blk] = w
        else:
            params.setdefault(blk, {})[key] = w
    params["fc"] = {
        "w": flat[off:].reshape(cin, cfg["n_classes"]) * cin ** -0.5,
        "b": torch.zeros(cfg["n_classes"], device=device),
    }
    off = 0
    for blk, key, c in bns:
        v = vec[:, off:off + c]
        off += c
        p = {"scale": 1.0 + 0.1 * v[0], "bias": 0.1 * v[1]}
        s = {"mean": 0.1 * v[2], "var": 1.0 + 0.4 * torch.tanh(v[3])}
        if key is None:
            params[blk], state[blk] = p, s
        else:
            params[blk][key] = p
            state.setdefault(blk, {})[key] = s
    return params, state


def program_config(cfg: dict):
    """The program's ResNetConfig and CIMPolicy from the file's numbers."""
    from repro_torch.configs.base import CIMPolicy
    from repro_torch.core.params import CIMConfig
    from repro_torch.models.resnet import ResNetConfig

    c = cfg["cim"]
    policy = CIMPolicy(
        mode=cfg["mode"],
        cim=CIMConfig(rows_active=c["rows_active"], act_bits=c["act_bits"],
                      weight_bits=c["weight_bits"], adc_bits=c["adc_bits"],
                      cutoff=c["cutoff"], adc_mode=c["adc_mode"],
                      vdd=c["vdd"], noisy=c["noisy"]),
        act_symmetric=cfg["act_symmetric"],
        act_clip_pct=cfg["act_clip_pct"],
        apply_to_logits=cfg["apply_to_logits"],
        apply_to_stem=cfg["apply_to_stem"],
    )
    return ResNetConfig(n_classes=cfg["n_classes"],
                        widths=tuple(cfg["widths"]),
                        blocks_per_stage=cfg["blocks_per_stage"], cim=policy)


def model_macs(cfg: dict, traffic: dict) -> int:
    """Multiply-accumulates one call (one forward) needs."""
    return resnet20.model_macs(cfg, traffic["batch"])


def macro_products(cfg: dict, traffic: dict) -> list[dict]:
    """The macro matmuls of one call: M, K, N, the input feature map's
    elements and the output's bytes per element (float32)."""
    return [dict(c, out_bytes=4)
            for c in resnet20.conv_shapes(cfg, traffic["batch"])
            if c["macro"]]


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, stages):
        from repro_torch.models import resnet

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.batch, self.pool_n = traffic["batch"], traffic["pool"]
        self.steps_per_call = 1
        with stages("weights"):
            self.params, self.bn = make_weights(cfg, seed, device)
        with stages("plan"):
            self.pcfg = program_config(cfg)
            self.planned = resnet.plan_params(self.params, self.pcfg.cim)
        with stages("inputs"):
            self.images, labels = generate.cifar_pool(
                cfg["n_classes"], self.batch, self.pool_n, traffic["noise"],
                seed, device)
            self.labels = labels.cpu()
        self._forward = resnet.forward
        self.logits: list[torch.Tensor] = []
        self.correct_top1 = 0
        with stages("warmup"):
            for i in range(traffic["warmup"]):
                self.call(i)
            self.logits.clear()
            self.correct_top1 = 0

    @torch.no_grad()
    def call(self, i: int) -> int:
        j = i % self.pool_n
        logits, _ = self._forward(self.planned, self.bn, self.images[j],
                                  self.pcfg)
        host = logits.cpu()
        self.correct_top1 += int((host.argmax(-1) == self.labels[j]).sum())
        self.logits.append(host)
        return self.batch

    # -- what one call does, for the per-layer metrics ----------------------

    def model_macs(self) -> int:
        return model_macs(self.cfg, self.traffic)

    def macro_products(self) -> list[dict]:
        return macro_products(self.cfg, self.traffic)

    # -- the check -----------------------------------------------------------

    def release(self) -> None:
        self.planned = None

    def _reference(self, tf32: bool):
        return resnet20.ResNet20(self.params, self.bn, self.cfg, tf32=tf32)

    def compare(self, picks: list[int], outputs=None) -> dict:
        """``logit_err``: the largest |logit - reference logit| over the
        picked batches, over the largest |reference logit| of its batch.
        ``outputs`` (call -> logits) puts other logits in the program's
        place (the control)."""
        ref = self._reference(tf32=False)
        worst = 0.0
        for i in picks:
            want = ref.forward(self.images[i % self.pool_n]).cpu()
            got = self.logits[i] if outputs is None else outputs[i]
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
        return {"logit_err": worst}

    def control_outputs(self, picks: list[int]) -> dict:
        """The reference with TF32 products in the program's place."""
        ref = self._reference(tf32=True)
        return {i: ref.forward(self.images[i % self.pool_n]).cpu()
                for i in picks}
