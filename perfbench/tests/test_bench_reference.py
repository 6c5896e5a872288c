"""The plain reference against the program (repro_torch) on the CPU at
small sizes: the macro matmul bit for bit, ResNet-20's logits bit for
bit, Qwen2's served logits and tokens."""

import dataclasses

import pytest
import torch

from perfbench import harness
from perfbench.adapters import lm as lm_adapter
from perfbench.adapters import resnet as resnet_adapter
from perfbench.reference import macro, qwen2, resnet20
from perfbench.tests.small import small_spec


@pytest.mark.parametrize("m,k,n", [(5, 16, 8), (33, 100, 24), (4, 300, 7)])
def test_macro_int_equals_program_b1(m, k, n):
    from repro_torch.core.params import PAPER_OP_16ROWS
    from repro_torch.core.pipeline import MacroSpec
    from repro_torch.kernels import cim_mac

    gen = torch.Generator().manual_seed(m * k + n)
    x = torch.randint(0, 16, (m, k), generator=gen, dtype=torch.int32)
    w = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int32)
    op = macro.OperatingPoint()
    spec = MacroSpec.from_config(PAPER_OP_16ROWS)
    want = cim_mac.gpq_matmul_plain(x, w.to(torch.int8), spec)
    assert torch.equal(macro.macro_int(x, w, op), want)


@pytest.mark.parametrize("dtype,symmetric,clip", [
    (torch.float32, True, 0.995), (torch.bfloat16, False, 1.0)])
def test_macro_linear_equals_program_execute(dtype, symmetric, clip):
    from repro_torch.configs.base import CIMPolicy
    from repro_torch.core import engine
    from repro_torch.core.params import PAPER_OP_16ROWS

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(40, 96, generator=gen).to(dtype)
    if symmetric:
        x = torch.relu(x)
    w = (torch.randn(96, 24, generator=gen) * 0.1).to(dtype)
    policy = CIMPolicy(mode="cim-kernel", cim=PAPER_OP_16ROWS,
                       act_symmetric=symmetric, act_clip_pct=clip)
    want = engine.execute(x, engine.plan_weights(w, policy=policy), policy)
    op = macro.OperatingPoint()
    got = macro.linear(x, macro.plan(w, op), op, symmetric=symmetric,
                       clip_pct=clip)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def test_resnet20_logits_equal_program():
    from repro_torch.models import resnet

    spec = small_spec("resnet20-cifar.eval-b256")
    cfg = dict(spec["config"], widths=[8, 16, 32], blocks_per_stage=2)
    params, bn = resnet_adapter.make_weights(cfg, 11, "cpu")
    pcfg = resnet_adapter.program_config(cfg)
    images = torch.randn(4, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(5))
    planned = resnet.plan_params(params, pcfg.cim)
    with torch.no_grad():
        want, _ = resnet.forward(planned, bn, images, pcfg)
    got = resnet20.ResNet20(params, bn, cfg).forward(images)
    assert torch.equal(got, want)
    # The control differs from the program.
    ctl = resnet20.ResNet20(params, bn, cfg, tf32=True).forward(images)
    assert not torch.equal(ctl, want)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0000005])
    got = resnet20.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


def test_qwen2_serving_equals_program():
    from repro_torch.models import transformer

    spec = small_spec("qwen2-0.5b.decode-b4")
    cfg = spec["config"]
    w = lm_adapter.make_weights(cfg, 13, "cpu")
    pcfg = lm_adapter.program_config(cfg)
    from repro_torch.core import engine

    params = engine.plan_params(lm_adapter.program_params(w),
                                policy=pcfg.cim)
    prompts = torch.randint(0, cfg["vocab_size"], (2, 12),
                            generator=torch.Generator().manual_seed(1))
    caches = transformer.init_caches(pcfg, 2, 16, device="cpu")
    with torch.no_grad():
        logits, _ = transformer.prefill(params, prompts, caches, pcfg)
        want, toks = [logits], [logits.argmax(-1)]
        for j in range(3):
            logits, _ = transformer.decode_step(params, toks[-1], 12 + j,
                                                caches, pcfg)
            want.append(logits)
            toks.append(logits.argmax(-1))
    want = torch.stack(want, 1)[..., :cfg["vocab_size"]].float()
    served = torch.stack(toks, 1)
    ref = qwen2.Qwen2(lm_adapter.reference_weights(w), cfg)
    got = ref.serve(prompts, served)
    assert torch.equal(got.argmax(-1), served)
    # bfloat16 logits: the prefill exactly, decode within one bf16 step of
    # the largest logit (attention over the cache sums in another order).
    assert torch.equal(got[:, 0], want[:, 0])
    step = 2.0 ** (torch.floor(torch.log2(want.abs().max())) - 7)
    assert (got - want).abs().max() <= step


def test_program_configs_are_the_ports_own():
    """The files' numbers give the port's qwen2-0.5b CONFIG (bfloat16
    weights, the benchmark's policy) and its ResNet-20 CONFIG under
    ``configs.resnet.cim_policy(mode="cim-kernel")``."""
    from repro_torch.configs import qwen2_0_5b, resnet, resnet20_cifar
    from repro_torch.core.params import PAPER_OP_16ROWS

    got = lm_adapter.program_config(
        harness.load_cell("qwen2-0.5b.decode-b4")["config"])
    assert got == dataclasses.replace(qwen2_0_5b.CONFIG, cim=got.cim,
                                      param_dtype="bfloat16")
    assert got.cim.mode == "cim-kernel" and got.cim.cim == PAPER_OP_16ROWS
    policy = resnet.cim_policy(mode="cim-kernel")
    got = resnet_adapter.program_config(
        harness.load_cell("resnet20-cifar.eval-b256")["config"])
    assert got == dataclasses.replace(resnet20_cifar.CONFIG, cim=policy)
