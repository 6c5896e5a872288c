"""``models.resnet.im2col`` on the card: the launches a conv's patches take.

Marked ``card`` (skipped without a CUDA device; run on the card with
``PYTHONPATH=src python -m pytest --noconftest -q
tests/test_torch_resnet_card.py``, since ``tests/conftest.py`` imports JAX):
one ``im2col`` call issues the same few device operations at batch 4 and
at batch 64 (the pad and one gather, never ATen's per-image
``im2col_kernel``), and its output equals the CPU's bit for bit. The CPU
tests of the patches against the JAX reference are in
``tests/test_torch_resnet.py``.
"""

import pytest
import torch

from repro_torch.models import resnet


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _traced_im2col(x, kernel_hw, stride):
    """One ``im2col`` under the profiler: its output and the names of the
    device operations it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    resnet.im2col(x, kernel_hw, stride)  # warm up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = resnet.im2col(x, kernel_hw, stride)
        torch.cuda.synchronize()
    ops = [ev.name() for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA]
    return out, ops


@pytest.mark.card
@pytest.mark.parametrize("kh,stride", [(3, 1), (3, 2), (1, 2)])
def test_im2col_launches_do_not_grow_with_the_batch(card, kh, stride):
    gen = torch.Generator().manual_seed(3)
    counts = {}
    for b in (4, 64):
        x = torch.randn((b, 32, 32, 16), generator=gen)
        out, ops = _traced_im2col(x.to(card), (kh, kh), stride)
        assert len(ops) <= 3, ops
        assert not any("im2col_kernel" in name for name in ops), ops
        counts[b] = len(ops)
        assert torch.equal(out.cpu(), resnet.im2col(x, (kh, kh), stride))
    assert counts[4] == counts[64]
