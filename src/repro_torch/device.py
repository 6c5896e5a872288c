"""The device an entry point runs on, and full float32 on the card.

Entry points run on the card unless the caller asks for the CPU;
``resolve`` turns the asked-for name into a ``torch.device`` and refuses
a CUDA device where there is none. ``full_float32`` turns TF32 off for
matmuls and cuDNN while it is open (a context manager, or a decorator
when called), so float32 paths on the card round as on the CPU, and
restores the flags after.
"""

from __future__ import annotations

import contextlib

import torch


def resolve(name: str, *, error: type[Exception] = RuntimeError
            ) -> torch.device:
    """``name`` as a torch.device. A CUDA device where
    ``torch.cuda.is_available()`` is false raises ``error`` (command
    lines pass ``SystemExit``)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise error(f"{device} was asked for, and no CUDA device is "
                    "available (torch.cuda.is_available() is false); ask "
                    "for 'cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_float32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
