"""The benchmark's own tests (``python -m pytest perfbench/tests`` from the
repository root). They import the program from ``src/``; those marked
``card`` need a CUDA device and skip without one."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(1)
