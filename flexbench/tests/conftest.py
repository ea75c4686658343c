"""CPU tests of the benchmark harness: `python3 -m pytest flexbench/tests`
from the root of the repository. Tests that need the card carry the
`card` marker and skip, deciding inside the test, where there is none."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def cpu():
    """The port on the CPU, with one intra-op thread."""
    import torch

    from repro_torch import device
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = device.set_default("cpu")
    yield torch.device("cpu")
    device.set_default(prev)
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
