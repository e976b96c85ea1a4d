"""The benchmark's own tests: CPU tests at smoke size, and card tests
(marker ``card``) that decide inside the test whether a card is there and
skip with a reason when it is not.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skips where none is present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device; the test skips where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -q bench/tests -m card`")
    return torch.device("cuda")
