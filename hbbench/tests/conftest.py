"""The benchmark's tests: CPU ones at small sizes, and ``card`` ones that run
only where a CUDA device is (each decides inside the test)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config: pytest.Config) -> None:
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh_featurizer():
    """Each test builds the program's shared featurizer on its own seeded weights."""
    from heybuddy_tpu_torch.models import featurizer

    featurizer._GLOBAL_EMBEDDINGS.clear()
    yield
    featurizer._GLOBAL_EMBEDDINGS.clear()
