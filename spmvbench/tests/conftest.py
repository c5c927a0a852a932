"""Fixtures of the benchmark's own tests (``pytest spmvbench/tests``)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
