"""Fixtures shared by the port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none.
    Decided here at run time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")
