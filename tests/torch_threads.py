"""A test module that imports ``one_torch_thread`` runs each of its tests
with torch on one CPU thread (restored after). The port's tests run
small tensors, where the per-op cost of a thread team dominates: under
the suite's six test workers on an 8-core host, Word2Vec's 1,500 steps
took 22 s on the default team and 0.5 s on one thread."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
