"""The port's CPU test modules run PyTorch in one intra-op thread.

The suite runs six test files at once (``pytest -n 6 --dist loadfile``) on a
machine of a few cores. PyTorch spreads each CPU op over every core by
default, so six workers oversubscribe the CPU several times over and its
OpenMP barriers stall: the ResNet graph's initializer ran ~10x slower in a
worker beside five others than alone. A module imports the fixture below
(``from torch_threads import one_torch_thread  # noqa: F401``) to run in one
thread, or wraps a part in :func:`one_thread`; the count is restored after.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with one_thread():
        yield
