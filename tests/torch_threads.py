"""One intra-op thread for the port's CPU tests.

A test file that runs torch on the CPU imports the fixture, which pytest
then applies to every test of that file:

    from torch_threads import one_thread  # noqa: F401

The suite runs in several xdist workers on one machine's cores. Each
worker's torch would otherwise start an intra-op pool as wide as the
machine, and the steps these tests run are many small ops: six such pools
on eight cores made a run of `bench_torch.main` take minutes where it takes
seconds on one thread. The fixture is module-scoped, so the module-scoped
fixtures that build weights and engines run on one thread too (pytest sets
up an autouse fixture ahead of the other fixtures of its scope). The rank
processes of `parallel/launch.py` set their own count.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
