"""Shared fixture of the port's CPU tests: one torch intra-op thread.

The suite runs several pytest workers at once.  Torch's default of one
intra-op thread per core in every worker oversubscribes the cores, and
the port's ops at test sizes gain nothing from threads: a 12-frame
192x128 hier-B encode takes the same time on 1 thread as on 8 alone,
and many times longer on 8 beside other busy workers.  Results do not
depend on the thread count (integer and elementwise arithmetic)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
