import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the test workers share the machine's
    cores, and torch's threads in each of them would oversubscribe it (a
    small decode step then takes seconds, and a window serves none)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
