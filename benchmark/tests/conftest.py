import pytest
import torch

# the rehearsals run a loader's threads beside the model: a few threads a
# test process keep several such processes from thrashing one machine
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """The card, decided when a test asks for it: a test that needs one skips
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
