"""JPEG sampling factors 3 and 4 decoded on the card. Marked ``cuda``;
the test skips where no CUDA device is present (decided inside the
fixture). It imports the port and the fixtures' manifest only, so it runs
on a GPU host without JAX or PIL:

    python -m pytest tests/test_torch_small_data_cuda.py -m cuda --noconftest

Tolerance: the card's JPEG decode within one level of the host's (the same
float arithmetic in another order). WebP and the small datasets have no
card stage of their own (a host decode or read, then a copy), so nothing of
theirs is checked here; ``chip_smoke.py`` feeds them to models on the card.
"""

import pytest
import torch

from vision_tpu_torch.io import decode_jpeg
from torch_io_fixtures import DATA, SAMPLING

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    return torch.device("cuda")


def test_sampling_factors_3_and_4_decode_within_a_level_of_the_host(dev):
    streams = [(DATA / n).read_bytes() for n in sorted(SAMPLING)]
    for data, card in zip(streams, decode_jpeg(streams)):
        host = decode_jpeg(data, device="cpu").expand(3, -1, -1)
        assert card.device.type == "cuda"
        assert (card.cpu().int() - host.int()).abs().max() <= 1
