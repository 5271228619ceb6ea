"""On the card: the harness's whole run at a small size through the CUDA
kernels, sound and with a fault planted. Skips without a card; the
``gpu`` marker is the repository's (``tests/conftest.py``)."""
import pytest

from portbench.tests import tiny


@pytest.fixture()
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


SIZES = dict(num_words=5000, num_docs=2000, mean_doc_len=100,
             num_topics=256)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault",
                         [None, "altered_draw", "altered_count", "control"])
def test_run_on_the_card(cuda_device, cell, fault):
    result, lines = tiny.run(cell, seconds=0.5, fault=fault, traced=1,
                             device=cuda_device, **SIZES)
    assert result["correct"] is (fault is None), lines
    assert result["device"]["busy_s"] > 0
