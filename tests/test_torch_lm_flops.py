"""``repro_torch.launch.roofline.model_flops`` against the reference's for
the ten LM configs under the train, prefill and decode shapes and the two
LDA configs, and ``repro_torch.utils``'s tree counts against
``repro.utils``'s."""
import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch.roofline import model_flops as ref_model_flops
from repro.models import model as R
from repro.utils import tree_bytes as ref_tree_bytes
from repro.utils import tree_param_count as ref_param_count
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.roofline import model_flops
from repro_torch.models import model as P
from repro_torch.utils import tree_bytes, tree_param_count

SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", list_archs(lm_only=True))
def test_model_flops_equal_reference(arch, shape):
    want = ref_model_flops(ref_config(arch), REF_SHAPES[shape])
    assert model_flops(get_config(arch), SHAPES[shape]) == want


@pytest.mark.parametrize("name", ["zenlda-nytimes", "zenlda-webchunk"])
def test_lda_model_flops_equal_reference(name):
    assert model_flops(get_config(name), None) == \
        ref_model_flops(ref_config(name), None)


def test_tree_counts_equal_reference():
    """A smoke model's parameters, as the reference's tree and as the
    port's LM (and as numpy leaves in nested dicts): the same count and
    bytes (bf16 leaves 2 bytes each)."""
    tree = R.init_params(jax.random.key(0), ref_config("qwen3-8b-smoke"))
    lm = P.init_params(0, get_config("qwen3-8b-smoke"), device="meta")
    assert tree_param_count(lm) == ref_param_count(tree)
    assert tree_bytes(lm) == ref_tree_bytes(tree)
    host = jax.tree.map(np.asarray, tree)
    assert tree_param_count(host) == ref_param_count(tree)
    assert tree_bytes(host) == ref_tree_bytes(tree)
