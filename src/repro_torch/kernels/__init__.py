"""Hand-written Hopper kernels and their plain torch versions.

``ops`` holds the public wrappers (re-exported here); a CPU tensor runs
the plain version, a CUDA tensor launches the kernel built from ``csrc/``
by ``_build`` at its first launch (importing the package builds nothing).
``autotune`` is the reference's tile autotuner (one launch per kernel).
"""
from repro_torch.kernels.ops import (  # noqa: F401
    cdf_draws,
    cdf_remedy,
    cdf_row_search,
    cdf_uniforms,
    doc_row_search,
    sparse_row_sample,
    topic_histogram,
    zen_fused_infer_sample,
    zen_fused_sample,
    zen_infer_sample,
    zen_sample,
)
