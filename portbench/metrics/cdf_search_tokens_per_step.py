"""cdf_search_tokens_per_step (tokens): the tokens kernel 7 queues for a
walk in a sweep (target > 0: the draws that take term 2, over both draws
of every token), its real work, from the program's counter
``zen_cdf.search_tokens`` (counted in ``cdf_compact_kernel``). Layer: the
kernels (``kernels/csrc/cdf_search.cu``)."""
from portbench.metrics._program_trace import count_per_sweep


def read(record):
    return count_per_sweep(record, "zen_cdf.search_tokens")
