"""The paper's own workloads as dry-runnable configs.

NYTIMES mirrors the paper's small dataset (Table 2: 101,636 words, ~100M
tokens, K=1000); WEBCHUNK mirrors BingWebC1Mon (302,098 words, K=10,000)
with a 1M-document streaming window per iteration (the Spark analogue
holds partitions in executor memory; we hold one streamed doc window in
HBM — DESIGN.md §3.1).
"""
from repro_torch.configs.base import LDAArchConfig

NYTIMES = LDAArchConfig(
    name="zenlda-nytimes",
    num_words=101_636,
    num_topics=1000,
    docs_per_step=299_752,
    avg_doc_len=332,
    algorithm="zen_cdf",
    max_kd=128,
)

WEBCHUNK = LDAArchConfig(
    name="zenlda-webchunk",
    num_words=302_098,
    num_topics=10_000,
    docs_per_step=1_048_576,
    avg_doc_len=192,
    algorithm="zen_cdf",
    max_kd=128,
    delta_dtype="int16",  # §Perf l3: halves the count-sync collectives
    kd_dtype="int16",  # §Perf l4: halves every N_kd pass
)
