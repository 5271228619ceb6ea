"""merge_changed_tokens_per_step (tokens): the tokens whose topic
changes in a sweep's merge, kernel 5's useful work, from the program's
counter ``counts.changed_tokens`` (counted by the kernel on its word-side
call; with torch ops on the plain route). Layer: the counts."""
from portbench.metrics._program_trace import count_per_sweep


def read(record):
    return count_per_sweep(record, "counts.changed_tokens")
