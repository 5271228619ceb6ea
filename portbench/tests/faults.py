"""Faults planted underneath a run, for the tests that show ``correct``
coming out false (``test_portbench_faults.py``, ``test_portbench_gpu.py``).
Never used by a benchmark run.

* ``unchanged``: the step returns its state unchanged;
* ``half``: half of the tokens (every other one) keep their old topic;
* ``altered_draw``: one token in 64 gets the topic after its draw;
* ``altered_count``: the delta merge adds one to N_wk[0, 0];
* ``control``: the control in the program's place: every sweep's draws
  are the plain reference's, computed in bfloat16 (the precision below
  the configuration's float32) from the state's topics and a recount.

A one-chip cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

from portbench import registry

FAULTS = ("unchanged", "half", "altered_draw", "altered_count", "control")
CONTROL_DTYPE = "bfloat16"


def runner(name: str, config, traffic, cell, seed, device):
    """The cell's ``Runner`` with fault ``name`` planted in its session from
    the end of ``build`` to ``release``: the set-up's warm-up sweeps and
    the window run with it, the check after it."""
    base = registry.runner(config["runner"]).Runner

    class Planted(base):
        def build(self, parts):
            super().build(parts)
            self._planted = contextlib.ExitStack()
            self._planted.enter_context(planted(name, self))

        def release(self):
            self._planted.close()
            super().release()

    return Planted(config, traffic, cell, seed, device)


def control_sweep(run):
    """A ``plan.sweep`` that draws every token by the reference in
    ``CONTROL_DTYPE``."""
    import torch

    from portbench.reference import compare, lda

    cfg = run.config
    corpus = (run.word, run.doc, cfg["num_words"], cfg["num_docs"])
    every = torch.arange(run.tokens, device=run.device)
    low = getattr(torch, CONTROL_DTYPE)

    def sweep(state):
        n_wk, n_kd, n_k = lda.counts(run.word, run.doc, state.topic,
                                     cfg["num_words"], cfg["num_docs"],
                                     cfg["num_topics"])
        z = compare.reference_draws(
            cfg["sampler"], every, corpus, state.topic, n_wk, n_kd, n_k,
            run.prior, run.seed, int(state.iteration), cfg["max_kd"], low)
        return z.to(state.topic.dtype)

    return sweep


@contextlib.contextmanager
def planted(name: str, run):
    """Plant fault ``name`` in runner ``run``'s session while the block
    runs (between ``Runner.build`` and ``Runner.release``)."""
    plan = run.session.plan
    k = run.config["num_topics"]
    if name == "unchanged":
        plan.step = lambda state: state
    elif name == "control":
        plan.sweep = control_sweep(run)
    elif name in ("half", "altered_draw"):
        sweep = plan.sweep

        def broken(state):
            z = sweep(state).clone()
            if name == "half":
                z[::2] = state.topic[::2]
            else:
                z[::64] = (z[::64] + 1) % k
            return z

        plan.sweep = broken
    elif name == "altered_count":
        from repro_torch.core import counts

        merge = counts.delta_counts

        def broken_merge(*args, **kwargs):
            d_wk, d_kd, d_k = merge(*args, **kwargs)
            d_wk = d_wk.clone()
            d_wk[0, 0] += 1
            return d_wk, d_kd, d_k

        counts.delta_counts = broken_merge
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        if name == "altered_count":
            counts.delta_counts = merge
        else:
            for attr in ("step", "sweep"):
                plan.__dict__.pop(attr, None)
