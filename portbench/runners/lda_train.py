"""The LDA training cells: ``TrainSession.step`` of ``repro_torch`` on the
single box, sweep after sweep, over a corpus drawn from the seed.

Set-up builds one session, initialises it from the seed and drives it
through the traffic's warm-up sweeps, which load every kernel and build
the plan's row orders. The window hands that same session on and steps
it until ``seconds`` have passed, keeping one sweep queued behind the one
on the card, and ends on a synchronize once the last sweep is done.
``train_tokens_per_s`` is every token of the window's sweeps over the
window's wall time.

The check (``reference.compare``) runs after the window, once the
session is freed: the sampled tokens' initial topics and first-sweep
draws against the reference worked out from the seed, the last sweep's
draws against the reference worked out from the program's topics before
it, and the final counts against a recount.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from portbench.reference import compare
from portbench.reference import hash as rhash
from portbench.reference.lda import Prior
from portbench.traffic.lda_corpus import lda_corpus

# keys of a configuration that go to the program's RunConfig
RUN_KEYS = ("algorithm", "max_kd", "kernels", "init")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int,
                 device):
        self.config, self.traffic, self.cell = config, traffic, cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.prior = Prior(num_topics=config["num_topics"],
                           alpha=config["alpha"], beta=config["beta"],
                           alpha_prime=config["alpha_prime"],
                           asymmetric=config["asymmetric_alpha"])
        self.session = self.state = None
        self.sweeps = 0  # every sweep run, warm-up included

    # -- set-up: build, then warm_up; each adds its parts' seconds --------
    def build(self, parts: dict) -> None:
        """Corpus, session and initial state."""
        cfg, tr, dev = self.config, self.traffic, self.device
        t = time.perf_counter()
        from repro_torch.core.types import Corpus, LDAHyperParams
        from repro_torch.train.session import RunConfig, TrainSession
        parts["import_program"] = time.perf_counter() - t

        t = time.perf_counter()
        word, doc, _ = lda_corpus(
            self.seed, cfg["num_docs"], cfg["num_words"], cfg["num_topics"],
            cfg["mean_doc_len"], tr["doc_prior"], tr["word_prior"], dev)
        self.word, self.doc = word, doc
        self.tokens = int(word.shape[0])
        sync(dev)
        parts["corpus"] = time.perf_counter() - t
        if dev.type == "cuda":
            # the generator's temporaries are not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        t = time.perf_counter()
        hyper = LDAHyperParams(num_topics=cfg["num_topics"],
                               alpha=cfg["alpha"], beta=cfg["beta"],
                               alpha_prime=cfg["alpha_prime"],
                               asymmetric_alpha=cfg["asymmetric_alpha"])
        run = RunConfig(eval_every=tr["eval_every"],
                        **{k: cfg[k] for k in RUN_KEYS})
        corpus = Corpus(word=word, doc=doc, num_words=cfg["num_words"],
                        num_docs=cfg["num_docs"])
        self.session = TrainSession(corpus, hyper, run, device=dev)
        sync(dev)
        parts["session"] = time.perf_counter() - t

        t = time.perf_counter()
        self.state = self.session.init(self.seed)
        self.sample = compare.sample_tokens(
            self.seed, self.tokens, tr["check_sample_tokens"], dev)
        self.init_sample = self.state.topic[self.sample].clone()
        sync(dev)
        parts["init"] = time.perf_counter() - t

    def warm_up(self, parts: dict) -> None:
        """The traffic's warm-up sweeps, through the window's own call; the
        first is the one the check follows from the seed."""
        if self.traffic["warmup_sweeps"] < 1:
            raise ValueError("a training cell warms up with a sweep or more")
        t = time.perf_counter()
        for _ in range(self.traffic["warmup_sweeps"]):
            self.step()
            if self.sweeps == 1:
                self.first_sample = self.state.topic[self.sample].clone()
        sync(self.device)
        parts["warmup"] = time.perf_counter() - t

    def step(self) -> None:
        self.state = self.session.step(self.state)
        self.sweeps += 1

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, mark=None) -> dict:
        """Sweeps until ``seconds`` have passed; ``mark`` (a span factory,
        or None) wraps each sweep for the trace."""
        dev = self.device
        cuda = dev.type == "cuda"
        span = mark or (lambda name: contextlib.nullcontext())
        sync(dev)
        start = self.sweeps
        queued = None
        t0 = time.perf_counter()
        while True:
            with span("portbench.sweep"):
                self.step()
            if cuda:
                done = torch.cuda.Event()
                done.record()
                if queued is not None:
                    queued.synchronize()
                queued = done
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        wall = time.perf_counter() - t0
        sweeps = self.sweeps - start
        return {"wall_s": wall, "sweeps": sweeps,
                "end_to_end": {"train_tokens_per_s":
                               sweeps * self.tokens / wall}}

    def shape(self) -> dict:
        cfg = self.config
        return {"tokens": self.tokens, "words": cfg["num_words"],
                "docs": cfg["num_docs"], "topics": cfg["num_topics"]}

    # -- after the window -------------------------------------------------
    def release(self) -> None:
        """Keep the program's outputs, free the rest of the session."""
        st = self.state
        self.out = {k: getattr(st, k) for k in
                    ("topic", "prev_topic", "n_wk", "n_kd", "n_k")}
        self.session = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared, by name (``reference.compare``)."""
        cfg, out, k = self.config, self.out, self.config["num_topics"]
        corpus = (self.word, self.doc, cfg["num_words"], cfg["num_docs"])
        sampler, max_kd = cfg["sampler"], cfg["max_kd"]
        nums = {"init": compare.init_mismatch(self.seed, self.sample,
                                              self.init_sample, k)}
        z0 = rhash.initial_topics(
            self.seed, torch.arange(self.tokens, device=self.device), k)
        nums["first_sweep"] = compare.draw_mismatch(
            sampler, self.sample, self.first_sample, corpus, z0, self.prior,
            self.seed, 0, max_kd)
        del z0
        nums["last_sweep"] = compare.draw_mismatch(
            sampler, self.sample, out["topic"][self.sample], corpus,
            out["prev_topic"], self.prior, self.seed, self.sweeps - 1,
            max_kd)
        nums["counts"] = compare.count_mismatch(
            corpus, out["topic"], out["n_wk"], out["n_kd"], out["n_k"], k)
        return nums
