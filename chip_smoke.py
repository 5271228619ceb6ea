#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its mesh plan,
sharded serving and router, the compare CLI, the examples, the LM zoo's
serving and training paths, the kernels' launch shapes and the
``LDATrainer`` shims on one CUDA card, and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds ``src/repro_torch/kernels/csrc/zen_infer.cu``,
   ``zen_train.cu``, ``sparse_row.cu``, ``cdf_search.cu`` and
   ``topic_histogram.cu`` for sm_90a, one nvcc each, in parallel (prints
   the ``-Xptxas -v`` summary);
3. kernels — both serving kernels at NYTIMES width (W = 101,636,
   K = 1000) on one full bucket sweep (32 slots x 512 = 16,384 tokens) of
   random counts: the fused kernel must be bit-equal to the gathered one
   and to the exact loop (``zen_infer_exact``: the exact chain for every
   (t, k), one warp per token, as the kernels ran before their redesign),
   and both may differ from the plain torch version on the card only at
   counted near-ties (top two scores within 1e-4) on at most 1e-4 of
   tokens; CUDA-event times of kernels, exact loop and plain version, the
   kernels' stats (topics scored exactly, exact-loop tokens), the fast
   loop's and the exact chain's SASS per (t, k), and the bounds;
4. serving — a planted NYTIMES-width model (each word one dominant topic,
   ~12M tokens of counts) saved with ``save_lda_model``, loaded back with
   ``FrozenLDAModel.from_checkpoint``, and 256 documents of Poisson(332)
   tokens served through ``LDAEngine`` with ``zen_pallas``: throughput mode
   on the fused kernel, throughput mode on the gathered kernel
   (``kernels="off"``), latency mode (RT-LDA), then 64 documents through
   ``zen_cdf``'s frozen CDF tables. Every theta must be
   finite and sum to 1, the top topic must match the planted one on at
   least 90% of single-topic documents, the two throughput runs' thetas
   must equal ``SERVE_RECORD`` (taken before the kernels' redesign), and
   latency-mode assignments must equal those of the same engine on the
   CPU for a sample of documents.
   Each run's launch counts are zeroed after its warm-up and read right
   after its serving window: a throughput run must launch its own kernel
   and no other, and the latency and zen_cdf runs (no kernel) none. Then
   both serving kernels on the fused run's own inputs (its 10th launch at
   the widest bucket, captured from a repeat of the run), checked and
   timed as in phase 3; the serving adversarial grid
   (``SERVE_ADVERSARIAL``: +inf noise, also at a z_old clamped at p =
   1e-30, the forced bucket, exact ties in the bucket, across two lanes
   and in one lane, the engine's padding positions, the clamp, K = 1, 5,
   37 and 36, inputs outside the premise, and K = 14,464, 14,592 and
   16,385 about the table's move to global memory), each at 0 mismatches
   against the exact loop with fused == gathered; and the serving
   estimate's margin premises checked by exhaustion;
5. train_kernels — both training kernels at NYTIMES width on the first
   1,048,576 tokens of the corpus below after init (the gathered rows are
   8.4 GB): fused bit-equal to gathered, each bit-equal to its plain
   version (0 mismatches); CUDA-event times, the bytes, the MUFU and hash
   operations, the fast loop's instructions per (t, k) read from
   ``cuobjdump -sass``, the share of (t, k) scored exactly (the kernel's
   stats output), and the bounds. Then the adversarial grid
   (``ADVERSARIAL``: +inf noise, the forced top bucket, equal-count rows
   with exact ties, p at the 1e-30 clamp, K = 37, 36 and 10,000, inputs
   outside the estimate's premise, and K = 14,464, 16,384 and 16,385
   about where the per-topic table moves from shared to global memory),
   each at 0 mismatches with fused == gathered; the estimate's margin
   premises checked by exhaustion; and the fused kernel timed on both
   sides of that placement boundary (K = 14,464 and 14,592);
6. train   — ``TrainSession`` with ``zen_pallas`` (``kernels="auto"``) on
   the corpus ``launch.train --topics 1000 --synthetic-docs 299752
   --synthetic-words 101636 --synthetic-len 332`` builds (~99.5M tokens):
   random init, 5 iterations with an eval at init and after each one;
   count invariants after every step, predictive llh rising at every eval,
   change rate in (0, 1), the llh and change-rate lists equal to
   ``RECORD`` (no redesign may change a draw), exactly 5 fused launches
   and 10 of kernel 5 (the delta merge: word and doc rows per step) and
   no other, then ``save_model`` read back bit-equal; one more step
   profiled;
7. train_small — the same recipe at 4,096 documents (~1.36M tokens) and
   the same initial topics, 3 iterations of ``zen`` (plain torch, cdf),
   ``std``, ``zen_pallas`` fused and ``zen_pallas`` gathered
   (``kernels="off"``): fused and gathered topics bit-identical after every
   iteration, each run launching only its own kernel (``zen`` and ``std``
   none) and, under ``kernels="auto"``, kernel 5 twice per step, the fused
   run's per-token llh equal to ``TRAIN_SMALL_LLH``, ``zen``'s within 1%
   of it and ``std``'s within 1% of ``zen``'s;
8. train_sparse — this slice's path at full width: ``TrainSession`` with
   ``zen_sparse`` and the paper's sparse word initialisation (degree 0.1)
   on the same NYTIMES corpus: 3 iterations, an eval at init and after
   each; count invariants after every step, llh rising at every eval, the
   lists equal to ``RECORD``, and launches of the sparse-row kernel (> 0)
   and of kernel 5 (2 per step) only. Reports the row widths of
   every sweep, seconds per step and the table build within it (timed
   apart on the same state), peak memory, and one more step profiled;
9. sparse_kernels — kernel 6 against its plain version on the first
   1,048,576 tokens of that state, on the term-3 rows (J = max_kd) and on
   SparseLDA's q rows (J = max_kw): topics equal with 0 mismatches, CUDA-
   event times and the bytes bound;
10. train_cdf — ``TrainSession`` with ``zen_cdf`` (``kernels="auto"``,
   max_kd 64) on the same NYTIMES corpus from a random init: 3 iterations,
   an eval at init and after each; count invariants after every step, llh
   rising at every eval, the lists equal to ``RECORD``, and launches of
   the CDF row search (kernel 7, two per token chunk) and of kernel 5 (2
   per step) only. Reports seconds per step, peak memory and one more
   step profiled;
11. histogram — kernel 5 on that run's last step as the delta merge of
   every backend runs it under ``kernels="auto"``: doc rows in the corpus
   order (checked sorted), R = 299,752, and word rows along the session's
   word-major walk, R = 101,636. ``delta_counts`` on the kernel equals
   ``delta_counts`` under ``kernels="off"`` (the plain version), and each
   side is bit-equal to the plain version, also walked without its order;
   CUDA-event times of the kernel, the plain version (two ``index_put_``)
   and both ``delta_counts`` routes, the bytes bound, the SASS loop and
   ``-res-usage`` figures;
12. cdf_kernels — kernel 7 on the first 1,048,576 tokens of the zen_cdf
   state, on the path's term-2 targets of draw a and on targets uniform
   over each word's row: bit-equal to its plain version (0 mismatches),
   CUDA-event times of the kernel, the plain version and the
   ``kernels="off"`` route (the ``w_cdf`` build and its ``log K`` search),
   the bytes, operation and instruction-issue bounds, the SASS loop and
   ``-res-usage`` figures;
13. train_sparse_small — the train_small corpus and one set of initial
   topics, 3 iterations each of ``zen_sparse``, ``sparselda``,
   ``zen_hybrid``, ``lightlda`` (kernel) and ``lightlda`` with
   ``kernels="off"`` (per-word alias tables), ``zen_cdf`` (kernel 7) and
   ``zen_cdf`` with ``kernels="off"``, and ``zen``: invariants after every
   step, each run's per-token llh within 8% of ``zen``'s, every run
   launching only its own kernel (``lightlda`` off, ``zen_cdf`` off and
   ``zen`` none) and, under ``kernels="auto"``, kernel 5 twice per step.

14. stream — the live pipeline on the train corpus (``ReplaySource``,
   32,768-document windows: 10 per epoch, the last of 4,840; 2 sweeps per
   window): (1) rotation, ``zen_pallas`` fused, decay 0: 12 windows (one
   epoch, then w0 and w1 again on their retained topics), a model
   checkpoint every 4 windows; after the first, a throughput ``LDAEngine``
   (``zen_pallas`` fused, buckets (128, 256, 512), 32 slots, 10 sweeps)
   serves it under its background ticker, follows the directory
   (``watch_checkpoint_dir``, period 0.2 s) and a client thread keeps 64
   corpus documents in flight; the stream's callback waits (60 s at most)
   for each later checkpoint's reload. Checks: ``n_k == n_wk.sum(0)``,
   counts >= 0 and every token counted once after every window, finite
   window perplexities, the final counts bit-equal to
   ``assembled_state()``'s, every theta finite, versions never decreasing
   within a bucket and the last request's >= 2, launches of kernels 2, 5
   and 4 and none of the gathered ones; then one more window profiled.
   (2) decay 0.02, ``zen_cdf`` (max_kd 64), 4 fresh windows: the count
   checks, one transition's device decay equal to ``np.rint`` on the host
   in float64, kernels 7 and 5 launched. (3) resume, the first 65,536
   documents in 16,384-document windows: 6 windows straight, against 3
   windows with a stream checkpoint and a new session resuming to 6:
   counts, cursors and retained topics bit-equal. (4) kernel 2 on the
   inputs of a 32,768-document window's first sweep, captured from the
   session's call, against its plain version: every draw equal; then 2
   windows of 8,192 documents under ``kernels="auto"`` (the fused path:
   kernels 2 and 5) and ``"off"`` (the gathered path: kernel 1 and the
   plain merge): bit-equal counts and retained topics, equal window llh.
   After leg 1 the following engine, trainer idle and watcher stopped, is
   timed at the stream client's load and at the serving phase's (256
   documents at once, under the ticker and stepped inline), as a control
   for the serving rate beside the trainer. Per window it prints
   milliseconds by phase (host slice; then decay, copy with the plan,
   compose and sweeps between CUDA events; eval and retire on the host
   clock), docs/sec and tokens/sec; per leg the model-save times, the
   reload latency from a checkpoint's commit to the version bump, serving
   docs/sec and peak device memory.

15. quality (runs right after ``train``) — quality evaluation and
   telemetry on the train cell: ``CoherenceStats`` of the 99.5M-token
   corpus (NPMI window 10) timed alone with its peak device memory; then
   ``TrainSession.run`` with ``zen_pallas``, an eval and a quality eval
   (top 10 words, 100 left-to-right documents of 20 particles) after
   every iteration and a ``train_iter`` record per iteration into a JSONL
   under ``build/`` (removed after). The llh and change-rate lists must
   equal ``RECORD["train"]`` (quality and telemetry are read-only), the
   launches those of ``train``, the JSONL one record per iteration. It
   prints seconds per quality eval, one eval split into top words, UMass,
   NPMI and left-to-right (with its near-tie count per document; the
   same sweep on the host must agree within 1e-10 relative on every
   document without one), milliseconds per telemetry record. A trained
   model's top words on this corpus are a dozen head words, so the eval
   is also timed, with the peak device memory of UMass and NPMI, on a
   top-word union of several thousand words spread over every frequency
   band (``planted_top_counts``). D(w), D(w, w') and the window counts of
   1,000 seeded pairs of the trained model's top words and 1,000 pairs of
   that union, drawn across frequency bands (``banded_pairs``), are
   checked against a direct per-pair version on the card
   (``plain_pair_counts``: per-word document sets and window-interval
   unions). train_autopilot: the same init with the autopilot every 2 of 4
   iterations: its decisions, the backend it moves to, seconds per
   iteration on each side, count invariants after every step, and each
   iteration's launches checked for the backend that ran it;
16. serve_autopilot (runs after the serving adversarial grid) — the
   serving phase's model and 256 documents through an engine under its
   ticker, submissions 2 ms apart: telemetry off, then telemetry and the
   autopilot on (windows of 16 arrivals), then the documents cut to 32
   tokens in two bursts, so the autopilot's recut of the wide grid is
   applied when the grid drains. docs/sec, p50/p99, every decision and
   whether it was applied, every bucket swap (no request admitted and
   unfinished at it; a request still queued must finish on the new grid
   as its decode alone does), finite thetas and launches of kernel 4
   only. Then the recut grid is swapped under traffic, stepped inline
   (``swap_across_traffic``): the grid must hold while a request is in
   flight, requests queued at the swap are cut to the new widest bucket,
   and every theta must equal its document's decode alone with the same
   key on the grid it finished on.

17. mesh_one (runs after the stream phase) — a world of one under NCCL:
   ``TrainSession`` with ``mesh_shape=(1, 1)`` on the train corpus
   (``grid_partition`` timed apart), ``zen_pallas`` fused, 3 iterations:
   count invariants after every step, the change-rate list equal to
   ``RECORD["train"]``'s first 3 entries and the llh after the third to
   its record within 1e-12 relative (float64 sums of the same float32
   terms), kernels 2 and 5 launched 3 and 6 times. Milliseconds per
   step split into sweep, merge (kernel 5) and the two all-reduces, peak
   memory;
18. mesh_four — 4 gloo ranks sharing the card on a (2, 2) grid: the grid
   partitioned once here and handed to the ranks as memory-mapped
   ``.npy`` files under ``build/``; 2 iterations; count invariants after
   every step; the final counts and topics, gathered and un-permuted,
   equal (by SHA-256, on every rank) a ``zen_pallas`` single box over the
   corpus declared at (W_pad, D_pad) with the same key. Per rank: seconds
   per iteration split into sweep, kernel 5 and the N_w|k and N_k|d
   all-reduces with their bytes, peak memory, launches (2 and 4);
19. sharded_serve (runs after serve_autopilot) — the fused throughput
   run's model, documents and keys at ``mesh_shape`` (1, 2) and (1, 4):
   thetas equal to ``SERVE_RECORD["throughput_fused"]``, kernel 4
   launched m times the unsharded run's count; docs/sec, p50 / p99;
20. router — 2 replicas behind ``LDARouter``, each request under the
   key the single engine derives for it: the same digest, both replicas
   at work, docs/sec; then a broadcast ``reload`` (the same counts, a
   new version) while the first admissions decode: nothing dropped,
   every ticket on the version it was admitted under, the digest again;
21. configs (runs first, after the device line) — NYTIMES's W, K, D and
   mean document length from ``repro_torch.configs``
   (``get_config("zenlda-nytimes")``; every phase reads its widths from
   there), the NYTIMES and WEBCHUNK records and their ``tokens_per_step``;
22. compare (runs after mesh_four) — ``repro_torch.launch.compare.main``
   with ``--sessions`` on two RunConfig JSONs, ``zen_pallas`` and
   ``zen_cdf`` (max_kd 64), 3 iterations each, ``--topics 1000
   --synthetic-docs 299752 --synthetic-words 101636 --synthetic-len 332
   --eval-every 1`` and the train cell's seed: the train cell's corpus and
   init, so its printed llh of iterations 1-3 must equal
   ``RECORD["train"]`` and ``RECORD["train_cdf"]`` at the table's
   precision; each session's wall seconds and launches (kernels 2 and 5,
   kernels 7 and 5) are recorded and checked;
23. examples — ``examples/quickstart_torch.py`` (the llh rises at every
   eval, counts conserved), ``examples/distributed_lda_torch.py --devices
   4`` (four gloo ranks sharing the card, in a process of their own:
   ``count conservation: True``) and ``examples/train_nytimes_lda_torch.py``
   at its default size, 100 iterations straight and 50 then resumed to 100
   (the topics' SHA-256 equal), each on its default device, the card;
   wall seconds of each; kernel 5 on every step of the two in-process
   examples (``zen``) and no other kernel;
24. lm_serve (runs last) — the LM zoo's serving path: qwen3-8b from
   ``repro_torch.configs`` at its published widths and full depth (36
   layers, d_model 4096, 32 heads, 8 KV heads, d_ff 12,288, vocab
   151,936), bf16, random weights from the seed; its parameter count
   equal to the reference's (``LM_PARAMS``); 16 requests of 16-64 prompt
   tokens and 32 new tokens each through ``ServingEngine`` (8 slots of
   1,024 positions, greedy), every decode call recorded: the fed tokens
   are what the engine's admission rule makes of the prompts and outputs,
   each output the argmax of its own logits, the shared cache length
   below 1,024, and a replay from a fresh cache emits every token again;
   tokens/sec, decode-call ms p50/p99 against the weight-read bound, peak
   memory, a profiled step, no LDA kernel launched. Then prefill + decode
   == forward at full width with 4 layers in float32, the ten ``-smoke``
   configs on the card == on the CPU (forward, 8 decode steps, every
   cache leaf; 1e-4), and ``examples/serve_lm_torch.py`` on the card;
25. lm_train (runs after lm_serve) — LM training: qwen3-8b at its
   published widths, depth cut to 16 layers (4,332,855,296 parameters,
   the reference's count), bf16, the config's AdamW (``OptConfig(
   learning_rate=1e-3)``, the example's) and ``nothing_saveable`` remat,
   12 steps of 4 x 1,024 tokens from ``examples/train_lm_torch.py``'s
   generator: the loss finite at every step and the mean of the last 4
   below the first; step ms p50 / p99 (synchronised), tokens/sec, MFU
   (``model_flops``' 6·N·T over the step time and 989 TFLOP/s), peak
   memory against the 12-byte-a-parameter state, one profiled step. Then
   (a) at full width, 2 layers, float32: the three remat policies' loss
   and grads (bit-equal, or the largest gap) and peak memory; (b) the
   same, 1 against 4 microbatches, parameters after one step within
   2e-3; (c) the ten ``-smoke`` configs in float32, one train step on the
   card == on the CPU (loss, every grad, the parameters after it; 1e-4),
   each with its own optimizer; (d) ``TrainLoop`` on ``qwen3-8b-smoke``
   with parameters, optimizer state and step in the checkpoint tree:
   stopped at 6 and resumed to 12 == 12 straight, bit for bit; (e)
   ``examples/train_lm_torch.py`` on the card at its defaults. None of
   the seven kernels may launch.
26. lm_dryrun (runs after lm_train) — the torch dry-run
   (``repro_torch.launch.dryrun``): (a) qwen3-8b's train_4k, prefill_32k
   and decode_32k cells on the 16 x 16 and 2 x 16 x 16 production meshes
   and zenlda-nytimes on 16 x 16, each traced as rank 0 of a fake process
   group on ``meta`` tensors with the mesh's device type ``cuda``: every
   record (per-device flops, bytes, collective bytes, memory, trace
   seconds) and the roofline table's rows; (b) lm_train's cell (16
   layers, 4 x 1,024 tokens, AdamW) traced on a (1, 1) mesh against the
   real step on the card: its flops == ``FlopCounterMode`` over the
   first step's forward and backward (AdamW counts none), its peak
   within 15% of the first step's ``max_memory_allocated``; (c) the
   same state as DTensors on a one-rank NCCL (1, 1) mesh, two steps: loss
   and every parameter bit-equal to the plain steps' (or within 1e-5
   relative, the leaf named), each step timed beside the plain one; (d)
   the LDA cell at mesh_four's blocks: its collective bytes == the bytes
   mesh_four's steps all-reduced a rank. None of the seven kernels may
   launch.
27. autotune — each kernel's block shape against the others, each built
   from its source with ``-D`` (``_build.variant``, all built at once
   after the main build): kernels 1-2 at 8, 16 and 32 warps per block on
   train_kernels' inputs (T = 1,048,576, K = 1000), kernel 6 at 2, 4, 8
   and 16 warps on sparse_kernels' term-3 rows, kernel 7 at 128, 256 and
   512 threads on cdf_kernels' path targets (each leg runs inside its
   phase, on its inputs): every shape's draws (and kernels 1-2's
   exact-work stats) equal to the default shape's, CUDA-event times per
   shape; ``autotune_fused`` / ``autotune_sparse`` / ``autotune_cdf`` on
   the same inputs (one launch each: no knob reaches a kernel); then
   ``apply_best``'s knobs train the train_small corpus for 2 iterations
   of ``zen_pallas`` fused and gathered, ``zen_sparse`` and ``zen_cdf``,
   each state equal to the default knobs' run. Kernels 1, 2, 6 and 7 must
   launch;
28. trainer (runs after train) — ``LDATrainer`` at NYTIMES width on the
   train cell's corpus, ``zen_pallas`` fused, 2 iterations: its state's
   SHA-256 (topics and counts) equal to ``TrainSession.run``'s from the
   same key, ``train(key, 1)`` then ``train(key, 1, state=...)`` equal to
   ``train(key, 2)``, kernels 2 and 5 (and no other) launched.

The serving phase also serves 64 documents with ``zen_cdf`` (throughput
mode on its frozen per-word CDFs: no kernel), and train_small also runs
``std`` (Eq. 3 as written, plain torch) within 1% of ``zen``. The
train_kernels phase also launches kernels 1-2 with a per-token index (a
mesh cell's corpus indices): the identity keeps every draw, a permuted
launch with index pi permutes them, and both are timed.

Then it prints the ``{"kernels": [...]}`` line (all seven kernels, each
with its launches on its own path and on the stream, quality,
train_autopilot, serve_autopilot, mesh_one, mesh_four, sharded_serve,
router, compare, examples, lm_serve, lm_train, lm_dryrun, autotune and
trainer phases'),
the ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``. It exits
non-zero, before any result, when no CUDA device is present, when the
repository's ``src/`` is missing, or when any check fails.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# NYTIMES's words, topics, documents and mean tokens per document: set by
# the configs phase from repro_torch.configs (zenlda-nytimes)
W_NYT = K_NYT = D_NYT = LEN_NYT = None
SLOTS, BUCKET = 32, 512
N_DOCS = 256
TRAIN_ITERS, SMALL_DOCS, SMALL_ITERS = 5, 4096, 3
SPARSE_ITERS = 3  # train_sparse: iterations of zen_sparse at full width
SPARSE_LLH_BAND = 0.08  # train_sparse_small: llh/token vs zen's
CDF_ITERS, CDF_MAX_KD = 3, 64  # train_cdf: zen_cdf iterations, doc rows
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOKENS = 1 << 20  # training-kernel phase: first 1,048,576 tokens
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SFU_PER_SM_PER_CLK = 16  # special-function unit results per SM per clock
INSTR_PER_SM_PER_CLK = 4 * 32  # 4 warp schedulers x 32 lanes
INT_PER_SM_PER_CLK = 64  # 32-bit integer operations per SM per clock
HASH_INT_OPS = 9  # integer operations of the counter hash per (t, k)
NEAR_TIE = 1e-4
# the stream phase: the train corpus replayed in windows
STREAM_WINDOW_DOCS, STREAM_SWEEPS = 32_768, 2  # 10 windows per epoch
STREAM_WINDOWS, STREAM_SAVE_EVERY = 12, 4  # one epoch, then w0, w1 again
STREAM_DECAY, DECAY_WINDOWS = 0.02, 4
RESUME_DOCS, RESUME_WINDOW_DOCS = 65_536, 16_384
RESUME_WINDOWS, RESUME_KILL = 6, 3
PLAIN_WINDOW_DOCS, PLAIN_WINDOWS = 8_192, 2
STREAM_IDLE_SERVE_S = 2.0  # serving after the stream ends, trainer idle
# the quality phase: the train cell with quality evaluation and telemetry
QUALITY_TOP_N, NPMI_WINDOW = 10, 10
L2R_DOCS, L2R_PARTICLES = 100, 20
PAIR_SAMPLE = 1000  # top-word pairs recounted by the plain version
AUTOPILOT_ITERS, AUTOPILOT_EVERY = 4, 2
# the serve_autopilot phase
SERVE_PACE_S, AUTOPILOT_WINDOW = 0.002, 16
SHORT_QUERY = 32  # tokens of the short queries of the recut run
# kernel 5 (csrc/topic_histogram.cu) and kernel 7 (csrc/cdf_search.cu)
# as the profiler names their device functions
HIST_KERNELS = ("hist_sorted_kernel", "zero_cut_rows_kernel",
                "zero_fill_kernel")
CDF_KERNELS = ("cdf_compact_kernel", "cdf_walk_kernel")
CDF_STRIPS = 4  # strips per pass of the walk's loop (kStrips)
# the mesh phases: a world of one under NCCL on the train cell, 4 gloo
# ranks sharing the card on a (2, 2) grid, sharded serving, the router
MESH_ONE_ITERS, MESH_FOUR_ITERS = 3, 2
MESH_FOUR_SHAPE = (2, 2)
MESH_FOUR_SEEN = {}  # mesh_four's blocks and all-reduced bytes (lm_dryrun)
MESH_LLH_RTOL = 1e-12  # mesh_one's llh vs RECORD (expected: equal)
MESH_SERVE_SHARDS = (2, 4)
ROUTER_REPLICAS = 2
# the compare phase: compare --sessions at NYTIMES width, zen_pallas
# against zen_cdf, 3 iterations each with an eval after every one
COMPARE_ITERS = 3
# the examples phase: train_nytimes_lda_torch straight for NYT_EX_ITERS
# iterations, and stopped at half of them then resumed
NYT_EX_ITERS = 100
# the lm_serve phase: the LM zoo's serving path at qwen3-8b's published
# widths and full depth in bf16, random weights from the seed
LM_ARCH = "qwen3-8b"
LM_PARAMS = 8_191_783_936  # repro.launch.specs.params_abstract's count
LM_BATCH, LM_MAX_LEN = 8, 1024
LM_REQUESTS, LM_PROMPT, LM_MAX_NEW = 16, (16, 64), 32
LM_CHECK_LAYERS = 4  # prefill + decode == forward at full width, float32
LM_PREFILL_TOL = 2e-3  # the reference's test_prefill_decode_consistency
LM_SMOKE_STEPS, LM_SMOKE_TOL = 8, 1e-4  # the -smoke configs, card vs CPU
# the lm_train phase: LM_ARCH at its published widths, depth cut so that
# AdamW's state fits the card (12 bytes a parameter: bf16 parameters and
# gradients, float32 m and v), trained on examples/train_lm_torch.py's
# synthetic tokens
LM_TRAIN_LAYERS = 16  # of 36: 4.33B parameters, 52.0 GB of state
LM_TRAIN_PARAMS = 4_332_855_296  # repro.launch.specs.params_abstract's
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 12, 4, 1024
# OptConfig()'s default learning rate. The example's 1e-3 (set for its
# smoke widths) is run too at full width and recorded: with no warm-up
# its loss rises there in the first steps, while at 3e-4 it falls
# (PERF.md §6)
LM_TRAIN_LR = 3e-4
LM_EXAMPLE_LR = 1e-3  # examples/train_lm.py's OptConfig
LM_STATE_BYTES = 12  # per parameter
LM_TRAIN_CHECK_LAYERS = 2  # checks (a) and (b): full width, float32
LM_REMAT_TOL = 1e-5  # (a): grads scaled by the leaf's largest |g|
LM_MB_TOL = 2e-3  # (b): tests/test_train.py's test_microbatch_equivalence
LM_SIGN_FLOOR = 1e-6  # (c): AdamW's first step moves ~lr * sign(g)
LM_LOOP_STEPS, LM_LOOP_STOP = 12, 6  # (d): stop at 6, resume to 12
# the lm_dryrun phase: the production-mesh cells traced on the card (a),
# the dry-run's peak held to lm_train's measured one within this share
# (b), and the DTensor step's steps (c)
LM_DRYRUN_CELLS = [(LM_ARCH, shape, multi)
                   for shape in ("train_4k", "prefill_32k", "decode_32k")
                   for multi in (False, True)] + [
                       ("zenlda-nytimes", "train_lda", False)]
LM_DRYRUN_PEAK_TOL = 0.15
LM_DRYRUN_STEPS = 2
# the autotune phase: each swept source's block-shape macro, its default
# and the other values it is rebuilt at (_build.variant); its legs run
# inside train_kernels, sparse_kernels and cdf_kernels on their inputs,
# then apply_best's knobs train the train_small corpus for AUTOTUNE_ITERS
SHAPES = {"zen_train.cu": ("ZEN_TRAIN_WARPS", 32, (8, 16)),
          "sparse_row.cu": ("SPARSE_ROW_WARPS", 8, (2, 4, 16)),
          "cdf_search.cu": ("CDF_SEARCH_THREADS", 256, (128, 512))}
AUTOTUNE_ITERS = 2
AUTOTUNE = {"sweeps": {}, "timings": [], "launches": {}, "seconds": 0.0}
# the trainer phase: LDATrainer at NYTIMES width, zen_pallas fused
TRAINER_ITERS = 2
# The training phases' records, as this script measured them before
# kernels 5 and 7 were redesigned (NVIDIA H100 80GB HBM3, 700 W; equal in
# four runs of that tree): no kernel redesign may change them, since every
# draw is counter-based and every count an integer
RECORD = {
    "train": {
        "llh": [-553201183.023535, -552858789.5727848, -552430974.6499592,
                -551982301.1272973, -551533959.0934076,
                -551100162.7035435],
        "change_rate": [0.9989971068767338, 0.9942934639652927,
                        0.9886557953084262, 0.9828150417487752,
                        0.977131860126165],
    },
    "train_sparse": {
        "llh": [-551683197.7157105, -550211639.0543504, -548992734.4532295,
                -547991388.1614581],
        "change_rate": [0.9941575079234416, 0.9755162955561146,
                        0.9533872665494625],
    },
    "train_cdf": {
        "llh": [-553201183.023535, -552490201.228704, -551752980.2351285,
                -551185658.4481958],
        "change_rate": [0.9983710900516083, 0.9782291959193491,
                        0.9693572627624099],
    },
}
TRAIN_SMALL_LLH = -5.84568195283306  # fused and gathered, per token
# The serving runs' thetas (theta_digest), as this script measured them
# before kernels 3 and 4 were redesigned (NVIDIA H100 80GB HBM3, 700 W):
# a redesign that keeps every draw keeps them
SERVE_RECORD = {
    "throughput_fused":
        "0b6a643fe05845777c0f3971e1aa6cc536f1f61bb03621aae72cd03cbb1f8b6d",
    "throughput_gathered":
        "1f903eb536c157bb6d4a33cabec7b7f0c1d854d9d3eae60fbcaba6fcfc4d47d0",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_record(phase: str, llh, change_rate) -> None:
    """The phase's llh and change-rate lists must equal :data:`RECORD`."""
    want = RECORD[phase]
    check(llh == want["llh"] and change_rate == want["change_rate"],
          f"{phase}: llh {llh} / change rate {change_rate} differ from "
          f"the record {want}")


def check_launches(phase: str, counts, want) -> None:
    """``counts`` must be ``want`` (kernel -> launches) and 0 elsewhere."""
    got = {n: v for n, v in counts.items() if v or n in want}
    check(got == want, f"{phase}: expected launches {want}, got {counts}")


def autotune_leg(fn):
    """One leg of the autotune phase, with every launch count at 0 just
    before it; its launches are added to ``AUTOTUNE["launches"]`` and its
    seconds to ``AUTOTUNE["seconds"]``."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    AUTOTUNE["seconds"] += time.perf_counter() - t0
    for name, n in ops.launch_counts().items():
        AUTOTUNE["launches"][name] = AUTOTUNE["launches"].get(name, 0) + n
    return out


def shape_variants():
    """(source, defines) of every shape :data:`SHAPES` sweeps but the
    defaults, for ``_build.build``."""
    return [(src, (f"{macro}={v}",))
            for src, (macro, _, others) in SHAPES.items() for v in others]


def at_shape(source: str, value: int):
    """The launchers of ``source`` at block shape ``value`` while the
    block runs: its variant build, or the main build at the default."""
    import contextlib

    from repro_torch.kernels import _build

    macro, default, _ = SHAPES[source]
    if value == default:
        return contextlib.nullcontext()
    return _build.variant(source, f"{macro}={value}")


def shapes_of(source: str):
    _, default, others = SHAPES[source]
    return sorted((default, *others))


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, gate: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events. With
    ``gate`` the card first sleeps ~15 ms, so that all ``reps`` launches
    are queued before the first event: a call shorter than its host-side
    launch cost is then timed back to back, not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if gate:
        torch.cuda._sleep(30_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_kernels_on(a, sm_count: int, sm_clock_hz: float, reps: int = 20):
    """Both serving kernels, the exact loop (zen_infer_exact: the exact
    chain for every (t, k), one warp per token) and the plain version on
    one input set ``a`` (n_wk, n_kd, word, slot, z, seeds, alpha, n_k,
    beta, w_beta): fused == gathered == the exact loop (0 mismatches),
    kernel against plain only at counted near-ties; CUDA-event times, the
    kernels' stats, the bytes and the operation bounds."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gather import (
        zen_fused_infer_sample_cuda,
        zen_fused_infer_sample_plain,
        zen_infer_exact_cuda,
    )
    from repro_torch.kernels.zen_sampler import gumbel_noise

    n_wk, n_kd, word, slot, z, seeds = (a[n] for n in (
        "n_wk", "n_kd", "word", "slot", "z", "seeds"))
    alpha, n_k, beta, w_beta = a["alpha"], a["n_k"], a["beta"], a["w_beta"]
    (w, k), b, t = n_wk.shape, n_kd.shape[0], word.shape[0]
    args = (n_wk, n_kd, word, slot, z, seeds, alpha, n_k)
    kw = dict(beta=beta, w_beta=w_beta)
    nwk_rows = n_wk[word.long()].contiguous()
    nkd_rows = n_kd[slot.long()].contiguous()

    def fused():
        return ops.zen_fused_infer_sample(*args, **kw)

    def gathered():
        return ops.zen_infer_sample(nwk_rows, nkd_rows, z, seeds, alpha,
                                    n_k, **kw)

    def exact():
        return zen_infer_exact_cuda(*args, **kw)

    def plain():
        return zen_fused_infer_sample_plain(*args, **kw)

    out_f, out_g, out_e, out_p = fused(), gathered(), exact(), plain()
    stats = torch.zeros(3, dtype=torch.int64, device=n_wk.device)
    out_s = zen_fused_infer_sample_cuda(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    check(bool(torch.equal(out_f, out_g)),
          "fused and gathered kernels disagree")
    check(bool(torch.equal(out_s, out_f)), "serving: stats run differs")
    exact_mism = int((out_f != out_e).sum())
    check(exact_mism == 0, f"serving kernels differ from the exact loop "
          f"on {exact_mism} of {t} tokens")
    check(int(out_f.min()) >= 0 and int(out_f.max()) < k,
          "serving kernel drew a topic outside [0, K)")
    mism = (out_f != out_p).nonzero().flatten()
    gaps = []
    if mism.numel():
        # recompute both candidates' scores in plain torch at the
        # mismatched tokens: a legitimate mismatch is a near-tie
        m = mism.long()
        cand = torch.stack([out_f[m], out_p[m]], 1).long()
        nw = n_wk[word[m].long()].gather(1, cand).to(torch.float32)
        nd = n_kd[slot[m].long()].gather(1, cand).to(torch.float32) \
            - (cand == z[m, None].long()).to(torch.float32)
        p = (nd + alpha[cand]) * (nw + beta) / (n_k[cand] + w_beta)
        s = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(seeds[m, None], 0, cand)
        gaps = (s[:, 0] - s[:, 1]).abs().tolist()
    check(all(g <= NEAR_TIE for g in gaps),
          f"kernel-vs-plain mismatches that are no near-tie: {gaps}")
    check(len(gaps) <= NEAR_TIE * t,
          f"{len(gaps)} kernel-vs-plain mismatches over {t} tokens")

    # gated: a launch of the verified kernels is shorter than its host-side
    # cost, so back to back they would be timed at the host's pace (kept
    # apart as host_paced)
    ms = {"fused": cuda_ms(fused, reps=reps, gate=True),
          "gathered": cuda_ms(gathered, reps=reps, gate=True),
          "exact_loop": cuda_ms(exact, reps=reps, gate=True),
          "plain": cuda_ms(plain, reps=5)}
    host_paced = {"fused": cuda_ms(fused, reps=reps),
                  "gathered": cuda_ms(gathered, reps=reps),
                  "exact_loop": cuda_ms(exact, reps=reps)}
    uniq = int(torch.unique(word).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    tok = t * 4 * 4 + t * 4  # word/slot or z/seeds in, topics out
    forced, cands, fallback = stats.tolist()
    del nwk_rows, nkd_rows
    return {
        "T": t, "K": k, "W": w, "B": b, "unique_words": uniq,
        "bytes_fused": uniq * k * 4 + b * k * 4 + vec + tok,
        "bytes_gathered": 2 * t * k * 4 + vec + t * 4 * 2 + t * 4,
        # the operations any exact draw needs: the hash of every (t, k)
        # for its noise; this design's estimate adds three MUFU lg2 per
        # (t, k), its own floor
        "hash_ms": (HASH_INT_OPS * t * k
                    / (sm_count * INT_PER_SM_PER_CLK * sm_clock_hz) * 1e3),
        "mufu_lg2": 3 * t * k,
        "design_mufu_ms": (3 * t * k / (sm_count * SFU_PER_SM_PER_CLK
                                        * sm_clock_hz) * 1e3),
        "ms": ms, "host_paced_ms": host_paced, "gaps": gaps,
        "exact_loop_mismatches": exact_mism,
        "exact_work": {"forced": forced, "candidates": cands,
                       "exact_loop_tokens": fallback},
        "exact_topics_per_token": (forced + cands) / t,
        "exact_share": (forced + cands + fallback * k) / (t * k),
    }


def serve_sass():
    """The serving kernels' SASS: the verified fused and gathered kernels'
    fast loops at K = 1000 (4 topics per lane, table in shared memory) and
    the exact loop's K loop (zen_infer_exact_kernel: the exact chain, one
    topic per lane per pass, as the kernels before the redesign ran it for
    every (t, k))."""
    inst = "ILi4ELb1EE"
    out = {name: fast_loop_stats(kern + inst, 4, source="zen_infer.cu")
           for name, kern in (("zen_fused_infer_sample",
                               "zen_infer_fused_kernel"),
                              ("zen_infer_sample",
                               "zen_infer_gathered_kernel"))}
    out["exact_loop"] = sass_loop_stats("zen_infer_exact_kernel",
                                        source="zen_infer.cu")
    return out


def issue_bound_ms(t: int, k: int, loop, work, sm_count: int,
                   sm_clock_hz: float):
    """Issue bound of one launch of a verified sampler (kernels 1-4), in
    warp instructions: its fast loop (``fast_loop_stats``) over every pass,
    one exact_score per exactly scored topic (the candidates of a token
    share one divergent pass, so this overcounts) and ceil(K/32) exact
    chains per exact-loop token (``work``: the stats output); None without
    the SASS figures."""
    if not loop or not loop["exact_score_instructions"]:
        return None
    warp_instr = (t * -(-k // (32 * loop["topics_per_pass"]))
                  * loop["fast_loop_instructions"]
                  + (work["forced"] + work["candidates"]
                     + work["exact_loop_tokens"] * -(-k // 32))
                  * loop["exact_score_instructions"])
    return (warp_instr * 32 / (sm_count * INSTR_PER_SM_PER_CLK
                               * sm_clock_hz) * 1e3)


def serve_row_figures(r, name, sass, sm_count, sm_clock_hz):
    """One serving kernel's figures on one input set ``r``."""
    fused = name == "zen_fused_infer_sample"
    nbytes = r["bytes_fused" if fused else "bytes_gathered"]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "ms": r["ms"]["fused" if fused else "gathered"],
        "host_paced_ms": r["host_paced_ms"]["fused" if fused else "gathered"],
        "plain_ms": r["ms"]["plain"],
        "exact_loop_ms": r["ms"]["exact_loop"],
        "bound_ms": max(bytes_ms, r["hash_ms"]),
        "bound_by": "bytes" if bytes_ms >= r["hash_ms"] else "operations",
        "bytes": nbytes, "bytes_ms": bytes_ms, "hash_ms": r["hash_ms"],
        "mufu_lg2": r["mufu_lg2"], "design_mufu_ms": r["design_mufu_ms"],
        "issue_bound_ms": issue_bound_ms(r["T"], r["K"], sass[name],
                                         r["exact_work"], sm_count,
                                         sm_clock_hz),
        "exact_work": r["exact_work"],
        "exact_topics_per_token": r["exact_topics_per_token"],
        "exact_share": r["exact_share"], "tokens": r["T"],
        "unique_words": r["unique_words"],
    }


def phase_kernels(gen, dev, sm_count: int, sm_clock_hz: float):
    """Both kernels against each other, the exact loop and the plain
    version, on random counts at the serving cell's shapes."""
    import torch

    w, k, b, t = W_NYT, K_NYT, SLOTS, SLOTS * BUCKET
    i32 = torch.int32
    n_wk = torch.randint(0, 64, (w, k), generator=gen, device=dev, dtype=i32)
    n_kd = torch.randint(0, 12, (b, k), generator=gen, device=dev, dtype=i32)
    word = torch.randint(0, w, (t,), generator=gen, device=dev, dtype=i32)
    slot = torch.arange(b, device=dev, dtype=i32).repeat_interleave(BUCKET)
    z = torch.randint(0, k, (t,), generator=gen, device=dev, dtype=i32)
    seeds = torch.randint(0, 2**31 - 1, (t,), generator=gen, device=dev,
                          dtype=i32)
    n_k = n_wk.sum(0).to(torch.float32)
    alpha = torch.rand(k, generator=gen, device=dev) * 0.1
    r = serve_kernels_on(dict(n_wk=n_wk, n_kd=n_kd, word=word, slot=slot,
                              z=z, seeds=seeds, alpha=alpha, n_k=n_k,
                              beta=0.01, w_beta=w * 0.01),
                         sm_count, sm_clock_hz)
    sass = serve_sass()
    gaps = r["gaps"]
    # the fused kernel's fixed cost against its cost per token: gated
    # times on the first 4,096 tokens (one sweep of 128-token buckets),
    # all 16,384 and those four times over
    from repro_torch.kernels import ops
    by_tokens = {}
    for n in (4096, t, 4 * t):
        idx = torch.arange(n, device=dev) % t
        sub = [x[idx].contiguous() for x in (word, slot, z, seeds)]
        by_tokens[str(n)] = cuda_ms(
            lambda: ops.zen_fused_infer_sample(n_wk, n_kd, *sub, alpha, n_k,
                                               beta=0.01, w_beta=w * 0.01),
            reps=20, gate=True)

    def row(name, replaces):
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_infer.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps,
            "exact_loop_mismatches": r["exact_loop_mismatches"],
            **serve_row_figures(r, name, sass, sm_count, sm_clock_hz),
            "sass": sass[name], "exact_loop_sass": sass["exact_loop"],
            "library_ms": None,
            **({"ms_by_tokens": by_tokens}
               if name == "zen_fused_infer_sample" else {}),
        }

    rows = [row("zen_fused_infer_sample",
                "src/repro/kernels/fused_gather.py:166"),
            row("zen_infer_sample", "src/repro/kernels/zen_sampler.py:218")]
    emit({"phase": "kernels", "W": w, "K": k, "T": t,
          "unique_words": r["unique_words"], "fused_equals_gathered": True,
          "exact_loop_mismatches": r["exact_loop_mismatches"],
          "mismatches_vs_plain": len(gaps), "ms": r["ms"],
          "host_paced_ms": r["host_paced_ms"], "exact_work": r["exact_work"],
          "exact_topics_per_token": r["exact_topics_per_token"],
          "fused_ms_by_tokens": by_tokens, "sass": sass})
    del n_wk
    torch.cuda.empty_cache()
    return rows


def capture_path_inputs(model, cfg, docs, seed: int, sweep: int):
    """The inputs of the ``sweep``-th launch of the fused serving kernel
    at the widest bucket (32 slots x 512 tokens) when ``docs`` are served
    as the throughput_fused run serves them (the run is deterministic, so
    these are that run's own): the model's n_wk, the bucket's n_kd, words,
    slots, z and seeds, and the per-topic vectors."""
    import repro_torch.algorithms.zen_pallas as zen_pallas
    from repro_torch.serving import LDAEngine

    seen = []
    real = zen_pallas.zen_fused_infer_sample

    def record(n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k, *,
               beta, w_beta, **kw):
        if word.shape[0] == SLOTS * BUCKET:
            seen.append(None if len(seen) != sweep else dict(
                n_wk=n_wk, n_kd=n_kd.clone(), word=word.clone(),
                slot=slot.clone(), z=z_old.clone(), seeds=seeds.clone(),
                alpha=alpha_k, n_k=n_k, beta=beta, w_beta=w_beta))
        return real(n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
                    beta=beta, w_beta=w_beta, **kw)

    zen_pallas.zen_fused_infer_sample = record
    try:
        engine = LDAEngine(model, cfg, seed=seed)
        engine.infer_batch(docs)
    finally:
        zen_pallas.zen_fused_infer_sample = real
    check(len(seen) > sweep, f"serving path: {len(seen)} launches at the "
          f"widest bucket, fewer than {sweep + 1}")
    return seen[sweep]


def phase_serve_path(model, cfg, docs, seed: int, rows, sm_count: int,
                     sm_clock_hz: float):
    """Both serving kernels on the throughput_fused run's own inputs (the
    10th launch at the widest bucket), against the exact loop and the
    plain version; their figures join ``rows`` under ``path``."""
    import torch

    a = capture_path_inputs(model, cfg, docs, seed, sweep=9)
    r = serve_kernels_on(a, sm_count, sm_clock_hz)
    # padding positions (past each slot's document, z_old often at N_kd =
    # 0, the clamp) are sampled, then dropped by the engine
    lens = [min(len(d), BUCKET) for d in docs if len(d) > BUCKET // 2]
    sass = {row["name"]: row["sass"] for row in rows}
    for row in rows:
        row["path"] = serve_row_figures(r, row["name"], sass, sm_count,
                                        sm_clock_hz)
        row["path"]["mismatches_vs_plain"] = len(r["gaps"])
    emit({"phase": "serve_path_kernels", "T": r["T"], "K": r["K"],
          "unique_words": r["unique_words"], "ms": r["ms"],
          "host_paced_ms": r["host_paced_ms"],
          "padding_share_of_widest_bucket": 1 - sum(lens) / (len(lens)
                                                          * BUCKET),
          "exact_loop_mismatches": r["exact_loop_mismatches"],
          "mismatches_vs_plain": len(r["gaps"]),
          "exact_work": r["exact_work"],
          "exact_topics_per_token": r["exact_topics_per_token"]})
    torch.cuda.empty_cache()



# The serving kernels' adversarial grid: (name, seed, T, K, W, B, kind,
# pins). Slot s holds tokens [s T / B, (s + 1) T / B), as the serving path
# lays out a bucket. A pin (token, token seed, topics, z_old) sets that
# token's seed and z_old and must draw min(topics); a pin whose z_old is
# one of its topics zeroes that doc count (the clamped z_old). Kind
# "pinned": equal counts (n_wk 5, n_kd 2, alpha 0.05, N_k 1000, z_old 0)
# with each pin's topics raised to 10^7 in its token's slot row, so that
# one of them must win. The pins' coordinates (seed, 0, topic), held
# against the JAX package's hash and oracles by
# tests/test_torch_serve_kernels.py:
# - inf_noise: seed 38296 has m = 2^24 - 1 at topic 415 (noise +inf), drawn
#   by token 100 (z_old 7) and by token 2000, whose z_old is 415 with
#   N_kd = 0 there, so its p clamps at 1e-30;
# - top_bucket: seed 1003, topic 325, m = 16774212 (the forced bucket);
# - top_bucket_tie: seed 141959, topics 156 and 406, m = 16773846 and
#   16773845, one u: an exact tie of two forced topics;
# - candidates_tie: seed 1025, topics 402 and 713 (lanes 4 and 18), equal
#   m: two candidates rescored exactly;
# - same_lane_tie: seed 1339, topics 696 and 826 (lane 14), equal m: a
#   lane's two best tie, so the token takes the exact loop;
# - padding: the engine's bucket state: each slot a document of 1 to 512
#   tokens, z_old stale past it, n_kd counting the document alone, so
#   many padding positions have N_kd = 0 at z_old (the clamp);
# - p_clamp: alpha_k from 1e-33 to 1e-23 and empty counts, so p lies on
#   both sides of the 1e-30 clamp;
# - k_1, k_5, k_37 (one topic per lane), k_36 (a partial 128-topic pass),
#   premise_off (one N_k + W b above 2^100: the block samples with the
#   exact loop alone);
# - k_14464 (the largest table an H100 block keeps in shared memory),
#   k_14592 and k_16385 (tables the launcher puts in global memory, with 4
#   and 1 topics per lane).
SERVE_ADVERSARIAL = (
    ("inf_noise", 21, 4096, 1000, 200, 8, "random",
     ((100, 38296, (415,), 7), (2000, 38296, (415,), 415))),
    ("top_bucket", 22, 4096, 1000, 200, 8, "pinned",
     ((700, 1003, (325,), 0),)),
    ("top_bucket_tie", 23, 4096, 1000, 200, 8, "pinned",
     ((1200, 141959, (156, 406), 0),)),
    ("candidates_tie", 24, 4096, 1000, 200, 8, "pinned",
     ((1900, 1025, (402, 713), 0),)),
    ("same_lane_tie", 25, 4096, 1000, 200, 8, "pinned",
     ((3000, 1339, (696, 826), 0),)),
    ("padding", 26, 16384, 1000, 5000, 32, "padding", ()),
    ("p_clamp", 27, 4096, 1000, 100, 8, "clamp", ()),
    ("k_1", 28, 4096, 1, 50, 8, "random", ()),
    ("k_5", 29, 4096, 5, 50, 8, "random", ()),
    ("k_37", 30, 4096, 37, 50, 8, "random", ()),
    ("k_36", 31, 4096, 36, 50, 8, "random", ()),
    ("premise_off", 32, 4096, 1000, 100, 8, "premise_off", ()),
    ("k_14464", 33, 512, 14464, 60, 4, "random", ()),
    ("k_14592", 34, 512, 14592, 60, 4, "random", ()),
    ("k_16385", 35, 512, 16385, 60, 4, "random", ()),
)


def serve_adversarial_case(spec, dev):
    """The inputs of one :data:`SERVE_ADVERSARIAL` case on ``dev``."""
    import torch

    _, seed, t, k, w, b, kind, pins = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    slot = (torch.arange(t, device=dev) * b // t).to(i32)
    z = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    seeds = torch.randint(0, 2**31 - 1, (t,), generator=g, device=dev,
                          dtype=i32)
    alpha = torch.rand(k, generator=g, device=dev) * 0.2 + 0.001
    n_wk = torch.randint(0, 40, (w, k), generator=g, device=dev, dtype=i32)
    n_k = None
    if kind == "pinned":
        n_wk = torch.full((w, k), 5, dtype=i32, device=dev)
        n_kd = torch.full((b, k), 2, dtype=i32, device=dev)
        alpha = torch.full((k,), 0.05, device=dev)
        n_k = torch.full((k,), 1000.0, device=dev)
        z.zero_()
    elif kind == "clamp":
        n_wk.zero_()
        n_kd = torch.zeros((b, k), dtype=i32, device=dev)
        alpha = 10.0 ** (torch.rand(k, generator=g, device=dev) * 10 - 33)
        n_k = torch.full((k,), 1000.0, device=dev)
    elif kind == "padding":
        per = t // b
        length = torch.randint(1, per + 1, (b,), generator=g, device=dev)
        doc = torch.arange(t, device=dev) % per < length[slot.long()]
        n_kd = torch.zeros((b, k), dtype=i32, device=dev)
        n_kd.index_put_((slot[doc].long(), z[doc].long()),
                        torch.ones_like(z[doc]), accumulate=True)
    else:  # random, premise_off: each token's own topic counted
        n_kd = torch.randint(0, 8, (b, k), generator=g, device=dev,
                             dtype=i32)
        n_kd.index_put_((slot.long(), z.long()), torch.ones_like(z),
                        accumulate=True)
    if n_k is None:
        n_k = n_wk.sum(0).to(torch.float32)
    if kind == "premise_off":
        n_k[5] = 1e35
    for tok, tseed, topics, z_old in pins:
        seeds[tok] = tseed
        z[tok] = z_old
        row = int(slot[tok])
        if kind == "pinned":
            n_kd[row, list(topics)] = 10**7
        if z_old in topics:
            n_kd[row, z_old] = 0
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, slot=slot, z=z,
                seeds=seeds, alpha=alpha, n_k=n_k, beta=0.01,
                w_beta=w * 0.01)


def serve_adversarial_check(spec, dev):
    """Both serving kernels on one :data:`SERVE_ADVERSARIAL` case against
    the exact loop: 0 mismatches, fused == gathered, the pinned draws.
    Direct launches with the stats output, outside the launch counts.
    Returns the case's summary, with where the launcher put the table."""
    import torch

    from repro_torch.kernels.fused_gather import (
        zen_fused_infer_sample_cuda,
        zen_infer_exact_cuda,
    )
    from repro_torch.kernels.zen_sampler import (
        infer_global_table_entries,
        zen_infer_sample_cuda,
    )

    name, _, t, k, _, _, _, pins = spec
    a = serve_adversarial_case(spec, dev)
    args = tuple(a[n] for n in ("n_wk", "n_kd", "word", "slot", "z",
                                "seeds", "alpha", "n_k"))
    kw = dict(beta=a["beta"], w_beta=a["w_beta"])
    exact = zen_infer_exact_cuda(*args, **kw)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    fused = zen_fused_infer_sample_cuda(*args, stats=stats, **kw)
    gathered = zen_infer_sample_cuda(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["slot"].long()].contiguous(), a["z"], a["seeds"],
        a["alpha"], a["n_k"], **kw)
    torch.cuda.synchronize()
    mism = int((fused != exact).sum())
    check(bool(torch.equal(fused, gathered)),
          f"serving adversarial {name}: fused != gathered")
    check(mism == 0, f"serving adversarial {name}: {mism} mismatches "
          "against the exact loop")
    forced, cands, exact_loop = stats.tolist()
    check(exact_loop == t if name == "premise_off" else
          exact_loop < t and forced + cands < t * k,
          f"serving adversarial {name}: exact work {stats.tolist()}")
    for tok, _, topics, _ in pins:
        check(int(fused[tok]) == min(topics),
              f"serving adversarial {name}: token {tok} drew "
              f"{int(fused[tok])}, pinned {min(topics)}")
    table = "global" if infer_global_table_entries(k, dev) else "shared"
    return {"case": name, "T": t, "K": k, "table": table,
            "stats": stats.tolist(),
            "pins": {str(p[0]): min(p[2]) for p in pins},
            "mismatches": mism}


def planted_model(gen, dev):
    """Each word one dominant topic (100 counts) plus 20 background counts
    on random topics: 12.2M tokens, below the 2^24 where a float32 N_k sum
    turns order-dependent."""
    import torch

    w, k = W_NYT, K_NYT
    dom = torch.randperm(w, generator=gen, device=dev) % k
    n_wk = torch.zeros((w, k), dtype=torch.int32, device=dev)
    n_wk[torch.arange(w, device=dev), dom] = 100
    bg = torch.randint(0, k, (w, 20), generator=gen, device=dev)
    n_wk.scatter_add_(1, bg, torch.ones_like(bg, dtype=torch.int32))
    return n_wk, n_wk.sum(0), dom.cpu().numpy()


def planted_docs(rng, dom, n_docs: int):
    """Poisson(332) documents on 1-2 planted topics; 90% of tokens from
    the topics' dominant words, 10% uniform noise."""
    import numpy as np

    by_topic = [np.flatnonzero(dom == t) for t in range(K_NYT)]
    docs, topics = [], []
    for _ in range(n_docs):
        n = max(1, int(rng.poisson(332)))
        ts = rng.choice(K_NYT, size=int(rng.integers(1, 3)), replace=False)
        pick = rng.choice(ts, size=n)
        words = np.array([rng.choice(by_topic[t]) for t in pick], np.int32)
        noise = rng.random(n) < 0.1
        words[noise] = rng.integers(0, W_NYT, int(noise.sum()))
        docs.append(words)
        topics.append([int(t) for t in ts])
    return docs, topics


def serve(model, cfg, docs, seed: int):
    """Warm, then serve every doc through the ticket front; returns
    (thetas, requests, seconds, kernel launches of the serving window)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=seed)
    engine.warm()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [engine.submit_async(d) for d in docs]
    reqs = [engine.request(t) for t in tickets]
    thetas = np.stack([engine.result(t) for t in tickets])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return thetas, reqs, secs, ops.launch_counts()


def theta_digest(thetas) -> str:
    """SHA-256 of a serving run's thetas as float32 bytes: every draw of
    the run decides them, so an unchanged digest shows unchanged draws."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(thetas, dtype=np.float32).tobytes()).hexdigest()


def check_thetas(name, thetas, topics, n_docs):
    import numpy as np

    check(thetas.shape == (n_docs, K_NYT), f"{name}: theta shape")
    check(bool(np.isfinite(thetas).all()), f"{name}: non-finite theta")
    check(bool(np.allclose(thetas.sum(1), 1.0, atol=1e-4)),
          f"{name}: theta rows do not sum to 1")
    single = [i for i, ts in enumerate(topics) if len(ts) == 1]
    hit = np.mean([int(np.argmax(thetas[i])) == topics[i][0]
                   for i in single])
    pair = [i for i, ts in enumerate(topics) if len(ts) == 2]
    pair_hit = np.mean([int(np.argmax(thetas[i])) in topics[i]
                        for i in pair]) if pair else float("nan")
    check(hit >= 0.9, f"{name}: planted topic recovered on {hit:.3f} of "
          f"single-topic docs (< 0.9)")
    return float(hit), float(pair_hit)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import _build
    from repro_torch.serving import FrozenLDAModel, LDAServeConfig
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.train.checkpoint import save_lda_model

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(dev)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    emit({"phase": "device", "name": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sm_count": props.multi_processor_count,
          "max_sm_clock_hz": sm_clock_hz, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    phase_configs()

    t0 = time.perf_counter()
    log = _build.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if ("ptxas" in ln and ("registers" in ln or "Compiling" in ln))
             or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(src.relative_to(ROOT)) for src in _build.SOURCES],
          "ptxas": ptxas})
    # the autotune phase's other block shapes, all at once
    t0 = time.perf_counter()
    _build.build(shape_variants())
    emit({"phase": "build_shapes", "seconds": time.perf_counter() - t0,
          "variants": [f"{src} -D{d[0]}" for src, d in shape_variants()]})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = phase_kernels(gen, dev, props.multi_processor_count, sm_clock_hz)

    # -- serving: planted model through a checkpoint round trip ----------
    hyper = LDAHyperParams(num_topics=K_NYT, alpha=0.01, beta=0.01)
    n_wk, n_k, dom = planted_model(gen, dev)
    ckpt = ROOT / "build" / "chip_smoke_model"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save_lda_model(str(ckpt), n_wk, n_k, hyper, step=0)
    model = FrozenLDAModel.from_checkpoint(str(ckpt), device=dev)
    t_ckpt = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    check(bool(torch.equal(model.n_wk, n_wk)) and model.hyper == hyper,
          "checkpoint round trip changed the model")
    del n_wk
    rng = np.random.default_rng(args.seed)
    docs, topics = planted_docs(rng, dom, N_DOCS)
    base = dict(buckets=(128, 256, 512), max_batch=SLOTS, num_sweeps=10,
                algorithm="zen_pallas")
    # (run, config, docs, planted topics, the kernel the run must launch)
    runs = [
        ("throughput_fused", LDAServeConfig(**base), docs, topics,
         "zen_fused_infer_sample"),
        ("throughput_gathered", LDAServeConfig(kernels="off", **base),
         docs[:64], topics[:64], "zen_infer_sample"),
        ("latency", LDAServeConfig(mode="latency", **base), docs, topics,
         None),
        ("throughput_cdf", LDAServeConfig(**{**base,
                                             "algorithm": "zen_cdf"}),
         docs[:64], topics[:64], None),
    ]
    results, launches = {}, {}
    for name, cfg, ds, ts, kernel in runs:
        thetas, reqs, secs, counts = serve(model, cfg, ds, args.seed)
        hit, pair_hit = check_thetas(name, thetas, ts, len(ds))
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3 for r in reqs)
        results[name] = (thetas, reqs)
        emit({"phase": "serving", "run": name, "docs": len(ds),
              "tokens": int(sum(len(d) for d in ds)), "seconds": secs,
              "docs_per_sec": len(ds) / secs, "p50_ms": lat["p50"],
              "p99_ms": lat["p99"], "max_ms": lat["max"],
              "planted_top1_single": hit, "planted_top1_pair": pair_hit,
              "launches": counts, "card": smi, "checkpoint_seconds": t_ckpt,
              "theta_sha256": theta_digest(thetas)})
        check(all((v > 0) == (k == kernel) for k, v in counts.items()),
              f"{name}: expected launches of {kernel} only, got {counts}")
        if kernel is not None:
            launches[kernel] = counts[kernel]
        if name in SERVE_RECORD:
            check(theta_digest(thetas) == SERVE_RECORD[name],
                  f"{name}: thetas differ from the record (a kernel "
                  f"changed a draw)")

    # latency mode is deterministic: the CPU engine must agree exactly
    sample = list(range(16))
    cpu_model = FrozenLDAModel(model.n_wk.cpu(), model.n_k.cpu(), hyper)
    cpu_reqs = serve_cpu(cpu_model, runs[2][1], [docs[i] for i in sample])
    gpu_reqs = results["latency"][1]
    same = all(np.array_equal(cpu_reqs[j].z, gpu_reqs[i].z)
               for j, i in enumerate(sample))
    check(same, "latency-mode assignments differ between card and CPU")
    emit({"phase": "reference", "latency_docs_equal_on_cpu": len(sample)})
    for name, cfg, ds, _, _ in runs:
        emit({"phase": "profile", "run": name, "docs": len(ds[:64]),
              **profile_serving(model, cfg, ds[:64], args.seed)})
    phase_serve_path(model, runs[0][1], docs, args.seed, rows,
                     props.multi_processor_count, sm_clock_hz)
    grid = [serve_adversarial_check(spec, dev) for spec in SERVE_ADVERSARIAL]
    check(any(case["table"] == "global" for case in grid),
          "serving adversarial grid: no case put the table in global memory")
    emit({"phase": "serve_kernels_adversarial", "cases": grid,
          "margin": margin_premises(dev, kernels="infer")})
    serve_autopilot_launches = phase_serve_autopilot(
        model, base, docs, topics, args.seed, smi)
    sharded_launches = phase_sharded_serve(
        model, base, docs, args.seed, launches["zen_fused_infer_sample"],
        smi)
    router_launches = phase_router(model, base, docs, args.seed, smi)

    # -- training: kernels, the full NYTIMES run, the three backends ------
    train_rows, train_launches, by_phase = run_training(
        args.seed, dev, props, smi, sm_clock_hz)
    by_phase["compare"] = phase_compare(args.seed, smi)
    by_phase["examples"] = phase_examples(smi)
    by_phase["lm_serve"] = phase_lm_serve(args.seed, dev, smi)
    by_phase["lm_train"] = phase_lm_train(args.seed, dev, smi)
    by_phase["lm_dryrun"] = phase_lm_dryrun(args.seed, dev, smi)
    launches.update(train_launches)
    by_phase["serve_autopilot"] = {
        "zen_fused_infer_sample": serve_autopilot_launches}
    by_phase["sharded_serve"] = sharded_launches
    by_phase["router"] = router_launches
    rows = train_rows + rows
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the live pipeline's launches (stream phase: legs 1 and 2), and
        # those of the quality, train_autopilot and serve_autopilot runs
        for phase, counts in by_phase.items():
            r[f"launches_{phase}"] = counts.get(r["name"], 0)
        check(r["launches"] > 0,
              f"{r['name']} was not launched on its path")
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def phase_configs() -> None:
    """NYTIMES's widths from the port's config registry (the paper's
    configs): every phase reads them from here."""
    import dataclasses

    from repro_torch.configs import get_config, list_archs

    global W_NYT, K_NYT, D_NYT, LEN_NYT
    nyt = get_config("zenlda-nytimes")
    web = get_config("zenlda-webchunk")
    W_NYT, K_NYT = nyt.num_words, nyt.num_topics
    D_NYT, LEN_NYT = nyt.docs_per_step, nyt.avg_doc_len
    emit({"phase": "configs", "archs": list_archs(),
          "nytimes": dataclasses.asdict(nyt),
          "nytimes_tokens_per_step": nyt.tokens_per_step,
          "webchunk": dataclasses.asdict(web),
          "webchunk_tokens_per_step": web.tokens_per_step})


def sass_function(kernel: str, source: str):
    """``(address, instruction)`` pairs of the first function whose
    mangled name holds ``kernel``, from ``cuobjdump -sass`` of the library
    built from ``source``, and the branch targets of each branch (label or
    address resolved). None when the tool or the function is missing."""
    import re

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = [_build.target(s) for s in _build.SOURCES
           if s.name == source][0]
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=120).stdout
    except OSError:
        return None
    funcs = re.split(r"\n\s*Function : ", out)
    body = next((f for f in funcs[1:] if kernel in f.splitlines()[0]), None)
    if body is None:
        return None
    instr, labels = [], {}
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instr.append((addr, m.group(2)))
    branches = []  # (address, target, instruction)
    for addr, text in instr:
        if "BRA" not in text.split() and "CALL.REL.NOINC" not in text:
            continue
        m = re.search(r"\(\s*(\.L_x_\d+)\s*\)|(?:BRA|NOINC)\s+(?:!?P\d+,\s*)?"
                      r"(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                               16)
        if target is not None:
            branches.append((addr, target, text))
    return instr, branches


def sass_loop_stats(kernel: str, source: str = "zen_train.cu",
                    holding: str = None):
    """Instructions in a loop of ``kernel``, from ``cuobjdump -sass`` of
    the library built from ``source``: the span of the function's widest
    backward branch (the K loop, kept rolled, of one (t, k) per lane per
    pass), or with ``holding`` the narrowest one whose span holds that
    opcode (an inner loop). None when the tool or the pattern is
    missing."""
    parsed = sass_function(kernel, source)
    if parsed is None:
        return None
    instr, branches = parsed
    best = None
    for addr, target, text in branches:
        if "BRA" not in text.split() or target >= addr:
            continue
        if holding is not None:
            if not any(holding in t for a, t in instr
                       if target <= a <= addr):
                continue
            if best is None or addr - target < best[1] - best[0]:
                best = (target, addr)
        elif best is None or addr - target > best[1] - best[0]:
            best = (target, addr)
    if best is None:
        return None
    loop = [t for a, t in instr if best[0] <= a <= best[1]]
    return {"loop_instructions": len(loop),
            "loop_mufu": sum("MUFU" in t for t in loop),
            "function_instructions": len(instr)}


def fast_loop_stats(kernel: str, topics_per_pass: int,
                    source: str = "zen_train.cu"):
    """The verified training sampler's fast loop in ``kernel``'s SASS: the
    smallest backward-branch loop that holds the estimate's MUFU.LG2 (3
    per topic); its instructions less those that a forward branch skips
    over an exact-path CALL (the rare top-bucket block), per pass and per
    (t, k), with the fast loop's opcodes counted; and the out-of-line
    exact_score's length (the CALL target up to its RET), which each exact
    topic costs. None when the tool or the pattern is missing."""
    parsed = sass_function(kernel, source)
    if parsed is None:
        return None
    instr, branches = parsed
    addrs = [a for a, _ in instr]

    def span(lo, hi):  # instructions with lo <= address <= hi
        return [(a, t) for a, t in instr if lo <= a <= hi]

    loops = [(target, addr) for addr, target, text in branches
             if "BRA" in text.split() and target < addr
             and sum("MUFU.LG2" in t for _, t in span(target, addr))
             >= 3 * topics_per_pass]
    if not loops:
        return None
    lo, hi = min(loops, key=lambda l: l[1] - l[0])
    body = span(lo, hi)
    skipped = set()
    for addr, target, text in branches:
        if "BRA" in text.split() and lo <= addr < target <= hi:
            region = [a for a, t in body if addr < a < target]
            if any("CALL" in t for a, t in body if a in region):
                skipped.update(region)
    fast = len(body) - len(skipped)
    calls = [target for addr, target, text in branches
             if "CALL.REL.NOINC" in text and lo <= addr <= hi]
    exact = None
    if calls:
        start = addrs.index(calls[0]) if calls[0] in addrs else None
        if start is not None:
            n = 0
            for _, t in instr[start:]:
                n += 1
                if any(w.startswith("RET") for w in t.split()):
                    break
            exact = n
    ops = {}
    for a, t in body:
        if a not in skipped:
            op = t.split()[0] if not t.startswith("@") else t.split()[1]
            ops[op] = ops.get(op, 0) + 1
    return {"loop_instructions": len(body),
            "fast_loop_instructions": fast,
            "fast_loop_opcodes": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])),
            "topics_per_pass": topics_per_pass,
            "fast_instructions_per_tk": fast / topics_per_pass,
            "loop_mufu": sum("MUFU" in t for _, t in body),
            "exact_score_instructions": exact,
            "function_instructions": len(instr)}


def res_usage(source: str, kernel: str):
    """``cuobjdump -res-usage`` of ``kernel`` in the library built from
    ``source``: registers, stack, shared and local (spill) bytes. None
    when the tool or the function is missing."""
    import re

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = [_build.target(s) for s in _build.SOURCES if s.name == source][0]
    try:
        out = subprocess.run([tool, "-res-usage", str(lib)],
                             capture_output=True, text=True,
                             timeout=120).stdout
    except OSError:
        return None
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "Function" in line and kernel in line and i + 1 < len(lines):
            return dict(re.findall(r"(\w+):(\d+)", lines[i + 1]))
    return None


def synthetic_nytimes(num_docs: int):
    """The corpus ``launch.train --synthetic-docs num_docs
    --synthetic-words 101636 --synthetic-len 332`` builds."""
    from repro_torch.data.corpus import synthetic_corpus

    return synthetic_corpus(0, num_docs=num_docs, num_words=W_NYT,
                            avg_doc_len=LEN_NYT, zipf_a=1.2)


# The training kernels' adversarial grid: (name, seed, T, K, W, D, counts,
# pinned {token: topic}). The pins are the plain version's own draws at
# hash coordinates chosen for them (tests/test_torch_train_kernels.py
# holds them against the JAX package's hash and oracle):
# - inf_noise: (seed 1857, row 118, topic 230) has m = 2^24 - 1, noise
#   +inf: that topic wins whatever its probability;
# - *_tie: rows of equal counts, where the noise alone decides, and rows
#   whose two largest noises are equal (m 2j, 2j + 1 round to one u), so
#   the exact scores tie and the lower topic must win: in the forced top
#   bucket (seed 88, row 642: 26 and 336), in two lanes' candidates (seed
#   2, row 760: 147 and 808) and in one lane, which sends the token to the
#   exact loop (seed 458, row 104: 254 and 893);
# - p_clamp: alpha_k from 1e-33 to 1e-23 and empty counts, so p lies on
#   both sides of the 1e-30 clamp;
# - odd_k (K = 37, one topic per lane), k_36 (a partial 128-topic pass),
#   k_10000 (the K = 10,000 configuration), premise_off (one N_k + W b
#   above 2^100: the block samples with the exact loop alone);
# - k_14464 (the largest table that fits in an H100's shared memory),
#   k_16384 and k_16385 (tables the launcher puts in global memory, with
#   4 and 1 topics per lane).
ADVERSARIAL = (
    ("inf_noise", 1857, 4096, 256, 40, 6, "random", {118: 230}),
    ("top_bucket_tie", 88, 1024, 1000, 8, 4, "equal", {642: 26}),
    ("candidates_tie", 2, 1024, 1000, 8, 4, "equal", {760: 147}),
    ("same_lane_tie", 458, 1024, 1000, 8, 4, "equal", {104: 254}),
    ("p_clamp", 7, 4096, 1000, 100, 10, "clamp", {}),
    ("odd_k", 11, 4096, 37, 50, 3, "random", {}),
    ("k_36", 12, 4096, 36, 50, 3, "random", {}),
    ("k_10000", 13, 4096, 10000, 3000, 20, "random", {}),
    ("premise_off", 14, 4096, 1000, 100, 10, "premise_off", {}),
    ("k_14464", 16, 512, 14464, 60, 8, "random", {}),
    ("k_16384", 17, 512, 16384, 60, 8, "random", {}),
    ("k_16385", 18, 512, 16385, 60, 8, "random", {}),
)


def adversarial_case(spec, dev):
    """The inputs of one :data:`ADVERSARIAL` case on ``dev``."""
    import torch

    name, seed, t, k, w, d, kind, _ = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    doc = torch.randint(0, d, (t,), generator=g, device=dev, dtype=i32)
    if kind == "equal":  # z_old = 0 is none of the pinned topics
        return dict(n_wk=torch.full((w, k), 5, dtype=i32, device=dev),
                    n_kd=torch.full((d, k), 2, dtype=i32, device=dev),
                    word=word, doc=doc,
                    z=torch.zeros(t, dtype=i32, device=dev),
                    alpha=torch.full((k,), 0.05, device=dev),
                    n_k=torch.full((k,), 1000.0, device=dev), seed=seed)
    z = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    if kind == "clamp":
        n_wk = torch.zeros((w, k), dtype=i32, device=dev)
        n_kd = torch.zeros((d, k), dtype=i32, device=dev)
    else:
        n_wk = torch.randint(0, 40, (w, k), generator=g, device=dev,
                             dtype=i32)
        n_kd = torch.randint(0, 8, (d, k), generator=g, device=dev,
                             dtype=i32)
    ones = torch.ones(t, dtype=i32, device=dev)
    n_wk.index_put_((word.long(), z.long()), ones, accumulate=True)
    n_kd.index_put_((doc.long(), z.long()), ones, accumulate=True)
    if kind == "clamp":
        alpha = 10.0 ** (torch.rand(k, generator=g, device=dev) * 10 - 33)
        n_k = torch.full((k,), 1000.0, device=dev)
    else:
        alpha = torch.rand(k, generator=g, device=dev) * 0.2 + 0.001
        n_k = n_wk.sum(0).to(torch.float32)
    if kind == "premise_off":
        n_k[5] = 1e35
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, doc=doc, z=z, alpha=alpha,
                n_k=n_k, seed=seed)


def adversarial_check(spec, dev):
    """Both training kernels on one :data:`ADVERSARIAL` case against the
    plain version: 0 mismatches, fused == gathered, the pinned draws.
    Direct launches with the stats output, outside the launch counts.
    Returns the case's summary, with where the launcher put the table."""
    import torch

    from repro_torch.kernels.fused_gather import (
        zen_fused_sample_cuda,
        zen_fused_sample_plain,
    )
    from repro_torch.kernels.zen_sampler import (
        train_global_table_entries,
        zen_sample_cuda,
    )

    name, _, t, k, w, _, _, pins = spec
    a = adversarial_case(spec, dev)
    args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
            a["n_k"], a["seed"])
    kw = dict(beta=0.01, w_beta=w * 0.01)
    plain = zen_fused_sample_plain(*args, **kw)
    rows = (a["n_wk"][a["word"].long()].contiguous(),
            a["n_kd"][a["doc"].long()].contiguous())
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    fused = zen_fused_sample_cuda(*args, stats=stats, **kw)
    gathered = zen_sample_cuda(*rows, a["z"], a["alpha"], a["n_k"],
                               a["seed"], **kw)
    torch.cuda.synchronize()
    mism = int((fused != plain).sum())
    check(bool(torch.equal(fused, gathered)),
          f"adversarial {name}: fused != gathered")
    check(mism == 0, f"adversarial {name}: {mism} kernel-vs-plain "
          "mismatches")
    exact, cands, exact_loop = stats.tolist()
    # premise_off: every token takes the exact loop; elsewhere the exact
    # chain runs for a few topics of some tokens
    check(exact_loop == t if name == "premise_off" else
          exact_loop < t and exact + cands < t * k,
          f"adversarial {name}: exact work {stats.tolist()}")
    for tok, topic in pins.items():
        check(int(plain[tok]) == topic,
              f"adversarial {name}: token {tok} drew {int(plain[tok])}, "
              f"pinned {topic}")
    table = "global" if train_global_table_entries(k, dev) else "shared"
    return {"case": name, "T": t, "K": k, "table": table,
            "stats": stats.tolist(),
            "pins": {str(tok): topic for tok, topic in pins.items()},
            "mismatches": mism}


def margin_premises(dev, kernels: str = "train"):
    """A verified sampler's margin premises by exhaustion on the card
    (``kernels``: "train" or "infer", each source's own estimate): E1 over
    every float in [1e-30, FLT_MAX], E2 over every m below the forced
    bucket (and below other widths, for the record)."""
    from repro_torch.kernels.zen_sampler import fast_score_errors

    r = fast_score_errors(dev, kernels)
    noise = r["noise_err"]
    below = {f"2^{j}": float(noise[:(1 << 24) - (1 << j)].max())
             for j in range(8, 15)}
    e2 = float(noise[:r["top_bucket"]].max())
    slack = 2.0 ** -14
    out = {"margin": r["margin"], "top_bucket": r["top_bucket"],
           "E1_log": r["log_err"], "E2_noise": e2, "slack": slack,
           "sum": r["log_err"] + e2 + slack,
           "E2_below_top_minus": below}
    check(out["sum"] <= r["margin"],
          f"margin premise broken: E1 + E2 + 2^-14 = {out['sum']} > "
          f"{r['margin']}")
    return out


def placement_boundary_ms(dev):
    """The fused kernel on both sides of the table's placement boundary
    (T = 65,536): K = 14,464, the largest table an H100 block keeps in
    shared memory, and K = 14,592, the smallest it reads from global
    memory through L1; ms per 10^9 (t, k) and where the table went."""
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda
    from repro_torch.kernels.zen_sampler import train_global_table_entries

    out = {}
    for k in (14464, 14592):
        a = adversarial_case(("boundary", 15, 1 << 16, k, 3000, 20,
                              "random", {}), dev)
        args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"],
                a["alpha"], a["n_k"], a["seed"])
        ms = cuda_ms(lambda: zen_fused_sample_cuda(*args, beta=0.01,
                                                   w_beta=30.0), reps=5)
        out[str(k)] = {
            "table": ("global" if train_global_table_entries(k, dev)
                      else "shared"),
            "ms": ms, "ms_per_1e9_tk": ms * 1e9 / ((1 << 16) * k)}
        del a, args
    return out


def phase_train_kernels(sess, st, seed: int, sm_count: int,
                        sm_clock_hz: float):
    """Both training kernels on the first KERNEL_TOKENS tokens of the
    initialised NYTIMES state, against each other and the plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gather import zen_fused_sample_plain
    from repro_torch.kernels.zen_sampler import gumbel_noise

    c, h = sess.corpus, sess.hyper
    t, k = KERNEL_TOKENS, K_NYT
    word, doc, z = c.word[:t], c.doc[:t], st.topic[:t]
    alpha = h.alpha_k(st.n_k).contiguous()
    n_k = st.n_k.to(torch.float32)
    beta, w_beta = h.beta, c.num_words * h.beta
    kseed = seed * 7919 + 1
    nwk_rows = st.n_wk[word.long()].contiguous()
    nkd_rows = st.n_kd[doc.long()].contiguous()

    def fused():
        return ops.zen_fused_sample(st.n_wk, st.n_kd, word, doc, z, alpha,
                                    n_k, kseed, beta=beta, w_beta=w_beta)

    def gathered():
        return ops.zen_sample(nwk_rows, nkd_rows, z, alpha, n_k, kseed,
                              beta=beta, w_beta=w_beta)

    def plain():
        return zen_fused_sample_plain(st.n_wk, st.n_kd, word, doc, z, alpha,
                                      n_k, kseed, beta=beta, w_beta=w_beta)

    out_f, out_g, out_p = fused(), gathered(), plain()
    torch.cuda.synchronize()
    check(bool(torch.equal(out_f, out_g)),
          "training: fused and gathered kernels disagree")
    check(int(out_f.min()) >= 0 and int(out_f.max()) < k,
          "training kernel drew a topic outside [0, K)")
    mism = (out_f != out_p).nonzero().flatten()
    gaps = []
    if mism.numel():
        m = mism.long()
        cand = torch.stack([out_f[m], out_p[m]], 1).long()
        hit = (cand == z[m, None].long()).to(torch.float32)
        nw = st.n_wk[word[m].long()].gather(1, cand).to(torch.float32) - hit
        nd = st.n_kd[doc[m].long()].gather(1, cand).to(torch.float32) - hit
        a = alpha[cand]
        p = (a * beta + nw * a + nd * (nw + beta)) / (n_k[cand] - hit
                                                      + w_beta)
        sc = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(kseed, m[:, None], cand)
        gaps = (sc[:, 0] - sc[:, 1]).abs().tolist()
    check(all(g <= NEAR_TIE for g in gaps),
          f"training kernel-vs-plain mismatches that are no near-tie: {gaps}")
    check(len(gaps) <= NEAR_TIE * t,
          f"training: {len(gaps)} kernel-vs-plain mismatches over {t}")
    # the verified design is exact: no near-tie may differ either
    check(not gaps, f"training: {len(gaps)} kernel-vs-plain mismatches")

    # the exact work these inputs need, from the kernels' stats output
    # (direct launches, outside the launch counts): topics scored exactly
    # in the pass or as z_old, rescored candidates, exact-loop tokens
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda
    stats = torch.zeros(3, dtype=torch.int64, device=st.n_wk.device)
    check(bool(torch.equal(zen_fused_sample_cuda(
        st.n_wk, st.n_kd, word, doc, z, alpha, n_k, kseed, beta=beta,
        w_beta=w_beta, stats=stats), out_f)), "training: stats run differs")
    forced, cands, fallback = stats.tolist()

    # the per-token index a mesh cell passes (its tokens' corpus
    # indices): the identity keeps every draw, a permutation pi of the
    # tokens with index pi permutes them
    ident = torch.arange(t, dtype=torch.int32, device=z.device)

    def fused_index():
        return ops.zen_fused_sample(st.n_wk, st.n_kd, word, doc, z, alpha,
                                    n_k, kseed, beta=beta, w_beta=w_beta,
                                    token_index=ident)

    def gathered_index():
        return ops.zen_sample(nwk_rows, nkd_rows, z, alpha, n_k, kseed,
                              beta=beta, w_beta=w_beta, token_index=ident)

    gen = torch.Generator(device=z.device).manual_seed(seed + 17)
    perm = torch.randperm(t, generator=gen, device=z.device)
    pl = perm.long()
    out_perm = ops.zen_fused_sample(
        st.n_wk, st.n_kd, word[pl].contiguous(), doc[pl].contiguous(),
        z[pl].contiguous(), alpha, n_k, kseed, beta=beta, w_beta=w_beta,
        token_index=perm.to(torch.int32))
    check(bool(torch.equal(fused_index(), out_f))
          and bool(torch.equal(gathered_index(), out_g))
          and bool(torch.equal(out_perm, out_f[pl])),
          "training kernels: the per-token index changed a draw")
    del out_perm, pl, perm

    ms_f = cuda_ms(fused, reps=5, warmup=1)
    ms_g = cuda_ms(gathered, reps=5, warmup=1)
    ms_fi = cuda_ms(fused_index, reps=5, warmup=1)
    ms_gi = cuda_ms(gathered_index, reps=5, warmup=1)
    ms_p = cuda_ms(plain, reps=2, warmup=0)

    uniq_w = int(torch.unique(word).numel())
    uniq_d = int(torch.unique(doc).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    bytes_f = (uniq_w + uniq_d) * k * 4 + vec + t * 3 * 4 + t * 4
    bytes_g = 2 * t * k * 4 + vec + t * 4 + t * 4
    # the operations any exact draw needs: the hash of every (t, k) for
    # its noise. This design's estimate adds three MUFU lg2 per (t, k),
    # its own floor (design_mufu_ms), and the exact chains a few per token
    # (issue bound below)
    hash_ms = (HASH_INT_OPS * t * k
               / (sm_count * INT_PER_SM_PER_CLK * sm_clock_hz) * 1e3)
    mufu = 3 * t * k
    sfu_ms = mufu / (sm_count * SFU_PER_SM_PER_CLK * sm_clock_hz) * 1e3
    topics_per_pass = 4 if k % 4 == 0 else 1
    # the instantiation the launcher takes: the table in shared memory
    # unless the library asks for global scratch
    from repro_torch.kernels.zen_sampler import train_global_table_entries
    in_shared = train_global_table_entries(k, st.n_wk.device) == 0
    inst = f"ILi{topics_per_pass}ELb{int(in_shared)}EE"
    sass = {name: fast_loop_stats(kern + inst, topics_per_pass) for name,
            kern in (("zen_fused_sample", "zen_train_fused_kernel"),
                     ("zen_sample", "zen_train_gathered_kernel"))}
    exact_share = (forced + cands + fallback * k) / (t * k)

    def row(name, replaces, ms, ms_index, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        loop = sass[name]
        issue_ms = issue_bound_ms(
            t, k, loop, {"forced": forced, "candidates": cands,
                         "exact_loop_tokens": fallback},
            sm_count, sm_clock_hz)
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_train.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps, "tokens": t,
            "ms": ms, "ms_token_index": ms_index, "plain_ms": ms_p,
            "bound_ms": max(bytes_ms, hash_ms),
            "bound_by": "bytes" if bytes_ms >= hash_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "hash_ms": hash_ms,
            "mufu_lg2": mufu, "design_mufu_ms": sfu_ms,
            "sass": loop, "exact_share": exact_share,
            "exact_work": {"forced": forced, "candidates": cands,
                           "exact_loop_tokens": fallback},
            "issue_bound_ms": issue_ms, "library_ms": None,
        }

    rows = [
        row("zen_fused_sample", "src/repro/kernels/fused_gather.py:46",
            ms_f, ms_fi, bytes_f),
        row("zen_sample", "src/repro/kernels/zen_sampler.py:105", ms_g,
            ms_gi, bytes_g),
    ]
    emit({"phase": "train_kernels", "W": W_NYT, "K": k, "T": t,
          "unique_words": uniq_w, "unique_docs": uniq_d,
          "fused_equals_gathered": True, "mismatches_vs_plain": len(gaps),
          "token_index_keeps_draws": True,
          "ms": {"fused": ms_f, "gathered": ms_g, "plain": ms_p,
                 "fused_token_index": ms_fi,
                 "gathered_token_index": ms_gi},
          "sass": sass, "exact_share": exact_share,
          "exact_work": {"forced": forced, "candidates": cands,
                         "exact_loop_tokens": fallback}})
    autotune_leg(lambda: autotune_train(
        st, word, doc, z, alpha, n_k, kseed, beta, w_beta, nwk_rows,
        nkd_rows, out_f, [forced, cands, fallback]))
    del nwk_rows, nkd_rows
    torch.cuda.empty_cache()
    dev = st.n_wk.device
    grid = [adversarial_check(spec, dev) for spec in ADVERSARIAL]
    check(any(case["table"] == "global" for case in grid),
          "adversarial grid: no case put the table in global memory")
    emit({"phase": "train_kernels_adversarial", "cases": grid,
          "margin": margin_premises(dev),
          "placement_boundary": placement_boundary_ms(dev)})
    torch.cuda.empty_cache()
    return rows


def phase_train(sess, st, smi):
    """Five iterations of the full NYTIMES run, evaluated at init and
    after each step; returns the run's launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.checkpoint import load_lda_model

    corpus = sess.corpus
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    step_s, eval_s = [], []
    for _ in range(TRAIN_ITERS):
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train", "tokens": corpus.num_tokens,
          "docs": corpus.num_docs, "W": corpus.num_words, "K": K_NYT,
          "llh": llh, "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "eval_seconds": eval_s,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train: predictive llh did not rise at every eval: {llh}")
    check(all(0 < m["change_rate"] < 1 for m in evals[1:]),
          "train: change rate outside (0, 1)")
    # one fused sweep per step, and the delta merge's kernel 5 twice (word
    # and doc rows)
    check_launches("train", counts, {"zen_fused_sample": TRAIN_ITERS,
                                     "topic_histogram": 2 * TRAIN_ITERS})
    check_record("train", llh, [m["change_rate"] for m in evals[1:]])

    ckpt = ROOT / "build" / "chip_smoke_train_model"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    sess.save_model(st, str(ckpt))
    n_wk, n_k, hyper, meta, step = load_lda_model(str(ckpt))
    t_ckpt = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    check(step == TRAIN_ITERS and hyper == sess.hyper
          and meta["algorithm"] == "zen_pallas"
          and bool((torch.from_numpy(n_wk).to(st.n_wk.device)
                    == st.n_wk).all())
          and bool((torch.from_numpy(n_k).to(st.n_k.device)
                    == st.n_k).all()),
          "train: save_model then load_lda_model changed the model")
    emit({"phase": "train_checkpoint", "seconds": t_ckpt,
          "n_wk_bytes": int(n_wk.nbytes)})
    emit({"phase": "train_profile", **profile_step(sess, st)})
    return counts


def profile_step(sess, st):
    """Device busy share and time by kernel name over one more training
    step and its eval, from ``torch.profiler``; run after the main path's
    counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("step", lambda: sess.step(st)),
                     ("eval", lambda: sess.metrics(st))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        out[name] = device_summary(prof, wall_us,
                                   groups={"delta_merge": HIST_KERNELS})
    fused = [v for k, v in out["step"]["top_device_ms"].items()
             if "zen_train_fused_kernel" in k]
    out["kernel_ms_per_launch"] = fused[0][0] / fused[0][1] if fused \
        else None
    return out


def device_summary(prof, wall_us: float, items: int = 8, groups=None):
    """Device busy time, idle share and the largest device items of one
    profiled window; ``groups`` (name -> kernel function names) sums each
    group's [ms, launches]. Only events that ran on the card count: an
    operator's host-side entry also carries its kernels' device time, and
    counting both would count that time twice."""
    import re

    from torch.autograd import DeviceType

    by_name, calls = {}, {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:items]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "host_ms": (wall_us - busy_us) / 1e3,
           "device_idle_share": (1 - busy_us / wall_us) if busy_us
           else None,
           "top_device_ms": {k[:80]: [v / 1e3, calls[k]] for k, v in top}}
    if groups:
        out["groups_ms"] = {}
        for name, fns in groups.items():
            # a template's name goes on with "<": match up to it
            keys = [k for k in by_name
                    if any(re.search(rf"::{re.escape(f)}[<(]", k)
                           for f in fns)]
            out["groups_ms"][name] = [sum(by_name[k] for k in keys) / 1e3,
                                      sum(calls[k] for k in keys)]
    return out


def phase_train_small(seed: int, dev, smi):
    """zen, zen_pallas fused and zen_pallas gathered from the same initial
    topics; returns the gathered run's launch count. Under "auto" each
    step's delta merge also launches kernel 5 twice."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_nytimes(SMALL_DOCS)
    hyper = LDAHyperParams(num_topics=K_NYT)
    runs = (("zen", "zen", "auto", None),
            ("std", "std", "auto", None),
            ("fused", "zen_pallas", "auto", "zen_fused_sample"),
            ("gathered", "zen_pallas", "off", "zen_sample"))
    topics, llh, counts_by = {}, {}, {}
    for name, algorithm, kernels, kernel in runs:
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm=algorithm, kernels=kernels), device=dev)
        st = sess.init(seed)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        topics[name] = []
        for _ in range(SMALL_ITERS):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
            topics[name].append(st.topic.clone())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        counts_by[name] = counts
        llh[name] = sess.llh(st) / corpus.num_tokens
        emit({"phase": "train_small", "run": name, "algorithm": algorithm,
              "kernels": kernels, "tokens": corpus.num_tokens,
              "seconds": secs, "llh_per_token": llh[name],
              "launches": counts, "card": smi})
        want = {} if kernel is None else {kernel: counts[kernel] or -1}
        if kernels == "auto":
            want["topic_histogram"] = 2 * SMALL_ITERS
        check_launches(f"train_small {name}", counts, want)
        del sess, st
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(topics["fused"],
                                                 topics["gathered"]))
    check(same, "train_small: fused and gathered runs drew different "
          "topics")
    check(llh["fused"] == TRAIN_SMALL_LLH,
          f"train_small: llh/token {llh['fused']} differs from the record "
          f"{TRAIN_SMALL_LLH}")
    rel = abs(llh["zen"] / llh["fused"] - 1)
    rel_std = abs(llh["std"] / llh["zen"] - 1)
    emit({"phase": "train_small_check", "fused_equals_gathered": True,
          "zen_vs_fused_llh_rel": rel, "std_vs_zen_llh_rel": rel_std})
    check(rel < 0.01, f"train_small: zen llh/token {llh['zen']} vs fused "
          f"{llh['fused']} differ by {rel:.4f} (>= 1%)")
    check(rel_std < 0.01, f"train_small: std llh/token {llh['std']} vs zen "
          f"{llh['zen']} differ by {rel_std:.4f} (>= 1%)")
    return counts_by["gathered"]["zen_sample"]


def run_training(seed: int, dev, props, smi, sm_clock_hz: float):
    """The training phases, dense, padded-sparse and CDF; returns the five
    training-side kernels' rows and their launches on their paths."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.train.session import RunConfig, TrainSession

    t0 = time.perf_counter()
    corpus = synthetic_nytimes(D_NYT)
    t_corpus = time.perf_counter() - t0
    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(algorithm="zen_pallas"),
                        device=dev)
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    emit({"phase": "train_setup", "tokens": sess.corpus.num_tokens,
          "corpus_seconds": t_corpus,
          "init_seconds": time.perf_counter() - t0})
    rows = phase_train_kernels(sess, st, seed, props.multi_processor_count,
                               sm_clock_hz)
    train_counts = phase_train(sess, st, smi)
    corpus_dev = sess.corpus
    del sess, st
    torch.cuda.empty_cache()
    trainer_counts = phase_trainer(corpus_dev, seed, dev, smi)
    quality_counts, autopilot_counts = phase_quality(corpus_dev, seed, smi)
    gathered_launches = phase_train_small(seed, dev, smi)
    sparse_counts, sparse_row = phase_train_sparse(corpus_dev, seed, smi)
    torch.cuda.empty_cache()
    cdf_rows, cdf_counts = phase_train_cdf(
        corpus_dev, seed, smi, props.multi_processor_count, sm_clock_hz)
    del corpus_dev
    torch.cuda.empty_cache()
    autotune_counts = phase_autotune(seed, dev, smi)
    phase_train_sparse_small(seed, dev, smi)
    stream_counts = phase_stream(corpus, seed, dev, smi)
    mesh_one_counts = phase_mesh_one(corpus, seed, dev, smi)
    mesh_four_counts = phase_mesh_four(corpus, seed, dev, smi)
    del corpus
    # kernel 5's launches on the delta merge of each full-width path
    merge = {"train": train_counts["topic_histogram"],
             "train_sparse": sparse_counts["topic_histogram"],
             "train_cdf": cdf_counts["topic_histogram"]}
    for row in cdf_rows:
        if row["name"] == "topic_histogram":
            row["launches_by_path"] = merge
    return rows + [sparse_row] + cdf_rows, {
        "zen_fused_sample": train_counts["zen_fused_sample"],
        "zen_sample": gathered_launches,
        "sparse_row_sample": sparse_counts["sparse_row_sample"],
        "cdf_row_search": cdf_counts["cdf_row_search"],
        "topic_histogram": train_counts["topic_histogram"]}, {
        "stream": stream_counts, "quality": quality_counts,
        "train_autopilot": autopilot_counts, "mesh_one": mesh_one_counts,
        "mesh_four": mesh_four_counts, "autotune": autotune_counts,
        "trainer": trainer_counts}


def phase_train_sparse(corpus, seed: int, smi):
    """``zen_sparse`` at full NYTIMES width from the sparse word init;
    returns the run's launch counts and the sparse-row kernel's row of the
    kernels table (from :func:`phase_sparse_kernels`)."""
    import torch

    from repro_torch import algorithms
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.core.zen_sparse import build_tables
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_sparse", init="sparse_word"), device=corpus.word.device)
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    knobs = sess.cfg.knobs()

    def tables_seconds(state, pads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab = build_tables(state.n_wk, state.n_kd, state.n_k, sess.hyper,
                           sess.corpus.num_words, pads.max_kw, pads.max_kd)
        torch.cuda.synchronize()
        del tab
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    pads_by_sweep, step_s, table_s, eval_s = [], [], [], []
    for _ in range(SPARSE_ITERS):
        pads = algorithms.resolve_row_pads(st, knobs)
        pads_by_sweep.append([pads.max_kw, pads.max_kd])
        table_s.append(tables_seconds(st, pads))
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(sess.corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train_sparse", "algorithm": "zen_sparse",
          "init": "sparse_word", "tokens": sess.corpus.num_tokens,
          "W": sess.corpus.num_words, "K": K_NYT, "init_seconds": t_init,
          "row_pads_by_sweep": pads_by_sweep, "llh": llh,
          "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "table_build_seconds": table_s,
          "eval_seconds": eval_s, "peak_device_gb": peak_gb,
          "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train_sparse: predictive llh did not rise at every eval: {llh}")
    check(counts["sparse_row_sample"] > 0,
          f"train_sparse: no sparse-row launch: {counts}")
    check_launches("train_sparse", counts, {
        "sparse_row_sample": counts["sparse_row_sample"],
        "topic_histogram": 2 * SPARSE_ITERS})
    check_record("train_sparse", llh, [m["change_rate"] for m in evals[1:]])
    emit({"phase": "train_sparse_profile",
          **profile_path_step(sess, st, ("sparse_row_kernel",))})
    row = phase_sparse_kernels(sess, st, seed)
    return counts, row


def profile_path_step(sess, st, kernels):
    """Device busy share and the largest device items of one more training
    step, after the path's counts were read; ``groups_ms`` holds the path's
    kernel (``kernels``: its device functions) and the delta merge's
    kernel 5, each [ms, launches]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.step(st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_summary(prof, wall_us, items=12, groups={
        "path_kernel": kernels, "delta_merge": HIST_KERNELS})


def phase_sparse_kernels(sess, st, seed: int):
    """Kernel 6 against its plain version on the first KERNEL_TOKENS
    tokens of the full-width zen_sparse state, on the term-3 rows and on
    SparseLDA's q rows; returns the kernel's row of the kernels table."""
    import torch

    from repro_torch import algorithms
    from repro_torch.core.baselines import sparselda_rows, sparselda_tables
    from repro_torch.core.zen_sparse import _d_sparse, build_tables
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_row import sparse_row_sample_plain

    c, h = sess.corpus, sess.hyper
    t = KERNEL_TOKENS
    pads = algorithms.resolve_row_pads(st, sess.cfg.knobs())
    args = (st.n_wk, st.n_kd, st.n_k, h, c.num_words, pads.max_kw,
            pads.max_kd)
    word, doc, z = c.word[:t], c.doc[:t], st.topic[:t]
    gen = torch.Generator(device=word.device).manual_seed(seed)
    shapes = {}
    tab = build_tables(*args)
    d_vals, d_topics = _d_sparse(tab, word, doc, h.beta)
    del tab
    shapes["term3"] = (d_vals, d_topics)
    sl = sparselda_tables(*args)
    _, _, q_vals, wk_idx = sparselda_rows(sl, word, doc, z)
    del sl
    shapes["sparselda_q"] = (q_vals, wk_idx)
    torch.cuda.empty_cache()
    runs = {}
    for name, (vals, topics) in shapes.items():
        mass = vals.sum(1)
        tgt = torch.rand(t, generator=gen, device=word.device) * mass
        tgt[:64] = mass[:64]  # a few targets on the row's mass
        tgt[64:128] = 0.0

        def kernel():
            return ops.sparse_row_sample(vals, topics, tgt)

        def plain():
            return sparse_row_sample_plain(vals, topics, tgt)

        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        mism = int((out_k != out_p).sum())
        err = float((out_k.long() - out_p.long()).abs().max())
        check(mism == 0, f"sparse_kernels {name}: {mism} kernel-vs-plain "
              f"mismatches over {t} tokens")
        ms_k = cuda_ms(kernel, reps=10)
        ms_p = cuda_ms(plain, reps=2, warmup=1)
        if name == "term3":
            autotune_leg(lambda: autotune_sparse_rows(vals, topics, tgt,
                                                      out_k))
        j = vals.shape[1]
        # the function must read every weight (it counts over all J
        # lanes), one target and one topic id per row, and write one
        # topic; whole topic rows (T J 8 + T 8 bytes) it never needs
        nbytes = t * j * 4 + t * 12
        runs[name] = {"J": j, "ms": ms_k, "plain_ms": ms_p,
                      "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes_with_topic_rows": t * j * 8 + t * 8,
                      "mismatches": mism, "max_abs_err": err}
        emit({"phase": "sparse_kernels", "rows": name, "T": t, **runs[name]})
    del shapes, d_vals, d_topics, q_vals, wk_idx
    torch.cuda.empty_cache()
    main = runs["term3"]
    return {
        "name": "sparse_row_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_row.cu",
        "replaces": "src/repro/kernels/sparse_row.py:34", "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bytes": main["bytes"], "J": main["J"], "shapes": runs,
        "res_usage": res_usage("sparse_row.cu", "sparse_row_kernel"),
        "library_ms": None,
    }


def phase_train_cdf(corpus, seed: int, smi, sm_count: int,
                    sm_clock_hz: float):
    """``zen_cdf`` at full NYTIMES width from a random init; then kernel 5
    on its last step and kernel 7 on its state. Returns the two kernels'
    rows of the kernels table and the run's launch counts."""
    import torch

    from repro_torch.algorithms.zen_cdf import CDF_CHUNK_ELEMS
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_cdf", max_kd=CDF_MAX_KD), device=corpus.word.device)
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens = sess.corpus.num_tokens
    chunk = CDF_CHUNK_ELEMS // CDF_MAX_KD
    chunks = -(-tokens // chunk)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    step_s, eval_s = [], []
    for _ in range(CDF_ITERS):
        prev = st
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(sess.corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train_cdf", "algorithm": "zen_cdf", "init": "random",
          "max_kd": CDF_MAX_KD, "tokens": tokens,
          "W": sess.corpus.num_words, "K": K_NYT, "init_seconds": t_init,
          "token_chunk": chunk, "chunks_per_sweep": chunks, "llh": llh,
          "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "eval_seconds": eval_s,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train_cdf: predictive llh did not rise at every eval: {llh}")
    # two CDF searches per token chunk, two histograms per step
    check_launches("train_cdf", counts, {
        "cdf_row_search": 2 * chunks * CDF_ITERS,
        "topic_histogram": 2 * CDF_ITERS})
    check_record("train_cdf", llh, [m["change_rate"] for m in evals[1:]])
    emit({"phase": "train_cdf_profile",
          **profile_path_step(sess, st, CDF_KERNELS)})
    hist_row = phase_histogram(sess, prev, st)
    del prev
    torch.cuda.empty_cache()
    cdf_row = phase_cdf_kernels(sess, st, seed, sm_count, sm_clock_hz)
    return [cdf_row, hist_row], counts


def phase_histogram(sess, prev, st):
    """Kernel 5 on one full-width step (``prev`` -> ``st``) as the delta
    merge runs it: doc rows in corpus order and word rows along the plan's
    word-major walk, every token weighted once. Each side is bit-equal to
    the plain version, and ``delta_counts`` on the kernel route to
    ``delta_counts`` under ``kernels="off"`` (the plain version), so the
    check is not circular. CUDA-event times of both routes and the bytes
    bound. Returns the kernel's row of the kernels table."""
    import torch

    from repro_torch.core.counts import delta_counts
    from repro_torch.kernels import ops
    from repro_torch.kernels.topic_histogram import topic_histogram_plain

    c, k = sess.corpus, K_NYT
    t = c.num_tokens
    zo, zn = prev.topic, st.topic
    orders = sess.plan.row_orders()
    check(orders[1].order is None,
          "histogram: the corpus tokens are not in doc order")
    args = (c.word, c.doc, zo, zn, c.num_words, c.num_docs, k)

    def merge(use_kernel):
        return delta_counts(*args, use_kernel=use_kernel,
                            orders=orders if use_kernel else None)

    on, off = merge(True), merge(False)
    check(all(bool(torch.equal(a, b)) for a, b in zip(on, off)),
          "histogram: delta_counts on kernel 5 differs from kernels=off")
    del on, off
    torch.cuda.empty_cache()
    merge_ms = cuda_ms(lambda: merge(True), reps=5, gate=True)
    merge_off_ms = cuda_ms(lambda: merge(False), reps=3, warmup=1)
    emit({"phase": "histogram_merge", "T": t, "K": k,
          "equals_kernels_off": True, "delta_counts_ms": merge_ms,
          "delta_counts_off_ms": merge_off_ms})
    sides = {"doc": (c.doc, c.num_docs, orders[1]),
             "word": (c.word, c.num_words, orders[0])}
    runs = {}
    for name, (rows, r, order) in sides.items():
        def kernel(order=order):
            return ops.topic_histogram(rows, zo, zn, None, r, k, order=order)

        def plain():
            return topic_histogram_plain(rows, zo, zn, None, r, k)

        diff = kernel() - plain()
        mism, err = int((diff != 0).sum()), float(diff.abs().max())
        check(mism == 0, f"histogram {name}: {mism} kernel-vs-plain "
              f"mismatches over ({r}, {k})")
        del diff
        torch.cuda.empty_cache()
        ms_k = cuda_ms(kernel, reps=5, gate=True)
        ms_p = cuda_ms(plain, reps=3, warmup=1)
        # the (R, K) output written once, three int32 ids per token read
        # once (the walk is the design's own)
        nbytes = r * k * 4 + t * 12
        runs[name] = {"R": r, "ms": ms_k, "plain_ms": ms_p,
                      "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "walk": "tokens" if order.order is None
                      else "word-major permutation",
                      "mismatches": mism, "max_abs_err": err}
        emit({"phase": "histogram", "rows": name, "T": t, "K": k,
              "changed_tokens": int((zn != zo).sum()), "equals_plain": True,
              **runs[name]})
    torch.cuda.empty_cache()
    main = runs["doc"]
    return {
        "name": "topic_histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topic_histogram.cu",
        "replaces": "src/repro/kernels/topic_histogram.py:31",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bytes": main["bytes"], "R": main["R"], "shapes": runs,
        "delta_counts_ms": merge_ms, "delta_counts_off_ms": merge_off_ms,
        "sass": sass_loop_stats("hist_sorted_kernel", "topic_histogram.cu",
                                holding="ATOMS"),
        "res_usage": {f: res_usage("topic_histogram.cu", f)
                      for f in HIST_KERNELS},
        # two accumulating index_put_ calls (the plain version itself)
        "library_ms": main["plain_ms"],
    }


def phase_cdf_kernels(sess, st, seed: int, sm_count: int,
                      sm_clock_hz: float):
    """Kernel 7 against its plain version on the first KERNEL_TOKENS tokens
    of the full-width zen_cdf state: on the path's term-2 targets of draw a
    (tokens whose draw takes another term search target 0) and on targets
    uniform over each word's row; times beside the ``kernels="off"`` route
    and the bounds. Returns the kernel's row of the kernels table."""
    import torch

    from repro_torch.algorithms import zen_cdf as zc
    from repro_torch.core.keys import fold_in, key_seed, stream_uniforms
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdf_search import cdf_row_search_plain

    c, h = sess.corpus, sess.hyper
    t, k = KERNEL_TOKENS, K_NYT
    word, doc = c.word[:t], c.doc[:t]
    tab = zc.build_cdf_tables(st.n_wk, st.n_kd, st.n_k, h, c.num_words,
                              CDF_MAX_KD, use_kernel=True)
    _, d_cdf = zc.doc_rows(tab, word, doc, st.n_wk, h)
    m1 = tab.g_cdf[-1]
    m12 = m1 + tab.m2_all[word.long()]
    sweep_seed = key_seed(fold_in(st.rng, st.iteration))
    u = stream_uniforms(sweep_seed, 0, t, zc.CDF_STREAMS,
                        device=word.device)[0] * (m12 + d_cdf[:, -1])
    del d_cdf
    term1 = (u >= m1) & (u < m12)
    gen = torch.Generator(device=word.device).manual_seed(seed)
    targets = {
        "path": torch.where(term1, torch.clamp_min(u - m1, 0.0), 0.0),
        "uniform": torch.rand(t, generator=gen, device=word.device)
        * (m12 - m1),
    }
    term = tab.terms.t4
    w_cdf = torch.cumsum(st.n_wk.to(torch.float32) * term[None, :], dim=-1)
    w_cdf_ms = cuda_ms(lambda: torch.cumsum(
        st.n_wk.to(torch.float32) * term[None, :], dim=-1), reps=3)
    # the walk's strip loop: CDF_STRIPS strips per pass, unrolled
    loop = sass_loop_stats("cdf_walk_kernel", "cdf_search.cu",
                           holding="SHFL.UP")
    issue_rate = sm_count * INSTR_PER_SM_PER_CLK * sm_clock_hz
    runs = {}
    for name, tgt in targets.items():
        def kernel():
            return ops.cdf_row_search(st.n_wk, word, term, tgt)

        def plain():
            return cdf_row_search_plain(st.n_wk, word, term, tgt)

        def off():
            return zc._bsearch_gather(w_cdf, word, tgt)

        out_k, out_p, out_o = kernel(), plain(), off()
        torch.cuda.synchronize()
        mism = int((out_k != out_p).sum())
        err = float((out_k.long() - out_p.long()).abs().max())
        check(mism == 0, f"cdf_kernels {name}: {mism} kernel-vs-plain "
              f"mismatches over {t} tokens")
        ms_k = cuda_ms(kernel, reps=10, gate=True)
        ms_host = cuda_ms(kernel, reps=10)  # at the host's launch pace
        ms_p = cuda_ms(plain, reps=2, warmup=1)
        ms_o = cuda_ms(off, reps=10)
        if name == "path":
            autotune_leg(lambda: autotune_cdf_rows(st.n_wk, word, term, tgt,
                                                   out_k))
        # what this data needs: a token with target <= 0 reads nothing; the
        # others the row's counts up to the answer (all K when clamped)
        live = tgt > 0
        need = torch.where(live, out_k.long() + 1, 0)
        row_need = torch.zeros(st.n_wk.shape[0], dtype=torch.int64,
                               device=word.device).scatter_reduce_(
            0, word.long(), need, reduce="amax")
        nbytes = int(row_need.sum()) * 4 + k * 4 + t * 12
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # a multiply, an add and a compare per needed element, float32
        flops = 3 * int(need.sum())
        flops_ms = flops / FP32_FLOPS * 1e3
        strips = int(torch.where(live, out_k.long() // 32 + 1, 0).sum())
        issue_ms = (strips * 32 * loop["loop_instructions"] / CDF_STRIPS
                    / issue_rate * 1e3 if loop else None)
        runs[name] = {
            "ms": ms_k, "ms_host_paced": ms_host, "plain_ms": ms_p,
            "off_route_search_ms": ms_o,
            "off_route_matches": float((out_o == out_k).float().mean()),
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "bytes_no_reuse": int(need.sum()) * 4 + k * 4 + t * 12,
            # whole rows of the distinct words, as if no walk stopped early
            "bytes_whole_rows": int(torch.unique(word).numel()) * k * 4
            + k * 4 + t * 12,
            "flops": flops, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "strips_walked": strips, "issue_bound_ms": issue_ms,
            "searching_tokens": int(live.sum()), "mismatches": mism,
            "max_abs_err": err,
        }
        emit({"phase": "cdf_kernels", "targets": name, "T": t, "K": k,
              "w_cdf_build_ms": w_cdf_ms, "sass": loop, **runs[name]})
    del w_cdf, tab, targets
    torch.cuda.empty_cache()
    main = runs["path"]
    return {
        "name": "cdf_row_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cdf_search.cu",
        "replaces": "src/repro/kernels/cdf_search.py:36", "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bytes": main["bytes"], "issue_bound_ms": main["issue_bound_ms"],
        "off_route_ms": main["off_route_search_ms"],
        "w_cdf_build_ms": w_cdf_ms, "shapes": runs, "sass": loop,
        "res_usage": {f: res_usage("cdf_search.cu", f)
                      for f in CDF_KERNELS},
        # no one PyTorch call computes it
        "library_ms": None,
    }


def autotune_train(st, word, doc, z, alpha, n_k, kseed, beta, w_beta,
                   nwk_rows, nkd_rows, out_f, stats_default):
    """The autotune phase on train_kernels' inputs: kernels 1 and 2 at
    every block shape (draws and exact-work stats equal to the default
    shape's, CUDA-event times as the kernels table takes them), then
    ``autotune_fused``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import autotune_fused
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda

    kw = dict(beta=beta, w_beta=w_beta)

    def fused():
        return ops.zen_fused_sample(st.n_wk, st.n_kd, word, doc, z, alpha,
                                    n_k, kseed, **kw)

    def gathered():
        return ops.zen_sample(nwk_rows, nkd_rows, z, alpha, n_k, kseed, **kw)

    rows = []
    for warps in shapes_of("zen_train.cu"):
        with at_shape("zen_train.cu", warps):
            stats = torch.zeros(3, dtype=torch.int64, device=z.device)
            out_s = zen_fused_sample_cuda(st.n_wk, st.n_kd, word, doc, z,
                                          alpha, n_k, kseed, stats=stats,
                                          **kw)
            same = (bool(torch.equal(fused(), out_f))
                    and bool(torch.equal(gathered(), out_f))
                    and bool(torch.equal(out_s, out_f))
                    and stats.tolist() == stats_default)
            check(same, f"autotune: kernels 1-2 at {warps} warps drew "
                  f"other topics or stats ({stats.tolist()} vs "
                  f"{stats_default})")
            rows.append({"warps": warps, "bit_equal": True,
                         "fused_ms": cuda_ms(fused, reps=5, warmup=1),
                         "gathered_ms": cuda_ms(gathered, reps=5,
                                                warmup=1)})
    timings = autotune_fused(st.n_wk, st.n_kd, word, doc, z, alpha, n_k,
                             kseed, bts=(128, 256), bks=(512,), iters=5,
                             **kw)
    AUTOTUNE["timings"] += timings
    AUTOTUNE["sweeps"]["zen_fused_sample+zen_sample"] = {
        "T": int(word.shape[0]), "K": int(alpha.shape[0]), "shapes": rows,
        "autotune_us": [[t.bt, t.bk, t.us_per_call] for t in timings]}


def autotune_sparse_rows(vals, topics, tgt, out_default):
    """The autotune phase on sparse_kernels' term-3 rows: kernel 6 at
    every block shape, equal to the default's, timed; then
    ``autotune_sparse``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import autotune_sparse

    def kernel():
        return ops.sparse_row_sample(vals, topics, tgt)

    rows = []
    for warps in shapes_of("sparse_row.cu"):
        with at_shape("sparse_row.cu", warps):
            check(bool(torch.equal(kernel(), out_default)),
                  f"autotune: kernel 6 at {warps} warps drew other topics")
            rows.append({"warps": warps, "bit_equal": True,
                         "ms": cuda_ms(kernel, reps=10)})
    timings = autotune_sparse(vals, topics, tgt, bts=(128, 256),
                              bss=(128,), iters=5)
    AUTOTUNE["timings"] += timings
    AUTOTUNE["sweeps"]["sparse_row_sample"] = {
        "T": int(vals.shape[0]), "J": int(vals.shape[1]), "shapes": rows,
        "autotune_us": [[t.bt, t.bs, t.us_per_call] for t in timings]}


def autotune_cdf_rows(counts, rows_ids, term, tgt, out_default):
    """The autotune phase on cdf_kernels' path targets: kernel 7 at every
    block shape, equal to the default's, timed gated; then
    ``autotune_cdf``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import autotune_cdf

    def kernel():
        return ops.cdf_row_search(counts, rows_ids, term, tgt)

    rows = []
    for threads in shapes_of("cdf_search.cu"):
        with at_shape("cdf_search.cu", threads):
            check(bool(torch.equal(kernel(), out_default)),
                  f"autotune: kernel 7 at {threads} threads drew other "
                  f"topics")
            rows.append({"threads": threads, "bit_equal": True,
                         "ms": cuda_ms(kernel, reps=10, gate=True)})
    timings = autotune_cdf(counts, rows_ids, term, tgt, bts=(128, 256),
                           bks=(512,), iters=5)
    AUTOTUNE["timings"] += timings
    AUTOTUNE["sweeps"]["cdf_row_search"] = {
        "T": int(rows_ids.shape[0]), "K": int(term.shape[0]),
        "shapes": rows,
        "autotune_us": [[t.bt, t.bk, t.us_per_call] for t in timings]}


def phase_autotune(seed: int, dev, smi):
    """The autotune phase's last leg: ``apply_best`` over the three
    sweeps' timings, then the train_small corpus for AUTOTUNE_ITERS
    iterations of ``zen_pallas`` (fused and gathered), ``zen_sparse`` and
    ``zen_cdf`` under the default knobs and the tuned ones: each run's
    state equal to the default knobs' run. Returns the phase's launches
    (all legs)."""
    import dataclasses

    import torch

    from repro_torch.algorithms import SamplerKnobs
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels.autotune import apply_best
    from repro_torch.train.session import RunConfig, TrainSession

    default = SamplerKnobs()
    tuned = apply_best(AUTOTUNE["timings"], default)
    knob_sets = {"default": default, "tuned": tuned}
    corpus = synthetic_nytimes(SMALL_DOCS)
    hyper = LDAHyperParams(num_topics=K_NYT)
    runs = (("zen_pallas", "auto"), ("zen_pallas", "off"),
            ("zen_sparse", "auto"), ("zen_cdf", "auto"))

    def train_small():
        digests = {}
        for label, kn in knob_sets.items():
            for algorithm, kernels in runs:
                sess = TrainSession(corpus, hyper, RunConfig(
                    algorithm=algorithm, kernels=kernels, bt=kn.bt,
                    bk=kn.bk, bs=kn.bs, max_kd=CDF_MAX_KD
                    if algorithm == "zen_cdf" else 0), device=dev)
                st = sess.init(seed)
                for _ in range(AUTOTUNE_ITERS):
                    st = sess.step(st)
                    st.check_invariants(sess.corpus)
                digests[(label, algorithm, kernels)] = _digest(
                    st.topic, st.n_wk, st.n_kd, st.n_k)
                del sess, st
        return digests

    digests = autotune_leg(train_small)
    for (label, algorithm, kernels), d in digests.items():
        check(d == digests[("default", algorithm, kernels)],
              f"autotune: {algorithm} (kernels={kernels}) under the "
              f"{label} knobs trained another state than the default's")
    torch.cuda.empty_cache()
    launches = dict(AUTOTUNE["launches"])
    for name in ("zen_sample", "zen_fused_sample", "sparse_row_sample",
                 "cdf_row_search"):
        check(launches.get(name, 0) > 0,
              f"autotune: {name} was not launched: {launches}")
    emit({"phase": "autotune", "sweeps": AUTOTUNE["sweeps"],
          "apply_best": dataclasses.asdict(tuned),
          "train_small": {"iterations": AUTOTUNE_ITERS,
                          "tokens": corpus.num_tokens,
                          "knob_sets": {k: dataclasses.asdict(v)
                                        for k, v in knob_sets.items()},
                          "states_equal_default": True},
          "seconds": AUTOTUNE["seconds"], "launches": launches,
          "card": smi})
    return launches


def phase_trainer(corpus, seed: int, dev, smi):
    """``LDATrainer`` (the deprecated shims) at NYTIMES width on the train
    cell's corpus, ``zen_pallas`` fused: ``train(key, 2)`` and ``train(key,
    1)`` then ``train(key, 1, state=...)``, each state's SHA-256 (topics and
    counts) equal to ``TrainSession.run``'s from the same key; kernels 2
    and 5 launched (one and two a step). Returns the phase's launches."""
    import torch

    from repro_torch.core import LDATrainer, TrainConfig
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_pallas", num_iterations=TRAINER_ITERS), device=dev)
    want = sess.run(seed)
    want_sha = _digest(want.topic, want.n_wk, want.n_kd, want.n_k)
    del sess, want
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = LDATrainer(corpus, hyper, TrainConfig(algorithm="zen_pallas"),
                         device=dev)
    straight = trainer.train(seed, TRAINER_ITERS)
    torch.cuda.synchronize()
    t_straight = time.perf_counter() - t0
    straight_sha = _digest(straight.topic, straight.n_wk, straight.n_kd,
                           straight.n_k)
    del straight
    half = trainer.train(seed, TRAINER_ITERS // 2)
    resumed = trainer.train(seed, TRAINER_ITERS - TRAINER_ITERS // 2,
                            state=half)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    resumed_sha = _digest(resumed.topic, resumed.n_wk, resumed.n_kd,
                          resumed.n_k)
    iteration = int(resumed.iteration)
    del half, resumed, trainer
    torch.cuda.empty_cache()
    emit({"phase": "trainer", "tokens": corpus.num_tokens, "K": K_NYT,
          "iterations": TRAINER_ITERS, "session_sha256": want_sha,
          "trainer_sha256": straight_sha, "resumed_sha256": resumed_sha,
          "straight_seconds": t_straight, "launches": counts, "card": smi})
    check(straight_sha == want_sha,
          "trainer: LDATrainer.train differs from TrainSession.run")
    check(resumed_sha == want_sha and iteration == TRAINER_ITERS,
          "trainer: train then train(state=...) differs from the straight "
          "run")
    check_launches("trainer", counts, {
        "zen_fused_sample": 2 * TRAINER_ITERS,
        "topic_histogram": 4 * TRAINER_ITERS})
    return counts


def phase_train_sparse_small(seed: int, dev, smi):
    """The padded-sparse backends, ``zen_cdf`` on and off its kernel and
    the dense ``zen`` from one set of initial topics on the train_small
    corpus."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_nytimes(SMALL_DOCS)
    hyper = LDAHyperParams(num_topics=K_NYT)
    # (run, algorithm, kernels policy, the one kernel it launches)
    sparse = "sparse_row_sample"
    runs = (("zen", "zen", "auto", None),
            ("zen_sparse", "zen_sparse", "auto", sparse),
            ("sparselda", "sparselda", "auto", sparse),
            ("zen_hybrid", "zen_hybrid", "auto", sparse),
            ("lightlda", "lightlda", "auto", sparse),
            ("lightlda_off", "lightlda", "off", None),
            ("zen_cdf", "zen_cdf", "auto", "cdf_row_search"),
            ("zen_cdf_off", "zen_cdf", "off", None))
    init_topics, llh = None, {}
    for name, algorithm, kernels, kernel in runs:
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm=algorithm, kernels=kernels), device=dev)
        if init_topics is None:
            init_topics = sess.init(seed).topic.cpu().numpy()
        st = sess.init(seed, init_topics=init_topics)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(SMALL_ITERS):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        llh[name] = sess.llh(st) / corpus.num_tokens
        emit({"phase": "train_sparse_small", "run": name,
              "algorithm": algorithm, "kernels": kernels,
              "tokens": corpus.num_tokens, "seconds": secs,
              "llh_per_token": llh[name], "launches": counts, "card": smi})
        want = {} if kernel is None else {kernel: counts[kernel] or -1}
        if kernels == "auto":
            want["topic_histogram"] = 2 * SMALL_ITERS
        check_launches(f"train_sparse_small {name}", counts, want)
        del sess, st
        torch.cuda.empty_cache()
    rel = {n: abs(v / llh["zen"] - 1) for n, v in llh.items()}
    emit({"phase": "train_sparse_small_check", "llh_rel_to_zen": rel})
    bad = {n: r for n, r in rel.items() if r >= SPARSE_LLH_BAND}
    check(not bad, f"train_sparse_small: llh/token off zen's by >= "
          f"{SPARSE_LLH_BAND:.0%}: {bad} ({llh})")


def stream_source(corpus, window_docs: int, epochs: int):
    """A ``ReplaySource`` that also records the host milliseconds of each
    window's slice (``slice_ms``, in call order)."""
    from repro_torch.data.stream import ReplaySource

    class TimedReplay(ReplaySource):
        def window_slice(self, slice_index):
            t0 = time.perf_counter()
            w = super().window_slice(slice_index)
            self.slice_ms.append((time.perf_counter() - t0) * 1e3)
            return w

    src = TimedReplay(corpus, window_docs, epochs=epochs)
    src.slice_ms = []
    return src


def stream_window_record(sess, src, m, tokens_seen=None):
    """One window's line: its metrics, milliseconds by phase and rates,
    after the count checks (``n_k == n_wk.sum(0)``, both >= 0, and with
    ``tokens_seen`` the conserved token total)."""
    import math

    import torch

    check(bool(torch.equal(sess.n_k, sess.n_wk.sum(0, dtype=torch.int32))),
          f"stream window {m['window']}: n_k != n_wk.sum(0)")
    check(bool((sess.n_wk >= 0).all()) and bool((sess.n_k >= 0).all()),
          f"stream window {m['window']}: a negative count")
    if tokens_seen is not None:
        check(int(sess.n_k.sum(dtype=torch.int64)) == tokens_seen,
              f"stream window {m['window']}: {int(sess.n_k.sum())} tokens "
              f"in the model, {tokens_seen} seen")
    check(math.isfinite(m["perplexity"]),
          f"stream window {m['window']}: perplexity {m['perplexity']}")
    t = sess.timings
    dt = m["docs"] / m["docs_per_sec"]
    return {"window": m["window"], "uid": m["uid"], "docs": m["docs"],
            "tokens": m["tokens"], "perplexity": m["perplexity"],
            "change_rate": m["change_rate"],
            "docs_per_sec": m["docs_per_sec"],
            "tokens_per_sec": m["tokens"] / dt,
            "ms": {"slice": src.slice_ms[-1] if src.slice_ms else None,
                   "copy": t["plan"], "compose": t["compose"],
                   "sweeps": t["sweeps"], "eval": t["eval"],
                   "decay": t["decay"], "retire": t["retire"]}}


def serving_controls(engine, docs):
    """The following engine once the trainer is idle and its watcher is
    stopped, at three loads on its last model: the stream's closed-loop
    client (64 documents in flight for STREAM_IDLE_SERVE_S seconds) and
    N_DOCS documents at once, both under the background ticker, then
    N_DOCS at once stepped inline by ``result``, as the serving phase
    serves them."""
    import numpy as np

    def run(batches):
        lat, n = [], 0
        t0 = time.perf_counter()
        for batch in batches:
            tickets = [engine.submit_async(d) for d in batch]
            reqs = [engine.request(t) for t in tickets]
            for t in tickets:
                engine.result(t, timeout=120)
            lat += [(r.t_done - r.t_submit) * 1e3 for r in reqs]
            n += len(batch)
        secs = time.perf_counter() - t0
        return {"docs": n, "seconds": secs, "docs_per_sec": n / secs,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}

    def closed_loop():
        t_end, i = time.perf_counter() + STREAM_IDLE_SERVE_S, 0
        while time.perf_counter() < t_end:
            yield [docs[(i + j) % len(docs)] for j in range(64)]
            i += 64

    burst = [docs[:N_DOCS]]
    out = {}
    engine.start(0.001)
    try:
        out["ticker_64_in_flight"] = run(closed_loop())
        out["ticker_at_once"] = run(burst)
    finally:
        engine.stop()
    out["inline_at_once"] = run(burst)
    return out


def stream_fused_vs_plain(corpus, hyper, seed: int, dev):
    """Kernel 2 at the stream's shapes: the inputs of the first sweep of
    one STREAM_WINDOW_DOCS window (the stream's first window, fresh
    topics), captured from the session's own call, against the plain
    version on the same inputs. The plain version materialises (T, K)
    floats, so it runs in KERNEL_TOKENS slices at their token offsets."""
    import torch

    import repro_torch.algorithms.zen_pallas as zen_pallas
    from repro_torch.kernels.fused_gather import zen_fused_sample_plain
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    seen = []
    real = zen_pallas.zen_fused_sample

    def record(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, kseed, *,
               beta, w_beta, **kw):
        out = real(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, kseed,
                   beta=beta, w_beta=w_beta, **kw)
        if not seen:
            seen.append(dict(
                n_wk=n_wk.clone(), n_kd=n_kd.clone(), word=word.clone(),
                doc=doc.clone(), z=z_old.clone(), alpha=alpha_k.clone(),
                n_k=n_k.clone(), seed=kseed, beta=beta, w_beta=w_beta,
                out=out.clone()))
        return out

    zen_pallas.zen_fused_sample = record
    try:
        StreamingSession(stream_source(corpus, STREAM_WINDOW_DOCS, 1), hyper,
                         RunConfig(algorithm="zen_pallas", kernels="auto",
                                   num_iterations=1,
                                   window_docs=STREAM_WINDOW_DOCS,
                                   window_sweeps=1),
                         device=dev).run(seed)
    finally:
        zen_pallas.zen_fused_sample = real
    check(len(seen) == 1, "stream: kernel 2 was not called on the window")
    a = seen[0]
    t = a["word"].shape[0]
    mismatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, t, KERNEL_TOKENS):
        end = min(t, start + KERNEL_TOKENS)
        plain = zen_fused_sample_plain(
            a["n_wk"], a["n_kd"], a["word"][start:end], a["doc"][start:end],
            a["z"][start:end], a["alpha"], a["n_k"], a["seed"],
            beta=a["beta"], w_beta=a["w_beta"], row_offset=start)
        mismatches += int((plain != a["out"][start:end]).sum())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the verified design is exact: not even a near-tie may differ
    check(mismatches == 0, f"stream: kernel 2 differs from its plain "
          f"version on {mismatches} of {t} window tokens")
    return {"window_docs": STREAM_WINDOW_DOCS, "tokens": t,
            "docs_in_window": int(a["n_kd"].shape[0]),
            "mismatches": mismatches, "plain_seconds": plain_s}


def phase_stream(corpus, seed: int, dev, smi):
    """The live pipeline on the card: streaming training (the NYTIMES
    corpus replayed in windows) and a serving engine that hot-reloads the
    trainer's model checkpoints. Four legs (see the module docstring);
    returns the stream path's launch counts."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from repro_torch.core.types import Corpus, LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    hyper = LDAHyperParams(num_topics=K_NYT)
    build = ROOT / "build"
    models_dir = build / "chip_smoke_stream_models"
    resume_dir = build / "chip_smoke_stream_resume"
    for d in (models_dir, resume_dir):
        shutil.rmtree(d, ignore_errors=True)

    # -- leg 1: rotation (zen_pallas fused) followed by a serving engine --
    t0 = time.perf_counter()
    src = stream_source(corpus, STREAM_WINDOW_DOCS, epochs=2)
    source_s = time.perf_counter() - t0
    cfg = RunConfig(algorithm="zen_pallas", kernels="auto",
                    num_iterations=STREAM_WINDOWS,
                    window_docs=STREAM_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS,
                    checkpoint_dir=str(models_dir),
                    checkpoint_every=STREAM_SAVE_EVERY)
    sess = StreamingSession(src, hyper, cfg, device=dev)
    saves, bumps, windows = [], [], []
    live = {"engine": None, "tokens_seen": 0, "waited": 0}
    served, served_lock = [], threading.Lock()
    stop = threading.Event()
    threads = []
    real_save = sess.save_model

    def timed_save(directory=None):
        t = time.perf_counter()
        path = real_save(directory)
        done = time.perf_counter()
        saves.append({"step": sess.windows_done, "ms": (done - t) * 1e3,
                      "committed_at": done})
        return path

    sess.save_model = timed_save
    first = src.window_slice(0).corpus
    bounds = np.searchsorted(first.doc.numpy(),
                             np.arange(first.num_docs + 1))
    docs = [first.word.numpy()[bounds[d]:bounds[d + 1]]
            for d in range(first.num_docs)]
    src.slice_ms.clear()

    def client(engine):
        """Closed loop: 64 documents in flight, each batch reaped before
        the next is submitted."""
        i = 0
        while not stop.is_set():
            batch = [docs[(i + j) % len(docs)] for j in range(64)]
            i += 64
            tickets = [engine.submit_async(d) for d in batch]
            reqs = [engine.request(t) for t in tickets]
            thetas = [engine.result(t, timeout=120) for t in tickets]
            with served_lock:
                served.extend(
                    (r.uid, r.model_version, len(r.words),
                     bool(np.isfinite(th).all()), r.t_done - r.t_submit,
                     r.t_done)
                    for r, th in zip(reqs, thetas))

    def monitor(engine):
        version = engine.model_version
        while not stop.is_set():
            v = engine.model_version
            if v != version:
                bumps.append({"version": v, "at": time.perf_counter()})
                version = v
            time.sleep(0.002)

    def wait_version(engine, version):
        deadline = time.monotonic() + 60
        while engine.model_version < version \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        check(engine.model_version >= version,
              f"stream: the engine did not reach model version {version} "
              f"within 60 s of its checkpoint (at {engine.model_version}; "
              f"watcher error {engine.watch_error})")

    def on_window(s, m):
        if m["window"] < src.windows_per_epoch:
            live["tokens_seen"] += m["tokens"]
        windows.append(stream_window_record(s, src, m, live["tokens_seen"]))
        eng = live["engine"]
        if eng is None and saves:
            # the first model checkpoint is on disk: serve it, follow
            model = FrozenLDAModel.from_checkpoint(str(models_dir),
                                                   device=dev)
            eng = LDAEngine(model, LDAServeConfig(
                buckets=(128, 256, 512), max_batch=SLOTS, num_sweeps=10,
                algorithm="zen_pallas"), seed=seed)
            eng.warm()
            eng.start(0.001)
            eng.watch_checkpoint_dir(str(models_dir), period=0.2,
                                     initial_step=saves[0]["step"])
            live["engine"], live["t_engine"] = eng, time.perf_counter()
            live["waited"] = 1
            for fn in (client, monitor):
                th = threading.Thread(target=fn, args=(eng,), daemon=True)
                th.start()
                threads.append(th)
        elif eng is not None and len(saves) > live["waited"]:
            # the save after the previous window: wait for its reload
            wait_version(eng, len(saves) - 1)
            live["waited"] = len(saves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(seed, callback=on_window)
    eng = live["engine"]
    check(eng is not None, "stream: no model checkpoint started the engine")
    wait_version(eng, len(saves) - 1)
    t_idle = time.monotonic()
    time.sleep(STREAM_IDLE_SERVE_S)  # serving on, the trainer idle
    stop.set()
    for th in threads:
        th.join()
    t_serve = time.perf_counter() - live["t_engine"]
    watch_err = eng.stop_watching()
    eng.stop()
    torch.cuda.synchronize()
    leg1_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "stream_serve_control", "version": eng.model_version,
          **serving_controls(eng, docs), "card": smi})
    for w in windows:
        emit({"phase": "stream_window", "leg": "rotation", **w})
    check(watch_err is None, f"stream: checkpoint watcher failed: "
          f"{watch_err}")
    check(len(windows) == STREAM_WINDOWS and sess.windows_done
          == STREAM_WINDOWS, f"stream: {len(windows)} windows run")
    check(all(x[3] for x in served) and len(served) > 0,
          f"stream: {sum(not x[3] for x in served)} of {len(served)} "
          f"thetas not finite")
    # one bucket admits in submission order and never mixes versions, so
    # versions never decrease within a bucket; across buckets a later
    # short document may be admitted before an earlier long one
    by_bucket = {}
    for uid, version, n, *_ in sorted(served):
        bl = next((b for b in (128, 256, 512) if n <= b), 512)
        by_bucket.setdefault(bl, []).append(version)
    check(all(v == sorted(v) for v in by_bucket.values()),
          "stream: request versions decrease within a bucket")
    last_version = sorted(served)[-1][1]
    check(last_version >= 2, f"stream: the last request decoded under "
          f"version {last_version}, not >= 2")
    reloads = []
    for k, save in enumerate(saves[1:], start=1):
        bump = next((b for b in bumps if b["version"] >= k), None)
        reloads.append(None if bump is None else
                       (bump["at"] - save["committed_at"]) * 1e3)
    t0 = time.perf_counter()
    st = sess.assembled_state()
    assemble_s = time.perf_counter() - t0
    check(bool(torch.equal(st.n_wk, sess.n_wk))
          and bool(torch.equal(st.n_k, sess.n_k)),
          "stream: the session's counts differ from assembled_state()'s")
    del st
    lat = sorted(x[4] * 1e3 for x in served)
    idle_docs = sum(t_idle <= x[5] < t_idle + STREAM_IDLE_SERVE_S
                    for x in served)
    emit({"phase": "stream", "leg": "rotation", "windows": len(windows),
          "window_docs": STREAM_WINDOW_DOCS, "sweeps": STREAM_SWEEPS,
          "source_seconds": source_s, "leg_seconds": leg1_s,
          "model_save_ms": [x["ms"] for x in saves],
          "model_save_steps": [x["step"] for x in saves],
          "reload_latency_ms": reloads,
          "engine_versions": eng.model_version, "reloads": eng.reloads,
          "served_docs": len(served), "serve_seconds": t_serve,
          "serve_docs_per_sec": len(served) / t_serve,
          "serve_docs_per_sec_trainer_idle": idle_docs / STREAM_IDLE_SERVE_S,
          "serve_p50_ms": lat[len(lat) // 2],
          "serve_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
          "versions_by_bucket": {b: sorted(set(v))
                                 for b, v in by_bucket.items()},
          "assembled_seconds": assemble_s, "peak_device_gb": peak_gb,
          "launches": counts, "card": smi})
    for name in ("zen_fused_sample", "topic_histogram",
                 "zen_fused_infer_sample"):
        check(counts[name] > 0, f"stream: {name} was not launched")
    for name in ("zen_sample", "zen_infer_sample"):
        check(counts[name] == 0, f"stream: {name} (gathered) launched")
    # one profiled window (w2 again) after the checks
    from torch.profiler import ProfilerActivity, profile

    window = next(src.windows(start=STREAM_WINDOWS))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run_window(window)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "stream_profile", "window": window.index,
          "uid": window.uid, "ms": sess.timings,
          **device_summary(prof, wall_us,
                           groups={"delta_merge": HIST_KERNELS})})
    del sess, src, prof
    torch.cuda.empty_cache()

    # -- leg 2: decay (zen_cdf, kernel 7), four fresh windows -------------
    src = stream_source(corpus, STREAM_WINDOW_DOCS, epochs=1)
    cfg = RunConfig(algorithm="zen_cdf", kernels="auto", max_kd=CDF_MAX_KD,
                    num_iterations=DECAY_WINDOWS,
                    window_docs=STREAM_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS, decay=STREAM_DECAY)
    sess = StreamingSession(src, hyper, cfg, device=dev)
    windows, decay = [], {}

    def on_decay_window(s, m):
        windows.append(stream_window_record(s, src, m))
        if m["window"] != 1:
            return
        # one transition: the session's device decay against np.rint on
        # the host in float64, then the counts are put back
        kept = (s.n_wk, s.n_k)
        t = time.perf_counter()
        host = s.n_wk.cpu().numpy()
        decay["copy_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = np.rint(host.astype(np.float64)
                       * (1.0 - STREAM_DECAY)).astype(np.int32)
        decay["host_rint_ms"] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        s._apply_decay()
        torch.cuda.synchronize()
        decay["device_ms"] = (time.perf_counter() - t) * 1e3
        decay["equal"] = bool(np.array_equal(s.n_wk.cpu().numpy(), want)) \
            and bool(np.array_equal(s.n_k.cpu().numpy(),
                                    want.sum(0).astype(np.int32)))
        decay["ties"] = int((host.astype(np.float64) * (1.0 - STREAM_DECAY)
                             % 1.0 == 0.5).sum())
        s.n_wk, s.n_k = kept

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(seed, callback=on_decay_window)
    torch.cuda.synchronize()
    leg2_s = time.perf_counter() - t0
    cdf_counts = ops.launch_counts()
    for w in windows:
        emit({"phase": "stream_window", "leg": "decay", **w})
    emit({"phase": "stream", "leg": "decay", "windows": len(windows),
          "decay": STREAM_DECAY, "leg_seconds": leg2_s, "transition": decay,
          "launches": cdf_counts, "card": smi})
    check(len(windows) == DECAY_WINDOWS, f"decay: {len(windows)} windows")
    check(decay.get("equal") is True,
          "decay: the device decay differs from np.rint on the host")
    check(cdf_counts["cdf_row_search"] > 0
          and cdf_counts["topic_histogram"] > 0,
          f"decay: kernels 7 and 5 not launched: {cdf_counts}")
    del sess, src
    torch.cuda.empty_cache()

    # -- leg 3: kill and resume, on the first 65,536 documents -------------
    t_end = int(np.searchsorted(corpus.doc.numpy(), RESUME_DOCS))
    sub = Corpus(word=corpus.word[:t_end], doc=corpus.doc[:t_end],
                 num_words=corpus.num_words, num_docs=RESUME_DOCS)
    cfg = RunConfig(algorithm="zen_pallas", num_iterations=RESUME_WINDOWS,
                    window_docs=RESUME_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS)
    runs = {}
    t0 = time.perf_counter()
    for name, c in (
        ("straight", cfg),
        ("killed", dataclasses.replace(
            cfg, num_iterations=RESUME_KILL,
            train_checkpoint_dir=str(resume_dir),
            train_checkpoint_every=RESUME_KILL)),
        ("resumed", dataclasses.replace(
            cfg, train_checkpoint_dir=str(resume_dir),
            train_checkpoint_every=RESUME_KILL)),
    ):
        s = StreamingSession(stream_source(sub, RESUME_WINDOW_DOCS, 2),
                             hyper, c, device=dev)
        t = time.perf_counter()
        s.run(seed)
        torch.cuda.synchronize()
        runs[name] = (s, time.perf_counter() - t)
    leg3_s = time.perf_counter() - t0
    a, b = runs["straight"][0], runs["resumed"][0]
    same = (a.windows_done == b.windows_done == RESUME_WINDOWS
            and a.docs_consumed == b.docs_consumed
            and runs["killed"][0].windows_done == RESUME_KILL
            and bool(torch.equal(a.n_wk, b.n_wk))
            and bool(torch.equal(a.n_k, b.n_k))
            and sorted(a._retained) == sorted(b._retained)
            and all(np.array_equal(a._retained[u], b._retained[u])
                    for u in a._retained))
    emit({"phase": "stream", "leg": "resume", "docs": RESUME_DOCS,
          "tokens": sub.num_tokens, "window_docs": RESUME_WINDOW_DOCS,
          "windows": RESUME_WINDOWS, "killed_at": RESUME_KILL,
          "seconds": {k: v[1] for k, v in runs.items()},
          "leg_seconds": leg3_s, "bit_equal": same, "card": smi})
    check(same, "resume: the resumed run differs from the straight one")
    del runs, a, b, s, sub
    shutil.rmtree(resume_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- leg 4: kernel 2 on a whole window against its plain version, then
    # the fused path (kernels 2 and 5) against the gathered one (kernel 1
    # and the plain merge)
    emit({"phase": "stream", "leg": "fused_vs_plain", "card": smi,
          **stream_fused_vs_plain(corpus, hyper, seed, dev)})
    out = {}
    for kernels in ("auto", "off"):
        src = stream_source(corpus, PLAIN_WINDOW_DOCS, epochs=1)
        s = StreamingSession(src, hyper, RunConfig(
            algorithm="zen_pallas", kernels=kernels,
            num_iterations=PLAIN_WINDOWS, window_docs=PLAIN_WINDOW_DOCS,
            window_sweeps=STREAM_SWEEPS), device=dev)
        llh = []
        ops.reset_launch_counts()
        s.run(seed, callback=lambda _s, m: llh.append(m["llh"]))
        torch.cuda.synchronize()
        out[kernels] = (s, llh, ops.launch_counts())
    (a, la, ca), (b, lb, cb) = out["auto"], out["off"]
    same = (bool(torch.equal(a.n_wk, b.n_wk))
            and bool(torch.equal(a.n_k, b.n_k))
            and sorted(a._retained) == sorted(b._retained)
            and all(np.array_equal(a._retained[u], b._retained[u])
                    for u in a._retained))
    emit({"phase": "stream", "leg": "fused_vs_gathered",
          "window_docs": PLAIN_WINDOW_DOCS, "windows": PLAIN_WINDOWS,
          "llh_auto": la, "llh_off": lb, "bit_equal": same,
          "launches_auto": ca, "launches_off": cb, "card": smi})
    check(same and la == lb, "stream: kernels='auto' and 'off' differ")
    check(ca["zen_fused_sample"] == PLAIN_WINDOWS * STREAM_SWEEPS
          and ca["topic_histogram"] == 2 * PLAIN_WINDOWS * STREAM_SWEEPS,
          f"stream auto: launches {ca}")
    check(cb["zen_fused_sample"] == 0 and cb["topic_histogram"] == 0
          and cb["zen_sample"] > 0,
          f"stream off: launches {cb}")
    del out, a, b
    shutil.rmtree(models_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"zen_fused_sample": counts["zen_fused_sample"],
            "topic_histogram": counts["topic_histogram"],
            "zen_fused_infer_sample": counts["zen_fused_infer_sample"],
            "cdf_row_search": cdf_counts["cdf_row_search"]}


def profile_serving(model, cfg, docs, seed: int):
    """Device busy share and time by kernel name over one serving window
    (after warm-up), from ``torch.profiler``; run after the main path's
    counts were read, so its launches are not counted there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=seed)
    engine.warm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer_batch(docs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_summary(prof, wall_us)


def serve_cpu(model, cfg, docs):
    """The finished requests of ``docs`` served caller-driven."""
    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=0)
    uids = [engine.submit(d) for d in docs]
    done = {r.uid: r for r in engine.run_until_done()}
    return [done[u] for u in uids]


def plain_pair_counts(corpus, pairs, window: int):
    """D(w), D(w, w') and the windows holding both words of each pair,
    recomputed directly on the card for :func:`phase_quality`'s check: per
    word its documents (distinct (word, doc) pairs) and the union of the
    window intervals its occurrences fall in (a difference array over the
    corpus's window indices); per pair the intersection of those sets.
    Independent of ``CoherenceStats``' first-occurrence counting."""
    import numpy as np
    import torch

    dev = corpus.word.device
    word, doc = corpus.word.long(), corpus.doc.long()
    d_count = corpus.num_docs
    bounds = torch.searchsorted(doc, torch.arange(d_count + 1, device=dev))
    lens = bounds[1:] - bounds[:-1]
    last = (lens - window).clamp(min=0)
    n_win = (last + 1) * (lens > 0)
    win_base = torch.cumsum(n_win, 0) - n_win
    total_windows = int(n_win.sum())
    words = np.unique(pairs).astype(np.int64)
    wanted = torch.zeros(corpus.num_words, dtype=torch.bool, device=dev)
    wanted[torch.as_tensor(words, device=dev)] = True
    tok = wanted[word].nonzero().squeeze(1)  # token positions, ascending
    key = word[tok] * (d_count + 1) + doc[tok]
    key, order = torch.sort(key, stable=True)
    tok = tok[order]
    cuts = torch.searchsorted(key, torch.as_tensor(
        words, device=dev) * (d_count + 1)).tolist() + [len(key)]
    span = {int(w): (cuts[i], cuts[i + 1]) for i, w in enumerate(words)}

    def docs_of(w):
        lo, hi = span[w]
        return torch.unique_consecutive(doc[tok[lo:hi]])

    def windows_of(w):
        lo, hi = span[w]
        p = tok[lo:hi]
        d = doc[p]
        pos = p - bounds[d]
        start = (pos - window + 1).clamp(min=0) + win_base[d]
        stop = torch.minimum(pos, last[d]) + win_base[d] + 1
        diff = torch.zeros(total_windows + 1, dtype=torch.int32, device=dev)
        diff.index_add_(0, start, torch.ones_like(start, dtype=torch.int32))
        diff.index_add_(0, stop, -torch.ones_like(stop, dtype=torch.int32))
        return torch.cumsum(diff[:-1], 0) > 0

    out = {"doc_freq": [], "co_doc_freq": [], "window_count": [],
           "co_window_count": []}
    cached = (None, None, None)
    for a, b in sorted((int(x), int(y)) for x, y in pairs):
        if cached[0] != a:
            cached = (a, docs_of(a), windows_of(a))
        _, docs_a, win_a = cached
        docs_b, win_b = docs_of(b), windows_of(b)
        out["doc_freq"].append(int(docs_a.numel()))
        out["co_doc_freq"].append(int(torch.isin(docs_a, docs_b).sum()))
        out["window_count"].append(int(win_a.sum()))
        out["co_window_count"].append(int((win_a & win_b).sum()))
    return sorted((int(x), int(y)) for x, y in pairs), out, total_windows


def planted_top_counts(num_words: int, k: int, top_n: int, seed: int,
                       device):
    """(W, K) int32 counts whose top ``top_n`` words of each topic are
    drawn log-uniformly over word rank (the synthetic corpus's word id is
    its Zipf rank), with counts top_n..1 and zeros elsewhere: a top-word
    union of several thousand words that spans every frequency band, as
    a trained model's topics do, where a few iterations on the Zipf
    corpus give every topic the same head words."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_wk = torch.zeros((num_words, k), dtype=torch.int32, device=device)
    rows, cols, vals = [], [], []
    for t in range(k):
        ids = []
        while len(ids) < top_n:
            w = int(np.exp(rng.uniform(0.0, np.log(num_words)))) - 1
            if w not in ids:
                ids.append(w)
        rows += ids
        cols += [t] * top_n
        vals += list(range(top_n, 0, -1))
    n_wk[torch.as_tensor(rows, device=device),
         torch.as_tensor(cols, device=device)] = torch.as_tensor(
        vals, dtype=torch.int32, device=device)
    return n_wk


def banded_pairs(top, doc_freq, n: int, rng):
    """``n`` of the top-word matrix's (l, m) pairs, spread over frequency
    bands: pairs are grouped by the decades of their two words' document
    frequencies and drawn round-robin across the groups, in a seeded
    order within each. Returns the (n, 2) pairs and the count per band
    ("lo-hi" decades)."""
    import numpy as np

    k, top_n = top.shape
    ls = np.array([l for m in range(1, top_n) for l in range(m)])
    ms = np.array([m for m in range(1, top_n) for _ in range(m)])
    pairs = np.stack([top[:, ls].ravel(), top[:, ms].ravel()], 1)
    dec = np.floor(np.log10(np.maximum(doc_freq(pairs.ravel()), 1)))
    dec = dec.astype(np.int64).reshape(pairs.shape)
    lo, hi = dec.min(1), dec.max(1)
    perm = rng.permutation(len(pairs))
    key = (lo * 16 + hi)[perm]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.searchsorted(sk, sk)  # first slot of each group
    rank = np.empty(len(perm), np.int64)
    rank[order] = np.arange(len(perm)) - start
    pick = perm[np.argsort(rank, kind="stable")[:n]]
    bands = {}
    for a, b in zip(lo[pick], hi[pick]):
        bands[f"{a}-{b}"] = bands.get(f"{a}-{b}", 0) + 1
    return pairs[pick], dict(sorted(bands.items()))


def phase_quality(corpus, seed: int, smi):
    """The ``train`` cell's run again with quality evaluation and telemetry
    on, then a run with the autopilot; returns the launch counts of both
    runs (summed) for the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.eval import (
        CoherenceStats,
        left_to_right_llh_batch,
        npmi_coherence,
        top_topic_words,
        umass_coherence,
    )
    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl
    from repro_torch.train.session import RunConfig, TrainSession

    dev = corpus.word.device
    hyper = LDAHyperParams(num_topics=K_NYT)
    out_dir = ROOT / "build" / "chip_smoke_quality"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    # (2) the corpus statistics alone: build time and peak device memory
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = CoherenceStats.from_corpus(corpus, window=NPMI_WINDOW)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    stats_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    stats_held_gb = (torch.cuda.memory_allocated() - base) / 1e9

    # (1), (4): quality and telemetry on the train cell's run
    path = out_dir / "train.jsonl"
    cfg = RunConfig(algorithm="zen_pallas", num_iterations=TRAIN_ITERS,
                    eval_every=1, quality_every=1,
                    quality_top_n=QUALITY_TOP_N,
                    quality_npmi_window=NPMI_WINDOW,
                    quality_l2r_docs=L2R_DOCS,
                    quality_l2r_particles=L2R_PARTICLES,
                    metrics_out=str(path), metrics_every=1)
    t0 = time.perf_counter()
    sess = TrainSession(corpus, hyper, cfg, device=dev)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    timed = {"quality_s": [], "telemetry_ms": []}

    def timing(fn, key, scale):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[key].append((time.perf_counter() - t) * scale)
            return got
        return wrapped

    sess._quality.evaluate = timing(sess._quality.evaluate, "quality_s", 1)
    sess.telemetry.record_iteration = timing(
        sess.telemetry.record_iteration, "telemetry_ms", 1e3)
    seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    final = sess.run(seed, callback=lambda st, m: seen.append(dict(m)))
    counts = ops.launch_counts()
    llh = [m["llh"] for m in seen]
    change = [m["change_rate"] for m in seen]
    quality = [{k: m[k] for k in ("coherence_umass", "coherence_npmi",
                                  "l2r_llh", "l2r_per_token")}
               for m in seen]
    records = read_jsonl(str(path))
    iters = [r for r in records if r["kind"] == "train_iter"]
    check(llh == RECORD["train"]["llh"][1:]
          and change == RECORD["train"]["change_rate"],
          f"quality: quality and telemetry changed the run: llh {llh}, "
          f"change rate {change} against {RECORD['train']}")
    check_launches("quality", counts, {"zen_fused_sample": TRAIN_ITERS,
                                       "topic_histogram": 2 * TRAIN_ITERS})
    check([r["iteration"] for r in iters] == list(range(1, TRAIN_ITERS + 1)),
          f"quality: telemetry records {[r['iteration'] for r in iters]}")
    check(all(np.isfinite(v) for q in quality for v in q.values()),
          f"quality: non-finite quality record {quality}")

    # (2) one eval split into its parts, on the final snapshot
    split = {}

    def part(name, fn, into=split):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        into[name] = time.perf_counter() - t
        return got

    top = part("top_words_s", lambda: top_topic_words(
        final.n_wk, QUALITY_TOP_N).cpu().numpy())
    umass, _ = part("umass_s", lambda: umass_coherence(stats, top))
    npmi, _ = part("npmi_s", lambda: npmi_coherence(stats, top))
    l2r_docs = sess._quality._l2r_docs
    rngs = [np.random.default_rng((0, TRAIN_ITERS, i))
            for i in range(len(l2r_docs))]
    (l2r, near) = part("l2r_s", lambda: left_to_right_llh_batch(
        final.n_wk, final.n_k, l2r_docs, hyper,
        num_particles=L2R_PARTICLES, rngs=rngs))
    check(umass == quality[-1]["coherence_umass"]
          and npmi == quality[-1]["coherence_npmi"]
          and sum(float(v) for v in l2r) == quality[-1]["l2r_llh"],
          "quality: the split eval differs from the session's last one")
    # the same sweep on the host: a document with no near-tie on the card
    # must draw the host's particles
    t0 = time.perf_counter()
    host_l2r, host_near = left_to_right_llh_batch(
        final.n_wk.cpu(), final.n_k.cpu(), l2r_docs, hyper,
        num_particles=L2R_PARTICLES,
        rngs=[np.random.default_rng((0, TRAIN_ITERS, i))
              for i in range(len(l2r_docs))])
    host_l2r_s = time.perf_counter() - t0
    l2r_gap = np.abs(l2r - host_l2r) / np.maximum(np.abs(host_l2r), 1.0)
    clean = near == 0
    check(not host_near.any() and clean.any()
          and l2r_gap[clean].max() <= 1e-10,
          f"quality: left-to-right on the card differs from the host's: "
          f"largest relative gap {l2r_gap[clean].max()} on documents "
          f"without a near-tie, host near-ties {int(host_near.sum())}")

    # (3) a top-word union of realistic size: its eval cost and memory
    wide_n_wk = planted_top_counts(corpus.num_words, K_NYT, QUALITY_TOP_N,
                                   seed, dev)
    wide_split, wide_peak_gb = {}, {}
    wide_top = part("top_words_s", lambda: top_topic_words(
        wide_n_wk, QUALITY_TOP_N).cpu().numpy(), wide_split)
    del wide_n_wk
    for name, fn in (("umass", umass_coherence), ("npmi", npmi_coherence)):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        part(f"{name}_s", lambda fn=fn: fn(stats, wide_top), wide_split)
        wide_peak_gb[name] = (torch.cuda.max_memory_allocated() - mem0) / 1e9

    # (3) the counts on the card against a direct per-pair version: pairs
    # of the trained model's top words, and of the wide union spread over
    # frequency bands
    rng = np.random.default_rng(seed)
    pair_idx = [(m, l) for m in range(1, QUALITY_TOP_N) for l in range(m)]
    pick = rng.choice(top.shape[0] * len(pair_idx), PAIR_SAMPLE,
                      replace=False)
    pairs = np.array([(top[i // len(pair_idx), pair_idx[i % len(pair_idx)][1]],
                       top[i // len(pair_idx), pair_idx[i % len(pair_idx)][0]])
                      for i in pick])
    wide_pairs, bands = banded_pairs(wide_top, stats.doc_freq, PAIR_SAMPLE,
                                     rng)
    pairs = np.concatenate([pairs, wide_pairs])
    t0 = time.perf_counter()
    ordered, plain, total_windows = plain_pair_counts(corpus, pairs,
                                                      NPMI_WINDOW)
    plain_s = time.perf_counter() - t0
    a = np.array([p[0] for p in ordered])
    b = np.array([p[1] for p in ordered])
    got = {"doc_freq": stats.doc_freq(a).tolist(),
           "co_doc_freq": stats.co_doc_freq(a, b).tolist(),
           "window_count": stats.window_count(a).tolist(),
           "co_window_count": stats.co_window_count(a, b).tolist()}
    for key in got:
        bad = sum(x != y for x, y in zip(got[key], plain[key]))
        check(bad == 0, f"quality: {key} differs from the plain version "
              f"on {bad} of {len(ordered)} pairs")
    check(total_windows == stats.num_windows,
          f"quality: {stats.num_windows} windows, plain {total_windows}")
    emit({"phase": "quality", "tokens": corpus.num_tokens,
          "num_windows": stats.num_windows, "llh": llh,
          "change_rate": change, "equal_to_record": True,
          "quality": quality, "l2r_near_ties": int(near.sum()),
          "l2r_near_tie_docs": int((~clean).sum()),
          "l2r_near_ties_session": sess._quality.last_near_ties,
          "l2r_host_s": host_l2r_s,
          "l2r_host_gap_max": float(l2r_gap.max()),
          "stats_build_s": stats_s, "stats_peak_gb": stats_peak_gb,
          "stats_held_gb": stats_held_gb, "session_build_s": session_s,
          "quality_eval_s": timed["quality_s"], "eval_split": split,
          "union_words": int(np.unique(top).size),
          "wide_union_words": int(np.unique(wide_top).size),
          "wide_eval_split": wide_split, "wide_peak_gb": wide_peak_gb,
          "wide_pair_bands": bands,
          "telemetry_ms": timed["telemetry_ms"],
          "telemetry_records": len(iters),
          "tokens_per_s": [r["tokens_per_s"] for r in iters],
          "pairs_checked": len(ordered), "plain_pairs_s": plain_s,
          "launches": counts, "card": smi})
    del sess, final, stats
    torch.cuda.empty_cache()
    return counts, phase_train_autopilot(corpus, seed, hyper, out_dir, smi)


def phase_train_autopilot(corpus, seed: int, hyper, out_dir, smi):
    """The train cell from the same initial topics with the autopilot on:
    its decisions, the backend it moves to and the seconds per iteration
    on each side of the switch, launches counted per backend."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl
    from repro_torch.train.session import RunConfig, TrainSession

    path = out_dir / "autopilot.jsonl"
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_pallas", num_iterations=AUTOPILOT_ITERS,
        autopilot=True, autopilot_every=AUTOPILOT_EVERY,
        metrics_out=str(path)), device=corpus.word.device)
    st0 = sess.init(seed)
    steps, decisions, launches = [], [], {}
    backend = [sess.plan.backend.name]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_last = [time.perf_counter()]

    def cb(st, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        ran = backend[-1]
        kernel = ("zen_fused_sample" if ran == "zen_pallas"
                  else "sparse_row_sample")
        check(counts.get(kernel, 0) > 0,
              f"autopilot: iteration {int(st.iteration)} on {ran} did not "
              f"launch {kernel}: {counts}")
        check_launches(f"autopilot iteration {int(st.iteration)} ({ran})",
                       counts, {kernel: counts[kernel],
                                "topic_histogram": 2})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        steps.append({"iteration": int(st.iteration), "backend": ran,
                      "seconds": now - t_last[0],
                      "launches": {k: v for k, v in counts.items() if v}})
        decisions.extend(m.get("autopilot", ()))
        backend.append(sess.plan.backend.name)
        st.check_invariants(sess.corpus)
        torch.cuda.synchronize()
        t_last[0] = time.perf_counter()

    sess.run(state=st0, callback=cb)
    records = read_jsonl(str(path))
    iters = [r for r in records if r["kind"] == "train_iter"]
    check(len(iters) == AUTOPILOT_ITERS and decisions
          and any(r["kind"] == "decision" for r in records),
          f"autopilot: {len(iters)} telemetry records, decisions "
          f"{decisions}")
    emit({"phase": "train_autopilot", "iterations": steps,
          "decisions": decisions, "final_backend": sess.plan.backend.name,
          "row_pads": list(sess.row_pads),
          "telemetry": [{k: r[k] for k in ("iteration", "backend", "dt_s",
                                           "word_rows", "doc_rows")}
                        for r in iters],
          "card": smi})
    del sess, st0
    torch.cuda.empty_cache()
    return launches


def serve_paced(engine, docs, pace: float):
    """Submit ``docs`` ``pace`` seconds apart under the engine's ticker and
    collect them; returns (thetas, requests, seconds)."""
    import numpy as np

    t0 = time.perf_counter()
    tickets = []
    for d in docs:
        tickets.append(engine.submit_async(d))
        time.sleep(pace)
    reqs = [engine.request(t) for t in tickets]
    thetas = np.stack([engine.result(t, timeout=120.0) for t in tickets])
    return thetas, reqs, time.perf_counter() - t0


def phase_serve_autopilot(model, base, docs, topics, seed: int, smi):
    """The serving phase's model and documents under the ticker, paced:
    telemetry off, then telemetry and the autopilot on; then short
    queries on the same grid, in two bursts, so the autopilot's bucket
    recut is applied once the grid drains. Returns the fused serving
    kernel's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl, summarize_latencies
    from repro_torch.serving import LDAEngine, LDAServeConfig

    out_dir = ROOT / "build" / "chip_smoke_serve_autopilot"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    kernel = "zen_fused_infer_sample"
    launches = 0
    short = [d[:SHORT_QUERY] for d in docs]
    runs = [("telemetry_off", {}, [docs]),
            ("autopilot", {"autopilot": True}, [docs]),
            ("autopilot_recut", {"autopilot": True},
             [short[:len(short) // 2], short[len(short) // 2:]])]
    for name, extra, bursts in runs:
        path = out_dir / f"{name}.jsonl"
        if extra:
            extra = {**extra, "autopilot_window": AUTOPILOT_WINDOW,
                     "metrics_out": str(path)}
        engine = LDAEngine(model, LDAServeConfig(**base, **extra), seed=seed)
        swaps = []
        apply = engine._apply_pending_buckets

        def watched(engine=engine, apply=apply, swaps=swaps):
            # in flight from the requests' own flags, not the buckets'
            # slots that the swap itself tests
            grid = engine.bucket_widths
            in_flight = [u for u, r in engine._tickets.items()
                         if r.admitted and not r.done]
            queued = [r.uid for r in engine.queue]
            apply()
            if engine.bucket_widths != grid:
                swaps.append({"from": list(grid),
                              "to": list(engine.bucket_widths),
                              "in_flight": in_flight, "queued": queued})

        engine._apply_pending_buckets = watched
        engine.warm()
        engine.start()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        served = []
        try:
            for burst in bursts:
                served.append(serve_paced(engine, burst, SERVE_PACE_S))
        finally:
            engine.stop()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        thetas = np.concatenate([s[0] for s in served])
        reqs = [r for s in served for r in s[1]]
        secs = sum(s[2] for s in served)
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3
                                  for r in reqs)
        check(bool(np.isfinite(thetas).all())
              and thetas.shape == (len(docs), K_NYT),
              f"serve_autopilot {name}: non-finite or missing thetas")
        check(not any(s["in_flight"] for s in swaps),
              f"serve_autopilot {name}: a bucket swap with requests in "
              f"flight {swaps}")
        by_uid = {r.uid: (r, th) for r, th in zip(reqs, thetas)}
        for sw in swaps:
            check_requeued(model, base, seed, sw["to"],
                           [by_uid[u] for u in sw["queued"]],
                           f"serve_autopilot {name}")
        check(all((v > 0) == (k == kernel) for k, v in counts.items()),
              f"serve_autopilot {name}: expected launches of {kernel} "
              f"only, got {counts}")
        launches += counts[kernel]
        row = {"phase": "serve_autopilot", "run": name, "docs": len(reqs),
               "pace_s": SERVE_PACE_S, "seconds": secs,
               "docs_per_sec": len(reqs) / secs, "p50_ms": lat["p50"],
               "p99_ms": lat["p99"], "max_ms": lat["max"],
               "final_knobs": {"tick_period": engine.tick_period,
                               "max_slot_wait": engine.max_slot_wait,
                               "buckets": list(engine.bucket_widths)},
               "bucket_swaps": swaps, "spills": engine.spills,
               "launches": counts, "card": smi}
        if name != "autopilot_recut":
            hit, pair_hit = check_thetas(f"serve_autopilot {name}", thetas,
                                         topics, len(docs))
            row.update(planted_top1_single=hit, planted_top1_pair=pair_hit)
        if extra:
            records = read_jsonl(str(path))
            row["windows"] = sum(r["kind"] == "serve_window"
                                 for r in records)
            row["decisions"] = [
                {k: r[k] for k in ("tick_period", "max_slot_wait",
                                   "buckets", "applied", "reason")}
                for r in records if r["kind"] == "decision"]
            check(row["windows"] > 0, f"serve_autopilot {name}: no window")
        if name == "autopilot_recut":
            check(len(swaps) >= 1 and engine.bucket_widths[0] <= SHORT_QUERY,
                  f"serve_autopilot: the short queries' grid was not recut "
                  f"({swaps}, {engine.bucket_widths})")
            recut = swaps[0]["to"]
        emit(row)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "serve_autopilot", "run": "swap_across_traffic",
          **swap_across_traffic(model, base, docs, recut, seed),
          "card": smi})
    return launches


def check_requeued(model, base, seed: int, grid, queued, what: str) -> None:
    """Requests queued when the bucket grid became ``grid``: each must
    have finished on it, cut to its widest bucket exactly when longer,
    with the theta of the same document and key decoded alone by a fresh
    engine on that grid (a chain's draws depend on its key, words and
    model only)."""
    import numpy as np

    from repro_torch.serving import LDAEngine, LDAServeConfig

    if not queued:
        return
    fresh = LDAEngine(model, LDAServeConfig(**{**base, "buckets":
                                                tuple(grid)}), seed=seed)
    uids = [fresh.submit(r.words, key=r.key) for r, _ in queued]
    alone = {r.uid: r for r in fresh.run_until_done()}
    for (r, theta), u in zip(queued, uids):
        known = r.orig_len - r.dropped_unknown
        check(r.done and len(r.words) == min(known, max(grid))
              and r.truncated == (known > len(r.words))
              and np.array_equal(theta, alone[u].theta),
              f"{what}: request {r.uid} queued across the swap to {grid} "
              f"finished with {len(r.words)} of {known} tokens, truncated "
              f"{r.truncated}, or a theta unlike its decode alone")


def swap_across_traffic(model, base, docs, grid, seed: int):
    """The recut run's grid swapped under traffic, stepped inline so the
    order is fixed: 16 documents admitted to the wide grid, the recut made
    pending (as the autopilot's decision leaves it), steps until none is
    in flight (the grid must hold through every step that begins with
    one), then 16 more documents queued on the drained grid before the
    step that swaps. A request admitted before the swap must finish as on
    the wide grid, one still queued at it as on the new grid, cut to its
    widest bucket; each theta must equal its decode alone (see
    :func:`check_requeued`)."""
    from repro_torch.serving import LDAEngine, LDAServeConfig

    engine = LDAEngine(model, LDAServeConfig(**base), seed=seed)
    old, new = engine.bucket_widths, tuple(sorted(grid))
    tickets = [engine.submit_async(d) for d in docs[:16]]
    engine.step()
    engine._pending_buckets = new
    second, swapped, held = None, None, 0
    while second is None or not all(engine.request(t).done
                                    for t in tickets):
        live = [engine.request(t) for t in tickets]
        busy = any(r.admitted and not r.done for r in live)
        if second is None and not busy:
            second = [engine.submit_async(d) for d in docs[16:32]]
            tickets += second
            live += [engine.request(t) for t in second]
        before = engine.bucket_widths
        waiting = [r.uid for r in live if not r.admitted]
        engine.step()
        if engine.bucket_widths != before:
            check(not busy and swapped is None and engine.bucket_widths
                  == new, f"swap_across_traffic: the grid went {before} -> "
                  f"{engine.bucket_widths} with requests in flight")
            swapped = set(waiting)
        elif swapped is None:
            held += 1
    check(second is not None and swapped is not None
          and all(t in swapped for t in second),
          f"swap_across_traffic: no swap with the second documents queued "
          f"({engine.bucket_widths})")
    done = [(engine.request(t), engine.result(t)) for t in tickets]
    wide = [(r, th) for r, th in done if r.uid not in swapped]
    cut = [(r, th) for r, th in done if r.uid in swapped]
    check_requeued(model, base, seed, old, wide, "swap_across_traffic")
    check_requeued(model, base, seed, new, cut, "swap_across_traffic")
    return {"from": list(old), "to": list(new), "steps_held": held,
            "in_flight_before_swap": len(wide), "queued_across": len(cut),
            "truncated": int(sum(r.truncated for r, _ in cut)),
            "thetas_equal_alone": len(done)}


# -- the mesh plan, sharded serving and the router --------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_step(plan, st, phases):
    """One mesh step with its phases stamped after a synchronize (sweep,
    kernel 5's merge, the N_w|k all-reduce, then N_k|d's with N_k's);
    milliseconds appended to ``phases``."""
    _sync(plan.device)
    last = [time.perf_counter()]

    def timer(name):
        _sync(plan.device)
        now = time.perf_counter()
        phases.setdefault(name, []).append((now - last[0]) * 1e3)
        last[0] = now

    return plan.step(st, timer=timer)


def phase_mesh_one(corpus, seed: int, dev, smi):
    """A world of one under NCCL: the train cell as a (1, 1) mesh, its
    change-rate list and llh held to ``RECORD["train"]``, kernels 2 and 5
    launched as on the single box."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core.graph import grid_partition
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    t0 = time.perf_counter()
    grid = grid_partition(corpus, 1, 1)
    t_grid = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh_one_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1, device_id=dev)
        try:
            sess = TrainSession(corpus, LDAHyperParams(num_topics=K_NYT),
                                RunConfig(algorithm="zen_pallas",
                                          mesh_shape=(1, 1)),
                                device=dev, grid=grid)
            plan = sess.plan
            t0 = time.perf_counter()
            st = sess.init(seed)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            phases, change, step_ms = {}, [], []
            for _ in range(MESH_ONE_ITERS):
                t0 = time.perf_counter()
                st = _mesh_step(plan, st, phases)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                plan.check_invariants(st)
                change.append(plan.change_rate(st))
            counts = ops.launch_counts()
            t0 = time.perf_counter()
            llh = sess.llh(st)
            t_llh = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            backend = plan.comm.backend
            w_pad, d_pad = plan.num_words_pad, grid.num_docs_padded
            del sess, plan, st
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want_llh = RECORD["train"]["llh"][MESH_ONE_ITERS]
    rel = abs(llh / want_llh - 1)
    emit({"phase": "mesh_one", "backend": backend, "W_pad": w_pad,
          "D_pad": d_pad, "tokens": corpus.num_tokens,
          "grid_partition_s": t_grid, "init_s": t_init, "step_ms": step_ms,
          "phase_ms": phases, "change_rate": change, "llh": llh,
          "llh_rel_vs_record": rel, "llh_s": t_llh,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(backend == "nccl", f"mesh_one: process group on {backend}")
    check((w_pad, d_pad) == (W_NYT, D_NYT),
          f"mesh_one: a (1, 1) grid padded to {w_pad} x {d_pad}")
    check(change == RECORD["train"]["change_rate"][:MESH_ONE_ITERS],
          f"mesh_one: change rate {change} differs from the record")
    # float64 sums of the same float32 terms: order changes nothing at
    # this magnitude, so the llh is the single box's up to 1e-12
    check(rel <= MESH_LLH_RTOL, f"mesh_one: llh {llh} vs the record "
          f"{want_llh} ({rel:.3e} relative)")
    check_launches("mesh_one", counts,
                   {"zen_fused_sample": MESH_ONE_ITERS,
                    "topic_histogram": 2 * MESH_ONE_ITERS})
    return counts


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np_contiguous(a).tobytes())
    return h.hexdigest()


def np_contiguous(a):
    import numpy as np

    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a)


def _save_grid(grid, out_dir) -> None:
    import numpy as np

    for f in ("word", "doc", "mask", "token", "word_perm", "doc_perm"):
        np.save(out_dir / f"{f}.npy", getattr(grid, f))
    (out_dir / "grid.json").write_text(json.dumps({
        f: int(getattr(grid, f)) for f in (
            "data_parallel", "model_parallel", "words_per_shard",
            "docs_per_shard")}))


def _load_grid(out_dir):
    """The parent's grid, memory-mapped: a rank reads its cell's rows."""
    import numpy as np

    from repro_torch.core.graph import GridPartition

    arrays = {f: np.load(out_dir / f"{f}.npy", mmap_mode="r")
              for f in ("word", "doc", "mask", "token", "word_perm",
                        "doc_perm")}
    return GridPartition(**arrays, **json.loads(
        (out_dir / "grid.json").read_text()))


def mesh_four_rank(out: str, seed: int, want: str, device: str,
                   num_topics: int) -> None:
    """One rank of ``mesh_four`` (4 gloo ranks sharing ``device``, the
    card): its cell of the parent's grid, MESH_FOUR_ITERS steps, then the
    gathered, un-permuted counts and topics against the oracle's
    digests."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    out_dir = pathlib.Path(out)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = _load_grid(out_dir)
    t0 = time.perf_counter()
    sess = TrainSession(None, LDAHyperParams(num_topics=num_topics),
                        RunConfig(algorithm="zen_pallas",
                                  mesh_shape=MESH_FOUR_SHAPE),
                        device=dev, grid=grid)
    plan = sess.plan
    st = sess.init(seed)
    _sync(dev)
    t_setup = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    phases, iter_s, sent = {}, [], []
    all_reduce = plan.comm.all_reduce

    def counted(t, axis="all", op="sum"):
        sent[-1] += t.numel() * t.element_size()
        return all_reduce(t, axis, op)

    for _ in range(MESH_FOUR_ITERS):
        dist.barrier()
        t0 = time.perf_counter()
        sent.append(0)
        plan.comm.all_reduce = counted  # the step's all-reduces alone
        st = _mesh_step(plan, st, phases)
        plan.comm.all_reduce = all_reduce
        iter_s.append(time.perf_counter() - t0)
        plan.check_invariants(st)
    counts = ops.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else None)
    t0 = time.perf_counter()
    got = {"topics": _digest(plan.corpus_topics(st)),
           "n_wk": _digest(plan.host_n_wk(st)),
           "n_kd": _digest(plan.host_n_kd(st)),
           "n_k": _digest(st.n_k)}
    t_gather = time.perf_counter() - t0
    k = num_topics
    rec = {"rank": plan.comm.rank, "cell_tokens": plan.data.num_real,
           "backend": plan.comm.backend, "setup_s": t_setup,
           "iteration_s": iter_s, "phase_ms": phases,
           "d_wk_bytes": grid.words_per_shard * k * 4,
           "d_kd_bytes": grid.docs_per_shard * k * 4,
           "all_reduce_bytes": sent,
           "words_per_shard": grid.words_per_shard,
           "docs_per_shard": grid.docs_per_shard,
           "peak_device_gb": peak_gb, "launches": counts,
           "gather_s": t_gather, "equal": got == json.loads(want),
           "digests": got}
    (out_dir / f"rank{plan.comm.rank}.json").write_text(json.dumps(rec))


def phase_mesh_four(corpus, seed: int, dev, smi):
    """4 gloo ranks on the one card, mesh (2, 2): the grid partitioned
    once here and memory-mapped by the ranks; the gathered counts and
    topics against a ``zen_pallas`` single box over the corpus declared
    at (W_pad, D_pad), same key, bit for bit."""
    import torch

    from repro_torch.core.graph import grid_partition
    from repro_torch.core.types import Corpus, LDAHyperParams
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.train.session import RunConfig, TrainSession

    out_dir = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    grid = grid_partition(corpus, *MESH_FOUR_SHAPE)
    t_grid = time.perf_counter() - t0
    _save_grid(grid, out_dir)
    w_pad, d_pad = grid.num_words_padded, grid.num_docs_padded
    w, d = corpus.num_words, corpus.num_docs
    cells = grid.mask.sum(1).tolist()
    del grid
    # the oracle: one cell holding the whole corpus at (W_pad, D_pad)
    declared = Corpus(corpus.word, corpus.doc, w_pad, d_pad)
    sess = TrainSession(declared, LDAHyperParams(num_topics=K_NYT),
                        RunConfig(algorithm="zen_pallas"), device=dev)
    st = sess.init(seed)
    for _ in range(MESH_FOUR_ITERS):
        st = sess.step(st)
    want = {"topics": _digest(st.topic), "n_wk": _digest(st.n_wk[:w]),
            "n_kd": _digest(st.n_kd[:d]), "n_k": _digest(st.n_k)}
    del sess, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_local(f"{pathlib.Path(__file__).resolve()}:mesh_four_rank", 4,
                args=(str(out_dir), seed, json.dumps(want), str(dev), K_NYT))
    t_world = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(4)]
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {}
    for r in ranks:
        for name, v in r["launches"].items():
            launches[name] = launches.get(name, 0) + v
    iter_s = [max(r["iteration_s"][i] for r in ranks)
              for i in range(MESH_FOUR_ITERS)]
    emit({"phase": "mesh_four", "shape": list(MESH_FOUR_SHAPE),
          "backend": ranks[0]["backend"], "W_pad": w_pad, "D_pad": d_pad,
          "cell_tokens": cells, "grid_partition_s": t_grid,
          "world_s": t_world, "iteration_s": iter_s,
          "ranks": [{k: r[k] for k in (
              "rank", "cell_tokens", "setup_s", "iteration_s", "phase_ms",
              "d_wk_bytes", "d_kd_bytes", "all_reduce_bytes",
              "peak_device_gb", "launches", "gather_s", "equal")}
              for r in ranks],
          "launches": launches, "equal_to_single_box": all(
              r["equal"] for r in ranks), "card": smi})
    check(all(r["equal"] for r in ranks),
          f"mesh_four: counts or topics differ from the single box at "
          f"(W_pad, D_pad) = ({w_pad}, {d_pad}): "
          f"{[r['digests'] for r in ranks]} vs {want}")
    for r in ranks:
        check_launches(f"mesh_four rank {r['rank']}", r["launches"],
                       {"zen_fused_sample": MESH_FOUR_ITERS,
                        "topic_histogram": 2 * MESH_FOUR_ITERS})
    # what lm_dryrun's LDA cell is held to: a rank's blocks and the bytes
    # its steps all-reduced
    MESH_FOUR_SEEN.update(
        words_per_shard=ranks[0]["words_per_shard"],
        docs_per_shard=ranks[0]["docs_per_shard"],
        cell_tokens=cells, all_reduce_bytes=sorted(
            {b for r in ranks for b in r["all_reduce_bytes"]}))
    return launches


def phase_sharded_serve(model, base, docs, seed: int, unsharded: int,
                        smi):
    """The fused throughput run's model, documents and keys, sharded over
    word rows at (1, 2) and (1, 4) on the one card: its thetas' digest,
    kernel 4 launched m times per bucket sweep."""
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.serving import LDAServeConfig

    launches = {}
    kernel = "zen_fused_infer_sample"
    for m in MESH_SERVE_SHARDS:
        cfg = LDAServeConfig(mesh_shape=(1, m), **base)
        thetas, reqs, secs, counts = serve(model, cfg, docs, seed)
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3
                                  for r in reqs)
        digest = theta_digest(thetas)
        emit({"phase": "sharded_serve", "mesh_shape": [1, m],
              "docs": len(docs), "seconds": secs,
              "docs_per_sec": len(docs) / secs, "p50_ms": lat["p50"],
              "p99_ms": lat["p99"], "max_ms": lat["max"],
              "theta_sha256": digest, "launches": counts, "card": smi})
        check(digest == SERVE_RECORD["throughput_fused"],
              f"sharded_serve (1, {m}): thetas differ from the unsharded "
              f"record")
        check_launches(f"sharded_serve (1, {m})", counts,
                       {kernel: m * unsharded})
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
    return launches


def phase_router(model, base, docs, seed: int, smi):
    """Two replicas on the card behind ``LDARouter``, each request under
    the key the single engine derives for it: the thetas' digest, both
    replicas at work; then a broadcast reload under traffic, every
    ticket finishing on the version it was admitted under."""
    import torch

    from repro_torch.core.keys import fold_in, key_from_seed
    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.serving import (
        FrozenLDAModel,
        LDARouter,
        LDAServeConfig,
    )

    cfg = LDAServeConfig(**base)
    # the single engine's keys: warm() takes uids 1..len(buckets) first
    first = len(cfg.buckets) + 1
    keys = [fold_in(key_from_seed(seed), first + i)
            for i in range(len(docs))]
    router = LDARouter(model, cfg, replicas=ROUTER_REPLICAS, seed=seed)
    router.warm()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [router.submit_async(d, key=k) for d, k in zip(docs, keys)]
    owner = [router.engines.index(router._tickets[t][0]) for t in tickets]
    reqs = [router.request(t) for t in tickets]
    thetas = [router.result(t) for t in tickets]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    lat = summarize_latencies((r.t_done - r.t_submit) * 1e3 for r in reqs)
    import numpy as np

    digest = theta_digest(np.stack(thetas))
    per_replica = [owner.count(i) for i in range(ROUTER_REPLICAS)]
    # the reload: the same counts as a new model, broadcast while the
    # first admissions are in flight
    tickets = [router.submit_async(d, key=k) for d, k in zip(docs, keys)]
    for engine in router.engines:
        engine.step()
    admitted = {t for t in tickets if router.poll(t) == "admitted"}
    version = router.reload(FrozenLDAModel(model.n_wk.clone(),
                                           model.n_k.clone(), model.hyper))
    reqs2 = [router.request(t) for t in tickets]
    thetas2 = [router.result(t) for t in tickets]
    versions = [r.model_version for r in reqs2]
    pinned = all(v == (0 if t in admitted else version)
                 for t, v in zip(tickets, versions))
    digest2 = theta_digest(np.stack(thetas2))
    emit({"phase": "router", "replicas": ROUTER_REPLICAS,
          "docs": len(docs), "seconds": secs,
          "docs_per_sec": len(docs) / secs, "p50_ms": lat["p50"],
          "p99_ms": lat["p99"], "per_replica": per_replica,
          "theta_sha256": digest, "launches": counts,
          "reload": {"admitted_before": len(admitted),
                     "finished": len(thetas2), "version": version,
                     "versions_pinned": pinned,
                     "theta_sha256": digest2}, "card": smi})
    check(digest == SERVE_RECORD["throughput_fused"],
          "router: thetas differ from the single engine's record")
    check(all(per_replica), f"router: a replica took no work "
          f"{per_replica}")
    check(len(thetas2) == len(docs) and admitted and pinned,
          f"router: reload under traffic: {len(admitted)} admitted before, "
          f"versions {sorted(set(versions))}")
    check(digest2 == SERVE_RECORD["throughput_fused"],
          "router: thetas across the reload differ from the record")
    check_launches("router", counts,
                   {"zen_fused_infer_sample":
                    counts["zen_fused_infer_sample"] or -1})
    return counts

def _example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn, *args):
    """``fn(*args)``'s result and standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_compare(seed: int, smi):
    """``python -m repro_torch.launch.compare --sessions`` at NYTIMES
    width on the card: ``zen_pallas`` against ``zen_cdf`` (max_kd
    CDF_MAX_KD), 3 iterations each, an eval after every one, on the corpus
    and seed of the train cell. Its printed llh must equal
    ``RECORD["train"]`` and ``RECORD["train_cdf"]`` for iterations 1-3 at
    the table's precision; each session's wall seconds and launches
    (kernels 2, 5 and 7) are recorded. Returns the phase's launches."""
    import torch

    from repro_torch.algorithms.zen_cdf import CDF_CHUNK_ELEMS
    from repro_torch.kernels import ops
    from repro_torch.launch import compare
    from repro_torch.train import session as session_mod

    out_dir = ROOT / "build" / "chip_smoke_compare"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    configs = {"zen_pallas": {"algorithm": "zen_pallas",
                              "num_iterations": COMPARE_ITERS},
               "zen_cdf": {"algorithm": "zen_cdf", "max_kd": CDF_MAX_KD,
                           "num_iterations": COMPARE_ITERS}}
    paths = []
    for name, cfg in configs.items():
        path = out_dir / f"{name}.json"
        path.write_text(json.dumps(cfg))
        paths.append(str(path))
    sessions = []
    run = session_mod.TrainSession.run

    def timed_run(self, *a, **k):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        st = run(self, *a, **k)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        sessions.append({
            "algorithm": self.cfg.algorithm, "tokens": self.plan.num_tokens,
            "seconds": time.perf_counter() - t0,
            "launches": {n: after[n] - before[n] for n in after
                         if after[n] - before[n]}})
        return st

    argv = ["--sessions", *paths, "--topics", str(K_NYT),
            "--synthetic-docs", str(D_NYT), "--synthetic-words", str(W_NYT),
            "--synthetic-len", str(LEN_NYT), "--eval-every", "1",
            "--seed", str(seed)]
    torch.cuda.empty_cache()
    session_mod.TrainSession.run = timed_run
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        runs, table = _captured(compare.main, argv)
    finally:
        session_mod.TrainSession.run = run
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    shutil.rmtree(out_dir, ignore_errors=True)
    rows = [line.strip("|").split("|") for line in table.splitlines()
            if line.startswith("| ") and not line.startswith("| iter |")]
    rows = [[c.strip() for c in r] for r in rows]
    want = [[str(it), f"{RECORD['train']['llh'][it]:.1f}",
             f"{RECORD['train_cdf']['llh'][it]:.1f}"]
            for it in range(1, COMPARE_ITERS + 1)]
    llh = {name: [m["llh"] for m in runs[p]] for name, p in zip(configs,
                                                                paths)}
    emit({"phase": "compare", "argv": argv[3:], "table": table.splitlines(),
          "seconds": wall, "sessions": sessions, "llh": llh,
          "llh_equal_to_record": {
              "zen_pallas": llh["zen_pallas"] == RECORD["train"]["llh"][
                  1:COMPARE_ITERS + 1],
              "zen_cdf": llh["zen_cdf"] == RECORD["train_cdf"]["llh"][
                  1:COMPARE_ITERS + 1]},
          "launches": counts, "card": smi})
    check([r[:3] for r in rows] == want,
          f"compare: the printed llh {[r[:3] for r in rows]} differ from "
          f"RECORD's {want}")
    check([r["algorithm"] for r in sessions] == list(configs),
          f"compare: sessions ran {[r['algorithm'] for r in sessions]}")
    # kernel 2 once a sweep, kernel 5 twice a step (the delta merge),
    # kernel 7 twice a token chunk
    chunks = -(-sessions[1]["tokens"] // (CDF_CHUNK_ELEMS // CDF_MAX_KD))
    for r, want_launches in zip(sessions, (
            {"zen_fused_sample": COMPARE_ITERS,
             "topic_histogram": 2 * COMPARE_ITERS},
            {"cdf_row_search": 2 * chunks * COMPARE_ITERS,
             "topic_histogram": 2 * COMPARE_ITERS})):
        check_launches(f"compare {r['algorithm']}", r["launches"],
                       want_launches)
    return counts


def phase_examples(smi):
    """The three examples of the port at their own sizes, each on its
    default device (the card): quickstart (the llh rises at every eval,
    counts conserved); distributed_lda --devices 4 (four gloo ranks
    sharing the card, in a process of their own: ``count conservation:
    True``); train_nytimes_lda at its default NYTimes-shaped size, straight
    for NYT_EX_ITERS iterations, then stopped at half and resumed: the two
    final topic arrays' SHA-256 must be equal. Wall seconds of each;
    returns the launches of the runs in this process."""
    import torch

    from repro_torch.kernels import ops

    out_dir = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    record = {"phase": "examples", "card": smi}
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    (sess, st, evals), out = _captured(_example("quickstart_torch").main, [])
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    quick_counts = ops.launch_counts()
    llh0 = float(out.split("llh0 = ")[1].split()[0])
    llh = [llh0] + [m["llh"] for m in evals]
    st.check_invariants(sess.corpus)
    record["quickstart"] = {"seconds": quick_s, "llh": llh,
                            "device": str(sess.device),
                            "launches": quick_counts}
    check(sess.device.type == "cuda", "quickstart: not on the card")
    check(len(evals) == 3 and all(b > a for a, b in zip(llh, llh[1:])),
          f"quickstart: llh did not rise at every eval: {llh}")
    del sess, st

    code = ("import importlib.util, sys; spec = importlib.util."
            "spec_from_file_location('ex', sys.argv[1]); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); m.main(['--devices', '4'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", code,
         str(ROOT / "examples" / "distributed_lda_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    record["distributed"] = {"seconds": time.perf_counter() - t0,
                             "returncode": res.returncode,
                             "stdout": res.stdout.splitlines()}
    check(res.returncode == 0 and "(gloo, cuda)" in res.stdout
          and "count conservation: True" in res.stdout,
          f"distributed_lda_torch: rc {res.returncode}, stdout "
          f"{res.stdout[-2000:]}, stderr {res.stderr[-2000:]}")

    nyt = _example("train_nytimes_lda_torch")
    half = NYT_EX_ITERS // 2
    runs = {}
    for name, iters, ckpt in (("straight", NYT_EX_ITERS, "a"),
                              ("stop", half, "b"),
                              ("resume", NYT_EX_ITERS, "b")):
        t0 = time.perf_counter()
        (s, state), out = _captured(
            nyt.main, ["--iters", str(iters), "--ckpt", str(out_dir / ckpt)])
        torch.cuda.synchronize()
        runs[name] = {
            "seconds": time.perf_counter() - t0,
            "iteration": int(state.iteration),
            "topic_sha256": hashlib.sha256(
                state.topic.cpu().numpy().tobytes()).hexdigest(),
            "last_line": [ln for ln in out.splitlines()
                          if ln.startswith("iter")][-1],
            "resumed": "resumed from iteration" in out}
        state.check_invariants(s.corpus)
        del s, state
    counts = ops.launch_counts()
    shutil.rmtree(out_dir, ignore_errors=True)
    record["train_nytimes"] = {"iterations": NYT_EX_ITERS, "runs": runs}
    record["launches"] = counts
    emit(record)
    check(runs["resume"]["resumed"] and runs["stop"]["iteration"] == half
          and runs["resume"]["iteration"] == NYT_EX_ITERS,
          f"train_nytimes_lda_torch: the stop and resume runs: {runs}")
    check(runs["resume"]["topic_sha256"] == runs["straight"]["topic_sha256"],
          "train_nytimes_lda_torch: the resumed run's topics differ from "
          "the straight run's")
    # both examples train on zen (plain torch): kernel 5 on every step's
    # delta merge, twice, and no other kernel
    check_launches("examples", counts,
                   {"topic_histogram": 2 * (30 + 2 * NYT_EX_ITERS)})
    return counts


def lm_prompts(seed: int, vocab: int):
    """LM_REQUESTS prompts of LM_PROMPT[0]..LM_PROMPT[1] tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def lm_expected_calls(prompts, outs, batch: int, max_new: int):
    """The decode calls the engine's rules make for ``prompts`` (submitted
    in order) emitting ``outs``: (fed tokens, fresh cache, [(slot,
    request, output index)] for a generation step or None for an
    admission call). Admission feeds a prompt token by token over the
    whole batch; the cache restarts only when every slot is empty."""
    import numpy as np

    tokens = np.zeros((batch,), np.int32)
    active = [None] * batch
    queue = list(range(len(prompts)))
    emitted = [0] * len(prompts)
    calls, fresh = [], False
    while queue or any(a is not None for a in active):
        for slot in range(batch):
            if active[slot] is not None or not queue:
                continue
            r = queue.pop(0)
            fresh = fresh or all(a is None for a in active)
            for t in prompts[r][:-1]:
                tokens[slot] = t
                calls.append((tokens.copy(), fresh, None))
                fresh = False
            tokens[slot] = prompts[r][-1]
            active[slot] = r
        gen = [(s, r, emitted[r]) for s, r in enumerate(active)
               if r is not None]
        calls.append((tokens.copy(), fresh, gen))
        fresh = False
        for s, r, k in gen:
            tokens[s] = outs[r][k]
            emitted[r] += 1
            if emitted[r] >= max_new:
                active[s] = None
    return calls


def lm_spy(engine, dev):
    """Wrap the engine's decode: every call's fed tokens, whether its
    cache was fresh (not the one the previous call returned), its device
    ms (synchronised either side) and its logits (kept on the card)."""
    import torch

    decode = engine._decode
    calls, last = [], [None]

    def spy(p, t, c):
        fresh = c is not last[0]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, caches = decode(p, t, c)
        torch.cuda.synchronize(dev)
        calls.append({"fed": t.cpu().numpy(), "fresh": fresh,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "logits": logits})
        last[0] = caches
        return logits, caches

    engine._decode = spy
    return calls


def lm_top2_gap(logits):
    """Per row: the float32 argmax (the first maximum, as ``np.argmax``)
    and the gap between the top two values."""
    import torch

    l32 = logits.to(torch.float32)
    top = torch.topk(l32, 2, dim=-1).values
    return torch.argmax(l32, dim=-1), top[:, 0] - top[:, 1]


def lm_replay(lm, cfg, calls, expected, dev):
    """Feed the recorded tokens from a fresh cache at every reset: the
    largest logit difference from the engine's run, and per generation
    step (slot, request, k) the replay's argmax and top-2 gap."""
    import torch

    from repro_torch.models import model as M

    caches, max_diff, picks = None, torch.zeros((), device=dev), []
    with torch.no_grad():
        for call, (fed, fresh, gen) in zip(calls, expected):
            if fresh:
                caches = M.init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=dev)
            logits, caches = M.decode_step(
                lm, cfg, torch.tensor(fed, device=dev), caches)
            max_diff = torch.maximum(max_diff, (
                logits.to(torch.float32)
                - call["logits"].to(torch.float32)).abs().max())
            if gen is not None:
                picks.append((gen, *lm_top2_gap(logits)))
    return float(max_diff), [
        (s, r, k, int(idx[s]), float(gap[s]))
        for gen, idx, gap in [(g, i.cpu(), d.cpu()) for g, i, d in picks]
        for s, r, k in gen]


def lm_card_vs_cpu(seed: int, dev):
    """Check 4: each -smoke config in float32, the same parameters on the
    card and on the CPU: forward, then LM_SMOKE_STEPS decode steps (logits
    and every cache leaf) within LM_SMOKE_TOL. Returns the largest
    differences per config."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import model as M

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, tuple):
            return [x for v in tree for x in leaves(v)]
        return [] if tree is None else [tree]

    out = {}
    for arch in list_archs(lm_only=True):
        cfg = dataclasses.replace(get_config(arch + "-smoke"),
                                  dtype="float32")
        cpu = M.init_params(seed, cfg, device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(seed)
        kw = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
            np.int32)}
        if cfg.family == "encdec":
            kw["enc_embeds"] = rng.standard_normal(
                (2, 16, cfg.d_model)).astype(np.float32)
        diffs = {}
        with torch.no_grad():
            lc, ac = M.forward(cpu, cfg, **{k: torch.from_numpy(v)
                                            for k, v in kw.items()})
            lg, ag = M.forward(gpu, cfg, **{k: torch.from_numpy(v).to(dev)
                                            for k, v in kw.items()})
            pairs = [("forward", lc, lg.cpu()), ("aux", ac, ag.cpu())]
            s_enc = 16 if cfg.family == "encdec" else 0
            cc = M.init_cache(cfg, 2, 32, s_enc=s_enc, device="cpu")
            cg = M.init_cache(cfg, 2, 32, s_enc=s_enc, device=dev)
            for i, t in enumerate(rng.integers(
                    0, cfg.vocab_size, (LM_SMOKE_STEPS, 2)).astype(np.int32)):
                dc, cc = M.decode_step(cpu, cfg, torch.from_numpy(t), cc)
                dg, cg = M.decode_step(gpu, cfg, torch.from_numpy(t).to(dev),
                                       cg)
                pairs.append((f"decode{i}", dc, dg.cpu()))
            pairs += [(f"cache{j}", a, b.cpu())
                      for j, (a, b) in enumerate(zip(leaves(cc), leaves(cg)))]
        for name, a, b in pairs:
            check(a.shape == b.shape and torch.allclose(
                a.to(torch.float32), b.to(torch.float32), rtol=LM_SMOKE_TOL,
                atol=LM_SMOKE_TOL),
                f"lm_serve: {arch}-smoke {name} on the card differs from "
                f"the CPU by {float((a.float() - b.float()).abs().max())}")
            diffs[name] = float((a.float() - b.float()).abs().max())
        out[arch] = {"forward": diffs["forward"],
                     "decode": max(v for k, v in diffs.items()
                                   if k.startswith("decode")),
                     "cache": max(v for k, v in diffs.items()
                                  if k.startswith("cache"))}
        del cpu, gpu
    return out


def lm_prefill_consistency(seed: int, dev):
    """Check 3: LM_ARCH at full width, depth cut to LM_CHECK_LAYERS, in
    float32: prefill_with_cache then decode_step equals forward within
    LM_PREFILL_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(LM_ARCH),
                              num_layers=LM_CHECK_LAYERS, dtype="float32")
    lm = M.init_params(seed, cfg, device=dev)
    s = 12
    tokens = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, s + 1)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        pre, cache = M.prefill_with_cache(lm, cfg, tokens[:, :s], 32)
        dec, _ = M.decode_step(lm, cfg, tokens[:, s], cache)
        full, _ = M.forward(lm, cfg, tokens=tokens)
    d_dec = float((dec - full[:, s, :cfg.vocab_size]).abs().max())
    d_pre = float((pre - full[:, s - 1]).abs().max())
    check(torch.allclose(dec, full[:, s, :cfg.vocab_size],
                         rtol=LM_PREFILL_TOL, atol=LM_PREFILL_TOL)
          and torch.allclose(pre, full[:, s - 1], rtol=LM_PREFILL_TOL,
                             atol=LM_PREFILL_TOL),
          f"lm_serve: prefill + decode differ from forward at full width "
          f"({d_pre}, {d_dec})")
    return {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "prefill_max_abs": d_pre, "decode_max_abs": d_dec,
            "params": lm.num_params()}


def phase_lm_serve(seed: int, dev, smi):
    """The LM zoo's serving path (``repro_torch.models``,
    ``repro_torch.serving.ServingEngine``) at LM_ARCH's published widths
    and full depth in bf16, random weights from ``seed``: the parameter
    count against the reference's; LM_REQUESTS requests of LM_PROMPT
    tokens, LM_MAX_NEW new tokens each, greedy, LM_BATCH slots of
    LM_MAX_LEN positions, every decode call recorded (synchronised either
    side: its ms; the run's wall clock gives tokens/sec), checked: (1) the engine's
    bookkeeping (the fed tokens are what its admission rule makes of the
    prompts and outputs, each output the argmax of its own logits for its
    slot, the cache reset only when every slot was empty and its length
    below LM_MAX_LEN), (2) a replay of the fed tokens from a fresh cache
    reproduces every emitted token (the largest logit difference stated).
    Peak memory, the step against its weight-read bound, a
    profiled step. Then (3) prefill + decode == forward at full width
    (LM_CHECK_LAYERS layers, float32), (4) every -smoke config on the card
    == on the CPU, and ``examples/serve_lm_torch.py`` on the card.
    Returns the LM serving runs' kernel launches (none of the seven)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = get_config(LM_ARCH)
    record = {"phase": "lm_serve", "arch": LM_ARCH, "card": smi,
              "widths": {k: getattr(cfg, k) for k in (
                  "num_layers", "d_model", "num_heads", "num_kv_heads",
                  "resolved_head_dim", "d_ff", "vocab_size",
                  "padded_vocab_size", "qk_norm", "rope_theta", "dtype")}}
    torch.zeros((), device=dev)  # the allocator exists before its reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lm = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                       device=dev)
    torch.cuda.synchronize(dev)
    weight_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    record.update(init_s=time.perf_counter() - t0, params=lm.num_params(),
                  weight_bytes=weight_bytes)
    check(lm.num_params() == LM_PARAMS,
          f"lm_serve: {lm.num_params()} parameters, the reference counts "
          f"{LM_PARAMS}")
    prompts = lm_prompts(seed, cfg.vocab_size)
    engine = ServingEngine(lm, cfg, ServeConfig(max_batch=LM_BATCH,
                                                max_len=LM_MAX_LEN),
                           device=dev)
    calls = lm_spy(engine, dev)
    for p in prompts:
        engine.submit(p, max_new=LM_MAX_NEW)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = sorted(engine.run_until_done(), key=lambda r: r.uid)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    outs = [r.out for r in done]
    check(len(done) == LM_REQUESTS
          and all(len(o) == LM_MAX_NEW for o in outs),
          f"lm_serve: {len(done)} requests finished, lengths "
          f"{[len(o) for o in outs]}")
    # (1) bookkeeping
    expected = lm_expected_calls(prompts, outs, LM_BATCH, LM_MAX_NEW)
    check(len(calls) == len(expected)
          and all(np.array_equal(c["fed"], e[0]) and c["fresh"] == e[1]
                  for c, e in zip(calls, expected)),
          "lm_serve: the engine fed other tokens (or reset its cache "
          "elsewhere) than its admission rule makes of the prompts and "
          "outputs")
    gen_calls = [(c, e[2]) for c, e in zip(calls, expected) if e[2]]
    for c, gen in gen_calls:  # the engine's own choice, on the host
        host = c["logits"].to(torch.float32).cpu().numpy()
        check(all(int(np.argmax(host[s])) == outs[r][k] for s, r, k in gen),
              "lm_serve: an output is not the argmax of the engine's "
              "logits")
    rounds, n = [], 0
    for _, fresh, _ in expected:
        if fresh and n:
            rounds.append(n)
            n = 0
        n += 1
    rounds.append(n)
    check(max(rounds) < LM_MAX_LEN,
          f"lm_serve: the shared cache length reached {max(rounds)}")
    # (2) replay from a fresh cache
    max_diff, picks = lm_replay(lm, cfg, calls, expected, dev)
    parted = [(s, r, k, i, gap) for s, r, k, i, gap in picks
              if i != outs[r][k]]
    check(all(gap <= 2 * max_diff for *_, gap in parted),
          f"lm_serve: the replay emits other tokens away from near-ties: "
          f"{parted[:4]} (largest logit difference {max_diff})")
    ms = np.array([c["ms"] for c in calls])
    gen_ms = np.array([c["ms"] for c, _ in gen_calls])
    del calls, gen_calls
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    n_tokens = LM_REQUESTS * LM_MAX_NEW
    # one decode step profiled, over the last round's cache
    torch.cuda.synchronize(dev)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.decode_step(lm, cfg, torch.tensor(engine.tokens, device=dev),
                      engine.caches)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    record.update(
        requests=LM_REQUESTS, prompt_tokens=sum(map(len, prompts)),
        max_new=LM_MAX_NEW, max_batch=LM_BATCH, max_len=LM_MAX_LEN,
        decode_calls=len(expected),
        admission_calls=len(expected) - len(gen_ms),
        generation_steps=len(gen_ms), calls_per_round=rounds,
        max_cache_length=max(rounds),
        replay_max_abs_logit_diff=max_diff,
        replay_parted_at_near_ties=len(parted), wall_s=wall, generated_tokens=n_tokens,
        tokens_per_s=n_tokens / wall, decode_calls_per_s=len(expected) / wall,
        decode_ms_p50=float(np.percentile(ms, 50)),
        decode_ms_p99=float(np.percentile(ms, 99)),
        generation_ms_p50=float(np.percentile(gen_ms, 50)),
        generation_ms_p99=float(np.percentile(gen_ms, 99)),
        weight_read_bound_ms=bound_ms,
        p50_over_bound=float(np.percentile(ms, 50)) / bound_ms,
        peak_memory_bytes=peak, kernel_launches=counts,
        profiled_step=device_summary(prof, wall_us, items=10),
        first_outputs=outs[:2])
    del engine, lm, prof
    torch.cuda.empty_cache()
    check(not any(counts.values()),
          f"lm_serve: the LM path launched LDA kernels {counts}")
    # (3), (4)
    record["prefill_consistency"] = lm_prefill_consistency(seed, dev)
    torch.cuda.empty_cache()
    record["smoke_card_vs_cpu"] = lm_card_vs_cpu(seed, dev)
    # the example, on its default device (the card)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (ex_done, theta), out = _captured(_example("serve_lm_torch").main, [])
    torch.cuda.synchronize(dev)
    ex_counts = ops.launch_counts()
    record["example"] = {"seconds": time.perf_counter() - t0,
                         "stdout": out.splitlines(), "launches": ex_counts}
    emit(record)
    check("on cuda" in out and [len(r.out) for r in ex_done] == [8] * 4
          and bool(torch.isfinite(theta).all())
          and abs(float(theta.sum()) - 1) < 1e-4,
          f"serve_lm_torch on the card: {out}")
    # its RT-LDA leg trains 20 zen iterations: kernel 5 twice a step
    check_launches("serve_lm_torch", ex_counts, {"topic_histogram": 40})
    return counts


def lm_train_batch(cfg, rng, dev, batch: int = LM_TRAIN_BATCH,
                   seq: int = LM_TRAIN_SEQ):
    """examples/train_lm_torch.py's synthetic tokens."""
    return _example("train_lm_torch").make_batch(cfg, rng, batch, seq, dev)


def lm_train_steps(state, cfg, opt, seed: int, dev):
    """LM_TRAIN_STEPS train steps of ``state``, each synchronised and
    timed, on batches drawn from ``seed``: (the state after them, losses,
    grad norms, ms)."""
    import numpy as np
    import torch

    from repro_torch.train.train_step import make_train_step

    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    losses, norms, ms = [], [], []
    for _ in range(LM_TRAIN_STEPS):
        b = lm_train_batch(cfg, rng, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, ms


def _grad_gap(grads, base):
    """(bit-equal?, the largest |difference| scaled by the leaf's largest
    |g|, that leaf)."""
    import torch

    worst, leaf = 0.0, None
    for n, g in base.items():
        d = float((grads[n] - g).abs().max()) / (float(g.abs().max()) or 1.0)
        if d > worst:
            worst, leaf = d, n
    equal = all(torch.equal(grads[n], g) for n, g in base.items())
    return equal, worst, leaf


def lm_train_remat(seed: int, dev):
    """Check (a): LM_ARCH at full width, LM_TRAIN_CHECK_LAYERS layers in
    float32, one batch: loss and grads under the three remat policies
    against ``none``'s, each policy's peak memory and ms."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.train_step import compute_grads

    base = dataclasses.replace(get_config(LM_ARCH), dtype="float32",
                               num_layers=LM_TRAIN_CHECK_LAYERS)
    lm = M.init_params(torch.Generator(device=dev).manual_seed(seed), base,
                       device=dev).requires_grad_(True)
    b = lm_train_batch(base, np.random.default_rng(seed), dev)
    out, ref = {}, None
    for policy in ("none", "nothing_saveable", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _, grads = compute_grads(lm, cfg, b)
        torch.cuda.synchronize(dev)
        row = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        if ref is None:
            ref = (loss, grads)
        else:
            equal, gap, leaf = _grad_gap(grads, ref[1])
            row.update(bit_equal=equal and bool(torch.equal(loss, ref[0])),
                       loss_diff=float(loss - ref[0]), max_grad_gap=gap,
                       max_gap_leaf=leaf)
            check(float((loss - ref[0]).abs()) <= LM_REMAT_TOL
                  and gap <= LM_REMAT_TOL,
                  f"lm_train: remat {policy} differs from none: loss "
                  f"{row['loss_diff']}, grads {gap} at {leaf}")
            del grads
        out[policy] = row
    return {"layers": base.num_layers, "dtype": base.dtype,
            "tokens": LM_TRAIN_BATCH * LM_TRAIN_SEQ, **out}


def lm_train_microbatch(seed: int, dev):
    """Check (b): the same config, one step of 1 against 4 microbatches
    from the same parameters and batch, with the reference test's default
    ``OptConfig()``: the parameters after it within LM_MB_TOL (AdamW's
    first step moves an element by up to lr = 3e-4 whatever its |g|, so
    a sign that the summation order flips costs at most 6e-4)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32",
                              num_layers=LM_TRAIN_CHECK_LAYERS)
    opt = OptConfig()
    b = lm_train_batch(cfg, np.random.default_rng(seed), dev)
    after, metrics = {}, {}
    for n_mb in (1, 4):
        st = init_train_state(torch.Generator(device=dev).manual_seed(seed),
                              cfg, opt, device=dev)
        st, m = make_train_step(cfg, opt, num_microbatches=n_mb)(st, b)
        metrics[n_mb] = {k: float(v) for k, v in m.items()}
        if n_mb == 1:
            after = {n: p.detach().clone()
                     for n, p in st.params.named_parameters()}
            del st
            torch.cuda.empty_cache()
            continue
        gap = max(float((p.detach() - after[n]).abs().max())
                  for n, p in st.params.named_parameters())
    del st, after
    torch.cuda.empty_cache()
    check(gap <= LM_MB_TOL,
          f"lm_train: 4 microbatches end {gap} from 1 (> {LM_MB_TOL})")
    return {"max_abs_param_gap": gap, "metrics": metrics}


def lm_train_card_vs_cpu(seed: int, dev):
    """Check (c): each -smoke config in float32, the same parameters and
    batch on the card and on the CPU, one train step with the config's
    own optimizer: the loss, every gradient (scaled by its leaf's largest
    |g|) and the parameters after the step within LM_SMOKE_TOL; an element
    whose CPU gradient is below LM_SIGN_FLOOR of its leaf's largest is
    left out of the parameters and counted."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import TrainState, compute_grads, \
        make_train_step

    opt = OptConfig(learning_rate=LM_EXAMPLE_LR)
    out = {}
    for arch in list_archs(lm_only=True):
        cfg = dataclasses.replace(get_config(arch + "-smoke"),
                                  dtype="float32")
        cpu = M.init_params(seed, cfg, device="cpu").requires_grad_(True)
        gpu = copy.deepcopy(cpu).to(dev)
        bc = lm_train_batch(cfg, np.random.default_rng(seed), "cpu", 2, 16)
        bg = {k: v.to(dev) for k, v in bc.items()}
        lc, _, gc = compute_grads(cpu, cfg, bc)
        lg, _, gg = compute_grads(gpu, cfg, bg)
        _, grad_gap, leaf = _grad_gap({n: g.cpu() for n, g in gg.items()},
                                      gc)
        init, _ = make_optimizer(cfg.optimizer, opt)
        step = make_train_step(cfg, opt)
        zero = torch.zeros((), dtype=torch.int32)
        step(TrainState(cpu, init(cpu), zero), bc)
        step(TrainState(gpu, init(gpu), zero.to(dev)), bg)
        param_gap, left_out = 0.0, 0
        for (n, pc), (_, pg) in zip(cpu.named_parameters(),
                                    gpu.named_parameters()):
            keep = gc[n].abs() >= LM_SIGN_FLOOR * (float(gc[n].abs().max())
                                                   or 1.0)
            left_out += int((~keep).sum())
            if keep.any():
                d = (pg.detach().cpu()[keep] - pc.detach()[keep]).abs()
                param_gap = max(param_gap, float(
                    (d / (1 + pc.detach()[keep].abs())).max()))
        loss_gap = abs(float(lg) - float(lc))
        check(loss_gap <= LM_SMOKE_TOL * (1 + abs(float(lc)))
              and grad_gap <= LM_SMOKE_TOL and param_gap <= LM_SMOKE_TOL,
              f"lm_train: {arch}-smoke train step on the card differs from "
              f"the CPU: loss {loss_gap}, grads {grad_gap} ({leaf}), "
              f"parameters {param_gap}")
        out[arch] = {"optimizer": cfg.optimizer, "loss": float(lc),
                     "loss_gap": loss_gap, "grad_gap": grad_gap,
                     "grad_gap_leaf": leaf, "param_gap": param_gap,
                     "params_left_out": left_out,
                     "params": sum(p.numel() for p in cpu.parameters())}
        del cpu, gpu, gc, gg
    return out


def _copy_into(dst, src) -> None:
    """A restored tree's host leaves into the live tensors of ``dst``, a
    tree of the same structure (NamedTuples come back as tuples)."""
    import numpy as np
    import torch

    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.asarray(src)))


def lm_train_loop_resume(seed: int, dev, out_dir):
    """Check (d): ``TrainLoop`` on LM_ARCH's smoke config (bf16), the
    checkpoint tree holding the parameters (the reference's layout), the
    optimizer state and the step: LM_LOOP_STEPS straight against a run
    stopped at LM_LOOP_STOP and resumed by a new loop and state. Each step
    draws its batch from a generator seeded by the step, so both runs see
    the same tokens. Returns the comparison."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.convert import load_into, params_to_reference
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    cfg = get_config(LM_ARCH + "-smoke")
    opt = OptConfig(learning_rate=LM_EXAMPLE_LR)
    step_fn = make_train_step(cfg, opt)

    def loop_step(st):
        rng = np.random.default_rng(seed * 1000 + int(st.step))
        return step_fn(st, lm_train_batch(cfg, rng, dev, 8, 64))

    def tree(st):
        return {"params": params_to_reference(st.params),
                "opt": st.opt_state, "step": st.step}

    def restore(st, t):
        load_into(st.params, t["params"])
        _copy_into(st.opt_state, t["opt"])
        _copy_into(st.step, t["step"])
        return st

    def run(directory, steps, every):
        loop = TrainLoop(loop_step, LoopConfig(
            num_steps=steps, checkpoint_every=every,
            checkpoint_dir=str(directory), log_every=0),
            checkpoint_tree_fn=tree, restore_fn=restore)
        return loop.run(init_train_state(
            torch.Generator(device=dev).manual_seed(seed), cfg, opt,
            device=dev))

    shutil.rmtree(out_dir, ignore_errors=True)
    straight = run(out_dir / "straight", LM_LOOP_STEPS, LM_LOOP_STEPS)
    first = run(out_dir / "stopped", LM_LOOP_STOP, LM_LOOP_STOP)
    check(int(first.step) == LM_LOOP_STOP, "lm_train: the stopped run")
    resumed = run(out_dir / "stopped", LM_LOOP_STEPS, LM_LOOP_STEPS)
    shutil.rmtree(out_dir, ignore_errors=True)
    pairs = [(f"params.{n}", a, b) for (n, a), (_, b) in zip(
        straight.params.named_parameters(), resumed.params.named_parameters())]
    pairs += [(f"{k}.{n}", getattr(straight.opt_state, k)[n],
               getattr(resumed.opt_state, k)[n])
              for k in ("m", "v") for n in straight.opt_state.m]
    unequal = [(n, float((a.float() - b.float()).abs().max()))
               for n, a, b in pairs if not torch.equal(a, b)]
    check(int(resumed.step) == LM_LOOP_STEPS and not unequal,
          f"lm_train: stopped at {LM_LOOP_STOP} and resumed differs from "
          f"the straight run: {unequal[:6]}")
    return {"steps": LM_LOOP_STEPS, "stopped_at": LM_LOOP_STOP,
            "leaves_compared": len(pairs), "bit_equal": not unequal}


def phase_lm_train(seed: int, dev, smi):
    """LM training (``repro_torch.train``): LM_ARCH at its published widths
    with LM_TRAIN_LAYERS layers in bf16, the config's AdamW and remat
    policy, LM_TRAIN_STEPS steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens
    of examples/train_lm_torch.py's data, synchronised and timed; the
    parameter count against the reference's, the loss finite and falling,
    MFU by ``model_flops``, peak memory, a profiled step. Then checks
    (a)-(d) (``lm_train_remat``, ``lm_train_microbatch``,
    ``lm_train_card_vs_cpu``, ``lm_train_loop_resume``) and (e)
    ``examples/train_lm_torch.py`` on the card. Returns the phase's
    launches of the seven kernels (none may launch)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    record = {"phase": "lm_train", "arch": LM_ARCH, "card": smi,
              "cut": {"num_layers": [get_config(LM_ARCH).num_layers,
                                     LM_TRAIN_LAYERS]},
              "widths": {k: getattr(cfg, k) for k in (
                  "num_layers", "d_model", "num_heads", "num_kv_heads",
                  "resolved_head_dim", "d_ff", "vocab_size",
                  "padded_vocab_size", "qk_norm", "rope_theta", "dtype",
                  "optimizer", "remat_policy")}}
    # earlier phases' tensors held only by reference cycles go now: the
    # state and the step need all but ~15 GB of the card
    gc.collect()
    torch.zeros((), device=dev)  # the allocator exists before its reset
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    record["held_at_start_bytes"] = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    opt = OptConfig(learning_rate=LM_TRAIN_LR)
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed),
                             cfg, opt, device=dev)
    torch.cuda.synchronize(dev)
    n = state.params.num_params()
    record.update(init_s=time.perf_counter() - t0, params=n,
                  state_bytes=LM_STATE_BYTES * n)
    check(n == LM_TRAIN_PARAMS,
          f"lm_train: {n} parameters, the reference counts "
          f"{LM_TRAIN_PARAMS}")
    state, losses, norms, ms = lm_train_steps(state, cfg, opt, seed, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    step = make_train_step(cfg, opt)
    b = lm_train_batch(cfg, np.random.default_rng(seed + 1), dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e3 * 1e3
    profiled = device_summary(prof, wall_us, items=12)
    del state, prof, b, m
    torch.cuda.empty_cache()
    # the example's learning rate at this width, on the same batches
    ex_opt = OptConfig(learning_rate=LM_EXAMPLE_LR)
    _, ex_losses, ex_norms, _ = lm_train_steps(init_train_state(
        torch.Generator(device=dev).manual_seed(seed), cfg, ex_opt,
        device=dev), cfg, ex_opt, seed, dev)
    torch.cuda.empty_cache()
    check(all(np.isfinite(ex_losses)),
          f"lm_train: at lr {LM_EXAMPLE_LR} a loss is not finite")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = model_flops(cfg, ShapeConfig("lm_train", "train", LM_TRAIN_SEQ,
                                         LM_TRAIN_BATCH))
    p50 = float(np.percentile(ms, 50))
    record.update(
        steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
        learning_rate=LM_TRAIN_LR, losses=losses, grad_norms=norms,
        step_ms=ms, step_ms_p50=p50,
        step_ms_p99=float(np.percentile(ms, 99)),
        step_ms_p50_after_first=float(np.percentile(ms[1:], 50)),
        step_ms_p99_after_first=float(np.percentile(ms[1:], 99)),
        example_lr={"learning_rate": LM_EXAMPLE_LR, "losses": ex_losses,
                    "grad_norms": ex_norms},
        tokens_per_s=tokens / (p50 / 1e3), model_flops=flops,
        mfu=flops / (p50 / 1e3) / PEAK_FLOPS,
        mfu_convention="6*N*T (launch.roofline.model_flops: N every "
                       "parameter, T tokens per step; remat's second "
                       "forward not counted) over the p50 step and one "
                       "H100's 989 TFLOP/s dense bf16",
        peak_memory_bytes=peak, peak_over_state=peak / (LM_STATE_BYTES * n),
        profiled_step=profiled)
    check(all(np.isfinite(losses)),
          f"lm_train: a loss is not finite: {losses}")
    check(float(np.mean(losses[-4:])) < losses[0],
          f"lm_train: the loss did not fall: {losses}")
    record["remat"] = lm_train_remat(seed, dev)
    torch.cuda.empty_cache()
    record["microbatch"] = lm_train_microbatch(seed, dev)
    torch.cuda.empty_cache()
    record["smoke_card_vs_cpu"] = lm_train_card_vs_cpu(seed, dev)
    record["loop_resume"] = lm_train_loop_resume(
        seed, dev, ROOT / "build" / "chip_smoke_lm_train")
    t0 = time.perf_counter()
    (final, run), out = _captured(_example("train_lm_torch").main, [])
    torch.cuda.synchronize(dev)
    record["example"] = {"seconds": time.perf_counter() - t0,
                         "stdout": out.splitlines(),
                         "first_losses": run[:3], "last_losses": run[-3:]}
    check("finished at step 60" in out and int(final.step) == 60
          and final.step.device.type == "cuda"
          and float(np.mean(run[-10:])) < float(np.mean(run[:10])),
          f"train_lm_torch on the card: {out} {run}")
    del final
    counts = ops.launch_counts()
    record.update(kernel_launches=counts,
                  seconds=time.perf_counter() - t_phase)
    emit(record)
    check(not any(counts.values()),
          f"lm_train: the LM training path launched LDA kernels {counts}")
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lm_dryrun_cells(smi):
    """(a): LM_DRYRUN_CELLS traced on their production meshes with the
    mesh's device type ``cuda``; each record, then the table's rows."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.table import LINK_NOTE, build_rows, render

    store = {}
    for arch, shape, multi in LM_DRYRUN_CELLS:
        rec = run_cell(arch, shape, multi, "cuda")
        emit({"phase": "lm_dryrun_cell", "card": smi, **rec})
        mem = rec["memory_analysis"]
        check(rec["ok"] and rec["bytes_per_device"] > 0
              and rec["collective_bytes_per_device"] > 0
              and mem["peak_memory_in_bytes"] > 0
              and (rec["flops_per_device"] > 0 or arch.startswith("zenlda")),
              f"lm_dryrun: {arch} x {shape} ({rec['mesh']}): {rec}")
        store[f"{arch}|{shape}|{'multi' if multi else 'single'}"] = rec
    rows = build_rows(store)
    emit({"phase": "lm_dryrun_table", "note": LINK_NOTE,
          "rows": [{k: v for k, v in r.items() if k != "mem_analysis"}
                   for r in rows], "markdown": render(rows).splitlines()})
    return store


def lm_dryrun_vs_step(seed: int, dev):
    """(b) and (c): lm_train's cell (LM_ARCH, LM_TRAIN_LAYERS layers, bf16,
    LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, AdamW, the config's remat)
    traced on a (1, 1) fake mesh, against the real steps on the card:
    its peak against the first plain step's ``max_memory_allocated``;
    the same state as DTensors on a one-rank NCCL (1, 1) mesh,
    LM_DRYRUN_STEPS steps against the plain ones (loss, every parameter),
    each step timed; its flops against ``FlopCounterMode`` over the first
    step's forward and backward on the card (the counted loss == the
    plain step's)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.sharding.partition import batch_sharding, distribute
    from repro_torch.train.checkpoint import shard_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import compute_grads, \
        init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(LM_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    cell = ShapeConfig("lm_train", "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    pred = trace_cell(cfg, cell, (1, 1), ("data", "model"), "cuda")
    opt = OptConfig(learning_rate=LM_TRAIN_LR)
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    batches = [lm_train_batch(cfg, rng, dev)
               for _ in range(LM_DRYRUN_STEPS)]

    def fresh():
        return init_train_state(
            torch.Generator(device=dev).manual_seed(seed), cfg, opt,
            device=dev)

    def run(state, bs):
        """Steps on ``bs``, each timed and its peak read (the allocator's
        peak reset before it)."""
        losses, ms, peaks = [], [], []
        for b in bs:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated(dev))
            losses.append(float(m["loss"]))
        return state, losses, ms, peaks

    def free():
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    free()
    held = torch.cuda.memory_allocated(dev)
    state, losses, ms, peaks = run(fresh(), batches)
    plain = {n: p.detach().cpu() for n, p in state.params.named_parameters()}
    del state
    free()

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        state = shard_state(fresh(), cfg, mesh)
        sh = batch_sharding(batches[0], mesh)
        placed = [{k: distribute(v, sh[k])
                   for k, v in b.items()} for b in batches]
        state, d_losses, d_ms, d_peaks = run(state, placed)
        gaps = {}
        for n, p in state.params.named_parameters():
            got = p.to_local().detach().cpu()
            if not torch.equal(got, plain[n]):
                want = plain[n].float()
                gaps[n] = float(((got.float() - want).abs().max()
                                 / want.abs().max().clamp_min(1e-30)))
        del state, placed
    finally:
        dist.destroy_process_group()
    free()
    # FlopCounterMode over the real step's forward and backward, apart,
    # with the parameters alone resident: the update after them is AdamW,
    # which holds no product the counter counts, and the whole step under
    # the mode peaked 25 GB above the plain one (82.3 GB: out of memory
    # after the earlier phases)
    lm = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                     device=dev).requires_grad_(True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        fc_loss, _, grads = compute_grads(lm, cfg, batches[0])
    torch.cuda.synchronize(dev)
    fc_ms = (time.perf_counter() - t0) * 1e3
    flops = float(fc.get_total_flops())
    fc_peak = torch.cuda.max_memory_allocated(dev)
    fc_loss = float(fc_loss)
    del lm, grads
    free()
    peak = peaks[0] - held
    pred_peak = pred["memory_analysis"]["peak_memory_in_bytes"]
    out = {"trace": pred, "flop_counter": flops,
           "measured_peak_bytes": peak, "held_at_start_bytes": held,
           "peak_gap": pred_peak / peak - 1.0,
           "plain": {"losses": losses, "step_ms": ms, "step_peaks": peaks},
           "sharded": {"losses": d_losses, "step_ms": d_ms,
                       "step_peaks": d_peaks, "unequal_leaves": gaps,
                       "placements": "Replicate() on the (1, 1) mesh: "
                                     "every leaf whole"},
           "flop_counter_grads": {"loss": fc_loss, "ms": fc_ms,
                                  "peak": fc_peak}}
    check(pred["flops_per_device"] == flops,
          f"lm_dryrun (b): traced flops {pred['flops_per_device']} != "
          f"FlopCounterMode {flops}")
    check(fc_loss == losses[0],
          f"lm_dryrun (b): the counted loss {fc_loss} != {losses[0]}")
    check(abs(out["peak_gap"]) <= LM_DRYRUN_PEAK_TOL,
          f"lm_dryrun (b): predicted peak {pred_peak} vs measured {peak}")
    check(d_losses == losses,
          f"lm_dryrun (c): DTensor losses {d_losses} != plain {losses}")
    check(not gaps or max(gaps.values()) <= 1e-5,
          f"lm_dryrun (c): parameters differ from the plain step's: {gaps}")
    return out


def lm_dryrun_lda(dev):
    """(d): the LDA cell at mesh_four's (2, 2) grid and padded blocks
    (K_NYT topics) traced on a fake mesh: its collective bytes against
    what mesh_four's ranks all-reduced in an iteration. The cell sweeps
    with NYTIMES's ``zen_cdf`` (mesh_four's ``zen_pallas`` wrappers refuse
    a ``meta`` tensor); a step's all-reduces are the same for every
    backend."""
    from repro_torch.configs.base import LDAArchConfig
    from repro_torch.launch.dryrun import trace_cell

    seen = MESH_FOUR_SEEN
    rows, cols = MESH_FOUR_SHAPE
    dims = {"words_per_shard": seen["words_per_shard"],
            "docs_per_shard": seen["docs_per_shard"],
            "e_cell": -(-max(seen["cell_tokens"]) // 8) * 8}
    cfg = LDAArchConfig(name="mesh_four", num_words=dims[
        "words_per_shard"] * cols, num_topics=K_NYT,
        docs_per_step=dims["docs_per_shard"] * rows, avg_doc_len=1,
        algorithm="zen_cdf", max_kd=128)
    rec = trace_cell(cfg, "train_lda", MESH_FOUR_SHAPE, ("data", "model"),
                     "cuda", lda_dims=dims)
    want = (dims["words_per_shard"] + dims["docs_per_shard"] + 1) \
        * K_NYT * 4
    check(seen["all_reduce_bytes"] == [want]
          and rec["collective_bytes_per_device"] == want,
          f"lm_dryrun (d): traced {rec['collective_bytes_per_device']} "
          f"bytes, mesh_four all-reduced {seen['all_reduce_bytes']}, "
          f"blocks give {want}")
    return {"dims": dims, "trace": rec,
            "mesh_four_all_reduce_bytes": seen["all_reduce_bytes"],
            "d_wk_bytes": dims["words_per_shard"] * K_NYT * 4,
            "d_kd_bytes": dims["docs_per_shard"] * K_NYT * 4,
            "d_k_bytes": K_NYT * 4}


def phase_lm_dryrun(seed: int, dev, smi):
    """The torch dry-run on the card (``repro_torch.launch.dryrun``): (a)
    the production-mesh cells, (b) lm_train's cell against the real step,
    (c) that step as DTensors on a one-rank NCCL mesh against the plain
    one, (d) the LDA cell's collective bytes against mesh_four's. Returns
    the phase's launches of the seven kernels (none may launch)."""
    import logging

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    # DTensor's planner logs a warning per sequential redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    ops.reset_launch_counts()
    record = {"phase": "lm_dryrun", "card": smi}
    t0 = time.perf_counter()
    lm_dryrun_cells(smi)
    record["cells_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["vs_step"] = lm_dryrun_vs_step(seed, dev)
    record["vs_step_s"] = time.perf_counter() - t0
    record["lda"] = lm_dryrun_lda(dev)
    counts = ops.launch_counts()
    record.update(kernel_launches=counts,
                  seconds=time.perf_counter() - t_phase)
    emit(record)
    check(not any(counts.values()),
          f"lm_dryrun: the dry-run launched LDA kernels {counts}")
    return counts


if __name__ == "__main__":
    sys.exit(main())
