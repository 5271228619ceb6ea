"""Readings that set the limits of a cell's check, on the card at the
cell's own size, many seeds in one process:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--out control.jsonl]

For each seed it runs the cell as a benchmark run does (set-up, a short
window, release) and prints one JSON line: the program's numbers (the
lower readings), the control's (the reference computed in bfloat16 in
the program's place, judged by the reference), and the faults' read in
the reference's place (``unchanged``: the topics before the sweep;
``half``: every other sampled token keeps its old topic;
``altered_draw``: one token in 64 takes the next topic). Benchmark runs
never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

CONTROL_DTYPE = "bfloat16"


def readings(run, seed: int) -> dict:
    import torch

    from portbench.reference import compare
    from portbench.reference import hash as rhash

    cfg = run.config
    k = cfg["num_topics"]
    corpus = (run.word, run.doc, cfg["num_words"], cfg["num_docs"])
    sampler, max_kd = cfg["sampler"], cfg["max_kd"]
    low = getattr(torch, CONTROL_DTYPE)
    out = {"program": run.check(), "control": {}, "faults": {}}
    z0 = rhash.initial_topics(seed, torch.arange(run.tokens,
                                                 device=run.device), k)
    out["control"]["first_sweep"] = compare.control_mismatch(
        sampler, run.sample, corpus, z0, run.prior, seed, 0, max_kd, low)
    del z0
    prev = run.out["prev_topic"]
    it = run.sweeps - 1
    out["control"]["last_sweep"] = compare.control_mismatch(
        sampler, run.sample, corpus, prev, run.prior, seed, it, max_kd, low)
    from portbench.reference import lda

    n_wk, n_kd, n_k = lda.counts(run.word, run.doc, prev, cfg["num_words"],
                                 cfg["num_docs"], k)
    ref = compare.reference_draws(sampler, run.sample, corpus, prev, n_wk,
                                  n_kd, n_k, run.prior, seed, it, max_kd)
    before = prev[run.sample].long()
    half = torch.where(torch.arange(ref.shape[0], device=ref.device) % 2
                       == 0, before, ref)
    altered = ref.clone()
    altered[::64] = (altered[::64] + 1) % k
    for name, drawn in (("unchanged", before), ("half", half),
                        ("altered_draw", altered)):
        out["faults"][name] = compare.share(ref, drawn, run.sample)
    out["change_share"] = compare.share(ref, before, run.sample)
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench import registry

    cell, config, traffic = registry.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run = registry.runner(config["runner"]).Runner(
                config, traffic, cell, seed, dev)
            run.build({})
            run.warm_up({})
            win = run.window(args.seconds)
            run.release()
            line = {"workload": args.workload, "seed": seed,
                    "sweeps": run.sweeps, "tokens": run.tokens,
                    "tokens_per_s": win["end_to_end"].get(
                        "train_tokens_per_s"),
                    **readings(run, seed),
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
            del run
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
