"""A committed cell at a size the CPU tests can hold: the same runner,
sampler, prior and traffic, with W, D, K, the doc length and the doc
rows cut."""
from portbench import registry

SIZES = {"num_words": 300, "num_docs": 200, "mean_doc_len": 40,
         "num_topics": 16}
MAX_KD = 8
CELLS = ("nytimes-dense-sweeps", "nytimes-cdf-sweeps")
SEED = 2**31 + 77  # wider than 32 signed bits, as benchmark seeds may be


def spec(name: str, **sizes):
    cell, config, traffic = registry.cell_spec(name)
    config = dict(config, **dict(SIZES, **sizes))
    if config["max_kd"]:
        config["max_kd"] = MAX_KD
    return cell, config, traffic


def run(name: str, seed: int = SEED, seconds: float = 0.2, fault=None,
        traced: int = 0, device="cpu", **sizes):
    """One run of the harness at a cut size (on the CPU unless ``device``
    says otherwise), with fault ``fault`` (a name of ``faults.FAULTS``)
    planted or none: (result, check lines)."""
    import time

    import torch

    from portbench import harness
    from portbench.tests import faults

    cell, config, traffic = spec(name, **sizes)
    device = torch.device(device)
    if fault is None:
        run = registry.runner(config["runner"]).Runner(
            config, traffic, cell, seed, device)
    else:
        run = faults.runner(fault, config, traffic, cell, seed, device)
    return harness.run_cell(registry.benchmark(), name, cell, run, seconds,
                            traced, time.perf_counter(), {})
