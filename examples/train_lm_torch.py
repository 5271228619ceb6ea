"""Train an LM from the zoo on synthetic data with the fault-tolerant loop,
on the PyTorch port (``examples/train_lm.py``), on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-8b-smoke \
        [--steps 60] [--ckpt /tmp/lm_ckpt] [--device cpu]

Any of the 10 LM architectures works with ``--arch <id>-smoke`` (reduced
widths). The tokens are the reference example's (the same numpy
generator and seed); the weights are drawn from seed 0 by the port, so
they differ from the reference's. A resumed run restores the parameters
and the step, not the optimizer state, as the reference's does.
"""
import argparse
import logging

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.convert import load_into, params_to_reference
from repro_torch.models.layers import dtype_of
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def make_batch(cfg, rng, batch: int, seq: int, device) -> dict:
    """synthetic LM data: structured Markov-ish tokens (learnable), drawn
    from ``rng`` as the reference example draws them."""
    base = rng.integers(0, cfg.vocab_size // 4, (batch, seq))
    tokens = (base + np.arange(seq)[None, :] % 7).astype(np.int32)
    b = {
        "tokens": torch.from_numpy(tokens % cfg.vocab_size).to(device),
        "labels": torch.from_numpy(np.roll(tokens, -1, 1) % cfg.vocab_size)
        .to(device),
    }
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, seq, cfg.d_model))).to(
            device=device, dtype=dtype_of(cfg))
    return b


def restore(state, tree):
    """The reference example's restore: parameters and step."""
    load_into(state.params, tree["params"])
    return state._replace(step=torch.as_tensor(
        np.asarray(tree["step"]), device=state.step.device))


def main(argv=None):
    """Returns ``(the final TrainState, the loss of every step run)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b-smoke")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    opt = OptConfig(learning_rate=1e-3)
    state = init_train_state(0, cfg, opt, device=args.device)
    step = make_train_step(cfg, opt)
    device = state.step.device
    rng = np.random.default_rng(0)
    losses = []

    def loop_step(state):
        state, metrics = step(state, make_batch(cfg, rng, args.batch,
                                                args.seq, device))
        losses.append(float(metrics["loss"]))
        return state, {"loss": losses[-1]}

    loop = TrainLoop(
        loop_step,
        LoopConfig(num_steps=args.steps, checkpoint_every=25,
                   checkpoint_dir=args.ckpt, log_every=10),
        checkpoint_tree_fn=lambda s: {"params": params_to_reference(s.params),
                                      "step": s.step},
        restore_fn=restore if args.ckpt else None,
    )
    logging.basicConfig(level=logging.INFO)
    final = loop.run(state)
    print(f"finished at step {int(final.step)}")
    return final, losses


if __name__ == "__main__":
    main()
