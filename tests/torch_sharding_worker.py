"""Rank code of ``tests/test_torch_sharding.py``'s gloo worlds (started by
``repro_torch.launch.mesh.spawn_local``): the narrow qwen3's train steps
on DTensor parameters over a (2, 2) mesh, with AdamW (its checkpoint
saved there) and with Adafactor, and that checkpoint restored on a
(1, 1) mesh."""
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _setup(workdir):
    from repro_torch.models.convert import params_from_reference

    data = np.load(os.path.join(workdir, "inputs.npz"), allow_pickle=True)
    tree = data["tree"].item()
    cfg = data["cfg"].item()
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    lm = params_from_reference(tree, cfg, device="cpu").requires_grad_(True)
    return cfg, lm, batch, int(data["steps"])


def sharded_steps(workdir):
    """Train on a (2, 2) mesh with each optimizer; rank 0 writes the losses
    and the gathered parameters (``sharded.npz`` for AdamW,
    ``sharded_adafactor.npz``); every rank saves AdamW's sharded state."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    _steps(workdir, mesh, "adamw", "sharded.npz", save=True)
    _steps(workdir, mesh, "adafactor", "sharded_adafactor.npz", save=False)


def _steps(workdir, mesh, optimizer, out, save):
    import dataclasses

    from repro_torch.sharding.partition import batch_sharding, distribute
    from repro_torch.train.checkpoint import (
        full_state,
        save_checkpoint,
        shard_state,
    )
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import (
        TrainState,
        compute_grads,
        make_train_step,
    )

    cfg, lm, batch, steps = _setup(workdir)
    cfg = dataclasses.replace(cfg, optimizer=optimizer)
    opt_init, _ = make_optimizer(optimizer, OptConfig())
    state = TrainState(params=lm, opt_state=opt_init(lm),
                       step=torch.zeros((), dtype=torch.int32))
    state = shard_state(state, cfg, mesh)
    sh = batch_sharding(batch, mesh)
    batch = {k: distribute(v, sh[k]) for k, v in batch.items()}
    _, _, grads = compute_grads(state.params, cfg, batch)
    grads = {n: g.full_tensor().numpy() for n, g in grads.items()}
    step = make_train_step(cfg)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    placements = {n: str(p.placements)
                  for n, p in state.params.named_parameters()}
    if save:
        save_checkpoint(os.path.join(workdir, "ckpt"), steps,
                        dict(state.params.named_parameters()))
    full = full_state(state)
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, out),
                 losses=np.array(losses),
                 placements=np.array(placements, dtype=object),
                 **{"g/" + n: g for n, g in grads.items()},
                 **{"p/" + n: p.detach().numpy()
                    for n, p in full.params.named_parameters()})


def restore_one(workdir):
    """Restore the (2, 2) checkpoint on a (1, 1) mesh and write it back
    gathered."""
    from repro_torch.sharding.partition import param_shardings
    from repro_torch.train.checkpoint import restore_checkpoint

    cfg, lm, _, steps = _setup(workdir)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    target = dict(lm.named_parameters())
    sh = param_shardings(lm, cfg, mesh)
    tree, _ = restore_checkpoint(
        os.path.join(workdir, "ckpt", f"step_{steps:08d}"), target,
        device="cpu", shardings={n: sh[n] for n in target})
    np.savez(os.path.join(workdir, "restored11.npz"),
             kinds=np.array([type(v).__name__ for v in tree.values()]),
             **{"p/" + n: v.full_tensor().detach().numpy()
                for n, v in tree.items()})
