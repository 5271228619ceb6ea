"""The LM sharding rules on DTensor (``repro_torch/sharding/partition.py``)
against the reference's (``repro/sharding/partition.py``), a sharded train
step on a (2, 2) gloo mesh against the unsharded one, and sharded
checkpoints."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.configs import get_config as r_get_config
from repro.configs import list_archs
from repro.launch.specs import params_abstract as r_params_abstract
from repro.sharding.partition import param_specs as r_param_specs
from repro.utils.compat import abstract_mesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (
    AbstractMesh,
    make_production_mesh,
    production_shape,
)
from repro_torch.models.convert import _tree_path
from repro_torch.sharding.partition import (
    NamedSharding,
    cache_sharding,
    param_specs,
    placements_of,
)

WORKER = os.path.join(os.path.dirname(__file__), "torch_sharding_worker.py")
# AdamW's first steps move an element by ~lr * sign(g) whatever |g|: an
# element whose gradient is at the noise of a summation order (the
# sharded step sums its batch and contraction shards in another order)
# may move differently, so the post-step parameters leave out (and count)
# the elements whose first gradient is below this fraction of the leaf's
# largest, as tests/test_torch_lm_train_step.py does.
SIGN_FLOOR = 1e-6


def _norm(spec):
    """A spec with one-axis tuples as the axis name (``PartitionSpec``
    stores ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_leaf(tree, name):
    keys, index = _tree_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree if index is None else tree[index])


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """Both packages' abstract parameters of ``arch`` (shared by the two
    meshes' cases)."""
    from repro_torch.launch.specs import params_abstract

    return (r_params_abstract(r_get_config(arch)),
            params_abstract(get_config(arch)))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs(lm_only=True))
def test_param_specs_equal_reference(arch, multi_pod):
    """Every parameter's spec is the reference's for its stacked leaf with
    the layer axis dropped, and divides its dim on the production mesh."""
    shape, axes = production_shape(multi_pod)
    r_mesh = abstract_mesh(shape, axes)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == dict(zip(axes, shape))
    r_params, lm = _abstract(arch)
    r_specs = r_param_specs(r_params, r_get_config(arch), r_mesh)
    specs = param_specs(lm, get_config(arch), mesh)
    assert set(specs) == {n for n, _ in lm.named_parameters()}
    for name, p in lm.named_parameters():
        keys, index = _tree_path(name)
        want = r_specs
        for k in keys:
            want = want[k]
        want = tuple(want)
        if index is not None and want:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert _norm(specs[name]) == _norm(want), (name, specs[name], want)
        for dim, entry in zip(p.shape, specs[name]):
            if entry is None:
                continue
            n = int(np.prod([mesh.shape[a] for a in
                             ((entry,) if isinstance(entry, str) else entry)]))
            assert dim % n == 0, (name, tuple(p.shape), specs[name])


def test_cache_sharding_rules():
    """The reference's cache cases: batch over data and the sequence over
    ``model``; at batch 1 the sequence takes every axis."""
    from repro_torch.models.model import init_cache

    mesh = AbstractMesh(("data", "model"), (2, 2))
    cfg = get_config("qwen3-8b")
    sh = cache_sharding(init_cache(cfg, 4, 64, device="meta"), mesh)
    assert _norm(sh.k.spec)[1:3] == ("data", "model"), sh.k.spec
    assert sh.length.spec == ()
    sh1 = cache_sharding(init_cache(cfg, 1, 64, device="meta"), mesh)
    assert sh1.k.spec[1] is None
    assert sh1.k.spec[2] == ("data", "model"), sh1.k.spec
    # both packages give every leaf of every family's cache the same spec
    from repro.models.model import init_cache as r_init_cache
    from repro.sharding import cache_sharding as r_cache_sharding

    r_mesh = abstract_mesh((2, 2), ("data", "model"))
    for arch in list_archs(lm_only=True):
        for b in (4, 1):
            rc = r_get_config(arch + "-smoke")
            s_enc = 64 if rc.family == "encdec" else 0
            want = jax.tree.leaves(
                r_cache_sharding(r_init_cache(rc, b, 64, s_enc=s_enc,
                                              abstract=True), r_mesh),
                is_leaf=lambda x: hasattr(x, "spec"))
            got = cache_sharding(init_cache(get_config(arch + "-smoke"), b,
                                            64, s_enc=s_enc, device="meta"),
                                 mesh)
            got = [s for s in _leaves(got)]
            assert len(got) == len(want), arch
            for g, w in zip(got, want):
                assert _norm(g.spec) == _norm(w.spec), (arch, b, g.spec,
                                                        w.spec)


def _leaves(tree):
    if isinstance(tree, NamedSharding):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


# one leaf of each family: (arch, parameter name) on a (2, 2, 2) mesh
SHARD_LEAVES = [
    ("qwen3-8b-smoke", "layers.0.attn.wq"),
    ("qwen3-8b-smoke", "embed"),
    ("minicpm3-4b-smoke", "layers.0.attn.wkv_b"),
    ("grok-1-314b-smoke", "layers.0.moe.w_gate"),
    ("arctic-480b-smoke", "layers.0.moe.w_down"),
    ("falcon-mamba-7b-smoke", "layers.0.m.in_proj"),
    ("zamba2-1.2b-smoke", "mamba.0.m.out_proj"),
    ("whisper-medium-smoke", "decoder.0.mlp.w_down"),
]


def test_local_shards_match_jax_device_indices():
    """Each device's shard (offset and shape) of one leaf of each family
    on a (pod, data, model) = (2, 2, 2) mesh: the DTensor placements'
    local box equals ``NamedSharding.devices_indices_map`` for the device
    at the same mesh position."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    mesh = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    cases = []
    for arch, name in SHARD_LEAVES:
        cfg = get_config(arch)
        from repro_torch.launch.specs import params_abstract

        lm = params_abstract(cfg)
        spec = param_specs(lm, cfg, mesh)[name]
        shape = tuple(dict(lm.named_parameters())[name].shape)
        assert any(e is not None for e in spec), (arch, name, spec)
        cases.append((arch, name, spec, shape))
    code = (
        "import json, numpy as np\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "from repro.launch.mesh import make_mesh\n"
        "mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))\n"
        f"cases = {[(list(map(_jsonable, s)), list(sh)) for _, _, s, sh in cases]!r}\n"
        "out = []\n"
        "for spec, shape in cases:\n"
        "    spec = [tuple(e) if isinstance(e, list) else e for e in spec]\n"
        "    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))\n"
        "    rows = []\n"
        "    for pos in np.ndindex(2, 2, 2):\n"
        "        idx = m[mesh.devices[pos]]\n"
        "        rows.append([[s.start or 0, (s.stop if s.stop is not None else n) - (s.start or 0)]\n"
        "                     for s, n in zip(idx, shape)])\n"
        "    out.append(rows)\n"
        "print('JSON' + json.dumps(out))\n")
    got = run_with_devices(code, n_devices=8)
    ref = __import__("json").loads(got.split("JSON", 1)[1])
    for (arch, name, spec, shape), rows in zip(cases, ref):
        pl = placements_of(spec, mesh)
        for pos, want in zip(np.ndindex(2, 2, 2), rows):
            lshape, off = _compute_local_shape_and_global_offset(
                shape, (2, 2, 2), list(pos), pl)
            assert [list(x) for x in zip(off, lshape)] == want, \
                (arch, name, pos)


def _jsonable(entry):
    return list(entry) if isinstance(entry, tuple) else entry


NARROW = dict(d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
              vocab_size=512, dtype="float32")
STEPS = 3


def _plain_runs(tree, cfg, rcfg, toks, labels):
    """The port's and the reference's unsharded steps from ``tree``, with
    ``cfg.optimizer``."""
    from repro.train.optimizer import OptConfig as ROpt
    from repro.train.train_step import init_train_state as r_init
    from repro.train.train_step import make_train_step as r_make
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import (
        TrainState,
        compute_grads,
        make_train_step,
    )

    lm = params_from_reference(tree, cfg, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, _, grads = compute_grads(lm, cfg, batch)
    opt_init, _ = make_optimizer(cfg.optimizer, OptConfig())
    st = TrainState(lm, opt_init(lm), torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg)
    losses = []
    for _ in range(STEPS):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))

    rst = r_init(jax.random.key(0), rcfg, ROpt())
    rst = rst._replace(params=jax.tree.map(jnp.asarray, tree))
    r_step = jax.jit(r_make(rcfg))
    r_losses = []
    for _ in range(STEPS):
        rst, rm = r_step(rst, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
        r_losses.append(float(rm["loss"]))
    return {
        "losses": losses, "r_losses": r_losses,
        "grads": {n: g.numpy() for n, g in grads.items()},
        "params": {n: p.detach().numpy()
                   for n, p in st.params.named_parameters()},
        "r_params": jax.tree.map(np.asarray, rst.params),
    }


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The narrow qwen3 of tests/test_sharding.py: the reference's and the
    port's unsharded steps here, the sharded steps in a (2, 2) gloo world
    with AdamW (its checkpoint saved there) and with Adafactor (under
    ``"adafactor"``), and the checkpoint restored in a (1, 1) world."""
    from repro.models import model as R
    from repro_torch.launch.mesh import spawn_local

    wd = str(tmp_path_factory.mktemp("sharded"))
    rcfg = dataclasses.replace(r_get_config("qwen3-8b-smoke"), **NARROW)
    cfg = dataclasses.replace(get_config("qwen3-8b-smoke"), **NARROW)
    assert cfg.optimizer == rcfg.optimizer == "adamw"
    tree = jax.tree.map(np.asarray, R.init_params(jax.random.key(0), rcfg))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (4, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (4, 16)).astype(np.int32)
    np.savez(os.path.join(wd, "inputs.npz"),
             tree=np.array(tree, dtype=object),
             cfg=np.array(cfg, dtype=object), tokens=toks, labels=labels,
             steps=STEPS)
    spawn_local(f"{WORKER}:sharded_steps", 4, (wd,))
    spawn_local(f"{WORKER}:restore_one", 1, (wd,))

    def load(name):
        return dict(np.load(os.path.join(wd, name), allow_pickle=True))

    ada = [dataclasses.replace(c, optimizer="adafactor")
           for c in (cfg, rcfg)]
    return {
        "sharded": load("sharded.npz"),
        "restored": load("restored11.npz"),
        "ckpt": os.path.join(wd, "ckpt", f"step_{STEPS:08d}"),
        **_plain_runs(tree, cfg, rcfg, toks, labels),
        "adafactor": {"sharded": load("sharded_adafactor.npz"),
                      **_plain_runs(tree, *ada, toks, labels)},
    }


def test_sharded_step_is_sharded(sharded_run):
    """The (2, 2) step ran on DTensor parameters placed by the rules."""
    pl = sharded_run["sharded"]["placements"].item()
    assert pl["layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["embed"] == "(Replicate(), Shard(dim=0))"


def _equals_unsharded(run):
    """Loss and first gradients within 1e-5 of the port's unsharded step;
    every parameter after the steps within 1e-5, but for the sign-noise
    elements (counted; fewer than 1 in 10,000)."""
    sh = run["sharded"]
    np.testing.assert_allclose(sh["losses"], run["losses"],
                               rtol=1e-5, atol=1e-5)
    off = total = 0
    for name, g in run["grads"].items():
        scale = np.abs(g).max() or 1.0
        np.testing.assert_allclose(sh["g/" + name] / scale, g / scale,
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        keep = np.abs(g) >= SIGN_FLOOR * scale
        a, b = sh["p/" + name], run["params"][name]
        np.testing.assert_allclose(a[keep], b[keep], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        off += int((~np.isclose(a, b, rtol=1e-5, atol=1e-5)).sum())
        total += g.size
    assert off < total / 1e4, (off, total)
    print(f"sharded vs unsharded: {off} sign-noise elements of {total} "
          f"beyond 1e-5")


def _equals_reference(run):
    """The sharded step within 1e-4 of the reference's unsharded step
    (the port's train step's bound), and the loss falls."""
    sh = run["sharded"]
    np.testing.assert_allclose(sh["losses"], run["r_losses"],
                               rtol=1e-4, atol=1e-4)
    assert sh["losses"][-1] < sh["losses"][0]
    for name, g in run["grads"].items():
        keep = np.abs(g) >= SIGN_FLOOR * (np.abs(g).max() or 1.0)
        np.testing.assert_allclose(
            sh["p/" + name][keep], _ref_leaf(run["r_params"], name)[keep],
            rtol=1e-4, atol=1e-4, err_msg=name)


def test_sharded_step_equals_unsharded(sharded_run):
    """AdamW: the (2, 2) step against the port's unsharded one."""
    _equals_unsharded(sharded_run)


def test_sharded_step_equals_reference(sharded_run):
    """AdamW: the (2, 2) step against the reference's unsharded one."""
    _equals_reference(sharded_run)


def test_sharded_adafactor_step_equals_unsharded(sharded_run):
    """Adafactor (its statistics stacked over the layers, factored ones
    sharded with the reduced dim dropped): the (2, 2) step against the
    port's unsharded one."""
    _equals_unsharded(sharded_run["adafactor"])


def test_sharded_adafactor_step_equals_reference(sharded_run):
    """Adafactor: the (2, 2) step against the reference's unsharded one."""
    _equals_reference(sharded_run["adafactor"])


def test_sharded_checkpoint_restores_elsewhere(sharded_run):
    """The checkpoint saved at (2, 2) holds the full leaves: restored on a
    (1, 1) mesh (as DTensors) and unsharded, every leaf is equal."""
    from repro_torch.train.checkpoint import restore_checkpoint

    sh, back = sharded_run["sharded"], sharded_run["restored"]
    assert set(back["kinds"]) == {"DTensor"}
    names = [k[2:] for k in sh if k.startswith("p/")]
    target = {n: None for n in names}
    plain, _ = restore_checkpoint(sharded_run["ckpt"], target, device="cpu")
    for n in names:
        np.testing.assert_array_equal(back["p/" + n], sh["p/" + n])
        np.testing.assert_array_equal(plain[n].numpy(), sh["p/" + n])
