"""The port's optimizers (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``): ports of ``tests/test_train.py``'s
optimizer tests, and the same numpy parameters and gradients through 3
updates of each optimizer in both packages (parameters and state within
1e-6 relative), on float32 and bf16 leaves, 1-D leaves, and a stacked
(4, 256, 256) leaf whose layers' gradients differ in scale by 100x. The
port holds that leaf as 4 per-layer parameters (``layers.{l}.w``), as an
``LM`` holds a layer stack; Adafactor's RMS-1 clip must be taken over the
whole stack, as the reference takes it over its stacked leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.specs import params_abstract
from repro.train import optimizer as R
from repro_torch.configs import get_config, list_archs
from repro_torch.models.convert import _tree_path, to_numpy, to_torch
from repro_torch.models.model import init_params
from repro_torch.train import optimizer as P
from repro_torch.train.train_step import init_train_state
from repro_torch.utils import tree_bytes, tree_param_count

KINDS = ["adamw", "adafactor"]
LAYERS, STEPS = 4, 3
RTOL = 1e-6  # relative to each leaf's largest magnitude, and elementwise
# The global norm is a float32 sum of squares over ~400k elements: the
# reference's (XLA's CPU reduction) is up to 6e-6 off the float64 value on
# these inputs, the port's (torch's cascade sum) within 1e-7. So the norm
# is held at 1e-5, and so is everything a clipped step scales by it.
NORM_RTOL = 1e-5
# A bf16 parameter is the float32 result rounded: where that result lies
# at a bf16 rounding boundary, a last-bit float32 difference rounds the two
# packages to neighbouring bf16 values, and later steps carry that gap
# along. So a bf16 leaf must be bit-equal but for at most this share of
# its elements, each within one bf16 step (2^-7 of the binade) of the
# leaf's largest magnitude.
BF16_NEIGHBOURS = 1e-3

# name -> (shape, dtype); ``stack`` leaves are the stacked (L, ...) leaf
# in the reference and L per-layer parameters in the port
LEAVES = {
    "a": ((256, 128), "float32"),  # factored
    "b": ((128, 256), "bfloat16"),  # factored, bf16
    "c": ((64, 32), "float32"),  # too small to factor
    "d": ((300,), "float32"),  # 1-D
    "e": ((200,), "bfloat16"),  # 1-D, bf16
}
STACK = {"w": (256, 256), "s": (256,)}  # factored per layer; (4, 256) not


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    flat = {k: rng.standard_normal(shape).astype(np.float32) * 0.1
            for k, (shape, _) in LEAVES.items()}
    stack = {k: rng.standard_normal((LAYERS,) + shape).astype(np.float32)
             * 0.1 for k, shape in STACK.items()}
    return flat, stack


def _np_grads(step):
    """Gaussian gradients; the stack's layers alternate scales 1 and 100,
    and swap them every step."""
    flat, stack = _np_params(100 + step)
    scale = np.array([100.0 ** ((l + step) % 2) for l in range(LAYERS)],
                     np.float32)
    stack = {k: v * scale.reshape((-1,) + (1,) * (v.ndim - 1))
             for k, v in stack.items()}
    return flat, stack


def _ref_tree(flat, stack):
    tree = {k: jnp.asarray(v).astype(LEAVES[k][1]) for k, v in flat.items()}
    tree["layers"] = {k: jnp.asarray(v) for k, v in stack.items()}
    return tree


def _port_tree(flat, stack, sep="."):
    """Flat dotted names; ``sep="_"`` breaks the stack into unrelated
    leaves (``layers_0_w``: each its own tree path)."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    out = {k: torch.from_numpy(v).to(dt[LEAVES[k][1]])
           for k, v in flat.items()}
    for k, v in stack.items():
        for l in range(LAYERS):
            out[f"layers{sep}{l}{sep}{k}"] = torch.from_numpy(v[l].copy())
    return out


def _ref_leaf(tree, name, dtype=np.float32):
    keys, index = _tree_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree if index is None else tree[index], dtype)


def _close_param(t, ref, name, rtol=RTOL):
    """A port parameter against the reference's leaf: float32 within
    ``rtol``; bf16 bit-equal but for rounding-boundary neighbours."""
    if t.dtype != torch.bfloat16:
        _close(t.numpy(), _ref_leaf(ref, name), name, rtol)
        return
    got = t.float().numpy()
    want = _ref_leaf(ref, name)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    apart = np.abs(got - want)
    assert apart.max() <= step, f"{name}: bf16 values {apart.max()} apart"
    assert (apart > 0).mean() <= BF16_NEIGHBOURS, \
        f"{name}: {(apart > 0).sum()} of {apart.size} bf16 values differ"


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _run_both(kind, sep=".", grad_clip=1e4):
    cfg_kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=grad_clip)
    r_init, r_update = R.make_optimizer(kind, R.OptConfig(**cfg_kw))
    p_init, p_update = P.make_optimizer(kind, P.OptConfig(**cfg_kw))
    ref = _ref_tree(*_np_params())
    port = _port_tree(*_np_params(), sep=sep)
    r_state, p_state = r_init(ref), p_init(port)
    r_gn, p_gn = [], []
    for step in range(STEPS):
        flat, stack = _np_grads(step)
        # bf16 leaves get bf16 gradients, as jax.grad gives them
        ref, r_state, rm = r_update(ref, _ref_tree(flat, stack), r_state)
        port, p_state, pm = p_update(port, _port_tree(flat, stack, sep),
                                     p_state)
        r_gn.append(float(rm["grad_norm"]))
        p_gn.append(float(pm["grad_norm"]))
    return ref, r_state, port, p_state, r_gn, p_gn


@pytest.mark.parametrize("clip,rtol", [(1e4, RTOL), (50.0, NORM_RTOL)],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("kind", KINDS)
def test_updates_match_reference(kind, clip, rtol):
    """3 updates; the gradient norm (~3,600) is below the clip in the
    first case (1e-6) and clipped to 50 in the second."""
    ref, r_state, port, p_state, r_gn, p_gn = _run_both(kind,
                                                        grad_clip=clip)
    np.testing.assert_allclose(p_gn, r_gn, rtol=NORM_RTOL)
    assert int(p_state.step) == int(r_state.step) == STEPS
    for name, t in port.items():
        _close_param(t, ref, name, rtol)
        assert t.dtype == (torch.bfloat16 if name in ("b", "e")
                           else torch.float32)
    if kind == "adamw":
        for name in port:
            _close(p_state.m[name].numpy(), _ref_leaf(r_state.m, name),
                   f"m {name}", rtol)
            _close(p_state.v[name].numpy(), _ref_leaf(r_state.v, name),
                   f"v {name}", rtol)
        return
    ref_stats = jax.tree_util.tree_flatten_with_path(
        r_state.stats, is_leaf=lambda x: isinstance(x, R.FactoredStat))[0]
    assert len(ref_stats) == len(p_state.stats)
    for path, r in ref_stats:
        key = ".".join(p.key for p in path)
        p = p_state.stats[key]
        assert isinstance(p, P.FactoredStat) == isinstance(r, R.FactoredStat)
        pairs = zip(p, r) if isinstance(r, R.FactoredStat) else [(p, r)]
        for a, b in pairs:
            assert tuple(a.shape) == tuple(b.shape), key
            _close(a.numpy(), b, f"stat {key}", rtol)


def test_adafactor_factors_the_stacked_shapes():
    state = P.adafactor_init(_port_tree(*_np_params()))
    assert isinstance(state.stats["a"], P.FactoredStat)
    assert not isinstance(state.stats["c"], P.FactoredStat)
    w = state.stats["layers.w"]
    assert tuple(w.row.shape) == (LAYERS, 256)
    assert tuple(w.col.shape) == (LAYERS, 256)
    # a per-layer (256,) leaf stacks to (4, 256): not factored (L < 128)
    assert tuple(state.stats["layers.s"].shape) == (LAYERS, 256)


def test_per_layer_rms_clip_misses_the_reference():
    """The mutation: the stack's layers as unrelated leaves, so Adafactor
    takes its RMS-1 clip per layer. The stacked leaf's layers then end
    elsewhere than the reference's (its layers' scales jump 100x, so the
    per-layer RMS differ), while every other leaf still agrees."""
    ref, _, port, _, _, _ = _run_both("adafactor", sep="_")
    for name in LEAVES:
        _close_param(port[name], ref, name)
    gaps = [np.abs(port[f"layers_{l}_w"].numpy()
                   - _ref_leaf(ref, f"layers.{l}.w")).max()
            for l in range(LAYERS)]
    assert max(gaps) > 1e-3 * np.abs(_ref_leaf(ref, "layers.0.w")).max()


def _quad_problem():
    """min ||Wx - y||^2 toy problem for optimizer sanity."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16, 8)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    y = x @ torch.from_numpy(w_true)
    params = {"w": torch.zeros((16, 8), requires_grad=True)}

    def loss(p):
        return torch.mean((x @ p["w"] - y) ** 2)

    return params, loss


@pytest.mark.parametrize("kind", KINDS)
def test_optimizer_minimizes(kind):
    params, loss = _quad_problem()
    cfg = P.OptConfig(learning_rate=0.05, weight_decay=0.0)
    init, update = P.make_optimizer(kind, cfg)
    state = init(params)
    l0 = float(loss(params).detach())
    for _ in range(200):
        (g,) = torch.autograd.grad(loss(params), [params["w"]])
        params, state, _ = update(params, {"w": g}, state)
    assert float(loss(params).detach()) < 0.05 * l0


def test_grad_clip():
    params = {"w": torch.zeros((4,))}
    cfg = P.OptConfig(learning_rate=1.0, grad_clip=1.0, weight_decay=0.0)
    _, update = P.make_optimizer("adamw", cfg)
    state = P.adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    _, _, metrics = update(params, huge, state)
    assert float(metrics["grad_norm"]) > 1e8  # reported pre-clip
    # the step is clipped: AdamW's first step moves each element by ~lr
    assert float(params["w"].abs().max()) <= 1.0 + 1e-6


def test_adafactor_state_smaller_than_adam():
    """The reason grok/arctic use it: factored stats are O(n+m)."""
    cfg = get_config("qwen3-8b-smoke")
    st = init_train_state(0, cfg, device="cpu")
    adam_bytes = tree_bytes(P.adamw_init(st.params))
    fact_bytes = tree_bytes(P.adafactor_init(st.params))
    assert fact_bytes < adam_bytes / 3
    # AdamW: float32 m and v for every parameter, plus the step
    assert adam_bytes == 8 * tree_param_count(st.params) + 4


@pytest.mark.parametrize("arch", list_archs(lm_only=True))
def test_every_config_factors_as_the_reference(arch):
    """Each full config's Adafactor statistics, built on a ``meta`` LM,
    have the reference's structure and shapes (a factored pair exactly
    where ``_factorable`` of the reference's stacked leaf holds)."""
    ref = jax.tree_util.tree_flatten_with_path(params_abstract(
        ref_config(arch)))[0]
    want = {}
    for path, leaf in ref:
        shape = tuple(leaf.shape)
        want[".".join(p.key for p in path)] = (
            (shape[:-1], shape[:-2] + shape[-1:])
            if R._factorable(shape) else shape)
    stats = P.adafactor_init(init_params(0, get_config(arch),
                                         device="meta")).stats
    got = {k: (tuple(s.row.shape), tuple(s.col.shape))
           if isinstance(s, P.FactoredStat) else tuple(s.shape)
           for k, s in stats.items()}
    assert got == want


def test_bf16_leaves_cross_as_bits():
    """A bf16 leaf saved by either package loads back as the same bits
    (``np.load`` gives a saved bfloat16 array as a 2-byte void)."""
    t = torch.randn(5).to(torch.bfloat16)
    arr = to_numpy(t)
    void = arr.view(np.dtype("V2"))
    assert torch.equal(to_torch(void), t)
    assert torch.equal(to_torch(arr), t)


def test_adamw_slices_a_leaf_without_changing_it(monkeypatch):
    """AdamW updates a large leaf in flat slices (bounding its float32
    temporaries): slices of 1,000 elements give the same bits as whole
    leaves."""
    flat, stack = _np_params()
    results = []
    for chunk in (P._CHUNK, 1000):
        monkeypatch.setattr(P, "_CHUNK", chunk)
        port = _port_tree(flat, stack)
        init, update = P.make_optimizer("adamw", P.OptConfig())
        state = init(port)
        for step in range(STEPS):
            port, state, _ = update(port, _port_tree(*_np_grads(step)),
                                    state)
        results.append((port, state))
    (a, sa), (b, sb) = results
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert torch.equal(sa.m[name], sb.m[name]), name
        assert torch.equal(sa.v[name], sb.v[name]), name
