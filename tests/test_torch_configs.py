"""The port's config registry (``repro_torch.configs``) against the JAX
package's (``repro.configs``): every config field for field, every smoke
variant, the derived properties, the shape cells and the registry order;
then ``tests/test_configs.py``'s config-only cases on the port.

``test_param_counts_match_names`` is not mirrored: it counts the
parameters the LM models' abstract shapes give (``launch/specs.py``
``params_abstract``), which the port has not yet (the LM models).

Last, the port's new entry points (the registry, ``launch.compare`` and
the three ``examples/*_torch.py``) import in a process where ``jax`` and
``repro`` cannot be imported.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from helpers import REPO

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro_torch import configs
from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.configs.base import ArchConfig, LDAArchConfig

REF_ARCHS = ref_configs.list_archs()
REF_LM = ref_configs.list_archs(lm_only=True)
ALL_NAMES = REF_ARCHS + [a + "-smoke" for a in REF_LM]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_config_equals_reference_field_for_field(name):
    port, ref = get_config(name), ref_configs.get_config(name)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for f in dataclasses.fields(ref):  # nested configs: same class names
        sub = getattr(ref, f.name)
        if dataclasses.is_dataclass(sub):
            assert type(getattr(port, f.name)).__name__ == \
                type(sub).__name__, f.name


@pytest.mark.parametrize("name", ALL_NAMES)
def test_derived_properties_equal_reference(name):
    port, ref = get_config(name), ref_configs.get_config(name)
    props = ("tokens_per_step",) if isinstance(ref, ref_base.LDAArchConfig) \
        else ("padded_vocab_size", "resolved_head_dim", "is_sub_quadratic")
    for p in props:
        assert getattr(port, p) == getattr(ref, p), p


def test_shapes_and_registry_order_equal_reference():
    assert list(SHAPES) == list(ref_configs.SHAPES)
    for k, v in SHAPES.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(
            ref_configs.SHAPES[k])
    assert list_archs() == REF_ARCHS
    assert list_archs(lm_only=True) == REF_LM
    for name in REF_ARCHS:
        assert shapes_for(get_config(name)) == ref_configs.shapes_for(
            ref_configs.get_config(name)), name


def test_default_fields_equal_reference():
    """The schema: every dataclass's fields, in order, with their
    defaults (a field the configs leave at its default is checked too)."""
    for cls in ("MLAConfig", "MoEConfig", "SSMConfig", "ArchConfig",
                "LDAArchConfig", "ShapeConfig"):
        ours = [(f.name, f.default) for f in
                dataclasses.fields(getattr(configs.base, cls))]
        theirs = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(ref_base, cls))]
        assert ours == theirs, cls


def test_configs_are_frozen():
    cfg = get_config("zenlda-nytimes")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.num_topics = 1


def test_lda_configs_are_the_papers():
    nyt = get_config("zenlda-nytimes")
    assert isinstance(nyt, LDAArchConfig)
    assert (nyt.num_words, nyt.num_topics, nyt.docs_per_step,
            nyt.avg_doc_len) == (101_636, 1000, 299_752, 332)
    assert nyt.tokens_per_step == 299_752 * 332
    web = get_config("zenlda-webchunk")
    assert (web.num_words, web.num_topics) == (302_098, 10_000)
    assert web.delta_dtype == web.kd_dtype == "int16"
    with pytest.raises(AssertionError):
        get_config("zenlda-nytimes-smoke")  # no smoke variant of LDA


# -- tests/test_configs.py's config-only cases, on the port ---------------

def test_ten_archs_plus_lda():
    archs = list_archs()
    assert len([a for a in archs if not a.startswith("zenlda")]) == 10
    assert "zenlda-nytimes" in archs and "zenlda-webchunk" in archs


def test_assigned_figures_exact():
    g = get_config("gemma3-4b")
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.d_ff, g.vocab_size) == (34, 2560, 8, 4, 10240, 262144)
    assert g.local_global_pattern == 5
    q = get_config("qwen3-8b")
    assert q.qk_norm and q.num_kv_heads == 8 and q.d_ff == 12288
    a = get_config("arctic-480b")
    assert a.moe.num_experts == 128 and a.moe.top_k == 2
    assert a.moe.dense_residual
    gk = get_config("grok-1-314b")
    assert gk.moe.num_experts == 8 and gk.d_ff == 32768
    f = get_config("falcon-mamba-7b")
    assert f.ssm.version == 1 and f.ssm.state_dim == 16 and f.d_ff == 0
    z = get_config("zamba2-1.2b")
    assert z.ssm.version == 2 and z.ssm.state_dim == 64
    v = get_config("qwen2-vl-2b")
    assert v.mrope and v.num_kv_heads == 2
    w = get_config("whisper-medium")
    assert w.encoder_decoder and w.norm_style == "layernorm"
    m = get_config("minicpm3-4b")
    assert m.mla is not None and m.num_layers == 62
    q15 = get_config("qwen1.5-4b")
    assert q15.qkv_bias and q15.num_kv_heads == 20


def test_shape_skip_rules():
    """long_500k only for sub-quadratic archs."""
    for arch in list_archs(lm_only=True):
        cfg = get_config(arch)
        runs_long = "long_500k" in shapes_for(cfg)
        assert runs_long == cfg.is_sub_quadratic, arch
    assert set(
        a for a in list_archs(lm_only=True)
        if "long_500k" in shapes_for(get_config(a))
    ) == {"gemma3-4b", "zamba2-1.2b", "falcon-mamba-7b"}


def test_cell_count():
    """40 cells = 10 archs x 4 shapes; runnable cells = 33 + 2 LDA."""
    total = 0
    runnable = 0
    for arch in list_archs(lm_only=True):
        cfg = get_config(arch)
        total += 4
        runnable += len(shapes_for(cfg))
    assert total == 40
    assert runnable == 33
    assert sum(len(shapes_for(get_config(a))) for a in list_archs()) == 35


def test_smoke_configs_are_small():
    for arch in list_archs(lm_only=True):
        cfg = get_config(arch + "-smoke")
        assert isinstance(cfg, ArchConfig)
        assert cfg.d_model <= 128 and cfg.vocab_size <= 512
        assert cfg.family == get_config(arch).family


_NO_JAX = r"""
import importlib.abc, importlib.util, json, os, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError(f'{{name}} is not importable here')
        return None

sys.meta_path.insert(0, _Refuse())
for name in ('jax', 'repro'):
    try:
        __import__(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f'{{name}} imported')
import repro_torch.configs
from repro_torch.configs import get_config
from repro_torch.launch import compare
for name in ('quickstart_torch', 'distributed_lda_torch',
             'train_nytimes_lda_torch'):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join({examples!r}, name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
# the store diff resolves its legend from the port alone
d = {tmp!r}
rec = {{'zenlda-nytimes|train_lda|single': {{
    'ok': True, 'flops_per_device': 2e12, 'bytes_per_device': 1e9,
    'collective_bytes_per_device': 0.0}}}}
for n, f in (('a', 2e12), ('b', 1e12)):
    rec['zenlda-nytimes|train_lda|single']['flops_per_device'] = f
    json.dump(rec, open(os.path.join(d, n + '.json'), 'w'))
compare.main([os.path.join(d, 'a.json'), os.path.join(d, 'b.json')])
assert get_config('zenlda-nytimes').num_topics == 1000
loaded = sorted(k for k in sys.modules
                if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not loaded, loaded
print('NO_JAX_OK')
"""


def test_port_entry_points_import_without_jax(tmp_path):
    code = _NO_JAX.format(examples=os.path.join(REPO, "examples"),
                          tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
    assert "# zenlda-nytimes: sampler backend 'zen_cdf'" in res.stdout
    assert "| zenlda-nytimes|train_lda|single | compute |" in res.stdout
