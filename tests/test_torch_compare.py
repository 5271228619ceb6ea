"""``repro_torch.launch.compare`` — both modes through ``main(argv)``,
held against ``tests/test_compare_cli.py``'s cases and against the JAX
package's ``repro.launch.compare`` on the same inputs.

* ``--sessions`` (``--device cpu``): RunConfig JSONs dumped by the
  reference run through the port's ``TrainSession`` on one synthetic
  corpus; the table must parse and carry the quality columns when
  ``--quality-every`` is set. At the CLI's default corpus (400 x 800 x 64,
  K = 32) both packages' last per-token llh agree within ``LLH_BAND``.
* store diff: the same rows as the reference (cells, terms, ``x``
  ratios, which do not depend on the peaks); the seconds columns are the
  records' counts over one H100's peaks (``launch/roofline.py``).
"""
import dataclasses
import json
import re

import pytest

from repro.launch import compare as ref_compare
from repro.launch import roofline as ref_roofline
from repro.train.session import RunConfig as RefRunConfig
from repro_torch.launch import compare, roofline
from repro_torch.train.session import RunConfig

# --sessions at the default corpus, zen and zen_sparse, 10 iterations: the
# last per-token llh over seeds 0-3 spread 0.29% (port, zen), 0.11%
# (port, zen_sparse), 0.03% and 0.11% (reference); the largest gap
# between a port seed and a reference seed was 0.16%. The band is about
# three times the larger spread.
LLH_BAND = 0.01


def _run_main(capsys, argv):
    compare.main(argv)
    return capsys.readouterr().out


def _run_ref(monkeypatch, capsys, argv):
    monkeypatch.setattr("sys.argv", ["compare.py"] + argv)
    ref_compare.main()
    return capsys.readouterr().out


def _table_rows(out):
    """Parse `| iter | ... |` body rows into lists of cell strings."""
    rows = []
    for line in out.splitlines():
        if line.startswith("|") and not line.startswith("|---") \
                and "iter" not in line:
            rows.append([c.strip() for c in line.strip("|").split("|")])
    return rows


def _diff_rows(out):
    """The store diff's body rows, split on " | " (a cell holds "|")."""
    return [line[2:-2].split(" | ") for line in out.splitlines()
            if line.startswith("| ") and not line.startswith("| cell |")]


@pytest.fixture()
def session_configs(tmp_path):
    """Two RunConfig JSONs as the reference writes them."""
    paths = []
    for name, algo in [("base.json", "zen"), ("opt.json", "zen_sparse")]:
        cfg = RefRunConfig(algorithm=algo, num_iterations=2, eval_every=1)
        p = tmp_path / name
        p.write_text(cfg.to_json())
        paths.append(str(p))
    return paths


def test_sessions_mode_end_to_end(capsys, session_configs):
    base, opt = session_configs
    out = _run_main(capsys, [
        "--sessions", base, opt, "--topics", "4",
        "--synthetic-docs", "30", "--synthetic-words", "40",
        "--synthetic-len", "12", "--device", "cpu",
    ])
    assert "algorithm=zen " in out and "algorithm=zen_sparse" in out
    header = next(l for l in out.splitlines() if l.startswith("| iter |"))
    assert "baseline llh" in header and "optimized ppl" in header
    assert "umass" not in header  # no quality flag -> no quality columns
    rows = _table_rows(out)
    assert [r[0] for r in rows] == ["1", "2"]
    for r in rows:  # llh/ppl cells are floats for both runs
        assert all(re.fullmatch(r"-?\d+\.\d+", c) for c in r[1:]), r


def test_sessions_mode_quality_columns(capsys, session_configs):
    base, opt = session_configs
    out = _run_main(capsys, [
        "--sessions", base, opt, "--topics", "4", "--quality-every", "2",
        "--synthetic-docs", "30", "--synthetic-words", "40",
        "--synthetic-len", "12", "--device", "cpu",
    ])
    header = next(l for l in out.splitlines() if l.startswith("| iter |"))
    for label in ("umass", "npmi"):
        assert f"baseline {label}" in header and f"optimized {label}" in header
    rows = _table_rows(out)
    # iteration 1: eval only -> quality cells are "-"; iteration 2: filled
    assert rows[0][0] == "1" and "-" in rows[0]
    umass_col = 1 + 2 * 2  # after llh/ppl pairs: baseline umass
    assert re.fullmatch(r"-?\d+\.\d+", rows[1][umass_col])


def _store(flops, coll):
    return {
        "zenlda|4096x64|single": {
            "ok": True, "flops_per_device": flops,
            "bytes_per_device": 1e9, "collective_bytes_per_device": coll,
        },
    }


def test_store_diff_mode(capsys, tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_store(2e12, 0.0)))
    b.write_text(json.dumps(_store(1e12, 0.0)))
    out = _run_main(capsys, [str(a), str(b)])
    # compute moved 2x -> row printed; collective is 0 -> skipped
    row = next(l for l in out.splitlines() if "zenlda|4096x64|single" in l)
    assert "compute" in row and " 2.00 |" in row
    assert "collective" not in out


def test_store_diff_min_ratio_filters(capsys, tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_store(1.02e12, 0.0)))
    b.write_text(json.dumps(_store(1e12, 0.0)))
    out = _run_main(capsys, [str(a), str(b)])
    assert "compute" not in out  # 1.02x under the default 1.05 gate
    out = _run_main(capsys, [str(a), str(b), "--min-ratio", "1.01"])
    assert "compute" in out


def test_store_diff_skips_failed_cells(capsys, tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    bad = _store(2e12, 0.0)
    bad["zenlda|4096x64|single"]["ok"] = False
    a.write_text(json.dumps(bad))
    b.write_text(json.dumps(_store(1e12, 0.0)))
    out = _run_main(capsys, [str(a), str(b)])
    assert "zenlda|4096x64|single" not in [
        l.split("|")[1].strip() for l in out.splitlines()
        if l.startswith("| zen")
    ]


def test_reference_run_config_json_loads_unchanged(capsys, tmp_path):
    """A reference RunConfig with non-default fields: the port reads the
    same run, field for field, and ``--sessions`` runs it."""
    ref = RefRunConfig(algorithm="zen_cdf", max_kd=8, num_iterations=2,
                       eval_every=1, exclusion_start=1, init="sparse_word",
                       sparse_init_degree=0.3, rebuild_every=2,
                       kernels="off", quality_top_n=5)
    text = ref.to_json()
    port = RunConfig.from_json(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(text)
    b.write_text(RefRunConfig(algorithm="zen", num_iterations=2,
                              eval_every=1).to_json())
    out = _run_main(capsys, [
        "--sessions", str(a), str(b), "--topics", "4",
        "--synthetic-docs", "30", "--synthetic-words", "40",
        "--synthetic-len", "12", "--device", "cpu",
    ])
    assert "algorithm=zen_cdf plan=single-box" in out
    assert [r[0] for r in _table_rows(out)] == ["1", "2"]


def test_sessions_need_the_card_unless_asked(session_configs):
    """``--device`` defaults to cuda and does not fall back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare.main(["--sessions", *session_configs, "--topics", "4",
                      "--synthetic-docs", "30", "--synthetic-words", "40",
                      "--synthetic-len", "12"])


_RECORDS = {
    # a fitted single-box cell: the fit's counts replace the record's
    "zenlda-nytimes|train_lda|single": (
        dict(flops_per_device=4e14, bytes_per_device=2e11,
             collective_bytes_per_device=0.0),
        dict(flops_per_device=1e14, bytes_per_device=1.9e11,
             collective_bytes_per_device=0.0)),
    "zenlda-nytimes|train_lda|fit": (
        dict(flops_per_device=8e14, bytes_per_device=3e11,
             collective_bytes_per_device=0.0),
        dict(flops_per_device=2e14, bytes_per_device=2.99e11,
             collective_bytes_per_device=0.0)),
    "zenlda-webchunk|train_lda|16x16": (
        dict(flops_per_device=3e13, bytes_per_device=5e10,
             collective_bytes_per_device=4e9),
        dict(flops_per_device=3e13, bytes_per_device=2.5e10,
             collective_bytes_per_device=1e9)),
    "gemma3-4b|train_4k|16x16": (
        dict(flops_per_device=1e15, bytes_per_device=1e12,
             collective_bytes_per_device=2e10),
        dict(flops_per_device=1.01e15, bytes_per_device=1.5e12,
             collective_bytes_per_device=2e10)),
    "qwen3-8b|decode_32k|16x16": (
        dict(flops_per_device=1e12, bytes_per_device=1e10,
             collective_bytes_per_device=1e8),
        dict(flops_per_device=5e11, bytes_per_device=1e10,
             collective_bytes_per_device=1e8)),
}


def _stores(tmp_path):
    base, opt = {}, {}
    for key, (b, o) in _RECORDS.items():
        base[key] = dict(ok=True, **b)
        opt[key] = dict(ok=True, **o)
    base["grok-1-314b|train_4k|16x16"] = dict(ok=False)  # a failed cell
    opt["grok-1-314b|train_4k|16x16"] = dict(
        ok=True, flops_per_device=1.0, bytes_per_device=1.0,
        collective_bytes_per_device=1.0)
    a, b = tmp_path / "base.json", tmp_path / "opt.json"
    a.write_text(json.dumps(base))
    b.write_text(json.dumps(opt))
    return str(a), str(b), base, opt


def test_store_diff_rows_equal_reference(monkeypatch, capsys, tmp_path):
    a, b, base, opt = _stores(tmp_path)
    ours = _run_main(capsys, [a, b, "--min-ratio", "1.02"])
    theirs = _run_ref(monkeypatch, capsys, [a, b, "--min-ratio", "1.02"])
    rows, ref_rows = _diff_rows(ours), _diff_rows(theirs)
    assert len(rows) == 5  # the failed cell and terms under 1.02x left out
    # same cells, terms and ratios, in the same order
    assert [(r[0], r[1], r[4]) for r in rows] == \
        [(r[0], r[1], r[4]) for r in ref_rows]
    legend = [l for l in ours.splitlines() if l.startswith("# ")]
    assert legend == [l for l in theirs.splitlines() if l.startswith("# ")]
    peak = {"compute": roofline.PEAK_FLOPS, "memory": roofline.HBM_BW,
            "collective": roofline.NVLINK_BW}
    field = {"compute": "flops_per_device", "memory": "bytes_per_device",
             "collective": "collective_bytes_per_device"}
    for cell, term, sb, so, _ in rows:
        arch, shape, mesh = cell.split("|")
        src_b, src_o = base[cell], opt[cell]
        if mesh == "single":  # the fit's counts
            src_b = base[f"{arch}|{shape}|fit"]
            src_o = opt[f"{arch}|{shape}|fit"]
        assert sb == f"{src_b[field[term]] / peak[term]:.3e}", (cell, term)
        assert so == f"{src_o[field[term]] / peak[term]:.3e}", (cell, term)


def test_roofline_terms_keys_and_h100_constants():
    rec = dict(flops_per_device=989e12, bytes_per_device=6.7e12,
               collective_bytes_per_device=450e9)
    got, ref = roofline.roofline_terms(rec), ref_roofline.roofline_terms(rec)
    assert set(got) == set(ref)
    assert got["compute_s"] == pytest.approx(1.0)
    assert got["memory_s"] == pytest.approx(2.0)
    assert got["collective_s"] == pytest.approx(1.0)
    assert got["bottleneck"] == "memory"
    assert got["step_lower_bound_s"] == got["memory_s"]
    assert roofline.roofline_terms({})["step_lower_bound_s"] == 0.0


def test_sessions_default_corpus_within_band_of_reference(
        monkeypatch, capsys, tmp_path):
    """The CLI's default corpus and K, zen and zen_sparse for 10
    iterations from seed 0 in each package: the last eval's llh of each
    run within ``LLH_BAND`` of the reference's."""
    paths = []
    for name, algo in (("a.json", "zen"), ("b.json", "zen_sparse")):
        p = tmp_path / name
        p.write_text(RefRunConfig(algorithm=algo, num_iterations=10,
                                  eval_every=5).to_json())
        paths.append(str(p))
    runs = compare.main(["--sessions", *paths, "--device", "cpu"])
    capsys.readouterr()
    theirs = _run_ref(monkeypatch, capsys, ["--sessions", *paths])
    last = _table_rows(theirs)[-1]
    assert last[0] == "10"
    for path, col in zip(paths, (1, 2)):
        ours = runs[path][-1]["llh"]
        ref = float(last[col])
        assert runs[path][-1]["iteration"] == 10
        assert abs(ours / ref - 1) < LLH_BAND, (path, ours, ref)
