"""The yardstick's counts at the cells' shapes, and the per-layer readers
on a record of known numbers."""
import pytest

from portbench import registry, roofline

H100 = "NVIDIA H100 80GB HBM3"
# NYTimes at the paper's W and D, K = 1000, and one corpus's T
T, W, D, K = 99_510_105, 101_636, 299_752, 1000


def test_sweep_flops():
    assert roofline.sweep_flops(T, K) == 497_550_525_000  # 4.9755e11


def test_kernel_bytes():
    assert roofline.zen_train_fused_bytes(T, W, D, K) == 3_197_721_680
    assert roofline.topic_histogram_bytes(T, W, D, K) == 3_197_713_680


def test_least_seconds():
    assert roofline.least_seconds(
        H100, flops=roofline.sweep_flops(T, K)) == pytest.approx(
        7.42613e-3, rel=1e-5)
    # kernel 2 is bound by its work, kernel 5 by its bytes
    k2 = roofline.least_seconds(
        H100, flops=roofline.sweep_flops(T, K),
        nbytes=roofline.zen_train_fused_bytes(T, W, D, K))
    assert k2 == roofline.sweep_flops(T, K) / 67e12
    k5 = roofline.least_seconds(
        H100, nbytes=roofline.topic_histogram_bytes(T, W, D, K))
    assert k5 == pytest.approx(0.954541e-3, rel=1e-5)
    assert roofline.least_seconds("some other card", flops=1.0) is None


def record(ops, sweeps=10, window_s=2.0, busy_s=1.9, kind=H100):
    return {"shape": {"tokens": T, "words": W, "docs": D, "topics": K},
            "sweeps": sweeps, "window_s": window_s, "device_kind": kind,
            "device": {"busy_s": busy_s, "ops": ops,
                       "launches": sum(n for _, n in ops.values())}}


OPS = {
    "void (anonymous namespace)::zen_train_fused_kernel<4, true>(int "
    "const*)": [1.9, 10],
    "(anonymous namespace)::hist_sorted_kernel((anonymous namespace)::"
    "Walk, int, int)": [0.08, 20],
    "(anonymous namespace)::zero_cut_rows_kernel(int const*, int*, int, "
    "int, int)": [0.0001, 20],
    "void at::native::vectorized_elementwise_kernel<4>": [0.01, 200],
}


def read(name, rec):
    return registry.metric_reader(name)(rec)


def test_readers():
    rec = record(OPS)
    flops10 = roofline.sweep_flops(T, K) * 10
    assert read("step_mfu", rec) == pytest.approx(
        100 * flops10 / 67e12 / 2.0)
    assert read("zen_train_fused_roofline", rec) == pytest.approx(
        100 * flops10 / 67e12 / 1.9)
    k5 = roofline.topic_histogram_bytes(T, W, D, K) / 3.35e12
    assert read("topic_histogram_roofline", rec) == pytest.approx(
        100 * 10 * k5 / 0.0801)
    assert read("device_launches_per_step", rec) == 25.0
    assert read("device_idle_share", rec) == pytest.approx(5.0)


@pytest.mark.parametrize("name, kernel", [
    ("zen_train_fused_roofline", "zen_train_fused_kernel"),
    ("topic_histogram_roofline", "hist_sorted_kernel")])
def test_roofline_counts_sweeps_not_launches(name, kernel):
    """A kernel launched in two chunks a sweep, for the same device time,
    reads the same share as one launch a sweep."""
    once = record({f"{kernel}(int const*)": [1.9, 10]})
    twice = record({f"{kernel}(int const*)": [1.9, 20]})
    assert read(name, twice) == pytest.approx(read(name, once))


def test_readers_find_nothing():
    """A kernel off the path, or a card with no peaks listed, leaves its
    metric out: never a 0."""
    rec = record({"void at::native::cumsum": [1.0, 5]})
    assert read("zen_train_fused_roofline", rec) is None
    assert read("topic_histogram_roofline", rec) is None
    other = record(OPS, kind="some other card")
    for name in ("step_mfu", "zen_train_fused_roofline",
                 "topic_histogram_roofline"):
        assert read(name, other) is None
    assert read("device_idle_share", record({}, busy_s=0.0)) is None
    assert read("device_launches_per_step", record({})) is None


def test_kernel_names_match_whole_words():
    from portbench.trace import device_time

    rec = record({"zen_train_fused_kernel_v2(int)": [1.0, 1],
                  "my_hist_sorted_kernel(int)": [1.0, 1]})
    assert device_time(rec, ("zen_train_fused_kernel",)) == (0.0, 0)
    assert device_time(rec, ("hist_sorted_kernel",)) == (0.0, 0)
