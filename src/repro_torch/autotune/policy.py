"""Autopilot policies: windows of metrics in, typed decisions out
(``repro/autotune/policy.py``; the port keeps its own copy, so equal
windows give equal decisions).

Training side (``TrainAutopilot``): the paper's hybrid argument (§3.2)
says per-token sampling cost is the decomposition's row density — ``K``
dense, ``K_d`` doc-side, ``K_w`` word-side, ``min`` for the hybrid. The
static version of that argument picks a backend once at config time;
the autopilot re-evaluates it on the rebuild cadence against the row-nnz
stats ``TrainTelemetry`` measured from the LIVE counts, and also turns
the same degree stats into padded-row capacity targets (quantile +
slack, lane-rounded) instead of trusting a user's global ``max_kw``/
``max_kd`` guess.

Serving side (``ServeAutopilot``): derive the SLA knobs from the
observed arrival process — tick at a fraction of the median
inter-arrival time (ticking much faster burns CPU on empty admissions,
much slower adds avoidable queueing latency), allow bucket spill when
requests measurably wait at saturated buckets, and re-cut bucket widths
from the measured document-length distribution when the static grid
truncates or wastes.

Both policies are deliberately conservative: relative-change hysteresis
plus a dwell counter, so one noisy window never flips a knob and two
knobs never fight each other tick over tick. Every ``decide`` returns
only the decisions whose application would actually change something.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _lane_round(n: int, multiple: int = 8) -> int:
    n = max(1, int(n))
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# typed decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decision:
    """Base: every decision serializes as one ``kind="decision"`` JSONL
    record carrying its type, payload, and the measured reason."""

    reason: str

    def to_record(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        reason = d.pop("reason")
        return {"kind": "decision", "decision": type(self).__name__,
                "reason": reason, **d}


@dataclasses.dataclass(frozen=True)
class BackendSwitch(Decision):
    """Re-pick the registry backend from measured row sparsity. Applied
    by the session at a rebuild tick (``SingleBoxPlan.set_backend``:
    the new backend's tables are prepared again)."""

    backend: str = ""


@dataclasses.dataclass(frozen=True)
class RowRepad(Decision):
    """Set padded-row capacities to measured-degree targets (quantile +
    slack, lane-rounded, clamped to K) instead of a static global
    max-nnz. Applied through the plan's repad machinery."""

    max_kw: int = 0
    max_kd: int = 0


@dataclasses.dataclass(frozen=True)
class ServeRetune(Decision):
    """New serving SLA knobs; ``None`` fields keep the current value.
    Applied by the engine between admission ticks (bucket changes wait
    for every bucket to drain — the hot-reload slot-swap discipline)."""

    tick_period: Optional[float] = None
    max_slot_wait: Optional[int] = None
    buckets: Optional[Tuple[int, ...]] = None


# ---------------------------------------------------------------------------
# training policy
# ---------------------------------------------------------------------------

# per-token cost of each decomposition as a function of measured row
# density (PAPER.md §3.2): which nnz statistic prices one token draw
_DENSE = "dense"
_DOC_SIDE = "doc"
_WORD_SIDE = "word"
_HYBRID = "hybrid"

BACKEND_COST_CLASS: Dict[str, str] = {
    "zen": _DENSE,
    "zen_dense": _DENSE,
    "std": _DENSE,
    "zen_cdf": _DENSE,
    "zen_pallas": _DENSE,
    "zen_sparse": _DOC_SIDE,
    "sparselda": _WORD_SIDE,
    "zen_hybrid": _HYBRID,
    "lightlda": _HYBRID,  # cycle-MH proposals draw from both sides
}


def backend_cost(name: str, mean_kw: float, mean_kd: float,
                 num_topics: int) -> float:
    """Estimated per-token sampling cost (in topic-row entries touched)."""
    klass = BACKEND_COST_CLASS.get(name, _DENSE)
    if klass == _DENSE:
        return float(num_topics)
    if klass == _DOC_SIDE:
        return float(mean_kd)
    if klass == _WORD_SIDE:
        return float(mean_kw)
    return float(min(mean_kw, mean_kd))


class TrainAutopilot:
    """Backend re-pick + row-capacity targets from a telemetry window.

    Args:
        candidates: backend names the switch may choose among (the
            session restricts this to registered backends compatible
            with its plan).
        switch_ratio: only switch when the best candidate's estimated
            cost is below this fraction of the current backend's.
        dwell: decisions to sit out after a switch (hysteresis).
        pad_quantile: which measured row-nnz statistic sets the
            capacity target ("max" never truncates; "p99" trades a
            tail of truncated rows for smaller pads).
        pad_slack: extra topic lanes added above the target before
            lane rounding.
    """

    def __init__(self, candidates: Sequence[str],
                 switch_ratio: float = 0.8, dwell: int = 2,
                 pad_quantile: str = "max", pad_slack: int = 8):
        if not candidates:
            raise ValueError("TrainAutopilot needs at least one candidate")
        if pad_quantile not in ("max", "p99"):
            raise ValueError(f"pad_quantile must be 'max' or 'p99', "
                             f"got {pad_quantile!r}")
        self.candidates = tuple(candidates)
        self.switch_ratio = float(switch_ratio)
        self.dwell = int(dwell)
        self.pad_quantile = pad_quantile
        self.pad_slack = int(pad_slack)
        self._cooldown = 0

    def decide(self, window: Sequence[Dict[str, Any]], *,
               current_backend: str, current_pads: Tuple[int, int],
               num_topics: int,
               pads_tunable: bool = True) -> List[Decision]:
        """Decisions for one rebuild tick (possibly empty).

        ``window`` is ``TrainTelemetry.window()`` — recent ``train_iter``
        records; the LAST record's row stats are the current measured
        state (they come from the live counts, so no averaging is
        needed — each record is already exact at its iteration).
        """
        if self._cooldown > 0:
            self._cooldown -= 1
            return []
        recs = [r for r in window if r.get("kind") == "train_iter"]
        if not recs:
            return []
        last = recs[-1]
        word, doc = last.get("word_rows"), last.get("doc_rows")
        if not word or not doc:
            return []
        mean_kw, mean_kd = float(word["mean"]), float(doc["mean"])
        decisions: List[Decision] = []

        # (a) backend re-pick: cheapest decomposition at measured density
        cur_cost = backend_cost(current_backend, mean_kw, mean_kd,
                                num_topics)
        best = min(
            self.candidates,
            key=lambda n: backend_cost(n, mean_kw, mean_kd, num_topics),
        )
        best_cost = backend_cost(best, mean_kw, mean_kd, num_topics)
        if (best != current_backend
                and best_cost < self.switch_ratio * cur_cost):
            decisions.append(BackendSwitch(
                backend=best,
                reason=(f"measured K_w≈{mean_kw:.1f} K_d≈{mean_kd:.1f} "
                        f"K={num_topics}: {best} costs ~{best_cost:.1f}"
                        f"/token vs {current_backend} ~{cur_cost:.1f}"),
            ))
            self._cooldown = self.dwell

        # (b) row capacities from degree stats: quantile + slack,
        # lane-rounded, clamped to K. Skip entirely when the plan's pads
        # are already auto-resolved (pads_tunable=False).
        if pads_tunable:
            q = self.pad_quantile
            target_kw = min(
                _lane_round(int(word[q]) + self.pad_slack), num_topics)
            target_kd = min(
                _lane_round(int(doc[q]) + self.pad_slack), num_topics)
            if (target_kw, target_kd) != tuple(current_pads):
                decisions.append(RowRepad(
                    max_kw=target_kw, max_kd=target_kd,
                    reason=(f"row-nnz {q}: word={word[q]} doc={doc[q]} "
                            f"(+{self.pad_slack} slack, lane-rounded) vs "
                            f"pads {tuple(current_pads)}"),
                ))
        return decisions


# ---------------------------------------------------------------------------
# serving policy
# ---------------------------------------------------------------------------

class ServeAutopilot:
    """SLA knobs from the observed arrival process, one window at a time.

    Args:
        period_fraction: target ``tick_period`` as a fraction of the
            median inter-arrival time (0.5 = tick twice per arrival:
            admission adds at most ~half an inter-arrival of delay while
            batches still form).
        min_period / max_period: clamp on the derived tick period.
        hysteresis: minimum relative change before a new period applies.
        retune_buckets: whether bucket-width decisions are allowed
            (they wait for a full drain, so latency-sensitive callers
            may prefer them off).
    """

    def __init__(self, period_fraction: float = 0.5,
                 min_period: float = 5e-4, max_period: float = 0.1,
                 hysteresis: float = 0.25, retune_buckets: bool = True):
        self.period_fraction = float(period_fraction)
        self.min_period = float(min_period)
        self.max_period = float(max_period)
        self.hysteresis = float(hysteresis)
        self.retune_buckets = bool(retune_buckets)

    def decide(self, summary: Dict[str, Any], *, tick_period: float,
               max_slot_wait: int,
               buckets: Sequence[int]) -> Optional[ServeRetune]:
        """One closed ``serve_window`` summary in, at most one
        ``ServeRetune`` out (None when every knob is already right)."""
        if summary.get("kind") != "serve_window":
            return None
        new_period = self._derive_period(summary, tick_period)
        new_wait = self._derive_wait(summary, max_slot_wait)
        new_buckets = (self._derive_buckets(summary, buckets)
                       if self.retune_buckets else None)
        if new_period is None and new_wait is None and new_buckets is None:
            return None
        reasons = []
        inter_p50 = summary["interarrival_ms"]["p50"]
        if new_period is not None:
            reasons.append(f"interarrival p50={inter_p50:.2f}ms -> "
                           f"tick {new_period * 1e3:.2f}ms")
        if new_wait is not None:
            reasons.append(f"wait_ticks p90={summary['wait_ticks_p90']}"
                           f" -> max_slot_wait={new_wait}")
        if new_buckets is not None:
            reasons.append(f"doc_len p99={summary['doc_len']['p99']:.0f}"
                           f" -> buckets={list(new_buckets)}")
        return ServeRetune(
            tick_period=new_period, max_slot_wait=new_wait,
            buckets=new_buckets, reason="; ".join(reasons),
        )

    # -- knob derivations ----------------------------------------------------
    def _derive_period(self, summary: Dict[str, Any],
                       current: float) -> Optional[float]:
        inter = summary.get("interarrival_ms", {})
        p50_ms = inter.get("p50")
        if not p50_ms or inter.get("count", 0) < 4:
            return None  # not enough arrivals to estimate a process
        target = p50_ms * 1e-3 * self.period_fraction
        target = min(self.max_period, max(self.min_period, target))
        if current > 0 and abs(target - current) / current < self.hysteresis:
            return None
        return target

    def _derive_wait(self, summary: Dict[str, Any],
                     current: int) -> Optional[int]:
        # requests measurably queue at their preferred bucket: open the
        # spill valve at the observed p90 wait so only the stuck tail
        # spills into wider buckets
        p90 = float(summary.get("wait_ticks_p90") or 0.0)
        if p90 >= 2.0:
            target = max(2, int(p90))
            if target != current:
                return target
        return None

    def _derive_buckets(self, summary: Dict[str, Any],
                        current: Sequence[int]) -> Optional[Tuple[int, ...]]:
        dl = summary.get("doc_len", {})
        if dl.get("count", 0) < 8:
            return None
        p50, p99, mx = dl.get("p50"), dl.get("p99"), dl.get("max")
        if not mx:
            return None
        cur = tuple(sorted(int(b) for b in current))
        truncating = mx > cur[-1]
        wasteful = cur[0] >= 4 * max(1.0, p50)
        if not (truncating or wasteful):
            return None
        widths = sorted({
            _lane_round(p50), _lane_round(p99), _lane_round(mx),
        })
        proposal = tuple(widths)
        if proposal == cur:
            return None
        return proposal
