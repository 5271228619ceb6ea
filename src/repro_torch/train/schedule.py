"""Training schedules: periodic/one-shot structural events as data (§6).

A framework-free copy of ``repro/train/schedule.py``; the port keeps its
own, as it imports nothing of the JAX package.

The paper's training workflow is one sampling loop plus periodic
*structural* events — model synchronization, exact count rebuild,
"converged" token exclusion enablement (§5.1), duplicate-topic merging
(§4.3), capacity re-resolution for the padded-sparse tables. A
``Schedule`` makes those events first-class: each is a ``ScheduledAction``
with a name, a cadence (``every``/``start``) or a one-shot trigger
(``at``), and a callback ``(ctx, state) -> state``. ``TrainSession`` builds
its schedule from ``RunConfig`` and fires it after every iteration.

Determinism contract (property-tested in the reference's
``tests/test_session.py``):

* an action fires at iteration ``n`` iff ``due(n)`` — a pure function of
  the action's own fields, never of other actions;
* within one iteration, actions fire in *registration order* (structural
  events are registered before observational ones, so an eval always sees
  post-rebuild/post-merge counts);
* every firing is appended to ``ctx.fired`` as ``(iteration, name)``, so a
  run's event history is replayable and assertable.

Iterations are counted the way the training loops do: ``state.iteration`` *after*
a step, i.e. the first step produces iteration 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ScheduledAction:
    """One named training event.

    Exactly one trigger form is used:
      * periodic — ``every > 0``: fires when ``iteration % every == 0`` and
        ``iteration >= start``;
      * one-shot — ``at is not None``: fires when ``iteration == at``.

    ``fn(ctx, state)`` returns the (possibly replaced) state; returning
    ``None`` keeps the incoming state (side-effect-only actions).
    """

    name: str
    fn: Callable[["ActionContext", Any], Any]
    every: int = 0
    start: int = 1
    at: Optional[int] = None

    def __post_init__(self) -> None:
        if self.at is not None and self.every:
            raise ValueError(
                f"action {self.name!r}: 'at' and 'every' are exclusive"
            )

    def due(self, iteration: int) -> bool:
        if self.at is not None:
            return iteration == self.at
        return (
            self.every > 0
            and iteration >= self.start
            and iteration % self.every == 0
        )


@dataclasses.dataclass
class ActionContext:
    """Mutable per-run context threaded through every action firing.

    ``metrics`` is reset by the session each iteration; actions contribute
    keys (the eval action writes ``llh``/``perplexity``/``change_rate``).
    ``stop`` requests loop termination after the current iteration (e.g.
    target perplexity reached). ``fired`` is the append-only event log.
    """

    session: Any = None
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stop: bool = False
    fired: List[Tuple[int, str]] = dataclasses.field(default_factory=list)


class Schedule:
    """An ordered, name-unique collection of ``ScheduledAction``s."""

    def __init__(self, actions: Tuple[ScheduledAction, ...] = ()):
        self._actions: List[ScheduledAction] = []
        for a in actions:
            self.add(a)

    def add(self, action: ScheduledAction) -> "Schedule":
        if any(a.name == action.name for a in self._actions):
            raise ValueError(f"duplicate schedule action {action.name!r}")
        self._actions.append(action)
        return self

    def replace(self, action: ScheduledAction) -> "Schedule":
        """Swap the same-named action in place, preserving its position
        (and therefore its firing order). This is how a cadence changes
        mid-run (the reference's autopilot actuates through it). Raises
        ``KeyError`` when no action with that name is registered."""
        for i, a in enumerate(self._actions):
            if a.name == action.name:
                self._actions[i] = action
                return self
        raise KeyError(f"no schedule action named {action.name!r}")

    def remove(self, name: str) -> "Schedule":
        """Drop a registered action by name (``KeyError`` if absent)."""
        for i, a in enumerate(self._actions):
            if a.name == name:
                del self._actions[i]
                return self
        raise KeyError(f"no schedule action named {name!r}")

    @property
    def actions(self) -> Tuple[ScheduledAction, ...]:
        return tuple(self._actions)

    def names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self._actions)

    def due(self, iteration: int) -> Tuple[str, ...]:
        """Names of the actions that fire at ``iteration``, in order."""
        return tuple(a.name for a in self._actions if a.due(iteration))

    def fire(self, ctx: ActionContext, state: Any, iteration: int) -> Any:
        """Run every due action in registration order; returns the state."""
        for action in self._actions:
            if not action.due(iteration):
                continue
            out = action.fn(ctx, state)
            if out is not None:
                state = out
            ctx.fired.append((iteration, action.name))
        return state
