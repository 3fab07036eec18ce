"""Self-tuning serving (the port of the reference package's ``tuning/``).

Two pieces close the loop from observed traffic to the serving knobs:

- :mod:`.knobs` — the live, lock-guarded knob registry.  Serving-path
  knobs that used to be construction-time env reads (coalescer
  wait/slots, brownout ladder, relax iteration rung, hierarchical
  threshold, the delta inline shortcut) read through it; env values stay
  the defaults, and every read of an UNSET knob still consults the env so
  existing ``KT_*`` workflows are untouched.  Decision points take one
  immutable :class:`~.knobs.KnobSnapshot` per flush/evaluation, so a
  mid-flight update can never tear a megabatch flush or a brownout
  evaluation.
- :mod:`.controller` — the online feedback controller riding the
  sampler clock: hill-climbs one knob at a time over its lattice
  with hysteresis, a frozen-baseline comparison window, and never-worse
  guardrails (frozen while any class burn rate is warn+; a step whose
  window regressed throughput-at-equal-or-better-critical-p99 reverts).

Enable with ``KT_TUNE=1`` (default off — the registry alone changes no
behavior); ``KT_TUNE_INTERVAL_S`` paces decisions, ``KT_TUNE_FREEZE``
pins individual knobs.
"""

from .knobs import (  # noqa: F401
    KNOB_ENVS,
    KnobSnapshot,
    Knobs,
    global_knobs,
)
from .controller import (  # noqa: F401
    TuningController,
    tune_enabled,
    tune_interval_s,
)

__all__ = [
    "KNOB_ENVS",
    "KnobSnapshot",
    "Knobs",
    "TuningController",
    "global_knobs",
    "tune_enabled",
    "tune_interval_s",
]
