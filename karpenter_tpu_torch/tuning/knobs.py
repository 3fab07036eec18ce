"""Live serving-knob registry: the port of the reference package's
``tuning/knobs.py``.

The serving stack's tunable knobs — coalescer wait/slots, the brownout
ladder's threshold and slot cap, the relax iteration rung, the
hierarchical routing threshold, the delta inline shortcut — used to be
read from the environment at scattered construction sites and call
sites.  This module is now the single front door:

- Each knob is a typed :class:`KnobSpec` with a **bounded lattice** of
  admissible values.  The lattice is what the feedback controller
  hill-climbs over; arbitrary values cannot be injected past it
  (``set()`` validates), so a runaway controller is bounded by
  construction.
- The **env value stays the default**: reading an UNSET knob consults
  ``os.environ`` at call time, exactly like the old scattered reads, so
  every existing ``KT_*`` workflow (tests monkeypatching
  ``KT_HIER_THRESHOLD`` included) behaves byte-identically until
  something explicitly ``set()``s the knob.  ktlint KT024 pins that
  call-time knob env reads happen HERE and nowhere else on the serving
  path.
- Decision points take one immutable :class:`KnobSnapshot` per
  flush/evaluation (``snapshot()`` reads every knob under ONE lock
  acquisition; ``update()`` writes multiple knobs under the same lock),
  so a tuner step racing a megabatch flush or a brownout evaluation is
  observed whole — old values or new values, never a mix.

``KT_TUNE_FREEZE`` (comma-separated knob names) pins knobs against the
controller without disabling the registry.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Optional, Tuple

#: relax iteration-count lattice — MUST mirror solver/relax.py
#: RELAX_ITER_RUNGS (the iteration rung ladder; keeping the lattice on the
#: rungs means tuning can never ask for a budget between rungs).
#: relax.py is not imported here: it pulls torch, and the registry stays
#: importable on its own.  tests/test_torch_tuning.py pins the mirror.
RELAX_ITER_LATTICE = (32, 64, 128, 256)


def _cast_bool(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "", "false", "off", "no")


@dataclass(frozen=True)
class KnobSpec:
    """One tunable knob: its identity, env default, and bounded lattice."""

    name: str
    env: str
    cast: type
    default: object
    lattice: Tuple
    doc: str

    def from_env(self) -> object:
        """The knob's *default* value: the env override when set (any
        value — an operator's explicit ``KT_MAX_SLOTS=24`` is honored
        even off-lattice; only the CONTROLLER is lattice-bound), else
        the built-in default."""
        raw = os.environ.get(self.env)
        if raw is None:
            return self.default
        try:
            if self.cast is bool:
                return _cast_bool(raw)
            return self.cast(raw)
        except (TypeError, ValueError):
            return self.default


#: the registry's knob population — name -> spec.  Lattices bracket the
#: built-in defaults; docs/TUNING.md renders this table.
SPECS: Tuple[KnobSpec, ...] = (
    KnobSpec(
        "max_wait_ms", env="KT_MAX_WAIT_MS", cast=float, default=0.0,
        lattice=(0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0),
        doc="Max hold before a partially-filled megabatch flushes (ms); "
            "0 flushes the moment the inbound queue idles."),
    KnobSpec(
        "max_slots", env="KT_MAX_SLOTS", cast=int, default=8,
        lattice=(1, 2, 4, 8, 16, 32),
        doc="Megabatch request-slot cap per coalescer flush; 1 disables "
            "cross-request batching.  The pipeline still floors/caps "
            "this against the mesh at apply time."),
    KnobSpec(
        "inline_delta", env="KT_DELTA_INLINE", cast=bool, default=True,
        lattice=(False, True),
        doc="Whether an idle pipeline serves session deltas inline on "
            "the RPC thread (the sub-ms shortcut) instead of via the "
            "queue."),
    KnobSpec(
        "brownout_ms", env="KT_BROWNOUT_MS", cast=float, default=2000.0,
        lattice=(500.0, 1000.0, 2000.0, 4000.0, 8000.0),
        doc="Brownout rung-1 queue-delay threshold (ms); rung n engages "
            "at 2^(n-1) times it; 0 disables the ladder."),
    KnobSpec(
        "brownout_slot_cap", env="KT_BROWNOUT_SLOT_CAP", cast=int,
        default=2, lattice=(1, 2, 4, 8),
        doc="Megabatch slot cap applied at brownout rung 2+."),
    KnobSpec(
        # ktlint: allow[KT014] knob NAME, not a compile-key tail — the
        # lattice IS the rung ladder precisely so no new key is minted
        "relax_iters", env="KT_RELAX_ITERS", cast=int, default=64,
        lattice=RELAX_ITER_LATTICE,
        doc="Relax-rung iteration budget; lattice = the "
            "compile-signature rungs (solver/relax.py RELAX_ITER_RUNGS),"
            " so tuning never mints a new compile signature."),
    KnobSpec(
        "hier_threshold", env="KT_HIER_THRESHOLD", cast=int,
        default=100_000,
        lattice=(25_000, 50_000, 100_000, 200_000, 400_000),
        doc="Pod count at/above which solves route hierarchically; 0 "
            "disables the hierarchical path."),
)

_SPEC_BY_NAME: Dict[str, KnobSpec] = {s.name: s for s in SPECS}

#: every env the registry fronts — the KT024 rule's call-time-read
#: denylist for serving-path files outside this module
KNOB_ENVS = frozenset(s.env for s in SPECS)


class KnobSnapshot:
    """One immutable, internally-consistent view of every knob.

    Built under the registry lock in a single acquisition; values are
    exposed as attributes (``snap.max_slots``) and via :meth:`get`.
    ``overridden`` says which knobs carry an explicit ``set()`` (vs the
    env/built-in default) — apply sites use it to leave construction-time
    behavior byte-identical until the controller actually moves a knob.
    """

    __slots__ = ("version", "values", "overridden")

    def __init__(self, version: int, values: Dict[str, object],
                 overridden: frozenset) -> None:
        object.__setattr__(self, "version", version)
        object.__setattr__(self, "values", MappingProxyType(dict(values)))
        object.__setattr__(self, "overridden", overridden)

    def __setattr__(self, name, value):  # immutability by construction
        raise AttributeError("KnobSnapshot is immutable")

    def __getattr__(self, name):
        try:
            return self.values[name]
        except KeyError:
            raise AttributeError(name) from None

    def get(self, name: str, default=None):
        return self.values.get(name, default)

    def is_overridden(self, name: str) -> bool:
        return name in self.overridden


class Knobs:
    """Lock-guarded live registry over :data:`SPECS`.

    Thread contract: any thread may ``get``/``snapshot``; the controller
    (or an operator hook) calls ``set``/``update``/``reset``.  Every
    read of the full state is one lock acquisition — the atomicity the
    concurrency tests (tests/test_tuning.py, KT_SANITIZE) pin.
    """

    def __init__(self, frozen: Optional[frozenset] = None) -> None:
        self._lock = threading.Lock()
        self._overrides: Dict[str, object] = {}
        self._version = 0
        if frozen is None:
            raw = os.environ.get("KT_TUNE_FREEZE", "")
            frozen = frozenset(
                p.strip() for p in raw.split(",") if p.strip())
        self._frozen = set(frozen)

    # ---- reads ----------------------------------------------------------
    def get(self, name: str):
        spec = _SPEC_BY_NAME[name]
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        return spec.from_env()

    def snapshot(self) -> KnobSnapshot:
        """Every knob in one lock acquisition — the per-flush/decision
        unit of atomicity."""
        with self._lock:
            version = self._version
            overrides = dict(self._overrides)
        values = {
            s.name: overrides.get(s.name, s.from_env()) for s in SPECS}
        return KnobSnapshot(version, values, frozenset(overrides))

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def frozen(self, name: str) -> bool:
        with self._lock:
            return name in self._frozen

    def lattice(self, name: str) -> Tuple:
        return _SPEC_BY_NAME[name].lattice

    # ---- writes ---------------------------------------------------------
    def set(self, name: str, value) -> bool:
        """Set one knob to a lattice value.  Returns False (and changes
        nothing) for a frozen knob or an off-lattice value — the bound
        that keeps any controller, however buggy, inside the lattice."""
        return self.update(**{name: value})

    def update(self, **values) -> bool:
        """Atomic multi-knob set: ALL values land under one lock hold
        (a concurrent ``snapshot()`` sees every one or none), or none do
        (any frozen knob / off-lattice value rejects the whole batch)."""
        staged = {}
        for name, value in values.items():
            spec = _SPEC_BY_NAME.get(name)
            if spec is None:
                return False
            try:
                value = spec.cast(value)
            except (TypeError, ValueError):
                return False
            if value not in spec.lattice:
                return False
            staged[name] = value
        with self._lock:
            if any(name in self._frozen for name in staged):
                return False
            self._overrides.update(staged)
            self._version += 1
        return True

    def reset(self, name: Optional[str] = None) -> None:
        """Drop override(s) back to the env/built-in default."""
        with self._lock:
            if name is None:
                self._overrides.clear()
            else:
                self._overrides.pop(name, None)
            self._version += 1

    def freeze(self, name: str) -> None:
        with self._lock:
            self._frozen.add(name)

    def thaw(self, name: str) -> None:
        with self._lock:
            self._frozen.discard(name)

    # ---- lattice stepping (the controller's move vocabulary) ------------
    def step(self, name: str, direction: int):
        """The lattice neighbor of the knob's CURRENT value in
        ``direction`` (+1 up / -1 down), or None at the lattice edge.
        An off-lattice current value (operator env override) steps onto
        the nearest admissible rung in that direction."""
        spec = _SPEC_BY_NAME[name]
        cur = self.get(name)
        lat = spec.lattice
        if spec.cast is bool:
            flipped = not bool(cur)
            return None if flipped == bool(cur) else flipped
        i = bisect_left(lat, cur)
        if i < len(lat) and lat[i] == cur:
            j = i + (1 if direction > 0 else -1)
        else:
            # off-lattice: bisect_left already points at the first rung
            # above cur, which IS the up-neighbor; down is one before it
            j = i if direction > 0 else i - 1
        if j < 0 or j >= len(lat):
            return None
        return lat[j]

    # ---- introspection (/tunez, docs) -----------------------------------
    def describe(self) -> dict:
        """Per-knob document for /tunez: current value, default source,
        lattice, freeze/override state."""
        snap = self.snapshot()
        with self._lock:
            frozen = set(self._frozen)
        out = {}
        for s in SPECS:
            out[s.name] = {
                "value": snap.get(s.name),
                "default": s.from_env(),
                "env": s.env,
                "lattice": list(s.lattice),
                "overridden": snap.is_overridden(s.name),
                "frozen": s.name in frozen,
            }
        return out


#: process-global registry: the serving stack's call-time knob reads
#: (relax iteration rung, hierarchical threshold) and the default
#: pipeline/controller wiring all share it, so a tuned value is seen
#: everywhere.  Tests inject their own Knobs instead.
_GLOBAL: Optional[Knobs] = None
_GLOBAL_LOCK = threading.Lock()


def global_knobs() -> Knobs:
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Knobs()
    return _GLOBAL
