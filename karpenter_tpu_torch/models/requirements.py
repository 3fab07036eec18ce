"""Node-selector requirement algebra.

Re-implements the semantics of karpenter-core's ``scheduling.Requirements``
(reconstructed in SURVEY.md §2.2 from the Provisioner CRD operator set at
upstream karpenter pkg/apis/crds/karpenter.sh_provisioners.yaml:204-208 and the
behavioral docs in website/content/en/preview/concepts/scheduling.md:134-167).

Design: each key's constraint is a ``ValueSet`` — either an *allow* set (finite)
or a *complement* set ("everything except these"), optionally intersected with
numeric (Gt/Lt) bounds.  Operators map to sets as:

- ``In {a,b}``        -> allow {a,b}
- ``NotIn {a,b}``     -> complement {a,b}
- ``Exists``          -> complement {}          (any value)
- ``DoesNotExist``    -> allow {}               (no value may satisfy; key must be absent)
- ``Gt "5"`` / ``Lt`` -> numeric bound intersected with the set

``Requirements`` is a key->ValueSet map closed under intersection (``add``),
with the two comparison predicates the scheduler needs:

- ``intersects(other)``: for every shared key the sets overlap — used for
  node-requirement x node-requirement merges (provisioner ∩ pod).
- ``compatible(labels)``: a concrete label assignment (e.g. an instance type's
  labels, one value per key) satisfies the requirement set — used on the hot
  path; the TPU solver compiles exactly this predicate into bitmask tensors
  (see models/tensorize.py).

This is a fresh design (sets + bounds), not a port of the Go representation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Iterator, Mapping, Optional, Sequence

# Operators (match the k8s NodeSelectorOperator strings used by the CRD).
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_OPERATORS = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)


def _as_number(value: str) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class ValueSet:
    """A (possibly complemented) string set intersected with numeric bounds.

    ``complement=False, values={}``  => empty set (DoesNotExist)
    ``complement=True,  values={}``  => universe
    ``greater``/``less`` are exclusive numeric bounds (Gt/Lt semantics).
    ``require_exists`` tracks whether the label must be *present*: kube
    NodeSelectorRequirement semantics say NotIn and DoesNotExist match nodes
    without the label, while Exists/Gt/Lt (and In, trivially) require it.
    The flag survives intersection so ``Exists ∩ NotIn{a}`` still demands
    presence.
    """

    values: FrozenSet[str] = frozenset()
    complement: bool = False
    greater: Optional[float] = None  # value must be > greater
    less: Optional[float] = None  # value must be < less
    require_exists: bool = False

    # ---- constructors -------------------------------------------------
    @staticmethod
    def universe() -> "ValueSet":
        return ValueSet(frozenset(), True)

    @staticmethod
    def empty() -> "ValueSet":
        return ValueSet(frozenset(), False)

    @staticmethod
    def of(*values: str) -> "ValueSet":
        return ValueSet(frozenset(values), False)

    # ---- predicates ---------------------------------------------------
    def is_empty(self) -> bool:
        """True if no value can satisfy this set (DoesNotExist semantics)."""
        if self.complement:
            # "everything except values" within bounds: empty only when the
            # numeric bounds admit nothing (integer semantics, bounds exclusive)
            return not self._bounds_admit_any()
        if not self.values:
            return True
        return not any(self.contains(v) for v in self.values)

    def _bounds_admit_any(self) -> bool:
        # consistent with contains(), which accepts any numeric string:
        # the open real interval (greater, less) is non-empty iff less > greater
        if self.greater is not None and self.less is not None:
            return self.less > self.greater
        return True

    def allows_absence(self) -> bool:
        """True if a node *without* this label satisfies the requirement
        (kube: DoesNotExist and NotIn match missing labels; In/Exists/Gt/Lt
        do not)."""
        if self.require_exists:
            return False
        if not self.complement:
            return not self.values  # only the DoesNotExist empty set
        return True  # NotIn-style complement

    def contains(self, value: str) -> bool:
        if self.greater is not None or self.less is not None:
            num = _as_number(value)
            if num is None:
                return False
            if self.greater is not None and not num > self.greater:
                return False
            if self.less is not None and not num < self.less:
                return False
        if self.complement:
            return value not in self.values
        return value in self.values

    def intersects(self, other: "ValueSet") -> bool:
        return not self.intersect(other).is_empty()

    # ---- algebra ------------------------------------------------------
    def intersect(self, other: "ValueSet") -> "ValueSet":
        greater = self.greater
        if other.greater is not None:
            greater = other.greater if greater is None else max(greater, other.greater)
        less = self.less
        if other.less is not None:
            less = other.less if less is None else min(less, other.less)

        req = self.require_exists or other.require_exists
        if self.complement and other.complement:
            out = ValueSet(self.values | other.values, True, greater, less, req)
        elif not self.complement and not other.complement:
            out = ValueSet(self.values & other.values, False, greater, less, req)
        else:
            allow, deny = (self, other) if not self.complement else (other, self)
            out = ValueSet(allow.values - deny.values, False, greater, less, req)
        # a node missing the label satisfies the conjunction iff it satisfies
        # BOTH conjuncts.  Without this, In{a} ∩ In{b} collapses to the empty
        # allow-set, which allows_absence() reads as DoesNotExist — a
        # contradictory pod (volume pin to one zone + node_selector to
        # another, fuzz seed 18) would then "fit" any label-less node
        if out.allows_absence() and not (
            self.allows_absence() and other.allows_absence()
        ):
            out = ValueSet(out.values, out.complement, greater, less, True)
        return out

    def enumerate_finite(self) -> Iterator[str]:
        """Iterate concrete values if the set is finite (allow-form)."""
        if self.complement:
            raise ValueError("cannot enumerate a complement set")
        for v in sorted(self.values):
            if self.contains(v):
                yield v

    # ---- display ------------------------------------------------------
    def __repr__(self) -> str:  # pragma: no cover
        base = ("¬" if self.complement else "") + "{" + ",".join(sorted(self.values)) + "}"
        if self.greater is not None:
            base += f" >{self.greater:g}"
        if self.less is not None:
            base += f" <{self.less:g}"
        return base


@dataclass(frozen=True)
class Requirement:
    """One NodeSelectorRequirement as written by a user (key, operator, values)."""

    key: str
    operator: str
    values: Sequence[str] = ()

    def __post_init__(self) -> None:
        if self.operator not in _OPERATORS:
            raise ValueError(f"unknown operator {self.operator!r} for key {self.key!r}")
        if self.operator in (GT, LT) and len(self.values) != 1:
            raise ValueError(f"{self.operator} requires exactly one value")
        if self.operator in (EXISTS, DOES_NOT_EXIST) and self.values:
            raise ValueError(f"{self.operator} must not carry values")
        object.__setattr__(self, "values", tuple(self.values))

    def __hash__(self) -> int:
        # memoized structural hash: requirements appear inside pod group-dedup
        # keys, hashed once per pod at tensorize time; shared instances
        # (deployment pods) amortize the computation
        h = self.__dict__.get("_h")
        if h is None:
            h = hash((self.key, self.operator, self.values))
            object.__setattr__(self, "_h", h)
        return h

    def value_set(self) -> ValueSet:
        if self.operator == IN:
            return ValueSet(frozenset(self.values), False)
        if self.operator == NOT_IN:
            return ValueSet(frozenset(self.values), True)
        if self.operator == EXISTS:
            return ValueSet(frozenset(), True, require_exists=True)
        if self.operator == DOES_NOT_EXIST:
            return ValueSet.empty()
        num = _as_number(self.values[0])
        if num is None:
            raise ValueError(f"{self.operator} value must be numeric: {self.values[0]!r}")
        if self.operator == GT:
            return ValueSet(frozenset(), True, greater=num, require_exists=True)
        return ValueSet(frozenset(), True, less=num, require_exists=True)


class Requirements:
    """An intersection of requirements, keyed by label.

    Mutable builder with value semantics on read.  ``add`` intersects; absent
    keys are unconstrained (universe).
    """

    __slots__ = ("_by_key",)

    def __init__(self, reqs: Iterable[Requirement] = ()) -> None:
        self._by_key: Dict[str, ValueSet] = {}
        for r in reqs:
            self.add(r)

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_labels(labels: Mapping[str, str]) -> "Requirements":
        out = Requirements()
        for k, v in labels.items():
            out.add(Requirement(k, IN, [v]))
        return out

    @staticmethod
    def from_node_selector_terms(terms) -> "Requirements":
        """Collapse a single NodeSelectorTerm's matchExpressions into Requirements."""
        out = Requirements()
        for t in terms:
            out.add(t if isinstance(t, Requirement) else Requirement(**t))
        return out

    def copy(self) -> "Requirements":
        out = Requirements()
        out._by_key = dict(self._by_key)
        return out

    # ---- mutation -----------------------------------------------------
    def add(self, req: "Requirement | Requirements") -> "Requirements":
        if isinstance(req, Requirements):
            for key, vs in req._by_key.items():
                self._merge(key, vs)
            return self
        self._merge(req.key, req.value_set())
        return self

    def _merge(self, key: str, vs: ValueSet) -> None:
        cur = self._by_key.get(key)
        self._by_key[key] = vs if cur is None else cur.intersect(vs)

    # ---- access -------------------------------------------------------
    def keys(self) -> Iterable[str]:
        return self._by_key.keys()

    def has(self, key: str) -> bool:
        return key in self._by_key

    def get(self, key: str) -> ValueSet:
        return self._by_key.get(key, ValueSet.universe())

    def __len__(self) -> int:
        return len(self._by_key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._by_key)

    # ---- predicates ---------------------------------------------------
    def intersects(self, other: "Requirements") -> Optional[str]:
        """None if every shared key's sets overlap, else the conflicting key.

        Mirrors core Requirements.Intersects used when layering provisioner
        requirements with pod requirements (scheduling.md:134-167).
        """
        for key, vs in self._by_key.items():
            if key not in other._by_key:
                continue
            merged = vs.intersect(other._by_key[key])
            if merged.is_empty():
                # Special case: both sides demanding DoesNotExist is compatible.
                if vs.is_empty() and other._by_key[key].is_empty():
                    continue
                return key
        return None

    def compatible(self, labels: Mapping[str, str]) -> Optional[str]:
        """None if the concrete labels satisfy every requirement, else the failing key.

        Missing-label semantics follow kube NodeSelectorRequirement rules:
        DoesNotExist and NotIn are satisfied by an absent label; In, Exists,
        Gt and Lt are not (ValueSet.allows_absence).
        """
        for key, vs in self._by_key.items():
            val = labels.get(key)
            if val is None:
                if not vs.allows_absence():
                    return key
                continue
            if vs.is_empty() or not vs.contains(val):
                return key
        return None

    def signature(self) -> tuple:
        """Lossless structural key for memoizing requirement-algebra answers
        per (requirements, node-class) pair (consolidation.compat_matrix,
        native.solve_tensors_native, reference._label_taint_ok).  Built from
        the ValueSet fields directly — ``to_list()``'s canonical operator
        form is LOSSY (it drops require_exists when a set is
        complement-with-values, so [Exists(k), NotIn(k,{x})] would collide
        with [NotIn(k,{x})] and inherit the first-seen answer)."""
        return tuple(sorted(
            (k, tuple(sorted(vs.values)), vs.complement, vs.greater,
             vs.less, vs.require_exists)
            for k, vs in self._by_key.items()
        ))

    def to_list(self) -> list:
        """Canonical list form (used by serialization + vocab registration)."""
        out = []
        for key in sorted(self._by_key):
            vs = self._by_key[key]
            if vs.greater is not None:
                out.append(Requirement(key, GT, [f"{vs.greater:g}"]))
            if vs.less is not None:
                out.append(Requirement(key, LT, [f"{vs.less:g}"]))
            if vs.complement:
                if vs.values:
                    out.append(Requirement(key, NOT_IN, sorted(vs.values)))
                elif vs.greater is None and vs.less is None and vs.require_exists:
                    out.append(Requirement(key, EXISTS))
            else:
                if vs.values:
                    out.append(Requirement(key, IN, sorted(vs.values)))
                else:
                    out.append(Requirement(key, DOES_NOT_EXIST))
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return "Requirements(" + ", ".join(f"{k}∈{v!r}" for k, v in sorted(self._by_key.items())) + ")"
