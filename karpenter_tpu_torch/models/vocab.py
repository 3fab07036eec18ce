"""Label vocabulary interning.

In/NotIn/Exists/DoesNotExist/Gt/Lt over arbitrary strings cannot be traced into
XLA; the solver needs fixed-width tensors.  This layer interns every label key,
every per-key value, every resource name, and every (selector, topology-key)
pair into dense integer ids so that:

- a concrete label assignment (an instance type's labels) becomes an int vector
  ``V[K]`` of per-key value ids (0 == "key absent"),
- a requirement set becomes a packed bitmask ``PM[K, W]`` (bit v of key k set
  iff value id v satisfies the requirement on k; Gt/Lt are evaluated against
  the finite value vocabulary at compile time, which is exact because every
  value a node can carry comes from the catalog),
- the satisfaction predicate lowers to a gather + bit-test on TPU
  (see solver/tpu.py).

SURVEY.md §7 flags this interning layer as a hard requirement of the design.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .requirements import Requirements, ValueSet

ABSENT = 0  # reserved value id per key: "label not present"


@dataclass
class Vocab:
    keys: List[str] = field(default_factory=list)
    key_id: Dict[str, int] = field(default_factory=dict)
    # per-key value tables; index 0 reserved for ABSENT
    values: List[List[Optional[str]]] = field(default_factory=list)
    value_id: List[Dict[str, int]] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_id: Dict[str, int] = field(default_factory=dict)
    frozen: bool = False

    # ---- interning ----------------------------------------------------
    def key(self, name: str) -> int:
        kid = self.key_id.get(name)
        if kid is None:
            if self.frozen:
                raise KeyError(f"unknown label key {name!r} (vocab frozen)")
            kid = len(self.keys)
            self.keys.append(name)
            self.key_id[name] = kid
            self.values.append([None])  # slot 0 = ABSENT
            self.value_id.append({})
        return kid

    def value(self, key_name: str, val: str) -> int:
        kid = self.key(key_name)
        vid = self.value_id[kid].get(val)
        if vid is None:
            if self.frozen:
                raise KeyError(f"unknown value {val!r} for key {key_name!r} (vocab frozen)")
            vid = len(self.values[kid])
            self.values[kid].append(val)
            self.value_id[kid][val] = vid
        return vid

    def resource(self, name: str) -> int:
        rid = self.resource_id.get(name)
        if rid is None:
            if self.frozen:
                raise KeyError(f"unknown resource {name!r} (vocab frozen)")
            rid = len(self.resources)
            self.resources.append(name)
            self.resource_id[name] = rid
        return rid

    # ---- sizes --------------------------------------------------------
    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def n_resources(self) -> int:
        return len(self.resources)

    def max_values(self) -> int:
        return max((len(v) for v in self.values), default=1)

    def mask_words(self) -> int:
        return (self.max_values() + 31) // 32

    # ---- lowering -----------------------------------------------------
    def labels_to_ids(self, labels: Mapping[str, str]) -> np.ndarray:
        """Concrete labels -> V[K] int32 (ABSENT for unmentioned keys).
        Unknown keys/values (never seen in any requirement or catalog entry)
        are ignored — nothing could ever constrain on them."""
        out = np.zeros(self.n_keys, dtype=np.int32)
        for k, v in labels.items():
            kid = self.key_id.get(k)
            if kid is None:
                continue
            out[kid] = self.value_id[kid].get(v, ABSENT) if v is not None else ABSENT
        return out

    def requirements_to_mask(
        self, reqs: Requirements, *, absent_ok_for_finite: bool = True
    ) -> np.ndarray:
        """Requirements -> PM[K, W] packed uint32.

        For keys with no requirement: all bits set.  Bit ABSENT(=0) encodes
        whether the key may be missing: allowed when the requirement is
        DoesNotExist, when there is no requirement, or — when
        ``absent_ok_for_finite`` — when the requirement is a finite allow set
        (karpenter lets the node *adopt* a single-valued pod-requirement label,
        scheduling.md:134-167, so an unlabeled candidate can still satisfy it).
        """
        K, W = self.n_keys, self.mask_words()
        pm = np.full((K, W), 0xFFFFFFFF, dtype=np.uint32)
        for key_name in reqs.keys():
            kid = self.key_id.get(key_name)
            if kid is None:
                raise KeyError(
                    f"requirement key {key_name!r} was never interned; "
                    "tensorize must register all requirement keys in pass 1"
                )
            vs = reqs.get(key_name)
            mask = np.zeros(W, dtype=np.uint32)
            vals = self.values[kid]
            for vid in range(1, len(vals)):
                if vs.contains(vals[vid]):  # type: ignore[arg-type]
                    mask[vid // 32] |= np.uint32(1 << (vid % 32))
            absent_ok = vs.allows_absence() or (
                # karpenter lets a node adopt a single-valued pod-requirement
                # label, so finite In-sets are satisfiable by an unlabeled node
                absent_ok_for_finite and not vs.complement and not vs.is_empty()
                and vs.greater is None and vs.less is None
            )
            if vs.is_empty():
                mask[:] = 0  # DoesNotExist: no concrete value acceptable
            if absent_ok:
                mask[0] |= np.uint32(1)
            pm[kid] = mask
        return pm

    def resources_to_row(self, lst: Mapping[str, float]) -> np.ndarray:
        row = np.zeros(self.n_resources, dtype=np.float64)
        for k, v in lst.items():
            rid = self.resource_id.get(k)
            if rid is not None:
                row[rid] = v
        return row
