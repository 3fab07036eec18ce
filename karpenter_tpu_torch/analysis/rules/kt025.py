"""KT025 — per-member gang-identity access outside the gang package.

The gang contract (docs/GANGS.md) holds only if every layer
treats a gang as ONE unit: one admission ticket, one delta
perturbation, one all-or-nothing placement decision.  The moment an
admission or solver path reads a member's ``gang_id``/``gang_size``
directly, it is re-deriving group semantics locally — and local
derivations drift (a host fast path that seats "just this member", a
shed that drops half a roster, an accounting loop that counts members
as units).  All group logic lives in ``karpenter_tpu_torch/gang/``:
membership
(``gang_of``/``has_gangs``/``gang_members``), placement discipline
(``gang_fixed``/``run_epilogue``), unit accounting (``admission_units``)
and delta widening (``expand_gang_removals``) are the sanctioned entry
points, and they are the ONLY code that touches the raw fields.

Flagged: any ``.gang_id`` / ``.gang_size`` attribute access in a file
under ``karpenter_tpu_torch/admission/`` or ``karpenter_tpu_torch/solver/``
(reads
and writes alike — a solver path has no business minting membership
either).

Exempt: ``karpenter_tpu_torch/gang/`` itself (outside the scanned dirs by
construction), and everything outside the two scoped packages —
``models/pod.py`` declares the fields and ``service/codec.py`` moves
them on/off the wire; both are data plumbing, not group decisions.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, file_nodes

ID = "KT025"
TITLE = "per-member gang-identity access outside the gang package"
HINT = ("route group semantics through karpenter_tpu_torch.gang — "
        "`gang_of(pod)`/`has_gangs`/`gang_members` for membership, "
        "`gang_fixed` for placement-path gating, `admission_units` for "
        "ticket accounting, `expand_gang_removals` for delta widening; "
        "a local read of the raw fields re-derives the all-or-nothing "
        "contract and will drift from it")

#: the fields whose direct access re-derives group semantics locally
GANG_FIELDS = ("gang_id", "gang_size")
#: packages where gang decisions must route through the gang package
SCOPED_PARTS = ("karpenter_tpu_torch/admission/",
                "karpenter_tpu_torch/solver/")


def _in_scope(path: str) -> bool:
    return any(part in path for part in SCOPED_PARTS)


def check(files) -> List[Finding]:
    findings: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        for n in file_nodes(f):
            if not (isinstance(n, ast.Attribute) and n.attr in GANG_FIELDS):
                continue
            findings.append(Finding(
                ID, f.path, n.lineno,
                f"direct `.{n.attr}` access re-derives gang semantics "
                "locally — admission/solver paths must treat a gang as "
                "one unit through the karpenter_tpu_torch.gang entry points, "
                "or the all-or-nothing contract drifts",
                hint=HINT,
            ))
    return findings
