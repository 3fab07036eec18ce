"""KT021 — wire-compatibility gate for the solver proto schema.

The gRPC boundary (``service/solver.proto``) is the one surface a
rolling upgrade cannot atomically change: old clients talk to new
servers and vice versa for the whole deploy window.  Three edits are
silently wire-breaking even though every test on ONE side still passes:

- **field-number reuse** — rebinding a number to a new name/meaning
  makes old payloads decode into the wrong field, no error anywhere;
- **type/label change** — ``int64 -> string`` or ``optional ->
  repeated`` on a live number changes the wire type; old messages
  decode garbage or drop the field;
- **removal without a tombstone** — deleting a field frees its number
  for accidental reuse next quarter; proto requires a ``reserved N;``
  tombstone to keep it burned.

The rule parses the CURRENT ``solver.proto`` with a pure-stdlib textual
parser and diffs it against the committed golden descriptor snapshot
(``analysis/solver_descriptor.golden.json`` — fields, numbers, types,
labels, reserved ranges).  Legitimate schema growth refreshes the golden
explicitly (``python -m karpenter_tpu_torch.analysis --proto-golden``),
so the diff shows up in review as a one-line JSON change next to the
.proto edit.  The port speaks the reference's wire: its ``solver.proto``
and golden carry the same wire facts as the reference's, and its
``solver_pb2.py`` is a byte-identical copy of the reference's generated
module.  The rule also cross-checks ``solver_pb2.py`` staleness: every
live field name must appear in the generated module's serialized
descriptor (regenerate the reference's with ``python
scripts/gen_proto.py`` and copy it).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

from ..ktlint import Finding, package_root

ID = "KT021"
TITLE = "wire-breaking solver.proto change vs the golden descriptor"
HINT = ("never rebind or retype a live field number; removals must leave "
        "`reserved N;` tombstones.  Additive changes: add the field to both "
        "packages' solver.proto, regenerate and copy solver_pb2.py "
        "(`python scripts/gen_proto.py`), then refresh the golden with "
        "`python -m karpenter_tpu_torch.analysis --proto-golden`")

PROTO_PATH = "karpenter_tpu_torch/service/solver.proto"
GOLDEN_NAME = "solver_descriptor.golden.json"

_MSG_RE = re.compile(r"^message\s+(\w+)\s*\{")
_RESERVED_RE = re.compile(r"^reserved\s+(.+);")
_FIELD_RE = re.compile(
    r"^(?:(repeated|optional|required)\s+)?"
    r"(map<[^>]+>|[\w.]+)\s+(\w+)\s*=\s*(\d+)\s*(?:;|\[)")


def parse_proto(text: str) -> Dict[str, dict]:
    """``{message: {"line", "fields": {number: {"name","type","label",
    "line"}}, "reserved": [numbers]}}`` — messages keyed by their dotted
    nesting path.  Textual and deliberately narrow: it parses THIS
    repo's proto dialect (proto3, no oneofs/enums/extensions), and
    anything it cannot parse it skips rather than misreads."""
    out: Dict[str, dict] = {}
    stack: List[str] = []
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        m = _MSG_RE.match(line)
        if m:
            stack.append(m.group(1))
            out[".".join(stack)] = {"line": i, "fields": {}, "reserved": []}
            continue
        if line.startswith("}"):
            if stack:
                stack.pop()
            continue
        if not stack:
            continue
        cur = out[".".join(stack)]
        m = _RESERVED_RE.match(line)
        if m:
            for part in m.group(1).split(","):
                toks = part.split()
                if len(toks) == 3 and toks[1] == "to":
                    cur["reserved"].extend(
                        range(int(toks[0]), int(toks[2]) + 1))
                elif part.strip().isdigit():
                    cur["reserved"].append(int(part.strip()))
            continue
        m = _FIELD_RE.match(line)
        if m:
            label, ftype, name, number = m.groups()
            cur["fields"][int(number)] = {
                "name": name, "type": ftype, "label": label or "",
                "line": i}
    return out


def golden_path() -> Path:
    return package_root() / "analysis" / GOLDEN_NAME


def snapshot(proto: Dict[str, dict]) -> dict:
    """The golden's JSON shape: line numbers stripped (they churn with
    comments; the WIRE facts are fields/numbers/types/labels/reserved)."""
    return {
        msg: {
            "fields": {
                str(num): {k: v for k, v in f.items() if k != "line"}
                for num, f in sorted(m["fields"].items())},
            "reserved": sorted(m["reserved"]),
        }
        for msg, m in sorted(proto.items())
    }


def write_golden(path: Optional[Path] = None) -> Path:
    """(Re)write the golden from the live proto — the explicit, reviewed
    step that blesses a schema change."""
    proto = parse_proto(
        (package_root().parent / PROTO_PATH).read_text())
    out = path or golden_path()
    out.write_text(json.dumps(snapshot(proto), indent=2, sort_keys=True)
                   + "\n")
    return out


def check(files, proto_text: Optional[str] = None,
          golden: Optional[dict] = None,
          pb2_text: Optional[str] = None) -> List[Finding]:
    fixture = proto_text is not None
    if not fixture and not any("karpenter_tpu_torch/service/" in f.path
                               for f in files):
        return []  # per-file run outside the wire surface
    if proto_text is None:
        try:
            proto_text = (package_root().parent / PROTO_PATH).read_text()
        except OSError:
            return []
    live = parse_proto(proto_text)
    if golden is None:
        try:
            golden = json.loads(golden_path().read_text())
        except (OSError, ValueError):
            return [Finding(
                ID, PROTO_PATH, 1,
                "no readable golden descriptor snapshot "
                f"(analysis/{GOLDEN_NAME}) — the wire-compat gate has "
                "nothing to diff against",
                hint=HINT)]
    out: List[Finding] = []
    for msg, gm in sorted(golden.items()):
        lm = live.get(msg)
        if lm is None:
            out.append(Finding(
                ID, PROTO_PATH, 1,
                f"message `{msg}` was removed from the schema — old "
                "peers still send/expect it",
                hint=HINT))
            continue
        live_reserved = set(lm["reserved"])
        for num_s, gf in sorted(gm["fields"].items(), key=lambda kv:
                                int(kv[0])):
            num = int(num_s)
            lf = lm["fields"].get(num)
            if lf is None:
                if num not in live_reserved:
                    out.append(Finding(
                        ID, PROTO_PATH, lm["line"],
                        f"`{msg}.{gf['name']}` (field {num}) was removed "
                        f"without a `reserved {num};` tombstone — the "
                        "number is free for silent reuse",
                        hint=HINT))
                continue
            if lf["name"] != gf["name"]:
                out.append(Finding(
                    ID, PROTO_PATH, lf["line"],
                    f"field number {num} of `{msg}` was re-bound: "
                    f"`{gf['name']}` -> `{lf['name']}` — old payloads "
                    "decode into the wrong field",
                    hint=HINT))
            elif (lf["type"] != gf["type"]
                  or lf["label"] != gf["label"]):
                was = f"{gf['label']} {gf['type']}".strip()
                now = f"{lf['label']} {lf['type']}".strip()
                out.append(Finding(
                    ID, PROTO_PATH, lf["line"],
                    f"`{msg}.{lf['name']}` (field {num}) changed wire "
                    f"shape: `{was}` -> `{now}`",
                    hint=HINT))
        golden_reserved = set(gm.get("reserved", []))
        for num, lf in sorted(lm["fields"].items()):
            if str(num) in gm["fields"]:
                continue
            if num in golden_reserved:
                out.append(Finding(
                    ID, PROTO_PATH, lf["line"],
                    f"`{msg}.{lf['name']}` re-uses field number {num}, "
                    "which is a reserved tombstone of a removed field",
                    hint=HINT))
            else:
                out.append(Finding(
                    ID, PROTO_PATH, lf["line"],
                    f"`{msg}.{lf['name']}` (field {num}) is not in the "
                    "golden descriptor — refresh it so the addition is "
                    "an explicit, reviewed wire change",
                    hint=HINT))
    # ---- generated-module staleness ------------------------------------
    if pb2_text is None and not fixture:
        try:
            pb2_text = (package_root() / "service"
                        / "solver_pb2.py").read_text()
        except OSError:
            pb2_text = None
    if pb2_text is not None:
        for msg, lm in sorted(live.items()):
            for num, lf in sorted(lm["fields"].items()):
                # the serialized FileDescriptorProto embeds every field
                # name as plain bytes — absence means the module predates
                # the .proto edit
                if lf["name"] not in pb2_text:
                    out.append(Finding(
                        ID, PROTO_PATH, lf["line"],
                        f"`{msg}.{lf['name']}` is in solver.proto but "
                        "solver_pb2.py has never heard of it — "
                        "regenerate and copy it (`python "
                        "scripts/gen_proto.py`)",
                        hint=HINT))
    return out
