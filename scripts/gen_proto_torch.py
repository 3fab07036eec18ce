"""Regenerate ``karpenter_tpu_torch/service/solver_pb2.py`` without protoc.

The port of ``scripts/gen_proto.py`` over ``karpenter_tpu_torch``: the
image has no ``protoc`` / ``grpc_tools``, so the generated module is
maintained programmatically.  This script loads the port's CURRENT
module's serialized ``FileDescriptorProto``, applies the schema deltas
declared in :data:`NEW_FIELDS` below (idempotently — fields already
present are left alone), and re-emits the module in the exact builder
format the repo carries, with the ``_serialized_start/_serialized_end``
offsets recomputed by first occurrence of each message's serialized
descriptor in the file bytes (nested map entries with identical bytes
share the first hit, same as the checked-in file).

    python scripts/gen_proto_torch.py            # rewrites the port's solver_pb2.py
    python scripts/gen_proto_torch.py --check    # exit 1 when the module is stale

The port speaks the reference's wire: its ``solver_pb2.py`` is a
byte-identical copy of the reference's (both packages' modules load into
protobuf's default pool in one process), so the deltas here are the
reference's, and a change to one must be made to both.

Wire compatibility: every added field is proto3-optional/repeated with
zero-value defaults, so old wire bytes decode with ""/0/false/[] and old
decoders skip the new tags — a rolling upgrade never breaks either side.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from google.protobuf import descriptor_pb2  # noqa: E402

OUT = ROOT / "karpenter_tpu_torch" / "service" / "solver_pb2.py"

F = descriptor_pb2.FieldDescriptorProto
#: message -> [(number, name, type, label)] — the schema deltas this repo
#: has accrued past the original solver.proto; append here and re-run.
NEW_FIELDS = {
    # delta serving: session identity + the perturbation payload.
    # A delta request reuses `pods` for the ADDED pods and `unavailable` for
    # the newly ICE'd offerings; removals/reclaims ride the new fields.
    "SolveRequest": [
        (13, "session_id", F.TYPE_STRING, F.LABEL_OPTIONAL),
        (14, "base_epoch", F.TYPE_INT64, F.LABEL_OPTIONAL),
        (15, "delta", F.TYPE_BOOL, F.LABEL_OPTIONAL),
        (16, "removed_pods", F.TYPE_STRING, F.LABEL_REPEATED),
        (17, "reclaimed_nodes", F.TYPE_STRING, F.LABEL_REPEATED),
        (18, "catalog_epoch", F.TYPE_INT64, F.LABEL_OPTIONAL),
        # fleet-wide tracing: the caller's trace context.  An
        # empty trace_id (old clients, unsampled origins) decodes to "no
        # context" and the server roots its trace locally — backward
        # compatible by construction.
        (19, "trace_id", F.TYPE_STRING, F.LABEL_OPTIONAL),
        (20, "parent_span", F.TYPE_STRING, F.LABEL_OPTIONAL),
        # chain-identity nonce: minted by the server at
        # establishment, echoed by the client on every delta, so an
        # epoch collision across chain LINEAGES (spool rollback) is a
        # typed SESSION_UNKNOWN instead of a silent divergence.  "" on
        # either side is the legacy wildcard — mixed-version fleets
        # simply keep today's epoch-only check.
        (21, "session_nonce", F.TYPE_STRING, F.LABEL_OPTIONAL),
    ],
    # session ack + delta-shaped responses: `assignments`/`nodes` carry only
    # the step's changes when `delta_mode` is an incremental tier;
    # `removed_nodes` are proposal nodes the step pruned.
    "SolveResponse": [
        (5, "session_epoch", F.TYPE_INT64, F.LABEL_OPTIONAL),
        (6, "session_state", F.TYPE_STRING, F.LABEL_OPTIONAL),
        (7, "delta_mode", F.TYPE_STRING, F.LABEL_OPTIONAL),
        (8, "removed_nodes", F.TYPE_STRING, F.LABEL_REPEATED),
        # fleet-wide tracing: which replica served this RPC —
        # failover-aware clients stamp it on their "remote" span so a
        # re-routed hop's serving replica is visible from the client side
        (9, "replica_id", F.TYPE_STRING, F.LABEL_OPTIONAL),
        # chain-identity nonce echo (see SolveRequest 21)
        (10, "session_nonce", F.TYPE_STRING, F.LABEL_OPTIONAL),
    ],
    # gang scheduling: members of one gang share
    # a gang_id and declare the gang's total size.  Old bytes decode to
    # ""/0 = ungrouped; old decoders skip the tags — a mixed-version fleet
    # simply schedules gang pods individually (pre-gang semantics).
    "Pod": [
        (14, "gang_id", F.TYPE_STRING, F.LABEL_OPTIONAL),
        (15, "gang_size", F.TYPE_INT32, F.LABEL_OPTIONAL),
    ],
}


def _apply(fdp: descriptor_pb2.FileDescriptorProto) -> int:
    added = 0
    by_name = {m.name: m for m in fdp.message_type}
    for msg_name, fields in NEW_FIELDS.items():
        msg = by_name[msg_name]
        have = {f.number for f in msg.field}
        for number, name, ftype, label in fields:
            if number in have:
                continue
            fld = msg.field.add()
            fld.name = name
            fld.number = number
            fld.type = ftype
            fld.label = label
            # json_name matches protoc's lowerCamelCase derivation
            parts = name.split("_")
            fld.json_name = parts[0] + "".join(p.title() for p in parts[1:])
            added += 1
    return added


def _walk(msg, prefix):
    """(PYNAME, DescriptorProto) depth-first, protoc naming: _SOLVEREQUEST,
    _POD_LABELSENTRY, ..."""
    pyname = f"{prefix}_{msg.name.upper()}"
    yield pyname, msg
    for nested in msg.nested_type:
        yield from _walk(nested, pyname)


def _emit(fdp: descriptor_pb2.FileDescriptorProto) -> str:
    blob = fdp.SerializeToString()
    lines = [
        "# -*- coding: utf-8 -*-",
        "# Generated by the protocol buffer compiler.  DO NOT EDIT!",
        "# source: solver.proto",
        '"""Generated protocol buffer code."""',
        "from google.protobuf.internal import builder as _builder",
        "from google.protobuf import descriptor as _descriptor",
        "from google.protobuf import descriptor_pool as _descriptor_pool",
        "from google.protobuf import symbol_database as _symbol_database",
        "# @@protoc_insertion_point(imports)",
        "",
        "_sym_db = _symbol_database.Default()",
        "",
        "",
        "",
        "",
        "DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile("
        + repr(blob) + ")",
        "",
        "_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())",
        "_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'solver_pb2',"
        " globals())",
        "if _descriptor._USE_C_DESCRIPTORS == False:",
        "",
        "  DESCRIPTOR._options = None",
    ]
    # map-entry options, then first-occurrence offsets, protoc layout
    messages = []
    for top in fdp.message_type:
        messages.extend(_walk(top, ""))
    for pyname, msg in messages:
        if msg.options.map_entry:
            lines.append(f"  {pyname}._options = None")
            lines.append(f"  {pyname}._serialized_options = b'8\\001'")
    for pyname, msg in messages:
        sub = msg.SerializeToString()
        start = blob.find(sub)
        assert start >= 0, f"descriptor bytes for {pyname} not found"
        lines.append(f"  {pyname}._serialized_start={start}")
        lines.append(f"  {pyname}._serialized_end={start + len(sub)}")
    lines.append("# @@protoc_insertion_point(module_scope)")
    return "\n".join(lines) + "\n"


def render():
    """``(fields added, module text, descriptor)``: the port's current
    module with :data:`NEW_FIELDS` applied, re-emitted."""
    from karpenter_tpu_torch.service import solver_pb2 as pb

    fdp = descriptor_pb2.FileDescriptorProto.FromString(
        pb.DESCRIPTOR.serialized_pb)
    added = _apply(fdp)
    return added, _emit(fdp), fdp


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    added, text, fdp = render()
    if "--check" in argv:
        if added or OUT.read_text() != text:
            print(f"{OUT} is stale ({added} schema deltas unapplied); run "
                  "`python scripts/gen_proto_torch.py`", file=sys.stderr)
            return 1
        return 0
    OUT.write_text(text)
    print(f"wrote {OUT} ({added} fields added, "
          f"{len(fdp.SerializeToString())} descriptor bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
