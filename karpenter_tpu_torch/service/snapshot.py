"""Session spool — versioned, checksummed, SESSION-ADDRESSABLE storage of
live delta chains, plus the ownership-lease API that makes it multi-writer
safe: the port of the reference package's ``service/snapshot.py``
(docs/RESILIENCE.md).

Delta serving is session-stateful; a replica restart would destroy every
``_warmstart_meta`` chain and cost one full re-establishing solve PER
CLIENT.  The spool lets a replica RESTART resume warm, and is the FLEET's
handoff medium: each session is its own record file under
``KT_SESSION_DIR/<backend>/sessions/``, guarded by a lease file under
``.../leases/``, so ANY replica sharing the volume (a shared PVC) can
restore a specific session on demand (``DeltaSessionTable.adopt``) — not
just its own table at boot — while the lease protocol guarantees two
replicas can never both adopt one chain.

Record layout (one file per session, ``sessions/<sid>.snap``)::

    MAGIC(8) | version(>I) | payload_len(>Q) | sha256(payload)(32) | payload

``payload`` is a pickle of ``{"schema": ..., "catalog_epoch": ...,
"entries": [one entry blob]}`` — pickle is the right tool here because the
spool is written and read by the SAME binary (the chain carries numpy
residual matrices and the full SimNode graph, and pickle preserves the
node-object identity sharing between ``result.nodes`` and ``meta.nodes``
that the warm-start tiers rely on).  What makes it safe is the envelope:

- **Atomic**: write-temp + fsync + rename — a SIGKILL mid-write leaves
  the previous spool intact, never a torn file.
- **Checksummed**: a flipped byte anywhere in the payload fails the
  sha256 and the restore refuses (``corrupt``).
- **Length-framed**: a truncated payload is detected BEFORE the checksum
  (``truncated``) so operators can tell disk-full from bit-rot.
- **Versioned twice**: the format version (:data:`SNAPSHOT_VERSION`) and
  a schema fingerprint derived from the live classes (module, name and
  dataclass fields) of ``SolveResult`` + ``warmstart._Meta`` + ``SimNode``
  — a refactor that changes the chain shape auto-invalidates old spools
  (``version``) instead of unpickling into a subtly different world.  The
  module names make the port's fingerprint differ from the reference
  package's: a reference spool (whose pickles name the reference's
  modules) is refused ``version`` before any entry is unpickled, and the
  port never reads one.
- **Host-only payload**: an entry is pickled with every tensor moved to
  the host first, so a spooled chain never names a device.
- **Catalog-gated**: a spool whose catalog epoch DIFFERS from the
  configured ``KT_CATALOG_EPOCH`` is refused whole (``catalog_epoch``)
  — older or newer, a chain packed against another epoch's prices must
  not serve warm.

Every refusal is a COLD START plus a counted reason
(``karpenter_solver_session_snapshot_restore_total{outcome}``), never a
crash and never a diverged chain.

The lease protocol (``leases/<sid>.lease``, JSON ``{owner, expires_at}``):

- **Claim** (:func:`claim_lease`) — an ``O_CREAT|O_EXCL`` create: exactly
  one creator wins on a shared POSIX volume.  Claiming your OWN lease
  renews it (write-temp + rename, safe because you own it).
- **Refusal** — an unexpired lease held by another owner raises the typed
  :class:`LeaseHeld`; the caller counts it and answers the client
  ``session_unknown`` (one re-establish, floor) instead of
  splitting the chain's ownership.
- **Steal after expiry** — an EXPIRED foreign lease is stolen by renaming
  it to a per-claimant tombstone (two concurrent stealers race the
  rename; exactly one wins, the loser re-reads and refuses) and then
  re-claimed with the same exclusive create.  A live owner renews on
  every record write, so only a dead (or wedged-past-TTL) replica's
  sessions are stealable — the failover-warmness window IS the lease TTL
  (``KT_SESSION_LEASE_S``).

Ownership is verified on every record write: a zombie replica whose lease
was stolen gets :class:`LeaseHeld` back from its renewal and must DROP the
chain (counted ``lease_lost``) — it can neither serve another epoch of it
nor clobber the adopter's newer record.

ktlint **KT017** pins this file (plus the ``DeltaSessionTable`` facade in
``service/delta.py``) as the ONLY place in ``service/`` allowed to touch
the record/lease primitives — a drive-by ``open()`` of a spool path from
the server or client layer would bypass the exactly-one-owner protocol.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import struct
import time as _time
from typing import Dict, List, Optional, Tuple

import torch

MAGIC = b"KTSESS1\n"
#: bump when the envelope layout changes (the schema fingerprint below
#: covers chain-SHAPE drift automatically)
SNAPSHOT_VERSION = 1
_HEADER = struct.Struct(">IQ")  # version, payload length
#: legacy whole-table spool file name (reworked to per-session
#: records; the name survives for the tombstone check below)
SPOOL_NAME = "sessions.snap"
#: per-session record files live here, one ``<sid>.snap`` each
SESSIONS_SUBDIR = "sessions"
#: per-session ownership leases live here, one ``<sid>.lease`` each
LEASES_SUBDIR = "leases"
RECORD_SUFFIX = ".snap"
LEASE_SUFFIX = ".lease"
#: default ownership-lease TTL, seconds (KT_SESSION_LEASE_S).  A dead
#: replica's sessions become stealable this long after its last record
#: write — the fleet's failover-warmness window.  Graceful paths (drain,
#: SIGTERM shutdown) RELEASE leases so adoption is instant.
DEFAULT_LEASE_S = 10.0

_REPLICA_ID: Optional[str] = None


def replica_id() -> str:
    """This process's stable spool-owner identity: ``KT_REPLICA_ID`` (the
    deploy sets the pod name) or a generated ``<host>-<pid>-<rand>``.
    Cached per process, so a restarted in-process service (tests, the
    single-replica topology) self-renews its own leases and resumes warm
    without waiting out the TTL."""
    global _REPLICA_ID
    env = os.environ.get("KT_REPLICA_ID", "")
    if env:
        return env
    if _REPLICA_ID is None:
        import socket
        import uuid

        _REPLICA_ID = (f"{socket.gethostname()}-{os.getpid()}-"
                       f"{uuid.uuid4().hex[:8]}")
    return _REPLICA_ID


class LeaseHeld(Exception):
    """Typed adoption refusal: another replica holds an UNEXPIRED lease on
    this session — exactly one owner per chain, by construction."""

    def __init__(self, session_id: str, owner: str,
                 expires_at: float) -> None:
        super().__init__(
            f"session {session_id!r} lease held by {owner!r} "
            f"until {expires_at:.3f}")
        self.session_id = session_id
        self.owner = owner
        self.expires_at = expires_at


class SnapshotRefused(Exception):
    """A spool file that must not be restored.  ``reason`` is one of the
    ``SNAPSHOT_RESTORE_OUTCOMES`` labels (corrupt / truncated / version /
    catalog_epoch) — the caller counts it and cold-starts."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(f"session snapshot refused ({reason}): {detail}")
        self.reason = reason


def chain_schema() -> str:
    """Fingerprint of the live chain shape: the dataclass fields of the
    result and warm-start bookkeeping the spool pickles.  Computed from
    the RUNNING code, so a refactor that adds/renames a field refuses old
    spools without anyone remembering to bump a constant."""
    from ..solver.types import SimNode, SolveResult
    from ..solver.warmstart import _Meta

    names = "|".join(
        f"{cls.__module__}.{cls.__qualname__}:"
        + ",".join(sorted(cls.__dataclass_fields__))
        for cls in (SolveResult, _Meta, SimNode)
        if hasattr(cls, "__dataclass_fields__"))
    return hashlib.sha256(names.encode()).hexdigest()[:16]


def spool_path(dir_path: str) -> str:
    return os.path.join(dir_path, SPOOL_NAME)


class _HostPickler(pickle.Pickler):
    """Pickles a device tensor as its host copy: a spooled chain must
    restore on any replica, whatever its device."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return obj.detach().cpu().__reduce_ex__(self.proto)
        return NotImplemented


def pack_entry(entry: dict) -> bytes:
    """One session entry -> its own pickle blob.  Entries are pickled
    INDIVIDUALLY so the table can serialize them without any scheduler
    lock: a chain that mutates under the pickler corrupts (or tears)
    only its own blob, which the caller detects via the epoch/in_step
    re-check and discards — the spool never carries a torn chain.  The
    result's attributes ride along (``_warmstart_meta`` and the
    unplaced-pod objects ``_warmstart_unplaced`` the next full keeps)."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(entry)
    return buf.getvalue()


def unpack_entry(blob: bytes) -> dict:
    return pickle.loads(blob)


def pack(entries: list, catalog_epoch: int = 0) -> bytes:
    """Serialize per-entry blobs (from :func:`pack_entry`) into one
    framed, checksummed spool blob."""
    payload = pickle.dumps(
        {"schema": chain_schema(), "catalog_epoch": int(catalog_epoch),
         "entries": entries},
        protocol=pickle.HIGHEST_PROTOCOL)
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(_HEADER.pack(SNAPSHOT_VERSION, len(payload)))
    buf.write(hashlib.sha256(payload).digest())
    buf.write(payload)
    return buf.getvalue()


def unpack(blob: bytes,
           expected_catalog_epoch: Optional[int] = None) -> Tuple[list, int]:
    """Validate + deserialize a spool blob -> (entries, catalog_epoch).

    Raises :class:`SnapshotRefused` with the counted reason on every
    adversarial shape: wrong magic / failed checksum / undecodable
    (``corrupt``), short payload (``truncated``), format-version or
    chain-schema drift (``version``), stale catalog (``catalog_epoch``).
    """
    head_len = len(MAGIC) + _HEADER.size + 32
    if len(blob) < head_len:
        raise SnapshotRefused("truncated",
                              f"{len(blob)}B < {head_len}B header")
    if blob[:len(MAGIC)] != MAGIC:
        raise SnapshotRefused("corrupt", "bad magic")
    version, length = _HEADER.unpack_from(blob, len(MAGIC))
    if version != SNAPSHOT_VERSION:
        raise SnapshotRefused(
            "version", f"format v{version}, want v{SNAPSHOT_VERSION}")
    digest = blob[len(MAGIC) + _HEADER.size:head_len]
    payload = blob[head_len:]
    if len(payload) < length:
        raise SnapshotRefused(
            "truncated", f"payload {len(payload)}B < declared {length}B")
    payload = payload[:length]
    if hashlib.sha256(payload).digest() != digest:
        raise SnapshotRefused("corrupt", "payload checksum mismatch")
    try:
        doc = pickle.loads(payload)
    # ktlint: allow[KT005] any undecodable payload is the same outcome: a
    # refused snapshot, counted 'corrupt', cold start
    except Exception as err:  # noqa: BLE001
        raise SnapshotRefused("corrupt", f"unpickle failed: {err}") from err
    if not isinstance(doc, dict) or "entries" not in doc:
        raise SnapshotRefused("corrupt", "payload is not a snapshot doc")
    if doc.get("schema") != chain_schema():
        raise SnapshotRefused(
            "version", "chain schema drift (warm-start bookkeeping shape "
            "changed since this spool was written)")
    epoch = int(doc.get("catalog_epoch", 0))
    if (expected_catalog_epoch is not None
            and epoch != int(expected_catalog_epoch)):
        raise SnapshotRefused(
            "catalog_epoch",
            f"spool catalog epoch {epoch} != configured "
            f"{expected_catalog_epoch}")
    return list(doc["entries"]), epoch


def _atomic_write(path: str, blob: bytes) -> str:
    """The one atomic file-install primitive every spool write rides:
    write-temp + fsync + rename.  The temp lives in the SAME directory
    so the rename is atomic on one mount, and carries a per-writer
    (pid + thread) suffix so concurrent writers can never interleave
    inside one temp file."""
    import threading

    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def write_atomic(dir_path: str, blob: bytes) -> str:
    """Legacy whole-table spool write: either the complete new snapshot
    or the complete previous one — never a torn file."""
    os.makedirs(dir_path, exist_ok=True)
    return _atomic_write(spool_path(dir_path), blob)


def read(dir_path: str) -> Optional[bytes]:
    """The legacy whole-table spool's bytes, or None when no snapshot
    exists (plain cold start, counted 'missing')."""
    try:
        with open(spool_path(dir_path), "rb") as fh:
            return fh.read()
    except FileNotFoundError:
        return None


# ---------------------------------------------------------------------------
# session-addressable records
# ---------------------------------------------------------------------------

def _safe_name(session_id: str) -> str:
    """Filesystem-safe encoding of a session id.  Ids are uuid hex in
    production, but the spool must not trust the wire: anything outside
    ASCII [A-Za-z0-9._-] is escaped as fixed-width per-UTF-8-byte
    ``%xx`` (collision-free — '%' itself escapes, and fixed width keeps
    the decoding unambiguous so two distinct hostile ids can never
    collide onto one record/lease file), so an id can neither traverse
    out of the spool directory nor alias another session's files."""
    out = []
    for ch in session_id:
        if ch.isascii() and (ch.isalnum() or ch in "._-"):
            out.append(ch)
        else:
            out.extend(f"%{b:02x}" for b in ch.encode("utf-8"))
    return "".join(out) or "%00"


def _unsafe_name(encoded: str) -> str:
    """Inverse of :func:`_safe_name` (record filename -> session id)."""
    buf = bytearray()
    i = 0
    while i < len(encoded):
        if encoded[i] == "%" and i + 3 <= len(encoded):
            try:
                buf.append(int(encoded[i + 1:i + 3], 16))
                i += 3
                continue
            except ValueError:
                pass
        buf.extend(encoded[i].encode("utf-8"))
        i += 1
    return buf.decode("utf-8", errors="replace")


def session_path(dir_path: str, session_id: str) -> str:
    return os.path.join(dir_path, SESSIONS_SUBDIR,
                        _safe_name(session_id) + RECORD_SUFFIX)


def lease_path(dir_path: str, session_id: str) -> str:
    return os.path.join(dir_path, LEASES_SUBDIR,
                        _safe_name(session_id) + LEASE_SUFFIX)


def list_sessions(dir_path: str) -> List[str]:
    """Session ids with a record under the spool (encoded filenames
    decoded back), oldest record first so boot-time adoption under a
    capacity bound keeps the fleet's most senior chains deterministic."""
    sess_dir = os.path.join(dir_path, SESSIONS_SUBDIR)
    entries = []
    try:
        listing = list(os.scandir(sess_dir))
    except FileNotFoundError:
        return []
    for e in listing:
        if not e.name.endswith(RECORD_SUFFIX):
            continue
        try:
            # per-entry: a sibling consuming (unlinking) ONE record
            # mid-scan must not blank the whole listing — the shared
            # spool is contended by design
            if e.is_file():
                entries.append((e.stat().st_mtime, e.name))
        except FileNotFoundError:
            continue
    return [_unsafe_name(name[:-len(RECORD_SUFFIX)])
            for _mtime, name in sorted(entries)]


def write_record(dir_path: str, session_id: str, blob: bytes) -> str:
    """One session's framed record (from :func:`pack`), installed
    atomically."""
    final = session_path(dir_path, session_id)
    os.makedirs(os.path.dirname(final), exist_ok=True)
    return _atomic_write(final, blob)


def record_exists(dir_path: str, session_id: str) -> bool:
    """Cheap existence probe — the adopt-on-miss fast path checks this
    BEFORE paying the lease-claim file ops, since the common miss (a
    genuinely unknown session) has no record at all."""
    return os.path.exists(session_path(dir_path, session_id))


def record_age_s(dir_path: str, session_id: str) -> Optional[float]:
    """Seconds since the record's bytes were last refreshed (wall clock —
    a live owner rewrites its records every snapshot pass, so a large
    age means the writer is gone), or None when the record is absent."""
    try:
        mtime = os.stat(session_path(dir_path, session_id)).st_mtime
    except OSError:
        return None
    # ktlint: allow[KT002] cross-process spool freshness is wall-clock
    # infrastructure, like the lease-mutex staleness breaker
    return max(0.0, _time.time() - mtime)


def read_record(dir_path: str, session_id: str) -> Optional[bytes]:
    try:
        with open(session_path(dir_path, session_id), "rb") as fh:
            return fh.read()
    except FileNotFoundError:
        return None


def remove_record(dir_path: str, session_id: str) -> None:
    try:
        os.unlink(session_path(dir_path, session_id))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the ownership-lease API (exactly one adopter per chain)
# ---------------------------------------------------------------------------

def _read_lease(path: str) -> Optional[Dict]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.loads(fh.read())
        if isinstance(doc, dict) and "owner" in doc:
            return doc
    except (OSError, ValueError):
        pass
    return None


#: how long a claim-mutex directory may exist before it is presumed
#: abandoned (a claimant died INSIDE the microseconds-long critical
#: section) and broken by the next claimant.  Generous on purpose: the
#: mkdir mtime is stamped by the STORAGE server on a shared volume, and
#: the margin must swallow realistic client/server clock skew — a
#: breaker that fires on a fresh mutex would let two claimants run the
#: read-decide-write concurrently.  A genuinely wedged mutex only delays
#: adoption (typed refusal -> one client re-establish), never serving.
_MUTEX_STALE_S = 30.0


class _LeaseMutex:
    """Per-lease critical section: an ``os.mkdir`` of ``<lease>.lock`` —
    atomic on a shared POSIX volume, exactly one winner — serializes
    every lease MUTATION (claim / renew / steal / release).  This is what
    makes the protocol's read-decide-write sequences actually atomic:
    rename-based steal schemes can yank a fresh lease a faster claimant
    just installed (observed in the contention tests), while a mutexed
    read-decide-write cannot.  The critical section is microseconds of
    file I/O; a mutex older than ``_MUTEX_STALE_S`` means its holder died
    inside it and is broken (rmdir races resolve to one winner)."""

    def __init__(self, path: str) -> None:
        self._dir = path + ".lock"

    def __enter__(self):
        for _ in range(2000):  # ~4s worst case at 2ms per spin
            try:
                os.mkdir(self._dir)
                return self
            except FileExistsError:
                try:
                    st = os.stat(self._dir)
                    # ktlint: allow[KT002] mutex staleness is wall-clock
                    # infrastructure shared ACROSS processes — an
                    # injectable test clock has no meaning for a sibling
                    # replica's mkdir timestamp
                    age = _time.time() - st.st_mtime
                except OSError:
                    continue  # released between the mkdir and the stat
                if age > _MUTEX_STALE_S:
                    try:
                        # re-verify at the last instant: if the dir was
                        # re-created since our stat (its identity moved),
                        # this rmdir would break a FRESH claimant's mutex
                        # — the decide-then-break window is narrowed to
                        # the microseconds between these two syscalls
                        st2 = os.stat(self._dir)
                        if st2.st_mtime == st.st_mtime \
                                and st2.st_ino == st.st_ino:
                            os.rmdir(self._dir)  # break the orphan
                    except OSError:
                        pass
                else:
                    _time.sleep(0.002)
        raise OSError(f"lease mutex {self._dir} wedged")

    def __exit__(self, *exc):
        try:
            os.rmdir(self._dir)
        except OSError:
            pass


def _write_lease(path: str, payload: bytes) -> None:
    """Atomic lease install (caller holds the mutex)."""
    _atomic_write(path, payload)


def claim_lease(dir_path: str, session_id: str, owner: str, now: float,
                ttl_s: float, force: bool = False) -> str:
    """Claim (or renew, or steal-after-expiry) the session's ownership
    lease, atomically (read-decide-write under the per-lease mutex).
    Returns ``"claimed"`` (was free), ``"renewed"`` (already ours), or
    ``"stolen"`` (the previous owner's lease had expired).  Raises
    :class:`LeaseHeld` when another owner's UNEXPIRED lease stands — the
    typed refusal that keeps adoption exactly-once.

    ``force=True`` steals even an unexpired foreign lease — reserved for
    session ESTABLISHMENT (``DeltaSessionTable.own``): the client just
    re-established the chain HERE, so whatever incarnation the old lease
    guarded is obsolete by the client's own authority; the old owner's
    next renewal refuses and it drops its zombie entry (``lease_lost``)
    instead of livelocking the session between two replicas."""
    path = lease_path(dir_path, session_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = json.dumps({"owner": owner,
                          "expires_at": now + max(0.0, ttl_s)}).encode()
    with _LeaseMutex(path):
        cur = _read_lease(path)
        if cur is None:
            # free (never claimed, released, or unreadable garbage — a
            # corrupt lease must not wedge its session forever)
            _write_lease(path, payload)
            return "claimed"
        if cur.get("owner") == owner:
            _write_lease(path, payload)
            return "renewed"
        if not force and float(cur.get("expires_at", 0.0)) > now:
            raise LeaseHeld(session_id, str(cur.get("owner")),
                            float(cur.get("expires_at", 0.0)))
        _write_lease(path, payload)
        return "stolen"


def release_lease(dir_path: str, session_id: str, owner: str) -> None:
    """Release the lease iff we still own it (a stolen lease belongs to
    the new owner — never delete it out from under them).  The
    owner-check + unlink runs under the same per-lease mutex as claims,
    so a release racing a steal cannot delete the thief's fresh lease."""
    path = lease_path(dir_path, session_id)
    if not os.path.exists(path):
        return
    try:
        with _LeaseMutex(path):
            cur = _read_lease(path)
            if cur is not None and cur.get("owner") == owner:
                try:
                    os.unlink(path)
                except OSError:
                    pass
    except OSError:
        pass  # wedged mutex: leave the lease to expire on its own


def lease_state(dir_path: str, session_id: str) -> Optional[Dict]:
    """The lease document ({owner, expires_at}) or None — observability
    only (statusz, tests); never a correctness input."""
    return _read_lease(lease_path(dir_path, session_id))
