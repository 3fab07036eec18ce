"""Device mesh + sharding layout for the solver: the port of the reference
package's ``parallel/mesh.py`` on PyTorch devices.

A :class:`Mesh` is a small array of ``torch.device`` entries with named
axes, each entry tagged with the ``torch.distributed`` rank that owns it:

- ``pods``  — shards the pod-group axis (G) of the requirement masks;
- ``types`` — shards the candidate axis (C) of the catalog tensors;
- ``slots`` — the megabatch request-slot axis (:func:`slot_mesh`): a 1-D
  re-view of the SAME entries, one contiguous block of request slots per
  entry, so a coalesced flush serves every slot on its own device with no
  cross-slot traffic.

Feasibility (``F[G, C]``) is computed block by block, each (pods, types)
block on its own mesh device (solver/tpu.py ``prepare``).  Unlike the
reference, the flat scan does not shard its node-slot axis: it runs
replicated on the device of the solve (see solver/tpu.py).

An entry is a device, not a process: one rank may hold several (a host
with several cards), and several entries may name the same card (virtual
shards, ``make_mesh(devices=["cuda:0"] * 8)``), which is how the layout is
exercised on a machine with one card.  ``make_mesh`` never falls back to
the CPU: asking for more cards than exist raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

POD_AXIS = "pods"
TYPE_AXIS = "types"
#: the megabatch request-slot axis: a 1-D re-view of the SAME entries the
#: (pods, types) mesh spans — see :func:`slot_mesh`
SLOT_AXIS = "slots"


def _obj_array(items: Sequence, shape=None) -> np.ndarray:
    """An object ndarray of ``items`` (never unpacked as sequences)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr if shape is None else arr.reshape(shape)


class _Placed:
    """One mesh entry before layout: a device and the rank that owns it."""

    __slots__ = ("device", "process_index")

    def __init__(self, device: torch.device, process_index: int) -> None:
        self.device = device
        self.process_index = process_index


class Mesh:
    """Named-axis array of ``torch.device`` entries.  ``devices`` is the
    ndarray of devices, ``process_indexes`` the owning rank of each entry
    (same shape), ``shape`` maps each axis name to its size.  Equal (and
    hashing equal) when devices, ranks and axes are."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_indexes=None) -> None:
        devs = np.asarray(devices, dtype=object)
        self.devices = devs
        self.axis_names = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(
                f"{devs.ndim}-d device array for axes {self.axis_names}")
        procs = (np.zeros(devs.shape, dtype=np.int64)
                 if process_indexes is None
                 else np.asarray(process_indexes, dtype=np.int64))
        if procs.shape != devs.shape:
            raise ValueError("process_indexes must match the device array")
        self.process_indexes = procs
        self._key = (self.axis_names, devs.shape,
                     tuple(str(d) for d in devs.reshape(-1)),
                     tuple(int(p) for p in procs.reshape(-1)))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self._key[2])})"


def _host_major(devices: Sequence) -> np.ndarray:
    """Arrange devices as a (pods, types) array.

    Multi-process (entries spanning >1 rank): the pods axis runs ACROSS
    ranks and the types axis WITHIN one, so the candidate-axis traffic
    stays between one host's own cards and only the embarrassingly
    parallel pod-group axis crosses hosts.  Single process: the largest
    factor pair (a, b), a >= b, so both axes shard."""
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    n = len(devices)
    n_proc = len(by_proc)
    if n_proc > 1 and n % n_proc == 0:
        per_host = n // n_proc
        rows = [by_proc[p][:per_host] for p in sorted(by_proc)]
        if all(len(r) == per_host for r in rows):
            return _obj_array([d for r in rows for d in r],
                              (n_proc, per_host))
    b = int(np.floor(np.sqrt(n)))
    while n % b:
        b -= 1
    return _obj_array(list(devices), (n // b, b))


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _local_devices(devices) -> List[torch.device]:
    """This rank's entries: the explicit ``devices``, else every visible
    card (one card per rank, the current one, inside a multi-rank job)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; the mesh never falls "
            "back to the CPU (pass devices=[...] for an explicit layout)")
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (pods, types) mesh.

    ``devices`` names this rank's entries explicitly (``["cuda:0"] * 8``
    is eight virtual shards on one card); otherwise the mesh takes every
    visible CUDA card.  Inside an initialised ``torch.distributed`` job
    every rank's entries are gathered (``all_gather_object``) and tagged
    with the rank, in rank order, then laid out host-major
    (:func:`_host_major`).  ``n_devices`` takes the first that many
    entries and raises when fewer exist: there is no CPU fallback."""
    import torch.distributed as dist

    local = _local_devices(devices)
    placed = [_Placed(d, _rank()) for d in local]
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        gathered: List = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        placed = [_Placed(torch.device(d), r)
                  for r, devs in enumerate(gathered) for d in devs]
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"make_mesh({n_devices}): need >= 1 device")
        if len(placed) < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}): only {len(placed)} device(s) "
                f"available ({[str(p.device) for p in placed]}); the mesh "
                "never falls back to the CPU")
        placed = placed[:n_devices]
    arr = _host_major(placed)
    devs = _obj_array([p.device for p in arr.reshape(-1)], arr.shape)
    procs = np.array([p.process_index for p in arr.reshape(-1)],
                     dtype=np.int64).reshape(arr.shape)
    return Mesh(devs, (POD_AXIS, TYPE_AXIS), procs)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


class NamedSharding:
    """A layout of an array over ``mesh``: ``spec[d]`` names the mesh axis
    that splits array dim ``d`` into equal contiguous blocks (None, or a
    dim past the spec, is whole on every entry).  No names = replicated."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...]) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)

    def shard_indices(self, shape: Sequence[int]) -> List[tuple]:
        """``(position, device, process_index, index)`` per mesh entry in
        row-major order; ``index`` is a tuple of slices into an array of
        ``shape``.  Raises when a sharded dim does not divide evenly."""
        mesh = self.mesh
        out = []
        for pos in np.ndindex(*mesh.devices.shape):
            index = []
            for d, n in enumerate(shape):
                name = self.spec[d] if d < len(self.spec) else None
                if name is None:
                    index.append(slice(0, int(n)))
                    continue
                ax = mesh.axis_names.index(name)
                k = mesh.devices.shape[ax]
                if n % k:
                    raise ValueError(
                        f"dim {d} of size {n} does not divide over the "
                        f"{k}-entry {name!r} axis")
                per = int(n) // k
                index.append(slice(pos[ax] * per, (pos[ax] + 1) * per))
            out.append((pos, mesh.devices[pos],
                        int(mesh.process_indexes[pos]), tuple(index)))
        return out


class Shard:
    """One addressable block of a :class:`ShardedArray`: ``index`` into the
    global array, the ``device`` and tensor ``data`` holding it, and the
    CUDA ``stream`` it was produced on (None on the host / current)."""

    __slots__ = ("index", "device", "data", "stream")

    def __init__(self, index: tuple, device, data: torch.Tensor,
                 stream=None) -> None:
        self.index = index
        self.device = device
        self.data = data
        self.stream = stream


class ShardedArray:
    """A global array laid out by a :class:`NamedSharding`, holding only
    THIS rank's blocks (``addressable_shards``).  ``nbytes`` is the whole
    array's size, as a whole-batch read would transfer it."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 sharding: NamedSharding, shards: List[Shard]) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.addressable_shards = shards

    @property
    def nbytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return int(np.prod(self.shape, dtype=np.int64)) * itemsize


def feasibility_shardings(mesh: Mesh):
    """(in_shardings, out_shardings) of ``solver.tpu.compute_feasibility``:
    the block partition of ``F[G, C]`` over (pods, types) and of
    ``dom_ok[G, D]`` over pods, with each input split the way its block
    needs it."""
    s = lambda *names: axis_sharding(mesh, *names)  # noqa: E731
    ins = dict(
        pm=s(POD_AXIS),            # [G, K, W]
        requests=s(POD_AXIS),      # [G, R]
        gp_ok=s(POD_AXIS),         # [G, P]
        cand_vw=s(TYPE_AXIS),      # [C, K]
        cand_vb=s(TYPE_AXIS),
        cand_alloc=s(TYPE_AXIS),
        cand_prov=s(TYPE_AXIS),
        key_check=s(),
        dom_vw=s(),
        dom_vb=s(),
    )
    outs = (s(POD_AXIS, TYPE_AXIS), s(POD_AXIS))  # F[G,C], dom_ok[G,D]
    return ins, outs


def replicate(mesh: Mesh, tree):
    """Place a pytree (dict / list / tuple of arrays) fully replicated on
    the mesh: every leaf a :class:`ShardedArray` with a whole copy on each
    of this rank's entries."""
    from .distributed import put_sharded

    sh = axis_sharding(mesh)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return put_sharded(tree, sh)


# ---------------------------------------------------------------------------
# cached layout construction
# ---------------------------------------------------------------------------
# Meshes hash by value, so these caches hit for every call over the
# process-lifetime mesh a serving path holds.


@lru_cache(maxsize=64)
def slot_mesh(mesh: Mesh) -> Mesh:
    """1-D ``('slots',)`` re-view of a ``(pods, types)`` mesh's entries,
    row-major over the host-major array: each rank's entries (and so its
    slots) stay contiguous."""
    return Mesh(mesh.devices.reshape(-1), (SLOT_AXIS,),
                mesh.process_indexes.reshape(-1))


@lru_cache(maxsize=64)
@lru_cache(maxsize=64)
def slot_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (dim 0 = request slot) sharding over
    :func:`slot_mesh`; trailing axes whole — fully local per slot.  Cached
    per mesh, like :func:`axis_sharding`: the serving path looks it up per
    flush."""
    return NamedSharding(slot_mesh(mesh), (SLOT_AXIS,))


@lru_cache(maxsize=256)
def axis_sharding(mesh: Mesh, *names: str) -> NamedSharding:
    """Cached ``NamedSharding(mesh, names)`` — no names = replicated."""
    return NamedSharding(mesh, tuple(names))


# ---------------------------------------------------------------------------
# host-ownership map (per-host fences over addressable shards)
# ---------------------------------------------------------------------------


def _owner_blocks(proc_of_dev: Sequence[int], n_slots: int) -> tuple:
    """Owner rank per slot, given the flattened (host-major) per-entry
    ranks.  ``n_slots`` must divide evenly over the entries (the sharded
    rung ladder guarantees it — ``_mega_rung`` floors at the entry count
    and doubles)."""
    n_dev = len(proc_of_dev)
    if n_slots % n_dev:
        raise ValueError(
            f"{n_slots} slots do not divide over {n_dev} devices: the "
            "sharded rung ladder should have padded to a multiple")
    per_dev = n_slots // n_dev
    return tuple(int(proc_of_dev[s // per_dev]) for s in range(n_slots))


def multihost(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans more than one rank — the regime where a
    whole-batch fence would read slots this process does not own."""
    if mesh is None:
        return False
    return len(set(int(p) for p in mesh.process_indexes.reshape(-1))) > 1


def slot_hosts(mesh: Mesh, n_slots: int) -> tuple:
    """Owner rank of each of ``n_slots`` padded request slots of a
    megabatch sharded over :func:`slot_mesh` (one contiguous block per
    rank by construction)."""
    return _owner_blocks(list(mesh.process_indexes.reshape(-1)), n_slots)


def local_slot_range(
    mesh: Mesh, n_slots: int, process_index: Optional[int] = None,
) -> Tuple[int, int]:
    """The contiguous ``[start, stop)`` slot range this rank owns in an
    ``n_slots``-padded megabatch (empty when the rank holds no entry of
    the mesh).  Defaults to ``torch.distributed.get_rank()`` inside an
    initialised job, else 0."""
    if process_index is None:
        process_index = _rank()
    owners = slot_hosts(mesh, n_slots)
    mine = [s for s, p in enumerate(owners) if p == process_index]
    if not mine:
        return (0, 0)
    lo, hi = mine[0], mine[-1] + 1
    # host-major contiguity is a layout invariant (slot_mesh's flatten)
    assert hi - lo == len(mine), (
        f"process {process_index} owns non-contiguous slots {mine}")
    return (lo, hi)


def mesh_signature(mesh: Optional[Mesh]) -> tuple:
    """Hashable (axis, size) fingerprint of a mesh for bucket keys (the
    reference's tuple; ``()`` for None)."""
    if mesh is None:
        return ()
    return tuple(
        (str(a), int(s)) for a, s in zip(mesh.axis_names, mesh.devices.shape)
    )
