"""Multi-process execution: ``torch.distributed`` over the host-major mesh —
the port of the reference package's ``parallel/distributed.py``.

Each process is one rank of a ``torch.distributed`` job; the (pods, types)
mesh of ``parallel/mesh.py`` spans every rank's devices, the pods axis
across ranks and the types axis within one.  The backend is ``nccl`` when
every rank drives its own card and ``gloo`` otherwise: NCCL refuses two
ranks on one GPU, so two processes sharing a card (and CPU workers) run on
gloo, whose collectives here move host copies (``all_gather_object``).

Entry points:

- ``worker_main`` (``python -m karpenter_tpu_torch.parallel.distributed``)
  — one rank: initialise, build the global mesh, assert the host-major
  layout against the REAL ranks and round-trip a slot-sharded array
  through ``put_sharded`` / ``replicate_for_host``; a caller's ``work``
  then runs on the mesh (``scripts/dryrun_multihost_torch.py`` serves a
  per-host-fenced megabatch and forwards a foreign slot there);
- ``launch_dryrun`` / ``launch_workers`` — spawn N ranks on this machine
  and collect their verdicts.

Every entry point resolves a missing device to the card and raises
without one; the CPU is used only when asked for (``--device cpu``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import torch


def multiprocess_cpu_support() -> Optional[str]:
    """None when multi-process CPU execution is available (this torch has
    ``torch.distributed`` with the gloo backend), else the precise missing
    capability (tests use it as a skip reason)."""
    import torch.distributed as dist

    if not dist.is_available():
        return "this torch build has no torch.distributed"
    if not dist.is_gloo_available():
        return ("this torch has no gloo backend: multi-process CPU "
                "collectives are unavailable")
    return None


def _backend_for(device: torch.device, num_processes: int,
                 process_id: int) -> str:
    """``nccl`` when every rank drives its own card (rank r on ``cuda:r``
    of a machine with a card per rank), ``gloo`` otherwise."""
    import torch.distributed as dist

    own_card = (device.type == "cuda" and dist.is_nccl_available()
                and (num_processes == 1
                     or (torch.cuda.device_count() >= num_processes
                         and device.index == process_id)))
    return "nccl" if own_card else "gloo"


def _rank_device(device, num_processes: int, process_id: int) -> torch.device:
    """This rank's device: ``device`` as given, else the card (raising
    without one), rank r on ``cuda:r`` when there is a card per rank and
    on ``cuda:0`` otherwise."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        own = torch.cuda.device_count() >= num_processes
        dev = torch.device("cuda", process_id if own else 0)
    return dev


def initialize(coordinator: str, num_processes: int, process_id: int,
               device=None) -> str:
    """Join the ``torch.distributed`` job at ``coordinator``
    (``host:port``) as rank ``process_id`` of ``num_processes``; returns
    the backend, which ``device`` (this rank's, resolved by
    :func:`_rank_device`) decides."""
    import datetime

    import torch.distributed as dist

    dev = _rank_device(device, num_processes, process_id)
    backend = _backend_for(dev, num_processes, process_id)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=300))
    return backend


def put_sharded(value, sharding):
    """Place a host value under ``sharding``: every rank holds the full
    value (the solve tensors are built deterministically on each host) and
    keeps only ITS blocks, each on its entry's device."""
    from .mesh import Shard, ShardedArray, _rank

    arr = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    me = _rank()
    shards = [
        Shard(index, dev, arr[index].contiguous().to(dev))
        for _pos, dev, proc, index in sharding.shard_indices(arr.shape)
        if proc == me
    ]
    return ShardedArray(arr.shape, arr.dtype, sharding, shards)


def gather_blocks(blocks, shape, dtype, device, complete: bool = True):
    """Assemble a ``shape`` array on ``device`` from ``(index, tensor)``
    blocks.  ``complete`` means this rank holds every block; otherwise the
    blocks of every rank are gathered (``all_gather_object`` over host
    copies, a collective every rank must enter)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if complete:
        for index, data in blocks:
            out[index] = data.to(device)
        return out
    import torch.distributed as dist

    mine = [(tuple((sl.start, sl.stop) for sl in index),
             data.cpu().numpy()) for index, data in blocks]
    gathered: List = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    for part in gathered:
        for bounds, arr in part:
            index = tuple(slice(a, b) for a, b in bounds)
            out[index] = torch.from_numpy(arr).to(device)
    return out


def replicate_for_host(mesh, value) -> np.ndarray:
    """The whole of a (possibly partly foreign) sharded array as a host
    ndarray on every rank: each rank contributes its own shards (read on
    the streams that produced them) and gathers the others'."""
    from ..solver.tpu import _on_stream
    from .mesh import ShardedArray, multihost

    if not isinstance(value, ShardedArray):
        return (value.cpu().numpy() if isinstance(value, torch.Tensor)
                else np.asarray(value))
    blocks = []
    for sh in value.addressable_shards:
        with _on_stream(sh.stream):
            blocks.append((sh.index, sh.data.cpu()))
    mesh = mesh or value.sharding.mesh
    return gather_blocks(blocks, value.shape, value.dtype, "cpu",
                         complete=not multihost(mesh)).numpy()


def assert_host_major(mesh) -> None:
    """The layout contract of ``mesh._host_major`` on real ranks: with >1
    rank, every types-axis row lives inside ONE rank and the pods axis
    walks the ranks in order, covering all of them."""
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world == 1:
        return
    row_procs = []
    for row in mesh.process_indexes:
        procs = {int(p) for p in row}
        assert len(procs) == 1, (
            f"types axis spans ranks {procs}: candidate-axis traffic "
            "would cross hosts")
        row_procs.append(procs.pop())
    assert row_procs == sorted(row_procs), (
        f"pods axis does not walk ranks in order: {row_procs}")
    assert len(set(row_procs)) == world, (
        f"pods axis covers {len(set(row_procs))} of {world} ranks")


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def worker_main(argv: Optional[List[str]] = None,
                work: Optional[Callable] = None) -> int:
    """One rank: the reference's flags plus ``--device`` (the card when
    absent).  Checks the mesh's layout and a sharded round trip, then runs
    ``work(mesh, device, args)`` if given; prints one ``MHOSTW`` JSON
    verdict holding the rank's record and whatever ``work`` returned."""
    import argparse
    import time

    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: the card); every "
                         "local entry is on it")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    device = _rank_device(args.device, args.num_processes, args.process_id)
    backend = initialize(args.coordinator, args.num_processes,
                         args.process_id, device=device)
    try:
        assert dist.get_world_size() == args.num_processes
        from .mesh import make_mesh, multihost, slot_sharding

        n_global = args.num_processes * args.local_devices
        mesh = make_mesh(n_global, devices=[device] * args.local_devices)
        assert mesh.size == n_global
        assert_host_major(mesh)
        assert multihost(mesh) == (args.num_processes > 1)
        # each rank holds only its slot blocks; the gather restores all
        value = np.arange(n_global * 3, dtype=np.int32).reshape(n_global, 3)
        arr = put_sharded(value, slot_sharding(mesh))
        assert len(arr.addressable_shards) == args.local_devices
        assert np.array_equal(replicate_for_host(mesh, arr), value), (
            "a sharded round trip lost blocks")
        record = dict(pid=dist.get_rank(), ok=True, backend=backend,
                      device=str(device), mesh=mesh.shape)
        if work is not None:
            record.update(work(mesh, device, args))
        dist.barrier()
        record["seconds"] = time.perf_counter() - t0
        print("MHOSTW " + json.dumps(record), flush=True)
        print(f"worker {args.process_id}/{args.num_processes} OK: "
              f"{args.num_processes} processes x {args.local_devices} "
              f"devices on {device} over {backend}, mesh {mesh.shape}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def launch_dryrun(
    n_processes: int = 2,
    local_devices: int = 2,
    timeout: float = 600.0,
    port: int = 0,
    retries: int = 2,
    device=None,
) -> List[str]:
    """Spawn ``n_processes`` ranks of ``worker_main`` on this machine, each
    on ``device`` (the card by default, raising without one; ``cpu`` for
    CPU ranks), and return their stdout tails; raises on any failure."""
    from ..device import resolve_device

    cmd = [sys.executable, "-m", "karpenter_tpu_torch.parallel.distributed",
           "--device", str(resolve_device(device))]
    return launch_workers(cmd, n_processes, local_devices, timeout=timeout,
                          port=port, retries=retries)


def launch_workers(
    worker_cmd: List[str],
    n_processes: int = 2,
    local_devices: int = 2,
    *,
    timeout: float = 600.0,
    port: int = 0,
    retries: int = 2,
) -> List[str]:
    """Spawn ``n_processes`` copies of ``worker_cmd`` wired into one
    ``torch.distributed`` job and return their stdout tails; raises on
    any failure.  Each worker receives the coordination flags
    (``--coordinator/--num-processes/--process-id/--local-devices``)
    appended to ``worker_cmd``.

    The coordinator port is picked by bind-and-release, which is racy
    (another process can grab it before rank 0 binds), so a launch that
    failed with a bind/connect-shaped error retries with a fresh port up to
    ``retries`` times — but only when the port was auto-picked; explicit
    ports and deterministic worker failures (assertion errors, bad solves)
    surface immediately."""
    last_err: Optional[Exception] = None
    attempts = 1 + (max(0, retries) if port == 0 else 0)
    for _ in range(attempts):
        try:
            return _launch_once(worker_cmd, n_processes, local_devices,
                                timeout, port)
        except RuntimeError as e:
            last_err = e
            msg = str(e).lower()
            if not any(s in msg for s in
                       ("bind", "address already in use", "connect",
                        "unavailable", "deadline", "timed out")):
                raise
    raise last_err


def _launch_once(
    worker_cmd: List[str], n_processes: int, local_devices: int,
    timeout: float, port: int,
) -> List[str]:
    import socket

    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")

    procs = []
    for pid in range(n_processes):
        procs.append(subprocess.Popen(
            list(worker_cmd) + [
                "--coordinator", coordinator,
                "--num-processes", str(n_processes),
                "--process-id", str(pid),
                "--local-devices", str(local_devices)],
            env=env, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    failures = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failures.append(f"worker {pid} timed out after {timeout}s")
        if p.returncode != 0:
            failures.append(
                f"worker {pid} rc={p.returncode}: {out.strip()[-1500:]}")
        outs.append(out.strip())
    if failures:
        raise RuntimeError("; ".join(failures))
    return outs


if __name__ == "__main__":
    raise SystemExit(worker_main())
