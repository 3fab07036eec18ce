"""Pending sets from a configuration, a traffic mix and ``--seed``.

A configuration's ``pending`` block fixes the deployments of one pending
set: how many, their replicas, the cpu and memory values they take and
their zone spread.  The traffic's ``sets`` says how many distinct sets a
run offers: set ``k`` pairs the ``d``-th cpu value with the memory value
``(d + k) mod n`` places on, so every set asks for the same total cpu and
memory.  The seed orders the deployments within each set and the sets
among themselves (which one a run offers first): every seed runs the
same work, in another order.  Pure Python
and numpy; the harness turns a set into the program's pod objects
(``inputs.py``).
"""

from __future__ import annotations

import numpy as np

GIB = 1024.0 ** 3


def pending_sets(config: dict, traffic: dict, seed: int) -> list:
    """``traffic["sets"]`` pending sets, each ``{"id", "deployments"}``
    with a deployment ``{"name", "cpu", "memory" (bytes), "replicas",
    "max_skew"}``; the same seed gives the same sets."""
    spec = config["pending"]
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    cpus = np.asarray(spec["cpu"], dtype=np.float64)
    mems = np.asarray(spec["memory_gib"], dtype=np.float64)
    n_dep = spec["deployments"]
    if len(cpus) != n_dep or len(mems) != n_dep:
        raise ValueError("a configuration gives one cpu and one memory "
                         "value per deployment")
    spread = spec.get("zone_spread")
    n_sets = traffic["sets"]
    out = []
    for s, k in enumerate(rng.permutation(n_sets)):
        pairs = [(cpus[d], mems[(d + k) % n_dep]) for d in range(n_dep)]
        order = rng.permutation(n_dep)
        out.append({"id": s, "deployments": [
            {"name": f"s{s}-d{j}", "cpu": float(pairs[d][0]),
             "memory": float(pairs[d][1]) * GIB,
             "replicas": spec["replicas"],
             "max_skew": spread["max_skew"] if spread else None}
            for j, d in enumerate(order)]})
    return out
