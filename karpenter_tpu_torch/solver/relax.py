"""Helpers of the convex-relaxation rung that the hierarchical price loop
shares: the host feasibility mirror and the mirror-descent step schedule.

The relax rung itself (the reference package's ``solver/relax.py``
``_relax_program``) is not ported yet; :class:`BatchScheduler.solve`
treats ``relax`` as off.  These helpers are numpy float32, as the
reference evaluates them.
"""

from __future__ import annotations

import numpy as np

#: mirror-descent step on the range-normalized subgradient
_ETA = np.float32(1.0)


def mirror_eta(t) -> np.float32:
    """Step size η/√(1+t/8) of the mirror-descent ladder at iteration ``t``,
    in float32 (the reference evaluates it on a float32 scalar)."""
    t = np.float32(t)
    return np.float32(_ETA / np.sqrt(np.float32(1.0) + t / np.float32(8.0)))


def _host_feasibility(st) -> np.ndarray:
    """Numpy mirror of the device feasibility (labels & fit & provisioner)
    — the same semantics as ops/feasibility's gather path, at group
    granularity ([G, C, K] bit gathers)."""
    G, C = st.G, st.C
    if G == 0 or C == 0:
        return np.zeros((G, C), dtype=bool)
    K = st.pm.shape[1]
    vw = np.asarray(st.cand_vw)                      # [C, K]
    vb = np.asarray(st.cand_vb).astype(np.uint32)
    g_idx = np.arange(G)[:, None, None]              # [G, 1, 1]
    k_idx = np.arange(K)[None, None, :]              # [1, 1, K]
    words = np.asarray(st.pm)[g_idx, k_idx, vw[None, :, :]]  # [G, C, K]
    bits = ((words >> vb[None, :, :]) & np.uint32(1)).astype(bool)
    lab = np.all(bits | ~np.asarray(st.key_check)[None, None, :], axis=2)
    req = np.asarray(st.requests, dtype=np.float32)  # [G, R]
    alloc = np.asarray(st.cand_alloc, dtype=np.float32)
    fit = np.all((req[:, None, :] <= alloc[None, :, :] + 1e-6)
                 | (req[:, None, :] <= 0), axis=2)
    gp = np.asarray(st.gp_ok)[np.arange(G)[:, None],
                              np.asarray(st.cand_prov)[None, :]]
    return lab & fit & gp
