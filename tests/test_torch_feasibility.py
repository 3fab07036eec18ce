"""Feasibility of the port against the reference package.

The reference tensorizes a batch whose groups differ in node selectors and
provisioner labels; the same arrays go to ``feasibility_jit`` and to the
port's ``compute_feasibility`` on both of its paths — the chunked gather
(G < 1024) and the bf16 bit-matmul (G >= 1024, rows tiled up).  F and
dom_ok must be bit-equal across all of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models import labels as L
from karpenter_tpu.models.pod import PodSpec
from karpenter_tpu.models.provisioner import Provisioner
from karpenter_tpu.models.tensorize import tensorize
from karpenter_tpu.solver.tpu import feasibility_jit
from karpenter_tpu_torch.ops.feasibility import (
    MATMUL_MIN_G,
    candidate_selector,
    label_feasibility_matmul,
)
from karpenter_tpu_torch.solver.tpu import compute_feasibility

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def st(small_catalog):
    pods = []
    for i in range(40):
        kw = {}
        if i % 3 == 0:
            kw["node_selector"] = {L.ZONE: f"zone-1{'abc'[i % 3]}"}
        if i % 4 == 0:
            kw["node_selector"] = {L.ARCH: "amd64", "team": f"t{i % 5}"}
        if i % 7 == 0:
            kw["node_selector"] = {L.CAPACITY_TYPE: "spot"}
        pods.append(PodSpec(name=f"p{i}", requests={"cpu": 0.5 + (i % 4)},
                            **kw))
    provs = [Provisioner(name="default").with_defaults(),
             Provisioner(name="gpu", labels={"team": "t0"}).with_defaults()]
    return tensorize(pods, provs, small_catalog)


def _tile(st, G):
    """Group-axis arrays tiled up to G rows (same rows, repeated)."""
    reps = -(-G // st.G)
    return dict(
        pm=np.tile(st.pm, (reps, 1, 1))[:G],
        requests=np.tile(st.requests, (reps, 1))[:G],
        gp_ok=np.tile(st.gp_ok, (reps, 1))[:G],
    )


def _ref(st, g):
    F, dom = feasibility_jit(
        jnp.asarray(g["pm"]), jnp.asarray(g["requests"]),
        jnp.asarray(g["gp_ok"]), jnp.asarray(st.cand_vw),
        jnp.asarray(st.cand_vb), jnp.asarray(st.cand_alloc),
        jnp.asarray(st.cand_prov), jnp.asarray(st.key_check),
        jnp.asarray(st.dom_vw), jnp.asarray(st.dom_vb),
        zone_key=st.vocab.key_id[L.ZONE],
        ct_key=st.vocab.key_id[L.CAPACITY_TYPE])
    return np.asarray(F), np.asarray(dom)


def _port(st, g):
    t = torch.from_numpy
    F, dom = compute_feasibility(
        t(g["pm"].astype(np.int64)), t(g["requests"]), t(g["gp_ok"]),
        t(st.cand_vw.astype(np.int64)), t(st.cand_vb.astype(np.int64)),
        t(st.cand_alloc), t(st.cand_prov.astype(np.int64)), t(st.key_check),
        t(st.dom_vw.astype(np.int64)), t(st.dom_vb.astype(np.int64)),
        st.vocab.key_id[L.ZONE], st.vocab.key_id[L.CAPACITY_TYPE])
    return F.numpy(), dom.numpy()


def test_gather_path_equals_reference(st):
    g = _tile(st, st.G)
    F_ref, dom_ref = _ref(st, g)
    F, dom = _port(st, g)
    assert F.any() and not F.all()  # the batch really discriminates
    np.testing.assert_array_equal(F, F_ref)
    np.testing.assert_array_equal(dom, dom_ref)


def test_matmul_path_equals_reference_and_gather(st):
    G = MATMUL_MIN_G + 37
    g = _tile(st, G)
    F_ref, dom_ref = _ref(st, g)
    F, dom = _port(st, g)
    np.testing.assert_array_equal(F, F_ref)
    np.testing.assert_array_equal(dom, dom_ref)
    # the gather path on the same rows (chunks below the matmul switch)
    small = _port(st, {k: v[:st.G] for k, v in g.items()})[0]
    np.testing.assert_array_equal(F[:st.G], small)


def test_label_matmul_equals_label_gather(st):
    from karpenter_tpu_torch.ops.masks import gather_pm_bits

    pm = torch.from_numpy(st.pm.astype(np.int64))
    vw = torch.from_numpy(st.cand_vw.astype(np.int64))
    vb = torch.from_numpy(st.cand_vb.astype(np.int64))
    kc = torch.from_numpy(st.key_check)
    lab_gather = torch.all(gather_pm_bits(pm, vw, vb) | ~kc[None, None, :],
                           dim=2)
    sel = candidate_selector(vw, vb, kc, st.pm.shape[2])
    assert sel.dtype == torch.bfloat16
    lab_matmul = label_feasibility_matmul(pm, sel, kc)
    assert torch.equal(lab_gather, lab_matmul)
