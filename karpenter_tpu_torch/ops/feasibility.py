"""Label feasibility as one matrix product, in PyTorch.

Two device formulations of "group g's requirement mask admits candidate c":

1. **Gather path** (solver/tpu.py compute_feasibility): per-key packed-word
   gathers.  Fine for small G; intermediates are [chunk, C, K].
2. **Matmul path** (here): expand the packed masks to 0/1 bits over the value
   vocabulary and contract in ONE bf16 matmul:

       count[g, c] = pm_bits[g, (k,v)] @ sel[(k,v), c]
       F[g, c]     = (count[g, c] == K)        # K = TOTAL key count

   where ``sel[(k,v), c] = 1`` iff candidate c carries value v for key k, and
   every *unchecked* key (zone/capacity-type, handled on the domain axis)
   contributes exactly 1 on both sides via a constant bit at v=0 — so the
   count target is the total K, not the checked-key count.  Bit counts are
   small integers (at most K), exact in bf16, so this is not an
   approximation.

The product is a plain ``torch.matmul``: it is a large matrix product
outside any hand-written kernel.  solver/tpu.py routes here when
G >= MATMUL_MIN_G; the tests hold both paths bit-equal.
"""

from __future__ import annotations

import torch

#: group count at which compute_feasibility switches from the chunked gather
#: path to the matmul path
MATMUL_MIN_G = 1024

#: per-matmul group chunk bounding the [chunk, K*V] bit expansion
_CHUNK_G = 8192


def candidate_selector(
    cand_vw: torch.Tensor,    # [C, K] value-id // 32
    cand_vb: torch.Tensor,    # [C, K] value-id % 32
    key_check: torch.Tensor,  # [K] bool
    W: int,
) -> torch.Tensor:
    """[K*32W, C] bf16 one-hot selector of each candidate's value per key.

    Unchecked keys select the constant-1 bit at v=0."""
    V = W * 32
    vid = cand_vw.to(torch.int64) * 32 + cand_vb.to(torch.int64)   # [C, K]
    vid_eff = torch.where(key_check[None, :], vid, 0)
    oh = torch.nn.functional.one_hot(vid_eff.t(), V)                # [K, C, V]
    return oh.permute(0, 2, 1).reshape(-1, cand_vw.shape[0]).to(torch.bfloat16)


def label_feasibility_matmul(
    pm: torch.Tensor,         # [G, K, W] packed requirement masks (int64)
    sel: torch.Tensor,        # [K*32W, C] from candidate_selector
    key_check: torch.Tensor,  # [K] bool
) -> torch.Tensor:
    """F_label[G, C]: group g admits candidate c on every checked key."""
    G, K, W = pm.shape
    V = W * 32
    shifts = torch.arange(32, dtype=torch.int64, device=pm.device)

    def chunk(pm_c):
        n = pm_c.shape[0]
        bits = ((pm_c[..., None] >> shifts) & 1).to(torch.bfloat16)
        bits = bits.reshape(n, K, V)
        # unchecked key: zero its vocabulary bits, then emit the constant 1
        bits = torch.where(key_check[None, :, None], bits, 0.0)
        const1 = torch.where(key_check[None, :], bits[:, :, 0], 1.0)
        bits[:, :, 0] = const1
        count = torch.matmul(bits.reshape(n, K * V), sel).to(torch.float32)
        return count >= float(K) - 0.5

    outs = [chunk(pm[i:i + _CHUNK_G]) for i in range(0, G, _CHUNK_G)]
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
