"""MAP labeling of a 1-D chain MRF, the labeling problem inside MST; port
of ``rpst.ops.graphcut`` (``chain_map_labeling``, ``potts_pairwise``).

On a chain the MAP labeling is exact by dynamic programming (Viterbi) in
O(C k^2). rpst runs it as two ``lax.scan``s; here a Python loop over the C
nodes (a few dozen channels) on device tensors. ``argmin`` takes the first
index on ties, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch


def chain_map_labeling(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact MAP labels of a chain MRF: d (C, k) per-node label costs, v
    (k, k) pairwise costs between neighbours -> (C,) int32 labels that
    minimize sum_c d[c, l_c] + sum_c v[l_c, l_{c+1}]."""
    m = d[0]
    back = []
    for c in range(1, d.shape[0]):
        trans = m[:, None] + v             # (k_prev, k)
        back.append(torch.argmin(trans, dim=0))
        m = d[c] + trans.min(dim=0).values
    labels = [torch.argmin(m)]
    for b in reversed(back):
        labels.append(b[labels[-1]])
    return torch.stack(labels[::-1]).to(torch.int32)


def potts_pairwise(k: int, lam: float, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """lam (1 - I), the Potts pairwise term."""
    return lam * (torch.ones((k, k), dtype=dtype, device=device)
                  - torch.eye(k, dtype=dtype, device=device))
