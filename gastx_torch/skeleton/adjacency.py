"""Graph adjacency builders for the lifting model.

Parity targets:
  * ``adj_from_edges`` / ``adj_from_skeleton``: reference
    ``common/graph_utils.py:27-45`` (symmetrized, self-looped, row-normalized
    dense adjacency) — rebuilt in plain numpy (no scipy/torch needed for a
    J×J dense matrix).
  * ``local_adjacencies``: the hand-crafted symmetric-pair and
    connection (1st-order at non-distal + 2nd-order at distal joints)
    adjacencies built inside ``model/local_attention.py:92-114``.

Note: the semantic graph conv only consumes the *sparsity pattern* of these
matrices (``adj > 0`` mask, model/local_attention.py:24); the row-normalized
values never reach the model, so float precision here is irrelevant.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from gastx_torch.skeleton.layouts import JointLayout
from gastx_torch.skeleton.skeleton import Skeleton


def _row_normalize(mx: np.ndarray) -> np.ndarray:
    rowsum = mx.sum(axis=1)
    r_inv = np.where(rowsum > 0, 1.0 / np.where(rowsum > 0, rowsum, 1.0), 0.0)
    return mx * r_inv[:, None]


def adj_from_edges(num_pts: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Dense normalized adjacency: rownorm(max(A, A^T) + I), float32."""
    a = np.zeros((num_pts, num_pts), dtype=np.float32)
    for i, j in edges:
        a[i, j] = 1.0
    a = np.maximum(a, a.T)
    return _row_normalize(a + np.eye(num_pts, dtype=np.float32)).astype(np.float32)


def adj_from_skeleton(skeleton: Skeleton) -> np.ndarray:
    """Normalized adjacency from (child, parent) bone edges."""
    edges = [(i, int(p)) for i, p in enumerate(skeleton.parents()) if p >= 0]
    return adj_from_edges(skeleton.num_joints(), edges)


def local_adjacencies(layout: JointLayout) -> Tuple[np.ndarray, np.ndarray]:
    """Build (adj_sym, adj_con) for the LocalGraph of a given joint layout.

    adj_sym: identity plus left<->right mirror pairs
    (model/local_attention.py:92-102).
    adj_con: 1st-order normalized adjacency with distal-joint rows zeroed,
    plus 2nd-order adjacency kept only at distal-joint rows
    (model/local_attention.py:104-114).
    """
    adj = adj_from_skeleton(layout.skeleton())
    j = layout.num_joints
    left, right = list(layout.joints_left), list(layout.joints_right)
    distal = set(layout.distal_joints)

    adj_sym = np.eye(j, dtype=np.float32)
    for li, ri in zip(left, right):
        adj_sym[li, ri] = 1.0
        adj_sym[ri, li] = 1.0

    adj_1st = adj.copy()
    adj_1st[list(sorted(distal))] = 0.0

    adj_2nd = (adj @ adj).astype(np.float32)
    non_distal = [i for i in range(j) if i not in distal]
    adj_2nd[non_distal] = 0.0

    return adj_sym, adj_1st + adj_2nd
