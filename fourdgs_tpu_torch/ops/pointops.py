"""Point-cloud op library: the reference's `pointops2` CUDA extension
(`pointops2/functions/pointops.py`) as torch functions.

PyTorch counterpart of `fourdgs_tpu/ops/pointops.py`, with its signatures
and index dtypes (int32 indices). The trainer uses only `knn` (the rigid
loss, `train.py:138-140`) and `fps` (a commented-out init path,
`dataset_readers.py:341`); grouping, interpolation, subtraction,
aggregation and the Point Transformer attention ops are here for API
parity. "offset"-batched inputs (the pointops2 convention) map to a
leading batch axis. Ties in the nearest-neighbour and furthest-point
selections go to the lowest index, as `jax.lax.top_k` and `jnp.argmax`
give them.
"""

from __future__ import annotations

import torch

from .knn import knn as _knn_flat


def _nearest(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of d2 (..., M), nearest first,
    the lowest index first among equals: (idx int32, values)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), vals[..., :k]


def knn(x: torch.Tensor, src: torch.Tensor, k: int):
    """k nearest neighbours of each query in `x` among `src`.

    x: (B, N, 3), src: (B, M, 3). Returns (idx (B, N, k) int32, dist
    (B, N, k) EUCLIDEAN distance: the reference wrapper returns sqrt'd
    dist2, `pointops.py:48`). Exact O(N·M) per batch."""
    d2 = torch.sum((x[:, :, None, :] - src[:, None, :, :]) ** 2, dim=-1)
    idx, vals = _nearest(d2, k)
    return idx, torch.sqrt(torch.clamp(vals, min=0.0))


def knn_self(points: torch.Tensor, k: int,
             valid: torch.Tensor | None = None):
    """Self-kNN over one unbatched cloud (window-approximate for large N);
    see `ops.knn.knn`. Returns (idx, dist2)."""
    return _knn_flat(points, k=k, valid=valid)


def fps(points: torch.Tensor, k: int) -> torch.Tensor:
    """Furthest point sampling: (N, 3) → (k,) int32 indices. Start at
    index 0, then repeatedly take the point farthest from the selected
    set (reference `furthestsampling`)."""
    n = points.shape[0]
    idx = torch.zeros(k, dtype=torch.int32, device=points.device)
    mind2 = torch.full((n,), float("inf"), dtype=points.dtype,
                       device=points.device)
    for i in range(1, k):
        d2 = torch.sum((points - points[idx[i - 1]]) ** 2, dim=-1)
        mind2 = torch.minimum(mind2, d2)
        # The first of the largest, as jnp.argmax (torch.argmax's rule).
        idx[i] = torch.argmax(mind2)
    return idx


def grouping(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features: feats (M, C), idx (N, k) → (N, k, C)
    (reference `grouping`, `pointops.py:70-90`)."""
    return feats[idx.long()]


def interpolation(src_xyz: torch.Tensor, dst_xyz: torch.Tensor,
                  feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance-weighted k-NN feature interpolation (reference
    `interpolation`): src (M, 3) with feats (M, C) → features at dst
    (N, 3)."""
    d2 = torch.sum((dst_xyz[:, None, :] - src_xyz[None, :, :]) ** 2, -1)
    idx, vals = _nearest(d2, k)
    dist = torch.sqrt(torch.clamp(vals, min=1e-12))
    w = 1.0 / (dist + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum("nk,nkc->nc", w, feats[idx.long()])


def subtraction(a: torch.Tensor, b: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour feature difference: a (N, C), b (M, C), idx (N, k) →
    (N, k, C) with out[n, j] = a[n] − b[idx[n, j]]."""
    return a[:, None, :] - b[idx.long()]


def aggregation(feats: torch.Tensor, weights: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour aggregation: feats (M, C), weights (N, k), idx
    (N, k) → (N, C)."""
    return torch.einsum("nk,nkc->nc", weights, feats[idx.long()])


# ---------------------------------------------------------------------------
# Sparse point-attention ops (Point Transformer V2 family), bound by the
# reference from pointops2 and never called by the 4DGS trainer
# (`pointops_api.cpp:16-45`). Edge pairs are COO: edge m relates query
# index0[m] to key/value index1[m]. Differentiable through autograd: the
# gather and index_add forms give the reference's scatter backward.
# ---------------------------------------------------------------------------

def _segment_sum(x: torch.Tensor, segment: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, segment.long(), x)


def attention_step1(q: torch.Tensor, k: torch.Tensor, index0: torch.Tensor,
                    index1: torch.Tensor) -> torch.Tensor:
    """Per-edge attention logits: q (N, h, d), k (N, h, d), index0/index1
    (M,) → (M, h), out[m, h] = q[index0[m], h] · k[index1[m], h]."""
    return torch.einsum("mhd,mhd->mh", q[index0.long()], k[index1.long()])


def attention_step2(attn: torch.Tensor, v: torch.Tensor,
                    index0: torch.Tensor, index1: torch.Tensor,
                    n: int | None = None) -> torch.Tensor:
    """Weighted value aggregation: attn (M, h), v (N, h, d) → (N, h, d),
    out[n] = Σ_{m: index0[m] = n} attn[m] · v[index1[m]]."""
    n = n or v.shape[0]
    return _segment_sum(attn[:, :, None] * v[index1.long()], index0, n)


def _rel_table_sum(table: torch.Tensor, rel_idx: torch.Tensor):
    """(L, h, d, 3), (M, 3) → (M, h, d): the per-axis table rows summed
    (`relative_pos_encoding_cuda_kernel_v2.cu:276-279`)."""
    rel = rel_idx.long()
    return sum(table[rel[:, a], :, :, a] for a in range(3))


def dot_prod_with_idx(q: torch.Tensor, index: torch.Tensor,
                      table: torch.Tensor,
                      rel_idx: torch.Tensor) -> torch.Tensor:
    """Relative-position logits: q (N, h, d), index (M,), table
    (L, h, d, 3), rel_idx (M, 3) → (M, h), out[m, h] = Σ_d Σ_a
    q[index[m], h, d] · table[rel_idx[m, a], h, d, a]."""
    rel = rel_idx.long()
    pos = torch.stack([table[rel[:, a], :, :, a] for a in range(3)], -1)
    return torch.einsum("mhd,mhda->mh", q[index.long()], pos)


def attention_step2_with_rel_pos_value(
        attn: torch.Tensor, v: torch.Tensor, index0: torch.Tensor,
        index1: torch.Tensor, table: torch.Tensor, rel_idx: torch.Tensor,
        n: int | None = None) -> torch.Tensor:
    """attention_step2 with per-edge relative positional values added to
    v: table (L, h, d, 3), rel_idx (M, 3)."""
    n = n or v.shape[0]
    contrib = attn[:, :, None] * (v[index1.long()]
                                  + _rel_table_sum(table, rel_idx))
    return _segment_sum(contrib, index0, n)


# ---- v2/v3 variants: CSR query index (`index0_offsets`, N_q + 1 exclusive
# starts) instead of the COO index0 column; decoded to COO here. `n_max`
# (the reference's CUDA block-size bound) is accepted and ignored.

def _csr_to_coo(offsets: torch.Tensor, m: int) -> torch.Tensor:
    """index0_offsets (N + 1,) → the query index of each edge (m,)."""
    edges = torch.arange(m, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, edges, right=True) - 1).to(
        torch.int32)


def attention_step1_v2(q: torch.Tensor, k: torch.Tensor,
                       index1: torch.Tensor, index0_offsets: torch.Tensor,
                       n_max: int | None = None) -> torch.Tensor:
    """CSR attention_step1 (reference `pointops.py:142-203`)."""
    del n_max
    index0 = _csr_to_coo(index0_offsets, index1.shape[0])
    return attention_step1(q, k, index0, index1)


def attention_step2_v2(attn: torch.Tensor, v: torch.Tensor,
                       index0: torch.Tensor, index1: torch.Tensor,
                       n: int | None = None) -> torch.Tensor:
    """attention_step2 with output length max(index0) + 1 by default: COO
    in the reference too (`pointops.py:268-318`)."""
    if n is None:
        n = int(index0.max()) + 1
    return attention_step2(attn, v, index0, index1, n)


def dot_prod_with_idx_v2(q: torch.Tensor, index_q: torch.Tensor,
                         k: torch.Tensor, index_k: torch.Tensor,
                         table_q: torch.Tensor, table_k: torch.Tensor,
                         rel_idx: torch.Tensor) -> torch.Tensor:
    """Two-sided relative-position logits (reference `pointops.py:372-443`):
    out[m, h] = q[index_q[m]] · table_q(rel_idx[m]) + k[index_k[m]] ·
    table_k(rel_idx[m])."""
    return (torch.einsum("mhd,mhd->mh", q[index_q.long()],
                         _rel_table_sum(table_q, rel_idx))
            + torch.einsum("mhd,mhd->mh", k[index_k.long()],
                           _rel_table_sum(table_k, rel_idx)))


def dot_prod_with_idx_v3(q: torch.Tensor, index_q_offsets: torch.Tensor,
                         n_max: int | None, k: torch.Tensor,
                         index_k: torch.Tensor, table_q: torch.Tensor,
                         table_k: torch.Tensor,
                         rel_idx: torch.Tensor) -> torch.Tensor:
    """dot_prod_with_idx_v2 with a CSR query index (reference
    `pointops.py:446-519`)."""
    del n_max
    index_q = _csr_to_coo(index_q_offsets, index_k.shape[0])
    return dot_prod_with_idx_v2(q, index_q, k, index_k, table_q, table_k,
                                rel_idx)


def attention_step2_with_rel_pos_value_v2(
        attn: torch.Tensor, v: torch.Tensor, index0_offsets: torch.Tensor,
        n_max: int | None, index1: torch.Tensor, table: torch.Tensor,
        rel_idx: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """CSR attention_step2_with_rel_pos_value (reference
    `pointops.py:584-646`)."""
    del n_max
    index0 = _csr_to_coo(index0_offsets, index1.shape[0])
    return attention_step2_with_rel_pos_value(attn, v, index0, index1,
                                              table, rel_idx, n)
