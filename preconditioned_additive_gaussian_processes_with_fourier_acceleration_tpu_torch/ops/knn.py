"""KNN sparsity pattern (port of ops/knn.py).

Rebuild of Nfft4GPDistanceEuclidKnn (ref SRC/linearalg/kernels.c:121-403):
for each point i the lfil-1 nearest *preceding* points (j < i), a
lower-triangular pattern, with i itself as the last entry of the row.

Output is padded-ELL: idx (n, lfil) (padded slots = i, the row's own
index), mask (n, lfil) bool; slot lfil-1 always holds the diagonal i.
"""

import numpy as np
import torch


def knn_pattern(X, lfil: int, *, block: int = 1024, col_block: int = 32768):
    """Lower-triangular KNN pattern, on X's device.

    Row blocks against column blocks: each (block, col_block) distance tile
    is one GEMM, masked to j < i, merged into a running top-k; peak memory
    O(block * col_block).  Column blocks wholly at or past a row block's
    last row hold no preceding point and are skipped.  Returns (idx int64,
    mask bool), (n, lfil) each, the selected indices index-ascending like
    the reference's CSR rows.
    """
    n, _d = X.shape
    k = lfil - 1
    dev = X.device
    self_col = torch.arange(n, device=dev)[:, None]
    if k == 0:
        return self_col.clone(), torch.ones((n, 1), dtype=torch.bool, device=dev)
    cb = min(col_block, n)
    xx = torch.sum(X * X, dim=1)
    idx_parts, mask_parts = [], []
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(r0 + block, n), device=dev)
        Xb = X[rows]
        bxx = xx[rows][:, None]
        best_d = torch.full((rows.shape[0], k), float("inf"), dtype=X.dtype, device=dev)
        best_i = torch.zeros((rows.shape[0], k), dtype=torch.int64, device=dev)
        for c0 in range(0, min(n, r0 + block - 1), cb):
            cols = torch.arange(c0, min(c0 + cb, n), device=dev)
            d2 = bxx + xx[cols][None, :] - 2.0 * (Xb @ X[cols].T)
            d2 = torch.where(cols[None, :] < rows[:, None], d2, float("inf"))
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, cols[None, :].expand(rows.shape[0], -1)], dim=1)
            best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, sel)
        kmask = torch.isfinite(best_d)
        order = torch.argsort(torch.where(kmask, best_i, n + 1), dim=1)
        idx_parts.append(torch.gather(best_i, 1, order))
        mask_parts.append(torch.gather(kmask, 1, order))
    mask = torch.cat(mask_parts)
    idx = torch.where(mask, torch.cat(idx_parts), self_col)
    idx = torch.cat([idx, self_col], dim=1)
    mask = torch.cat([mask, torch.ones((n, 1), dtype=torch.bool, device=dev)], dim=1)
    return idx, mask


def knn_pattern_host(X, lfil: int):
    """Host k-d tree variant of knn_pattern (scipy.spatial.cKDTree).

    Same output contract, as numpy (idx int32, mask bool).  Preceding
    neighbours come from a widening overall-KNN query (k doubles until every
    row has enough preceding candidates or the whole prefix is used), run
    on all host cores.
    """
    from scipy.spatial import cKDTree

    X = np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X)
    n, _d = X.shape
    k = lfil - 1
    idx = np.full((n, k), 0, np.int64)
    mask = np.zeros((n, k), bool)
    if k > 0 and n > 1:
        tree = cKDTree(X)
        todo = np.arange(1, n)
        kq = min(max(4 * lfil, 64), n)
        while todo.size:
            _, nb = tree.query(X[todo], k=kq, workers=-1)
            nb = np.atleast_2d(nb)
            prec = nb < todo[:, None]
            cnt = prec.sum(axis=1)
            enough = (cnt >= np.minimum(k, todo)) | (kq >= n)
            rows = todo[enough]
            nb_e = nb[enough]
            prec_e = prec[enough]
            # first k preceding per row, in query (distance) order
            order = np.argsort(~prec_e, axis=1, kind="stable")
            nb_sel = np.take_along_axis(nb_e, order[:, :k], axis=1)
            ok = np.take_along_axis(prec_e, order[:, :k], axis=1)
            nb_sel = np.where(ok, nb_sel, n + 1)
            nb_sel.sort(axis=1)                  # reference rows are index-sorted
            got = nb_sel <= n
            idx[rows] = np.where(got, nb_sel, 0)
            mask[rows] = got
            todo = todo[~enough]
            kq = min(kq * 2, n)
    self_col = np.arange(n, dtype=np.int64)[:, None]
    idx = np.where(mask, idx, self_col)
    idx = np.concatenate([idx, self_col], axis=1)
    mask = np.concatenate([mask, np.ones((n, 1), bool)], axis=1)
    return idx.astype(np.int32), mask
