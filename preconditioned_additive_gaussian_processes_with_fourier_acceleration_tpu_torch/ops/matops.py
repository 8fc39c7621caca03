"""Dense and padded-ELL matrix helpers (port of ops/matops.py: the dense
solves and the ELL products of the near-field)."""

import torch


def stable_chol(K, extra_shift: float = 0.0):
    """Cholesky with the reference's stabilization shift and escalation.

    nu = sqrt(n) * ulp(||K||_F) is added to the diagonal (ref chol.c:448-464);
    while the factorization fails the shift escalates x1e2, x1e4, x1e6 and the
    first good factor wins.  Returns (L, nu).
    """
    n = K.shape[0]
    fro = torch.linalg.norm(K)
    ulp = torch.nextafter(fro, torch.full_like(fro, float("inf"))) - fro
    base = float(n) ** 0.5 * ulp + extra_shift
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + base * eye)
    nu, tries = base, 1.0
    while int(info) != 0 and tries < 4:
        nu = base * 10.0 ** (2.0 * tries)
        L, info = torch.linalg.cholesky_ex(K + nu * eye)
        tries += 1.0
    if int(info) != 0:
        L = torch.full_like(K, float("nan"))
    return L, nu


def _solve_tri(A, b, upper: bool):
    vec = b.ndim == 1
    x = torch.linalg.solve_triangular(A, b[:, None] if vec else b, upper=upper)
    return x[:, 0] if vec else x


def tril_solve(L, b):
    """Solve L x = b for lower-triangular L; b is (n,) or (n, m)."""
    return _solve_tri(L, b, upper=False)


def triu_solve(L, b):
    """Solve L^T x = b for lower-triangular L."""
    return _solve_tri(L.T, b, upper=True)


def chol_solve(L, b):
    """Solve (L L^T) x = b by two triangular solves (ref chol.c:111-137)."""
    return triu_solve(L, tril_solve(L, b))


# --- padded-ELL sparse matrices ------------------------------------------------
# Row i of G is stored as idx[i] (n, lfil) column indices and val[i] values;
# padded slots carry value 0.  Plain torch gathers and index_add: the JAX
# package computes these outside any Pallas kernel too (its TPU-tuned row
# gather, _gather_vec, is a plain x[idx] here).

def ell_matvec(idx, val, x):
    """y = G x: gather + row-wise dot."""
    return torch.sum(val * x[idx], dim=1)


def ell_matvec_batch(idx, val, Xb):
    """y[r] = G x_r for a batch Xb (nv, n): one row gather of the (n, nv)
    transposed batch serves every right-hand side."""
    G = Xb.T[idx.reshape(-1)].reshape(*idx.shape, Xb.shape[0])
    return torch.einsum("is,isv->vi", val, G)


def ell_rmatvec(idx, val, x, n=None):
    """y = G' x: scatter-add."""
    n = n if n is not None else x.shape[0]
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx.reshape(-1), (val * x[:, None]).reshape(-1))


def ell_rmatvec_batch(idx, val, Xb, n=None):
    """y[r] = G' x_r for a batch Xb (nv, n): one row-wise scatter-add of the
    (n * lfil, nv) contributions."""
    nv = Xb.shape[0]
    n = n if n is not None else Xb.shape[1]
    contrib = val[:, :, None] * Xb.T[:, None, :]              # (rows, lfil, nv)
    out = torch.zeros((n, nv), dtype=Xb.dtype, device=Xb.device)
    return out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, nv)).T
