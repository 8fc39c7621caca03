"""Dense matrix helpers (port of the dense part of ops/matops.py)."""

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
