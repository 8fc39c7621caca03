"""Plain reference of additive Fourier-accelerated GP training and prediction.

What the benchmark holds the port's outputs against.  Plain torch, on any
device, in float64 unless a `Precision` says otherwise; it imports nothing of
the port and takes nothing the port made but an AFN plan's structure
(afn_reference.py).  From the shared inputs (points, labels, probes,
Nystrom landmarks) it works out again the window geometry, the Fourier
coefficients, the near-field, the preconditioner, the solves, the SLQ
estimate, the loss, its gradient, the Adam steps and the posterior mean.
The Adam steps may start from a given optimizer state (the program's, late
in a window); the residual of a given solve is read on its own operator.

The mathematics (the NFFT4GP reference code, Hitenze/Preconditioned_Additive_
Gaussian_Processes_with_Fourier_Acceleration, SRC/):

- additive kernel  K = f^2 (mean_w k_w + mu I), dK/df = 2 f (mean_w k_w +
  mu I), dK/dl = f^2 mean_w dk_w/dl, dK/dmu = f^2 I;
- each window's kernel as a Fourier sum on the torus: the window's points
  centred and scaled so their radius lies in [1/8, 1/4]; the kernel sampled
  on the (2N)^d torus grid, FFT, the central N modes per dimension
  (k = -N/2 .. N/2 - 1; "trimmed": without k = -N/2); k_w(x_i, x_j) =
  sum_k b_k cos(2 pi k.(x_i - x_j)), applied as an NDFT in exponential form;
- where the configuration states a near-field (Matern-1/2), each window's
  tapered radius correction on every pair within rho (solve_reference.py's
  `NearField`, its pairs found once by the harness), valued at l from the
  coefficients over all N modes, and its d/dl from theirs;
- the stabilized Nystrom preconditioner M = K1 (K11 + nu I)^-1 K1' + eta I,
  eta = mu f^2, nu = sqrt(k) ulp(||K11||_F) of the configuration's working
  precision (float32); dM_mu = f^2 I, the eta derivative left out of dM_f;
  or AFN on the plan's structure (afn_reference.py);
- loss = 0.5 (y'K^-1 y / n + logdet K / n + log 2 pi), K^-1 y by FGMRES
  (Krylov dimension and steps 2 maxits), logdet and tr(K^-1 dK) by
  preconditioned SLQ (maxits Lanczos steps over the probes);
- Adam (beta 0.9, 0.999, eps 1e-8) on the softplus-transformed (f, l, mu);
- the posterior mean K(test, train) K^-1 y, the solve on the train points'
  geometry and the product on the joint [train; test] geometry.

Phase tables are held in the dtype the configuration states for them
(`WindowSpec.table`): a bfloat16 table is the cosines and sines of each
coordinate rounded to bfloat16, whose products are then exact.
"""

import math
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

from .afn_reference import Afn

LOG_2PI = math.log(2.0 * math.pi)
ADAM = dict(alpha=0.01, beta1=0.9, beta2=0.999, eps=1e-8)


class Precision(NamedTuple):
    """dtype: the working dtype; tf32: float32 products on TF32 (the control)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False


REFERENCE = Precision()


@contextmanager
def tf32_mode(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def softplus(x):
    """(softplus(x), d/dx) of the raw hyperparameters."""
    return torch.log1p(torch.exp(x)), torch.sigmoid(x)


def base_kernel(kind: str, r2, l):  # noqa: E741
    """(k(r), dk/dl) on squared distances."""
    if kind == "gaussian":
        k = torch.exp(-r2 / (2.0 * l * l))
        return k, r2 / (l * l * l) * k
    if kind == "matern12":
        r = torch.sqrt(r2)
        k = torch.exp(-r / l)
        return k, r / (l * l) * k
    raise ValueError(f"the reference covers the gaussian and matern12 kernels, not {kind}")


def round_to(x, dtype):
    return x if dtype is None else x.to(dtype).to(x.dtype)


def ulp32(v: float) -> float:
    a = torch.tensor(v, dtype=torch.float32)
    return float(torch.nextafter(a, torch.tensor(float("inf"))) - a)


# --- geometry and coefficients ------------------------------------------------------

class WindowSpec(NamedTuple):
    """One window of the operator: its features, whether the k = -N/2 modes
    are kept and the dtype of its phase tables (None: exact)."""

    feats: tuple
    nyquist: bool
    table: Optional[torch.dtype]


def scaled_points(Xw, dtype):
    """Centre by the mean and scale the radius into [1/8, 1/4]."""
    x = Xw.to(dtype)
    xc = x - torch.mean(x, dim=0)
    radius = float(torch.max(torch.sqrt(torch.sum(xc * xc, dim=1))))
    scale = 0.25 / radius if (radius > 0.25 or radius < 0.125) else 1.0
    return xc * scale, scale


def modes(N: int, nyquist: bool, dtype, device):
    lo = -(N // 2) if nyquist else -(N // 2) + 1
    return torch.arange(lo, N - N // 2, dtype=dtype, device=device)


def coefficients(kind: str, l, scale: float, N: int, d: int, nyquist: bool, oversample: int = 2):
    """(b, db_l) over the kept modes, each (M,)*d, from the kernel sampled on
    the (oversample N)^d torus grid [-1/2, 1/2)^d, in float64."""
    Nos = oversample * N
    dev = l.device
    g = torch.fft.fftfreq(Nos, dtype=torch.float64, device=dev)     # k / Nos
    grids = torch.meshgrid(*([g] * d), indexing="ij")
    r2 = sum(gi * gi for gi in grids) / (scale * scale)
    k, dk = base_kernel(kind, r2, l.to(torch.float64))
    lo = Nos // 2 - N // 2 + (0 if nyquist else 1)
    cut = (slice(lo, Nos // 2 + N - N // 2),) * d
    return tuple(torch.fft.fftshift(torch.fft.fftn(s)).real[cut] / Nos**d for s in (k, dk))


def phase_tables(x, kvec, table_dtype):
    """Per dimension (cos, sin)(2 pi k x_d), (n, M) each, rounded to the
    table dtype."""
    out = []
    for j in range(x.shape[1]):
        ph = 2.0 * math.pi * x[:, j, None].to(torch.float64) * kvec.to(torch.float64)[None, :]
        out.append((round_to(torch.cos(ph), table_dtype).to(x.dtype),
                    round_to(torch.sin(ph), table_dtype).to(x.dtype)))
    return out


# --- the NDFT in exponential form, complex numbers as (re, im) pairs ------------------

def _cmm(a, b):
    return (a[0] @ b[0] - a[1] @ b[1], a[0] @ b[1] + a[1] @ b[0])


def _split_cmm(a, b, parts: int = 64):
    """_cmm of (nv, M, R) by (R, N) over a long R: the R axis cut into
    `parts` slices multiplied as one batch and summed, so that the product
    runs wide on the device rather than as one GEMM with a narrow output."""
    R = a[0].shape[-1]
    if R < 16 * parts:
        return _cmm(a, b)
    r = -(-R // parts)
    pad = r * parts - R

    def cut_a(t):
        t = torch.nn.functional.pad(t, (0, pad))
        return t.reshape(*t.shape[:-1], parts, r).movedim(-2, -3)              # (nv, parts, M, r)

    def cut_b(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(parts, r, t.shape[-1])

    out = _cmm(tuple(cut_a(t) for t in a), tuple(cut_b(t) for t in b))
    return tuple(o.sum(dim=-3) for o in out)


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _outer(a, b):
    """(R, M) x (R, M') -> (R, M M') row-wise outer product of pairs."""
    return tuple(t.reshape(t.shape[0], -1) for t in _cmul((a[0][:, :, None], a[1][:, :, None]),
                                                          (b[0][:, None, :], b[1][:, None, :])))


def _chunk(d: int, n: int, nv: int, M: int) -> int:
    per_row = nv * M ** max(d - 1, 1) + M ** (d - 1)
    return max(1024, min(n, (1 << 26) // per_row))


def ndft_adjoint(E, V):
    """A_k = sum_i V_i prod_d e^{2 pi i k_d x_id} for the rows of V (nv, n):
    (re, im), each (nv, M^d)."""
    d = len(E)
    nv, n = V.shape
    M = E[0][0].shape[1]
    if d == 1:
        re, im = _split_cmm((V[:, None, :], torch.zeros_like(V)[:, None, :]), E[0])
        return re[:, 0], im[:, 0]
    A = None
    step = _chunk(d, n, nv, M)
    for s in range(0, n, step):
        e1 = tuple(t[s:s + step] for t in E[0])
        rest = tuple(t[s:s + step] for t in E[1])
        if d == 3:
            rest = _outer(rest, tuple(t[s:s + step] for t in E[2]))
        P = tuple((t[None] * V[:, s:s + step, None]).transpose(1, 2) for t in e1)   # (nv, M, R)
        part = _split_cmm(P, rest)                                                # (nv, M, M^(d-1))
        A = part if A is None else (A[0] + part[0], A[1] + part[1])
    return A[0].reshape(nv, -1), A[1].reshape(nv, -1)


def ndft_forward(E, G):
    """y_i = Re sum_k G_k prod_d e^{2 pi i k_d x_id} for weight sets G
    ((re, im), each (ns, M^d)): (ns, n)."""
    d = len(E)
    n, M = E[0][0].shape
    ns = G[0].shape[0]
    if d == 1:
        return (E[0][0] @ G[0].T - E[0][1] @ G[1].T).T
    Gm = tuple(g.reshape(ns, M, -1) for g in G)
    y = G[0].new_empty((ns, n))
    step = _chunk(d, n, ns, M)
    for s in range(0, n, step):
        e1 = tuple(t[s:s + step] for t in E[0])
        rest = tuple(t[s:s + step] for t in E[1])
        if d == 3:
            rest = _outer(rest, tuple(t[s:s + step] for t in E[2]))
        T = _cmm((e1[0][None], e1[1][None]), Gm)                                  # (ns, R, M^(d-1))
        y[:, s:s + step] = torch.sum(T[0] * rest[0][None] - T[1] * rest[1][None], dim=2)
    return y


# --- the operator ---------------------------------------------------------------------

class Window:
    """One window's scaled points, phase tables and coefficients, and its
    near-field's values where it has the pairs `nf` (a NearField of its
    scaled points)."""

    def __init__(self, kind, spec: WindowSpec, X, params, N, prec: Precision, eval_rows=None, nf=None):
        self.d = len(spec.feats)
        self.spec = spec
        x, self.scale = scaled_points(X[:, list(spec.feats)], prec.dtype)
        l = params[1]  # noqa: E741
        b, db = coefficients(kind, l, self.scale, N, self.d, spec.nyquist)
        self.b = b.reshape(-1).to(prec.dtype)
        self.db = db.reshape(-1).to(prec.dtype)
        kvec = modes(N, spec.nyquist, prec.dtype, X.device)
        rows = slice(None) if eval_rows is None else eval_rows
        self.E = phase_tables(x[rows], kvec, spec.table)
        self.nf, self.near = nf, None
        if nf is not None:
            full, dfull = coefficients(kind, l, self.scale, N, self.d, nyquist=True)
            self.near = {"k": nf.values(kind, l, full), "l": nf.values(kind, l, dfull, grad=True)}

    def sums(self, V, families):
        """Per family ('k', 'l') the window's kernel sum of the rows of V."""
        A = ndft_adjoint(self.E, V)
        outs = []
        for fam in families:
            w = self.b if fam == "k" else self.db
            out = ndft_forward(self.E, (w * A[0], -w * A[1]))
            if self.near is not None:
                out = out + self.nf.apply(*self.near[fam], V)
            outs.append(out)
        return outs


class AdditiveOperator:
    """K and its gradient rows on the rows of V (nv, n); `nearfield`: each
    window's NearField, or None."""

    def __init__(self, kind, specs, X, params, N, prec: Precision, nearfield=None):
        self.f, self.l, self.mu = params
        nfs = nearfield if nearfield is not None else (None,) * len(specs)
        self.windows = [Window(kind, s, X, params, N, prec, nf=nf) for s, nf in zip(specs, nfs)]

    def _sums(self, V, families):
        acc = [torch.zeros_like(V) for _ in families]
        for win in self.windows:
            for a, s in zip(acc, win.sums(V, families)):
                a += s
        return [a / len(self.windows) for a in acc]

    def matvec(self, V):
        (k,) = self._sums(V, ("k",))
        return self.f * self.f * (k + self.mu * V)

    def grad_matvec(self, V):
        k, dl = self._sums(V, ("k", "l"))
        f2 = self.f * self.f
        return torch.stack([2.0 * self.f * (k + self.mu * V), f2 * dl, f2 * V], dim=1)


# --- preconditioners -------------------------------------------------------------------

def kernel_with_grad(kind, windows, params):
    """kernel(A, B=None) -> (K, dK): the additive kernel f^2 (mean_w k_w + mu I)
    between point sets (..., a, d) and (..., b, d), batched over leading
    dimensions, exact distances, the noise on the diagonal where B is None;
    dK (3, ..., a, b) its derivatives in (f, l, mu)."""
    f, l, mu = params  # noqa: E741

    def kernel(A, B=None):
        same = B is None
        B = A if same else B
        k = dk = 0.0
        for feats in windows:
            D2 = sum(torch.square(A[..., :, j, None] - B[..., None, :, j]) for j in feats)
            kw, dkw = base_kernel(kind, D2, l)
            k, dk = k + kw, dk + dkw
        k, dk = k / len(windows), dk / len(windows)
        eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device) if same else torch.zeros_like(k)
        kmu = k + mu * eye
        return f * f * kmu, torch.stack([2.0 * f * kmu, f * f * dk, (f * f * eye).expand_as(k)])

    return kernel


def additive_kernel(kind, X, Y, windows, l):  # noqa: E741
    """(mean_w k_w, mean_w dk_w/dl) between point sets, exact distances."""
    k = dk = 0.0
    for feats in windows:
        D2 = torch.zeros((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device)
        for f in feats:
            D2 += torch.square(X[:, f, None] - Y[None, :, f])
        kw, dkw = base_kernel(kind, D2, l)
        k, dk = k + kw, dk + dkw
    return k / len(windows), dk / len(windows)


class Nystrom:
    def __init__(self, kind, X, landmarks, windows, params, rank):
        f, l, mu = params  # noqa: E741
        XL = X[landmarks[:rank]]
        kb1, dkb1 = additive_kernel(kind, X, XL, windows, l)
        kb11, dkb11 = additive_kernel(kind, XL, XL, windows, l)
        f2 = f * f
        self.K1, self.dK1 = f2 * kb1, (2.0 * f * kb1, f2 * dkb1)
        K11, self.dK11 = f2 * kb11, (2.0 * f * kb11, f2 * dkb11)
        k = K11.shape[0]
        base = math.sqrt(k) * ulp32(float(torch.linalg.norm(K11)))
        eye = torch.eye(k, dtype=X.dtype, device=X.device)
        for tries in range(4):
            self.L11, info = torch.linalg.cholesky_ex(K11 + base * 10.0 ** (2 * tries) * eye)
            if int(info) == 0:
                break
        # Uf = K1 L^-T through the (k, k) inverse: one triangular solve against
        # all n columns meets a slow path of cuBLAS's trsm at n ~ 1e6
        Linv = torch.linalg.solve_triangular(self.L11, eye, upper=False)
        self.Uf = self.K1 @ Linv.T                                                       # (n, k)
        self.eta, self.f2, self.n, self.k = mu * f2, f2, X.shape[0], k
        C = self.eta * eye + self.Uf.T @ self.Uf
        self.Lc = torch.linalg.cholesky(C)
        self.logdet_C = 2.0 * torch.sum(torch.log(torch.diagonal(self.Lc)))

    def _q(self, B):
        """(K11 + nu I)^-1 B."""
        return torch.cholesky_solve(B, self.L11)

    def solve(self, R):
        """M^-1 on the rows of R (nv, n), Woodbury on eta I + Uf Uf'."""
        Z = torch.cholesky_solve((R @ self.Uf).T, self.Lc).T
        return (R - Z @ self.Uf.T) / self.eta

    def logdet(self):
        return (self.n - self.k) * torch.log(self.eta) + self.logdet_C

    def _dM(self, j, Zc):
        """dM_j on the columns of Zc (n, m), j in {0: f, 1: l}."""
        w = self._q(self.K1.T @ Zc)
        wd = self._q(self.dK1[j].T @ Zc)
        return self.dK1[j] @ w + self.K1 @ wd - self.K1 @ self._q(self.dK11[j] @ w)

    def dvp(self, Z):
        """(nv, 3, n) rows M^-1 dM_j z."""
        outs = [self.solve(self._dM(j, Z.T).T) for j in range(2)]
        outs.append(self.f2 * self.solve(Z))
        return torch.stack(outs, dim=1)

    def trace(self):
        """tr(M^-1 dM_j) for (f, l, mu)."""
        MK1 = self.solve(self.K1.T)                       # (k, n) rows of M^-1 K1
        K1MK1 = MK1 @ self.K1
        out = []
        for j in range(2):
            MdK1 = self.solve(self.dK1[j].T)
            t1 = torch.trace(self._q(MdK1 @ self.K1))     # tr(Q K1' M^-1 dK1)
            t2 = torch.trace(self._q(self.dK11[j] @ self._q(K1MK1)))
            out.append(2.0 * t1 - t2)
        UU = self.Uf.T @ self.Uf
        out.append(self.f2 * (self.n - torch.trace(torch.cholesky_solve(UU, self.Lc))) / self.eta)
        return torch.stack(out)


# --- Krylov ----------------------------------------------------------------------------

def fgmres(matvec, b, psolve, kdim: int, maxits: int, tol: float):
    """Right-preconditioned restarted GMRES with a fixed preconditioner (the
    flexible form's iterate), CGS2, restarts gated on the true residual."""
    n = b.shape[0]
    eps = torch.finfo(b.dtype).eps
    normb = float(torch.linalg.norm(b))
    safe = 1.0 if normb == 0 else normb
    tolb = tol * normb
    x = torch.zeros_like(b)
    r = b
    total = 0
    while True:
        beta = float(torch.linalg.norm(r))
        V = torch.zeros((kdim + 1, n), dtype=b.dtype, device=b.device)
        Z = torch.zeros((kdim, n), dtype=b.dtype, device=b.device)
        V[0] = r / (1.0 if beta == 0 else beta)
        H = torch.zeros((kdim + 1, kdim), dtype=torch.float64)
        j, stop = 0, beta <= tolb
        while j < kdim and not stop:
            Z[j] = psolve(V[j][None])[0]
            w = matvec(Z[j][None])[0]
            h1 = V @ w
            w = w - h1 @ V
            h2 = V @ w
            w = w - h2 @ V
            t = float(torch.linalg.norm(w))
            H[:, j] = (h1 + h2).double().cpu()
            H[j + 1, j] = t
            V[j + 1] = w / (1.0 if t == 0 else t)
            rhs = torch.zeros(j + 2, dtype=torch.float64)
            rhs[0] = beta
            ycol = torch.linalg.lstsq(H[:j + 2, :j + 1], rhs[:, None]).solution
            res = float(torch.linalg.norm(H[:j + 2, :j + 1] @ ycol - rhs[:, None]))
            stop = res <= tolb or t <= eps * safe or total + j + 1 >= maxits
            j += 1
        if j > 0:
            x = x + ycol[:, 0].to(b.dtype).to(b.device) @ Z[:j]
        total += j
        r = b - matvec(x[None])[0]
        if float(torch.linalg.norm(r)) <= tolb or total >= maxits:
            return x, total


def slq(matvec, dmatvec, probes, maxits: int, pre):
    """Preconditioned SLQ: logdet(K)/n and tr(K^-1 dK_j)/n over the probes;
    `pre` has the preconditioners' solve, logdet, trace and dvp.

    Lanczos with full reorthogonalization on each probe; a probe whose
    recursion breaks down (a norm or sqrt(v'w) under eps) stops there, and
    its tridiagonal keeps the steps taken and its leading finite block."""
    nv, n = probes.shape
    dt, dev = probes.dtype, probes.device
    eps = torch.finfo(dt).eps
    V = torch.zeros((nv, maxits + 1, n), dtype=dt, device=dev)
    Z = torch.zeros_like(V)
    v0 = pre.solve(probes)
    beta0 = torch.sqrt(torch.clamp(torch.sum(v0 * probes, dim=1), min=0.0))
    safe0 = torch.where(beta0 == 0, torch.ones_like(beta0), beta0)
    V[:, 0] = v0 / safe0[:, None]
    Z[:, 0] = probes / safe0[:, None]
    TD = torch.ones((nv, maxits), dtype=torch.float64, device=dev)
    TE = torch.zeros((nv, maxits), dtype=torch.float64, device=dev)
    active = beta0 >= eps
    size = torch.zeros(nv, dtype=torch.int64, device=dev)
    for k in range(maxits):
        if not bool(active.any()):
            break
        w = matvec(V[:, k])
        c1 = torch.einsum("vjn,vn->vj", V, w)
        w = w - torch.einsum("vj,vjn->vn", c1, Z)
        c2 = torch.einsum("vjn,vn->vj", V, w)
        w = w - torch.einsum("vj,vjn->vn", c2, Z)
        c = (c1 + c2).double()
        t = torch.linalg.norm(w, dim=1)
        vn = pre.solve(w)
        s = torch.sqrt(torch.clamp(torch.sum(vn * w, dim=1), min=0.0))
        break1, break2 = t < eps, s < eps
        keep = (active & ~break1 & ~break2)[:, None]
        safe = torch.where(s == 0, torch.ones_like(s), s)[:, None]
        V[:, k + 1] = torch.where(keep, vn / safe, 0.0)
        Z[:, k + 1] = torch.where(keep, w / safe, 0.0)
        rec = active & ~break1
        TD[:, k] = torch.where(rec, c[:, k], TD[:, k])
        if k > 0:
            TE[:, k - 1] = torch.where(rec, c[:, k - 1], TE[:, k - 1])
        size = size + active.to(size.dtype)
        active = active & ~break1 & ~break2
    idx = torch.arange(maxits, device=dev)
    finite = torch.isfinite(TD) & torch.isfinite(TE)
    first_bad = torch.min(torch.where(~finite, idx, maxits), dim=1).values
    size = torch.minimum(size, first_bad)
    TD = torch.where(idx[None] < size[:, None], TD, 1.0)
    TE = torch.where(idx[None] < size[:, None] - 1, TE, 0.0)
    T = torch.diag_embed(TD) + torch.diag_embed(TE[:, :-1], 1) + torch.diag_embed(TE[:, :-1], -1)
    theta, Q = torch.linalg.eigh(T)
    vals = torch.sum(Q[:, 0, :] ** 2 * torch.log(torch.abs(theta)), dim=1).to(dt)
    e1 = torch.zeros((nv, maxits, 1), dtype=torch.float64, device=dev)
    e1[:, 0, 0] = beta0.double()
    y = torch.where(idx[None] < size[:, None], torch.linalg.solve(T, e1)[:, :, 0], 0.0).to(dt)
    x = torch.einsum("vj,vjn->vn", y, V[:, :maxits])
    x = torch.where(torch.isfinite(x), x, 0.0)
    dvals = torch.einsum("vpn,vn->vp", dmatvec(probes), x) - torch.einsum("vpn,vn->vp", pre.dvp(probes), probes)
    logdet = torch.mean(vals) + pre.logdet() / n
    dlogdet = torch.mean(dvals, dim=0) / n + pre.trace() / n
    return logdet, dlogdet


# --- the problem ------------------------------------------------------------------------

class Problem(NamedTuple):
    """The shared inputs and the configuration's settings."""

    kind: str
    X: torch.Tensor                 # (n, d) as served (float32)
    y: torch.Tensor
    probes: torch.Tensor            # (nvecs, n) Rademacher
    landmarks: torch.Tensor         # Nystrom landmark indices
    specs: tuple                    # WindowSpec per window
    N: int = 32
    rank: int = 50
    maxits: int = 10
    tol: float = 1e-6
    precond: str = "nystrom"        # "nystrom" (on the landmarks) | "afn" (on the plan)
    plan: Optional[object] = None   # afn_reference.Plan: AFN's structure
    nearfield: Optional[tuple] = None   # per window its NearField, in the working dtype; None: no near-field


def preconditioner(prob: Problem, X, params):
    """The configuration's preconditioner at params, on X in the working dtype."""
    windows = [s.feats for s in prob.specs]
    if prob.precond == "afn":
        return Afn(kernel_with_grad(prob.kind, windows, params), X, prob.plan)
    if prob.precond != "nystrom":
        raise ValueError(f"the reference covers the nystrom and afn preconditioners, not {prob.precond}")
    return Nystrom(prob.kind, X, prob.landmarks, windows, params, prob.rank)


def _params(raw, prec, device):
    val, dval = softplus(raw.to(device=device, dtype=torch.float64))
    return tuple(v.to(prec.dtype) for v in val), dval.to(prec.dtype)


def loss_and_grad(prob: Problem, raw, prec: Precision = REFERENCE):
    """(loss, grad (3,)) at the raw hyperparameters."""
    with tf32_mode(prec.tf32):
        X, y = prob.X.to(prec.dtype), prob.y.to(prec.dtype)
        params, dt = _params(raw, prec, X.device)
        n = X.shape[0]
        op = AdditiveOperator(prob.kind, prob.specs, X, params, prob.N, prec, prob.nearfield)
        pre = preconditioner(prob, X, params)
        its = min(n, 2 * prob.maxits)
        iky, _ = fgmres(op.matvec, y, pre.solve, its, its, prob.tol)
        L1 = torch.dot(y, iky) / n
        L1_grad = (op.grad_matvec(iky[None])[0] @ iky) / n * dt
        logdet, dlogdet = slq(op.matvec, op.grad_matvec, prob.probes.to(prec.dtype), min(n, prob.maxits), pre)
        loss = 0.5 * (L1 + logdet + LOG_2PI)
        grad = 0.5 * (-L1_grad + dlogdet * dt)
    return loss.double(), grad.double()


class AdamStart(NamedTuple):
    """An Adam state to step from: the raw hyperparameters, both moments and
    the steps taken."""

    x: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: int


def adam_steps(prob: Problem, start: AdamStart, steps: int, prec: Precision = REFERENCE):
    """`steps` Adam steps from `start`: (losses, the gradient of the first
    step, raw after the last step)."""
    x, m, v = (a.to(device=prob.X.device, dtype=torch.float64).clone() for a in (start.x, start.m, start.v))
    losses, g1 = [], None
    for t in range(start.t + 1, start.t + steps + 1):
        loss, g = loss_and_grad(prob, x, prec)
        g = g.to(x.device)
        losses.append(float(loss))
        g1 = g if g1 is None else g1
        m = ADAM["beta1"] * m + (1.0 - ADAM["beta1"]) * g
        v = ADAM["beta2"] * v + (1.0 - ADAM["beta2"]) * g * g
        mh = m / (1.0 - ADAM["beta1"] ** t)
        vh = v / (1.0 - ADAM["beta2"] ** t)
        x = x - ADAM["alpha"] * mh / (torch.sqrt(vh) + ADAM["eps"])
    return losses, g1, x


def solve_residual(prob: Problem, raw, solution, prec: Precision = REFERENCE):
    """||y - K x|| / ||y|| of a solve's answer x for K y at the raw
    hyperparameters; an answer shorter than y is taken as zero past its end."""
    with tf32_mode(prec.tf32):
        X, y = prob.X.to(prec.dtype), prob.y.to(prec.dtype)
        params, _ = _params(raw, prec, X.device)
        x = torch.zeros_like(y)
        sol = solution.to(device=y.device, dtype=prec.dtype).reshape(-1)[: y.shape[0]]
        x[: sol.shape[0]] = sol
        op = AdditiveOperator(prob.kind, prob.specs, X, params, prob.N, prec, prob.nearfield)
        return float(torch.linalg.norm(y - op.matvec(x[None])[0]) / torch.linalg.norm(y))


def posterior_mean(prob: Problem, raw, tests, maxits: int, prec: Precision = REFERENCE):
    """Posterior means at each test set of `tests`: the solve on the train
    points, the product on the joint [train; test] geometry."""
    with tf32_mode(prec.tf32):
        X, y = prob.X.to(prec.dtype), prob.y.to(prec.dtype)
        params, _ = _params(raw, prec, X.device)
        n = X.shape[0]
        op = AdditiveOperator(prob.kind, prob.specs, X, params, prob.N, prec)
        pre = preconditioner(prob, X, params)
        its = min(n, maxits)
        x, _ = fgmres(op.matvec, y, pre.solve, its, its, prob.tol)
        del op, pre
        f, l, _mu = params  # noqa: E741
        means = []
        for Xt in tests:
            Xall = torch.cat([X, Xt.to(prec.dtype)])
            acc = torch.zeros(Xt.shape[0], dtype=prec.dtype, device=X.device)
            for s in prob.specs:
                tr = Window(prob.kind, s, Xall, params, prob.N, prec, eval_rows=slice(0, n))
                te = Window(prob.kind, s, Xall, params, prob.N, prec, eval_rows=slice(n, None))
                A = ndft_adjoint(tr.E, x[None])
                acc += ndft_forward(te.E, (tr.b * A[0], -tr.b * A[1]))[0]
            means.append((f * f * acc / len(prob.specs)).double())
    return means
