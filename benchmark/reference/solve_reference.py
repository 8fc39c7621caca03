"""Plain reference of a kernel solve on the near-field-corrected Fourier operator.

What the benchmark holds a solve's answer x of A x = b against.  Plain
torch, on any device, in float64 unless a `Precision` says otherwise; it
imports nothing of the port and takes nothing the port made.  From the
sites alone it works out again the scaled points, the Fourier
coefficients, the near-field pairs and their values, and applies three
things: the operator the configuration states, the dense kernel, and a
plain conjugate gradient on the operator (the control's solver).

The mathematics (the NFFT4GP reference code, Hitenze/Preconditioned_Additive_
Gaussian_Processes_with_Fourier_Acceleration, SRC/external/nfft_interface.c:
265-398 for the Matern-1/2 fastsum; AFN_PCG.md section 1 for the tapered
radius near-field), per feature window w of one or two features, with
K = f^2 (mean_w k_w + mu I):

- the dense kernel: k_w(x_i, x_j) = exp(-r / l), r the distance of the
  window's features;
- its Fourier sum: the window's points centred and scaled so that their
  radius lies in [1/8, 1/4] (factor s); k sampled at r = |g| / s on the
  (2N)^d grid g of [-1/2, 1/2)^d, FFT, the central N modes a dimension
  (k = -N/2 .. N/2 - 1), each coefficient b_k clipped at 0 where the
  configuration states `psd_clip` (the true spectrum is positive);
- the far field sum_k b_k cos(2 pi k.(x_i - x_j)) over the modes without a
  k_d = -N/2 ("trimmed"), applied as an NDFT in exponential form;
- the near-field: on every pair i, j (i = j included) at most rho apart in
  scaled coordinates, the exact kernel minus the Fourier sum over all N
  modes a dimension, weighted by (1 - |x_i - x_j| / rho)^2, one rho for
  all pairs, so the correction is symmetric; rho is the pitch of a grid
  over the points' bounding box that holds max(4, nf_lfil / 3) points a
  cell on average: (volume max(4, nf_lfil / 3) / n)^(1/d);
- the operator A = f^2 (mean_w (far_w + near_w) + mu I).

The near-field's Fourier sum at an offset D is evaluated in cosines and
sines of |k| (k -> -k folded, exact), two products over the pairs.
"""

import math
from typing import NamedTuple

import torch

from . import gp_reference as gr

Precision = gr.Precision
REFERENCE = gr.REFERENCE
ROW_BLOCK = 2048          # rows of a dense block (the pair search, the dense kernel)
PAIR_CHUNK = 1 << 19      # pairs a step of the near-field's Fourier sum


class Spec(NamedTuple):
    """The operator a configuration states."""

    kind: str
    windows: tuple        # feature indices of each window, one or two a window
    f: float
    l: float              # noqa: E741
    mu: float
    N: int                # Fourier modes a dimension
    nf_lfil: int          # sizes the near-field's radius; 0: no near-field
    psd_clip: bool


def spec_of(problem: dict) -> Spec:
    return Spec(kind=problem["kernel"], windows=tuple(tuple(w) for w in problem["windows"]), f=problem["f"],
                l=problem["l"], mu=problem["mu"], N=problem["fastsum_N"], nf_lfil=problem["nf_lfil"],
                psd_clip=problem["psd_clip"])


def radius(x, nf_lfil: int) -> float:
    """The near-field's radius: the pitch of a grid over the bounding box of
    x (n, d) that holds max(4, nf_lfil / 3) points a cell on average."""
    n, d = x.shape
    ext = torch.clamp(torch.amax(x, dim=0) - torch.amin(x, dim=0), min=1e-12).double()
    return float((torch.prod(ext) * max(4.0, nf_lfil / 3.0) / n) ** (1.0 / d))


def radius_pairs(x, rho: float, block: int = ROW_BLOCK):
    """(rows, cols) of every pair i < j of points of x (n, d) at most rho
    apart: blocks of rows against the later points."""
    n = x.shape[0]
    rows, cols = [], []
    for s in range(0, n, block):
        xi = x[s: s + block]
        D2 = torch.zeros((xi.shape[0], n - s), dtype=x.dtype, device=x.device)
        for j in range(x.shape[1]):
            D2 += torch.square(xi[:, j, None] - x[None, s:, j])
        later = torch.arange(n - s, device=x.device)[None, :] > torch.arange(xi.shape[0], device=x.device)[:, None]
        i, t = torch.nonzero((D2 <= rho * rho) & later, as_tuple=True)
        rows.append(i + s)
        cols.append(t + s)
    return torch.cat(rows), torch.cat(cols)


def _fold(N: int, dtype, device):
    """(F0, F1), (N/2 + 1, N): F0[p, k] = [|k| = p], F1 = F0 sgn(k), for the
    modes k = -N/2 .. N/2 - 1."""
    k = torch.arange(-(N // 2), N - N // 2, device=device)
    F0 = (torch.arange(N // 2 + 1, device=device)[:, None] == k.abs()[None, :]).to(dtype)
    return F0, F0 * torch.where(k < 0, -1.0, 1.0).to(dtype)[None, :]


def fourier_sum(b, D):
    """Re sum_k b_k e^{2 pi i k.D} at the offsets D (m, d), d = 1 or 2, for
    coefficients b (N,)*d over k = -N/2 .. N/2 - 1: with c_p, s_p the cosine
    and sine of 2 pi p D_j, p = |k|, sum W0 c c - W1 s s over the folded
    coefficients W0 = F0 b F0', W1 = F1 b F1'."""
    m, d = D.shape
    N = b.shape[0]
    F0, F1 = _fold(N, b.dtype, b.device)
    p = torch.arange(N // 2 + 1, dtype=D.dtype, device=D.device)
    if d == 1:
        return torch.cos(2.0 * math.pi * D[:, :1] * p[None, :]) @ (F0 @ b)
    if d != 2:
        raise ValueError(f"the near-field covers windows of one or two features, not {d}")
    W0, W1 = F0 @ b @ F0.T, F1 @ b @ F1.T
    out = torch.empty(m, dtype=D.dtype, device=D.device)
    for s in range(0, m, PAIR_CHUNK):
        ph = 2.0 * math.pi * D[s: s + PAIR_CHUNK, :, None] * p[None, None, :]     # (chunk, 2, P)
        c, sn = torch.cos(ph), torch.sin(ph)
        out[s: s + PAIR_CHUNK] = (torch.sum((c[:, 0] @ W0) * c[:, 1], dim=1)
                                  - torch.sum((sn[:, 0] @ W1) * sn[:, 1], dim=1))
    return out


class NearField:
    """The tapered radius near-field's pairs on one window's scaled points x
    (scaled by `scale` from the sites): found once, valued at any
    lengthscale."""

    def __init__(self, x, scale: float, nf_lfil: int):
        self.scale = scale
        self.rho = radius(x, nf_lfil)
        self.rows, self.cols = radius_pairs(x, self.rho)
        self.D = x[self.rows] - x[self.cols]
        self.r = torch.sqrt(torch.sum(self.D * self.D, dim=1))
        self.taper = torch.square(torch.clamp(1.0 - self.r / self.rho, min=0.0))

    def values(self, kind: str, l, b, grad: bool = False):  # noqa: E741
        """(diag, values) of the correction for coefficients b (N,)*d (float64,
        all N modes): the exact kernel at l (grad: its d/dl, with db_l for b)
        minus the Fourier sum, tapered; diag is the pair i = i (r = 0, taper 1)."""
        dt = self.D.dtype
        exact = gr.base_kernel(kind, torch.square(self.r / self.scale), l)[1 if grad else 0]
        vals = (exact - fourier_sum(b.to(dt), self.D)) * self.taper
        return (0.0 if grad else 1.0) - torch.sum(b).to(dt), vals

    def apply(self, diag, vals, V):
        """The symmetric correction on the rows of V (nv, n)."""
        out = diag * V
        out.index_add_(1, self.rows, vals * V[:, self.cols])
        out.index_add_(1, self.cols, vals * V[:, self.rows])
        return out


class Window:
    """One window: its far field (trimmed modes) and near-field pairs."""

    def __init__(self, spec: Spec, feats, X, prec: Precision):
        dt = prec.dtype
        x, scale = gr.scaled_points(X[:, list(feats)], dt)
        self.d = len(feats)
        l64 = torch.tensor(spec.l, dtype=torch.float64, device=X.device)
        b, _ = gr.coefficients(spec.kind, l64, scale, spec.N, self.d, nyquist=True)
        if spec.psd_clip:
            b = torch.clamp(b, min=0.0)
        trim = (slice(1, None),) * self.d
        self.b = b[trim].reshape(-1).to(dt)
        self.E = gr.phase_tables(x, gr.modes(spec.N, False, dt, X.device), None)
        self.nf = None
        if spec.nf_lfil > 0:
            self.nf = NearField(x, scale, spec.nf_lfil)
            self.diag, self.vals = self.nf.values(spec.kind, torch.tensor(spec.l, dtype=dt), b)

    def far(self, V):
        A = gr.ndft_adjoint(self.E, V)
        return gr.ndft_forward(self.E, (self.b * A[0], -self.b * A[1]))

    def near(self, V):
        return self.nf.apply(self.diag, self.vals, V)


class Operator:
    """A (the configuration's operator) and K (the dense kernel) on the rows
    of V (nv, n), at one precision."""

    def __init__(self, spec: Spec, X, prec: Precision = REFERENCE):
        self.spec, self.prec = spec, prec
        self.X = X.to(prec.dtype)
        with gr.tf32_mode(prec.tf32):
            self.windows = [Window(spec, w, self.X, prec) for w in spec.windows]

    def matvec(self, V):
        s = self.spec
        with gr.tf32_mode(self.prec.tf32):
            V = V.to(self.prec.dtype)
            acc = torch.zeros_like(V)
            for w in self.windows:
                acc += w.far(V)
                if w.nf is not None:
                    acc += w.near(V)
            return s.f * s.f * (acc / len(self.windows) + s.mu * V)

    def exact_matvec(self, V, block: int = ROW_BLOCK):
        """The dense kernel K V, in blocks of rows."""
        s = self.spec
        with gr.tf32_mode(self.prec.tf32):
            V = V.to(self.prec.dtype)
            X, n = self.X, self.X.shape[0]
            out = torch.empty_like(V)
            for r0 in range(0, n, block):
                k = 0.0
                for feats in s.windows:
                    D2 = torch.zeros((min(block, n - r0), n), dtype=X.dtype, device=X.device)
                    for j in feats:
                        D2 += torch.square(X[r0: r0 + block, j, None] - X[None, :, j])
                    k = k + gr.base_kernel(s.kind, D2, torch.tensor(s.l, dtype=X.dtype))[0]
                out[:, r0: r0 + block] = V @ (k / len(s.windows)).T
            return s.f * s.f * (out + s.mu * V)


def residuals(op: Operator, B, Xs):
    """(||b - A x|| / ||b||, ||b - K x|| / ||b||) of each answer x (a row of
    Xs, (nv, n)) to its right-hand side b (a row of B), A the operator and
    K the dense kernel, in float64."""
    B = B.to(torch.float64)
    Xs = Xs.to(device=B.device, dtype=op.prec.dtype)
    norm = torch.linalg.norm(B, dim=1)
    on_op = torch.linalg.norm(B - op.matvec(Xs).double(), dim=1) / norm
    on_kernel = torch.linalg.norm(B - op.exact_matvec(Xs).double(), dim=1) / norm
    return on_op.tolist(), on_kernel.tolist()


def cg(matvec, b, tol: float, maxits: int):
    """Plain conjugate gradient from x = 0 to ||b - A x|| <= tol ||b||, the
    true residual read again where the recurrence's meets tol: (x, steps)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    tolb = tol * float(torch.linalg.norm(b))
    it = 0
    while it < maxits and math.sqrt(float(rr)) > tolb:
        q = matvec(p[None])[0]
        alpha = rr / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rr_new = torch.dot(r, r)
        it += 1
        if math.sqrt(float(rr_new)) <= tolb:
            r = b - matvec(x[None])[0]
            rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, it
