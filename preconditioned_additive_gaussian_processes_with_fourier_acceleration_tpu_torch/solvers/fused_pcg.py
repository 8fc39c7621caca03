"""Fused dense Krylov solves: a whole CG solve, or the Lanczos recursions of
all probes, in one kernel launch (port of solvers/pallas_pcg.py).

For a dense SPD K of n up to a few thousand (the multiclass and small
regression problems) a Krylov step is one matvec and a few dots, so a
solver that launches each op separately is bound by launch and host
latency, not by work.  The two kernels of csrc/fused_pcg.cu run every step
in one persistent cooperative launch, one block an SM:

- `fused_pcg_dense`: unpreconditioned CG on K x = b (replaces
  `_pcg_kernel`), returning (x, relres, niter);
- `fused_lanczos_dense`: the Lanczos recursions of the nv probes with
  two-pass classical Gram-Schmidt against the whole history (replaces
  `_lanczos_kernel`), returning (alpha, beta, V, beta0), the SLQ input.

Neither is wired into `gp_loss` (nor is its JAX counterpart): the shipped
solvers are solvers/pcg.py and solvers/lanczos.py.

Which rows (CG) or columns (Lanczos) of K each block owns, how many of them
stay in shared memory for the whole launch and how many stream through a
ring every step is decided here, by the pure functions `cg_plan`,
`lanczos_plan` and `dense_plan`; the C entry points check a plan and refuse
one that does not cover K exactly once or does not fit the card.

Both work in float32, as the JAX functions cast; x comes back in b's
dtype.  Each has a plain torch version beside it.  The wrapper follows one
rule: a CPU tensor goes to the plain version; a CUDA tensor launches the
hand-written kernel (built at first use by ops/_cuda_build.py) and raises
if it cannot.  Each wrapper counts its launches in `.launches`.
"""

from dataclasses import dataclass

import torch

from ..ops import _cuda_build

# largest n either kernel takes (PCG keeps p, n floats, in shared memory)
MAX_N = 16384
# the Lanczos kernel's limits: probes per launch (per-thread accumulators)
# and steps (the coefficient history lives in shared memory)
MAX_NV = 16
MAX_ITS = 64
_EPS32 = torch.finfo(torch.float32).eps


# --- the launch plans (mirrored by the checks of csrc/fused_pcg.cu) ------------

# blocks a plan may hold (the C side's per-block arrays)
MAX_BLOCKS = 256
# dynamic shared memory is aligned to 1024 bytes inside the kernels
SMEM_SLACK = 1024
# CG: consumer threads (a producer warp beside them when rows stream), the
# bytes ahead of p (mbarriers, reduction buffers, broadcast slots), and the
# bytes of the ring of one-row stages the streamed rows arrive through
# (two to MAX_STAGES stages)
CG_CONS = 512
CG_FIXED = 4096
CG_RING_BYTES = 32768
MAX_STAGES = 8
# Lanczos: consumer threads, the bytes ahead of the ring (mbarriers, the
# coefficients, the cross-warp sums of a panel: 128 columns x 16 probes),
# the panel widths; chunks of LZ_STREAM_ROWS (resident plans:
# LZ_RESIDENT_ROWS) rows a consumer column group, at most 256 (one TMA
# box); the ring's stages where K streams (few, large copies: two stages
# of 256 rows beat four of 64 at n = 2200 to 4096 on an H100, though less
# of K stays resident), and the most where it all stays (its stages then
# carry v_it alone)
LZ_CONS = 256
LZ_FIXED = 18432
LZ_WIDTHS = (4, 8, 16, 32, 64, 128)
LZ_STREAM_ROWS = 8
LZ_RESIDENT_ROWS = 4
LZ_STAGES = 2
LZ_MAX_STAGES = 8
# the most bytes a block keeps of its own columns of w and of the V history
# (nv rounded up to 4 + nv (maxits + 1) floats a column) in shared memory;
# past it they stay in global memory
LZ_OWN_MAX = 49152


def _ld(n: int) -> int:
    """K's row stride in the kernels: n rounded up to 16 bytes."""
    return -(-n // 4) * 4


def _nvp4(nv: int) -> int:
    """Probes per row of the transposed Lanczos vectors: nv rounded up to 4."""
    return -(-nv // 4) * 4


@dataclass(frozen=True)
class CgPlan:
    """Block b owns rows starts[b]:starts[b + 1] of K; the first resident[b]
    of them are copied to its shared memory once a launch, the rest stream
    every step through a ring of `stages` one-row stages."""
    n: int
    blocks: int
    starts: tuple
    resident: tuple
    stages: int
    smem: int

    @property
    def row_bytes(self) -> int:
        return 4 * _ld(self.n)

    @property
    def resident_bytes(self) -> int:
        return sum(self.resident) * self.row_bytes

    @property
    def streamed_bytes(self) -> int:
        """Bytes of K that stream every step."""
        return (self.n - sum(self.resident)) * self.row_bytes


@dataclass(frozen=True)
class LanczosPlan:
    """K's columns in panels of `width`; block b owns panels
    pstarts[b]:pstarts[b + 1], and of each panel the first resident[b]
    chunks of `chunk_rows` rows stay in shared memory for the launch, the
    rest stream every step through a ring of `stages` stages, each holding
    a chunk of the transposed v_it and, where some chunk streams, of the
    panel."""
    n: int
    nv: int
    maxits: int
    blocks: int
    width: int
    chunk_rows: int
    pstarts: tuple
    resident: tuple
    stages: int
    own: bool
    smem: int

    @property
    def chunks(self) -> int:
        return -(-self.n // self.chunk_rows)

    @property
    def chunk_bytes(self) -> int:
        return 4 * self.chunk_rows * self.width

    @property
    def streams(self) -> bool:
        return any(r < self.chunks for r in self.resident)

    @property
    def stage_bytes(self) -> int:
        return 4 * self.chunk_rows * (_nvp4(self.nv) + (self.width if self.streams else 0))

    @property
    def own_bytes(self) -> int:
        """Shared memory for the blocks' own columns of w and of the V history."""
        per = max(self.pstarts[b + 1] - self.pstarts[b] for b in range(self.blocks))
        return _own_bytes(per * self.width, self.nv, self.maxits) if self.own else 0

    @property
    def resident_bytes(self) -> int:
        return sum((self.pstarts[b + 1] - self.pstarts[b]) * self.resident[b]
                   for b in range(self.blocks)) * self.chunk_bytes

    @property
    def streamed_bytes(self) -> int:
        """Bytes of K's panels (padded to whole panels and chunks) that
        stream every step."""
        panels = self.pstarts[-1]
        return panels * self.chunks * self.chunk_bytes - self.resident_bytes


def _own_bytes(ncol: int, nv: int, maxits: int) -> int:
    return -(-4 * ncol * (_nvp4(nv) + nv * (maxits + 1)) // 1024) * 1024


def _split(total: int, parts: int) -> tuple:
    return tuple(b * total // parts for b in range(parts + 1))


def cg_plan(n: int, sms: int, smem_per_block: int) -> CgPlan:
    """Rows of K for the CG kernel: min(sms, n) blocks of contiguous rows,
    as even as integers allow; every block keeps full copies of p (shared
    memory) and r (registers), so beside its rows it needs 4 ld bytes.  All
    rows resident when they fit; else a ring of one-row stages holding
    about CG_RING_BYTES (2 to MAX_STAGES rows) and as many resident rows
    as the rest of the budget holds.  Raises ValueError where not even a
    ring of two rows fits."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n must be in [1, {MAX_N}], got {n}")
    G = min(sms, n, MAX_BLOCKS)
    if G < 1:
        raise ValueError(f"no SM to run on: {sms}")
    starts = _split(n, G)
    counts = [starts[b + 1] - starts[b] for b in range(G)]
    row = 4 * _ld(n)
    base = SMEM_SLACK + CG_FIXED + row
    if base + max(counts) * row <= smem_per_block:
        return CgPlan(n, G, starts, tuple(counts), 0, base + max(counts) * row)
    stages = min(MAX_STAGES, max(2, CG_RING_BYTES // row), (smem_per_block - base) // row)
    if stages < 2:
        raise ValueError(f"CG at n={n}: p and a ring of two rows need {base + 2 * row} bytes of shared memory, "
                         f"the card gives {smem_per_block}")
    keep = (smem_per_block - base - stages * row) // row
    resident = tuple(min(c, keep) for c in counts)
    return CgPlan(n, G, starts, resident, stages, base + (stages + max(resident)) * row)


def lanczos_plan(n: int, nv: int, sms: int, smem_per_block: int, maxits: int = 10) -> LanczosPlan:
    """Columns of K for the Lanczos kernel: panels of the narrowest width of
    LZ_WIDTHS that gives no more panels than SMs (else the widest), blocks
    of contiguous panels.  A block's own columns of w and of the V history
    (maxits + 1 rows) take shared memory first where they need at most
    LZ_OWN_MAX.  Where every panel of a block then fits its shared memory
    whole, in chunks of LZ_RESIDENT_ROWS rows a consumer thread's column
    group (at most 256), it stays there and the ring (up to LZ_MAX_STAGES
    stages) carries v_it alone.  Else chunks of LZ_STREAM_ROWS rows a
    column group; the ring's LZ_STAGES stages carry a chunk of v_it (nv
    rounded up to 4 probes a row) and of the panel, and what the budget
    leaves holds each panel's leading chunks for the launch.  Raises
    ValueError where the ring does not fit."""
    if not 1 <= n <= MAX_N or not 1 <= nv <= MAX_NV or not 1 <= maxits <= MAX_ITS:
        raise ValueError(f"n must be in [1, {MAX_N}], nv in [1, {MAX_NV}] and maxits in [1, {MAX_ITS}], "
                         f"got {n}, {nv}, {maxits}")
    if sms < 1:
        raise ValueError(f"no SM to run on: {sms}")
    width = next((w for w in LZ_WIDTHS if -(-n // w) <= min(sms, MAX_BLOCKS)), LZ_WIDTHS[-1])
    panels = -(-n // width)
    G = min(sms, panels, MAX_BLOCKS)
    pstarts = _split(panels, G)
    per = [pstarts[b + 1] - pstarts[b] for b in range(G)]
    own = _own_bytes(max(per) * width, nv, maxits) <= LZ_OWN_MAX
    groups = LZ_CONS // (width // 4)  # row groups: consumer threads over column groups
    base = SMEM_SLACK + LZ_FIXED + (_own_bytes(max(per) * width, nv, maxits) if own else 0)
    # all of K resident, v_it alone in the ring
    rows = min(256, LZ_RESIDENT_ROWS * groups)
    chunks = -(-n // rows)
    held = max(per) * chunks * 4 * rows * width
    vstage = 4 * rows * _nvp4(nv)
    stages = min(LZ_MAX_STAGES, max(2, chunks * max(per)), (smem_per_block - base - held) // vstage)
    if stages >= 2:
        return LanczosPlan(n, nv, maxits, G, width, rows, pstarts, (chunks,) * G, stages, own,
                           base + held + stages * vstage)
    rows = min(256, LZ_STREAM_ROWS * groups)
    chunks = -(-n // rows)
    chunk = 4 * rows * width
    stage = 4 * rows * _nvp4(nv) + chunk
    avail = smem_per_block - base - LZ_STAGES * stage
    if avail < 0:
        raise ValueError(f"Lanczos at n={n}, nv={nv}: a ring of {LZ_STAGES} {stage}-byte stages does not fit "
                         f"{smem_per_block} bytes of shared memory")
    resident = tuple(min(chunks - 1, avail // (chunk * p)) for p in per)  # some chunk streams
    held = max(p * r for p, r in zip(per, resident))
    return LanczosPlan(n, nv, maxits, G, width, rows, pstarts, resident, LZ_STAGES, own,
                       base + LZ_STAGES * stage + held * chunk)


def dense_plan(n: int, nv: int, sms: int, smem_per_block: int, maxits: int = 10) -> tuple:
    """(cg_plan(n, ...), lanczos_plan(n, nv, ..., maxits)) for a card of `sms`
    SMs and `smem_per_block` bytes of shared memory a block."""
    return cg_plan(n, sms, smem_per_block), lanczos_plan(n, nv, sms, smem_per_block, maxits)


def _safe(v):
    return torch.where(v == 0, torch.ones_like(v), v)


# --- plain versions ------------------------------------------------------------

def fused_pcg_dense_plain(K, b, *, maxits: int = 100, tol: float = 1e-6):
    """Plain torch CG with the TPU kernel's semantics: x = 0 start, the stop
    test on the squared recursion residual, breakdown on rho == 0 or
    pq <= 0, niter counting active steps.  Leaves the loop once stopped
    (every later step is a no-op)."""
    K32, b32 = K.to(torch.float32), b.to(torch.float32)
    nb2 = torch.sum(b32 * b32)
    safe_nb2 = _safe(nb2)
    tolb_sq = (tol * tol) * safe_nb2
    x = torch.zeros_like(b32)
    r, p = b32.clone(), b32.clone()
    normr_sq, rho_prev = nb2, torch.zeros_like(nb2)
    niter = 0
    stop = bool(nb2 <= tolb_sq)
    for it in range(maxits):
        if stop:
            break
        rho = torch.sum(r * r)
        if it > 0:
            p = r + (rho / _safe(rho_prev)) * p
        else:
            p = r.clone()
        q = K32 @ p
        pq = torch.sum(p * q)
        breakdown = bool(rho == 0.0) or bool(pq <= 0.0)
        alpha = torch.zeros_like(rho) if breakdown else rho / _safe(pq)
        x = x + alpha * p
        r = r - alpha * q
        normr_sq = torch.sum(r * r)
        niter += 1
        stop = breakdown or bool(normr_sq <= tolb_sq)
        rho_prev = rho
    relres = torch.sqrt(torch.clamp(normr_sq, min=0.0) / safe_nb2)
    return x.to(b.dtype), relres, torch.tensor(niter, dtype=torch.int32, device=b.device)


def fused_lanczos_dense_plain(K, Z, *, maxits: int = 10):
    """Plain torch batched Lanczos with the TPU kernel's semantics (M = I):
    w = v_it K, two CGS passes against the whole history, alpha = coeff[it],
    beta = coeff[it-1] (the reorthogonalization coefficient), the absolute
    break test ||w|| < float32 eps, identity/zero padding after a stop."""
    K32, Z32 = K.to(torch.float32), Z.to(torch.float32)
    nv, n = Z32.shape
    dev = Z32.device
    beta0 = torch.sqrt(torch.clamp(torch.sum(Z32 * Z32, dim=1), min=0.0))
    V = torch.zeros((nv, maxits + 1, n), dtype=torch.float32, device=dev)
    V[:, 0] = Z32 / _safe(beta0)[:, None]
    alpha = torch.ones((nv, maxits), dtype=torch.float32, device=dev)
    beta = torch.zeros((nv, max(maxits - 1, 0)), dtype=torch.float32, device=dev)
    stop = torch.zeros(nv, dtype=torch.bool, device=dev)
    for it in range(maxits):
        if bool(stop.all()):
            break
        w = V[:, it] @ K32
        coeff = torch.zeros((nv, maxits + 1), dtype=torch.float32, device=dev)
        for _ in range(2):
            t = torch.einsum("vjn,vn->vj", V, w)
            w = w - torch.einsum("vj,vjn->vn", t, V)
            coeff = coeff + t
        tn = torch.sqrt(torch.sum(w * w, dim=1))
        brk = tn < _EPS32
        live = ~stop & ~brk
        V[:, it + 1] = torch.where(live[:, None], w / _safe(tn)[:, None], 0.0)
        alpha[:, it] = torch.where(live, coeff[:, it], 1.0)
        if it > 0:
            beta[:, it - 1] = torch.where(live, coeff[:, it - 1], 0.0)
        stop = stop | brk
    return alpha, beta, V, beta0


# --- wrappers ------------------------------------------------------------------

def _check_square(K, n):
    if K.ndim != 2 or tuple(K.shape) != (n, n):
        raise ValueError(f"K must be ({n}, {n}), got {tuple(K.shape)}")


def _check_cuda(K, other, n):
    if other.device != K.device:
        raise ValueError(f"tensors on {K.device} and {other.device}")
    if n > MAX_N:
        raise ValueError(f"the fused CUDA kernels take n <= {MAX_N}, got {n}")


def fused_pcg_dense(K, b, *, maxits: int = 100, tol: float = 1e-6):
    """Solve K x = b (SPD dense K, no preconditioner) in one kernel launch.

    Replaces the TPU kernel `_pcg_kernel` (solvers/pallas_pcg.py).
    K (n, n), b (n,), both cast to float32.  Returns (x in b's dtype,
    relres float32, niter int32): the JAX `fused_pcg_dense` outputs."""
    n = b.shape[0]
    _check_square(K, n)
    if K.device.type == "cpu" and b.device.type == "cpu":
        return fused_pcg_dense_plain(K, b, maxits=maxits, tol=tol)
    if not (K.is_cuda and b.is_cuda):
        raise ValueError(f"K on {K.device}, b on {b.device}")
    _check_cuda(K, b, n)
    x, relres, niter = _cuda_build.fused_pcg(K.to(torch.float32).contiguous(),
                                             b.to(torch.float32).contiguous(), maxits, tol)
    fused_pcg_dense.launches += 1
    return x.to(b.dtype), relres, niter


def fused_lanczos_dense(K, Z, *, maxits: int = 10):
    """Batched unpreconditioned Lanczos of all probes in one kernel launch.

    Replaces the TPU kernel `_lanczos_kernel` (solvers/pallas_pcg.py).
    K (n, n) SPD, Z (nv, n) probes, cast to float32.  Returns
    (alpha (nv, maxits), beta (nv, maxits - 1), V (nv, maxits + 1, n),
    beta0 (nv,)), float32: the JAX `fused_lanczos_dense` outputs."""
    nv, n = Z.shape
    _check_square(K, n)
    if maxits < 1:
        raise ValueError(f"maxits must be >= 1, got {maxits}")
    if K.device.type == "cpu" and Z.device.type == "cpu":
        return fused_lanczos_dense_plain(K, Z, maxits=maxits)
    if not (K.is_cuda and Z.is_cuda):
        raise ValueError(f"K on {K.device}, Z on {Z.device}")
    _check_cuda(K, Z, n)
    if nv > MAX_NV or maxits > MAX_ITS:
        raise ValueError(f"the fused CUDA Lanczos takes nv <= {MAX_NV} and maxits <= {MAX_ITS}, "
                         f"got {nv} and {maxits}")
    out = _cuda_build.fused_lanczos(K.to(torch.float32).contiguous(),
                                    Z.to(torch.float32).contiguous(), maxits)
    fused_lanczos_dense.launches += 1
    return out


KERNEL_WRAPPERS = (fused_pcg_dense, fused_lanczos_dense)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
