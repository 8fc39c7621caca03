"""Packed streamed-table NDFT: the two kernels of the fastsum training step.

Port of ops/pallas_ndft.py in its table modes.  One phase table
Tp (Dtot, 2P, n) holds, per coordinate row j, cos(2 pi p x_j) in rows
[0, P) and sin in rows [P, 2P).  A 2-D window (ja, jb) uses L0 = Tp[ja] and
L1 = Tp[jb]; a 1-D window j uses Ls = Tp[j].

  adjoint  A_w,r = sum_i alpha_r[i] L0[:, i] L1[:, i]^T     (2P, 2P)
           v_s,r = sum_i alpha_r[i] Ls[:, i]                 (2P,)
  forward  y_s[i] = sum_w L0[:, i]^T G_s,w L1[:, i] + sum_singles Ls[:, i]^T g_s

Each of `packed_adjoint` and `packed_forward` has a plain torch version
beside it.  The wrapper follows one rule: a CPU tensor goes to the plain
version; a CUDA tensor launches the hand-written kernel of
csrc/packed_ndft.cu (built at first use by ops/_cuda_build.py) and raises
if the launch fails.  Each wrapper counts its kernel launches in its
`launches` attribute.

Both kernels read the table in its stored dtype (bf16 on the training path)
and accumulate in float32; alpha and the combined weights stay float32.

What bounds them on an H100: at n = 2e5, five 2-D windows and 2P = 32 a
pass reads 128 MB of bf16 table, but the contraction is 2 nv npairs (2P)^2 n
flops (2e10 at nv = 10), run as float32 FMAs on the CUDA cores.  Beyond a
single right-hand side that FMA issue, not the table bytes, bounds these
first versions; PERF.md has the times.
"""

import math

import torch

from . import _cuda_build

# 2P values the CUDA kernels are compiled for (2P = N with the trimmed
# Nyquist mode; templates in csrc/packed_ndft.cu)
KERNEL_WIDTHS = (16, 32)
_MAX_PAIRS = 32
_MAX_SINGLES = 64


def pack_phase_table(xT, P: int, table_dtype=None):
    """(Dtot, 2P, n) phase table of the coordinate rows xT (Dtot, n)."""
    pr = torch.arange(P, dtype=xT.dtype, device=xT.device)
    ph = 2.0 * math.pi * xT[:, None, :] * pr[None, :, None]       # (Dtot, P, n)
    T = torch.cat([torch.cos(ph), torch.sin(ph)], dim=1)
    return T.contiguous() if table_dtype is None else T.to(table_dtype).contiguous()


# --- plain versions ------------------------------------------------------------

def packed_adjoint_plain(Tp, alpha, pairs, singles):
    """Plain torch adjoint: ((nv, npairs, 2P, 2P), (nv, nsingles, 2P))."""
    T = Tp.to(alpha.dtype)
    A2 = torch.stack([(T[ja][None] * alpha[:, None, :]) @ T[jb].T for ja, jb in pairs], dim=1) \
        if pairs else alpha.new_zeros((alpha.shape[0], 0, T.shape[1], T.shape[1]))
    A1 = torch.stack([alpha @ T[j].T for j in singles], dim=1) \
        if singles else alpha.new_zeros((alpha.shape[0], 0, T.shape[1]))
    return A2, A1


def packed_forward_plain(Tp, G2, G1, pairs, singles):
    """Plain torch forward: (nsets, n) from G2 (nsets, npairs, 2P, 2P) and
    G1 (nsets, nsingles, 2P)."""
    dtype = G2.dtype if pairs else G1.dtype
    T = Tp.to(dtype)
    nsets = G2.shape[0] if pairs else G1.shape[0]
    y = torch.zeros((nsets, T.shape[2]), dtype=dtype, device=T.device)
    for w, (ja, jb) in enumerate(pairs):
        y = y + torch.sum(T[ja][None] * (G2[:, w] @ T[jb]), dim=1)
    for k, j in enumerate(singles):
        y = y + G1[:, k] @ T[j]
    return y


# --- wrappers ------------------------------------------------------------------

def _check_table(Tp, pairs, singles):
    if Tp.ndim != 3 or Tp.shape[1] % 2:
        raise ValueError(f"phase table must be (Dtot, 2P, n), got {tuple(Tp.shape)}")
    if not Tp.is_contiguous():
        raise ValueError("phase table must be contiguous")
    rows = [j for pr in pairs for j in pr] + list(singles)
    if not rows or min(rows) < 0 or max(rows) >= Tp.shape[0]:
        raise ValueError(f"window rows {rows} out of range for {Tp.shape[0]} table rows")


def _check_cuda(Tp, others, pairs, singles):
    """Shape/dtype rules of the CUDA kernels beyond those of the plain path."""
    for t in others:
        if t.device != Tp.device:
            raise ValueError(f"tensors on {t.device} and {Tp.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous float32 operands")
    if Tp.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels take bf16 or f32 tables, got {Tp.dtype}")
    if Tp.shape[1] not in KERNEL_WIDTHS:
        raise ValueError(f"the CUDA kernels are built for 2P in {KERNEL_WIDTHS}, got {Tp.shape[1]}")
    if len(pairs) > _MAX_PAIRS or len(singles) > _MAX_SINGLES:
        raise ValueError(f"at most {_MAX_PAIRS} 2-D and {_MAX_SINGLES} 1-D windows per call")


def packed_adjoint(Tp, alpha, *, pairs: tuple, singles: tuple = ()):
    """Folded adjoint mode tensors of all windows in one pass over the points.

    Replaces the TPU kernel `_adjoint_kernel` (ops/pallas_ndft.py, table
    modes).  Tp: (Dtot, 2P, n); alpha: (n,) or (nv, n) right-hand sides that
    share one table stream.  Returns (A2, A1): per 2-D window a (2P, 2P)
    [cos|sin] x [cos|sin] tensor, per 1-D window a (2P,) vector, each with a
    leading (nv,) axis for batched alpha -- the JAX `packed_adjoint` outputs.
    """
    _check_table(Tp, pairs, singles)
    batched = alpha.ndim == 2
    a2d = alpha if batched else alpha[None]
    if a2d.shape[1] != Tp.shape[2]:
        raise ValueError(f"alpha has {a2d.shape[1]} points, the table {Tp.shape[2]}")
    if a2d.device.type == "cpu" and Tp.device.type == "cpu":
        A2, A1 = packed_adjoint_plain(Tp, a2d, pairs, singles)
    elif a2d.is_cuda and Tp.is_cuda:
        _check_cuda(Tp, [a2d], pairs, singles)
        A2, A1 = _cuda_build.adjoint(Tp, a2d, pairs, singles)
        packed_adjoint.launches += 1
    else:
        raise ValueError(f"table on {Tp.device}, alpha on {a2d.device}")
    pick = (lambda t: t) if batched else (lambda t: t[0])  # noqa: E731
    return ([pick(A2[:, w]) for w in range(len(pairs))],
            [pick(A1[:, k]) for k in range(len(singles))])


def packed_forward(Tp, G2_sets, G1_sets=(), *, pairs: tuple, singles: tuple = ()):
    """Type-2 NDFT for several weight sets sharing one pass over the points.

    Replaces the TPU kernel `_forward_kernel` (ops/pallas_ndft.py, table
    modes).  G2_sets: per 2-D window a (nsets, 2P, 2P) stack of combined
    block tensors (fastsum._folded_combine output); G1_sets: per 1-D window
    a (nsets, 2P) stack.  Returns the list of nsets outputs y (n,).
    """
    _check_table(Tp, pairs, singles)
    W2 = Tp.shape[1]
    G2 = torch.stack(list(G2_sets), dim=1) if pairs else None
    G1 = torch.stack(list(G1_sets), dim=1) if singles else None
    ref = G2 if G2 is not None else G1
    nsets = ref.shape[0]
    if G2 is not None and tuple(G2.shape) != (nsets, len(pairs), W2, W2):
        raise ValueError(f"G2 stack {tuple(G2.shape)} does not match the table")
    if G1 is not None and tuple(G1.shape) != (nsets, len(singles), W2):
        raise ValueError(f"G1 stack {tuple(G1.shape)} does not match the table")
    if ref.device.type == "cpu" and Tp.device.type == "cpu":
        y = packed_forward_plain(Tp, G2, G1, pairs, singles)
    elif ref.is_cuda and Tp.is_cuda:
        G2c = G2.contiguous() if G2 is not None else torch.zeros(
            (nsets, 0, W2, W2), dtype=torch.float32, device=Tp.device)
        G1c = G1.contiguous() if G1 is not None else torch.zeros(
            (nsets, 0, W2), dtype=torch.float32, device=Tp.device)
        _check_cuda(Tp, [G2c, G1c], pairs, singles)
        y = _cuda_build.forward(Tp, G2c, G1c, pairs, singles)
        packed_forward.launches += 1
    else:
        raise ValueError(f"table on {Tp.device}, weights on {ref.device}")
    return list(torch.unbind(y))


packed_adjoint.launches = 0
packed_forward.launches = 0


def reset_launch_counts():
    packed_adjoint.launches = 0
    packed_forward.launches = 0
