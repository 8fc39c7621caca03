"""Packed NDFT: the two kernels of the fastsum training step.

Port of ops/pallas_ndft.py.  Per coordinate row j the phases are
cos(2 pi p x_j) in rows [0, P) and sin in rows [P, 2P).  A 2-D window
(ja, jb) uses L0 = phases of row ja and L1 = phases of row jb; a 1-D window
j uses Ls = phases of row j.

  adjoint  A_w,r = sum_i alpha_r[i] L0[:, i] L1[:, i]^T     (2P, 2P)
           v_s,r = sum_i alpha_r[i] Ls[:, i]                 (2P,)
  forward  y_s[i] = sum_w L0[:, i]^T G_s,w L1[:, i] + sum_singles Ls[:, i]^T g_s

Two phase sources, as in the JAX package:
- a TABLE Tp (Dtot, 2P, n) built once per dataset (`pack_phase_table`,
  the "table" modes): `packed_adjoint` / `packed_forward`;
- the raw coordinates xT (Dtot, n), the phases REGENERATED inside the
  kernels ("doubling", the default, and "direct"; `phase_slab`):
  `packed_adjoint_regen` / `packed_forward_regen`.

Each of the four has a plain torch version beside it.  The wrapper follows
one rule: a CPU tensor goes to the plain version, at every width; a CUDA
tensor launches the hand-written kernel (csrc/, built at first use by
ops/_cuda_build.py) and raises if the launch fails.  Each wrapper counts its
kernel launches in its `launches` attribute, and by shape in
`launches_by_shape`.

Widths on CUDA tensors: the narrow kernels below serve 2P in KERNEL_WIDTHS
(tables; `table_route` also sends float32 tables with many right-hand
sides or weight sets to the wide pair) and REGEN_KERNEL_WIDTHS
(regenerating); every other even 2P goes, with the same phase source, to
the wide pair of csrc/packed_ndft_wide.cu
(the adjoint's 2-D windows on the tensor cores, wgmma in 3xTF32; its 1-D
windows and the forward on the CUDA cores; the regenerating sources first
write their phases into a float32 slab, at most SLAB_BYTES at a time),
whose launches WIDE_ADJOINT / WIDE_FORWARD count (by "2P=.. nv=.." /
"2P=.. nsets=.."); an odd width raises.

Window counts: one launch of a CUDA kernel takes at most MAX_PAIRS 2-D and
MAX_SINGLES 1-D windows (the C side's `Rows`); a call with more runs its
windows in groups of launches (`window_groups`), every route alike: the
adjoint's outputs are per window and concatenate in window order, the
forward's per-point sums add, group by group in launch order.

A bf16 table (the training path's) goes to the tensor-core kernels of
csrc/packed_ndft_tc.cu: alpha * L0 and the combined weights are split into
three bf16 terms that hold their float32 significand exactly, so the
products are those of float32 arithmetic and the sums are float32.  A
float32 table goes to the kernels of csrc/packed_ndft.cu (CUDA cores fed
by a TMA ring, both bound by the table's bytes at one right-hand side or
weight set) up to F32_MAX_NV / F32_MAX_NSETS, past them to the wide pair
(`table_route`).  alpha and the weights are float32.  The regenerating
kernels take float32 coordinates and run on the tensor cores in 3xTF32
(each float32 operand split into two tf32 parts, three products), the
Nyquist mode's rows or columns and the 1-D windows on the CUDA cores in
the same launch (csrc/packed_ndft_regen.cu).

`pack_phase_table` pads the table's storage along the points to a multiple
of 64 and returns the view of its first n columns: the kernels copy
16-byte rows asynchronously, so a table's row stride must be a multiple of
16 bytes (a table without it is copied into padded storage first,
`_aligned_table`).

What bounds them on an H100: at n = 2e5, five 2-D windows and 2P = 32 a
table pass reads 128 MB of bf16 table (38 us at 3.35 TB/s), and the
contraction is 2 nv npairs (2P)^2 n flops (2e10 at nv = 10), three times
over on the bf16 tensor cores: many right-hand sides or weight sets are
bound by the tensor cores, one by the table bytes; PERF.md has the times.
"""

import math

import torch

from . import _cuda_build

TWO_PI = 6.283185307179586
# 2P values the CUDA kernels are compiled for: the table kernels take the
# trimmed width 2P = N, the regenerating kernels the untrimmed 2P = N + 2
# (templates in csrc/)
KERNEL_WIDTHS = (16, 32)
REGEN_KERNEL_WIDTHS = (18, 34)
PHASE_GENS = ("doubling", "direct")
# the most bytes a regenerating call's phase slab takes on the wide kernels;
# more points run in ranges of whole TABLE_PAD tiles
SLAB_BYTES = 1 << 30
# the most 2-D / 1-D windows one kernel launch takes (Rows in csrc/packed_ndft.cuh)
MAX_PAIRS = 32
MAX_SINGLES = 64
# points per padded table row: pack_phase_table rounds its storage up to it
TABLE_PAD = 64


def pack_phase_table(xT, P: int, table_dtype=None):
    """(Dtot, 2P, n) phase table of the coordinate rows xT (Dtot, n).

    The view of the first n columns of zero-padded (Dtot, 2P, npad)
    storage, npad a multiple of TABLE_PAD (as the JAX pack_phase_table pads
    to npad): each table row starts on a 128-byte boundary."""
    Dtot, n = xT.shape
    pr = torch.arange(P, dtype=xT.dtype, device=xT.device)
    ph = 2.0 * math.pi * xT[:, None, :] * pr[None, :, None]       # (Dtot, P, n)
    T = torch.cat([torch.cos(ph), torch.sin(ph)], dim=1)
    store = torch.zeros((Dtot, 2 * P, -(-n // TABLE_PAD) * TABLE_PAD),
                        dtype=T.dtype if table_dtype is None else table_dtype, device=xT.device)
    store[:, :, :n] = T
    return store[:, :, :n]


def phase_slab(xT, P: int, phase_gen: str = "doubling"):
    """(Dtot, 2P, n) phases of the coordinate rows xT, regenerated.

    'direct': one cos and one sin per mode (JAX `_build_T6`).  'doubling':
    cos/sin of 2 pi x once, then rows [have, 2 have) = rows [0, have)
    rotated by e^{i have theta}, the rotator taken from row have/2 by the
    double-angle identity (JAX `_build_T6_doubling`, its same recurrence
    stopped at P instead of the TPU's 8-row padding).
    """
    th = TWO_PI * xT
    if phase_gen == "direct":
        ph = th[:, None, :] * torch.arange(P, dtype=xT.dtype, device=xT.device)[None, :, None]
        return torch.cat([torch.cos(ph), torch.sin(ph)], dim=1)
    if phase_gen != "doubling":
        raise ValueError(f"unknown phase_gen {phase_gen!r}, expected one of {PHASE_GENS}")
    C = [torch.ones_like(th), torch.cos(th)]
    S = [torch.zeros_like(th), torch.sin(th)]
    have = 2
    while have < P:
        ch, sh = C[have // 2], S[have // 2]
        ck = ch * ch - sh * sh                                     # cos(have * th)
        sk = 2.0 * ch * sh                                         # sin(have * th)
        take = min(have, P - have)
        C, S = (C + [C[k] * ck - S[k] * sk for k in range(take)],
                S + [S[k] * ck + C[k] * sk for k in range(take)])
        have += take
    return torch.cat([torch.stack(C[:P], dim=1), torch.stack(S[:P], dim=1)], dim=1)


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


def packed_adjoint_regen_plain(xT, alpha, P, pairs, singles, phase_gen="doubling"):
    """Plain regenerating adjoint: phases from `phase_slab`, then the plain
    contraction."""
    return packed_adjoint_plain(phase_slab(xT, P, phase_gen), alpha, pairs, singles)


def packed_forward_regen_plain(xT, G2, G1, P, pairs, singles, phase_gen="doubling"):
    """Plain regenerating forward: phases from `phase_slab`, then the plain
    contraction."""
    return packed_forward_plain(phase_slab(xT, P, phase_gen), G2, G1, pairs, singles)


# --- wrappers ------------------------------------------------------------------

def _check_rows(nrows, pairs, singles):
    rows = [j for pr in pairs for j in pr] + list(singles)
    if not rows or min(rows) < 0 or max(rows) >= nrows:
        raise ValueError(f"window rows {rows} out of range for {nrows} coordinate rows")


def _check_table(Tp, pairs, singles):
    if Tp.ndim != 3 or Tp.shape[1] % 2:
        raise ValueError(f"phase table must be (Dtot, 2P, n), got {tuple(Tp.shape)}")
    d, w, n = Tp.stride()
    if n != 1 or w < Tp.shape[2] or d != Tp.shape[1] * w:
        raise ValueError("phase table must hold its rows with unit point stride and one row "
                         f"stride (pack_phase_table's layout), got strides {Tp.stride()}")
    _check_rows(Tp.shape[0], pairs, singles)


def _aligned_table(Tp):
    """A table whose rows start on 16-byte boundaries, as the asynchronous
    copies of every table kernel need: Tp itself, or a copy into padded
    storage."""
    if Tp.stride(1) * Tp.element_size() % 16 == 0 and Tp.data_ptr() % 16 == 0:
        return Tp
    n = Tp.shape[2]
    store = Tp.new_zeros((*Tp.shape[:2], -(-n // TABLE_PAD) * TABLE_PAD))
    store[:, :, :n] = Tp
    return store[:, :, :n]


def _check_coords(xT, pairs, singles):
    if xT.ndim != 2:
        raise ValueError(f"coordinates must be (Dtot, n), got {tuple(xT.shape)}")
    _check_rows(xT.shape[0], pairs, singles)


def _route(width, narrow):
    """"narrow" for a width the narrow kernels are built for, "wide" for
    every other even 2P; raises for an odd width."""
    if width in narrow:
        return "narrow"
    if width % 2 == 0 and width >= 2:
        return "wide"
    raise ValueError(f"the CUDA kernels take 2P in {narrow} (narrow kernels) or any other even 2P (wide "
                     f"kernels), got {width}")


# By 2P, the most right-hand sides (adjoint) and weight sets (forward) of a
# call that the float32-table kernels (csrc/packed_ndft.cu) take; past them
# the wide pair's wgmma kernels are faster; None: no cut-over.  Measured by
# scripts/torch_table_kernels_ab.py --kernels f32 (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md): at 2P = 16 the float32-table kernels won at every
# count (nv 1-16, nsets 1-20); at 32 the adjoint through nv = 10 (the wide
# one 5% faster at nv = 4 on five pairs, faster from nv = 16), the forward
# at nsets = 1 only.
F32_MAX_NV = {16: None, 32: 10}
F32_MAX_NSETS = {16: None, 32: 1}


def table_route(width, dtype, op, count):
    """The kernel of a table call on CUDA tensors: "f32" (csrc/packed_ndft.cu),
    "bf16" (csrc/packed_ndft_tc.cu) or "wide" (csrc/packed_ndft_wide.cu), by
    the width 2P, the table's dtype, op ("adjoint" or "forward") and count
    (its right-hand sides or weight sets); raises for an odd width."""
    if _route(width, KERNEL_WIDTHS) == "wide":
        return "wide"
    if dtype == torch.bfloat16:
        return "bf16"
    cut = (F32_MAX_NV if op == "adjoint" else F32_MAX_NSETS)[width]
    return "f32" if cut is None or count <= cut else "wide"


def _check_cuda(src, others, src_dtypes, table=False):
    """Shape/dtype rules of the CUDA kernels beyond those of the plain path."""
    for t in others:
        if t.device != src.device:
            raise ValueError(f"tensors on {t.device} and {src.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous float32 operands")
    if src.dtype not in src_dtypes or not (table or src.is_contiguous()):
        raise ValueError(f"the CUDA kernels take {src_dtypes} tables or contiguous coordinates, "
                         f"got {src.dtype}")


def window_groups(npairs: int, nsingles: int) -> list:
    """[(pair slice, single slice)]: the windows of one call split into
    launches of at most MAX_PAIRS 2-D and MAX_SINGLES 1-D windows, in
    window order; one group when they fit one launch."""
    count = max(1, -(-npairs // MAX_PAIRS), -(-nsingles // MAX_SINGLES))
    return [(slice(min(npairs, k * MAX_PAIRS), min(npairs, (k + 1) * MAX_PAIRS)),
             slice(min(nsingles, k * MAX_SINGLES), min(nsingles, (k + 1) * MAX_SINGLES))) for k in range(count)]


def grouped_adjoint(launch, pairs, singles):
    """The adjoint of every window through launch(pairs, singles) -> (A2
    (nv, npairs, 2P, 2P), A1 (nv, nsingles, 2P)), one call per group of
    `window_groups`: the groups' outputs concatenated in window order."""
    pairs, singles = tuple(pairs), tuple(singles)
    groups = window_groups(len(pairs), len(singles))
    if len(groups) == 1:
        return launch(pairs, singles)
    outs = [launch(pairs[p], singles[s]) for p, s in groups]
    return torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1)


def grouped_forward(launch, G2, G1, pairs, singles):
    """The forward of every window through launch(G2, G1, pairs, singles)
    -> y (nsets, n), one call per group of `window_groups` on its slices of
    the stacks G2 (nsets, npairs, 2P, 2P) and G1 (nsets, nsingles, 2P)
    (either None without windows of its kind): the groups' y summed in
    launch order, so a second call is bitwise equal."""
    pairs, singles = tuple(pairs), tuple(singles)
    groups = window_groups(len(pairs), len(singles))
    if len(groups) == 1:
        return launch(G2, G1, pairs, singles)
    y = None
    for p, s in groups:
        part = launch(None if G2 is None else G2[:, p].contiguous(), None if G1 is None else G1[:, s].contiguous(),
                      pairs[p], singles[s])
        y = part if y is None else y + part
    return y


def _alpha_rows(alpha, n):
    a2d = alpha if alpha.ndim == 2 else alpha[None]
    if a2d.shape[1] != n:
        raise ValueError(f"alpha has {a2d.shape[1]} points, the phases {n}")
    return a2d


def _adjoint_outputs(A2, A1, batched, npairs, nsingles):
    pick = (lambda t: t) if batched else (lambda t: t[0])  # noqa: E731
    return ([pick(A2[:, w]) for w in range(npairs)],
            [pick(A1[:, k]) for k in range(nsingles)])


def _weight_stacks(G2_sets, G1_sets, W2, pairs, singles):
    """Per-window (nsets, ...) stacks, or those already stacked, -> G2
    (nsets, npairs, W2, W2) and G1 (nsets, nsingles, W2), either None when
    it has no windows."""
    def stacked(g):
        return g if isinstance(g, torch.Tensor) else torch.stack(list(g), dim=1)

    G2 = stacked(G2_sets) if pairs else None
    G1 = stacked(G1_sets) if singles else None
    nsets = (G2 if G2 is not None else G1).shape[0]
    if G2 is not None and tuple(G2.shape) != (nsets, len(pairs), W2, W2):
        raise ValueError(f"G2 stack {tuple(G2.shape)} does not match 2P = {W2}")
    if G1 is not None and tuple(G1.shape) != (nsets, len(singles), W2):
        raise ValueError(f"G1 stack {tuple(G1.shape)} does not match 2P = {W2}")
    return G2, G1


def _dense_stacks(G2, G1, W2, device):
    """Contiguous stacks for the kernels, 16-byte aligned (the asynchronous
    copies of the weights); an empty stack for no windows."""
    nsets = (G2 if G2 is not None else G1).shape[0]
    G2c = G2.contiguous() if G2 is not None else torch.zeros(
        (nsets, 0, W2, W2), dtype=torch.float32, device=device)
    G1c = G1.contiguous() if G1 is not None else torch.zeros(
        (nsets, 0, W2), dtype=torch.float32, device=device)
    return tuple(g if g.data_ptr() % 16 == 0 else g.clone() for g in (G2c, G1c))


def packed_adjoint(Tp, alpha, *, pairs: tuple, singles: tuple = ()):
    """Folded adjoint mode tensors of all windows in one pass over the points.

    Replaces the TPU kernel `_adjoint_kernel` (ops/pallas_ndft.py, table
    modes).  Tp: (Dtot, 2P, n); alpha: (n,) or (nv, n) right-hand sides that
    share one table stream.  Returns (A2, A1): per 2-D window a (2P, 2P)
    [cos|sin] x [cos|sin] tensor, per 1-D window a (2P,) vector, each with a
    leading (nv,) axis for batched alpha -- the JAX `packed_adjoint` outputs.
    """
    _check_table(Tp, pairs, singles)
    a2d = _alpha_rows(alpha, Tp.shape[2])
    if a2d.device.type == "cpu" and Tp.device.type == "cpu":
        A2, A1 = packed_adjoint_plain(Tp, a2d, pairs, singles)
    elif a2d.is_cuda and Tp.is_cuda:
        _check_cuda(Tp, [a2d], _TABLE_DTYPES, table=True)
        route = table_route(Tp.shape[1], Tp.dtype, "adjoint", a2d.shape[0])
        if route == "wide":
            A2, A1 = _adjoint_wide(Tp, a2d, pairs, singles)
        else:
            T, kernel = _aligned_table(Tp), _cuda_build.adjoint_tc if route == "bf16" else _cuda_build.adjoint
            A2, A1 = grouped_adjoint(_counted(lambda pr, sg: kernel(T, a2d, pr, sg), packed_adjoint,
                                              f"nv={a2d.shape[0]}"), pairs, singles)
    else:
        raise ValueError(f"table on {Tp.device}, alpha on {a2d.device}")
    return _adjoint_outputs(A2, A1, alpha.ndim == 2, len(pairs), len(singles))


def packed_forward(Tp, G2_sets, G1_sets=(), *, pairs: tuple, singles: tuple = ()):
    """Type-2 NDFT for several weight sets sharing one pass over the points.

    Replaces the TPU kernel `_forward_kernel` (ops/pallas_ndft.py, table
    modes).  G2_sets: per 2-D window a (nsets, 2P, 2P) stack of combined
    block tensors (fastsum._folded_combine output), or all of them as one
    (nsets, npairs, 2P, 2P) tensor; G1_sets: per 1-D window a (nsets, 2P)
    stack, or one (nsets, nsingles, 2P) tensor.  Returns the list of nsets
    outputs y (n,).
    """
    _check_table(Tp, pairs, singles)
    W2 = Tp.shape[1]
    G2, G1 = _weight_stacks(G2_sets, G1_sets, W2, pairs, singles)
    ref = G2 if G2 is not None else G1
    if ref.device.type == "cpu" and Tp.device.type == "cpu":
        y = packed_forward_plain(Tp, G2, G1, pairs, singles)
    elif ref.is_cuda and Tp.is_cuda:
        G2c, G1c = _dense_stacks(G2, G1, W2, Tp.device)
        _check_cuda(Tp, [G2c, G1c], _TABLE_DTYPES, table=True)
        route = table_route(W2, Tp.dtype, "forward", G2c.shape[0])
        if route == "wide":
            y = _forward_wide(Tp, G2c, G1c, pairs, singles)
        else:
            T, kernel = _aligned_table(Tp), _cuda_build.forward_tc if route == "bf16" else _cuda_build.forward
            y = grouped_forward(_counted(lambda g2, g1, pr, sg: kernel(T, g2, g1, pr, sg), packed_forward,
                                         f"nsets={G2c.shape[0]}"), G2c, G1c, pairs, singles)
    else:
        raise ValueError(f"table on {Tp.device}, weights on {ref.device}")
    return list(torch.unbind(y))


def packed_adjoint_regen(xT, alpha, *, P: int, pairs: tuple, singles: tuple = (),
                         phase_gen: str = "doubling"):
    """`packed_adjoint` with the phases regenerated from the coordinates.

    Replaces the TPU kernel `_adjoint_kernel` (ops/pallas_ndft.py) in its
    "doubling" / "direct" modes.  xT: (Dtot, n) scaled window coordinates,
    P modes per row (the fused path keeps the Nyquist mode: P = N/2 + 1).
    Same outputs as `packed_adjoint`.  On CUDA tensors at 2P in
    REGEN_KERNEL_WIDTHS one launch of `adjoint_regen_tc_kernel`
    (csrc/packed_ndft_regen.cu): the 2-D windows on the tensor cores (3xTF32:
    about 3 * 2^-22 relative per product), their Nyquist columns and the 1-D
    windows on the CUDA cores; at the other widths the wide pair; on CPU
    tensors the plain version runs.
    """
    _check_coords(xT, pairs, singles)
    if phase_gen not in PHASE_GENS:
        raise ValueError(f"unknown phase_gen {phase_gen!r}, expected one of {PHASE_GENS}")
    a2d = _alpha_rows(alpha, xT.shape[1])
    if a2d.device.type == "cpu" and xT.device.type == "cpu":
        A2, A1 = packed_adjoint_regen_plain(xT, a2d, P, pairs, singles, phase_gen)
    elif a2d.is_cuda and xT.is_cuda:
        _check_cuda(xT, [a2d], (torch.float32,))
        if _route(2 * P, REGEN_KERNEL_WIDTHS) == "wide":
            A2, A1 = _adjoint_wide(xT, a2d, pairs, singles, P, phase_gen)
        else:
            A2, A1 = grouped_adjoint(_counted(lambda pr, sg: _cuda_build.adjoint_regen(xT, a2d, 2 * P, pr, sg,
                                                                                      phase_gen),
                                              packed_adjoint_regen, f"nv={a2d.shape[0]}"), pairs, singles)
    else:
        raise ValueError(f"coordinates on {xT.device}, alpha on {a2d.device}")
    return _adjoint_outputs(A2, A1, alpha.ndim == 2, len(pairs), len(singles))


def packed_forward_regen(xT, G2_sets, G1_sets=(), *, P: int, pairs: tuple, singles: tuple = (),
                         phase_gen: str = "doubling"):
    """`packed_forward` with the phases regenerated from the coordinates.

    Replaces the TPU kernel `_forward_kernel` (ops/pallas_ndft.py) in its
    "doubling" / "direct" modes.  xT: (Dtot, n); the weight stacks are
    (nsets, 2P, 2P) / (nsets, 2P) with 2P = 2 * P, per window or stacked
    over the windows as in `packed_forward`.  Returns nsets outputs.
    On CUDA tensors at 2P in REGEN_KERNEL_WIDTHS, per pass of up to 32 sets,
    one weight split and one `forward_regen_tc_kernel` launch
    (csrc/packed_ndft_regen.cu): the 2-D windows on the tensor cores
    (3xTF32), their Nyquist rows, the epilogue and the 1-D windows on the
    CUDA cores; at the other widths the wide pair; on CPU tensors the plain
    version runs.
    """
    _check_coords(xT, pairs, singles)
    if phase_gen not in PHASE_GENS:
        raise ValueError(f"unknown phase_gen {phase_gen!r}, expected one of {PHASE_GENS}")
    G2, G1 = _weight_stacks(G2_sets, G1_sets, 2 * P, pairs, singles)
    ref = G2 if G2 is not None else G1
    if ref.device.type == "cpu" and xT.device.type == "cpu":
        y = packed_forward_regen_plain(xT, G2, G1, P, pairs, singles, phase_gen)
    elif ref.is_cuda and xT.is_cuda:
        G2c, G1c = _dense_stacks(G2, G1, 2 * P, xT.device)
        _check_cuda(xT, [G2c, G1c], (torch.float32,))
        if _route(2 * P, REGEN_KERNEL_WIDTHS) == "wide":
            y = _forward_wide(xT, G2c, G1c, pairs, singles, P, phase_gen)
        else:
            y = grouped_forward(_counted(lambda g2, g1, pr, sg: _cuda_build.forward_regen(xT, g2, g1, 2 * P, pr, sg,
                                                                                         phase_gen),
                                         packed_forward_regen, f"nsets={G2c.shape[0]}"), G2c, G1c, pairs, singles)
    else:
        raise ValueError(f"coordinates on {xT.device}, weights on {ref.device}")
    return list(torch.unbind(y))


# --- the wide pair: every even 2P, every phase source -----------------------------------

_TABLE_DTYPES = (torch.bfloat16, torch.float32)


class LaunchCounter:
    """The launch counts of a kernel that several wrappers launch, kept as
    a wrapper keeps its own (`launches`, `launches_by_shape`)."""

    def __init__(self, name):
        self.__name__ = name


WIDE_ADJOINT = LaunchCounter("packed_adjoint_wide")
WIDE_FORWARD = LaunchCounter("packed_forward_wide")


def _point_ranges(src, W2):
    """[(i0, i1)]: the point ranges whose phase slab (Dtot, W2, i1 - i0)
    float32 stays within SLAB_BYTES."""
    Dtot, n = src.shape
    step = max(TABLE_PAD, SLAB_BYTES // (4 * Dtot * W2) // TABLE_PAD * TABLE_PAD)
    return [(i0, min(n, i0 + step)) for i0 in range(0, n, step)]


def _adjoint_wide(src, a2d, pairs, singles, P=None, phase_gen=None):
    """The wide adjoint on a table src (phase_gen None), or on the phases
    of coordinates src regenerated by phase_gen (P modes), range by range,
    the ranges' outputs summed in order."""
    if phase_gen is None:
        T = _aligned_table(src)
        return grouped_adjoint(_counted(lambda pr, sg: _cuda_build.adjoint_wide(T, a2d, pr, sg), WIDE_ADJOINT,
                                        f"2P={src.shape[1]} nv={a2d.shape[0]}"), pairs, singles)
    ranges = _point_ranges(src, 2 * P)
    for k, (i0, i1) in enumerate(ranges):
        alpha = a2d if len(ranges) == 1 else a2d[:, i0:i1].contiguous()
        R2, R1 = _adjoint_wide(_cuda_build.phases_wide(src[:, i0:i1], P, phase_gen), alpha, pairs, singles)
        A2, A1 = (R2, R1) if k == 0 else (A2 + R2, A1 + R1)
    return A2, A1


def _tf32(u):
    """float32 u rounded to tf32 to nearest, ties away from zero, on its bit
    pattern (tc_common.cuh tf32_rna)."""
    return ((u.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_weights_plain(G2):
    """The wide forward's weight split in torch (the plain version of
    csrc/packed_ndft_wide.cu wide_split_weights_kernel): G2 (nsets, npairs,
    2P, 2P) float32 -> (2, nsets, npairs, 2P, WRp) float32, WRp = 2P rounded
    up to 4 floats (16-byte rows for the TMA copies): [0] big = tf32(G2),
    [1] small = tf32(G2 - big), zeros in the pad; big + small is G2 to about
    2^-22 relative."""
    W2 = G2.shape[-1]
    out = G2.new_zeros((2, *G2.shape[:-1], -(-W2 // 4) * 4))
    big = _tf32(G2.contiguous())
    out[0, ..., :W2] = big
    out[1, ..., :W2] = _tf32(G2 - big)
    return out


def _forward_wide(src, G2c, G1c, pairs, singles, P=None, phase_gen=None):
    """The wide forward on a table src (phase_gen None), or on regenerated
    phases range by range as `_adjoint_wide`; the table's rows on 16-byte
    boundaries (`_aligned_table`)."""
    if phase_gen is None:
        T = _aligned_table(src)
        return grouped_forward(_counted(lambda g2, g1, pr, sg: _cuda_build.forward_wide(T, g2, g1, pr, sg),
                                        WIDE_FORWARD, f"2P={src.shape[1]} nsets={G2c.shape[0]}"),
                               G2c, G1c, pairs, singles)
    ranges = _point_ranges(src, 2 * P)
    if len(ranges) == 1:
        return _forward_wide(_cuda_build.phases_wide(src, P, phase_gen), G2c, G1c, pairs, singles)
    y = torch.empty((G2c.shape[0], src.shape[1]), dtype=torch.float32, device=src.device)
    for i0, i1 in ranges:
        y[:, i0:i1] = _forward_wide(_cuda_build.phases_wide(src[:, i0:i1], P, phase_gen), G2c, G1c, pairs, singles)
    return y


KERNEL_WRAPPERS = (packed_adjoint, packed_forward, packed_adjoint_regen, packed_forward_regen,
                   WIDE_ADJOINT, WIDE_FORWARD)


def _count(fn, shape):
    """One launch of fn's kernel, also counted by shape ("nv=10", "nsets=20")."""
    fn.launches += 1
    fn.launches_by_shape[shape] = fn.launches_by_shape.get(shape, 0) + 1


def _counted(launch, fn, shape):
    """launch, counting one launch of fn's kernel (`_count`) per call."""
    def counted(*args):
        out = launch(*args)
        _count(fn, shape)
        return out
    return counted


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_shape = {}


reset_launch_counts()
