"""Port parity at the wide NDFT widths (2P beyond the narrow kernels' 16, 32,
18, 34) and the pieces of the accuracy-width path, against the JAX package
on CPU, float64:

- the plain versions of the packed adjoint and forward (what the wide
  kernels of csrc/packed_ndft_wide.cu compute, and what CPU tensors run) at
  2P = 8, 64, 130 and 256, a 2-D and a 1-D window, nv and nsets of 1 and 3,
  for a float32-style table ("table_f32") and both regenerating sources,
  against the JAX Pallas kernels in interpret mode (block=128);
- the wrapper's routes: on CPU tensors the plain versions serve every even
  width up to 258 and no kernel launch is counted;
- the wide kernels' N tiles (adjoint and forward) and the forward's split
  weights (`split_weights_plain`: tf32 halves in 16-byte rows, zeros in the
  pad, the plain forward unchanged on them to 1e-6);
- `psd_clip` (fastsum_coeffs, additive_fastsum_coeffs, one matvec) at
  matern12, N = 32 and 64, l = 0.1 (where these points give no negative
  coefficient) and l = 0.5 (where some are clipped);
- `packed_ndft_plan(nf_require_grad=False)`: the same K matvec, no dK/dl
  near-field;
- GPProblem(matern12, fastsum_N=64): the stream engine's loss against the
  JAX GPProblem's, and the fused engine's against the table engine's.

Tolerances: table kernels 2e-5 relative to the largest entry (the JAX table
is stored in float32 and alpha rounded to it in table_f32 mode, as in
test_torch_packed_ndft.py); regenerating kernels 2e-6 (the JAX kernels'
dots return float32, as in test_torch_fused.py); coefficients, near-field
values and matvecs 1e-10 (the same formulas in float64); losses as in
test_torch_nf_stencil.py (stream: loss rtol 1e-6, gradient 1e-5 of its
largest entry) and the fused engine against the table engine on the same
KNN patterns 1e-10 (the same untrimmed operator in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops import pallas_ndft as jpn
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops import packed_ndft as tpn
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

BLOCK = 128
PAIRS = ((0, 1),)
SINGLES = (2,)
RTOL = {"table_f32": 2e-5, "doubling": 2e-6, "direct": 2e-6}
EXACT = 1e-10
# (2P, nv = nsets): every width once, both counts twice
WIDE_CASES = [(8, 1), (64, 3), (130, 1), (256, 3)]


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(97)
    return rng.uniform(-0.25, 0.25, size=(3, 200)), rng


def _sources(xT, P, source):
    """(port source, JAX source, JAX keywords) of one phase source."""
    if source == "table_f32":
        return (tpn.pack_phase_table(torch.tensor(xT), P), jpn.pack_phase_table(jnp.asarray(xT), P, block=BLOCK),
                dict(prec="highest"))
    return torch.tensor(xT), jnp.asarray(xT), {}


@pytest.mark.parametrize("source", ["table_f32", "doubling", "direct"])
@pytest.mark.parametrize("W2,nv", WIDE_CASES)
def test_wide_adjoint_plain_vs_jax(rows, source, W2, nv):
    xT, rng = rows
    P = W2 // 2
    alpha = rng.normal(size=(xT.shape[1],) if nv == 1 else (nv, xT.shape[1]))
    tsrc, jsrc, jkw = _sources(xT, P, source)
    if source == "table_f32":
        tA2, tA1 = tpn.packed_adjoint(tsrc, torch.tensor(alpha), pairs=PAIRS, singles=SINGLES)
    else:
        tA2, tA1 = tpn.packed_adjoint_regen(tsrc, torch.tensor(alpha), P=P, pairs=PAIRS, singles=SINGLES,
                                            phase_gen=source)
    jA2, jA1 = jpn.packed_adjoint(jsrc, jnp.asarray(alpha), P=P, pairs=PAIRS, singles=SINGLES, block=BLOCK,
                                  interpret=True, phase_gen=source, **jkw)
    for t, j in zip(tA2 + tA1, jA2 + jA1):
        assert t.shape[-1] == W2
        _close(t, j, RTOL[source])


@pytest.mark.parametrize("source", ["table_f32", "doubling", "direct"])
@pytest.mark.parametrize("W2,nsets", WIDE_CASES)
def test_wide_forward_plain_vs_jax(rows, source, W2, nsets):
    xT, rng = rows
    P = W2 // 2
    G2 = [rng.normal(size=(nsets, W2, W2)) for _ in PAIRS]
    G1 = [rng.normal(size=(nsets, W2)) for _ in SINGLES]
    tsrc, jsrc, jkw = _sources(xT, P, source)
    tG2, tG1 = [torch.tensor(g) for g in G2], [torch.tensor(g) for g in G1]
    if source == "table_f32":
        ty = tpn.packed_forward(tsrc, tG2, tG1, pairs=PAIRS, singles=SINGLES)
        jkw["n_out"] = xT.shape[1]
    else:
        ty = tpn.packed_forward_regen(tsrc, tG2, tG1, P=P, pairs=PAIRS, singles=SINGLES, phase_gen=source)
    jy = jpn.packed_forward(jsrc, [jnp.asarray(g) for g in G2], [jnp.asarray(g) for g in G1], P=P, pairs=PAIRS,
                            singles=SINGLES, block=BLOCK, interpret=True, phase_gen=source, **jkw)
    assert len(ty) == len(jy) == nsets
    for t, j in zip(ty, jy):
        _close(t, j, RTOL[source])


@pytest.mark.parametrize("W2", [2, 16, 34, 48, 130, 258])
def test_cpu_tensors_take_plain_versions_at_every_width(rows, W2):
    """CPU tensors: every wrapper runs its plain version at any even width
    (the narrow kernels' widths and others), bitwise, and counts no launch,
    neither its own nor the wide pair's."""
    xT, rng = rows
    P = W2 // 2
    x = torch.tensor(xT)
    Tp = tpn.pack_phase_table(x, P)
    alpha = torch.tensor(rng.normal(size=(2, xT.shape[1])))
    G2 = [torch.tensor(rng.normal(size=(2, W2, W2)))]
    G1 = [torch.tensor(rng.normal(size=(2, W2)))]
    tpn.reset_launch_counts()
    A2, A1 = tpn.packed_adjoint(Tp, alpha, pairs=PAIRS, singles=SINGLES)
    B2, B1 = tpn.packed_adjoint_plain(Tp, alpha, PAIRS, SINGLES)
    assert torch.equal(A2[0], B2[:, 0]) and torch.equal(A1[0], B1[:, 0]) and A2[0].shape == (2, W2, W2)
    y = tpn.packed_forward(Tp, G2, G1, pairs=PAIRS, singles=SINGLES)
    assert torch.equal(torch.stack(y), tpn.packed_forward_plain(Tp, torch.stack(G2, 1), torch.stack(G1, 1), PAIRS,
                                                                SINGLES))
    for gen in tpn.PHASE_GENS:
        R2, R1 = tpn.packed_adjoint_regen(x, alpha, P=P, pairs=PAIRS, singles=SINGLES, phase_gen=gen)
        S2, S1 = tpn.packed_adjoint_regen_plain(x, alpha, P, PAIRS, SINGLES, gen)
        assert torch.equal(R2[0], S2[:, 0]) and torch.equal(R1[0], S1[:, 0])
        yr = tpn.packed_forward_regen(x, G2, G1, P=P, pairs=PAIRS, singles=SINGLES, phase_gen=gen)
        yw = tpn.packed_forward_regen_plain(x, torch.stack(G2, 1), torch.stack(G1, 1), P, PAIRS, SINGLES, gen)
        assert torch.equal(torch.stack(yr), yw)
    assert tpn.WIDE_ADJOINT in tpn.KERNEL_WRAPPERS and tpn.WIDE_FORWARD in tpn.KERNEL_WRAPPERS
    assert all(fn.launches == 0 and fn.launches_by_shape == {} for fn in tpn.KERNEL_WRAPPERS)


@pytest.mark.parametrize("n,W2", [(1, 1026), (997, 130), (100_000, 130), (1_000_000, 1026)])
def test_point_ranges_bound_the_phase_slab(n, W2):
    """The regenerating sources' slab on the wide kernels: ranges of whole
    TABLE_PAD tiles (the last ragged) that cover the points in order, each
    slab within SLAB_BYTES (10 coordinate rows) and as long as that
    allows."""
    ranges = tpn._point_ranges(torch.empty((10, n)), W2)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all((i1 - i0) % tpn.TABLE_PAD == 0 for i0, i1 in ranges[:-1])
    assert all(4 * 10 * W2 * (i1 - i0) <= tpn.SLAB_BYTES for i0, i1 in ranges)
    if len(ranges) > 1:                      # no range could take one more tile
        assert 4 * 10 * W2 * (ranges[0][1] + tpn.TABLE_PAD) > tpn.SLAB_BYTES


def test_cuda_routes_by_width():
    """The width rule of CUDA tensors, decided before any launch: the narrow
    kernels' widths, every other even 2P (1028 and 2050 too: the wide pair
    has no width cap) to the wide pair, odd ones raise."""
    assert tpn._route(32, tpn.KERNEL_WIDTHS) == "narrow"
    assert tpn._route(34, tpn.REGEN_KERNEL_WIDTHS) == "narrow"
    assert tpn._route(34, tpn.KERNEL_WIDTHS) == "wide"
    for W2 in (2, 8, 64, 130, 256, 258, 600, 1026, 1028, 2050):
        assert tpn._route(W2, tpn.KERNEL_WIDTHS) == "wide"
    for W2 in (0, 33, 1027):
        with pytest.raises(ValueError):
            tpn._route(W2, tpn.KERNEL_WIDTHS)


def test_wide_adjoint_tiles_are_compiled_widths():
    """The wide adjoint's N tiles (`wide_tiles`, as csrc/packed_ndft_wide.cu
    wg_tiles) at every even 2P to 4096: ceil(2P / 144) tiles, each the
    narrowest compiled width (64, 72, 128, 136, 144) that covers 2P with
    them; 128-row blocks over the nv 2P rows in 64-row tiles."""
    from nfft4gp_torch.ops import _cuda_build as cb

    widths = (64, 72, 128, 136, 144)
    for W2 in range(2, 4098, 2):
        nt, ntn, mblocks = cb.wide_tiles(W2, 3)
        assert ntn == -(-W2 // 144)
        assert nt == min(w for w in widths if w * ntn >= W2)
        assert mblocks == -(-(-(-3 * W2 // 64)) // 2)
    assert [cb.wide_tiles(W2, 1)[:2] for W2 in (2, 66, 130, 144, 146, 256, 258, 1030)] == [
        (64, 1), (72, 1), (136, 1), (144, 1), (128, 2), (128, 2), (136, 2), (136, 8)]


def test_wide_forward_tiles_are_compiled_widths():
    """The wide forward's N tiles (`wide_forward_tiles`, as
    csrc/packed_ndft_wide.cu fw_tile) at every even 2P to 4096: ceil(2P /
    136) tiles, each the narrowest compiled width (64, 72, 128, 136) that
    covers 2P with them."""
    from nfft4gp_torch.ops import _cuda_build as cb

    widths = (64, 72, 128, 136)
    for W2 in range(2, 4098, 2):
        nt, ntn = cb.wide_forward_tiles(W2)
        assert ntn == -(-W2 // 136) == -(-W2 // nt)
        assert nt == min(w for w in widths if w * ntn >= W2)
    assert [cb.wide_forward_tiles(W2) for W2 in (2, 66, 130, 136, 138, 144, 146, 256, 258, 1030, 2050)] == [
        (64, 1), (72, 1), (136, 1), (136, 1), (72, 2), (72, 2), (128, 2), (128, 2), (136, 2), (136, 8), (136, 16)]


@pytest.mark.parametrize("W2", [8, 64, 128, 130, 258])
def test_split_weight_stacks(rows, W2):
    """`split_weights_plain` (the wide forward's weights as its kernel reads
    them, the plain version of its split kernel): rows padded to 4 floats
    with zeros in the pad, big and small tf32 (13 low bits zero), big +
    small = G to 2^-21 relative, and the plain forward on big + small equal
    to the plain forward on G to 1e-6."""
    xT, rng = rows
    P = W2 // 2
    Tp = tpn.pack_phase_table(torch.tensor(xT, dtype=torch.float32), P)
    G2 = torch.tensor(rng.normal(size=(3, len(PAIRS), W2, W2)), dtype=torch.float32)
    split = tpn.split_weights_plain(G2)
    assert tuple(split.shape) == (2, 3, len(PAIRS), W2, -(-W2 // 4) * 4)
    assert not split[..., W2:].any()
    assert not (split.view(torch.int32) & 0x1FFF).any()
    big, small = split[0, ..., :W2].double(), split[1, ..., :W2].double()
    assert float(((big + small - G2.double()).abs() - 2.0 ** -21 * G2.double().abs()).max()) <= 0
    assert float((small.abs() - 2.0 ** -10 * big.abs()).max()) <= 0
    y = tpn.packed_forward_plain(Tp, (big + small).float(), None, PAIRS, ())
    want = tpn.packed_forward_plain(Tp, G2, None, PAIRS, ())
    assert float(torch.linalg.norm(y - want) / torch.linalg.norm(want)) <= 1e-6


@pytest.mark.parametrize("kind", ["adjoint", "forward"])
def test_doubling_plain_vs_jax_at_1030(rows, kind):
    """Past the old 1026 cap: the plain versions at 2P = 1030 (doubling,
    P = 515, the recurrence's tenth doubling) against the JAX kernel in
    interpret mode, n = 200, one 2-D and one 1-D window, nv = nsets = 2."""
    xT, rng = rows
    W2, P = 1030, 515
    x = torch.tensor(xT)
    if kind == "adjoint":
        alpha = rng.normal(size=(2, xT.shape[1]))
        tA2, tA1 = tpn.packed_adjoint_regen(x, torch.tensor(alpha), P=P, pairs=PAIRS, singles=SINGLES)
        jA2, jA1 = jpn.packed_adjoint(jnp.asarray(xT), jnp.asarray(alpha), P=P, pairs=PAIRS, singles=SINGLES,
                                      block=BLOCK, interpret=True, phase_gen="doubling")
        for t, j in zip(tA2 + tA1, jA2 + jA1):
            assert t.shape[-1] == W2
            _close(t, j, RTOL["doubling"])
    else:
        G2 = [rng.normal(size=(2, W2, W2)) for _ in PAIRS]
        G1 = [rng.normal(size=(2, W2)) for _ in SINGLES]
        ty = tpn.packed_forward_regen(x, [torch.tensor(g) for g in G2], [torch.tensor(g) for g in G1], P=P,
                                      pairs=PAIRS, singles=SINGLES)
        jy = jpn.packed_forward(jnp.asarray(xT), [jnp.asarray(g) for g in G2], [jnp.asarray(g) for g in G1], P=P,
                                pairs=PAIRS, singles=SINGLES, block=BLOCK, interpret=True, phase_gen="doubling")
        for t, j in zip(ty, jy):
            _close(t, j, RTOL["doubling"])


# --- psd_clip and solve-only plans -----------------------------------------------------

M12 = (1.0, 0.1, 0.01)


@pytest.fixture(scope="module")
def m12_points():
    rng = np.random.default_rng(101)
    return rng.uniform(size=(300, 3)), rng.normal(size=300)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("l", [0.1, 0.5])
def test_psd_clip_matches_jax(m12_points, N, l):
    """At l = 0.1 no matern12 coefficient of these uniform points is
    negative (the clip changes nothing); at l = 0.5 the 2-D window's are
    (6 at N = 32, 38 at N = 64), and the clipped ones are zero."""
    X, v = m12_points
    windows = [[0, 1], [2]]
    tp = TParams.make(1.0, l, 0.01, dtype=torch.float64)
    jp = JParams.make(1.0, l, 0.01)
    tg = tfs.fastsum_geometry(torch.tensor(X[:, :2]), N)
    jg = jfs.fastsum_geometry(jnp.asarray(X[:, :2]), N)
    raw = tfs.fastsum_coeffs("matern12", tp, tg, nearfield_lfil=0)
    t = tfs.fastsum_coeffs("matern12", tp, tg, psd_clip=True, nearfield_lfil=0)
    j = jfs.fastsum_coeffs("matern12", jp, jg, psd_clip=True, nearfield_lfil=0)
    clipped = raw.b < 0
    assert int(clipped.sum()) == (0 if l == 0.1 else {32: 6, 64: 38}[N])
    assert torch.equal(t.b, torch.where(clipped, torch.zeros_like(raw.b), raw.b))
    assert torch.equal(t.db_l, raw.db_l)                                # derivatives are never clipped
    for name in ("b", "db_l", "w", "dw_l"):
        _close(getattr(t, name), getattr(j, name), EXACT)
    tg2 = tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(windows), N=N)
    jg2 = jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(windows), N=N)
    tplan = tfs.additive_fastsum_coeffs("matern12", tp, tg2, psd_clip=True, nearfield_lfil=0)
    jplan = jfs.additive_fastsum_coeffs("matern12", jp, jg2, psd_clip=True, nearfield_lfil=0)
    for (_, _, tpls), (_, _, jpls) in zip(tplan.groups, jplan.groups):
        for k, pl in enumerate(tpls):
            assert float(pl.b.min()) >= 0.0
            _close(pl.w, jpls.w[k], EXACT)
    _close(tfs.additive_fastsum_matvec(tplan, torch.tensor(v)), jfs.additive_fastsum_matvec(jplan, jnp.asarray(v)),
           EXACT)


def test_solve_only_plan_matches_jax(m12_points):
    """nf_require_grad=False: the packed plan's K matvec equals the full
    plan's and JAX's; no dK/dl near-field is held, and asking for it
    raises."""
    X, v = m12_points
    X = X[:, :2]
    windows = [[0, 1]]
    tg = tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(windows), N=32)
    jg = jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(windows), N=32)
    ts = tfs.additive_nearfield_stencil_direct(tg, "matern12", 12)
    js = jfs.additive_nearfield_stencil_direct(jg, "matern12", 12)
    tplan = tfs.additive_fastsum_coeffs("matern12", TParams.make(*M12, dtype=torch.float64), tg, psd_clip=True,
                                        nearfield_lfil=0)
    jplan = jfs.additive_fastsum_coeffs("matern12", JParams.make(*M12), jg, psd_clip=True, nearfield_lfil=0)
    full = tfs.packed_ndft_plan(tplan, nf_stencils=ts)
    solve = tfs.packed_ndft_plan(tplan, nf_stencils=ts, nf_require_grad=False)
    jsolve = jfs.packed_ndft_plan(jplan, nf_stencils=js, nf_require_grad=False, block=BLOCK)
    assert all(e.A_l is not None for e in full.nf) and all(e.A_l is None for e in solve.nf)
    assert all(e.A_l is None for e in jsolve.nf2)
    for a, b in zip(full.nf, solve.nf):
        assert torch.equal(a.A_k, b.A_k)
    vt = torch.tensor(v)
    assert torch.equal(tfs.packed_ndft_matvec(solve, vt), tfs.packed_ndft_matvec(full, vt))
    _close(tfs.packed_ndft_matvec(solve, vt),
           jfs.packed_ndft_matvec(jsolve, jnp.asarray(v), interpret=True, upcast=True, prec="highest"), 2e-5)
    with pytest.raises(ValueError):
        tfs.packed_ndft_grad_matvec(solve, vt)


# --- GPProblem at fastsum_N = 64 ---------------------------------------------------------

def test_problem_matern12_n64_engines():
    """GPProblem(matern12, fastsum_N=64) on the CPU: the stream engine (a
    2P = 64 table, radius near-field) against the JAX GPProblem, and the
    fused engine (2P = 66) against the table engine on the same KNN
    patterns, probes and landmarks."""
    rng = np.random.default_rng(103)
    n = 240
    X = rng.uniform(size=(n, 3))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)
    kw = dict(kernel="matern12", windows=[[0, 1], [2]], operator="fastsum", precond="nystrom", rank=16, maxits=6,
              nvecs=4, fastsum_N=64, fastsum_table_dtype=None, seed=3)
    probes = j_probes(jax.random.PRNGKey(kw["seed"] + 1), kw["nvecs"], n, dtype=jnp.float64)
    perm = j_rand_perm(jax.random.PRNGKey(kw["seed"]), n, kw["rank"])
    inj = state_from_numpy("cpu", landmarks=np.asarray(perm), probes=np.asarray(probes))
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.5], dtype=torch.float64))
    Xt, yt = torch.tensor(X), torch.tensor(y)

    jl, jgrad = JProblem(fastsum_engine="stream", **kw).make_loss(jnp.asarray(X), jnp.asarray(y))(
        jnp.asarray(raw.numpy()))
    stream = TProblem(fastsum_engine="stream", **kw)
    sl, sgrad = stream.make_loss(Xt, yt, probes=inj.probes, landmarks=inj.landmarks)(raw)
    assert all(s is not None for s in stream.nf_stencils_)
    np.testing.assert_allclose(float(sl), float(jl), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(sgrad.numpy(), jgrad, rtol=1e-5, atol=1e-5 * np.abs(jgrad).max())

    fused = TProblem(fastsum_fused=True, **kw)
    fl, fgrad = fused.make_loss(Xt, yt, probes=inj.probes, landmarks=inj.landmarks)(raw)
    tl, tgrad = TProblem(fastsum_engine="table", **kw).make_loss(
        Xt, yt, probes=inj.probes, landmarks=inj.landmarks, nf_patterns=fused.nf_patterns_)(raw)
    assert np.isfinite(float(fl))
    np.testing.assert_allclose(float(fl), float(tl), rtol=EXACT)
    np.testing.assert_allclose(fgrad.numpy(), tgrad.numpy(), rtol=EXACT, atol=EXACT * float(tgrad.abs().max()))
