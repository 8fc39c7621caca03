"""Port parity: the phase-regenerating NDFT (the plain versions of the fused
kernels), 3-feature windows, the fused engine and the engines' near-field
vs the JAX package on CPU, float64.  The JAX Pallas kernels run in
interpret mode with block=128, as tests/test_pallas_ndft.py runs them.

Tolerances:
- phase generators: 1e-12 absolute (the same recurrences in float64);
- regenerating adjoint/forward and the fused matvecs: 2e-6 relative to the
  largest entry -- the JAX kernels' dots return float32
  (preferred_element_type) even for float64 operands, the port stays in
  float64;
- the stream engine with a 3-feature window and the near-field: 2e-5 (the
  JAX table is stored in float32, as in test_torch_packed_ndft.py);
- d = 3 folding and folded adjoint/combine/forward, and the table engine
  with the near-field: 1e-10 relative to the largest entry (same formulas in
  float64).

The fused GPProblem is held against the JAX loss in
test_torch_fused_problem.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops import pallas_ndft as jpn
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops import packed_ndft as tpn
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

KERNEL_RTOL = 2e-6
EXACT_RTOL = 1e-10
BLOCK = 128
PAIRS = ((0, 1), (2, 3))
SINGLES = (4, 5)


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(89)
    return rng.uniform(-0.25, 0.25, size=(6, 300)), rng


@pytest.mark.parametrize("P", [17, 9])
@pytest.mark.parametrize("phase_gen", ["doubling", "direct"])
def test_phase_slab(rows, P, phase_gen):
    xT, _ = rows
    t = tpn.phase_slab(torch.tensor(xT), P, phase_gen).numpy()
    build = jpn._build_T6_doubling if phase_gen == "doubling" else jpn._build_T6
    j = np.asarray(build(jnp.asarray(xT), P))
    RP = ((P + 7) // 8) * 8                      # the JAX slab's padded rows
    np.testing.assert_allclose(t[:, :P], j[:, :P], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[:, P:], j[:, RP: RP + P], rtol=0, atol=1e-12)


@pytest.mark.parametrize("phase_gen", ["doubling", "direct"])
@pytest.mark.parametrize("nv", [None, 3])
def test_packed_adjoint_regen(rows, phase_gen, nv):
    xT, rng = rows
    P = 17
    alpha = rng.normal(size=(xT.shape[1],) if nv is None else (nv, xT.shape[1]))
    tA2, tA1 = tpn.packed_adjoint_regen(torch.tensor(xT), torch.tensor(alpha), P=P, pairs=PAIRS,
                                        singles=SINGLES, phase_gen=phase_gen)
    jA2, jA1 = jpn.packed_adjoint(jnp.asarray(xT), jnp.asarray(alpha), P=P, pairs=PAIRS,
                                  singles=SINGLES, block=BLOCK, interpret=True, phase_gen=phase_gen)
    for t, j in zip(tA2 + tA1, jA2 + jA1):
        _close(t, j, KERNEL_RTOL)


@pytest.mark.parametrize("phase_gen", ["doubling", "direct"])
@pytest.mark.parametrize("nsets", [1, 4])
def test_packed_forward_regen(rows, phase_gen, nsets):
    xT, rng = rows
    P = 9
    G2 = [rng.normal(size=(nsets, 2 * P, 2 * P)) for _ in PAIRS]
    G1 = [rng.normal(size=(nsets, 2 * P)) for _ in SINGLES]
    ty = tpn.packed_forward_regen(torch.tensor(xT), [torch.tensor(g) for g in G2],
                                  [torch.tensor(g) for g in G1], P=P, pairs=PAIRS, singles=SINGLES,
                                  phase_gen=phase_gen)
    jy = jpn.packed_forward(jnp.asarray(xT), [jnp.asarray(g) for g in G2], [jnp.asarray(g) for g in G1],
                            P=P, pairs=PAIRS, singles=SINGLES, block=BLOCK, interpret=True,
                            phase_gen=phase_gen)
    assert len(ty) == len(jy) == nsets
    for t, j in zip(ty, jy):
        _close(t, j, KERNEL_RTOL)


def test_regen_wrapper_rules(rows):
    xT, _ = rows
    x = torch.tensor(xT)
    before = tuple(f.launches for f in tpn.KERNEL_WRAPPERS)
    tpn.packed_adjoint_regen(x, torch.ones(x.shape[1], dtype=torch.float64), P=9, pairs=PAIRS)
    assert tuple(f.launches for f in tpn.KERNEL_WRAPPERS) == before   # CPU: no kernel
    with pytest.raises(ValueError):
        tpn.packed_adjoint_regen(x, torch.ones(x.shape[1] + 1, dtype=torch.float64), P=9, pairs=PAIRS)
    with pytest.raises(ValueError):
        tpn.packed_adjoint_regen(x, torch.ones(x.shape[1], dtype=torch.float64), P=9, pairs=((0, 9),))
    with pytest.raises(ValueError):
        tpn.packed_adjoint_regen(x, torch.ones(x.shape[1], dtype=torch.float64), P=9, pairs=PAIRS,
                                 phase_gen="table")


def test_folded_d3(rows):
    """fold_coeffs, folded adjoint / combine / forward of a 3-feature window."""
    _, rng = rows
    X = rng.uniform(size=(150, 3))
    alpha = rng.normal(size=150)
    tp, jp = TParams.make(1.0, 0.4, 0.05, dtype=torch.float64), JParams.make(1.0, 0.4, 0.05)
    tplan = tfs.fastsum_coeffs("gaussian", tp, tfs.fastsum_geometry(torch.tensor(X), 8))
    jplan = jfs.fastsum_coeffs("gaussian", jp, jfs.fastsum_geometry(jnp.asarray(X), 8))
    for name in ("b", "w", "dw_l"):
        _close(getattr(tplan, name), getattr(jplan, name), EXACT_RTOL)
    tA = tfs._folded_adjoint(tplan.geom.Tcs, torch.tensor(alpha))
    jA = jfs._folded_adjoint(jplan.geom.Tcs, jnp.asarray(alpha))
    _close(tA, jA, EXACT_RTOL)
    tB, jB = tfs._folded_combine(tplan.w, tA, 3), jfs._folded_combine(jplan.w, jA, 3)
    _close(tB, jB, EXACT_RTOL)
    _close(tfs._folded_forward(tplan.geom.Tcs, tB), jfs._folded_forward(jplan.geom.Tcs, jB), EXACT_RTOL)
    # batched rows give the rows' results
    tAb = tfs._folded_adjoint(tplan.geom.Tcs, torch.stack([torch.tensor(alpha), 2 * torch.tensor(alpha)]))
    _close(tAb[1], 2 * np.asarray(jA), EXACT_RTOL)


LAYOUTS = {
    "pairs_single": ([[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10]], 32, 400, 11),
    "rest_3d": ([[0, 1, 2], [3, 4]], 16, 200, 5),
}


@pytest.mark.parametrize("layout,nearfield", [("pairs_single", 0), ("pairs_single", 12), ("rest_3d", 0)])
def test_fused_matvecs(layout, nearfield):
    """The fused engine against the JAX fused path (the layouts of
    test_pallas_ndft.py), and its batched rows against single rows."""
    windows, N, n, d = LAYOUTS[layout]
    rng = np.random.default_rng(107)
    X = rng.uniform(size=(n, d))
    V = rng.normal(size=(2, n))
    tplan = tfs.additive_fastsum_build("gaussian", TParams.make(1.1, 0.5, 0.02, dtype=torch.float64),
                                       torch.tensor(X), t_windows(windows), N=N, nearfield_lfil=nearfield)
    jplan = jfs.additive_fastsum_build("gaussian", JParams.make(1.1, 0.5, 0.02), jnp.asarray(X),
                                       j_windows(windows), N=N, nearfield_lfil=nearfield)
    jkw = dict(block=BLOCK, interpret=True)
    jmv, jgrad = jax.jit(lambda v: (jfs.additive_fastsum_matvec_fused(jplan, v, **jkw),
                                    jfs.additive_fastsum_grad_matvec_fused(jplan, v, **jkw)))(
        jnp.asarray(V[0]))
    x = torch.tensor(V[0])
    _close(tfs.additive_fastsum_matvec_fused(tplan, x), jmv, KERNEL_RTOL)
    _close(tfs.additive_fastsum_grad_matvec_fused(tplan, x), jgrad, KERNEL_RTOL)
    Vb = torch.tensor(V)
    _close(tfs.additive_fastsum_matvec_fused_batch(tplan, Vb),
           torch.stack([tfs.additive_fastsum_matvec_fused(tplan, v) for v in Vb]), EXACT_RTOL)
    _close(tfs.additive_fastsum_grad_matvec_fused_batch(tplan, Vb),
           torch.stack([tfs.additive_fastsum_grad_matvec_fused(tplan, v) for v in Vb]), EXACT_RTOL)


def test_stream_engine_rest_and_nearfield():
    """The stream engine's plan with a 3-feature window (table path) and
    ELL near-field triples, against the JAX streamed plan (table_f32 kernels
    in interpret mode; 2e-5 as in test_torch_packed_ndft.py: the JAX table is
    stored in float32)."""
    windows = [[0, 1, 2], [3, 4], [5]]
    rng = np.random.default_rng(101)
    X = rng.uniform(size=(200, 6))
    V = rng.normal(size=(2, 200))
    kw = dict(interpret=True, upcast=True, prec="highest")
    jwin = np.asarray(j_windows(windows))

    @jax.jit
    def jrun(Xj, Vj):
        jplan = jfs.additive_fastsum_build("matern12", JParams.make(1.0, 0.4, 0.05), Xj, jwin,
                                           N=16, nearfield_lfil=6)
        jpn_ = jfs.packed_ndft_plan(jplan, block=BLOCK)
        return (jfs.packed_ndft_matvec(jpn_, Vj[0], **kw),
                jfs.packed_ndft_grad_matvec_batch(jpn_, Vj, **kw))

    tplan = tfs.additive_fastsum_build("matern12", TParams.make(1.0, 0.4, 0.05, dtype=torch.float64),
                                       torch.tensor(X), t_windows(windows), N=16, nearfield_lfil=6)
    tpn_ = tfs.packed_ndft_plan(tplan)
    assert len(tpn_.rest) == 1 and len(tpn_.nf) == 2
    jmv, jgrad = jrun(jnp.asarray(X), jnp.asarray(V))
    _close(tfs.packed_ndft_matvec(tpn_, torch.tensor(V[0])), jmv, 2e-5)
    _close(tfs.packed_ndft_grad_matvec_batch(tpn_, torch.tensor(V)), jgrad, 2e-5)


@pytest.mark.parametrize("sym", [True, False])
def test_table_engine_nearfield(sym):
    """matern12 table-engine matvecs with the KNN near-field (symmetrized or
    lower-triangular patterns) and a 3-feature window."""
    windows = [[0, 1, 2], [3, 4], [5]]
    rng = np.random.default_rng(97)
    X = rng.uniform(size=(240, 6))
    V = rng.normal(size=(2, 240))
    jgeom = jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(windows), N=16)
    pats = jax.jit(lambda g: jfs.additive_nearfield_patterns("matern12", g, 8))(jgeom)
    if sym:
        pats = jfs.symmetrize_nearfield_patterns(pats)
        assert all(p[2] for p in pats)

    @jax.jit
    def jrun(Vj):
        jplan = jfs.additive_fastsum_coeffs("matern12", JParams.make(1.0, 0.3, 0.05), jgeom,
                                            nearfield_lfil=8, nf_patterns=pats)
        return (jfs.additive_fastsum_matvec(jplan, Vj[0]),
                jax.vmap(lambda v: jfs.additive_fastsum_grad_matvec(jplan, v))(Vj))

    inj = state_from_numpy("cpu", nf_patterns=[(np.asarray(p[0]), np.asarray(p[1]), sym) for p in pats])
    tplan = tfs.additive_fastsum_coeffs(
        "matern12", TParams.make(1.0, 0.3, 0.05, dtype=torch.float64),
        tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(windows), N=16),
        nearfield_lfil=8, nf_patterns=inj.nf_patterns)
    jmv, jgrad = jrun(jnp.asarray(V))
    _close(tfs.additive_fastsum_matvec(tplan, torch.tensor(V[0])), jmv, EXACT_RTOL)
    _close(tfs.additive_fastsum_grad_matvec(tplan, torch.tensor(V)), jgrad, EXACT_RTOL)
