"""The TEST1 oracle slice: scripts/torch_test1_oracle.py's error table against
the same table made with the JAX package's functions (the code path of
scripts/test1_oracle.py: additive_kernel_matrix_with_grad, then
additive_fastsum_build / _matvec / _grad_matvec, the matern12 nf=0 row),
float64 on the CPU, n = 200, d = 4, the script's seed and windows.

Tolerances: each fast result (K@x, the three gradient rows, nf=0) within
1e-10 relative L2 of the JAX package's; each printed error within 1e-6
relative of JAX's (errors of 1e-6 to 1e-2 are differences of nearly equal
vectors, so their own rounding is about 1e-16 / error).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import additive_kernel_matrix_with_grad as j_kmat_grad
from nfft4gp_tpu.ops.kernels import make_windows as j_windows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS, DIM = 200, 4


def _oracle():
    spec = importlib.util.spec_from_file_location("torch_test1_oracle",
                                                  os.path.join(ROOT, "scripts", "torch_test1_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_table(args, windows_list):
    """The JAX script's computation, same data and order of rows."""
    rng = np.random.default_rng(906)
    X = jnp.asarray(rng.uniform(size=(args.n, args.d)))
    x = jnp.asarray(rng.normal(size=(args.n,)))
    p = JParams.make(args.f, args.l, args.mu, dtype=jnp.float64)
    windows = j_windows(windows_list)
    K, dK = j_kmat_grad(args.kernel, p, X, windows)
    exact = {"K@x": K @ x}
    dy_exact = jnp.einsum("knm,m->kn", dK, x)

    def build(lfil):
        return jax.jit(lambda Xv: jfs.additive_fastsum_build(args.kernel, p, Xv, windows, N=args.N,
                                                             nearfield_lfil=lfil))(X)

    plan = build(args.nearfield_lfil)
    fast = {"K@x": jax.jit(jfs.additive_fastsum_matvec)(plan, x)}
    dy_fast = jax.jit(jfs.additive_fastsum_grad_matvec)(plan, x)
    for j, name in enumerate(("dK/df@x", "dK/dl@x", "dK/dmu@x")):
        fast[name], exact[name] = dy_fast[j], dy_exact[j]
    if args.kernel == "matern12" and args.nearfield_lfil is None:
        fast["K@x nf=0"], exact["K@x nf=0"] = jax.jit(jfs.additive_fastsum_matvec)(build(0), x), exact["K@x"]
    rows = []
    for name in fast:
        diff = np.asarray(fast[name] - exact[name])
        bb = np.asarray(exact[name])
        linf, l2 = np.abs(diff).max(), np.linalg.norm(diff)
        rows.append((name, (linf, linf / np.abs(bb).max(), l2, l2 / np.linalg.norm(bb))))
    return rows, {k: np.asarray(v) for k, v in fast.items()}


@pytest.mark.parametrize("kernel", ["gaussian", "matern12"])
def test_oracle_table_matches_jax(kernel):
    import torch

    mod = _oracle()
    args = mod.build_argparser().parse_args(
        ["--n", str(N_PTS), "--d", str(DIM), "--kernel", kernel, "--platform", "cpu", "--x64"])
    table = mod.oracle_table(args, torch.device("cpu"))
    rows, fast = _jax_table(args, mod.windows_of(args.d))
    want_names = ["K@x", "dK/df@x", "dK/dl@x", "dK/dmu@x"] + (["K@x nf=0"] if kernel == "matern12" else [])
    assert [r[0] for r in table["rows"]] == [r[0] for r in rows] == want_names
    for name, want in fast.items():
        got = table["fast"][name]
        assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want), name
    for (name, got), (_, want) in zip(table["rows"], rows):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0, err_msg=name)
    text = mod.format_table(table)
    assert text.splitlines()[0].startswith(f"kernel={kernel} n={N_PTS} d={DIM} N=32 windows=")
    assert len(text.splitlines()) == 1 + len(want_names)
    if kernel == "matern12":
        # the near-field correction must beat the pure-Fourier operator
        errs = dict(table["rows"])
        assert errs["K@x"][3] < errs["K@x nf=0"][3]
