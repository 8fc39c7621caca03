"""The port's profiling and probe scripts on the CPU: scripts/torch_loss_profile.py,
torch_loss_bench.py, torch_setup_timing.py, torch_afn_solve_profile.py,
torch_rank_dispatch_probe.py and torch_op_accuracy_probe.py, against the JAX
scripts' rows and keys and against the JAX package's functions.

- Each script's main(argv) with --platform cpu at a small size writes the JAX
  script's row names and keys.
- The loss profile's FGMRES solution, SLQ logdet and traces and gp_loss with
  Nystrom, on the table engine (the operator both packages compute alike in
  float64: the JAX stream engine's kernels round to float32) against
  solvers/fgmres.py, solvers/lanczos.py slq_logdet and models/gp.py gp_loss,
  the probes drawn by jax.random and handed over: rtol 1e-8.  The loss
  bench's loss (table engine with Nystrom, and the dense operator) against
  the JAX GPProblem's, its probes and landmarks handed over: rtol 1e-8.
- The AFN apply profile's parts against the JAX AfnPrecond's own pieces on
  the same plan (the gather, the triangular solve, the K12 product, the
  FSAI forward and transpose products, the whole solve), float64: rtol 1e-10.
- The rank dispatch at n = 2000 on the JAX subsample draw: the branch and k
  of JAX's afn_plan, and the PCG iteration count with its preconditioner
  within one of JAX's pcg (without one within 3%: ~230 steps whose count
  rounding sets); the n = 2e4 draw of
  tests/goldens/rank_dispatch_subsamples_2e4.json against jax.random.
- The port's copy of host_reference_matvec equals the JAX script's bit for
  bit, and the table engine's error rows agree with the JAX package's
  additive_fastsum_matvec errors to 1e-6 absolute (float32, n = 2000).
"""

import importlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.gp import GPConfig as JConfig
from nfft4gp_tpu.models.gp import gp_loss as j_gp_loss
from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import kernel_matrix as j_kernel_matrix
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.ops.matops import ell_matvec as j_ell_matvec
from nfft4gp_tpu.ops.matops import ell_rmatvec as j_ell_rmatvec
from nfft4gp_tpu.preconds.afn import AfnPlan as JAfnPlan
from nfft4gp_tpu.preconds.afn import afn_plan as j_afn_plan
from nfft4gp_tpu.preconds.afn import afn_setup_from_plan as j_afn_setup
from nfft4gp_tpu.preconds.nystrom import nystrom_setup as j_nystrom_setup
from nfft4gp_tpu.solvers.fgmres import fgmres as j_fgmres
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.solvers.lanczos import slq_logdet as j_slq_logdet
from nfft4gp_tpu.solvers.pcg import pcg as j_pcg
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
CPU = torch.device("cpu")
RTOL = 1e-8
AFN_RTOL = 1e-10
GOLDEN = os.path.join(ROOT, "tests", "goldens", "rank_dispatch_subsamples_2e4.json")


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


def _jax_script(name):
    """A JAX script loaded by path (its module level imports numpy only)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_subsamples(n, nsample=500, nsample_r=2):
    """The subsamples JAX's afn_plan draws by default (PRNGKey(0))."""
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(nsample_r):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.choice(sub, n, (min(nsample, n),), replace=False)))
    return subs


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


LOSS_ROWS = ["coeffs+plan build", "matvec single", "matvec batch x3", "fgmres 2*maxits", "slq (no precond)",
             "nystrom setup (grad)", "batched eigh (nvecs,m,m)", "gp_loss precond=none", "gp_loss precond=nystrom"]
AFN_ROWS = ["afn.solve", "perm gather x[perm]", "unperm scatter", "chol_solve k", "K12' gemv", "fsai ell fwd",
            "fsai ell transpose", "afn.dvp x10"]
RANK_KEYS = ["l", "branch", "expected", "k", "plan_s", "pcg_iters", "pcg_relres", "pcg_iters_noprecond",
             "relres_noprecond"]

MAIN_CASES = {
    "loss_profile": ("torch_loss_profile", ["--n", "300", "--d", "4", "--nvecs", "3", "--maxits", "4", "--rank",
                                            "20", "--reps", "1"]),
    "loss_bench": ("torch_loss_bench", ["--n", "300", "--d", "4", "--nvecs", "3", "--maxits", "4", "--reps", "1"]),
    "setup_timing_bf16": ("torch_setup_timing", ["--n", "500", "--d", "4"]),
    "setup_timing_f32": ("torch_setup_timing", ["--n", "500", "--d", "4", "--table-dtype", "float32"]),
    "afn_solve_profile": ("torch_afn_solve_profile", ["--n", "400", "--d", "4", "--rank", "20", "--lfil", "8",
                                                      "--iters", "1"]),
    "rank_dispatch": ("torch_rank_dispatch_probe", ["--n", "600"]),
    "op_accuracy": ("torch_op_accuracy_probe", ["--n", "300", "--d", "4"]),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_writes_the_jax_rows_and_keys(case, tmp_path):
    name, argv = MAIN_CASES[case]
    path = tmp_path / "out.json"
    out = _script(name).main(argv + ["--platform", "cpu", "--json", str(path)])
    with open(path) as f:
        doc = json.load(f)
    assert doc == json.loads(json.dumps(out))
    assert doc.get("device", "cpu") == "cpu"
    if case == "loss_profile":
        assert {"n", "d", "nvecs", "maxits", "rank", "rows"} <= set(doc)
        assert list(doc["rows"]) == LOSS_ROWS and all(v > 0 for v in doc["rows"].values())
        assert all(v is None for v in doc["card_ms"].values())
    elif case == "loss_bench":
        assert [r["engine"] for r in doc["results"]] == ["table", "stream"]
        for r in doc["results"]:
            assert {"engine", "n", "d", "nvecs", "maxits", "ms_per_loss_step", "loss"} <= set(r)
            assert np.isfinite(r["loss"]) and r["ms_per_loss_step"] > 0
        assert np.isfinite(doc["loss_delta"]) and doc["config"]["n"] == 300
    elif case.startswith("setup_timing"):
        assert {"n", "d", "N", "kind", "table_dtype", "stages"} <= set(doc)
        assert list(doc["stages"]) == ["transfer", "geometry", "coeffs", "packed", "matvec", "matvec_tab"]
        assert all(set(s) == {"cold_s", "warm_s"} for s in doc["stages"].values())
        assert doc["stages"]["transfer"]["warm_s"] is None and doc["build_s"] is None
    elif case == "afn_solve_profile":
        assert list(doc["rows"]) == AFN_ROWS and all(v > 0 for v in doc["rows"].values())
    elif case == "rank_dispatch":
        with open(os.path.join(ROOT, "RANK_DISPATCH.json")) as f:
            jax_doc = json.load(f)
        assert set(jax_doc) <= set(doc) and list(doc["cases"]) == list(jax_doc["cases"])
        for rec in doc["cases"].values():
            assert sorted(rec) == sorted(RANK_KEYS)
            assert rec["branch"] == rec["expected"]
    else:
        assert list(doc["rows"]) == ["compensated=False", "compensated=True", "packed bf16"]
        for row, rec in doc["rows"].items():
            assert rec["rel_err"] <= doc["limits"][row] and rec["host_ms"] > 0


# --- the loss profile and the loss bench against the JAX functions -------------

def _table_build(geom):
    """The port's table engine as a params -> (matvec, dmatvec) factory."""
    from nfft4gp_torch.models.problem import _ops
    from nfft4gp_torch.ops import fastsum as fs

    def build(params):
        plan = fs.additive_fastsum_coeffs("gaussian", params, geom)
        return _ops(lambda V: fs.additive_fastsum_matvec(plan, V), lambda V: fs.additive_fastsum_grad_matvec(plan, V))

    return build


def test_loss_profile_rows_match_jax():
    from nfft4gp_torch.ops import fastsum as fs

    lp = _script("torch_loss_profile")
    args = lp.build_argparser().parse_args(["--n", "200", "--d", "4", "--nvecs", "4", "--maxits", "6",
                                            "--rank", "16"])
    X, y, _, perm, T = lp.make_problem(args, CPU, torch.float64)
    Z = np.array(j_probes(jax.random.PRNGKey(1), args.nvecs, args.n, dtype=jnp.float64))
    geom = fs.additive_fastsum_geometry(X, lp.windows_of(args.d))
    fns = lp.row_fns(args, geom, _table_build(geom), X, y, torch.from_numpy(Z), perm, T, None)
    x = fns["fgmres 2*maxits"]().numpy()
    slq = fns["slq (no precond)"]()
    loss_nys = float(fns["gp_loss precond=nystrom"]())

    windows = j_windows([[i, i + 1] for i in range(0, args.d, 2)])
    cfg = JConfig(kind="gaussian", maxits=args.maxits, nvecs=args.nvecs, tol=lp.FGMRES_TOL)
    its = 2 * args.maxits

    def jbuild(Xv):
        g = jfs.additive_fastsum_geometry(Xv, windows)

        def build(p):
            plan = jfs.additive_fastsum_coeffs("gaussian", p, g)
            return ((lambda v: jfs.additive_fastsum_matvec(plan, v)),
                    (lambda v: jfs.additive_fastsum_grad_matvec(plan, v)))

        return build

    @jax.jit
    def jax_rows(Xv, yv, Zv, pm):
        build = jbuild(Xv)
        p = JParams.make(1.0, 0.5, 0.1, dtype=jnp.float64)
        mv, dmv = build(p)
        xs = j_fgmres(mv, yv, kdim=its, maxits=its, tol=lp.FGMRES_TOL).x
        r = j_slq_logdet(mv, dmv, Zv, maxits=args.maxits)
        setup = lambda q: j_nystrom_setup("gaussian", q, Xv, pm, args.rank, require_grad=True,  # noqa: E731
                                          windows=windows)
        loss = j_gp_loss(jnp.asarray(lp.RAW, jnp.float64), yv, build, Zv, cfg, setup).loss
        return xs, r.logdet, r.dlogdet, loss

    jx, jld, jdld, jloss = jax_rows(jnp.asarray(X.numpy()), jnp.asarray(y.numpy()), jnp.asarray(Z),
                                    jnp.asarray(perm.numpy()))
    assert _rel(x, jx) <= RTOL
    np.testing.assert_allclose(float(slq.logdet), float(jld), rtol=RTOL)
    np.testing.assert_allclose(slq.dlogdet.numpy(), np.asarray(jdld), rtol=RTOL)
    np.testing.assert_allclose(loss_nys, float(jloss), rtol=RTOL)


@pytest.mark.parametrize("operator,precond", [("fastsum", "nystrom"), ("dense", "none")])
def test_loss_bench_loss_matches_jax(operator, precond):
    lb = _script("torch_loss_bench")
    args = lb.build_argparser().parse_args(["--n", "200", "--d", "4", "--nvecs", "4", "--maxits", "6", "--reps",
                                            "1", "--operator", operator, "--precond", precond])
    X, y, raw = lb.make_problem(args, CPU, torch.float64)
    Z = j_probes(jax.random.PRNGKey(1), args.nvecs, args.n, dtype=jnp.float64)
    perm = j_rand_perm(jax.random.PRNGKey(0), args.n, 64)
    engine = "table" if operator == "fastsum" else "dense"
    row = lb.engine_row(args, engine, X, y, raw, probes=torch.from_numpy(np.array(Z)),
                        landmarks=torch.from_numpy(np.array(perm)))
    jprob = JProblem(kernel="gaussian", windows=[[0, 1], [2, 3]], operator=operator, precond=precond, rank=64,
                     maxits=args.maxits, nvecs=args.nvecs, fastsum_N=32, fastsum_engine="table", seed=0)
    jloss = jprob.make_loss(jnp.asarray(X.numpy()), jnp.asarray(y.numpy()))(jnp.asarray(raw.numpy()))[0]
    np.testing.assert_allclose(row["loss"], float(jloss), rtol=RTOL)


# --- the AFN apply's parts ----------------------------------------------------

def test_afn_parts_match_jax():
    from nfft4gp_torch.preconds.afn import afn_setup_from_plan

    ap = _script("torch_afn_solve_profile")
    args = ap.build_argparser().parse_args(["--n", "300", "--d", "4", "--rank", "20", "--lfil", "8"])
    X, r, params, windows, plan = ap.make_plan(args, CPU, torch.float64)
    afn = afn_setup_from_plan("gaussian", params, X, plan, require_grad=True, windows=windows)
    got = {name: fn(r).numpy() for name, fn in ap.part_fns(afn).items()}
    assert int(afn.breakdown) == 0

    k = args.rank
    jplan = JAfnPlan(perm=plan.perm.numpy(), k=k, use_ran=False,
                     pattern=(plan.pattern[0].numpy(), plan.pattern[1].numpy()))
    jwin = j_windows([[i, i + 1] for i in range(0, args.d, 2)])

    @jax.jit
    def jax_parts(Xv, v):
        pre = j_afn_setup("gaussian", JParams.make(1.0, 0.5, 0.01, dtype=jnp.float64), Xv, jplan, windows=jwin)
        tail = v[k:]
        return {"afn.solve": pre.solve(v), "perm gather x[perm]": v[pre.perm],
                "unperm scatter": jnp.zeros_like(v).at[pre.perm].set(v),
                "chol_solve k": jax.scipy.linalg.solve_triangular(pre.L11, v[:k], lower=True),
                "K12' gemv": jnp.matmul(pre.K12, tail, precision="highest"),
                "fsai ell fwd": j_ell_matvec(pre.gs.idx, pre.gs.val, tail),
                "fsai ell transpose": j_ell_rmatvec(pre.gs.idx, pre.gs.val, tail)}

    want = jax_parts(jnp.asarray(X.numpy()), jnp.asarray(r.numpy()))
    # the port un-permutes by a gather: applied to y[perm] it gives back y,
    # which the scatter of y[perm] at perm gives too
    np.testing.assert_array_equal(got["unperm scatter"][plan.perm.numpy()], r.numpy())
    np.testing.assert_array_equal(np.asarray(want["unperm scatter"])[plan.perm.numpy()], r.numpy())
    for name in ("afn.solve", "perm gather x[perm]", "chol_solve k", "K12' gemv", "fsai ell fwd",
                 "fsai ell transpose"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=AFN_RTOL, atol=0, err_msg=name)


# --- the rank dispatch ----------------------------------------------------------

RANK_N = 2000


@pytest.mark.parametrize("kind,l", [("gaussian", 0.5), ("matern12", 0.05)])
def test_rank_dispatch_matches_jax(kind, l):  # noqa: E741
    rd = _script("torch_rank_dispatch_probe")
    X, b = rd.make_problem(RANK_N, CPU)
    rec = rd.run_case(kind, l, X, b, _jax_subsamples(RANK_N))

    Xj, bj = jnp.asarray(X.numpy()), jnp.asarray(b.numpy())
    params = JParams.make(1.0, l, 0.01, dtype=jnp.float64)
    plan = j_afn_plan(kind, params, Xj, maxrank=rd.MAXRANK, lfil=rd.LFIL)
    assert (rec["branch"], rec["k"]) == ("ran" if plan.use_ran else "afn", int(plan.k))

    @jax.jit
    def iterations(Xv, bv):
        pre = j_afn_setup(kind, params, Xv, plan)
        K = j_kernel_matrix(kind, params, Xv)
        mv = lambda v: jnp.matmul(K, v, precision="highest")  # noqa: E731
        return (j_pcg(mv, bv, precond=pre.solve, tol=rd.PCG_TOL, maxits=rd.PCG_MAXITS).niter,
                j_pcg(mv, bv, tol=rd.PCG_TOL, maxits=rd.PCG_MAXITS).niter)

    its, its0 = iterations(Xj, bj)
    assert abs(rec["pcg_iters"] - int(its)) <= 1
    # without a preconditioner matern12 takes ~230 float64 CG steps, whose
    # count is set by rounding: on these points 231 to 236 between the
    # product's summation orders and K's last bits (the port's pcg on JAX's
    # K gives JAX's 234), so 3% here
    assert abs(rec["pcg_iters_noprecond"] - int(its0)) <= max(1, 0.03 * int(its0))
    assert rec["pcg_relres"] <= rd.PCG_TOL


def test_rank_dispatch_golden_is_the_jax_draw():
    with open(GOLDEN) as f:
        doc = json.load(f)
    want = _jax_subsamples(doc["n"], doc["nsample"], doc["nsample_r"])
    assert len(doc["subsamples"]) == len(want)
    for got, w in zip(doc["subsamples"], want):
        np.testing.assert_array_equal(np.asarray(got), w)
    rd = _script("torch_rank_dispatch_probe")
    subs = rd.subsamples_of(rd.build_argparser().parse_args(["--subsamples", GOLDEN]))
    assert [s.tolist() for s in subs] == doc["subsamples"]
    with pytest.raises(ValueError):
        rd.subsamples_of(rd.build_argparser().parse_args(["--subsamples", GOLDEN, "--n", "1000"]))


# --- the operator accuracy probe -------------------------------------------------

def test_host_reference_copy_is_the_jax_scripts():
    port = _script("torch_op_accuracy_probe")
    jax_script = _jax_script("op_accuracy_probe")
    rng = np.random.default_rng(3)
    Xh, vh = rng.uniform(size=(150, 4)), rng.normal(size=150)
    for kw in ({}, {"N": 16, "oversample": 3}):
        a = port.host_reference_matvec(Xh, vh, [[0, 1], [2, 3]], 0.4, 0.02, 1.3, **kw)
        b = jax_script.host_reference_matvec(Xh, vh, [[0, 1], [2, 3]], 0.4, 0.02, 1.3, **kw)
        assert a.tobytes() == b.tobytes()


def test_op_accuracy_table_rows_match_jax_errors():
    port = _script("torch_op_accuracy_probe")
    args = port.build_argparser().parse_args(["--n", "2000"])
    Xh, vh, wlist = port.make_problem(args)
    y_ref = port.host_reference_matvec(Xh, vh, wlist, args.l, args.mu, 1.0)
    den = np.abs(y_ref).max()
    mvs = port.matvecs(args, Xh, wlist, CPU)
    v = torch.from_numpy(vh).float()
    params = JParams.make(1.0, args.l, args.mu, dtype=jnp.float32)
    X = jnp.asarray(Xh, jnp.float32)
    windows = j_windows(wlist)
    geom = jax.jit(lambda Xv: jfs.additive_fastsum_geometry(Xv, windows))(X)
    plan = jax.jit(lambda g: jfs.additive_fastsum_coeffs("gaussian", params, g, psd_clip=True))(geom)
    for comp in (False, True):
        y_port = mvs[f"compensated={comp}"](v).double().numpy()
        y_jax = np.asarray(jax.jit(lambda pl, vv: jfs.additive_fastsum_matvec(pl, vv, compensated=comp))(
            plan, jnp.asarray(vh, jnp.float32)), np.float64)
        err_port = np.abs(y_port - y_ref).max() / den
        err_jax = np.abs(y_jax - y_ref).max() / den
        assert abs(err_port - err_jax) <= 1e-6 and err_port <= port.ERR_LIMITS[f"compensated={comp}"]
