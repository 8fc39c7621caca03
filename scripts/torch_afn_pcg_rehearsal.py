"""CPU rehearsal of chip_smoke.py's [afn-pcg] phase, against the JAX package.

K x = y by PCG to relres 1e-2 (at most 400 iterations) with no
preconditioner, Nystrom (200 random landmarks) and AFN (maxrank 200, lfil
16, its own rank estimate) on chip_smoke's problem: matern12, the first two
features of make_data's points and the window [0, 1], (f, l, mu) =
(1, 0.1, 0.01), N = 32, float32.
Each package runs in its own process, so neither imports the other:

  --side jax:    the JAX package's dense operator, afn_setup and pcg (its
                 CPU fastsum engine carries the KNN near-field, which is not
                 positive definite at this mu: PCG breaks down on it);
  --side torch:  the port on the CPU: the dense operator (the JAX side's)
                 and the stream engine's plain versions (the radius
                 near-field that chip_smoke's card run uses).

With no --side both run and one JSON line per side is printed:

  python scripts/torch_afn_pcg_rehearsal.py --n 20000
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PARAMS = (1.0, 0.1, 0.01)
WINDOWS = [[0, 1]]
KW = dict(kernel="matern12", windows=WINDOWS, fastsum_N=32)


def make_data(n):
    """The first two features of chip_smoke.make_data's first n points (the
    AFN plan orders and patterns the points in the space the kernel sees),
    on the host."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(200_000, 10)).astype(np.float32)
    y = (np.sin(3.0 * X[:, 0]) + np.cos(2.0 * X[:, 3]) + 0.1 * rng.normal(size=200_000)).astype(np.float32)
    return np.ascontiguousarray(X[:n, :2]), y[:n]


def run_jax(n):
    import jax
    import jax.numpy as jnp

    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.models.problem import GPProblem
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.ops.kernels import (
        KernelParams, make_windows)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.preconds.afn import afn_setup
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.preconds.nystrom import (
        nystrom_setup)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.solvers.pcg import pcg
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu.utils.datasets import rand_perm

    X, y = (jnp.asarray(a) for a in make_data(n))
    params = KernelParams.make(*PARAMS, dtype=jnp.float32)
    mv, _ = GPProblem(operator="dense", **KW)._build_ops_factory(X)(params)
    W = make_windows(WINDOWS)
    setups = {
        "none": lambda: None,
        "nystrom": lambda: nystrom_setup("matern12", params, X, rand_perm(jax.random.PRNGKey(8), n, 200), 200,
                                         windows=W),
        "afn": lambda: afn_setup("matern12", params, X, maxrank=200, lfil=16, windows=W),
    }
    rows = {}
    for name, setup in setups.items():
        t = time.perf_counter()
        pre = setup()
        plan = None
        if isinstance(pre, tuple):
            pre, plan = pre
        s_setup = time.perf_counter() - t
        t = time.perf_counter()
        res = pcg(jax.jit(mv), y, precond=None if pre is None else jax.jit(pre.solve), tol=1e-2, maxits=400)
        rows[name] = dict(niter=int(res.niter), relres=float(res.relres), setup_s=s_setup,
                          solve_s=time.perf_counter() - t)
        if plan is not None:
            rows[name].update(k=plan.k, use_ran=bool(plan.use_ran))
    return rows


def run_torch(n):
    import torch

    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.models.problem import (
        GPProblem)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.ops.kernels import (
        KernelParams, make_windows)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.preconds.afn import (
        afn_setup)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.preconds.nystrom import (
        nystrom_setup)
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.solvers.pcg import pcg
    from preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.utils.datasets import (
        rand_perm)

    X, y = (torch.from_numpy(a) for a in make_data(n))
    params = KernelParams.make(*PARAMS, dtype=torch.float32)
    W = make_windows(WINDOWS)
    gen = torch.Generator().manual_seed(8)
    out = {}
    for engine in ("dense", "stream"):
        op = dict(operator="dense") if engine == "dense" else dict(
            operator="fastsum", fastsum_engine="stream", fastsum_table_dtype="float32")
        mv, _ = GPProblem(**op, **KW)._build_ops_factory(X)(params)
        setups = {
            "none": lambda: None,
            "nystrom": lambda: nystrom_setup("matern12", params, X, rand_perm(gen, n, 200), 200, windows=W),
            "afn": lambda: afn_setup("matern12", params, X, maxrank=200, lfil=16, windows=W, generator=gen),
        }
        rows = {}
        for name, setup in setups.items():
            t = time.perf_counter()
            pre = setup()
            plan = None
            if isinstance(pre, tuple):
                pre, plan = pre
            s_setup = time.perf_counter() - t
            t = time.perf_counter()
            res = pcg(mv, y, precond=None if pre is None else pre.solve, tol=1e-2, maxits=400)
            rows[name] = dict(niter=res.niter, relres=float(res.relres), setup_s=s_setup,
                              solve_s=time.perf_counter() - t)
            if plan is not None:
                rows[name].update(k=plan.k, use_ran=plan.use_ran)
        out[engine] = rows
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--side", choices=["jax", "torch"], default=None)
    args = ap.parse_args()
    if args.side is not None:
        rows = run_jax(args.n) if args.side == "jax" else run_torch(args.n)
        print(json.dumps({"side": args.side, "n": args.n, "cpu_seconds_are_host_times": True, "rows": rows}))
        return
    for side in ("jax", "torch"):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--n", str(args.n), "--side", side],
                              capture_output=True, text=True, env=env, check=True)
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
