"""The n = 1e6 scale demo's Nystrom preconditioner on one NVIDIA GPU: how the
relres after 60 iterations moves with the landmark draw and the reductions,
and how the row-sharded factorizations of the tall factor compare.

    python3 scripts/torch_scale_nystrom_probe.py [--n 1000000]

The problem is chip_smoke.py [scale]'s (scripts/torch_sharded_scale_demo.py:
d = 10, five 2-D windows, N = 32, gaussian (1, 0.5, 0.1), rank 200, PCG and
FGMRES to 1e-3 in at most 60 iterations).

1. gpu mode: the table engine on torch-generator landmark draws seeded 0-3
   and on the JAX script's draw (tests/goldens/scale_demo_landmarks_1e6.json,
   used at n = 1e6 only), with compensated reductions, and without them for
   seed 0 and the JAX draw; the stream engine on the JAX draw and seeds 1, 2.
2. mesh mode at world 1 (NCCL), stream engine, on the seed-0 draw: the
   sharded Nystrom factor three ways -- the library's TSQR thin SVD
   (parallel/sharded.sharded_nystrom_setup), the JAX package's Gram
   eigendecomposition (parallel/sharded.py there) in float32, and the same
   Gram formed and eigendecomposed in float64 -- each FGMRES solution
   against gpu mode's (one device, the tall SVD of preconds/nystrom.py).

Prints one line a run, then one JSON line; the card's name and power limit
first.  Card only: it exits without one.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRAW = os.path.join(ROOT, "tests", "goldens", "scale_demo_landmarks_1e6.json")
BASE_ARGV = ["--d", "10", "--fastsum-N", "32", "--mu", "0.1", "--rank", "200", "--iters", "60", "--tol", "1e-3"]


def gram_nystrom(dtype):
    """A sharded_nystrom_setup stand-in with the JAX package's algorithm:
    U = Uf V sigma^-1 from the eigendecomposition of the Gram Uf' Uf (one
    psum), the Gram and its eigendecomposition in `dtype`."""
    import torch

    from nfft4gp_torch.ops.kernels import KernelParams, additive_kernel_matrix
    from nfft4gp_torch.ops.matops import stable_chol, tril_solve
    from nfft4gp_torch.parallel.sharded import ShardedNystromPrecond

    def setup(mesh, kind, params, X, Xk, *, windows=None):
        noise_free = KernelParams(f=params.f, l=params.l, mu=torch.zeros_like(params.mu))
        L11, _ = stable_chol(additive_kernel_matrix(kind, noise_free, Xk, windows, Xk))
        Ufb = tril_solve(L11, additive_kernel_matrix(kind, noise_free, X, windows, Xk).T).T.to(dtype)
        lam, V = torch.linalg.eigh(mesh.psum(Ufb.T @ Ufb))
        sigma2 = torch.clamp(lam, min=0.0)
        pos = sigma2 > 0
        inv_sig = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, sigma2, torch.ones_like(sigma2))), 0.0)
        U = (Ufb @ (V * inv_sig[None, :])).to(X.dtype)
        sigma2 = sigma2.to(X.dtype)
        f2 = params.f * params.f
        eta = params.mu * f2
        return ShardedNystromPrecond(perm=torch.arange(U.shape[1], device=X.device), U=U, s=1.0 / (sigma2 + eta),
                                     sigma2=sigma2, eta=eta, f2=f2, mesh=mesh)

    return setup


def _summary(rec):
    return {"pcg": [rec["pcg"]["iters"], rec["pcg"]["relres"]], "fgmres": [rec["fgmres"]["iters"],
                                                                          rec["fgmres"]["relres"]],
            "matvec_ms": rec["matvec_ms"], "nystrom_s": rec["nystrom_s"]}


def draws(demo, n):
    """The landmark draws by name: torch seeds 0-3, and the JAX script's at
    n = 1e6."""
    import torch

    from nfft4gp_torch.utils.datasets import rand_perm

    out = {f"torch{s}": rand_perm(torch.Generator().manual_seed(s), n, 200) for s in range(4)}
    if n == 1_000_000:
        out["jax"] = demo.landmarks_of(demo.build_argparser().parse_args(
            ["--n", str(n), "--landmarks", JAX_DRAW]))
    return out


def gpu_runs(demo, n, device):
    lm = draws(demo, n)
    runs = [("table", d, True) for d in lm] + [("table", d, False) for d in ("torch0", "jax") if d in lm]
    runs += [("stream", d, True) for d in ("jax", "torch1", "torch2") if d in lm]
    out = {}
    for engine, draw, comp in runs:
        args = demo.build_argparser().parse_args(BASE_ARGV + ["--n", str(n), "--mode", "gpu", "--engine", engine]
                                                 + (["--compensated"] if comp else []))
        rec = demo.run_single(args, device, landmarks=lm[draw])
        key = f"{engine} {draw} compensated={comp}"
        out[key] = _summary(rec)
        print(f"[gpu] {key}: {out[key]}", flush=True)
    return out


def mesh_runs(demo, n, mesh, device):
    """Part 2: the three sharded factorizations on the seed-0 draw against
    gpu mode's FGMRES solution."""
    import torch

    import nfft4gp_torch.parallel.sharded as sh

    lm = draws(demo, n)["torch0"]
    argv = BASE_ARGV + ["--n", str(n), "--engine", "stream", "--compensated"]
    ref = demo.run_single(demo.build_argparser().parse_args(argv + ["--mode", "gpu"]), device, landmarks=lm)
    margs = demo.build_argparser().parse_args(argv + ["--mode", "mesh", "--devices", "1"])
    out = {"gpu (tall SVD)": _summary(ref)}
    library = sh.sharded_nystrom_setup
    try:
        for name, setup in (("tsqr (library)", library), ("gram float32 (JAX's)", gram_nystrom(torch.float32)),
                            ("gram float64", gram_nystrom(torch.float64))):
            sh.sharded_nystrom_setup = setup
            rec = demo.mesh_rank(mesh, margs, landmarks=lm)
            out[name] = dict(_summary(rec), x_fgmres_gap=float(
                np.linalg.norm(rec["x_fgmres"] - ref["x_fgmres"]) / np.linalg.norm(ref["x_fgmres"])))
            print(f"[mesh] {name}: {out[name]}", flush=True)
    finally:
        sh.sharded_nystrom_setup = library
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_scale_nystrom_probe: no CUDA device; this script runs only on a GPU")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    import torch_sharded_scale_demo as demo
    from nfft4gp_torch.parallel.mesh import close_mesh, make_mesh

    label = demo.nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {label}", flush=True)
    device = torch.device("cuda")
    rec = {"device": label, "n": args.n, "gpu": gpu_runs(demo, args.n, device)}
    with tempfile.TemporaryDirectory(prefix="nystrom_probe_") as tmp:
        mesh = make_mesh(1, rank=0, init_file=os.path.join(tmp, "store"), device="cuda")
        try:
            rec["mesh_world1"] = mesh_runs(demo, args.n, mesh, device)
        finally:
            close_mesh()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
