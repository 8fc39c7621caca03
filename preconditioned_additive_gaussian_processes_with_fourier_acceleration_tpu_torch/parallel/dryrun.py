"""One sharded training step on a spawned world, checked against one device:
the port's counterpart of the JAX package's `dryrun_multichip`.

    python -m preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.parallel.dryrun \
        --ranks 2 --device cpu

spawns the ranks (gloo on the CPU; NCCL on the card, where the default is
one rank per device), runs one Adam step of the richest training path --
matern12 with its cross-shard KNN near-field, the AFN preconditioner, the
windows [0], [1, 2], [3] -- and checks on every rank that

  1. the loss is finite and the loss and gradient match the same step on
     one device with all points (rtol 1e-4; gradient rtol 1e-3, atol 1e-6:
     the collectives reorder the sums, so bit parity is not expected);
  2. the output stays row-local: a fastsum matvec of the rank's rows
     returns n / world values, the rank's rows of the one-device matvec;
  3. every rank reports the same loss.

It prints one JSON line per rank and exits non-zero on any failure.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ..models.adam import adam_init
from ..ops import fastsum as fs
from ..ops.kernels import KernelParams, make_windows
from ..preconds.afn import afn_plan
from ..solvers.lanczos import rademacher_probes
from .mesh import PointsMesh, run_ranks
from .sharded import shard_plan, shard_points, sharded_table_ops
from .training import make_sharded_train_step, shard_training_data

WINDOWS = [[0], [1, 2], [3]]
POINTS_PER_RANK = 64
NVECS = 4


def _problem(n, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(5.0 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    probes = rademacher_probes(torch.Generator().manual_seed(seed + 1), NVECS, n, torch.float32).numpy()
    return X, y, probes


def _rank_step(mesh: PointsMesh, n: int) -> dict:
    X, y, probes = _problem(n)
    dev = mesh.device
    Xt = torch.from_numpy(X).to(dev)
    engine = "stream" if dev.type == "cuda" else "table"
    plan = afn_plan("matern12", KernelParams.make(1.0, 1.0, 0.1, dtype=torch.float32, device=dev), Xt,
                    maxrank=24, lfil=6, rank=24, force_afn=True)
    kw = dict(kernel="matern12", precond="afn", afn_plan=plan, nys_rank=16, slq_its=4, nvecs=NVECS,
              fastsum_N=16, nearfield_lfil=8, engine=engine)
    raw0 = torch.tensor([0.5, -0.5, -2.0], dtype=torch.float32, device=dev)
    _, loss, grad = make_sharded_train_step(WINDOWS, mesh=mesh, **kw)(
        adam_init(raw0), *shard_training_data(mesh, X, y, probes))
    _, loss_ref, grad_ref = make_sharded_train_step(WINDOWS, mesh=None, **kw)(
        adam_init(raw0), Xt, torch.from_numpy(y).to(dev), torch.from_numpy(probes).to(dev))
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss in the dry run: {loss}")
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4,
                               err_msg="sharded loss diverged from the one-device loss")
    np.testing.assert_allclose(grad.cpu().numpy(), grad_ref.cpu().numpy(), rtol=1e-3, atol=1e-6,
                               err_msg="sharded gradient diverged from the one-device gradient")

    pk = KernelParams.make(1.0, 0.5, 0.05, dtype=torch.float32, device=dev)
    full = fs.additive_fastsum_build("gaussian", pk, Xt, make_windows(WINDOWS), N=16)
    rows = mesh.rows(n)
    v = torch.from_numpy(y).to(dev)
    out = sharded_table_ops(mesh, shard_plan(full, rows))[0](shard_points(mesh, v))
    want = fs.additive_fastsum_matvec(full, v)[rows]
    if out.shape != (n // mesh.world,):
        raise AssertionError(f"the sharded matvec returned {tuple(out.shape)}, not this rank's {n // mesh.world} rows")
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    return {"rank": mesh.rank, "world": mesh.world, "device": str(dev), "engine": engine, "n": n,
            "loss": float(loss), "loss_one_device": float(loss_ref), "grad": grad.tolist(),
            "grad_one_device": grad_ref.tolist(), "rows": [rows.start, rows.stop],
            "matvec_rows": int(out.shape[0]),
            "matvec_max_abs_err": float(torch.max(torch.abs(out - want)))}


def dryrun_multichip(n_devices=None, *, device=None, timeout: float = 600.0) -> list:
    """Run the dry run on n_devices spawned ranks (default: every CUDA
    device; device='cpu' runs gloo ranks, default 2).  Returns the ranks'
    reports; raises if any check fails on any rank."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if n_devices is None:
        n_devices = 2 if on_cpu else torch.cuda.device_count()
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("the dry run runs on the CUDA devices and there is none; pass device='cpu'")
    reports = run_ranks(_rank_step, n_devices, POINTS_PER_RANK * n_devices, device=device, timeout=timeout,
                        threads=1 if on_cpu else None)
    if len({r["loss"] for r in reports}) != 1:
        raise AssertionError(f"the ranks disagree on the loss: {[r['loss'] for r in reports]}")
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="world size (default: the CUDA device count, "
                                                            "or 2 with --device cpu)")
    ap.add_argument("--device", default=None, help="'cpu' for gloo ranks on the CPU; default the card")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    for r in dryrun_multichip(args.ranks, device=args.device, timeout=args.timeout):
        print(json.dumps(r), flush=True)
    print("dryrun ok", flush=True)


if __name__ == "__main__":
    sys.exit(main())
