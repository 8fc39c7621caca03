"""Seconds per Adam step of the port's sharded train step against GPProblem's,
on one NVIDIA GPU, in turns; and the collectives a sharded step runs.

    python3 scripts/torch_sharded_steps.py [--n 200000] [--rounds 5] [--steps 4]

Both run chip_smoke.py's [main] configuration (gaussian, five 2-D windows,
N = 32, bf16 tables, Nystrom 50, maxits 10, nvecs 10, the same probes and
landmarks): GPProblem(fastsum_engine="stream") through its loss closure and
adam_step, and parallel/'s make_sharded_train_step at world 1 (NCCL, a
file:// store).  Each round times `steps` steady steps of one, then of the
other (the order alternating between rounds), after one untimed step each;
every step ends in torch.cuda.synchronize().  Then one step of each under
torch.profiler: the card's busy time, the NCCL kernels' time and the ops
with the most host time; and the host time of one psum of a float, alone
and read back.  Prints one JSON line; the card's name and power limit
first.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WINDOWS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]


def _data(n, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(3.0 * X[:, 0]) + np.cos(2.0 * X[:, 3]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()


def _timed(step, state, steps):
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return state, out


def _profile(step, state):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    dev = {e.key: e.self_device_time_total / 1e3 for e in avg if e.self_device_time_total > 0}
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in avg), reverse=True)[:12]
    return {"wall_ms": wall * 1e3, "device_ms": sum(dev.values()),
            "nccl_ms": sum(v for k, v in dev.items() if "nccl" in k.lower()),
            "host_self_ms_top": [[round(ms, 3), n, k] for ms, n, k in host]}


def _collective_us(mesh, reps=200):
    """Host microseconds a psum of one float takes, alone and with the
    scalar read back after each (as FGMRES reads its norms)."""
    t = torch.ones((), device=mesh.device)
    out = {}
    for name, fn in (("psum", lambda: mesh.psum(t)), ("psum_then_read", lambda: float(mesh.psum(t))),
                     ("clone_then_read", lambda: float(t.clone()))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_sharded_steps: no CUDA device")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.models.adam import adam_init, adam_step
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops import _cuda_build
    from nfft4gp_torch.parallel.mesh import PointsMesh, close_mesh, make_mesh
    from nfft4gp_torch.parallel.training import make_sharded_train_step, shard_training_data
    from nfft4gp_torch.solvers.lanczos import rademacher_probes
    from nfft4gp_torch.utils.datasets import rand_perm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    _cuda_build.build()
    X, y = _data(args.n)
    probes = rademacher_probes(torch.Generator().manual_seed(1), 10, args.n, X.dtype)
    landmarks = rand_perm(torch.Generator().manual_seed(0), args.n, 50)
    raw0 = transform_inverse("softplus", torch.tensor([1.0, 1.0, 0.1], device=X.device))
    loss_fn = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom", rank=50,
                        maxits=10, nvecs=10, fastsum_N=32, fastsum_engine="stream").make_loss(
        X, y, probes=probes, landmarks=landmarks)

    def main_step(state):
        _, grad = loss_fn(state.x)
        return adam_step(state, grad)

    calls = {}

    def counted(mesh, name):
        fn = getattr(PointsMesh, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(mesh, *a, **k)
        return call

    with tempfile.TemporaryDirectory(prefix="sharded_steps_") as tmp:
        mesh = make_mesh(1, rank=0, init_file=os.path.join(tmp, "store"), device="cuda")
        try:
            for name in ("psum", "pmax", "all_gather", "reduce_scatter"):
                setattr(mesh, name, counted(mesh, name))
            sstep = make_sharded_train_step(WINDOWS, mesh=mesh, landmarks=landmarks, kernel="gaussian",
                                            precond="nystrom", nys_rank=50, slq_its=10, nvecs=10, fastsum_N=32,
                                            engine="stream", table_dtype=torch.bfloat16)
            shard = shard_training_data(mesh, X, y, probes)

            def sharded_step(state):
                return sstep(state, *shard)[0]

            states = {"main": main_step(adam_init(raw0)), "sharded": sharded_step(adam_init(raw0))}
            steps = {"main": main_step, "sharded": sharded_step}
            times = {"main": [], "sharded": []}
            for r in range(args.rounds):
                for name in (("main", "sharded") if r % 2 == 0 else ("sharded", "main")):
                    states[name], t = _timed(steps[name], states[name], args.steps)
                    times[name] += t
            calls.clear()
            sharded_step(states["sharded"])
            per_step = dict(calls)
            prof = {name: _profile(steps[name], states[name]) for name in ("main", "sharded")}
            prof["collective_us"] = _collective_us(mesh)
        finally:
            close_mesh()
    med = {k: float(np.median(v)) for k, v in times.items()}
    q = {k: [float(np.percentile(v, 25)), float(np.percentile(v, 75))] for k, v in times.items()}
    print(json.dumps({"n": args.n, "rounds": args.rounds, "steps_a_round": args.steps, "s_per_step": times,
                      "median_s": med, "quartiles_s": q, "sharded_over_main": med["sharded"] / med["main"],
                      "collectives_a_sharded_step": per_step, "profiled_step": prof}), flush=True)


if __name__ == "__main__":
    main()
