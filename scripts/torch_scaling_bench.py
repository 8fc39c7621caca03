"""Scaling record of the port's row-sharded additive fastsum matvec; the port
of scripts/scaling_bench.py.  It writes its own JSON (default
SCALING_TORCH.json); SCALING.json is the JAX package's record.

1. Parity: the row-sharded matvec of both engines (table: the folded-NDFT
   products in torch, parallel/sharded.sharded_table_ops; stream: the packed
   bf16 phase table through the table kernels, sharded_stream_ops) on
   worlds of parallel/mesh.py's run_ranks against one process (rtol 1e-5,
   atol 1e-5, as the JAX script): world 1 in this process, then worlds of
   2, 4 and 8 ranks, gloo with --platform cpu; on the cards one rank a
   card (NCCL refuses two ranks on one card, so one card runs world 1).
2. Collectives per matvec: each PointsMesh collective's calls and bytes
   (the bytes of its result, as the JAX script reads the result shapes of
   the compiled HLO) during one matvec of each engine, counted by wrapping
   the mesh's psum / pmax / all_gather / reduce_scatter here; the library
   has no counter.
3. An efficiency model, efficiency(P) = t_comp / (t_comp + t_comm(P)):
   t_comp is this device's measured one-device matvec at n (host wall time
   around synchronized calls), over P; t_comm(P) is the collectives' count
   times the host time of one psum (measured here at world 1: on the card
   the floor under every collective before any byte moves), plus the ring
   all-reduce's 2 B (P - 1) / P bytes over --link-gbps and 2 (P - 1) hop
   latencies of --hop-us.  Both link figures are assumptions, named so in
   the JSON.

  python scripts/torch_scaling_bench.py                    # on the card
  python scripts/torch_scaling_bench.py --platform cpu --model-n 131072

Every time in the JSON comes with the device it was measured on (on the
card: torch's device name and nvidia-smi's name and power limit).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label  # noqa: E402

ENGINES = ("table", "stream")
COLLECTIVES = ("psum", "pmax", "all_gather", "reduce_scatter")
# the JAX script's HLO names of the same collectives
HLO_NAMES = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s a GPU (both directions)
NVLINK4_GBPS = 900.0
PARITY_RTOL = 1e-5
# the parity worlds past 1 (world 1 runs in this process); matvecs timed at
# each n; seconds a world may take
WORLDS = (2, 4, 8)
REPS = 20
WORLD_TIMEOUT = 600.0


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--model-n", default="131072,1000000",
                    help="n at which the one-device matvec is measured and the efficiency modeled")
    ap.add_argument("--link-gbps", type=float, default=NVLINK4_GBPS,
                    help="assumed link bandwidth, GB/s (default: the H100 SXM's published NVLink 4 figure)")
    ap.add_argument("--hop-us", type=float, default=1.0, help="assumed per-hop all-reduce latency, us")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU with gloo ranks; the default is the card")
    ap.add_argument("--out", default="SCALING_TORCH.json")
    return ap


def make_problem(n, d, device):
    """The JAX script's problem: X (n, d) and v (n,) from
    np.random.default_rng(0) in float32, gaussian (f, l, mu) = (1, 0.5, 0.01),
    2-feature windows [i, i + 1]."""
    import torch

    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32)).to(device)
    v = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device)
    params = KernelParams.make(1.0, 0.5, 0.01, dtype=torch.float32, device=device)
    return X, v, params, make_windows([[i, i + 1] for i in range(0, d, 2)])


def build_plan(X, params, windows, N):
    from nfft4gp_torch.ops import fastsum as fs

    return fs.additive_fastsum_build("gaussian", params, X, windows, N=N)


def single_matvec(engine, plan):
    """The one-device matvec of an engine on a whole plan."""
    import torch

    from nfft4gp_torch.ops import fastsum as fs

    if engine == "table":
        return lambda v: fs.additive_fastsum_matvec(plan, v)
    pn = fs.packed_ndft_plan(plan, table_dtype=torch.bfloat16)
    return lambda v: fs.packed_ndft_matvec(pn, v)


def sharded_matvec(engine, mesh, plan):
    """The row-sharded matvec of an engine on a plan built on all points."""
    import torch

    from nfft4gp_torch.parallel.sharded import shard_plan, sharded_stream_ops, sharded_table_ops

    splan = shard_plan(plan, mesh.rows(plan.groups[0][2][0].geom.x.shape[0]))
    if engine == "table":
        return sharded_table_ops(mesh, splan)[0]
    return sharded_stream_ops(mesh, splan, table_dtype=torch.bfloat16)[0]


def count_collectives(mesh, fn):
    """(fn(), {collective: {"count", "bytes"}}): the mesh's collectives that
    fn runs, each call's bytes those of its result; the mesh's methods are
    wrapped for the call and restored after."""
    calls = {}

    def wrap(name, orig):
        def call(*a, **k):
            out = orig(*a, **k)
            rec = calls.setdefault(name, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += out.numel() * out.element_size()
            return out
        return call

    for name in COLLECTIVES:
        setattr(mesh, name, wrap(name, getattr(mesh, name)))
    try:
        out = fn()
    finally:
        for name in COLLECTIVES:
            delattr(mesh, name)
    return out, calls


def hlo_counts(calls):
    """A count of count_collectives under the JAX script's HLO names."""
    out = {}
    for name, rec in calls.items():
        acc = out.setdefault(HLO_NAMES[name], {"count": 0, "bytes": 0})
        acc["count"] += rec["count"]
        acc["bytes"] += rec["bytes"]
    return out


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def psum_host_us(mesh, reps=200):
    """Host microseconds of one psum of a float at this world (synchronized
    after the batch): the floor under a collective before any byte moves."""
    import torch

    t = torch.ones((), device=mesh.device)
    mesh.psum(t)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.psum(t)
    _sync(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e6


def rank_matvecs(mesh, n, d, N):
    """A run_ranks rank function (chip_smoke.py calls it with its own mesh):
    every rank builds the plan on all points, cuts its rows and runs one
    matvec of each engine.  Returns per engine the rank's output rows and
    the collectives of that matvec (after one uncounted call)."""
    X, v, params, windows = make_problem(n, d, mesh.device)
    plan = build_plan(X, params, windows, N)
    vr = v[mesh.rows(n)]
    out = {}
    for engine in ENGINES:
        mv = sharded_matvec(engine, mesh, plan)
        mv(vr)
        y, calls = count_collectives(mesh, lambda: mv(vr))
        out[engine] = {"y": y.double().cpu().numpy(), "collectives": calls}
    return out


def single_outputs(n, d, N, device):
    X, v, params, windows = make_problem(n, d, device)
    plan = build_plan(X, params, windows, N)
    return {e: single_matvec(e, plan)(v).double().cpu().numpy() for e in ENGINES}


def parity(ys, ref):
    """Max relative gap, the JAX script's assert_allclose(rtol 1e-5, atol 1e-5)
    test as a number: max |y - ref| / (atol + rtol |ref|) <= 1 passes."""
    err = np.abs(ys - ref)
    return {"max_abs": float(err.max()), "max_rel_to_max": float(err.max() / np.abs(ref).max()),
            "ok": bool(np.all(err <= PARITY_RTOL + PARITY_RTOL * np.abs(ref)))}


def matvec_us(engine, n, d, N, device, reps=REPS):
    """Host microseconds of one synchronized-batch matvec of an engine on one
    device at n (after two untimed calls)."""
    X, v, params, windows = make_problem(n, d, device)
    mv = single_matvec(engine, build_plan(X, params, windows, N))
    for _ in range(2):
        mv(v)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        mv(v)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def model_efficiency(total_bytes, n_colls, t_matvec_us, host_us, link_gbps, hop_us, Ps=(2, 4, 8, 16)):
    """{f"P{P}": efficiency}: t_comp = t_matvec_us / P against t_comm(P) =
    n_colls * host_us + 2 B (P - 1) / P / link + 2 (P - 1) hop_us."""
    out = {}
    for P in Ps:
        t_comp = t_matvec_us / P
        t_comm = n_colls * host_us + (2.0 * total_bytes * (P - 1) / P) / (link_gbps * 1e3) + 2.0 * (P - 1) * hop_us
        out[f"P{P}"] = t_comp / (t_comp + t_comm)
    return out


def world1_record(mesh, args, model_ns, device_label):
    """The one-process part at world 1 on `mesh` (chip_smoke.py [scaling]):
    each engine's parity with one device and its collectives a matvec, the
    psum host floor, the measured one-device matvecs at model_ns and the
    modeled efficiency."""
    ranks = rank_matvecs(mesh, args.n, args.d, args.N)
    ref = single_outputs(args.n, args.d, args.N, mesh.device)
    colls = {e: ranks[e]["collectives"] for e in ENGINES}
    host_us = psum_host_us(mesh)
    rec = {"device": device_label, "parity_world1": {e: parity(ranks[e]["y"], ref[e]) for e in ENGINES},
           "collectives_per_matvec": colls,
           "collectives_per_matvec_hlo_names": {e: hlo_counts(c) for e, c in colls.items()},
           "collective_bytes_per_matvec": {e: sum(c["bytes"] for c in colls[e].values()) for e in ENGINES},
           "psum_host_us_world1": host_us, "matvec_us_measured": {}, "modeled_efficiency": {}}
    for e in ENGINES:
        ncoll = sum(c["count"] for c in colls[e].values())
        for n in model_ns:
            t = matvec_us(e, n, args.d, args.N, mesh.device)
            rec["matvec_us_measured"].setdefault(e, {})[str(n)] = t
            rec["modeled_efficiency"].setdefault(e, {})[str(n)] = model_efficiency(
                rec["collective_bytes_per_matvec"][e], ncoll, t, host_us, args.link_gbps, args.hop_us)
    return rec


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.parallel.mesh import close_mesh, make_mesh, run_ranks

    on_cpu = args.platform == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        sys.exit("torch_scaling_bench: no CUDA device; pass --platform cpu to run on the CPU")
    device = torch.device("cpu" if on_cpu else "cuda")
    # NCCL refuses two ranks on one card: on the cards a world takes one a rank
    worlds = [w for w in WORLDS if on_cpu or w <= torch.cuda.device_count()]
    label = "cpu" if on_cpu else card_label()
    print(f"[device] {label}", flush=True)

    ref = single_outputs(args.n, args.d, args.N, device)
    par, counts = {}, {}
    for w in worlds:
        threads = max(1, (os.cpu_count() or 1) // w) if on_cpu else None
        outs = run_ranks(rank_matvecs, w, args.n, args.d, args.N, device="cpu" if on_cpu else None,
                         timeout=WORLD_TIMEOUT, threads=threads)
        par[str(w)] = {e: parity(np.concatenate([o[e]["y"] for o in outs]), ref[e]) for e in ENGINES}
        counts[str(w)] = {e: outs[0][e]["collectives"] for e in ENGINES}
        print(f"parity, world {w}: {par[str(w)]}; collectives a matvec: {counts[str(w)]}", flush=True)
        if not all(p["ok"] for p in par[str(w)].values()):
            raise AssertionError(f"world {w}: the sharded matvec disagrees with one process: {par[str(w)]}")

    mesh = make_mesh(1, rank=0, device="cpu" if on_cpu else "cuda")
    try:
        rec = world1_record(mesh, args, [int(n) for n in args.model_n.split(",")], label)
    finally:
        close_mesh()
    out = {"metric": "additive_fastsum_matvec_scaling", "n": args.n, "d": args.d, "N": args.N,
           "parity_rtol": PARITY_RTOL, "parity": par, "parity_ok": True, "collectives_by_world": counts, **rec,
           "link_gbps_assumed": args.link_gbps,
           "link_note": "assumed: the NVIDIA H100 SXM data sheet's NVLink 4 bandwidth (900 GB/s a GPU, both "
                        "directions) unless --link-gbps says otherwise; not measured (one card)",
           "hop_us_assumed": args.hop_us,
           "model": "efficiency(P) = t_comp / (t_comp + t_comm), t_comp = matvec_us_measured / P, t_comm = "
                    "collectives a matvec x psum_host_us_world1 + 2 B (P-1)/P / link + 2 (P-1) hop_us",
           "jax_record": "SCALING.json (the JAX package's run on a virtual CPU mesh: one all-reduce of 23120 "
                         "bytes a matvec, from its compiled HLO)"}
    for e in ENGINES:
        print(f"{e}: collectives a matvec {rec['collectives_per_matvec'][e]}, modeled efficiency "
              f"{rec['modeled_efficiency'][e]}", flush=True)
    print(f"psum host us at world 1: {rec['psum_host_us_world1']:.1f}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
