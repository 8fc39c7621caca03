"""Process group + row ranges: the port's communication layer (port of
parallel/mesh.py).

The JAX package lays one Mesh with a "points" axis over the devices of one
process and lets XLA insert the collectives.  Here each device is a process
of a `torch.distributed` group (NCCL on the card, gloo on the CPU when
asked), each holding a contiguous block of n / world rows of every
points-sized array, and the collectives are written out: `PointsMesh.psum`
(all_reduce), `all_gather` and `reduce_scatter`, each over the points axis
of its tensor.

The group is set up from a `file://` store, never a fixed TCP port, so
several worlds on one machine (test workers) cannot collide.  `run_ranks`
spawns a world of processes on one machine and collects what each rank
returns, within a time limit.
"""

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist


class PointsMesh:
    """One rank's view of a 1-D process group over the points axis.

    group: the torch.distributed process group (None = the default group);
    rank, world: this process's place in it; device: where its tensors live.
    Every collective takes and returns tensors on `device`; none modifies
    its input."""

    def __init__(self, group, rank: int, world: int, device):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)

    def __repr__(self):
        return f"PointsMesh(rank={self.rank}, world={self.world}, device={self.device})"

    def rows(self, n: int) -> slice:
        """This rank's rows of n global points.  n must divide evenly, as
        JAX's shard_map requires of the points axis."""
        if n % self.world:
            raise ValueError(f"{n} points do not divide over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def n_global(self, n_local: int) -> int:
        return n_local * self.world

    def _reduce(self, t, op):
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, t):
        """t summed over the ranks (all_reduce)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t, dim: int = -1):
        """The ranks' blocks of t concatenated in rank order along `dim`."""
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _ALL_GATHER(out, src, group=self.group)
        return out.movedim(0, dim)

    def reduce_scatter(self, t, dim: int = -1):
        """t summed over the ranks, this rank's block of `dim` kept (JAX's
        psum_scatter with tiled=True)."""
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.world,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=self.group)
        return out.movedim(0, dim)


# newer torch renames the tensor-in, tensor-out collectives
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _mesh_device(device, rank: int) -> torch.device:
    """The rank's device: CUDA (one card a rank, round robin) unless the
    caller asks for the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh runs on the CUDA devices and there is none; pass device='cpu' "
                               "to run under gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def make_mesh(n_devices: Optional[int] = None, *, rank: Optional[int] = None,
              init_file: Optional[str] = None, device=None) -> PointsMesh:
    """This process's rank of a world of n_devices over the points axis.

    If torch.distributed is already initialized, its default group is used.
    Otherwise the group is made from the `file://` store at init_file (every
    rank passes the same path; a world of one may omit it), with rank and
    world from the arguments or the RANK / WORLD_SIZE environment.  device:
    None = CUDA with NCCL; "cpu" = gloo.  A failure to set up NCCL raises:
    there is no fallback to gloo."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"the process group has {world} ranks, asked for {n_devices}")
        backend = dist.get_backend()
        if device is None:
            device = "cpu" if backend == "gloo" else None
        return PointsMesh(None, rank, world, _mesh_device(device, rank))
    world = int(n_devices if n_devices is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    dev = _mesh_device(device, rank)
    if init_file is None:
        if world != 1:
            raise ValueError("a world of more than one rank needs init_file, the path of its file:// store")
        init_file = os.path.join(tempfile.mkdtemp(prefix="nfft4gp_mesh_"), "store")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(init_file), rank=rank,
                            world_size=world)
    return PointsMesh(None, rank, world, dev)


def close_mesh():
    """Tear down the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def points_sharding(mesh: PointsMesh, n: int) -> slice:
    """The rows of n global points that this rank holds."""
    return mesh.rows(n)


def replicated_sharding(mesh: PointsMesh) -> slice:
    """Every row: replicated arrays are whole on each rank."""
    return slice(None)


def _rank_main(call_file, rank, world, init_file, device, threads, out_q):
    try:
        if threads:
            torch.set_num_threads(threads)
        with open(call_file, "rb") as f:
            fn, args = pickle.load(f)
        mesh = make_mesh(world, rank=rank, init_file=init_file, device=device)
        out_q.put((rank, True, fn(mesh, *args)))
    except BaseException:  # reported to the parent, which raises it
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def run_ranks(fn: Callable, world: int, *args, device=None, timeout: float = 600.0,
              threads: Optional[int] = None) -> list:
    """Run fn(mesh, *args) on `world` spawned processes, one rank each, and
    return their results in rank order.

    fn must be importable by name (a module-level function) and return
    something picklable.  The group's store, and fn with its arguments, are
    files in a temporary directory (so starting a rank never waits on a
    pipe that a rank dead at start-up no longer reads).  If a rank raises
    or dies, or the world has not finished after `timeout` seconds (a hung
    collective), every rank is terminated and the error raised here.
    threads: torch's intra-op threads per rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="nfft4gp_world_") as tmp:
        init_file, call_file = os.path.join(tmp, "store"), os.path.join(tmp, "call.pkl")
        with open(call_file, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(call_file, r, world, init_file, device, threads, out_q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"the world of {world} ranks did not finish within {timeout} s")
                try:
                    rank, ok, out = out_q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited with codes "
                                           f"{[procs[r].exitcode for r in dead]} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
                results[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
    return [results[r] for r in range(world)]
