"""Device meshes and a launcher of ranks.

Port of ``libhpc_tpu/parallel/mesh.py``. The reference's ``jax.sharding.Mesh``
over the chips of one controller becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, one rank a device, with the reference's axis names as its
``mesh_dim_names`` (``"x"``, ``("host", "x")``, ``("py", "px")``). NCCL
carries the collectives on the card, gloo on the CPU.

A process group comes from one of three places:

  * ``torchrun --nproc-per-node=N script.py``: one rank a card, the group
    initialised from torchrun's environment by ``ensure_group``;
  * ``launch`` / ``RankPool`` below: n ranks spawned on this host;
  * neither: ``ensure_group`` makes a group of one rank in this process.

``launch`` and ``RankPool`` are the port's counterpart of the reference's
``force_cpu_devices(n)``, which turned one host into n virtual devices:
they spawn n processes (a ``torch.multiprocessing`` spawn context), join
them into one group that meets over a ``file://`` store in a fresh
temporary directory (no TCP port to collide on), run a function in each and
return each rank's result. Every wait is bounded: the group has a
``timeout``, and each collection of results has a deadline. A rank that
raises has its exception re-raised here with its traceback; a rank that
dies or hangs fails the call. On any failure every rank is terminated, so a
fault never outlives its call. Each rank runs torch on one thread. The
function and its arguments travel by pickle: the function must be importable
from this package (never from a test module), its result plain data.

Entry points run on the card unless the caller asks for the CPU:
``device_type="cuda"`` without a card raises, it never falls back to gloo.
"""

from __future__ import annotations

import atexit
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 120      # the process group's timeout, and a call's deadline
START_S = 120        # the deadline of the ranks' start (spawn, imports)
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _check_device_type(device_type: str) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type 'cuda' needs an NVIDIA GPU: "
                "torch.cuda.is_available() is false (pass "
                "device_type='cpu' for gloo ranks on the CPU)")
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_group(device_type: str = "cuda", timeout_s: float = TIMEOUT_S
                 ) -> None:
    """Make sure the default process group exists: the one already made
    (by torchrun's environment, a launcher or the caller), else one of a
    single rank in this process over a file store."""
    if dist.is_initialized():
        return
    _check_device_type(device_type)
    timeout = timedelta(seconds=timeout_s)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(_backend(device_type), timeout=timeout)
        return
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    store = tempfile.mkdtemp(prefix="libhpc_group_")
    atexit.register(shutil.rmtree, store, True)
    dist.init_process_group(_backend(device_type),
                            init_method=f"file://{store}/store", rank=0,
                            world_size=1, timeout=timeout)


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    _check_device_type(device_type)
    ensure_group(device_type)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the process "
                         f"group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_mesh_1d(n: int | None = None, axis: str = "x",
                 device_type: str = "cuda"):
    """1-D mesh over ranks 0..n-1 of the process group (n defaults to its
    size). Every rank of the group must call it, those outside the mesh
    too (it makes the mesh's process group); ``in_mesh`` tells them apart."""
    _check_device_type(device_type)
    ensure_group(device_type)
    world = dist.get_world_size()
    return _mesh(device_type, (world if n is None else n,), (axis,))


def make_mesh_2d(n_host: int, n_chip: int, axes=("host", "x"),
                 device_type: str = "cuda"):
    """2-D mesh: an outer axis (hosts) x an inner one (chips), row-major
    over ranks 0..n_host*n_chip-1."""
    return _mesh(device_type, (n_host, n_chip), tuple(axes))


def in_mesh(mesh) -> bool:
    """Whether this rank belongs to `mesh`."""
    return mesh.get_coordinate() is not None


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# Ranks on one host
# ---------------------------------------------------------------------------


class RankError(RuntimeError):
    """A rank failed, and its exception could not be carried back."""


def _rank_main(rank, n, device_type, store, timeout_s, tasks, results):
    torch.set_num_threads(1)

    def reply(tid, fn):
        try:
            payload = pickle.dumps(fn())
            results.put((rank, tid, True, payload))
        except BaseException as e:     # noqa: BLE001 — carried to the caller
            tb = traceback.format_exc()
            try:
                exc = pickle.dumps(e)
            except Exception:          # noqa: BLE001
                exc = None
            results.put((rank, tid, False, (exc, tb)))

    def init():
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(_backend(device_type),
                                init_method=f"file://{store}", rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s))

    reply(-1, init)
    while True:
        task = tasks.get()
        if task is None:
            break
        tid, fn, args, kwargs = task
        reply(tid, lambda: fn(*args, **kwargs))
    if dist.is_initialized():
        dist.destroy_process_group()


class RankPool:
    """n ranks of one process group on this host, kept for many calls.

        with RankPool(4, "cpu") as pool:
            outs = pool.run(fn, *args, **kwargs)   # fn(...) of each rank

    The ranks start at the first call. After a failed call the pool is
    closed; the next call starts new ranks."""

    def __init__(self, n: int, device_type: str = "cuda",
                 timeout_s: float = TIMEOUT_S):
        _check_device_type(device_type)
        if device_type == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} CUDA ranks need {n} NVIDIA GPUs; "
                               f"{torch.cuda.device_count()} found")
        self.n = n
        self.device_type = device_type
        self.timeout_s = timeout_s
        self._procs = []
        self._tid = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="libhpc_ranks_")
        store = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.n, self.device_type, store, self.timeout_s,
                  self._tasks[r], self._results)) for r in range(self.n)]
        # one BLAS / OpenMP thread a rank too (numpy's inverse in the AMG
        # setup, say): the children read these when they start
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            for p in self._procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._collect(-1, max(self.timeout_s, START_S))

    def run(self, fn, *args, **kwargs) -> list:
        """fn(*args, **kwargs) in every rank; the results by rank."""
        if not self._procs:
            self._start()
        self._tid += 1
        for q in self._tasks:
            q.put((self._tid, fn, args, kwargs))
        return self._collect(self._tid, self.timeout_s)

    def _collect(self, tid: int, timeout_s: float) -> list:
        deadline = time.monotonic() + timeout_s
        got = {}
        while len(got) < self.n:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(self.n)) - set(got))
                self.close(wait_s=0.0)
                raise TimeoutError(f"ranks {missing} gave no result in "
                                   f"{timeout_s} s")
            try:
                rank, t, ok, payload = self._results.get(
                    timeout=min(left, 0.5))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(self._procs)
                        if not p.is_alive()}
                if dead:
                    self.close(wait_s=0.0)
                    raise RankError(f"ranks exited: {dead} (rank: exit code)")
                continue
            if t != tid:
                continue
            if not ok:
                self.close(wait_s=0.0)
                exc, tb = payload
                try:
                    err = pickle.loads(exc) if exc is not None else None
                except Exception:      # noqa: BLE001
                    err = None
                if err is None:
                    raise RankError(f"rank {rank} raised:\n{tb}")
                err.add_note(f"raised in rank {rank}:\n{tb}")
                raise err
            got[rank] = pickle.loads(payload)
        return [got[r] for r in range(self.n)]

    def close(self, wait_s: float = 5.0) -> None:
        """Stop every rank: ask each to stop, give them wait_s seconds,
        then terminate the rest (at once after a failed call, where some
        may wait in a collective for a rank that failed)."""
        procs, self._procs = self._procs, []
        if not procs:
            return
        for p, q in zip(procs, self._tasks):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        t_end = time.monotonic() + wait_s
        for p in procs:
            p.join(max(t_end - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (*self._tasks, self._results):
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)


def launch(n: int, fn, args=(), kwargs=None, *, device_type: str = "cuda",
           timeout_s: float = TIMEOUT_S) -> list:
    """fn(*args, **kwargs) in each of n new ranks of one process group
    (gloo on the CPU, or NCCL with one card a rank); the results by rank.
    The ranks are stopped before it returns or raises."""
    with RankPool(n, device_type, timeout_s) as pool:
        return pool.run(fn, *args, **(kwargs or {}))


def run_in_group(n: int, fn, args=(), *, device_type: str = "cuda"):
    """fn(*args) as a command line runs it: in this rank of torchrun's
    group when torchrun started the process, else in n ranks started here
    (one a card, or gloo ranks on the CPU); rank 0's result."""
    if "WORLD_SIZE" in os.environ:
        ensure_group(device_type)
        return fn(*args)
    return launch(n, fn, args, device_type=device_type)[0]
