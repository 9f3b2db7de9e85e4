"""Several processes over torch.distributed (counterpart of
rucene_tpu/parallel/multi_host.py).

The reference spans one logical index over a multi-host TPU pod with
jax.distributed, one process per host. torch's idiom is one process per
card: ``initialize`` joins the process group (NCCL for CUDA tensors, gloo
for CPU tensors, as in the tests), ``make_pod_mesh`` lays the world's cards
out as a parallel.sharded.Mesh whose cells each name the process that
owns them, and ShardedIndex / ShardedSearcher run unchanged on it: every
process runs the cells it owns and one collective merge makes the answers
whole.

Layout rule, as the reference's: the heavy arrays never cross processes.
- partition="replicated" (a small index, most QPS): every process holds
  the whole index; the shard axis lies within a process, the query batch
  (dp) across processes.
- partition="index" (a big index, partial loading): the shard axis spans
  the processes; each loads only its own shards
  (ShardedIndex.from_directory), and the per-batch traffic is the
  [B, k] top-k gather.

Collectives (what replaces jax's multihost_utils.process_allgather): doc
freqs are summed with one all_reduce; a batch's top-k scores and doc ids
gather with all_gather_into_tensor, its hit counts with one all_reduce.
Each runs on the card under NCCL and on the CPU under gloo.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group: ``init_method`` (``tcp://localhost:<port>``
    or ``file://<path>``), world size and rank come from the caller, since
    nothing on the machine tells a program of a cluster. The backend is
    NCCL when CUDA is available, else gloo; under NCCL the process takes
    card ``rank % device_count``. No init_method: a single process, nothing
    to do. A failing rendezvous raises."""
    if init_method is None or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices() -> list[torch.device]:
    """This process's card (raises without one: the CPU is asked for by
    name, as the tests do)."""
    return [torch.device("cuda", torch.cuda.current_device())]


def make_pod_mesh(shards_per_host: int | None = None, devices=None,
                  partition: str = "replicated"):
    """A Mesh over every process's devices. ``devices``: this process's
    own (default local_devices()); every process must hold as many. Cells
    of other processes carry their rank and no device.

    partition="replicated": shards_per_host shards (default: one a local
    device) within each process, dp = processes x the devices left a
    shard. partition="index": processes x shards_per_host (default 1)
    shard rows, rank-major, dp = the local devices a shard."""
    from rucene_tpu_torch.parallel.sharded import Mesh

    local = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    n_proc, me = process_count(), process_index()
    per_host = len(local)
    if partition not in ("replicated", "index"):
        raise ValueError(f"unknown partition {partition!r}")
    if shards_per_host is None:
        shards_per_host = 1 if partition == "index" else per_host
    if per_host % shards_per_host:
        raise ValueError(
            f"{per_host} devices/host not divisible by shards_per_host={shards_per_host}"
        )
    dp_within = per_host // shards_per_host
    if partition == "index":
        s, dp = n_proc * shards_per_host, dp_within
    else:
        s, dp = shards_per_host, n_proc * dp_within
    devs = np.empty((s, dp), dtype=object)
    ranks = np.zeros((s, dp), np.int64)
    for r in range(n_proc):
        for a in range(shards_per_host):
            for j in range(dp_within):
                cell = (r * shards_per_host + a, j) if partition == "index" else (a, r * dp_within + j)
                ranks[cell] = r
                devs[cell] = local[a * dp_within + j] if r == me else None
    return Mesh(devs, ranks)


def process_local_query_slice(n_queries: int) -> slice:
    """The contiguous slice of a globally ordered query batch this process
    feeds."""
    n_proc = process_count()
    per = (n_queries + n_proc - 1) // n_proc
    pid = process_index()
    return slice(pid * per, min((pid + 1) * per, n_queries))


def _comm_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def allreduce_sum(a: np.ndarray) -> np.ndarray:
    """Elementwise sum over the processes (one all_reduce)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def allgather(a: np.ndarray) -> np.ndarray:
    """[processes, *a.shape]: every process's ``a`` in rank order (one
    all_gather_into_tensor)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device()).reshape(-1)
    out = torch.empty(process_count() * t.numel(), dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():  # renamed all_gather_single in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t)
    return out.cpu().numpy().reshape((process_count(),) + a.shape)
