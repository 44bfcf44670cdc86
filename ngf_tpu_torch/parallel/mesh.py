"""Ranks and process groups of the parallel modes: the counterpart of
`ngf_tpu/parallel/mesh.py` over ``torch.distributed``.

The JAX package puts the chips of one program in a device mesh and lets XLA
insert the collectives. Here every rank is a process on one device, the
parameters are replicated, and the collectives are explicit: the trainer
reduces its gradients once a step, and the sample-parallel renderer
(`sample_parallel.py`) exchanges each shard's transmittance and sums.

- :func:`maybe_initialize_distributed`: the process group, from the
  ``NGF_*`` variables (``tcp://`` rendezvous) or the launcher's own
  (``NGF_DISTRIBUTED=1``: ``env://``, as torchrun sets them).
- :func:`make_mesh` (a 1-D ``data`` mesh over every rank) and
  :func:`make_mesh_2d` (``data`` x ``sample``, rank r at (r // S, r % S)):
  a :class:`Mesh` with each axis's process group.
- :func:`shard_batch`: this rank's contiguous slice of a global batch along
  axis 0, as ``P("data")`` splits it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# A collective that waits longer than this fails the run instead of hanging
# it (a rank that died, or one that left the loop alone).
TIMEOUT = datetime.timedelta(minutes=30)

_INITIALIZED = False


def maybe_initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str | None = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> bool:
    """Initialise the default process group when the caller or the
    environment opts in (`ngf_tpu/parallel/mesh.py:25-71`)::

        NGF_COORDINATOR=host:port NGF_NUM_PROCESSES=N NGF_PROCESS_ID=i
        NGF_DISTRIBUTED=1   # no address: the launcher's MASTER_ADDR,
                            # MASTER_PORT, WORLD_SIZE and RANK (torchrun)

    The backend is NCCL for ``device_type`` 'cuda' (default: 'cuda' when a
    card is present) and gloo for 'cpu'; ``NGF_DIST_BACKEND`` names another
    (``gloo`` for several ranks that share one card). Returns False, doing
    nothing, when nobody opts in; True once a group exists (idempotent).
    """
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return True
    env = os.environ
    coordinator = coordinator or env.get("NGF_COORDINATOR") or None
    if num_processes is None and env.get("NGF_NUM_PROCESSES"):
        num_processes = int(env["NGF_NUM_PROCESSES"])
    if process_id is None and env.get("NGF_PROCESS_ID"):
        process_id = int(env["NGF_PROCESS_ID"])
    auto = env.get("NGF_DISTRIBUTED", "0") not in ("", "0")
    if coordinator is None and not auto:
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = env.get("NGF_DIST_BACKEND") or ("nccl" if device_type == "cuda" else "gloo")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("NGF_COORDINATOR needs NGF_NUM_PROCESSES and NGF_PROCESS_ID "
                             "(or num_processes and process_id)")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    _INITIALIZED = True
    return True


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK`` as
    torchrun sets it, else the global rank."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a mesh: ``shape`` by axis name (``{"data": D}`` or
    ``{"data": D, "sample": S}``), ``axis_names``, this rank, its index on
    each axis, and the process group of each axis that holds this rank
    (``data_group``: the ranks of its sample index; ``sample_group``: the
    ranks of its data index, None on a 1-D mesh)."""

    shape: dict
    axis_names: tuple
    rank: int
    data_index: int
    sample_index: int
    data_group: object
    sample_group: object = None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_sample(self) -> int:
        return self.shape.get("sample", 1)


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call maybe_initialize_distributed() "
                           "with NGF_COORDINATOR/NGF_NUM_PROCESSES/NGF_PROCESS_ID or "
                           "NGF_DISTRIBUTED=1 set")
    return dist.get_rank(), dist.get_world_size()


def make_mesh() -> Mesh:
    """1-D data-parallel mesh over every rank (`ngf_tpu/parallel/mesh.py:74-78`)."""
    rank, world = _world()
    return Mesh({"data": world}, ("data",), rank, rank, 0, dist.group.WORLD)


def make_mesh_2d(n_data: int, n_sample: int) -> Mesh:
    """('data', 'sample') mesh over the n_data * n_sample ranks of the
    world: rank r at (r // n_sample, r % n_sample), the row-major reshape
    of `ngf_tpu/parallel/mesh.py:97-106`. Every rank builds every axis
    group, in the same order."""
    rank, world = _world()
    if n_data * n_sample != world:
        raise ValueError(f"mesh {n_data}x{n_sample} needs {n_data * n_sample} ranks; the world "
                         f"has {world}")
    data_groups = [dist.new_group([d * n_sample + s for d in range(n_data)])
                   for s in range(n_sample)]
    sample_groups = [dist.new_group([d * n_sample + s for s in range(n_sample)])
                     for d in range(n_data)]
    d, s = divmod(rank, n_sample)
    return Mesh({"data": n_data, "sample": n_sample}, ("data", "sample"), rank, d, s,
                data_groups[s], sample_groups[d])


def shard_batch(mesh: Mesh, *tensors: torch.Tensor):
    """This rank's contiguous slice along axis 0 of each global batch, as
    ``P("data")`` splits it (`ngf_tpu/parallel/mesh.py:90-94`): rows
    ``[i b, (i + 1) b)`` of data index i, b = rows / D."""
    out = []
    for t in tensors:
        b, rem = divmod(t.shape[0], mesh.n_data)
        if rem:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over "
                             f"{mesh.n_data} data ranks")
        out.append(t[mesh.data_index * b:(mesh.data_index + 1) * b])
    return tuple(out) if len(out) > 1 else out[0]
