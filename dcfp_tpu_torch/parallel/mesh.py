"""The data-parallel mesh and its collectives (port of
``dcfp_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, spatial)`` device mesh
and lets XLA insert the collectives.  The port runs one process per card
(PyTorch's idiom): the ``data`` axis is the process axis of the default
``torch.distributed`` group, NCCL between CUDA ranks and gloo on the CPU.
The semantics stay the JAX package's, with the collectives written out:

* BN moments are those of the global batch (``sum_across``, an autograd
  sum, in ``graph/apply._bn``);
* each rank's loss is its share of the global-batch loss, so the shares
  add up to it (``losses/criteria.py``);
* gradients are summed across ranks in one flat buffer a step
  (``all_reduce_``), so params stay identical on every rank;
* confusion counts and stop flags are plain ``all_reduce_`` sums / maxima.

The ``spatial`` axis splits image height: global rank ``r`` is data rank
``r // n_spatial`` and spatial rank ``r % n_spatial`` (the JAX package's
devices reshaped ``(n_data, n_spatial)``), and the ranks of one data
rank form a spatial group, which holds bands of rows of every
activation and swaps the rows an op reads across bands
(``parallel/spatial.py``).  The world-wide sums above stay world-wide:
the bands of one image partition its pixels, so every pixel is counted
once.

Every helper is the identity when the world is 1 (no group, or a group
of one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dcfp_tpu_torch.device import DeviceLike, resolve_device


def world() -> int:
    """Processes in the data-parallel group (1 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the group (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def local_device(device: DeviceLike = None) -> torch.device:
    """``device`` (None means CUDA) with the index of this process's card
    filled in: ``distributed.initialize`` binds ``cuda:LOCAL_RANK``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def band(h: int, s: int, i: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a height-``h`` tensor that spatial rank ``i``
    of ``s`` holds: the first ``h % s`` bands take one row more."""
    q, r = divmod(h, s)
    lo = i * q + min(i, r)
    return lo, lo + q + (1 if i < r else 0)


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's view of its spatial group: the group's size, this
    rank's index in it, the global ranks of the group in band order and
    the process group itself.  ``parallel/spatial.py``'s band rule
    splits image rows over it."""
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def band(self, h: int, i: Optional[int] = None) -> Tuple[int, int]:
        return band(h, self.size, self.index if i is None else i)

    def bands(self, h: int) -> List[Tuple[int, int]]:
        return [band(h, self.size, j) for j in range(self.size)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's ``(data, spatial)`` mesh as one rank sees it: the axis
    sizes, this process's global rank, its device, its ranks on the two
    axes, its spatial group (``spatial``, None when ``n_spatial`` is 1)
    and its data group (the ranks of its spatial rank; None when
    ``n_data`` is 1 or ``n_spatial`` is 1, where the world is it)."""
    n_data: int
    n_spatial: int
    rank: int
    device: torch.device
    spatial: Optional[Axis] = None
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial


def create_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
                device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the group: ``n_data`` x ``n_spatial``
    must equal the world, as the JAX package's device count must.  With
    ``n_spatial`` > 1 every rank creates every spatial and data group, in
    the same order (``new_group`` is collective), and runs one sum on its
    spatial group, so that NCCL's communicator exists before the first
    point-to-point exchange on it."""
    total = world()
    if n_data is None:
        n_data = total // n_spatial
    if n_data * n_spatial != total:
        raise ValueError(f"mesh {n_data}x{n_spatial} != {total} devices")
    r, dev = rank(), local_device(device)
    if n_spatial == 1:
        return Mesh(n_data, 1, r, dev)
    spatial_groups = [tuple(range(d * n_spatial, (d + 1) * n_spatial))
                      for d in range(n_data)]
    groups = {ranks: dist.new_group(list(ranks)) for ranks in spatial_groups}
    data_group = None
    if n_data > 1:
        for s in range(n_spatial):
            ranks = list(range(s, total, n_spatial))
            g = dist.new_group(ranks)
            if r in ranks:
                data_group = g
    mine = spatial_groups[r // n_spatial]
    axis = Axis(n_spatial, r % n_spatial, mine, groups[mine])
    probe = torch.zeros(1, device=collective_device())
    dist.all_reduce(probe, group=axis.group)
    return Mesh(n_data, n_spatial, r, dev, axis, data_group)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _put(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's host piece of the global batch onto its device: NHWC
    images, (N, H, W) labels and the per-image 2-D vectors (compact
    ``pad`` triples, ``weight_class``) are all this rank's rows (the
    loader's stride of the epoch permutation over the data axis), nested
    dicts walked as the JAX package walks them.  Images stay whole: under
    a spatial axis the train step keeps its band of their rows."""
    out = {}
    for k, v in batch.items():
        out[k] = (shard_batch(mesh, v) if isinstance(v, dict)
                  else _put(v, mesh.device))
    return out


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple / dataclass, in a
    fixed order (sorted dict keys), the same on every rank."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate_tree(mesh: Mesh, tree):
    """``tree``'s tensors on this rank's device, rank 0's values on every
    rank (one broadcast a tensor).  The JAX package's ``put`` of a
    replicated array expects identical arrays on every process; here
    every rank starts from rank 0's params, BN state and optimizer
    state whatever it initialised itself."""
    out = _map(tree, lambda t: t.detach().to(mesh.device).clone())
    if world() > 1:
        for t in _tensors(out):
            _broadcast_(t)
    return out


# ---------------------------------------------------------------------------
# collectives (the identity in a world of 1)
# ---------------------------------------------------------------------------

def _reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> None:
    """``dist.all_reduce`` in place over ``group`` (None: every rank).
    Two ranks that share one card run gloo on CUDA tensors (NCCL refuses
    two ranks on one device): those go through a host copy."""
    kw = {} if group is None else {"group": group}
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, **kw)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, **kw)


def _broadcast_(t: torch.Tensor) -> None:
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.broadcast(host, src=0)
        t.copy_(host)
    else:
        dist.broadcast(t, src=0)


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` (``op``: "sum" or "max"), no
    autograd; returns ``t``.  Sums are deterministic and bit-identical on
    every rank (NCCL's and gloo's rings reduce each element once and
    broadcast it)."""
    if world() > 1:
        _reduce(t, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return t


class _SumAcross(torch.autograd.Function):
    """Sum over the ranks of ``group`` (None: every rank) whose backward
    is the sum of the ranks' incoming gradients: SyncBN's reduce, for a
    quantity every rank's loss share reads."""

    @staticmethod
    def forward(ctx, t, group=None):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        _reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        _reduce(out, group=ctx.group)
        return out, None


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ranks, differentiable (see ``_SumAcross``);
    ``t`` itself in a world of 1."""
    return _SumAcross.apply(t) if world() > 1 else t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on every rank) concatenated along
    dim 0 in rank order, without gradient; ``t`` in a world of 1."""
    if world() == 1:
        return t
    t = t.detach().contiguous()
    src = t.cpu() if t.is_cuda and dist.get_backend() == "gloo" else t
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def collective_device() -> torch.device:
    """Where a host value goes for a collective: this rank's card under
    NCCL, the CPU under gloo (or without a group)."""
    if world() > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")

