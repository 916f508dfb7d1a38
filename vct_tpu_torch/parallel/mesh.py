"""Process groups, the ('data', 'model') mesh and the collectives of data and
tensor parallelism (port of ``vct_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives. The port runs one process per device, as the reference did
(DDP over NCCL, ``mesh.py:4-8`` there), and says each collective itself:

* a rank is one process on one device; ranks form a ``data x model`` grid,
  rank ``r`` at data index ``r // model`` and model index ``r % model`` (the
  device order of the JAX mesh), with one process group per data column
  (``data_group``: the ranks that hold the same parameter shards, DDP's
  group) and one per model row (``model_group``: the ranks of one tensor
  parallel layer);
* every rank draws the same global batch and keeps its contiguous rows
  (``shard_batch``, the layout of ``NamedSharding(P('data'))``);
* gradients are averaged over ``data_group`` by DDP; a loss over the whole
  global batch gathers rows with ``gather_rows``, whose backward sums the
  gradient over the ranks and keeps this rank's rows;
* tensor parallelism splits the FFN Megatron-style and the LM head by vocab
  (``_TP_RULES``); ``copy_to_model`` / ``reduce_from_model`` are the two
  conjugate collectives around a split layer.

Every collective is an all-reduce (a gather is a sum of zero-filled buffers,
exact because adding zeros is), so the same code runs on NCCL and on gloo,
whose CUDA support is all-reduce and broadcast. The kernels take no part:
each rank launches them on its own rows, so the JAX package's ``shard_map``
wrappers and its kernel-mesh registry have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in the ``data x model`` grid. ``backend`` is
    None when no process group exists (one process, every collective a
    no-op)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the host."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device: torch.device, *, backend: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout: Optional[float] = None) -> bool:
    """Join a process group -> whether one exists. An existing group is kept;
    ``rank`` / ``world_size`` / ``init_method`` name one explicitly (``-ws N``
    spawning, tests with ``file://`` rendezvous), otherwise ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``env://``) is joined when set.
    Neither: one process, no group."""
    if dist.is_initialized():
        return True
    if rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if rank is None:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or default_backend(device), init_method=init_method,
                            rank=rank, world_size=world_size, **kw)
    return True


def mesh_shape(data: int, model: int, n: int) -> Tuple[int, int]:
    """The sizing rules of ``vct_tpu.parallel.mesh.make_mesh`` for ``n``
    devices: ``data=-1`` takes all that ``model`` leaves; a mesh larger than
    ``n`` or an indivisible ``n`` raises; a deliberate sub-mesh warns."""
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    if 1 < data * model < n:
        warnings.warn(
            f"mesh {data}x{model} uses {data * model} of {n} visible devices; "
            f"the remaining {n - data * model} idle",
            stacklevel=3,
        )
    return data, model


def make_mesh(data: int = -1, model: int = 1, *, device: Optional[torch.device] = None,
              backend: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, init_method: Optional[str] = None,
              timeout: Optional[float] = None) -> Mesh:
    """The ('data', 'model') mesh over the ranks of the process group (joined
    here when ``rank`` or ``torchrun``'s environment names one; see
    ``init_process_group``), or over this one process. ``backend`` defaults
    to NCCL for a CUDA ``device`` and gloo for the CPU. Every rank must call
    it: the groups are made collectively."""
    device = torch.device(device if device is not None else "cpu")
    joined = init_process_group(device, backend=backend, rank=rank, world_size=world_size,
                                init_method=init_method, timeout=timeout)
    n = dist.get_world_size() if joined else 1
    data, model = mesh_shape(data, model, n)
    if not joined:
        return Mesh(data, model, device=device)
    me = dist.get_rank()
    mesh = Mesh(data, model, rank=me, world=n, device=device, backend=dist.get_backend())

    def group(ranks):  # made by every rank, in the same order on each
        if len(ranks) == n:
            return dist.group.WORLD
        return dist.new_group(ranks) if len(ranks) > 1 else None

    for m in range(model):  # one group per data column
        ranks = [d * model + m for d in range(data)]
        g = group(ranks)
        if me in ranks:
            mesh.data_group = g
    for d in range(data):  # one group per model row
        ranks = [d * model + m for m in range(model)]
        g = group(ranks)
        if me in ranks:
            mesh.model_group = g
    return mesh


def destroy() -> None:
    """Leave the process group (when one exists)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


def row_range(mesh: Mesh, batch: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a global batch of ``batch`` rows."""
    if batch % mesh.data:
        raise ValueError(
            f"global batch {batch} is not divisible by the mesh's data size {mesh.data}: "
            f"decode and train over the mesh need batch % mesh_data == 0, which "
            f"collate's fixed rectangles guarantee when the batch size divides")
    per = batch // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous rows of every tensor or array in ``tree``
    (dicts, lists and tuples of them; None passes), as
    ``NamedSharding(P('data'))`` lays the global batch out."""
    if mesh.data == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if tree is None:
        return None
    lo, hi = row_range(mesh, tree.shape[0])
    return tree[lo:hi]


# ---------------------------------------------------------------------------
# collectives (every one an all-reduce; a group of None is one rank)
# ---------------------------------------------------------------------------


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (no gradient), as a new tensor."""
    if _group_size(group) == 1:
        return x.detach()
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group`` (no gradient)."""
    if _group_size(group) == 1:
        return x.detach()
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _place(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    """A zero tensor n times ``x``'s size along ``dim`` with ``x`` at block
    ``index``."""
    shape = list(x.shape)
    per = shape[dim]
    shape[dim] = per * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, index * per, per).copy_(x)
    return buf


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows in rank order. Backward: the gradient
    summed over the ranks (each computed the same loss of the gathered rows),
    this rank's rows kept; DDP's mean over ranks then gives the gradient of
    that one loss."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.n, ctx.index, ctx.rows = group, n, index, x.shape[0]
        buf = _place(x.contiguous(), n, index, 0)
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None, None


def gather_rows(x: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """The global batch's rows of ``x`` from every data rank (differentiable;
    bool masks come back as bool)."""
    if x is None or mesh.data == 1:
        return x
    if x.dtype == torch.bool:
        return gather_rows(x.float(), mesh) > 0.5
    if not x.requires_grad:
        buf = _place(x.contiguous(), mesh.data, mesh.data_index, 0)
        dist.all_reduce(buf, group=mesh.data_group)
        return buf
    return _GatherRows.apply(x, mesh.data_group, mesh.data, mesh.data_index)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model group (the
    input of a split layer feeds every shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward sums the shards' partial results over the model group;
    backward is the identity (every rank goes on with the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.model == 1 else _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.model == 1 else _ReduceFromModel.apply(x, mesh.model_group)


def gather_shards(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model group's shards along ``dim`` (no
    gradient)."""
    if mesh.model == 1:
        return x.detach()
    buf = _place(x.detach().contiguous(), mesh.model, mesh.model_index, dim)
    dist.all_reduce(buf, group=mesh.model_group)
    return buf


def gather_world(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in rank order (no gradient)."""
    if not mesh.distributed or mesh.world == 1:
        return [x.detach()]
    buf = _place(x.detach().contiguous()[None], mesh.world, mesh.rank, 0)
    dist.all_reduce(buf)
    return list(buf.unbind(0))


def barrier(mesh: Mesh) -> None:
    """Every rank waits for the others (no-op for one process)."""
    if mesh.distributed and mesh.world > 1:
        dist.barrier()


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` on every rank: decisions every rank must take alike
    (earlystop, scheduler, saving) come from one place."""
    if not mesh.distributed or mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# tensor parallelism over 'model'
# ---------------------------------------------------------------------------

# Megatron-style splits (``vct_tpu/parallel/mesh.py:78-113``) in the port's
# state_dict names: torch keeps weights [out, in], so JAX's [in, out] split
# dims transpose. FFN: column-split linear1 (weight and bias), row-split
# linear2 (its bias is added once, after the reduction); LM head: split by
# vocab. Attention and embeddings stay replicated. (suffix, ndim, split dim);
# a rule fires only when the split dim divides evenly.
_TP_RULES = (
    (".linear1.weight", 2, 0),
    (".linear1.bias", 1, 0),
    (".linear2.weight", 2, 1),
    (".generator.weight", 2, 0),
    (".generator.bias", 1, 0),
)


def tp_spec(name: str, shape: Sequence[int], model_size: int) -> Optional[int]:
    """The dim along which the parameter (or optimizer moment) ``name`` of
    full ``shape`` splits over ``model_size`` ranks; None = replicated."""
    if model_size <= 1:
        return None
    name = "." + name
    for suffix, ndim, dim in _TP_RULES:
        if name.endswith(suffix) and len(shape) == ndim:
            return dim if shape[dim] % model_size == 0 else None
    return None


def _shard(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    per = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_index * per, per).clone()


def shard_train_state(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Keep this rank's shard of every parameter ``tp_spec`` splits and
    switch the split layers to their tensor parallel forward (a module with a
    ``TP_PARAM`` class attribute names the parameter whose split decides it).
    Call it before the optimizer's first step: the moments are then made in
    the shards' shapes (``load_full_optimizer_state`` splits whole ones).
    Nothing changes at ``model`` 1. The split dims are kept in
    ``model.tp_split`` for ``full_state_dict``."""
    split: Dict[str, int] = {}
    if mesh.model > 1:
        for name, p in model.named_parameters():
            dim = tp_spec(name, p.shape, mesh.model)
            if dim is None:
                continue
            p.data = _shard(p.data, dim, mesh)
            split[name] = dim
        for name, mod in model.named_modules():
            tp_param = getattr(type(mod), "TP_PARAM", None)
            if tp_param and f"{name}.{tp_param}".lstrip(".") in split:
                mod.tp = mesh
    model.tp_split = split
    return model


def full_state_dict(mesh: Mesh, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every split tensor gathered whole, on the
    host. Every rank of the model group must call it."""
    split = getattr(model, "tp_split", {})
    return {k: (gather_shards(v, split[k], mesh) if k in split else v.detach()).cpu()
            for k, v in model.state_dict().items()}


def load_full_state_dict(mesh: Mesh, model: nn.Module, state: Dict[str, torch.Tensor]
                         ) -> None:
    """Load whole tensors (a checkpoint from any mesh) into a split model."""
    split = getattr(model, "tp_split", {})
    model.load_state_dict({k: (_shard(v, split[k], mesh) if k in split else v)
                           for k, v in state.items()})


def _param_names(model: nn.Module, optimizer) -> List[Optional[str]]:
    """The parameter name of each index of ``optimizer.state_dict()``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names.get(id(p)) for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(mesh: Mesh, model: nn.Module, optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole (every rank of the model group must call it)."""
    sd = optimizer.state_dict()
    split = getattr(model, "tp_split", {})
    if not split:
        return sd
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, name in enumerate(_param_names(model, optimizer)):
        if name in split and i in sd["state"]:
            sd["state"][i] = {k: (gather_shards(v, split[name], mesh)
                                  if isinstance(v, torch.Tensor) and v.shape == params[i].shape
                                  else v)
                              for k, v in sd["state"][i].items()}
    return sd


def load_full_optimizer_state(mesh: Mesh, model: nn.Module, optimizer,
                              sd: Dict[str, Any]) -> None:
    """Load a whole optimizer state (from any mesh) into a split model's
    optimizer."""
    split = getattr(model, "tp_split", {})
    if split:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = dict(sd["state"])
        for i, name in enumerate(_param_names(model, optimizer)):
            if name in split and i in state:
                dim = split[name]
                state[i] = {k: (_shard(v, dim, mesh)
                                if isinstance(v, torch.Tensor)
                                and v.dim() == params[i].dim()
                                and v.shape[dim] == params[i].shape[dim] * mesh.model
                                else v)
                            for k, v in state[i].items()}
        sd = dict(sd, state=state)
    optimizer.load_state_dict(sd)


# ---------------------------------------------------------------------------
# process-per-device launch
# ---------------------------------------------------------------------------


def spawn(fn: Callable, nprocs: int, args: tuple = (), timeout: Optional[float] = None
          ) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait for
    all of them. A rank that raises ends the others, and its traceback is
    raised here; past ``timeout`` seconds every rank is ended and
    ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
