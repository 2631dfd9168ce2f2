"""Rank meshes, batch sharding, the gradient mean and the pose head's
tensor parallelism.

Port of ``deepim_tpu/parallel/mesh.py``.  The reference's ``Mesh`` is a
grid of chips under one program; here a :class:`Mesh` is a grid of ranks
(processes) with the ``torch.distributed`` groups of its rows and columns:
rank ``d * n_model + m`` holds data index ``d`` and model index ``m``.

- Data parallelism: every rank trains on its rows of the global batch
  (:func:`shard_batch`) and :func:`mean_gradients` all-reduces the mean of
  the gradients and metrics before the optimizer clips them, where the
  reference ``pmean``s inside its ``shard_map``.
- Tensor parallelism of the pose head (the reference's ``_TP_RULES``, which
  GSPMD partitions): :func:`shard_params_for_tp` makes fc1 column-parallel
  (each model rank keeps fc_dim / n_model output features and their bias)
  and fc2 row-parallel (the matching input features; one all-reduce sums
  the partial products, and fc2's bias stays whole).  The two collectives
  of this (Megatron) split are autograd functions: fc1's input is the
  identity forward and an all-reduce backward, fc2's output an all-reduce
  forward and the identity backward (``torch.distributed.nn``'s
  all-reduce would reduce in backward too and multiply fc2's input
  gradient by n_model).

Only ``all_reduce`` and ``broadcast`` are used: gloo has no
``all_gather`` or ``reduce_scatter`` for CUDA tensors (and DTensor's
redistributions need them), and ranks that share a card must use gloo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """This rank's place in an (n_data, n_model) grid of ranks.

    ``data_group`` holds the ranks of this rank's model index (the data
    axis: gradients of tensor-parallel shards are averaged there),
    ``model_group`` those of its data index (the model axis), ``group``
    every rank of the mesh.  A rank beyond the mesh (the world holds more
    ranks than the mesh) has ``member`` False and takes no part.
    """

    shape: dict[str, int]
    rank: int
    data_index: int
    model_index: int
    group: object
    data_group: object
    model_group: object
    device: torch.device
    member: bool = True

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: torch.device | None = None) -> Mesh:
    """The (data, model) mesh over the first n_data * n_model ranks of the
    default group; every rank of the group must call it (it makes the
    groups).  ``device`` defaults to this rank's (``cuda:current`` or the
    CPU under gloo without CUDA)."""
    from deepim_tpu_torch.parallel import distributed

    world = distributed.world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} exceeds {world} ranks")
    if device is None:
        device = distributed._DEVICE or torch.device("cpu")
    r = distributed.rank()
    size = n_data * n_model
    if not dist.is_initialized():  # one process: the trivial mesh, no collectives
        return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, 0, 0, None, None, None, device)
    grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    group = dist.group.WORLD if size == world else dist.new_group(list(range(size)))
    data_groups = [dist.new_group([row[m] for row in grid]) for m in range(n_model)]
    model_groups = [dist.new_group(row) for row in grid]
    if r >= size:
        return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, r, -1, -1, None, None, None,
                    device, member=False)
    d, m = divmod(r, n_model)
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, r, d, m, group, data_groups[m],
                model_groups[d], device)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows of the leading dim of every tensor of
    ``batch`` (a tensor, or a dict of them; other values pass through)."""
    n, i = mesh.shape[DATA_AXIS], mesh.data_index

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide the mesh's {n} "
                             "data ranks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    if isinstance(batch, dict):
        return {key: rows(v) for key, v in batch.items()}
    return rows(batch)


def replicate(mesh: Mesh, module_or_tensors):
    """Broadcast from the mesh's first rank, in place: a module's
    parameters and buffers, or a list of tensors -> the argument."""
    if mesh.group is None:
        return module_or_tensors
    if isinstance(module_or_tensors, nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return module_or_tensors


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, accumulated in float32 -> ``x``'s dtype."""
    y = x.float().contiguous() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """fc1's input: the identity forward; backward, the all-reduce over
    the model axis of the partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """fc2's output: the all-reduce over the model axis of the partial
    products forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelLinear(nn.Module):
    """fc1 on one model rank: rows ``m*k:(m+1)*k`` of the weight and bias
    (``k = out_features / n_model``), applied in the input's dtype."""

    def __init__(self, lin: nn.Linear, mesh: Mesh):
        super().__init__()
        n, m = mesh.shape[MODEL_AXIS], mesh.model_index
        if lin.out_features % n:
            raise ValueError(f"fc1's {lin.out_features} features do not divide {n} model ranks")
        k = lin.out_features // n
        self.weight = nn.Parameter(lin.weight.detach()[m * k:(m + 1) * k].clone())
        self.bias = nn.Parameter(lin.bias.detach()[m * k:(m + 1) * k].clone())
        self.in_features, self.out_features = lin.in_features, k
        self.group = mesh.model_group

    sharded = ("weight", "bias")  # the parameters that differ by model rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RowParallelLinear(nn.Module):
    """fc2 on one model rank: columns ``m*k:(m+1)*k`` of the weight, the
    partial products summed over the model axis, then the whole bias."""

    def __init__(self, lin: nn.Linear, mesh: Mesh):
        super().__init__()
        n, m = mesh.shape[MODEL_AXIS], mesh.model_index
        if lin.in_features % n:
            raise ValueError(f"fc2's {lin.in_features} inputs do not divide {n} model ranks")
        k = lin.in_features // n
        self.weight = nn.Parameter(lin.weight.detach()[:, m * k:(m + 1) * k].clone())
        self.bias = nn.Parameter(lin.bias.detach().clone())
        self.in_features, self.out_features = k, lin.out_features
        self.group = mesh.model_group

    sharded = ("weight",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y + self.bias.to(y.dtype)


def shard_params_for_tp(model, mesh: Mesh):
    """Replace ``model``'s fc1 and fc2 by this rank's column- and
    row-parallel shards (in place; everything else stays replicated) ->
    ``model``.  Build the optimizer after this.  int8 models raise."""
    if mesh.shape[MODEL_AXIS] == 1:
        return model
    if getattr(model, "quant", "none") != "none":
        raise NotImplementedError("tensor parallelism of the int8 pose head is not ported "
                                  "(int8 runs with a data axis only)")
    model.fc1 = ColumnParallelLinear(model.fc1, mesh)
    model.fc2 = RowParallelLinear(model.fc2, mesh)
    return model


def sharded_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The parameters that :func:`shard_params_for_tp` split over the
    model axis (each model rank holds other values)."""
    return [p for mod in model.modules()
            if isinstance(mod, (ColumnParallelLinear, RowParallelLinear))
            for p in map(mod.get_parameter, mod.sharded)]


def _mean(tensors: list[torch.Tensor], group, n: int) -> None:
    """Replace ``tensors`` by their mean over ``group`` (``n`` ranks), in
    one all-reduce of one flat buffer."""
    if not tensors or group is None:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for t, f in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(f)


def mean_gradients(model: nn.Module, mesh: Mesh) -> None:
    """The data-parallel mean of every parameter's ``.grad``, in place:
    tensor-parallel shards over the data axis, everything else over the
    whole mesh (its model ranks hold equal gradients there)."""
    shards = {id(p) for p in sharded_parameters(model)}
    params = list(model.parameters())
    _mean([p.grad for p in params if id(p) not in shards], mesh.group, mesh.size)
    _mean([p.grad for p in params if id(p) in shards], mesh.data_group,
          mesh.shape[DATA_AXIS])


def mean_metrics(metrics: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """Each 0-d metric's mean over the mesh, in one all-reduce."""
    if mesh.group is None:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    return dict(zip(keys, flat.unbind()))


def global_grad_norm(model: nn.Module, mesh: Mesh) -> torch.Tensor:
    """The norm of the whole model's gradient under tensor parallelism:
    the replicated parameters' squares plus the shards' squares summed
    over the model axis."""
    from deepim_tpu_torch.train.train import global_norm

    shards = {id(p) for p in sharded_parameters(model)}
    rep = [p.grad for p in model.parameters() if id(p) not in shards]
    sq = torch.stack([p.grad.float().square().sum() for p in sharded_parameters(model)]).sum()
    dist.all_reduce(sq, group=mesh.model_group)
    return torch.sqrt(global_norm(rep).square() + sq)


def gather_rows(local: torch.Tensor, index: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows in one (n, ...) tensor on every rank: this rank's
    ``local`` rows go to rows ``index`` of a zero buffer, which one
    all-reduce sums (exact: each row is one rank's, plus zeros)."""
    full = torch.zeros((n, *local.shape[1:]), dtype=local.dtype, device=local.device)
    full[index.to(local.device)] = local
    if mesh.group is not None:
        dist.all_reduce(full, group=mesh.group)
    return full
