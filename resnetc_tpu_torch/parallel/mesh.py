"""Mesh and sharding rules.

Counterpart of ``resnetc_tpu/parallel/mesh.py``.  Axes:

- ``data``: data parallelism.  The batch dimension is split over the
  ranks of this axis, each rank keeps a replica of the parameters, and the
  gradients are averaged by one all-reduce (``train.sharded_train_step``).
- ``model``: channel tensor parallelism.  Each rank of the axis keeps the
  shard of every parameter on the dimension ``param_shardings`` gives it
  (``shard_tree``); the forward gathers activations over the axis
  (``parallel.tp``).

JAX places arrays with ``NamedSharding``s and lets XLA partition the
program.  In the port each rank runs its own program, so the batch and
label placements become slicing functions, the replicated placement a
broadcast from the data axis's first rank, and a parameter's sharding over
the model axis a contiguous copy of the rank's slice.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from resnetc_tpu_torch.tensor import tree_map

Tree = Any

DATA_AXIS = "data"
MODEL_AXIS = "model"

def mesh_shape(n_devices: int, n_data: int | None = None, n_model: int = 1) -> tuple[int, int]:
    """(data, model) sizes of a mesh over ``n_devices``: JAX's arithmetic
    and errors.  ``n_data=None`` takes what the model axis leaves."""
    if n_data is None:
        if n_devices % n_model:
            raise ValueError(f"{n_devices} devices not divisible by model={n_model}")
        n_data = n_devices // n_model
    need = n_data * n_model
    if need > n_devices:
        raise ValueError(f"need {need} devices, have {n_devices}")
    return n_data, n_model


def create_mesh(n_data: int | None = None, n_model: int = 1, *, device_type: str | None = None):
    """A 2-D (data, model) ``DeviceMesh`` over the ranks of the process group
    (``distributed.initialize`` first), in rank order.  Every rank takes one
    place, so the mesh must cover the group.  ``device_type`` defaults to
    ``cuda`` where CUDA is present."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs the process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    shape = mesh_shape(world, n_data, n_model)
    if shape[0] * shape[1] != world:
        raise ValueError(f"a {shape[0]} x {shape[1]} mesh leaves ranks of the group of "
                         f"{world} without a place")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, or of a mapping such as
    ``{"data": 4, "model": 2}`` (for the pure rules)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_group(mesh):
    """The process group of this rank's data axis: the ranks of its model
    index."""
    return mesh.get_group(DATA_AXIS)


def model_group(mesh):
    """The process group of this rank's model axis: the ranks of its data
    index, which hold the shards of one replica."""
    return mesh.get_group(MODEL_AXIS)


def model_index(mesh) -> int:
    """This rank's place on the model axis: the shard it holds."""
    return mesh.get_local_rank(MODEL_AXIS)


def batch_sharding(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's slice of a global batch along dim 0 (JAX ``P('data')``):
    a view, in rank order over the data axis.  Raises on a batch the axis
    does not divide."""
    n = axis_sizes(mesh)[DATA_AXIS]
    i = mesh.get_local_rank(DATA_AXIS)

    def take(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"global batch {x.shape[0]} not divisible by data={n}")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return take


label_sharding = batch_sharding


def replicated(mesh) -> Callable[[list], None]:
    """Make every rank's copy equal to the first data rank's of its model
    index: broadcasts the given tensors in place over the data axis (JAX
    ``P()`` over 'data': one copy on every device of the axis)."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)

    def share(tensors: list) -> None:
        by_kind: dict = {}
        for t in tensors:
            by_kind.setdefault((t.dtype, t.device), []).append(t)
        with torch.no_grad():
            for ts in by_kind.values():  # one broadcast per dtype
                flat = torch.cat([t.reshape(-1) for t in ts])
                dist.broadcast(flat, src=src, group=group)
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

    return share


def _param_spec(shape: tuple[int, ...]) -> int | None:
    """The dimension of a parameter sharded over 'model': conv weights HWIO
    shard O, the fc weight [out, in] shards out, every per-channel vector
    (BN affine and stats, fc bias) its only dimension."""
    if len(shape) == 4:
        return 3
    if len(shape) in (1, 2):
        return 0
    return None


def param_shardings(mesh, tree: Tree) -> Tree:
    """For each leaf of a parameter tree, the dimension sharded over
    'model', or None (replicated).  A dimension the model axis does not
    divide is replicated instead (a fc of 11 classes over 2).  Every
    dimension is replicated over 'data'."""
    model = axis_sizes(mesh)[MODEL_AXIS]

    def rule(leaf):
        dim = _param_spec(tuple(leaf.shape))
        return dim if dim is not None and leaf.shape[dim] % model == 0 else None

    return tree_map(rule, tree)


def _zip_map(fn, tree: Tree, dims: Tree) -> Tree:
    """``fn(leaf, dim)`` over a tree and its ``param_shardings``."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def _slice(leaf: torch.Tensor, dim: int | None, index: int, n: int) -> torch.Tensor:
    if dim is None:
        return leaf
    size = leaf.shape[dim] // n
    return leaf.narrow(dim, index * size, size).clone(memory_format=torch.contiguous_format)


def shard_tree(mesh, tree: Tree) -> Tree:
    """This rank's shard of a whole tree: each leaf sliced on the dimension
    ``param_shardings`` gives it, at ``model_index``, as a contiguous copy
    (an O-slice of an HWIO weight is strided, and the kernels read a weight
    as it lies in memory), or the leaf itself where it is replicated.  The
    copy is made once, where a tree is placed, never per call."""
    n = axis_sizes(mesh)[MODEL_AXIS]
    if n == 1:
        return tree
    i = model_index(mesh)
    dims = param_shardings(mesh, tree)
    return _zip_map(lambda leaf, d: _slice(leaf, d, i, n), tree, dims)


def gather_tree(mesh, tree: Tree, dims: Tree) -> Tree:
    """The whole tree from every model rank's ``shard_tree``: each leaf
    all-gathered over the model group along its dimension in ``dims``
    (``param_shardings`` of the whole tree: a shard's own shape cannot tell
    an 11-class fc replicated over 2 from a 22-class one sharded), the
    others kept.  Every model rank takes part and gets the whole tree."""
    n = axis_sizes(mesh)[MODEL_AXIS]
    if n == 1:
        return tree
    group = model_group(mesh)

    def gather(leaf, dim):
        if dim is None:
            return leaf
        parts = [torch.empty_like(leaf) for _ in range(n)]
        dist.all_gather(parts, leaf.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    return _zip_map(gather, tree, dims)
