"""Channel tensor parallelism: the collectives over the mesh's model axis,
with their gradients.

Counterpart of what XLA's SPMD partitioner inserts when the JAX package
places a tree with ``param_shardings`` over a ``model`` axis.  The port's
sharding is column-parallel: each model rank holds the output-channel shard
of every conv and the fc (``mesh.shard_tree``) and the shards of the
per-channel vectors, so activations flow channel-sharded along their last
(NHWC) dimension.  A conv or the fc first gathers its input along that
dimension over the model group; BN, bias, relu, the residual add and both
pools stay local, because the two branches of a block are sharded alike.

The two gathers differ in their backward:

- ``gather_for_sharded`` feeds a conv or fc whose output is sharded.  Each
  rank's consumer gives only a partial gradient for the whole input, so the
  backward sums the ranks' gradients and keeps this rank's slice (a
  reduce-scatter).
- ``gather_for_replicated`` feeds work that every model rank then computes
  alike: the logits before the loss, the features before a replicated fc
  (a class count the axis does not divide).  Every rank already holds the
  whole gradient, so the backward keeps this rank's slice with no sum; a
  sum there would multiply the gradient by the axis size.

Both take CUDA tensors under gloo (ranks sharing one card) as under NCCL.
The reduce-scatter is ``reduce_scatter_tensor``; a backend that lacks it
raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dimension, in rank
    order of ``group``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _own_slice(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of ``x`` along the last dimension."""
    n = x.shape[-1] // dist.get_world_size(group)
    return x.narrow(-1, dist.get_rank(group) * n, n)


def _reduce_scatter_last(g: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``g`` summed, this rank's slice along the last dimension
    (``reduce_scatter_tensor`` over the ranks' slices laid out along dim
    0)."""
    world = dist.get_world_size(group)
    lead = g.movedim(-1, 0)
    flat = lead.contiguous().reshape(-1)  # rank r's slice is the r-th 1/world
    out = flat.new_empty(flat.numel() // world)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out.view(lead.shape[0] // world, *lead.shape[1:]).movedim(0, -1)


class _GatherForSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_last(g, ctx.group), None


class _GatherForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group).contiguous(), None


def gather_for_sharded(x: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor from every model rank's channel shard (last
    dimension), for a consumer whose output is channel-sharded; the
    backward is a reduce-scatter (sum)."""
    return _GatherForSharded.apply(x, group)


def gather_for_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor from every model rank's channel shard (last
    dimension), for work every model rank then computes alike; the
    backward is this rank's slice of the gradient, with no sum."""
    return _GatherForReplicated.apply(x, group)


def input_gather(group):
    """A conv's input gather over ``group`` (``gather_for_sharded``), or
    the identity without a group."""
    if group is None:
        return lambda t: t
    return lambda t: gather_for_sharded(t, group)


def check_config(cfg, model_ranks: int) -> None:
    """Refuse a model axis that does not divide every conv's output
    channels.  Each conv's output is a shard, so every activation is one;
    the fc alone may be replicated (``mesh.param_shardings``).  JAX's
    partitioner would replicate such a layer instead; the port does not."""
    widths = {cfg.stem_width}
    for stage in range(4):
        widths.update(cfg.stage_channels(stage))
    if any(w % model_ranks for w in widths):
        raise ValueError(f"a model axis of {model_ranks} does not divide the channels "
                         f"{sorted(widths)} of {cfg.name}; channel tensor parallelism "
                         "needs it to")


def fc(feats: torch.Tensor, linear, num_classes: int, group) -> torch.Tensor:
    """The classifier over channel-sharded features; ``linear(x)`` is the
    caller's product with this rank's fc weight and bias.  A class count
    the axis divides shards the fc (``mesh.param_shardings``): every rank
    computes its classes from the gathered features, and the logits are
    gathered.  Otherwise the fc is replicated and every rank computes every
    class.  Returns the whole logits on every rank."""
    if num_classes % dist.get_world_size(group) == 0:
        return gather_for_replicated(linear(gather_for_sharded(feats, group)), group)
    return linear(gather_for_replicated(feats, group))
