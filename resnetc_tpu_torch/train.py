"""Training: forward and backward, torch-exact SGD with momentum, the LR
schedule and the train step.

Counterpart of ``resnetc_tpu/train.py`` (BASELINE.json config #4: ResNet
forward and backward with BatchNorm backward and SGD).  The step is the JAX
package's step math on stock PyTorch ops: ``models.resnet.forward`` in
train mode (BN on batch statistics, the JAX formula), gradients from
``torch.autograd.grad`` over the parameter leaves, and an SGD update that
matches ``torch.optim.SGD`` (weight decay folded into the gradient, fp32
momentum buffers, optional Nesterov).  No Pallas kernel lies on the JAX
package's training path, so none is ported here.

``sharded_train_step`` is the step over a (data, model) mesh: one process a
rank, each on its data slice of the global batch, with sync-BN over the
data axis and the gradients averaged over it by one all-reduce; over the
model axis each rank holds the channel shard of the state and the forward
gathers activations (``resnetc_tpu_torch.parallel``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from resnetc_tpu_torch.models import resnet
from resnetc_tpu_torch.ops.torch_ops import exact_fp32
from resnetc_tpu_torch.tensor import (
    BF16, DtypePolicy, flatten_tree, resolve_device, tree_map, unflatten_tree,
)
from resnetc_tpu_torch.tensor import policy as get_policy

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    label_smoothing: float = 0.0
    policy_name: str = "bf16"
    #: checkpoint each residual block in the backward pass: activation
    #: memory ~O(depth) smaller for the recomputed forward.
    remat: bool = False

    @property
    def policy(self) -> DtypePolicy:
        return get_policy(self.policy_name)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch; integer labels.  Smoothing
    spreads ``label_smoothing / classes`` over every class."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    log_probs = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    if label_smoothing:
        on = 1.0 - label_smoothing
        off = label_smoothing / num_classes
        targets = F.one_hot(labels, num_classes).float() * on + off
        nll = -(targets * log_probs).sum(dim=-1)
    else:
        nll = -log_probs.gather(-1, labels[:, None])[:, 0]
    return nll.mean()


# ---------------------------------------------------------------------------
# SGD (torch.optim.SGD-compatible)
# ---------------------------------------------------------------------------


def init_momentum(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def sgd_update(
    params: Tree,
    grads: Tree,
    momentum_buf: Tree,
    *,
    lr: float | torch.Tensor,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    nesterov: bool = False,
) -> tuple[Tree, Tree]:
    """One SGD step with torch.optim.SGD's semantics:

    ``g = grad + wd * w``; ``buf = mu * buf + g``;
    ``w -= lr * (g + mu * buf)`` if nesterov else ``w -= lr * buf``.
    With momentum 0 the buffer takes ``g`` and ``w -= lr * g``, as in the
    JAX package.  ``lr`` may be a 0-d tensor on the device.

    Updates ``params`` and ``momentum_buf`` in place (multi-tensor
    ``torch._foreach`` ops) and returns them: the inputs must not be reused
    as the old state after the call."""
    flat_p, flat_g, flat_b = flatten_tree(params), flatten_tree(grads), flatten_tree(momentum_buf)
    keys = list(flat_p)
    p = [flat_p[k] for k in keys]
    b = [flat_b[k] for k in keys]
    with torch.no_grad():
        g = [flat_g[k].float() for k in keys]
        if weight_decay:
            g = torch._foreach_add(g, p, alpha=weight_decay)
        if momentum:
            torch._foreach_mul_(b, momentum)
            torch._foreach_add_(b, g)
        else:
            for bi, gi in zip(b, g):
                bi.copy_(gi)
        step_dir = torch._foreach_add(g, b, alpha=momentum) if nesterov else b
        torch._foreach_sub_(p, torch._foreach_mul(step_dir, lr))
    return params, momentum_buf


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------


def cosine_schedule(
    base_lr: float, total_steps: int, *, warmup_steps: int = 0, final_lr: float = 0.0
):
    """Linear warm-up then cosine decay; returns ``step -> lr``, a 0-d fp32
    tensor on the step's device (a Python int gives a CPU tensor), so that a
    step count on the card yields the rate with no host sync."""

    def lr_at(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_lr + 0.5 * (base_lr - final_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return lr_at


# ---------------------------------------------------------------------------
# Train state + step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int32, 0-d
    params: Tree  # trainable weights, fp32
    bn_state: Tree  # BN running stats
    momentum: Tree  # SGD buffers (mirrors params), fp32


def init_train_state(
    model_cfg: resnet.ResNetConfig,
    generator: torch.Generator,
    *,
    device: str | torch.device | None = None,
) -> TrainState:
    """A fresh state: ``resnet.init`` from ``generator``, zero momentum, step
    0, on the card unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    variables = tree_map(lambda t: t.to(dev), resnet.init(model_cfg, generator))
    params, bn_state = resnet.split_params_state(variables)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        params=params,
        bn_state=bn_state,
        momentum=init_momentum(params),
    )


def loss_fn(
    model_cfg: resnet.ResNetConfig,
    params: Tree,
    bn_state: Tree,
    images: torch.Tensor,
    labels: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    policy: DtypePolicy = BF16,
    remat: bool = False,
    bn_group=None,
    model_group=None,
) -> tuple[torch.Tensor, tuple[Tree, torch.Tensor]]:
    """Differentiable loss; aux = (updated BN stats, logits).  ``bn_group``
    syncs every BN over a process group, ``model_group`` splits channels
    over one (``resnet.forward``)."""
    variables = resnet.merge_params_state(params, bn_state)
    logits, new_stats = resnet.forward(
        model_cfg, variables, images, train=True, policy=policy, remat=remat,
        bn_group=bn_group, model_group=model_group,
    )
    # In train mode every BN layer reports its updated running stats, with
    # exactly bn_state's structure, so they replace the old state wholesale.
    new_bn_state = new_stats if new_stats else bn_state
    loss = cross_entropy(logits, labels, label_smoothing=label_smoothing)
    return loss, (new_bn_state, logits)


def train_step(
    model_cfg: resnet.ResNetConfig,
    train_cfg: TrainConfig,
    ts: TrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    lr: float | torch.Tensor,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimization step; returns ``(new_ts, metrics)`` with ``loss``,
    ``accuracy`` and ``grad_norm`` as 0-d tensors on the device.  The step
    makes no host sync.

    Gradients come from ``torch.autograd.grad`` over the parameter leaves.
    As JAX donates the input state, this step updates the parameter and
    momentum tensors in place: ``ts`` must not be reused after the call.
    Forward and backward run under ``exact_fp32``, so that the FP32 policy
    is IEEE fp32 on the card in the backward convolutions too."""
    loss, new_bn_state, logits, keys, grads = _loss_and_grads(
        model_cfg, train_cfg, ts, images, labels)
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "accuracy": (logits.argmax(-1) == labels.long()).float().mean(),
            "grad_norm": _global_norm(grads),
        }
    return _apply_update(train_cfg, ts, keys, grads, new_bn_state, lr, images.device), metrics


def _loss_and_grads(model_cfg, train_cfg, ts, images, labels, bn_group=None,
                    model_group=None):
    """Forward and backward under ``exact_fp32``: (loss, new BN state,
    logits, parameter keys, gradients in the keys' order)."""
    flat = flatten_tree(ts.params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with exact_fp32():
        loss, (new_bn_state, logits) = loss_fn(
            model_cfg, unflatten_tree(leaves), ts.bn_state, images, labels,
            label_smoothing=train_cfg.label_smoothing, policy=train_cfg.policy,
            remat=train_cfg.remat, bn_group=bn_group, model_group=model_group,
        )
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, new_bn_state, logits, list(leaves), grads


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))


def _apply_update(train_cfg, ts, keys, grads, new_bn_state, lr, device) -> TrainState:
    """The SGD step in place (``sgd_update``) and the next state."""
    grad_tree = unflatten_tree(dict(zip(keys, grads)))
    if isinstance(lr, torch.Tensor):
        lr = lr.to(device, torch.float32)
    else:
        lr = torch.full((), lr, dtype=torch.float32, device=device)
    new_params, new_momentum = sgd_update(
        ts.params, grad_tree, ts.momentum,
        lr=lr, momentum=train_cfg.momentum,
        weight_decay=train_cfg.weight_decay, nesterov=train_cfg.nesterov,
    )
    return TrainState(
        step=ts.step + 1, params=new_params, bn_state=new_bn_state, momentum=new_momentum
    )


def state_shardings(model_cfg: resnet.ResNetConfig, mesh) -> tuple[Tree, Tree]:
    """(params, BN state) of ``parallel.mesh.param_shardings``: the
    dimension of each leaf sharded over the model axis, or None.  The
    momentum mirrors the params."""
    from resnetc_tpu_torch.parallel import mesh as pmesh

    whole = unflatten_tree({k: torch.empty(shape, device="meta")  # shapes, no storage
                            for k, shape in resnet.param_shapes(model_cfg).items()})
    return resnet.split_params_state(pmesh.param_shardings(mesh, whole))


def gather_train_state(model_cfg: resnet.ResNetConfig, mesh, ts: TrainState) -> TrainState:
    """The whole state from every model rank's shard (``shard_state``'s
    inverse; ``parallel.mesh.gather_tree``): what one process would hold.
    Every rank of the model group takes part and gets it."""
    from resnetc_tpu_torch.parallel import mesh as pmesh

    p_dims, s_dims = state_shardings(model_cfg, mesh)
    return TrainState(
        step=ts.step,
        params=pmesh.gather_tree(mesh, ts.params, p_dims),
        bn_state=pmesh.gather_tree(mesh, ts.bn_state, s_dims),
        momentum=pmesh.gather_tree(mesh, ts.momentum, p_dims),
    )


def sharded_train_step(
    model_cfg: resnet.ResNetConfig,
    train_cfg: TrainConfig,
    mesh,
    *,
    local_batch: bool = False,
):
    """The train step over ``mesh``'s (data, model) axes; counterpart of the
    JAX ``sharded_train_step`` (``train.py:239``).  Returns ``(step,
    shard_state, batch_slicers)``, as JAX does:

    - ``shard_state(ts)`` takes a whole state, makes every rank's equal to
      the first data rank's of its model index (params, BN state, momentum
      and step, broadcast in place over the data axis) and returns this
      rank's channel shard of it (``parallel.mesh.shard_tree``; the whole
      state under a model axis of 1);
    - ``step(ts, images, labels, lr)`` takes the global batch and computes
      on this rank's data slice of it (with ``local_batch=True``, the
      rank's own slice, as multi-host loading draws it): ``loss_fn`` with
      sync-BN over the data group and channels split over the model group,
      then one all-reduce over the data group of a flat buffer of the
      gradients, the loss and the accuracy, averaged over the data ranks;
      then ``train_step``'s in-place SGD update of the rank's shards.  It
      equals ``train_step`` on the global batch up to summation order (the
      ranks' slices are equal, so the average of their means is the global
      mean).  ``grad_norm`` is the whole model's: the sharded leaves' sums
      of squares summed over the model group, the replicated leaves counted
      once.  Loss and accuracy come from the whole logits, equal on every
      model rank;
    - ``batch_slicers``: (images, labels) -> this rank's data slice.

    Every rank must call the step with the same arguments in the same
    order.  ``gather_train_state`` gives back the whole state."""
    import torch.distributed as dist

    from resnetc_tpu_torch.parallel import mesh as pmesh

    group = pmesh.data_group(mesh)
    world = dist.get_world_size(group)
    split = pmesh.axis_sizes(mesh)[pmesh.MODEL_AXIS] > 1
    model_group = pmesh.model_group(mesh) if split else None
    share = pmesh.replicated(mesh)
    slicers = (pmesh.batch_sharding(mesh), pmesh.label_sharding(mesh))
    # The gradients that are shards: their squares sum over the model group.
    sharded = {k for k, d in flatten_tree(state_shardings(model_cfg, mesh)[0]).items()
               if d is not None}

    def shard_state(ts: TrainState) -> TrainState:
        share([ts.step] + [t for name in ("params", "bn_state", "momentum")
                           for t in flatten_tree(getattr(ts, name)).values()])
        return TrainState(step=ts.step, params=pmesh.shard_tree(mesh, ts.params),
                          bn_state=pmesh.shard_tree(mesh, ts.bn_state),
                          momentum=pmesh.shard_tree(mesh, ts.momentum))

    def grad_norm(keys, grads):
        if not split:
            return _global_norm(grads)
        sq = [g.float().square().sum() for g in grads]
        zero = sq[0].new_zeros(())
        own = sum((q for k, q in zip(keys, sq) if k in sharded), zero)
        dist.all_reduce(own, group=model_group)
        return torch.sqrt(own + sum((q for k, q in zip(keys, sq) if k not in sharded), zero))

    def step(ts, images, labels, lr):
        if not local_batch:
            images, labels = slicers[0](images), slicers[1](labels)
        loss, new_bn_state, logits, keys, grads = _loss_and_grads(
            model_cfg, train_cfg, ts, images, labels, bn_group=group if world > 1 else None,
            model_group=model_group)
        with torch.no_grad():
            accuracy = (logits.argmax(-1) == labels.long()).float().mean()
            buf = torch.cat([g.float().reshape(-1) for g in grads]
                            + [loss.detach().float().reshape(1), accuracy.reshape(1)])
            dist.all_reduce(buf, group=group)
            buf /= world
            parts = buf.split([g.numel() for g in grads] + [1, 1])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            metrics = {"loss": parts[-2][0], "accuracy": parts[-1][0],
                       "grad_norm": grad_norm(keys, grads)}
        return _apply_update(train_cfg, ts, keys, grads, new_bn_state, lr, images.device), metrics

    return step, shard_state, slicers
