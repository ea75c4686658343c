"""Train step assembly: loss, gradient accumulation (microbatching), AdamW.

The port of the reference's `repro.train.train_loop`. The loss and its
gradients: `model.forward` on parameters that require grad (the flash
kernel's forward on the card; its backward the plain recompute), the
gradients by `torch.autograd.grad` over the parameter leaves, a leaf no
path reaches getting zeros (the reference's `jax.value_and_grad`). With
`microbatches` > 1 the batch splits along its first dimension and the
microbatches' gradients are summed in float32, each divided by the
count, as the reference's scan sums them.

`jit_train_step` returns the step, donating the parameters and
optimizer state (updated in place, as the reference's `jit(...,
donate_argnums=(0, 1))` reuses their buffers). Under a `DeviceMesh`
(`sharding.use_mesh` around the call) it is the sharded step, the
reference's `jit(in_shardings=, out_shardings=)` from `param_shardings`:
between steps each rank holds its block of every parameter and moment
under its param spec (`shard_train_state`; FSDP's embed -> data
included), and a step

  1. gathers the whole parameters, with no graph;
  2. takes the loss and gradients in the global view (every sharded
     branch carries gradients: `sharding.shard_map`), the loss whole and
     equal on every rank;
  3. checks that the whole gradient is the same on every rank
     (`check_replicated`);
  4. cuts the gradient to blocks and runs AdamW on the blocks, donated,
     its clip on the whole gradient's norm.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import tree
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt


def cross_entropy(logits, labels):
    """Mean cross-entropy in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def make_loss_fn(model, cfg, *, aux_coef: float = 0.01,
                 mtp_coef: float = 0.3):
    def loss_fn(params, batch):
        logits, extras = model.forward(params, batch["tokens"],
                                       embeddings=batch.get("embeddings"))
        loss = cross_entropy(logits, batch["labels"])
        metrics = {"ce": loss}
        if extras.get("moe_aux") is not None and cfg.moe is not None:
            loss = loss + aux_coef * extras["moe_aux"]
            metrics["moe_aux"] = extras["moe_aux"]
        if "mtp_logits" in extras:
            mtp = cross_entropy(extras["mtp_logits"], batch["labels"][:, 1:])
            loss = loss + mtp_coef * mtp
            metrics["mtp_ce"] = mtp
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of `loss_fn(params, batch)`: the grads a
    tree like `params`, detached."""
    with torch.enable_grad():
        p = tree.map(lambda a: a.detach().requires_grad_(True), params)
        (loss, metrics) = loss_fn(p, batch)
        leaves = tree.leaves(p)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, got)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def make_grads_fn(model, cfg, *, microbatches: int = 1):
    """Returns grads_fn(params, batch) -> ((loss, metrics), grads): one
    step's loss and gradients, the batch split into `microbatches` along
    its first dimension and their gradients summed in float32, each
    divided by the count (the reference's scan)."""
    loss_fn = make_loss_fn(model, cfg)

    def grads_fn(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        n = B // microbatches
        grads = tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        losses, mets = [], []
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            (loss, metrics), g = value_and_grad(loss_fn, params, mb)
            grads = tree.map(lambda a, b: a + b.float() / microbatches,
                             grads, g)
            losses.append(loss)
            mets.append(metrics)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return (torch.stack(losses).mean(), metrics), grads

    return grads_fn


def make_train_step(model, cfg, opt_cfg: opt.OptConfig, *,
                    microbatches: int = 1, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): `make_grads_fn`'s gradients, then the AdamW update. With
    `donate`, the parameters and moments handed in are updated in place
    and handed back."""
    grads_fn = make_grads_fn(model, cfg, microbatches=microbatches)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grads_fn(params, batch)
        params2, opt_state2, om = opt.adamw_update(grads, opt_state, params,
                                                   opt_cfg, donate=donate)
        return params2, opt_state2, dict(metrics, loss=loss, **om)

    return train_step


def jit_train_step(model, cfg, opt_cfg, *, microbatches: int = 1):
    """The train step with the parameters and optimizer state donated:
    on whole trees with no mesh, on a rank's blocks under a DeviceMesh
    (the module docstring)."""
    if not sharding.ranks_in_use():
        return make_train_step(model, cfg, opt_cfg,
                               microbatches=microbatches, donate=True)
    ctx = sharding.current()
    specs = state_specs(model, opt_cfg)
    grads_fn = make_grads_fn(model, cfg, microbatches=microbatches)

    def train_step(params, opt_state, batch):
        with sharding.use_context(ctx):
            whole = sharding.unshard_tree(params, specs["params"])
            (loss, metrics), grads = grads_fn(whole, batch)
            del whole
            check_replicated(grads)
            gnorm = opt.global_norm(grads)
            grads = sharding.shard_tree(grads, specs["params"])
        params2, opt_state2, om = opt.adamw_update(
            grads, opt_state, params, opt_cfg, donate=True, gnorm=gnorm)
        return params2, opt_state2, dict(metrics, loss=loss, **om)

    return train_step


def state_specs(model, opt_cfg) -> dict:
    """{"params", "opt"}: the spec trees of the parameters and of the
    optimizer state (`opt_state_specs`)."""
    pspecs = model.param_specs()
    return {"params": pspecs, "opt": opt.opt_state_specs(pspecs, opt_cfg)}


def shard_train_state(model, opt_cfg, params, opt_state):
    """(parameter blocks, optimizer-state blocks): this rank's block of
    each whole leaf under the active mesh's param specs."""
    specs = state_specs(model, opt_cfg)
    return (sharding.shard_tree(params, specs["params"]),
            sharding.shard_tree(opt_state, specs["opt"]))


def unshard_train_state(model, opt_cfg, params, opt_state):
    """The whole trees of a rank's blocks (all-gathers; every rank)."""
    specs = state_specs(model, opt_cfg)
    return (sharding.unshard_tree(params, specs["params"]),
            sharding.unshard_tree(opt_state, specs["opt"]))


# elements of a leaf that `_fingerprint` widens to int64 at a time: its
# scratch stays at a few 128 MiB buffers whatever the leaf's size
_FP_CHUNK = 1 << 24


def _fingerprint(t) -> torch.Tensor:
    """Two int64 sums of a tensor's bit patterns, the second weighted by
    position: equal for bit-equal tensors."""
    t = t.detach().contiguous().reshape(-1)
    bits = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for i in range(0, bits.numel(), _FP_CHUNK):
        b = bits[i:i + _FP_CHUNK].long()
        w = torch.arange(i, i + b.numel(), device=t.device) % 65521 + 1
        out += torch.stack([b.sum(), (b * w).sum()])
    return out


def check_replicated(grads):
    """Raise unless every leaf of the whole gradient has the same bits on
    every rank of the default process group (its fingerprints' max and
    min over the ranks agree): a wrong transpose gives a rank another
    share of it. On fake tensors (the dry-run) the all-reduces run and
    nothing is compared."""
    import torch.distributed as dist
    leaves = tree.leaves(grads)
    if not leaves:
        return
    fp = torch.stack([_fingerprint(g) for g in leaves])
    hi, lo = fp.clone(), -fp
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX)
    if is_fake(hi):
        return          # a dry-run's trace: the collectives issued, no bits
    differ = (hi != -lo).any(-1)
    if bool(differ.any()):
        keys = [k for (k, _), d in zip(tree.flatten_with_keys(grads),
                                       differ.tolist()) if d]
        raise RuntimeError(f"the whole gradient differs across ranks at "
                           f"{keys}")
