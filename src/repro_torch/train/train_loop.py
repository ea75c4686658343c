"""Train step assembly: loss, gradient accumulation (microbatching), AdamW.

The port of the reference's `repro.train.train_loop`. The loss and its
gradients: `model.forward` on parameters that require grad (the flash
kernel's forward on the card; its backward the plain recompute), the
gradients by `torch.autograd.grad` over the parameter leaves, a leaf no
path reaches getting zeros (the reference's `jax.value_and_grad`). With
`microbatches` > 1 the batch splits along its first dimension and the
microbatches' gradients are summed in float32, each divided by the
count, as the reference's scan sums them.

One process has no mesh: `jit_train_step` returns the step, donating
the parameters and optimizer state (updated in place, as the
reference's `jit(..., donate_argnums=(0, 1))` reuses their buffers);
the sharded step comes with training on a mesh (ROADMAP slice 8e).
"""
from __future__ import annotations

import torch

from repro_torch import tree
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
    """The train step with the parameters and optimizer state donated
    (one process: no mesh, no shardings)."""
    return make_train_step(model, cfg, opt_cfg, microbatches=microbatches,
                           donate=True)
