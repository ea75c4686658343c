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
included). A model of `sharding.BLOCK_FAMILIES` (every family of the
registry: the dense, MoE, SSM and hybrid decoders and the
encoder-decoder) runs the block program:
the step takes the rank's rows of the batch (`sharding.rows(batch,
microbatches)`: its share of each of the reference's microbatches) and

  1. takes the loss (vocab-parallel, over the global batch) and each
     leaf's gradient block on the blocks (`_block_grads_fn`: a layer's
     weights gathered over data inside it, the gradient psum-scattered
     back, then summed over the block's replicas);
  2. checks that each block is the same on the ranks that hold it
     (`check_replicated(pspecs)`);
  3. runs AdamW on the blocks, donated, its clip on the global norm of
     the blocks (`optimizer.global_norm(pspecs)`).

A family outside `BLOCK_FAMILIES` would keep the global view (no
registered config reaches it any more): the step takes the whole batch
and

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

import contextlib
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import tree
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt


def cross_entropy(logits, labels, *, vocab: int | None = None):
    """Mean cross-entropy in float32. In a block program (`vocab`, the
    global vocabulary, given) the logits are the rank's rows, split over
    `model` by vocab where they have fewer columns: the max and the sum
    of exps are reduced over `model`, the label's logit is taken by the
    rank that holds it and psummed, and the mean covers the global batch
    (the sum psummed over the batch axes)."""
    if vocab is None or not sharding.in_blocks():
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - picked).mean()
    ax = sharding.batch_axes()
    total = _VocabNLL.apply(logits, labels, logits.shape[-1] != vocab).sum()
    n = labels.numel() * sharding.axis_size(ax)
    return (sharding.psum(total, ax) if ax else total) / n


# rows of the logits `_VocabNLL` widens to float32 at a time
_NLL_ROWS = 1024


class _VocabNLL(torch.autograd.Function):
    """The per-token loss, log-sum-exp less the label's logit, of a block
    program's logits (the rank's rows, its vocab columns where `split`
    over `model`), in float32 a chunk of rows at a time; its gradient,
    softmax less the one-hot label, written into one buffer of the
    logits' dtype (the fused arithmetic a compiler gives the reference:
    no whole float32 copy of the logits is kept for the backward)."""

    @staticmethod
    def forward(ctx, logits, labels, split: bool):
        flat = logits.reshape(-1, logits.shape[-1])
        V = flat.shape[1]
        lab = labels.reshape(-1).long()
        if split:
            lab = lab - sharding.axis_index("model") * V
        mine = (lab >= 0) & (lab < V)
        lab = lab.clamp(0, V - 1)
        lse = torch.cat([torch.logsumexp(flat[i:i + _NLL_ROWS].float(), -1)
                         for i in range(0, flat.shape[0], _NLL_ROWS)])
        picked = torch.where(mine, flat.gather(1, lab[:, None])[:, 0].float(),
                             0)
        if split:
            m = sharding.pmax(lse, "model")
            lse = m + sharding.psum(torch.exp(lse - m), "model").log()
            picked = sharding.psum(picked, "model")
        ctx.save_for_backward(logits, lab, mine, lse)
        ctx.split, ctx.mesh = split, sharding.current()
        return (lse - picked).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lab, mine, lse = ctx.saved_tensors
        g = g.reshape(-1).float()
        if ctx.split:
            # every model rank's loss is the one loss: its cotangents sum
            with sharding.use_context(ctx.mesh):
                g = sharding.psum(g, "model")
        flat = logits.reshape(-1, logits.shape[-1])
        out = torch.empty_like(flat)
        for i in range(0, flat.shape[0], _NLL_ROWS):
            j = slice(i, i + _NLL_ROWS)
            p = flat[j].float().sub_(lse[j, None]).exp_().mul_(g[j, None])
            p.scatter_add_(1, lab[j, None], torch.where(
                mine[j], -g[j], 0)[:, None])
            out[j] = p
        return out.reshape(logits.shape), None, None


def make_loss_fn(model, cfg, *, aux_coef: float = 0.01,
                 mtp_coef: float = 0.3):
    def loss_fn(params, batch):
        with sharding.program(cfg):
            return _loss(params, batch)

    def _loss(params, batch):
        logits, extras = model.forward(params, batch["tokens"],
                                       embeddings=batch.get("embeddings"))
        loss = cross_entropy(logits, batch["labels"], vocab=cfg.vocab_size)
        metrics = {"ce": loss}
        if extras.get("moe_aux") is not None and cfg.moe is not None:
            loss = loss + aux_coef * extras["moe_aux"]
            metrics["moe_aux"] = extras["moe_aux"]
        if "mtp_logits" in extras:
            mtp = cross_entropy(extras["mtp_logits"], batch["labels"][:, 1:],
                                vocab=cfg.vocab_size)
            loss = loss + mtp_coef * mtp
            metrics["mtp_ce"] = mtp
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, params, batch, *, seed: float = 1.0):
    """((loss, metrics), grads) of `loss_fn(params, batch)`: the grads a
    tree like `params`, detached; the loss's cotangent `seed`."""
    with torch.enable_grad():
        p = tree.map(lambda a: a.detach().requires_grad_(True), params)
        (loss, metrics) = loss_fn(p, batch)
        leaves = tree.leaves(p)
        got = torch.autograd.grad(loss, leaves, torch.full_like(loss, seed),
                                  allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, got)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def make_grads_fn(model, cfg, *, microbatches: int = 1,
                  batch: int | None = None):
    """Returns grads_fn(params, batch) -> ((loss, metrics), grads): one
    step's loss and gradients, the batch split into `microbatches` along
    its first dimension and their gradients summed in float32, each
    divided by the count (the reference's scan). `batch`, the global
    batch's rows, tells a block program which batch axes split each
    microbatch (`sharding.batch_rows`); None: every one."""
    loss_fn = make_loss_fn(model, cfg)
    if sharding.runs_blocks(cfg):
        return _block_grads_fn(model, loss_fn, microbatches, batch)

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


def _block_grads_fn(model, loss_fn, microbatches: int, rows: int | None):
    """The block program's `grads_fn(param blocks, batch rows)`. The rows
    are this rank's share of each of the reference's microbatches, in
    order (`sharding.rows(batch, microbatches)`: microbatch i is the
    global rows [i B/m, (i + 1) B/m), split over the batch axes as the
    spec resolves on B/m rows, whole on the ranks that cannot split
    it), so chunk i of the rank's rows is its share of microbatch i.
    Each chunk's loss is that microbatch's one loss, the same on every
    rank (the vocab-parallel loss and the MoE aux psum over every batch
    axis, a replicated row counted on each of its ranks in the sum and
    in the count alike); every rank seeds it with 1 / (the mesh's
    ranks), so that each collective's transpose sums the ranks' shares
    into its gradient, and a rank that holds a row another holds too
    seeds its own copy of the same loss: the sum over the ranks is the
    gradient once. The chunks' gradients are summed in float32 over the
    count (the reference's scan); then each leaf's block is summed over
    the ranks that hold the same block (`sharding.reduce_replicas`), a
    psum-scatter over data already done where FSDP gathered it. The
    metrics carry the chunk count run ("chunks"). With `rows` (the
    global batch's) each chunk runs in `sharding.batch_rows(rows /
    microbatches)`: a microbatch whole over some batch axis is known as
    such (`_moe_replicated` gathers no duplicate rows)."""
    ctx = sharding.current()
    pspecs = sharding.param_pspecs(model.param_specs())
    seed = 1.0 / math.prod(sharding.axis_sizes(ctx.mesh).values())

    def grads_fn(params, batch):
        with sharding.use_context(ctx):
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(
                    f"this rank's {b} rows are not {microbatches} equal "
                    "shares of microbatches (`sharding.rows(batch, "
                    "microbatches)` lays them out)")
            chunks, n = microbatches, b // microbatches
            grads, losses, mets = None, [], []
            for i in range(chunks):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                with (sharding.batch_rows(rows // microbatches) if rows
                      else contextlib.nullcontext()):
                    (loss, metrics), g = value_and_grad(loss_fn, params, mb,
                                                        seed=seed)
                if chunks > 1:
                    g = tree.map(lambda a: a.float() / chunks, g)
                    grads = g if grads is None else tree.map(
                        torch.add, grads, g)
                else:
                    grads = g
                losses.append(loss)
                mets.append(metrics)
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
            metrics["chunks"] = chunks
            return ((torch.stack(losses).mean(), metrics),
                    sharding.reduce_replicas(grads, pspecs))

    return grads_fn


def make_train_step(model, cfg, opt_cfg: opt.OptConfig, *,
                    microbatches: int = 1, donate: bool = False,
                    batch: int | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): `make_grads_fn`'s gradients, then the AdamW update. With
    `donate`, the parameters and moments handed in are updated in place
    and handed back."""
    grads_fn = make_grads_fn(model, cfg, microbatches=microbatches,
                             batch=batch)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grads_fn(params, batch)
        params2, opt_state2, om = opt.adamw_update(grads, opt_state, params,
                                                   opt_cfg, donate=donate)
        return params2, opt_state2, dict(metrics, loss=loss, **om)

    return train_step


def jit_train_step(model, cfg, opt_cfg, *, microbatches: int = 1,
                   batch: int | None = None):
    """The train step with the parameters and optimizer state donated:
    on whole trees with no mesh, on a rank's blocks under a DeviceMesh
    (the block program or the global view: the module docstring).
    `batch`: the global batch's rows (`make_grads_fn`)."""
    if not sharding.ranks_in_use():
        return make_train_step(model, cfg, opt_cfg,
                               microbatches=microbatches, donate=True)
    ctx = sharding.current()
    specs = state_specs(model, opt_cfg)
    grads_fn = make_grads_fn(model, cfg, microbatches=microbatches,
                             batch=batch)
    if sharding.runs_blocks(cfg):
        pspecs = sharding.param_pspecs(specs["params"])

        def block_step(params, opt_state, batch):
            with sharding.use_context(ctx):
                (loss, metrics), grads = grads_fn(params, batch)
                check_replicated(grads, pspecs)
                gnorm = opt.global_norm(grads, pspecs)
            params2, opt_state2, om = opt.adamw_update(
                grads, opt_state, params, opt_cfg, donate=True, gnorm=gnorm)
            return params2, opt_state2, dict(metrics, loss=loss, **om)
        return block_step

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


def check_replicated(grads, pspecs=None):
    """Raise unless every leaf of the whole gradient has the same bits on
    every rank of the default process group (its fingerprints' max and
    min over the ranks agree): a wrong transpose gives a rank another
    share of it. With `pspecs` (a block program's param specs) each
    leaf is a rank's block, compared across the ranks that hold the
    same block: the axes its spec does not name, one all-reduce pair
    per set of them. On fake tensors (the dry-run) the all-reduces run
    and nothing is compared."""
    import torch.distributed as dist
    leaves = tree.leaves(grads)
    if not leaves:
        return
    fp = torch.stack([_fingerprint(g) for g in leaves])
    hi, lo = fp.clone(), -fp
    if pspecs is None:
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MAX)
    else:
        axes = [sharding.unnamed_axes(s)
                for s in sharding.leaf_specs(grads, pspecs)]
        for ax in dict.fromkeys(a for a in axes if a):
            idx = torch.tensor([i for i, a in enumerate(axes) if a == ax],
                               device=fp.device)
            both = torch.cat([hi[idx], lo[idx]])
            both = sharding.pmax(both, ax)
            hi[idx], lo[idx] = both[:len(idx)], both[len(idx):]
    if is_fake(hi):
        return          # a dry-run's trace: the collectives issued, no bits
    differ = (hi != -lo).any(-1)
    if bool(differ.any()):
        keys = [k for (k, _), d in zip(tree.flatten_with_keys(grads),
                                       differ.tolist()) if d]
        raise RuntimeError(f"the whole gradient differs across ranks at "
                           f"{keys}")
