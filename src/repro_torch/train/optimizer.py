"""AdamW on plain tensors, with spec-derived optimizer state.

The port of the reference's `repro.train.optimizer`: its arithmetic
written out leaf by leaf (float32 moments unless `moment_dtype` says
otherwise, the global-norm clip scale, the bias corrections, `delta +
wd * p` then `p - lr * delta`, the result cast to the parameter's
dtype). `torch.optim.AdamW` is not used: its decoupled decay multiplies
the parameter by (1 - lr * wd) first, which rounds otherwise. The step
count, the learning rate and the clip scale stay 0-d device tensors, so
an update makes no host synchronisation.

`adamw_update(..., donate=True)` writes the new parameters and moments
into the tensors it was given (the analogue of the reference's
`jit(..., donate_argnums=(0, 1))`): each leaf's float32 temporaries live
only while that leaf is updated, so a full-width model's update needs
no second copy of its state. On a mesh the leaves are a rank's blocks,
the moments cut by `opt_state_specs` as the parameters by their specs
(`train_loop.shard_train_state`), and the clip's norm comes in whole
(`global_norm` of the blocks with their specs, in a block program).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch import tree
from repro_torch.models import module as mod
from repro_torch.models.module import torch_dtype
from repro_torch.parallel import sharding


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def opt_state_specs(param_specs, opt_cfg: OptConfig) -> dict:
    """Spec tree for (m, v) with the same logical axes as the params."""
    def moment(s):
        return dataclasses.replace(s, init="zeros", dtype=opt_cfg.moment_dtype)
    return {
        "m": mod.tree_map_specs(moment, param_specs),
        "v": mod.tree_map_specs(moment, param_specs),
        "step": mod.Spec((), (), init="zeros", dtype="int32"),
    }


def init_opt_state(params, opt_cfg: OptConfig):
    """Zero moments on each parameter's device, and a step count of 0."""
    dt = torch_dtype(opt_cfg.moment_dtype)
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else None

    def z(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree.map(z, params), "v": tree.map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(step, opt_cfg: OptConfig):
    """Linear warmup: step (counting from 1 after the first update)
    over `warmup_steps`, then the full rate; float32."""
    warm = torch.clamp(step.float() / max(1, opt_cfg.warmup_steps), max=1.0)
    return opt_cfg.lr * warm


def global_norm(tree_, pspecs=None) -> torch.Tensor:
    """The gradient's global norm. With `pspecs` (a block program's param
    specs) each leaf is a rank's block: its sum of squares is psummed
    over the axes its spec names, once per set of them, so each leaf
    counts once whatever its replicas."""
    leaves = tree.leaves(tree_)
    if pspecs is None:
        return torch.sqrt(sum(x.float().square().sum() for x in leaves))
    groups: dict = {}
    for x, s in zip(leaves, sharding.leaf_specs(tree_, pspecs)):
        named = tuple(a for a in sharding.axis_sizes(sharding.current().mesh)
                      if a not in sharding.unnamed_axes(s))
        groups.setdefault(named, []).append(x.float().square().sum())
    sq = 0
    for named, parts in groups.items():
        part = torch.stack(parts).sum()
        sq = sq + (sharding.psum(part, named) if named else part)
    return torch.sqrt(sq)


def adamw_update(grads, opt_state, params, opt_cfg: OptConfig, *,
                 donate: bool = False, gnorm=None):
    """Returns (new_params, new_opt_state, metrics). With `donate`, the
    new parameters and moments are written into `params` and
    `opt_state`'s tensors, which come back as the result. `gnorm`: the
    clip's global norm, taken on the whole gradient where `grads` are a
    rank's blocks of it (the sharded step: a sum of block norms would
    count a replicated leaf once per replica); by default
    `global_norm(grads)`."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if opt_cfg.grad_clip else 1.0)
    lr = _schedule(step, opt_cfg)
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    mdt = torch_dtype(opt_cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + g * (1 - b1)
        v32 = v.float() * b2 + g.square() * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + opt_cfg.eps)
        if opt_cfg.weight_decay:
            delta = delta + opt_cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        if donate:
            p.copy_(new_p)
            m.copy_(m32)
            v.copy_(v32)
            return p, m, v
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    with torch.no_grad():
        out = [upd(p, g, m, v) for p, g, m, v in
               zip(tree.leaves(params), tree.leaves(grads),
                   tree.leaves(opt_state["m"]), tree.leaves(opt_state["v"]))]
    new_params = tree.unflatten(params, [o[0] for o in out])
    new_state = {"m": tree.unflatten(params, [o[1] for o in out]),
                 "v": tree.unflatten(params, [o[2] for o in out]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
