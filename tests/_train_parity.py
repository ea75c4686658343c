"""Shared helpers of the training parity tests (`test_torch_train.py`,
`test_torch_encdec.py`): one reduced model in both packages on the
reference's parameters, and a train step's loss and gradients held
against `jax.value_and_grad` of the reference's loss.

Gradient tolerance: every leaf within 1e-4 of its largest |grad|, on the
`conditioned` copy of the reference's parameters (`chip_smoke.
conditioned`: queries and keys at a fan-in of d_model, embedding tables
at 1/sqrt(d_model)), the same copy in both packages. The spec's init
saturates a random model's softmaxes (reduced whisper-base's loss is
20-45), where one float32 ulp of the parameters moves the gradients by
~1e-3 of scale and two correct float32 programs cannot agree to 1e-4.
On the copy `grad_errors` reads 1.2e-6 to 2.4e-5 for the seven reduced
models. The control: a gradient that lost precision (`bf16_logit_grads`,
the logits' gradient rounded to bf16) reads 1.1e-3 (gemma-2b) and
2.8e-3 (whisper-base), and misses the bound; a wrong or missing term
moves a leaf by O(1) of its scale."""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild
from repro.train import data as jdata
from repro.train.train_loop import make_loss_fn as jloss
from repro_torch import tree
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train import train_loop as tloop

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import conditioned  # noqa: E402

GRAD_REL = 1e-4
LOSS_REL = 1e-5


@functools.lru_cache(maxsize=None)
def pair(arch: str, seed: int = 0):
    """(reference model, its params, port model, the same params)."""
    jm = jbuild(jreduced(jget_config(arch)))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = build_model(reduced(get_config(arch)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", model=tm)
    return jm, jp, tm, tp


def batch(cfg, step: int = 0, B: int = 2, S: int = 16) -> dict:
    """The reference's synthetic batch as numpy, with seeded frontend
    embeddings where the config has a frontend."""
    b = jax.tree.map(np.asarray, jdata.synthetic_batch(step, B, S,
                                                       cfg.vocab_size))
    if cfg.frontend.kind != "none":
        b["embeddings"] = np.random.default_rng(step).standard_normal(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_input)).astype(
                np.float32)
    return b


class _Bf16Grad(torch.autograd.Function):
    """The identity, its gradient rounded to bf16: a planted fault."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_logit_grads(tm):
    """The loss of a model with no aux or MTP term (gemma-2b, whisper-
    base), its logits' gradient rounded to bf16 on its way back and the
    loss itself unchanged: a precision fault in a backward."""
    def loss_fn(params, batch):
        logits, _ = tm.forward(params, batch["tokens"],
                               embeddings=batch.get("embeddings"))
        loss = tloop.cross_entropy(_Bf16Grad.apply(logits), batch["labels"])
        return loss, {"ce": loss}
    return loss_fn


def conditioned_pair(arch: str):
    """`pair(arch)` with both trees replaced by their conditioned copy."""
    jm, jp, tm, tp = pair(arch)
    cp = conditioned(tp, tm.cfg)
    jcp = jax.tree.unflatten(jax.tree.structure(jp),
                             [jnp.asarray(a.numpy()) for a in tree.leaves(cp)])
    return jm, jcp, tm, cp


def grad_errors(arch: str, make_loss=None) -> dict:
    """One train step on the conditioned copy and the reference's batch:
    the loss and metrics of the port and of `jax.value_and_grad` of the
    reference's loss, and each gradient leaf's largest difference over
    the reference leaf's largest |grad|. `make_loss(model)` makes the
    port's loss (`tloop.make_loss_fn` by default)."""
    jm, jp, tm, tp = conditioned_pair(arch)
    nb = batch(tm.cfg)
    jb = jax.tree.map(jnp.asarray, nb)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        jloss(jm, jm.cfg), has_aux=True))(jp, jb)
    tb = tree_from_numpy(nb, "cpu")
    loss_fn = (make_loss or (lambda m: tloop.make_loss_fn(m, m.cfg)))(tm)
    (tl, tmet), tg = tloop.value_and_grad(loss_fn, tp, tb)
    worst = {}
    jleaves = jax.tree.leaves(jg)
    tleaves = tree.flatten_with_keys(tg)
    assert len(jleaves) == len(tleaves)
    for (key, g), j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert g.shape == j.shape and g.dtype == torch.float32, key
        worst[key] = float(np.abs(g.numpy() - j).max()
                           / max(np.abs(j).max(), 1e-30))
    return dict(loss=(float(tl), float(jl)),
                metrics={k: (float(tmet[k]), float(jmet[k])) for k in jmet},
                port_metrics=sorted(tmet), worst=worst)


def hold_loss_and_grads(arch: str) -> dict:
    """One train step's loss and metrics and every gradient leaf of the
    port against `jax.value_and_grad` of the reference's loss, on the
    conditioned copy of the reference's parameters and its batch: the
    loss at LOSS_REL, each leaf at GRAD_REL of its scale. Returns the
    worst leaf."""
    got = grad_errors(arch)
    assert got["port_metrics"] == sorted(got["metrics"])
    for t, j in [got["loss"], *got["metrics"].values()]:
        np.testing.assert_allclose(t, j, rtol=LOSS_REL)
    worst = got["worst"]
    assert max(worst.values()) <= GRAD_REL, worst
    return dict(worst=max(worst.values()))
