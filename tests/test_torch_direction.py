"""Phase 11's one-step direction check (`chip_smoke.learning_check` with
one step, `DIRECTION_SEEDS`) on the CPU: reduced gemma-2b in float32 on
the `conditioned` copy of the reference's parameters, one AdamW step at
LR and one at -LR (no warm-up) in both packages on the same batch. The
gap between the two held-out losses over the starting loss is the
check's reading. Both packages read a positive gap (one step moves the
loss down its gradient), the port's within GAP_REL of the reference's.

The rate: the reduced model has ~10^5 parameters where the card's has
2.5 B, so the CLI's 3e-4 moves its loss by ~4e-6 of itself, at the
float32 rounding of the loss (the two packages then differ by 8 % of
the gap); 1e-2 reads a 3.7 % gap. The tolerance: the first AdamW step
moves each weight by about its rate times the sign of its gradient, so
an element whose gradient lies within float32 noise of zero steps in
opposite directions in the two packages. That moves the gap by 3.4e-4
of itself at 1e-2 (7.4e-4 at 3e-2), where the losses themselves agree
to 1e-5; GAP_REL = 1e-3 holds it, and a wrong sign or a lost gradient
misses by the whole gap."""
import jax
import jax.numpy as jnp
import torch

import _train_parity as tp_
from repro.train import optimizer as joptim
from repro.train.train_loop import make_train_step as jstep
from repro_torch import tree
from repro_torch.convert import tree_from_numpy
from repro_torch.train import optimizer as toptim

GAP_REL = 1e-3
LR = 1e-2


def test_one_step_gap_equals_the_reference_s():
    jm, jp, tm, tpar = tp_.conditioned_pair("gemma-2b")
    held = tp_.batch(tm.cfg, 1000, 4, 16)
    jheld = jax.tree.map(jnp.asarray, held)
    theld = tree_from_numpy(held, "cpu")
    jloss_fn = tp_.jloss(jm, jm.cfg)
    tloss_fn = tp_.tloop.make_loss_fn(tm, tm.cfg)
    b = tp_.batch(tm.cfg, 0, 4, 16)
    after = {}
    for lr in (LR, -LR):
        jc = joptim.OptConfig(lr=lr, warmup_steps=1)
        tc = toptim.OptConfig(lr=lr, warmup_steps=1)
        p, _, _ = jax.jit(jstep(jm, jm.cfg, jc))(
            jp, joptim.init_opt_state(jp, jc), jax.tree.map(jnp.asarray, b))
        q = tree.map(lambda a: a.clone(), tpar)
        q, _, _ = tp_.tloop.jit_train_step(tm, tm.cfg, tc)(
            q, toptim.init_opt_state(q, tc), tree_from_numpy(b, "cpu"))
        with torch.no_grad():
            after[lr] = (float(jloss_fn(p, jheld)[0]),
                         float(tloss_fn(q, theld)[0]))
    with torch.no_grad():
        before = (float(jloss_fn(jp, jheld)[0]),
                  float(tloss_fn(tpar, theld)[0]))
    gaps = [(after[-LR][i] - after[LR][i]) / abs(before[i]) for i in (0, 1)]
    print("one-step gap (reference, port):", gaps)
    assert gaps[0] > 0 and gaps[1] > 0
    assert abs(gaps[1] - gaps[0]) <= GAP_REL * abs(gaps[0])
