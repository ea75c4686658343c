"""Gradients through the port's flash attention, held against `jax.grad`
of the reference's `chunked_attention`, on the CPU.

`repro_torch.models.attention.chunked_attention` hands its operands to
`kernels.flash_attention.ops.attention`; where an operand requires grad
that call is an autograd Function whose backward differentiates the
plain version, recomputed on the operands' device (on the card the
forward is the kernel). The reference's `chunked_attention` is plain
JAX, differentiated by XLA. Both get the same seeded numpy operands and
the same output cotangent; the loss is sum(out * w).

Tolerance: 1e-5 of the gradient's largest magnitude, in float32. The two
sides differentiate the same function in another order of operations
(XLA through an online-softmax scan over key chunks, torch through one
softmax over the whole row), so they agree to float32 rounding, which
the sizes below keep under 1e-6 of scale; 1e-5 leaves room and still
catches a dropped term (a missing softcap or mask derivative moves the
gradient by its own scale)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jattention
from repro_torch import device as tdevice
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.attention import chunked_attention as tattention

GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


# (B, S, KVH, G, D, kwargs): causal, window, softcap, GQA (KVH < H), a
# non-causal case, and q_chunk / kv_chunk that cut the reference's scan
CASES = {
    "causal": (2, 32, 2, 1, 16, dict(causal=True)),
    "window": (1, 48, 1, 2, 16, dict(causal=True, window=12)),
    "softcap": (1, 32, 2, 1, 16, dict(causal=True, cap=5.0)),
    "gqa": (2, 32, 1, 4, 8, dict(causal=True)),
    "gqa_window_softcap": (1, 64, 2, 2, 16, dict(causal=True, window=20,
                                                 cap=3.0, q_chunk=16,
                                                 kv_chunk=16)),
    "not_causal": (1, 24, 1, 2, 16, dict(causal=False, sm_scale=0.3)),
}


def _operands(B, S, KVH, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    w = rng.standard_normal((B, S, KVH, G, D)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad_of_the_reference(case):
    B, S, KVH, G, D, kw = CASES[case]
    q, k, v, w = _operands(B, S, KVH, G, D, seed=len(case))

    def jloss(q, k, v):
        return jnp.sum(jattention(q, k, v, **kw) * w)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v))
    out = tattention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f"d{name} ({case})")


def test_only_the_operands_that_require_grad_get_one():
    q, k, v, w = _operands(1, 16, 1, 2, 8, seed=3)
    tq = torch.from_numpy(q).requires_grad_(True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = tattention(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    assert tq.grad is not None and tk.grad is None and tv.grad is None

    def jloss(q):
        return jnp.sum(jattention(q, jnp.asarray(k), jnp.asarray(v)) * w)
    j = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    np.testing.assert_allclose(tq.grad.numpy(), j, rtol=0,
                               atol=GRAD_RTOL * np.abs(j).max())


def test_no_grad_makes_no_autograd_record_and_the_same_values():
    q, k, v, _ = _operands(1, 16, 2, 2, 8, seed=5)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    with torch.no_grad():
        plain = tattention(tq, tk, tv)
    assert plain.grad_fn is None and not plain.requires_grad
    graded = tattention(tq, tk, tv)
    assert graded.grad_fn is not None
    assert torch.equal(graded.detach(), plain)
    # operands that require no grad make no record either
    free = tattention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert free.grad_fn is None and torch.equal(free, plain)


def test_the_backward_recompute_counts_no_kernel_launch():
    """On the CPU nothing launches; the backward's plain recompute adds
    no count on any device (it is not a kernel)."""
    q, k, v, w = _operands(1, 16, 1, 1, 8, seed=7)
    _build.reset_launches()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (tattention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    assert _build.LAUNCHES == {}


def test_kernel_layout_gradients_match_the_plain_versions_autograd():
    """`ops.attention` in the kernel's (B, H, S, D) layout, through a
    strided view as `chunked_attention` hands it: the Function's
    gradients equal plain autograd of `ref.reference`."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 8)).astype(
        np.float32)).transpose(1, 2)
    k = torch.from_numpy(rng.standard_normal((1, 5, 2, 8)).astype(
        np.float32)).transpose(1, 2)
    v = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(
        np.float32))
    kw = dict(causal=True, window=3, cap=2.0)
    a = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.attention(*a, **kw).backward(g)
    fa_ops.reference(*b, **kw).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
