"""The pod wire of the port (`core.tx_engine.transmit` /
`transmit_staged`, `KVTransferEngine.make_transfer_step`), on 8 gloo
ranks, held against the JAX package's sharded results.

The ranks run once for the module (`_torch_ranks.run`, job `wire`) on a
(2, 2, 2) (pod, data, model) mesh, as `tests/test_sharded.py::
test_tx_engine_pod_transfer_and_spray` runs the reference: the (2, 8,
16) float32 tensor laid out ("batch", "kv_seq", None) crosses the pod
axis by one permute of shift 1 — directly (each rank's (1, 4, 16)
block), staged (each rank's batch-only (1, 8, 16) block), and through
the int8 codec — and reduced gemma-2b's decode cache tree of batch 2
and length 16 through `make_transfer_step` both ways. The reference's
results come from one subprocess with 8 fake XLA devices.

Values are bit-equal to the reference's; the int8 path is within the
reference test's bound (2 % relative, 2 % of the largest value
absolute) of its exact swap and of the reference's result, and within
one float32 ulp of the latter (XLA's fused codec rounds a product
apart). The permutes' bytes on each rank are counted:
the staged path moves the stripe factor (here 2, the model axis) more."""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks
from repro_torch import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config, reduced
from repro.core import tx_engine
from repro.core.descriptors import TransferPlan
from repro.core.kvtransfer import KVTransferEngine
from repro.launch.mesh import make_mesh
from repro.models.module import Spec
from repro.models.registry import build_model
from repro.parallel import sharding

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
x = jnp.arange(2 * 8 * 16, dtype=jnp.float32).reshape(2, 8, 16)
spec = Spec((2, 8, 16), ("batch", "kv_seq", None))
plan = TransferPlan(axis="pod", shift=1)
plan8 = TransferPlan(axis="pod", shift=1, quantize_bits=8)
out = {"x": x}
model = build_model(reduced(get_config("gemma-2b")))
eng = KVTransferEngine(model, 2, 16, plan)
leaves, tdef = jax.tree.flatten(eng.spec_tree)
keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
caches = jax.tree.unflatten(tdef, [jax.random.normal(k, s.shape)
                                   for k, s in zip(keys, leaves)])
for k, a in jax.tree_util.tree_flatten_with_path(caches)[0]:
    out["cache/" + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in k)] = a
with sharding.use_mesh(mesh):
    x_dev = jax.device_put(x, NamedSharding(mesh, P(("pod",), None, None)))
    for name, fn, pl in (("direct", tx_engine.transmit, plan),
                         ("staged", tx_engine.transmit_staged, plan),
                         ("int8", tx_engine.transmit, plan8)):
        out[name] = jax.jit(lambda t: fn({"k": t}, {"k": spec}, pl))(
            x_dev)["k"]
    for staged in (False, True):
        got = jax.jit(eng.make_transfer_step(staged=staged))(caches)
        for k, a in jax.tree_util.tree_flatten_with_path(got)[0]:
            out[f"step/{int(staged)}/" + "/".join(
                str(getattr(p, "key", getattr(p, "idx", p))) for p in k)] = a
np.savez(sys.argv[1], **{k: np.asarray(a) for k, a in out.items()})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("wire")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    payload = {f"wire/{k}": v for k, v in ref.items()
               if k == "x" or k.startswith("cache/")}
    got = _torch_ranks.run(("wire",), WORLD, d, payload)
    return ref, got


def _swapped(x):
    """The pod axis of size 2 at shift 1 swaps the two pod halves of
    the batch."""
    return np.concatenate([x[1:], x[:1]])


@pytest.mark.parametrize("name", ["direct", "staged", "int8"])
def test_transmit_is_bit_equal_to_the_reference(ranks, name):
    """Every rank's `transmit` / `transmit_staged` result equals the
    reference's bit for bit and is the exact swap; the int8 one is
    within the reference test's bound of the swap and of the reference's
    result, and one float32 ulp of the latter."""
    ref, got = ranks
    exp = _swapped(ref["x"])
    for r, g in enumerate(got):
        if name == "int8":
            for want in (exp, ref[name]):
                np.testing.assert_allclose(g[f"wire/{name}"], want,
                                           rtol=0.02,
                                           atol=0.02 * np.abs(exp).max())
            # the codec is the reference's bit for bit (test_torch_kv.py);
            # XLA's fused jit of it rounds the scale's product apart by
            # one float32 ulp at most
            np.testing.assert_allclose(g[f"wire/{name}"], ref[name],
                                       rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(g[f"wire/{name}"], ref[name],
                                          err_msg=f"rank {r}")
            np.testing.assert_array_equal(g[f"wire/{name}"], exp)


@pytest.mark.parametrize("staged", [0, 1])
def test_make_transfer_step_is_bit_equal_to_the_reference(ranks, staged):
    """`make_transfer_step(staged=)` of a gemma cache tree: every leaf
    equal to the reference's step bit for bit, and to the pod swap of
    the batch."""
    ref, got = ranks
    keys = [k for k in ref if k.startswith(f"step/{staged}/")]
    assert keys
    for r, g in enumerate(got):
        for k in keys:
            np.testing.assert_array_equal(g[f"wire/{k}"], ref[k],
                                          err_msg=f"rank {r} {k}")
            leaf = k.split("/", 2)[2]
            # the cache leaves stack layers first: batch is dim 1
            np.testing.assert_array_equal(
                g[f"wire/{k}"], np.moveaxis(_swapped(np.moveaxis(
                    ref[f"cache/{leaf}"], 1, 0)), 0, 1))


def test_the_staged_wire_moves_more_bytes(ranks):
    """The bytes each rank's permutes moved: the direct path's block is
    striped over model (4 of 8 rows), the staged path replicates every
    non-batch dim first (all 8 rows), so it moves twice the bytes; the
    int8 path moves a quarter of the direct one's payload plus the
    float32 scales."""
    _, got = ranks
    row = 16 * 4                                  # one (.., 16) f32 row
    for g in got:
        direct, staged, int8 = (int(g[f"wire/{n}/bytes"])
                                for n in ("direct", "staged", "int8"))
        assert direct == 4 * row and staged == 8 * row
        assert staged > direct
        assert int8 == 4 * 16 + 4 * 4             # int8 rows + scales


def test_transmit_without_a_pod_axis_is_the_identity():
    """With no mesh, or a mesh without the plan's axis, both paths
    return the tree itself and still count their calls."""
    import torch
    from repro_torch.core import tx_engine
    from repro_torch.core.descriptors import TransferPlan
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.module import Spec
    from repro_torch.obs import metrics
    from repro_torch.parallel import sharding

    reg = metrics.get_registry().scope("tx_engine")
    t = {"k": torch.zeros(2, 8, 16)}
    spec = {"k": Spec((2, 8, 16), ("batch", "kv_seq", None))}
    before = (reg.counter("transmits").value,
              reg.counter("staged_transmits").value)
    for ctx in (None, tmesh.abstract_mesh((2, 4), ("data", "model"))):
        with (sharding.use_mesh(ctx) if ctx is not None
              else contextlib.nullcontext()):
            assert tx_engine.transmit(t, spec, TransferPlan()) is t
            assert tx_engine.transmit_staged(t, spec, TransferPlan()) is t
    assert (reg.counter("transmits").value,
            reg.counter("staged_transmits").value) == (before[0] + 2,
                                                       before[1] + 2)


def test_the_wire_payload_tree_keys_match():
    """The port's and the reference's cache trees flatten to the same
    keys (what the payload above pairs them by)."""
    from repro.configs.base import get_config, reduced
    from repro.models.registry import build_model
    from repro_torch.configs.base import get_config as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.registry import build_model as tbuild
    want = build_model(reduced(get_config("gemma-2b"))).cache_specs(2, 16)
    have = tbuild(treduced(tget("gemma-2b"))).cache_specs(2, 16)
    assert [k for k, _ in tree.flatten_with_keys(have)] == \
        [k for k, _ in tree.flatten_with_keys(want)]
