"""Expert parallelism of the port (`models.moe._moe_a2a` and
`_moe_replicated`), on 8 gloo ranks, held against the JAX package's
sharded results.

The ranks run once for the module (`_torch_ranks.run`, job
`expert_parallel`): reduced granite-moe-1b-a400m's MoE layer (4 experts,
top 2) on the reference's float32 parameters and a (4, 8) batch of
seeded hidden states, as `tests/test_sharded.py`'s MoE tests run it —
`_moe_a2a` and `_moe_replicated` on a (2, 4) (data, model) mesh with
`fsdp=False` at a capacity factor of 8 (nothing dropped), `_moe_a2a`
with FSDP weights, and EP over (model, data) on (2, 2), both ways — and
on a (4, 32) batch at capacity factors that drop (0.5 and 0.75), with
each rank's drops. The reference's sharded outputs (and
its local oracle) come from one subprocess with 8 fake XLA devices, the
drops from the reference's `_capacity` and `_dispatch_indices` on each
rank's block of its routing.

Tolerances are the reference test's: 2e-4 absolute, 2e-3 relative; the
drops exact. Every rank returns the same global result."""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-4, 2e-3
WORLD = 8
DROP_CFS = (0.5, 0.75)

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
import repro.perf as perf
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.models.module import init_params
from repro.parallel import sharding

cfg = reduced(get_config("granite-moe-1b-a400m"))
params = init_params(moe.moe_spec(cfg), jax.random.PRNGKey(0), "float32")
x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
xd = 0.5 * jax.random.normal(jax.random.PRNGKey(2), (4, 32, cfg.d_model))
out = {"x": x, "x_drop": xd, "local": moe.moe_apply(params, x, cfg)[0]}
for k, a in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(p.key) for p in k)] = a


def run(p, x):
    # a fresh jit each call: the flags are read while tracing
    return jax.jit(lambda p, x: moe.moe_apply(p, x, cfg)[0])(p, x)


mesh = make_mesh((2, 4), ("data", "model"))
for name, impl, fsdp in (("a2a", "a2a", False), ("rep", "replicated", False),
                         ("fsdp", "a2a", True)):
    perf.set_flags(capacity_factor=8.0, moe_impl=impl)
    with sharding.use_mesh(mesh, fsdp=fsdp):
        if fsdp:
            sh = sharding.param_shardings(moe.moe_spec(cfg))
            p = jax.tree.map(lambda a, s: jax.device_put(a, s)
                             if s is not None else a, params, sh)
        else:
            p = params
        out[name] = run(p, x)
    perf.reset_flags()
_, idx, _ = moe.route(params, xd, cfg)
idx = np.asarray(idx)
E = cfg.moe.n_experts
for cfv in [float(c) for c in sys.argv[2].split(",")]:
    for impl in ("a2a", "replicated"):
        perf.set_flags(moe_impl=impl, capacity_factor=cfv)
        with sharding.use_mesh(mesh, fsdp=False):
            out[f"drop/{cfv}/{impl}"] = run(params, xd)
            drops = []
            # each rank's block, ranks in (data, model) order
            for d in range(2):
                for m in range(4):
                    blk = idx[2 * d:2 * d + 2]
                    if impl == "a2a":
                        blk = blk[:, 8 * m:8 * m + 8].reshape(-1)
                        C = moe._capacity(blk.size // cfg.moe.top_k, cfg)
                        _, keep = moe._dispatch_indices(jnp.asarray(blk),
                                                        None, E, C)
                        drops.append(int((~np.asarray(keep)).sum()))
                    else:
                        blk = blk.reshape(-1)
                        C = moe._capacity(blk.size // cfg.moe.top_k, cfg)
                        loc = blk == m
                        _, keep = moe._dispatch_indices(
                            jnp.asarray(np.where(loc, 0, 1)), None, 2, C)
                        drops.append(int((~np.asarray(keep) & loc).sum()))
            out[f"drop/{cfv}/{impl}/drops"] = np.asarray(drops)
        perf.reset_flags()
mesh = make_mesh((2, 2), ("data", "model"))
for impl in ("a2a", "replicated"):
    perf.set_flags(capacity_factor=8.0, ep_over_data=True, moe_impl=impl)
    with sharding.use_mesh(mesh, fsdp=False):
        out[f"epd/{impl}"] = run(params, x)
    perf.reset_flags()
np.savez(sys.argv[1], **{k: np.asarray(a) for k, a in out.items()})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's results, each of the 8 ranks' results)."""
    d = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz"),
                        ",".join(map(str, DROP_CFS))],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    payload = {f"ep/{k}": v for k, v in ref.items()
               if k.startswith("param/") or k in ("x", "x_drop")}
    payload["ep/drop_cfs"] = np.asarray(DROP_CFS)
    got = _torch_ranks.run(("expert_parallel",), WORLD, d, payload)
    return ref, got


def _same_on_every_rank(got, key):
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g[key], got[0][key], err_msg=str(r))


@pytest.mark.parametrize("name", ["a2a", "rep", "fsdp"])
def test_moe_on_a_data_model_mesh_matches_the_reference(ranks, name):
    """`_moe_a2a` (`fsdp=False` and with FSDP weights, gathered over
    data inside) and `_moe_replicated` on (2, 4), nothing dropped:
    within 2e-4 / 2e-3 of the reference's sharded output and of its
    local oracle."""
    ref, got = ranks
    for r, g in enumerate(got):
        # a2a, rep, fsdp, then 2 x 2 drop runs, then 2 EP-over-data runs
        assert list(g["ep/counts"]) == [5, 4], r
        for want in (ref[name], ref["local"]):
            np.testing.assert_allclose(g[f"ep/{name}"], want, atol=ATOL,
                                       rtol=RTOL, err_msg=f"rank {r}")
    _same_on_every_rank(got, f"ep/{name}")


@pytest.mark.parametrize("impl", ["a2a", "replicated"])
def test_moe_with_experts_over_model_and_data_matches_the_reference(
        ranks, impl):
    """EP over (model, data) on (2, 2): one expert a rank, the all_to_all
    (or the staged psum, with its gather over data and the slice back)
    over a line ordered model-major, as JAX orders it."""
    ref, got = ranks
    for r, g in enumerate(got):
        np.testing.assert_allclose(g[f"ep/epd/{impl}"], ref[f"epd/{impl}"],
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(g[f"ep/epd/{impl}"], ref["local"],
                                   atol=ATOL, rtol=RTOL)
    _same_on_every_rank(got, f"ep/epd/{impl}")


@pytest.mark.parametrize("cf", DROP_CFS)
@pytest.mark.parametrize("impl", ["a2a", "replicated"])
def test_moe_at_a_dropping_capacity_matches_the_reference(ranks, impl, cf):
    """At a capacity factor that drops assignments, each rank's drops
    equal the reference's count on its block, and the output equals the
    reference's sharded output (the dropped assignments contribute
    zero) within 2e-4 / 2e-3."""
    ref, got = ranks
    key = f"drop/{cf}/{impl}"
    want_drops = ref[f"{key}/drops"]
    assert want_drops.sum() > 0, "the case must drop"
    for r, g in enumerate(got):
        # one dispatch per rank for each call: its own count
        assert list(g[f"ep/{key}/drops"]) == [want_drops[r]], r
        np.testing.assert_allclose(g[f"ep/{key}"], ref[key], atol=ATOL,
                                   rtol=RTOL, err_msg=f"rank {r}")
    _same_on_every_rank(got, f"ep/{key}")
