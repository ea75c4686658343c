"""The port's mesh and sharding rules (`launch.mesh`, `parallel.sharding`)
and its int8 reduction (`parallel.compress`), held against the JAX
package on the CPU.

The rules are pure logic: `resolve_spec` is compared with the
reference's for every parameter leaf of every config on both production
meshes, with and without FSDP and expert parallelism over the data axis,
on axes and sizes alone (the port's `abstract_mesh`, the reference's
`jax.sharding.AbstractMesh`); a subprocess builds the real (2, 16, 16)
`DeviceMesh` with torch's `fake` process-group backend (its 512-rank
world is process-global). What needs ranks runs once for the module on
8 gloo ranks (`_torch_ranks.run`): the local shapes DTensor gives each
rank under `param_shardings`, and `compressed_psum_mean`. The
reference's sharded results come from one subprocess with 8 fake XLA
devices, as `tests/test_sharded.py` runs them. Tolerances:
`compressed_psum_mean` within 1e-6 of the mean's scale (the two sum the
same int8-dequantized terms in another order: float32 rounding, which
could move a requantized value by one step of 1/127 of its chunk's
largest magnitude; the inputs here move none); shapes exact."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_ranks
from repro import perf
from repro.configs.base import get_config as jget_config
from repro.models.module import is_spec as jis_spec
from repro.models.registry import build_model as jbuild
from repro.parallel import compress as jcompress
from repro.parallel import sharding as jsharding
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.module import is_spec
from repro_torch.models.registry import build_model
from repro_torch.parallel import compress as tcompress
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma-2b", "phi4-mini-3.8b", "codeqwen1.5-7b", "stablelm-12b",
         "internvl2-2b", "granite-moe-1b-a400m", "recurrentgemma-2b",
         "mamba2-780m", "deepseek-v3-671b", "whisper-base")
# activation axes the models constrain by (`transformer.py`, `moe.py`)
ACTS = [(("batch", "seq", "embed"), (256, 4096, 2048)),
        (("batch", "kv_seq", None, None), (128, 32768, 1, 256)),
        (("batch", "seq", "vocab"), (32, 4096, 256000)),
        (("batch", "seq", "kv_heads", None, None), (16, 4096, 8, 3, 128)),
        (("batch", "seq", "heads", None), (2, 4096, 24, 128)),
        (("batch", "window", "kv_heads", "head_dim"), (7, 2048, 1, 256)),
        (("expert", "batch", "mlp"), (256, 64, 2048))]


def _reference_specs(arch, multi_pod, fsdp, ep):
    shape, axes = tmesh.production_shape(multi_pod=multi_pod)
    specs = jax.tree.leaves(jbuild(jget_config(arch)).param_specs(),
                            is_leaf=jis_spec)
    perf.set_flags(ep_over_data=ep)
    try:
        with jsharding.use_mesh(AbstractMesh(shape, axes), fsdp=fsdp):
            params = [tuple(jsharding.resolve_spec(s.axes, s.shape))
                      for s in specs]
            acts = [tuple(jsharding.resolve_spec(a, s, "act"))
                    for a, s in ACTS]
            prefix = [jsharding.batch_axes_prefix(n) for n in (1, 2, 32, 512)]
    finally:
        perf.reset_flags()
    return params, acts, prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_equals_the_reference_on_the_production_meshes(arch):
    """Every parameter leaf of `arch` at full size, and the activation
    layouts, on the (16, 16) and (2, 16, 16) meshes, FSDP on and off,
    experts over (model) and over (model, data): the same spec, entry for
    entry, and the same batch axes."""
    specs = tree.leaves(build_model(get_config(arch)).param_specs(),
                        is_leaf=is_spec)
    for multi_pod in (False, True):
        mesh = tmesh.abstract_mesh(*tmesh.production_shape(
            multi_pod=multi_pod))
        for fsdp in (True, False):
            for ep in (False, True):
                want = _reference_specs(arch, multi_pod, fsdp, ep)
                with sharding.use_mesh(mesh, fsdp=fsdp, ep_over_data=ep):
                    got = ([tuple(sharding.resolve_spec(s.axes, s.shape))
                            for s in specs],
                           [tuple(sharding.resolve_spec(a, s, "act"))
                            for a, s in ACTS],
                           [sharding.batch_axes_prefix(n)
                            for n in (1, 2, 32, 512)])
                assert got == want, (arch, multi_pod, fsdp, ep)


def test_rules_and_context_without_a_mesh_and_the_fallbacks():
    """No mesh: empty specs, size-1 axes, None trees, `constrain` the
    identity. On a mesh: the divide-or-replicate fallback (kv heads 8 on
    model 16 stay replicated), an axis used once a spec, and absent mesh
    axes dropped (no `pod` on the (16, 16) mesh)."""
    import torch
    assert sharding.resolve_spec(("embed", "heads"), (8, 8)) == ()
    assert sharding.mesh_axis_size("model") == 1
    assert sharding.current() is None and sharding.act_sharding(
        ("batch",), (4,)) is None
    specs = build_model(get_config("gemma-2b")).param_specs()
    assert all(p is None for p in tree.leaves(
        sharding.param_shardings(specs), is_leaf=lambda x: x is None))
    x = torch.zeros(3)
    assert sharding.constrain(x, "batch") is x
    with sharding.use_mesh(tmesh.abstract_mesh((16, 16),
                                               ("data", "model"))):
        assert sharding.mesh_axis_size("model") == 16
        assert sharding.mesh_axis_size("pod") == 1
        assert sharding.resolve_spec(("embed", "kv_heads", "head_dim"),
                                     (2048, 8, 128)) == ("data", None, None)
        assert sharding.resolve_spec(("heads", "mlp"), (16, 32)) \
            == ("model", None)
        assert sharding.resolve_spec(("batch", "seq"), (32, 8), "act") \
            == ("data", None)
        assert sharding.batch_axes_prefix(8) == ()
        with pytest.raises(RuntimeError, match="DeviceMesh"):
            sharding.axis_index("model")
    assert sharding.current() is None


def test_production_mesh_is_a_device_mesh_of_the_reference_axes():
    """`make_production_mesh` builds the (16, 16) and (2, 16, 16)
    `DeviceMesh`es over a 256- and a 512-rank world (torch's `fake`
    backend, in a subprocess), their axes named as the reference's; the
    rules resolve on them as on the abstract mesh; `make_mesh` refuses a
    world of the wrong size."""
    prog = textwrap.dedent("""
        import json, sys
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch import device, tree
        from repro_torch.configs.base import get_config
        from repro_torch.launch import mesh as tmesh
        from repro_torch.models.module import is_spec
        from repro_torch.models.registry import build_model
        from repro_torch.parallel import sharding
        device.set_default("cpu")
        specs = tree.leaves(build_model(get_config("phi4-mini-3.8b"))
                            .param_specs(), is_leaf=is_spec)
        out = {}
        for multi_pod, world in ((False, 256), (True, 512)):
            dist.init_process_group("fake", rank=world - 1,
                                    world_size=world, store=FakeStore())
            try:
                m = tmesh.make_production_mesh(multi_pod=multi_pod)
                with sharding.use_mesh(m):
                    out[str(multi_pod)] = dict(
                        names=list(m.mesh_dim_names), shape=list(m.shape),
                        model=sharding.axis_index("model"),
                        specs=[list(sharding.resolve_spec(s.axes, s.shape))
                               for s in specs])
                try:
                    tmesh.make_mesh((2, 4), ("data", "model"))
                except RuntimeError as e:
                    out[str(multi_pod)]["refused"] = "512" not in str(e)
            finally:
                dist.destroy_process_group()
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    specs = tree.leaves(build_model(get_config("phi4-mini-3.8b"))
                        .param_specs(), is_leaf=is_spec)
    for multi_pod in (False, True):
        shape, axes = tmesh.production_shape(multi_pod=multi_pod)
        g = got[str(multi_pod)]
        assert g["names"] == list(axes) and g["shape"] == list(shape)
        assert g["model"] == 15 and g["refused"]
        with sharding.use_mesh(tmesh.abstract_mesh(shape, axes)):
            want = [list(sharding.resolve_spec(s.axes, s.shape))
                    for s in specs]
        norm = [[tuple(e) if isinstance(e, list) else e for e in s]
                for s in g["specs"]]
        assert norm == [list(s) for s in want]


# -- on 8 ranks -----------------------------------------------------------------
REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models.module import is_spec
from repro.models.registry import build_model
from repro.parallel import sharding
from repro.parallel.compress import compressed_psum_mean

out = {}
# tests/test_compress.py's inputs
mesh = make_mesh((8,), ("d",))
x = jax.random.normal(jax.random.PRNGKey(0), (8, 4096))
out["x"] = np.asarray(x)
for res in (True, False):
    def inner(x_l, res=res):
        got = compressed_psum_mean(x_l[0], "d", return_residual=res)
        return tuple(g[None] for g in got) if res else got[None]
    spec = P("d", None)
    f = shard_map(inner, mesh=mesh, in_specs=spec,
                  out_specs=(spec, spec) if res else spec, check_vma=False)
    got = jax.jit(f)(x)
    if res:
        out["out"], out["residual"] = np.asarray(got[0]), np.asarray(got[1])
    else:
        out["bare"] = np.asarray(got)
# NamedSharding.shard_shape of reduced gemma-2b's leaves on (2, 4)
mesh = make_mesh((2, 4), ("data", "model"))
specs = build_model(reduced(get_config("gemma-2b"))).param_specs()
flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_spec)[0]
for fsdp in (True, False):
    with sharding.use_mesh(mesh, fsdp=fsdp):
        for path, s in flat:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            ns = NamedSharding(mesh, sharding.resolve_spec(s.axes, s.shape))
            out[f"shape/{int(fsdp)}/{key}"] = np.asarray(
                ns.shard_shape(s.shape), np.int64)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the reference's sharded results, each of the 8 gloo ranks')."""
    d = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE,
                        str(d / "ref.npz")], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    got = _torch_ranks.run(("shard_shapes", "compress"), 8, d,
                           {"x": ref["x"]})
    return ref, got


def test_param_shardings_give_each_rank_the_reference_shard_shape(ranks):
    """reduced gemma-2b's leaves distributed by `param_shardings` on a
    (2, 4) mesh: every rank's local shape is the reference's
    `NamedSharding.shard_shape`, FSDP on and off."""
    ref, got = ranks
    keys = sorted(k for k in ref if k.startswith("shape/"))
    assert keys and keys == sorted(k for k in got[0] if k.startswith("shape/"))
    # FSDP shards the embedding table's d_model over data; without it the
    # table is sharded over model (vocab) alone
    assert any(not np.array_equal(ref[f"shape/1/{k[8:]}"],
                                  ref[f"shape/0/{k[8:]}"])
               for k in keys if k.startswith("shape/1/"))
    for r, g in enumerate(got):
        for k in keys:
            np.testing.assert_array_equal(g[k], ref[k], err_msg=f"{r} {k}")


def test_compressed_psum_mean_equals_the_reference_on_8_ranks(ranks):
    """`compressed_psum_mean` over 8 gloo ranks of `tests/test_compress.
    py`'s inputs: each rank's result and residual equal the reference's
    within 1e-6 of the mean's scale, the int8 result within the
    reference test's 5 % of the exact mean; `wire_bytes_ratio` equal."""
    ref, got = ranks
    x = ref["x"]
    exact = x.mean(0)
    scale = np.abs(exact).max()
    for r, g in enumerate(got):
        for name in ("out", "residual", "bare"):
            np.testing.assert_allclose(g[f"compress/{name}"], ref[name][r],
                                       rtol=0, atol=1e-6 * scale,
                                       err_msg=f"rank {r} {name}")
        assert np.abs(g["compress/out"] - exact).max() < 0.05 * scale
        np.testing.assert_array_equal(g["compress/out"], got[0]["compress/out"])
    for b in (2, 4):
        assert tcompress.wire_bytes_ratio(b) == jcompress.wire_bytes_ratio(b)
