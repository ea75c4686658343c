"""Package rules of the torch port: what it imports, where it runs, and
how state crosses from the reference."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import verbs as jverbs
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import regions_from_numpy, tree_from_numpy
from repro_torch.core.kvtransfer import KVTransferEngine
from repro_torch.core.solar import SolarBlockStore
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.pd_disagg import PDServer

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").rglob("*.py"))


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_the_scan_covers_every_subpackage():
    subs = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
            for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"configs", "core", "kernels", "launch", "models", "obs",
            "parallel", "serve", "train", "utils", "verbs"} <= subs
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("parallel/collectives", "models/attention",
                "models/ffn", "models/layers", "models/transformer",
                "kernels/flash_attention/ops", "kernels/flash_attention/ref",
                "serve/paged", "serve/engine", "launch/serve",
                "kernels/ring_pipe/ops", "kernels/ring_pipe/ref",
                "kernels/list_walk/ops", "kernels/list_walk/ref",
                "core/solar", "serve/pd_disagg", "serve/router",
                "kernels/desc_ring/ops", "kernels/desc_ring/ref",
                "models/encdec", "train/data", "train/optimizer",
                "train/train_loop", "train/checkpoint", "train/fault",
                "launch/train", "launch/mesh", "parallel/sharding",
                "parallel/compress", "launch/dryrun", "launch/attribute",
                "utils/roofline", "utils/costmodel", "utils/hlo_analysis",
                "utils/hlo_cost"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    for probe in ("row_ring", "desc_ring", "latency", "sp", "dryrun"):
        assert f"tools/{probe}/probe.py" in names, probe


def test_import_needs_no_card_no_triton_and_pulls_in_no_jax():
    code = ("import sys, torch\n"
            "import repro_torch, repro_torch.verbs, repro_torch.convert\n"
            "import repro_torch.kernels.wr_scatter.ops\n"
            "import repro_torch.kernels.desc_ring.ops\n"
            "import repro_torch.kernels.kv_ingest.ops\n"
            "import repro_torch.core.kvtransfer, repro_torch.core.rx_engine\n"
            "import repro_torch.serve.kvcache, repro_torch.launch.mesh\n"
            "import repro_torch.models.registry, repro_torch.configs.base\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.models.transformer\n"
            "import repro_torch.parallel.collectives\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.kernels.ring_pipe.ops\n"
            "import repro_torch.kernels.list_walk.ops\n"
            "import repro_torch.core.solar, repro_torch.serve.pd_disagg\n"
            "import repro_torch.serve.router\n"
            "import repro_torch.models.encdec, repro_torch.launch.train\n"
            "import repro_torch.train.data, repro_torch.train.optimizer\n"
            "import repro_torch.train.train_loop\n"
            "import repro_torch.train.checkpoint, repro_torch.train.fault\n"
            "import repro_torch.parallel.sharding\n"
            "import repro_torch.parallel.compress\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.attribute\n"
            "import repro_torch.utils.hlo_cost, repro_torch.utils.costmodel\n"
            "from repro_torch.configs.base import get_config\n"
            "get_config('gemma-2b')\n"
            "assert not torch.cuda.is_available()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'repro', 'triton')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_is_the_card_and_never_falls_back():
    """Without a card, constructing on the default device raises; the
    CPU is used only when asked for."""
    prev = tdevice.set_default("cuda")
    try:
        assert tdevice.get_default().type == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            tverbs.ProtectionDomain()
        with pytest.raises(RuntimeError, match="cuda"):
            tverbs.CompletionQueue(16, device_ring=True)
        assert tverbs.ProtectionDomain(device="cpu").engine.device.type \
            == "cpu"
        assert not tverbs.CompletionQueue(16).ring.device   # host ring
        with pytest.raises(RuntimeError, match="cuda"):
            tverbs.Fabric(pods=2)
        with pytest.raises(RuntimeError, match="cuda"):
            PagedKVPool(4, 2, (3,))
        model = build_model(reduced(get_config("gemma-2b")))
        with pytest.raises(RuntimeError, match="cuda"):
            KVTransferEngine(model, 2, 8)
        with pytest.raises(RuntimeError, match="cuda"):
            model.init_cache(2, 8)
        with pytest.raises(RuntimeError, match="cuda"):
            model.init(torch.Generator())
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(model, {})
        with pytest.raises(RuntimeError, match="cuda"):
            PDServer(model, {})
        with pytest.raises(RuntimeError, match="cuda"):
            SolarBlockStore(4)
        assert tverbs.Fabric(pods=2, device="cpu").device.type == "cpu"
        assert PagedKVPool(4, 2, (3,), device="cpu").pages.device.type \
            == "cpu"
    finally:
        tdevice.set_default(prev)


def test_training_defaults_to_the_card_and_never_falls_back(tmp_path):
    """Without a card, the training CLI (its default `--device` is the
    card), a checkpoint restore onto the default device (a template of
    no tensors) and `EncDecLM.init` raise; asked for the CPU, they run."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.train.checkpoint import Checkpointer
    prev = tdevice.set_default("cuda")
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            tlaunch.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])
        ck = Checkpointer(str(tmp_path), async_write=False)
        ck.save(1, {"w": torch.ones(3)})
        with pytest.raises(RuntimeError, match="cuda"):
            ck.restore({"w": np.zeros(3, np.float32)})
        assert ck.restore({"w": torch.zeros(3)})[1]["w"].device.type == "cpu"
        model = build_model(reduced(get_config("whisper-base")))
        with pytest.raises(RuntimeError, match="cuda"):
            model.init(torch.Generator())
        with pytest.raises(RuntimeError, match="cuda"):
            model.init_cache(1, 4)
        assert tree_leaves_on_cpu(model.init(torch.Generator(),
                                             device="cpu"))
    finally:
        tdevice.set_default(prev)


def tree_leaves_on_cpu(t) -> bool:
    from repro_torch import tree
    leaves = tree.leaves(t)
    return bool(leaves) and all(x.device.type == "cpu" for x in leaves)


def test_tree_from_numpy_keeps_bf16_bits():
    """bf16 crosses as its bit pattern, from an ml_dtypes array or from
    uint16 bits (the card machine has no ml_dtypes); other leaves take
    the reference's demotion; the structure is kept."""
    rng = np.random.default_rng(2)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    bf[0, :3] = [np.inf, -0.0, np.nan]
    tree = {"v": [bf], "k": (np.arange(4, dtype=np.int64),
                             rng.standard_normal(2))}
    got = tree_from_numpy(tree, "cpu")
    assert got["v"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["v"][0].view(torch.int16).numpy().view(np.uint16),
        bf.view(np.uint16))
    assert isinstance(got["k"], tuple)
    assert [t.dtype for t in got["k"]] == [torch.int32, torch.float32]
    bits = tree_from_numpy([bf.view(np.uint16)], "cpu", bf16_bits=True)
    np.testing.assert_array_equal(
        bits[0].view(torch.int16).numpy().view(np.uint16),
        bf.view(np.uint16))
    with pytest.raises(TypeError):
        tree_from_numpy([np.zeros(2, np.float32)], "cpu", bf16_bits=True)


def test_regions_from_numpy_reproduces_reference_keys():
    rng = np.random.default_rng(5)
    regions = {"blocks": rng.standard_normal((16, 8)),      # float64
               "local": np.arange(12, dtype=np.int64).reshape(4, 3),
               "bytes": rng.integers(0, 255, (5, 7), dtype=np.uint8)}
    jverbs.ProtectionDomain._next_key = 0x4242
    jpd = jverbs.ProtectionDomain()
    jmrs = {k: jpd.reg_mr(k, a) for k, a in regions.items()}
    tverbs.ProtectionDomain._next_key = 0x4242
    tpd = tverbs.ProtectionDomain(device="cpu")
    tmrs = regions_from_numpy(tpd, regions, device="cpu")
    assert list(tmrs) == list(jmrs)
    for k in regions:
        j, t = jmrs[k], tmrs[k]
        assert (t.lkey, t.rkey, t.n_records, t.record, t.shape) == \
               (j.lkey, j.rkey, j.n_records, j.record, j.shape)
        jarr = np.asarray(jpd.engine.regions[k])
        tarr = tpd.mr_array(t).numpy()
        assert tarr.dtype == jarr.dtype
        np.testing.assert_array_equal(tarr, jarr)
    with pytest.raises(ValueError):
        regions_from_numpy(tpd, {"x": np.zeros(2)}, device="meta")
