"""Package rules of the torch port: what it imports, where it runs, and
how state crosses from the reference."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import verbs as jverbs
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.convert import regions_from_numpy

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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


def test_import_needs_no_card_no_triton_and_pulls_in_no_jax():
    code = ("import sys, torch\n"
            "import repro_torch, repro_torch.verbs, repro_torch.convert\n"
            "import repro_torch.kernels.wr_scatter.ops\n"
            "import repro_torch.kernels.desc_ring.ops\n"
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
    finally:
        tdevice.set_default(prev)


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
