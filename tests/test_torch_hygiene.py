"""Boundaries of the port: it imports nothing of JAX or of the JAX
package, it runs on the card unless asked for the CPU (and raises where
there is no card), and its CPU path never builds or loads a CUDA
library."""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.core.executor import execute_merge  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import merge_block as mb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, from_jax_flat, load_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.store.checkpoint import flatten_tree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "yaml", "repro")


def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MergePipe(str(tmp_path / "ws"))
    with pytest.raises(RuntimeError, match="CUDA"):
        MergePipe(str(tmp_path / "ws"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.merge_blocks("avg", np.zeros((1, 4), np.float32),
                         np.zeros((1, 1, 4), np.float32), {})
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096, device="cpu")
    rng = np.random.default_rng(0)
    base = {"w": rng.normal(size=(32, 64)).astype(np.float32)}
    mp.register_model("base", base)
    mp.register_model("e0", {"w": base["w"] + 0.01})
    mp.ensure_analyzed("base", ["e0"])
    plan = mp.plan("base", ["e0"], "avg", budget=0.5).plan
    for compute in ("pipelined", "batched"):
        with pytest.raises(RuntimeError, match="CUDA"):
            execute_merge(plan, mp.snapshots, mp.catalog, txn=mp.txn,
                          compute=compute, device="cuda")
    # refused before any transaction state: nothing staged or published
    assert os.listdir(mp.snapshots.staging_root) == []
    assert mp.list_snapshots() == []
    mp.close()


def test_kernel_checks_refuse_cpu_operands():
    x0, D = torch.zeros(2, 8), torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mb._check("linear_merge", x0, D, [])
    with pytest.raises(ValueError):
        mb._check("linear_merge", x0, torch.zeros(2, 3, 9), [])


def _forbid_library_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    for lib in (mb.LIBRARY, fa.LIBRARY):
        monkeypatch.setattr(lib, "_lib", None)
        monkeypatch.setattr(
            lib, "load",
            lambda: pytest.fail("the CPU path loaded a CUDA library"))


def test_cpu_path_never_loads_the_library(tmp_path, monkeypatch):
    _forbid_library_loads(tmp_path, monkeypatch)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(2, 16)).astype(np.float32)
    D = rng.normal(size=(2, 3, 16)).astype(np.float32)
    masks = rng.random((2, 3, 16)) < 0.5
    mb.reset_launches()
    for op in ("avg", "ta", "ties", "dare"):
        ops.merge_blocks(op, x0, D, {}, masks=masks, device="cpu")
    assert mb.LIBRARY._lib is None
    assert not os.path.exists(kbuild.BUILD_DIR)
    assert sum(mb.LAUNCHES.values()) == 0  # plain versions are not launches


def test_cpu_serving_never_loads_the_library(tmp_path, monkeypatch):
    """Prefill (flash attention), decode and the engine on the CPU run
    the plain versions and count no launch."""
    _forbid_library_loads(tmp_path, monkeypatch)
    model = build_model(get_smoke_config("qwen2-1.5b"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    fa.reset_launches()
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(3)]
    ServeEngine(model, batch_slots=2, max_len=16).run(reqs)
    with torch.no_grad():
        model(torch.zeros((1, 5), dtype=torch.long))
    assert all(r.done for r in reqs)
    assert fa.LIBRARY._lib is None
    assert not os.path.exists(kbuild.BUILD_DIR)
    assert fa.LAUNCHES["flash_attention"] == 0


def test_model_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite-3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    flat = flatten_tree(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_flat(cfg, flat)
    assert load_flat(model, flat) is model
    assert ServeEngine(model).device.type == "cpu"
