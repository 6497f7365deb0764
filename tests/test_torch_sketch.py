"""The port's ANALYZE against the JAX package: ``ops.sketch_blocks``
(device "cpu": the sketch kernel's plain version) against the JAX
``repro.kernels.ops.sketch_blocks`` on its jnp path and its forced-Pallas
path (interpret mode), with tests/test_kernels.py's shapes and bars; and
the port's ``analyze_model`` against the JAX one on the same checkpoints
(full, delta-kind and adapter experts over a bf16 base): equal bytes,
hashes, signatures and ``analyze`` I/O, stats within rtol 1e-5 / atol
1e-6 (sums in another order), ``cos_base`` within atol 1e-5 (the port
derives it from three norms), and identical plan selections."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.core.catalog import Catalog as JaxCatalog  # noqa: E402
from repro.core.planner import plan_merge as jax_plan_merge  # noqa: E402
from repro.core.sketch import analyze_model as jax_analyze  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.store.iostats import IOStats as JaxIOStats  # noqa: E402
from repro.store.tensorstore import CheckpointStore as JaxStore  # noqa: E402
from repro_torch.core.catalog import Catalog  # noqa: E402
from repro_torch.core.planner import plan_merge  # noqa: E402
from repro_torch.core.sketch import analyze_model  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.store.iostats import IOStats  # noqa: E402
from repro_torch.store.tensorstore import CheckpointStore  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
SHAPES = [(3, 257), (8, 1024), (5, 700), (16, 2048), (1, 64)]  # test_kernels
BLOCK = 4096
OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]


def _check_stats(got, want):
    """tests/test_kernels.py:80-82: l2 rtol 1e-4, absmax, mean rtol 1e-3 /
    atol 1e-6 (absmax is exact in both)."""
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("force_pallas", ["0", "1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sketch_blocks_matches_jax(monkeypatch, force_pallas, dtype, shape):
    nb, w = shape
    x = np.random.default_rng(3).normal(size=(nb, w)).astype(np.float32)
    xj = x.astype(BF16) if dtype == "bfloat16" else x
    xt = xj.view(np.uint16) if dtype == "bfloat16" else x  # bf16 words
    monkeypatch.setenv("REPRO_FORCE_PALLAS", force_pallas)
    want = np.asarray(jops.sketch_blocks(xj), np.float32)
    got = tops.sketch_blocks(xt, device="cpu")
    _check_stats(got, want)
    xf = xj.astype(np.float32)
    np.testing.assert_allclose(got[:, 0], np.linalg.norm(xf, axis=1),
                               rtol=1e-5)
    np.testing.assert_allclose(got[:, 2], xf.mean(axis=1), rtol=1e-5,
                               atol=1e-6)


def test_sketch_blocks_true_width_means():
    """Zero-padded ragged rows: ``widths`` gives np.mean of each unpadded
    row (the JAX wrapper would divide by the padded width); l2 and
    absmax are exact under zero padding."""
    rng = np.random.default_rng(4)
    widths = [1001, 64, 700, 1]
    rows = [rng.normal(size=n).astype(np.float32) for n in widths]
    padded = np.zeros((len(rows), max(widths)), np.float32)
    for i, r in enumerate(rows):
        padded[i, :r.size] = r
    got = tops.sketch_blocks(padded, device="cpu", widths=widths)
    want = np.concatenate([np.asarray(jops.sketch_blocks(r[None]))
                           for r in rows])
    _check_stats(got, want)
    np.testing.assert_allclose(got[:, 2], [r.mean() for r in rows],
                               rtol=1e-5, atol=1e-6)
    # a torch tensor input takes the same path
    np.testing.assert_array_equal(
        tops.sketch_blocks(torch.from_numpy(padded), device="cpu",
                           widths=widths), got)


def _checkpoints(rng):
    """A bf16 base, two full bf16 experts, a float32 delta-kind expert and
    a LoRA adapter (ml_dtypes arrays: the JAX package's form)."""
    shapes = {"l0/w": (64, 96), "l0/b": (96,), "emb": (300, 130),
              "l1/w": (40, 70)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    models = {"base": ("full", {k: v.astype(BF16) for k, v in base.items()})}
    for e in range(2):
        models[f"full{e}"] = ("full", {
            k: (v + 0.02 * rng.normal(size=v.shape)).astype(BF16)
            for k, v in base.items()})
    models["delta"] = ("delta", {
        k: (0.02 * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in base.items() if k != "l1/w"})
    models["lora"] = ("adapter", {
        "l0/w::lora_A": (0.1 * rng.normal(size=(4, 96))).astype(np.float32),
        "l0/w::lora_B": (0.1 * rng.normal(size=(64, 4))).astype(np.float32),
        "emb::lora_A": (0.1 * rng.normal(size=(2, 130))).astype(np.float32),
        "emb::lora_B": (0.1 * rng.normal(size=(300, 2))).astype(np.float32),
    })
    return models


@pytest.fixture
def analyzed(tmp_path):
    """One set of checkpoints (written by the JAX store) ANALYZEd by both
    packages into their own catalogs, each with its own I/O stats."""
    models = _checkpoints(np.random.default_rng(0))
    store = JaxStore(str(tmp_path / "models"), JaxIOStats())
    for name, (kind, arrays) in models.items():
        meta = {"kind": kind, **({"scale": 0.5} if kind == "adapter" else {})}
        store.write_model(name, arrays, meta=meta)
    jstats, tstats = JaxIOStats(), IOStats()
    jcat = JaxCatalog(str(tmp_path / "jax.sqlite"), jstats)
    tcat = Catalog(str(tmp_path / "port.sqlite"), tstats)
    jstore = JaxStore(str(tmp_path / "models"), jstats)
    tstore = CheckpointStore(str(tmp_path / "models"), tstats)
    for name in models:
        base = None if name == "base" else "base"
        jax_analyze(jcat, jstore, name, BLOCK, base_id=base)
        analyze_model(tcat, tstore, name, BLOCK, base_id=base, device="cpu")
    yield models, jcat, tcat, jstats, tstats
    jcat.close()
    tcat.close()


def test_analyze_matches_jax(analyzed):
    models, jcat, tcat, jstats, tstats = analyzed
    for cat in ("analyze",):
        for kind in ("read", "written"):
            assert (jstats.snapshot()[kind].get(cat)
                    == tstats.snapshot()[kind].get(cat))
    assert jstats.snapshot()["read"]["analyze"]["bytes"] > 0
    for name in models:
        a, b = jcat.block_metas(name, BLOCK), tcat.block_metas(name, BLOCK)
        assert len(a) == len(b) > 0, name
        for ra, rb in zip(a, b):
            # tensor, block, bytes, hash; absmax; sign signature
            assert ra[:4] == rb[:4] and ra[5] == rb[5] and ra[7] == rb[7]
            for i in (4, 6, 8):  # l2, mean, l2_delta
                if ra[i] is None:
                    assert rb[i] is None
                else:
                    assert rb[i] == pytest.approx(ra[i], rel=1e-5, abs=1e-6)
            if ra[9] is None:  # cos_base
                assert rb[9] is None
            else:
                assert rb[9] == pytest.approx(ra[9], abs=1e-5)
        assert jcat.tensor_metas(name) == tcat.tensor_metas(name)
    # every kind of row was exercised: deltas against the base, cosines
    assert any(r[9] is not None for r in tcat.block_metas("full0", BLOCK))
    assert all(r[9] is None for r in tcat.block_metas("delta", BLOCK))
    assert len(tcat.block_metas("lora", BLOCK)) > 0


@pytest.mark.parametrize("op,theta", OPS)
def test_plans_from_port_analyze_match_jax(analyzed, op, theta):
    _, jcat, tcat, _, _ = analyzed
    experts = ["full0", "full1", "delta", "lora"]
    for budget in (None, 60000, 20000):
        pj = jax_plan_merge(jcat, "base", experts, op, theta=theta,
                            budget_b=budget, block_size=BLOCK, reuse=False)
        pt = plan_merge(tcat, "base", experts, op, theta=theta,
                        budget_b=budget, block_size=BLOCK, reuse=False)
        assert pt.plan.selection == pj.plan.selection
        assert pt.plan.c_expert_hat == pj.plan.c_expert_hat


def test_analyze_groups_blocks_per_launch(tmp_path, monkeypatch):
    """A tensor's full-width blocks share launches under the byte cap, its
    ragged tail goes alone, and the rows equal an unbatched ANALYZE."""
    from repro_torch.core import sketch
    from repro_torch.kernels import merge_block as mb

    store = CheckpointStore(str(tmp_path / "models"), IOStats())
    rng = np.random.default_rng(5)
    base = {"emb": rng.normal(size=(300, 130)).astype(np.float32)}
    store.write_model("base", base)
    store.write_model("e", {"emb": base["emb"] + 0.01})
    calls = []
    real = mb.sketch_blocks
    monkeypatch.setattr(mb, "sketch_blocks",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    rows = {}
    for cap in (sketch.LAUNCH_BYTES, 4 * BLOCK):  # one group; 4-block groups
        monkeypatch.setattr(sketch, "LAUNCH_BYTES", cap)
        calls.clear()
        cat = Catalog(str(tmp_path / f"c{cap}.sqlite"))
        analyze_model(cat, store, "e", BLOCK, base_id="base", device="cpu")
        rows[cap] = cat.block_metas("e", BLOCK)
        shapes = list(calls)
        cat.close()
        nfull = 300 * 130 * 4 // BLOCK  # 38 full blocks + a tail
        want = ([(nfull, BLOCK // 4)] if cap > 4 * BLOCK else
                [(4, BLOCK // 4)] * (nfull // 4) + [(nfull % 4, BLOCK // 4)])
        tail = (1, (300 * 130 * 4 - nfull * BLOCK) // 4)
        # x, base, x − base per group
        assert shapes == [s for s in want + [tail] for _ in range(3)]
    a, b = rows.values()
    assert [r[:4] + (r[5], r[7]) for r in a] == [r[:4] + (r[5], r[7])
                                                 for r in b]
    for ra, rb in zip(a, b):
        for i in (4, 6, 8, 9):
            assert ra[i] == pytest.approx(rb[i], rel=1e-6, abs=1e-7)
