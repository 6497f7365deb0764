"""The port's merge path as a whole against the JAX package: the same
models registered in a JAX ``repro.core.api.MergePipe`` and a port
``repro_torch.core.api.MergePipe(device="cpu")`` give the same plans,
the same stream-engine bytes, the same pipelined results (the port's
torch kernel path against the JAX ``kernel="jax"`` path) and the same
per-category I/O bytes; each package merges a workspace the other wrote;
a cancelled pipelined merge publishes nothing."""
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.core.api import MergePipe as JaxMergePipe  # noqa: E402
from repro.core.executor import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.store.iostats import IOStats as JaxIOStats  # noqa: E402
from repro.store.iostats import measure as jax_measure  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.core.executor import MergeCancelled, PipelineConfig  # noqa: E402
from repro_torch.store.iostats import IOStats, measure  # noqa: E402

OPS = [
    ("avg", {}),
    ("ta", {"lam": 0.7}),
    ("ties", {"trim_frac": 0.3}),
    ("dare", {"density": 0.5, "seed": 3}),
]
BF16 = np.dtype(ml_dtypes.bfloat16)
IO_CATEGORIES = ("base_read", "expert_read", "out_written")
SMALL_PIPE = dict(window_blocks=4, prefetch_windows=2, read_threads=3,
                  write_queue_blocks=8)


def _models(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"layer0/w": (64, 96), "layer0/b": (96,), "emb": (128, 32),
              "layer1/w": (40, 70)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    experts = [{k: v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
                for k, v in base.items()} for _ in range(3)]
    if dtype == "bfloat16":
        base = {k: v.astype(BF16) for k, v in base.items()}
        experts = [{k: v.astype(BF16) for k, v in e.items()} for e in experts]
    return base, experts


def _port_arrays(arrays):
    """ml_dtypes bf16 -> the port's uint16 words (same bytes)."""
    return {k: v.view(np.uint16) if v.dtype == BF16 else v
            for k, v in arrays.items()}


def _register(mp, base, experts, port):
    conv = _port_arrays if port else (lambda a: a)
    mp.register_model("base", conv(base))
    ids = []
    for i, e in enumerate(experts):
        mp.register_model(f"ex{i}", conv(e))
        ids.append(f"ex{i}")
    mp.ensure_analyzed("base", ids)
    return ids


def _hashes(mp, sid):
    with mp.snapshots.models.open_model(sid) as r:
        return {t: r.spec(t)["hash"] for t in r.tensor_names()}


def _as_f32(a):
    if a.dtype in (BF16, np.uint16):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,theta", OPS)
def test_port_matches_jax_merge(tmp_path, dtype, op, theta):
    base, experts = _models(dtype)
    jmp = JaxMergePipe(str(tmp_path / "jax"), block_size=4096, stats=JaxIOStats())
    tmp = MergePipe(str(tmp_path / "port"), block_size=4096, device="cpu")
    ids = _register(jmp, base, experts, port=False)
    _register(tmp, base, experts, port=True)

    # the planners select the same blocks at the same cost
    jplan = jmp.plan("base", ids, op, theta=theta, budget=0.5).plan
    tplan = tmp.plan("base", ids, op, theta=theta, budget=0.5).plan
    assert tplan.c_expert_hat == jplan.c_expert_hat
    assert tplan.tensor_order == jplan.tensor_order
    for t in jplan.tensor_order:
        assert tplan.reverse_index(t) == jplan.reverse_index(t)

    with jax_measure(jmp.stats) as io_js:
        js = jmp.execute(jplan, compute="stream")
    with jax_measure(jmp.stats) as io_jk:
        jk = jmp.execute(jplan, compute="pipelined",
                         pipeline=JaxPipelineConfig(kernel="jax", **SMALL_PIPE))
    with measure(tmp.stats) as io_ts:
        ts = tmp.merge("base", ids, op, theta=theta, budget=0.5, compute="stream")
    with measure(tmp.stats) as io_tk:
        tk = tmp.merge("base", ids, op, theta=theta, budget=0.5,
                       pipeline=PipelineConfig(kernel="torch", **SMALL_PIPE))
    assert tk.stats["pipeline"]["kernel"] == "torch"

    # stream engines: bit-identical files
    assert _hashes(tmp, ts.sid) == _hashes(jmp, js.sid)
    # pipelined torch kernels vs pipelined jax kernels: float tolerance
    a, b = tmp.load(tk.sid), jmp.load(jk.sid)
    for k in a:
        if dtype == "float32":
            np.testing.assert_allclose(a[k], b[k], rtol=2e-6, atol=2e-6)
        else:
            ulp = np.abs(a[k].astype(np.int32) - b[k].view(np.uint16).astype(np.int32))
            assert ulp.max() <= 1, k
            np.testing.assert_allclose(_as_f32(a[k]), _as_f32(b[k]),
                                       rtol=2 ** -7, atol=0)
    # per-category I/O: every engine in both packages moves the same bytes
    for cat in IO_CATEGORIES:
        assert io_ts[cat] == io_tk[cat] == io_js[cat] == io_jk[cat], cat
    assert tk.stats["c_expert_run"] <= tplan.c_expert_hat
    jmp.close()
    tmp.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,theta", OPS)
def test_port_batched_engine_matches_stream(tmp_path, dtype, op, theta):
    """The batched engine (merge_blocks per (K_sel, width) group over a
    whole tensor) writes the stream engine's bytes and reads its bytes."""
    base, experts = _models(dtype, seed=1)
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096, device="cpu")
    ids = _register(mp, base, experts, port=True)
    with measure(mp.stats) as io_s:
        rs = mp.merge("base", ids, op, theta=theta, budget=0.5, compute="stream")
    with measure(mp.stats) as io_b:
        rb = mp.merge("base", ids, op, theta=theta, budget=0.5, compute="batched")
    assert _hashes(mp, rb.sid) == _hashes(mp, rs.sid)
    for cat in IO_CATEGORIES:
        assert io_s[cat] == io_b[cat], cat
    mp.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_workspace_is_shared_between_packages(tmp_path, writer):
    """One package registers and analyzes; the other opens the same
    workspace, merges, and gets the bytes the writer gets."""
    ws = str(tmp_path / "ws")
    base, experts = _models("bfloat16", seed=4)
    make_j = lambda: JaxMergePipe(ws, block_size=4096, stats=JaxIOStats())  # noqa: E731
    make_t = lambda: MergePipe(ws, block_size=4096, device="cpu")  # noqa: E731
    first, second = (make_j, make_t) if writer == "jax" else (make_t, make_j)

    mp = first()
    ids = _register(mp, base, experts, port=writer == "port")
    kw = dict(theta={"trim_frac": 0.3}, budget=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r1 = mp.merge("base", ids, "ties", compute="stream", sid="by-writer", **kw)
    assert r1.sid == "by-writer"
    mp.close()

    mp = second()
    assert mp.catalog.has_analysis("base", 4096)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        # each package's default engine: the port's is the pipelined one
        # with its torch kernels (plain versions on the CPU)
        r2 = mp.merge("base", ids, "ties", sid="by-reader", **kw)
    assert _hashes(mp, r2.sid) == _hashes(mp, "by-writer")
    assert mp.verify("by-writer") and mp.verify("by-reader")
    mp.close()


def test_cancel_mid_pipeline_publishes_nothing(tmp_path):
    base, experts = _models("float32", seed=2)
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096, device="cpu")
    ids = _register(mp, base, experts, port=True)
    plan = mp.plan("base", ids, "ties", theta={"trim_frac": 0.3}, budget=0.8).plan
    cancel = threading.Event()

    def progress(done, total):
        if done >= 2:
            cancel.set()

    cfg = PipelineConfig(window_blocks=1, prefetch_windows=1, read_threads=2)
    with pytest.raises(MergeCancelled):
        mp.execute(plan, sid="victim", pipeline=cfg, cancel=cancel,
                   progress=progress)
    assert "victim" not in mp.list_snapshots()
    assert not mp.snapshots.is_published("victim")
    assert mp.txn.recover() == {
        "staging_gc": 0, "manifests_repaired": 0, "resumable": {},
    }
    # the same plan then commits, bit-identical to the stream engine
    res = mp.execute(plan, sid="victim", pipeline=cfg)
    ref = mp.execute(plan, sid="reference", compute="stream")
    assert _hashes(mp, res.sid) == _hashes(mp, ref.sid)
    mp.close()


def test_port_stats_are_its_own(tmp_path):
    """A port MergePipe counts into its own IOStats by default."""
    a = MergePipe(str(tmp_path / "a"), block_size=4096, device="cpu")
    b = MergePipe(str(tmp_path / "b"), block_size=4096, device="cpu")
    assert isinstance(a.stats, IOStats) and a.stats is not b.stats
    a.close()
    b.close()
