"""The port's ``core/distributed.py`` against the JAX package's on the
CPU: the packing and mask builders and ``shard_plan_by_host`` give the
reference's arrays and buckets; ``merge_blocks_masked`` (the kernels'
plain versions on the CPU) matches the reference's ``build_merge_step``
on a one-device CPU mesh for every operator and model kind; the TIES
tail-block bound; and the whole-shard worker (``kernel="mesh"``) in
both packages: within tolerance of each other on float32 models, while
on bf16 models the port's runs and the reference's raises (it packs at
``block_size // 4`` elements, half a bf16 block)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from jax.sharding import Mesh  # noqa: E402
from repro.api import MergeSpec as JaxSpec  # noqa: E402
from repro.api import Session as JaxSession  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.api import MergePipe as JaxMergePipe  # noqa: E402
from repro.core.planner import plan_merge as jax_plan_merge  # noqa: E402
from repro.dist import DistOptions as JaxDist  # noqa: E402
from repro_torch.api import MergeSpec, Session  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.core.plan import MergePlan  # noqa: E402
from repro_torch.core.planner import plan_merge  # noqa: E402
from repro_torch.dist import DistOptions  # noqa: E402
from repro_torch.store import dtypes  # noqa: E402

from conftest import make_models  # noqa: E402

BS = 4096
OPS = [("avg", {}), ("ta", {"lam": 0.5}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 11})]
OP_IDS = [op for op, _ in OPS]
TOL = {"rtol": 1e-5, "atol": 1e-6}
BF16 = np.dtype(ml_dtypes.bfloat16)


# ------------------------------------------------------ packing and masks
def test_pack_unpack_match_reference():
    rng = np.random.default_rng(7)
    arrays = {
        "tiny": rng.normal(size=(3,)).astype(np.float32),
        "ragged": rng.normal(size=(5, 27)).astype(np.float32),
        "aligned": rng.normal(size=(2, 64)).astype(np.float32),
        "big": rng.normal(size=(401,)).astype(np.float32),
        "ints": np.arange(5, dtype=np.int32),  # excluded (non-float)
    }
    blocks, metas = dist.pack_arrays(arrays, 64)
    j_blocks, j_metas = jdist.pack_arrays(arrays, 64)
    assert metas == j_metas and "ints" not in {m[0] for m in metas}
    np.testing.assert_array_equal(blocks, j_blocks)
    out, j_out = dist.unpack_arrays(blocks, metas), jdist.unpack_arrays(
        j_blocks, j_metas)
    assert set(out) == set(j_out)
    for name in out:
        np.testing.assert_array_equal(out[name], j_out[name])
        np.testing.assert_array_equal(out[name], arrays[name])
    empty, none = dist.pack_arrays({"ints": arrays["ints"]}, 64)
    assert empty.shape == (0, 64) and none == []


def test_selection_and_dare_masks_match_reference():
    rng = np.random.default_rng(5)
    arrays = {"a/tail": rng.normal(size=(70,)).astype(np.float32),
              "a/w": rng.normal(size=(8, 256)).astype(np.float32),
              "b/w": rng.normal(size=(5, 256)).astype(np.float32)}
    blocks, metas = dist.pack_arrays(arrays, 256)

    class _P:  # minimal plan stand-in for the mask builders
        expert_ids = ["e0", "e1"]
        selection = {
            "e0": {"a/tail": [0], "a/w": [1, 3]},
            "e1": {"b/w": [0, 4], "missing": [0]},
        }
        theta = {"seed": 3, "density": 0.5}

    nb = blocks.shape[0]
    sel = dist.selection_mask(_P, metas, 256, nb)
    np.testing.assert_array_equal(sel, jdist.selection_mask(_P, metas, 256, nb))
    assert sel.sum() == 5
    masks = dist.dare_masks_packed(_P, metas, 256, nb)
    np.testing.assert_array_equal(
        masks, jdist.dare_masks_packed(_P, metas, 256, nb))
    assert masks.any()


@pytest.mark.parametrize("n_hosts", [2, 3, 4])
@pytest.mark.parametrize("mode", ["no-catalog", "catalog", "packed"])
def test_shard_plan_by_host_matches_reference(tmp_path, mode, n_hosts):
    """The same plan's LPT buckets (bytes and items) in both packages:
    the legacy block-size estimate, the catalog's physical bytes, and a
    packed layout whose deduped extents are billed once a host."""
    base, experts = make_models(n_experts=3)
    models = {"base": base, **{f"ex{i}": e for i, e in enumerate(experts)}}
    if mode == "packed":
        models["twin0"] = models["twin1"] = experts[0]
    ids = [m for m in models if m != "base"]
    buckets = []
    for MP, plan_fn, shard, kw in (
            (JaxMergePipe, jax_plan_merge, jdist.shard_plan_by_host, {}),
            (MergePipe, plan_merge, dist.shard_plan_by_host,
             {"device": "cpu"})):
        mp = MP(str(tmp_path / MP.__module__), block_size=BS, **kw)
        for name, arrays in models.items():
            mp.register_model(name, arrays)
        mp.ensure_analyzed("base", ids)
        layout = (mp.repack(ids, "base")["layout_id"] if mode == "packed"
                  else None)
        plan = plan_fn(mp.catalog, "base", ids, "ties",
                       budget_b=mp.resolve_budget(ids, 0.6), block_size=BS,
                       reuse=False, layout_id=layout).plan
        buckets.append(shard(plan, n_hosts, catalog=None if mode ==
                             "no-catalog" else mp.catalog))
        mp.close()
    assert buckets[1] == buckets[0]
    assert sum(len(b["items"]) for b in buckets[1]) > 0


# ------------------------------------------------------ the whole-shard step
@pytest.mark.parametrize("kind", ["delta", "full"])
@pytest.mark.parametrize("op,theta", OPS, ids=OP_IDS)
def test_merge_blocks_masked_matches_reference_step(op, theta, kind):
    """Rows of 0..K selected experts: the plain versions on the CPU
    against the reference's jitted step on a one-device CPU mesh."""
    rng = np.random.default_rng(13)
    k, nb, w = 3, 9, 256
    base = rng.normal(size=(nb, w)).astype(np.float32)
    experts = (0.05 * rng.normal(size=(k, nb, w))).astype(np.float32)
    if kind == "full":
        experts = experts + base[None]
    select = np.zeros((k, nb), bool)
    for b in range(nb):  # block b selects b % (K + 1) experts
        select[rng.permutation(k)[: b % (k + 1)], b] = True
    masks = rng.random((k, nb, w)) < 0.5
    args = [base, experts, select] + ([masks] if op == "dare" else [])
    kept = [a.copy() for a in args]
    got = dist.build_merge_step(op, theta, kind=kind, device="cpu")(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb, w)
    for a, b in zip(args, kept):
        np.testing.assert_array_equal(a, b)  # the inputs are not modified
    mesh = Mesh(np.array(jax.devices()[:1]), ("all",))
    want = np.asarray(jdist.build_merge_step(mesh, op, theta, kind=kind,
                                             donate=False)(*args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unselected = ~select.any(axis=0)
    np.testing.assert_array_equal(got.numpy()[unselected], base[unselected])


def test_merge_blocks_masked_launches_in_row_chunks(monkeypatch):
    """More rows than one launch takes: the same result in chunks."""
    rng = np.random.default_rng(2)
    k, nb, w = 2, 7, 64
    base = rng.normal(size=(nb, w)).astype(np.float32)
    experts = rng.normal(size=(k, nb, w)).astype(np.float32)
    select = rng.random((k, nb)) < 0.6
    whole = dist.merge_blocks_masked(base, experts, select, "avg", {},
                                     device="cpu")
    monkeypatch.setattr(dist, "MAX_LAUNCH_ROWS", 3)
    chunked = dist.merge_blocks_masked(base, experts, select, "avg", {},
                                       device="cpu")
    assert torch.equal(whole, chunked)
    with pytest.raises(ValueError, match="masks"):
        dist.merge_blocks_masked(base, experts, select, "dare", {},
                                 device="cpu")


def test_ties_tail_block_deviation_bounded(tmp_path):
    """The whole-shard TIES trims over the padded tail block, which can
    deviate from the streaming engine there and only there (the bound of
    tests/test_distributed.py)."""
    mp = MergePipe(str(tmp_path), block_size=1024, device="cpu")
    w = 256
    rng = np.random.default_rng(11)
    base = {"big": rng.normal(size=(40, 256)).astype(np.float32),
            "tail": rng.normal(size=(100,)).astype(np.float32)}
    deltas = [{k: 0.05 * rng.normal(size=v.shape).astype(np.float32)
               for k, v in base.items()} for _ in range(3)]
    mp.register_model("base", base)
    for i, d in enumerate(deltas):
        mp.register_model(f"e{i}", d, kind="delta")
    res = mp.merge("base", [f"e{i}" for i in range(3)], op="ties",
                   theta={"trim_frac": 0.4}, budget=1.0, reuse_plan=False)
    streamed = mp.load(res.sid)
    plan = MergePlan.from_payload(
        mp.catalog.get_plan(res.manifest["plan_id"])["payload"])
    base_blocks, metas = dist.pack_arrays(base, w)
    eb = np.stack([dist.pack_arrays(d, w)[0] for d in deltas])
    sel = dist.selection_mask(plan, metas, w, base_blocks.shape[0])
    step = dist.build_merge_step("ties", plan.theta, kind="delta",
                                 device="cpu")
    out = dist.unpack_arrays(step(base_blocks, eb, sel).numpy(), metas)
    np.testing.assert_allclose(out["big"], streamed["big"], **TOL)
    diff = ~np.isclose(out["tail"], streamed["tail"], **TOL)
    assert diff.sum() <= min(w, base["tail"].size)
    mp.close()


# ------------------------------------------------- the whole-shard workers
def _sessions(tmp_path, bf16):
    """A JAX and a port Session holding the same models (bf16: ml_dtypes
    arrays for the JAX package, their uint16 words for the port)."""
    base, experts = make_models(n_experts=3)
    jsess = JaxSession(str(tmp_path / "jax"), block_size=BS)
    psess = Session(str(tmp_path / "port"), block_size=BS, device="cpu")
    for name, arrays in [("base", base)] + [
            (f"ex{i}", e) for i, e in enumerate(experts)]:
        if bf16:
            jsess.register_model(name, {k: v.astype(BF16)
                                        for k, v in arrays.items()})
            psess.register_model(name, {k: dtypes.from_float32(v, dtypes.BFLOAT16)
                                        for k, v in arrays.items()})
        else:
            jsess.register_model(name, arrays)
            psess.register_model(name, arrays)
    return jsess, psess, ["ex0", "ex1", "ex2"]


def _run(sess, Spec, ids, sid, op, theta, budget="60%", **kw):
    sess.submit(Spec.build("base", ids, op=op, theta=dict(theta),
                           budget=budget), sid=sid)
    return sess.run_all(**kw)[0]


def _raggeds(sess, sid, w):
    """{tensor: min(W, size)} of the tensors a W-element block grid
    leaves ragged."""
    out = {}
    for t, a in sess.load(sid).items():
        if a.size % w:
            out[t] = min(w, a.size)
    return out


@pytest.mark.parametrize("op,theta", OPS, ids=OP_IDS)
def test_mesh_workers_float32_match_reference(tmp_path, op, theta):
    """float32 models, kernel="mesh", 2 workers in each package: within
    tolerance of each other; against the stream engine exact to the
    tolerance but for TIES's tail blocks."""
    jsess, psess, ids = _sessions(tmp_path, bf16=False)
    for sess, Spec, D in ((jsess, JaxSpec, JaxDist), (psess, MergeSpec,
                                                      DistOptions)):
        _run(sess, Spec, ids, "local", op, theta, compute="stream")
        _run(sess, Spec, ids, "mesh", op, theta, dist=D(
            n_workers=2, transport="inline", kernel="mesh"))
    got, ref, local = psess.load("mesh"), jsess.load("mesh"), psess.load(
        "local")
    tails = _raggeds(psess, "local", BS // 4)
    n_tail = 0
    for t in got:
        np.testing.assert_allclose(got[t], ref[t], **TOL)
        diff = ~np.isclose(got[t], local[t], **TOL)
        if op == "ties" and t in tails:
            n_tail += int(diff.sum())
        else:
            assert not diff.any(), t
    assert n_tail <= sum(tails.values())
    jsess.close()
    psess.close()


def _differ_but_zero_sign(a, b):
    """bf16 words that differ, a zero's sign apart."""
    a, b = a.view(np.uint16), b.view(np.uint16)
    both_zero = ((a & 0x7FFF) == 0) & ((b & 0x7FFF) == 0)
    return (a != b) & ~both_zero


@pytest.mark.parametrize("op,theta", [OPS[0], OPS[2], OPS[3]],
                         ids=["avg", "ties", "dare"])
def test_mesh_workers_bf16_port_runs_reference_raises(tmp_path, op, theta):
    """bf16 models: the port packs at the stored block's element count
    (block_size // 2) and lands bit-equal to its pipelined merge, a
    zero's sign apart (TIES: but for its tail blocks); the reference
    packs at block_size // 4 and raises (a deliberate difference)."""
    jsess, psess, ids = _sessions(tmp_path, bf16=True)
    with pytest.raises(ValueError, match="could not broadcast"):
        _run(jsess, JaxSpec, ids, "mesh", op, theta, dist=JaxDist(
            n_workers=2, transport="inline", kernel="mesh"))
    _run(psess, MergeSpec, ids, "local", op, theta)
    r = _run(psess, MergeSpec, ids, "mesh", op, theta, dist=DistOptions(
        n_workers=2, transport="inline", kernel="mesh"))
    assert r.stats["kernel"] == "mesh"
    got, local = psess.load("mesh"), psess.load("local")
    tails = _raggeds(psess, "local", BS // 2)
    n_tail = 0
    for t in got:
        n = int(_differ_but_zero_sign(got[t], local[t]).sum())
        if op == "ties" and t in tails:
            n_tail += n
        else:
            assert n == 0, t
    assert n_tail <= sum(tails.values())
    jsess.close()
    psess.close()


def test_mesh_worker_refuses_mixed_item_sizes(tmp_path):
    """A shard whose mergeable tensors differ in item size cannot share
    one block width: the worker raises, naming the dtypes."""
    rng = np.random.default_rng(1)
    base = {"a": rng.normal(size=(600,)).astype(np.float32),
            "b": dtypes.from_float32(rng.normal(size=(600,)).astype(
                np.float32), dtypes.BFLOAT16)}
    with Session(str(tmp_path / "ws"), block_size=BS, device="cpu") as sess:
        sess.register_model("base", base)
        sess.register_model("ex0", {
            "a": base["a"] + np.float32(0.1),
            "b": dtypes.from_float32(dtypes.to_float32(base["b"]) + 0.1,
                                     dtypes.BFLOAT16)})
        with pytest.raises(ValueError, match="item sizes"):
            _run(sess, MergeSpec, ["ex0"], "mesh", "avg", {}, budget="100%",
                 dist=DistOptions(n_workers=1, transport="inline",
                                  kernel="mesh"))
