"""The port's tiered / remote store (``repro_torch.store.remote``,
``repro_torch.store.tiered``) against the JAX package on the CPU, and the
JAX package's own remote-store cases run on the port.

Against the JAX package, the same seeded experts published to an
emulated bucket (``RemoteProfile`` latency 0) in a workspace of each
package: a cold TIES merge reads its expert bytes from the remote tier
(as many as a flat merge reads locally, bit-equal output), a warm
re-run from a fresh session reads them from the disk cache and none
from remote, and a ``tier_billing=True`` merge stays inside the budget —
with equal per-category bytes and equal remote request counters in both
packages at every step, also with faults injected and retried.

The port's ``DiskExtentCache.fill`` differs from the reference on
purpose: a caller that becomes the filler first looks at the cache
again, so one that arrives after an earlier fill finished is served
warm instead of fetching a second time.  So does ``TieredReader``: a
coalesced run the disk tier covers in part is read piece by piece, so a
tier-billed merge the reference refuses (budget soundness) runs within
budget on the port."""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.api import MergeSpec as JaxMergeSpec  # noqa: E402
from repro.api import Session as JaxSession  # noqa: E402
from repro.core.executor import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.store.iostats import measure as jax_measure  # noqa: E402
from repro_torch.api import MergeSpec, Session  # noqa: E402
from repro_torch.core.executor import PipelineConfig  # noqa: E402
from repro_torch.store.iostats import EXPERT_CATEGORIES, IOStats, measure  # noqa: E402
from repro_torch.store.remote import (  # noqa: E402
    RemoteError,
    RemoteObjectStore,
    RemoteProfile,
    RetryPolicy,
)
from repro_torch.store.tiered import DiskExtentCache, TieredReader  # noqa: E402

from torch_locktrace import lock_tracer  # noqa: E402,F401
from torch_pair import assert_same_arrays, cast  # noqa: E402

BS = 4096
OP_THETAS = {
    "avg": {},
    "ta": {"lam": 0.7},
    "ties": {"trim_frac": 0.3},
    "dare": {"density": 0.5, "seed": 3},
}


#: the bytes each step of the tiered sequence must move identically
TIER_IO = ("base_read", "expert_read", "expert_remote_read",
           "expert_disk_read", "expert_repair_read", "out_written")


# ======================================================= against the JAX package
def _pair_fleet(k=3):
    rng = np.random.default_rng(11)
    shapes = {"layer0/w": (64, 96), "emb": (128, 32), "ln": (96,),
              "layer1/w": (40, 70)}
    base = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    experts = [{n: v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
                for n, v in base.items()} for _ in range(k)]
    return base, experts


def _pair_session(tmp_path, pkg, dtype, remote, profile=None):
    """A session of one package ("jax" or "port") over its own workspace,
    the experts flat or published to the workspace's bucket."""
    ws = str(tmp_path / f"{pkg}-{'remote' if remote else 'flat'}")
    port = pkg == "port"
    sess = (Session(ws, block_size=BS, device="cpu") if port
            else JaxSession(ws, block_size=BS))
    base, experts = _pair_fleet()
    sess.register_model("base", cast(base, dtype, port))
    ids = []
    for i, ex in enumerate(experts):
        sess.register_model(f"e{i}", cast(ex, dtype, port))
        if remote:
            sess.publish_model_remote(f"e{i}", os.path.join(ws, "bucket"),
                                      profile=profile)
        ids.append(f"e{i}")
    sess.ensure_analyzed("base", ids)
    return sess, ids


def _pair_merge(sess, pkg, ids, budget=0.5, **run_kw):
    spec = (MergeSpec if pkg == "port" else JaxMergeSpec).build(
        base="base", experts=list(ids), op="ties",
        theta={"trim_frac": 0.3}, budget=budget)
    h = sess.submit(spec)
    remote = sess.snapshots.models.is_remote(ids[0])
    before = _requests(sess)["requests"] if remote else 0
    with (measure if pkg == "port" else jax_measure)(sess.stats) as io:
        sess.run_all(**run_kw)
    io = {c: io[c] for c in TIER_IO}
    io["requests"] = (_requests(sess)["requests"] if remote else 0) - before
    return h.result, sess.load(h.result.sid), io


def _requests(sess):
    ws = sess.snapshots.workspace
    return sess.snapshots.models.remote_store(
        os.path.join(ws, "bucket")).counters()


def _reopen(sess, pkg):
    ws = sess.snapshots.workspace
    sess.close()
    if pkg == "port":
        return Session(ws, block_size=BS, device="cpu")
    return JaxSession(ws, block_size=BS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_sequence_matches_reference(tmp_path, dtype):
    """Cold, warm and tier-billed TIES merges: outputs, per-category
    bytes and remote request counters equal in both packages."""
    out = {}
    for pkg in ("jax", "port"):
        flat, ids = _pair_session(tmp_path, pkg, dtype, remote=False)
        rf, golden, io_flat = _pair_merge(flat, pkg, ids)
        flat.close()
        sess, ids = _pair_session(tmp_path, pkg, dtype, remote=True,
                                  profile={"latency_s": 0.0})
        sess.evict_disk_cache(0)
        cold, got, io_cold = _pair_merge(sess, pkg, ids)
        # cold: every expert byte from remote, as many as the flat merge
        assert io_cold["expert_remote_read"] == io_flat["expert_read"] > 0
        assert io_cold["expert_disk_read"] == 0
        assert_same_arrays(golden, got)
        sess = _reopen(sess, pkg)
        warm, got_w, io_warm = _pair_merge(sess, pkg, ids)
        assert io_warm["expert_remote_read"] == 0
        assert io_warm["expert_disk_read"] == io_cold["expert_remote_read"]
        assert_same_arrays(golden, got_w)
        sess = _reopen(sess, pkg)
        billed, _, io_billed = _pair_merge(sess, pkg, ids, tier_billing=True)
        assert billed.stats["c_expert_run"] <= billed.stats["c_expert_hat"]
        assert (billed.stats["realized_expert_blocks"]
                >= cold.stats["realized_expert_blocks"])
        out[pkg] = dict(
            io=(io_flat, io_cold, io_warm, io_billed),
            stats=[(r.stats["c_expert_run"], r.stats["c_expert_hat"],
                    r.stats["realized_expert_blocks"])
                   for r in (rf, cold, warm, billed)],
            outputs=(golden, got),
        )
        sess.close()
    assert out["jax"]["io"] == out["port"]["io"]
    io_cold, io_warm = out["port"]["io"][1:3]
    assert io_cold["requests"] > 0 and io_warm["requests"] == 0
    assert out["jax"]["stats"] == out["port"]["stats"]
    assert_same_arrays(out["jax"]["outputs"][0], out["port"]["outputs"][0])


@pytest.mark.parametrize("fail_every", [3, 5])
def test_faults_retried_like_reference(tmp_path, fail_every):
    """An endpoint that fails every Nth data request: the tiered readers
    retry through it, the merge is bit-equal to the flat one, and the
    fault and request counters equal the reference's."""
    out = {}
    for pkg in ("jax", "port"):
        flat, ids = _pair_session(tmp_path, pkg, "bfloat16", remote=False)
        _, golden, _ = _pair_merge(flat, pkg, ids)
        flat.close()
        sess, ids = _pair_session(tmp_path, pkg, "bfloat16", remote=True,
                                  profile={"latency_s": 0.0,
                                           "fail_every": fail_every})
        sess.evict_disk_cache(0)
        before = _requests(sess)
        res, got, io = _pair_merge(sess, pkg, ids,
                                   pipeline=_pipe(pkg, read_threads=1))
        after = _requests(sess)
        assert_same_arrays(golden, got)
        assert after["faults_injected"] > before["faults_injected"]
        out[pkg] = ({k: after[k] - before[k] for k in after}, io, golden)
        sess.close()
    assert out["jax"][:2] == out["port"][:2]
    assert_same_arrays(out["jax"][2], out["port"][2])


def _pipe(pkg, **kw):
    """The remote-backed pipeline defaults of one package, with ``kw``."""
    config = PipelineConfig if pkg == "port" else JaxPipelineConfig
    return dataclasses.replace(config.for_remote(), **kw)


@pytest.mark.parametrize("coalesce", [True, False])
def test_tier_billing_over_coalesced_runs_matches_reference(tmp_path,
                                                            coalesce):
    """Tier billing prices a warm block at the disk tier's weight.  With
    coalescing, a run that mixes warm and cold blocks is fetched whole
    from remote by the reference, so its realized cold bytes pass the
    plan and its execute_merge refuses the merge.  The port reads such a
    run piece by piece (a deliberate difference): it runs the merge with
    realized remote bytes within the plan, from both tiers, and its
    snapshot equals the reference engine's merge of the same plan over
    local reads.  Without coalescing both packages run it and move the
    same bytes."""
    from repro.core.executor import execute_merge as jax_execute
    from repro.core.plan import MergePlan as JaxMergePlan

    out = {}
    for pkg in ("jax", "port"):
        sess, ids = _pair_session(tmp_path, pkg, "float32", remote=True,
                                  profile={"latency_s": 0.0})
        sess.evict_disk_cache(0)
        _pair_merge(sess, pkg, ids)                  # cold: fills the cache
        sess = _reopen(sess, pkg)
        _pair_merge(sess, pkg, ids)                  # warm
        budget = "30%"
        try:
            res, got, io = _pair_merge(sess, pkg, ids, budget=budget,
                                       tier_billing=True, coalesce=coalesce)
            out[pkg] = ("ran", io, res.stats["c_expert_run"],
                        res.stats["c_expert_hat"])
            payload = sess.catalog.get_plan(res.manifest["plan_id"])["payload"]
        except RuntimeError as e:
            assert "budget soundness violated" in str(e)
            out[pkg] = ("refused",)
        sess.close()
    if not coalesce:
        assert out["jax"] == out["port"]
        _, _io, run, hat = out["port"]
        assert run <= hat
        return
    assert out["jax"] == ("refused",)
    _, io, run, hat = out["port"]
    assert run == io["expert_remote_read"] <= hat
    assert io["expert_disk_read"] > 0 and io["expert_remote_read"] > 0
    # the reference engine on the port's plan, over local (flat) reads:
    # the expert bytes it reads are the plan's logical ones, past the
    # tier-billed hat, so its budget check is off
    flat, _ids = _pair_session(tmp_path, "jax", "float32", remote=False)
    ref = jax_execute(JaxMergePlan.from_payload(payload), flat.snapshots,
                      flat.catalog, sid="ref", txn=flat.txn,
                      enforce_budget=False)
    assert ref.stats["c_expert_run"] > hat
    assert_same_arrays(flat.load("ref"), got)
    flat.close()


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_tier_billing_whole_tiers_match_reference(tmp_path, tier):
    """Over a fully warm or a fully cold disk tier the port's piecewise
    read never splits a run: a tier-billed TIES at 30% selects the same
    blocks as the reference, moves the same bytes by category and the
    same remote requests, and gives the same output."""
    out = {}
    for pkg in ("jax", "port"):
        sess, ids = _pair_session(tmp_path, pkg, "float32", remote=True,
                                  profile={"latency_s": 0.0})
        sess.evict_disk_cache(0)
        if tier == "warm":
            _pair_merge(sess, pkg, ids, budget=1.0)  # every block cached
        sess = _reopen(sess, pkg)
        res, got, io = _pair_merge(sess, pkg, ids, budget="30%",
                                   tier_billing=True)
        plan = sess.catalog.get_plan(res.manifest["plan_id"])["payload"]
        out[pkg] = (plan["selection"], io, res.stats["c_expert_run"],
                    res.stats["c_expert_hat"], got)
        sess.close()
    assert out["jax"][:4] == out["port"][:4]
    io = out["port"][1]
    if tier == "warm":
        assert io["expert_remote_read"] == 0 < io["expert_disk_read"]
    else:
        assert io["expert_disk_read"] == 0 < io["expert_remote_read"]
    assert_same_arrays(out["jax"][4], out["port"][4])


@pytest.mark.parametrize("warm,gap_tier", [((1, 2), "warm"),
                                            ((0,), "cold")])
def test_coalesced_gap_bills_each_piece_its_selected_bytes(tmp_path, warm,
                                                          gap_tier):
    """A coalesced run over blocks 0 and 2 of ``emb`` bridges block 1 (its
    gap) and is read piece by piece over a partly warm disk tier: each
    piece bills its tier for exactly the selected bytes inside it, and
    the gap's bytes go to ``other`` whichever tier holds it.  With the
    gap in a warm piece, remote is billed for the cold selected block
    (charging the gap to the cold piece first would bill remote 0); with
    the gap in a cold piece, disk is billed for the warm selected block
    and remote for the cold one."""
    sess, ids = _pair_session(tmp_path, "port", "float32", remote=True,
                              profile={"latency_s": 0.0})
    sess.evict_disk_cache(0)
    sess = _reopen(sess, "port")
    reader = sess.snapshots.models.open_model(ids[0])
    assert isinstance(reader, TieredReader)
    for i in warm:                          # fill the disk tier's extents
        reader.read_block("emb", i, BS, "expert")
    ckey = reader._content_key("emb")
    pieces = reader.disk.pieces(ckey, 0, 3 * BS)
    gap = [c for o, n, c in pieces if o <= BS and BS + BS <= o + n]
    assert gap == [gap_tier == "warm"] and len(pieces) == 2
    cats = ("expert_remote", "expert_disk", "other")
    before = {c: reader.stats.bytes_read(c) for c in cats}
    got = reader.read_blocks_coalesced("emb", [0, 2], BS, "expert",
                                       gap_bytes=BS)
    moved = {c: reader.stats.bytes_read(c) - before[c] for c in cats}
    cold_selected = sum(i not in warm for i in (0, 2)) * BS
    assert moved == {"expert_remote": cold_selected,
                     "expert_disk": 2 * BS - cold_selected, "other": BS}
    _, experts = _pair_fleet()
    flat = experts[0]["emb"].reshape(-1)
    w = BS // 4
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], flat[i * w:(i + 1) * w])
    sess.close()


def test_late_filler_reads_the_cache_instead_of_fetching(tmp_path):
    """A caller that reaches ``fill`` after an earlier filler published
    the extent and left the in-flight table is served from the cache:
    ``we_fetched`` False and no fetch."""
    cache = DiskExtentCache(str(tmp_path / "dc"))
    fetches = []

    def fetch():
        fetches.append(1)
        return bytes(range(256)) * 16

    data, we = cache.fill("k", 0, 4096, fetch)
    assert we and len(fetches) == 1
    late, we_late = cache.fill("k", 0, 4096, fetch)
    assert late == data and we_late is False and len(fetches) == 1
    # a range the cache does not cover is still fetched
    _, we_other = cache.fill("k", 4096, 4096, fetch)
    assert we_other and len(fetches) == 2


def test_rescan_keeps_an_extent_published_while_listing(tmp_path,
                                                        monkeypatch):
    """A rescan whose directory listing predates a concurrent publish
    keeps the published extent in the index (the port's rescan merges
    instead of overwriting), so the range stays a warm hit."""
    from repro_torch.store import tiered

    cache = DiskExtentCache(str(tmp_path / "dc"))
    cache.put("k", 0, bytes(1024))
    real_listdir = tiered.os.listdir
    published = []

    def listdir(path):
        names = real_listdir(path)
        if not published:                     # the listing is taken, then
            published.append(cache.put("k", 1024, bytes(1024)))  # a publish
        return names

    monkeypatch.setattr(tiered.os, "listdir", listdir)
    # the miss rescans over a listing without the second extent, and is
    # served from both extents all the same
    assert cache.read("k", 0, 2048) == bytes(2048)
    assert published == [True]


@pytest.mark.parametrize("rescan", ["reference", "port"])
def test_fill_repair_alone_refetches_under_the_reference_rescan(
        tmp_path, monkeypatch, rescan):
    """Why the port's ``_rescan`` differs too: with the port's ``fill``
    but the reference's ``_rescan``, a reader whose miss rescans over a
    listing taken just before another caller's fill published the range
    drops that extent from the index, finds no cover when it becomes the
    filler, and fetches the range a second time.  With the port's
    ``_rescan`` it is served warm and the range is fetched once."""
    from repro.store.tiered import DiskExtentCache as JaxDiskExtentCache
    from repro_torch.store import tiered

    if rescan == "reference":
        monkeypatch.setattr(DiskExtentCache, "_rescan",
                            JaxDiskExtentCache._rescan)
    cache = DiskExtentCache(str(tmp_path / "dc"))
    cache.put("k", 0, bytes(1024))
    fetches = []

    def fetch():
        fetches.append(1)
        return bytes(range(256)) * 4

    real_listdir = tiered.os.listdir

    def listdir(path):
        names = real_listdir(path)
        if not fetches:                # the listing is taken, then another
            cache.fill("k", 1024, 1024, fetch)      # caller fills the range
        return names

    monkeypatch.setattr(tiered.os, "listdir", listdir)
    # the late reader: its miss rescans over the stale listing; on a miss
    # it becomes the filler, as TieredReader does
    data = cache.read("k", 1024, 1024)
    if data is None:
        data, _ = cache.fill("k", 1024, 1024, fetch)
    assert data == bytes(range(256)) * 4
    assert len(fetches) == (2 if rescan == "reference" else 1)


def test_tiered_reader_fills_trace_clean(tmp_path, lock_tracer):
    """Eight threads of two tiered readers filling the same cold ranges
    through one disk cache: no lock-order cycle, no blocking I/O under a
    scheduler lock, and one remote fetch per range."""
    sess, ids = _pair_session(tmp_path, "port", "float32", remote=True,
                              profile={"latency_s": 0.0})
    sess.evict_disk_cache(0)
    sess = _reopen(sess, "port")
    models = sess.snapshots.models
    readers = [models.open_model(ids[0]), models.open_model(ids[0])]
    assert all(isinstance(r, TieredReader) for r in readers)
    before = _requests(sess)["requests"]
    barrier = threading.Barrier(8)
    got = []

    def worker(i):
        barrier.wait()
        r = readers[i % 2]
        got.append([r.read_range("layer0/w", off, BS, "expert")
                    for off in range(0, 4 * BS, BS)])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(g == got[0] for g in got)
    assert _requests(sess)["requests"] - before == 4
    for r in readers:
        r.close()
    sess.close()


# ============================================ the JAX package's own cases
def _fleet(k=3):
    rng = np.random.default_rng(0)
    shapes = {"layer0/w": (64, 96), "emb": (128, 32), "ln": (96,)}
    base = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    experts = []
    for i in range(k):
        r = np.random.default_rng(100 + i)
        experts.append({
            n: v + 0.02 * r.normal(size=v.shape).astype(np.float32)
            for n, v in base.items()
        })
    return base, experts


def _setup(tmp_path, name, remote=False, profile=None, disk_cache=True, k=3):
    """A Session whose experts are flat local, or published to an
    emulated bucket and replaced by remote stubs."""
    ws = str(tmp_path / name)
    sess = Session(ws, block_size=BS, device="cpu")
    base, experts = _fleet(k)
    sess.register_model("base", base)
    ids = []
    for i, ex in enumerate(experts):
        mid = f"e{i}"
        sess.register_model(mid, ex)
        if remote:
            sess.publish_model_remote(
                mid, os.path.join(ws, "bucket"), profile=profile,
                disk_cache=disk_cache,
            )
        ids.append(mid)
    sess.ensure_analyzed("base", ids)
    return sess, ids


def _merge(sess, ids, op="ties", budget=0.5, **run_kw):
    h = sess.submit(MergeSpec.build(
        base="base", experts=list(ids), op=op, theta=OP_THETAS[op],
        budget=budget,
    ))
    sess.run_all(**run_kw)
    return h.result, sess.load(h.result.sid)


# --------------------------------------------------------------- endpoint
def test_remote_object_store_surface(tmp_path):
    store = RemoteObjectStore(str(tmp_path / "bucket"))
    store.put_object("m/a.bin", b"0123456789")
    assert store.head("m/a.bin")["size"] == 10
    assert store.get_range("m/a.bin", 2, 5) == b"23456"
    assert store.get_range("m/a.bin") == b"0123456789"
    assert store.list_keys() == ["m/a.bin"]
    assert store.list_keys("x/") == []
    with pytest.raises(RemoteError):
        store.get_range("m/a.bin", 8, 5)  # out of bounds
    with pytest.raises(RemoteError):
        store.get_range("m/missing.bin")
    with pytest.raises(RemoteError):
        store.head("m/missing.bin")
    with pytest.raises(RemoteError):
        store.get_range("../escape")
    c = store.counters()
    assert c["requests"] == 5 and c["bytes_served"] == 15


def test_fault_injection_and_retry_policy(tmp_path):
    store = RemoteObjectStore(str(tmp_path / "bucket"))
    store.put_object("k", b"abc")
    store.inject_faults(2)
    with pytest.raises(RemoteError):
        store.get_range("k")
    # retry rides through the remaining scheduled fault
    retries = []
    data = RetryPolicy(attempts=3, base_backoff_s=0.0).call(
        lambda: store.get_range("k"), on_retry=retries.append
    )
    assert data == b"abc" and retries == [1]
    # exhaustion: more consecutive faults than attempts
    store.inject_faults(5)
    with pytest.raises(RemoteError, match="after 3 attempts"):
        RetryPolicy(attempts=3, base_backoff_s=0.0).call(
            lambda: store.get_range("k")
        )
    assert store.counters()["faults_injected"] == 5
    # deterministic fail_every schedule
    flaky = RemoteObjectStore(
        str(tmp_path / "b2"), RemoteProfile(fail_every=2)
    )
    flaky.put_object("k", b"x")
    assert flaky.get_range("k") == b"x"
    with pytest.raises(RemoteError):
        flaky.get_range("k")


# ------------------------------------------------------------- tiered path
def test_publish_roundtrip_and_tier_accounting(tmp_path):
    sess, ids = _setup(tmp_path, "ws", remote=True)
    base, experts = _fleet()
    # stubs replace local bytes but the models stay visible
    for i, mid in enumerate(ids):
        assert sess.snapshots.models.is_remote(mid)
        assert mid in sess.snapshots.models.list_models()
        got = sess.load(mid)
        for t in experts[i]:
            np.testing.assert_array_equal(got[t], experts[i][t])
    st = sess.stats
    sess.evict_disk_cache(0)
    misses0 = st.cache_counters("disk")["misses"]
    hits0 = st.cache_counters("disk")["hits"]
    reader = sess.snapshots.models.open_model(ids[0])
    # cold expert read: the budget-governed expert_remote category
    reader.read_range("layer0/w", 0, BS, "expert")
    assert st.bytes_read("expert_remote") == BS
    assert st.cache_counters("disk")["misses"] == misses0 + 1
    # the fill warmed the disk tier: the re-read is expert_disk, with
    # no further remote expert bytes
    reader.read_range("layer0/w", 0, BS, "expert")
    assert st.bytes_read("expert_remote") == BS
    assert st.bytes_read("expert_disk") == BS
    assert st.cache_counters("disk")["hits"] == hits0 + 1
    sess.close()


def test_register_remote_from_existing_bucket(tmp_path):
    sess, ids = _setup(tmp_path, "pub", remote=True)
    bucket = os.path.join(str(tmp_path / "pub"), "bucket")
    _, experts = _fleet()
    sess.close()
    # a second tenant points a fresh workspace at the same bucket
    other = Session(str(tmp_path / "tenant2"), block_size=BS, device="cpu")
    other.register_remote_model("e0", bucket)
    got = other.load("e0")
    for t in experts[0]:
        np.testing.assert_array_equal(got[t], experts[0][t])
    with pytest.raises(ValueError):
        other.register_remote_model("e0", bucket)  # already registered
    with pytest.raises(RemoteError):
        other.register_remote_model("typo", bucket)  # never published
    other.close()


@pytest.mark.parametrize("op", sorted(OP_THETAS))
def test_remote_merge_bit_identical_to_local(tmp_path, op):
    lsess, ids = _setup(tmp_path, "local")
    _, golden = _merge(lsess, ids, op=op)
    lsess.close()
    rsess, rids = _setup(tmp_path, "remote", remote=True,
                         profile={"latency_s": 1e-4})
    _, got = _merge(rsess, rids, op=op)
    for t in golden:
        np.testing.assert_array_equal(golden[t], got[t])
    rsess.close()


def test_warm_rerun_reads_zero_remote_expert_bytes(tmp_path):
    lsess, ids = _setup(tmp_path, "local")
    _, golden = _merge(lsess, ids)
    lsess.close()
    rsess, rids = _setup(tmp_path, "remote", remote=True)
    _merge(rsess, rids)
    rsess.close()
    # fresh Session, same workspace: RAM tier empty, disk tier warm
    warm = Session(str(tmp_path / "remote"), block_size=BS, device="cpu")
    with measure(warm.stats) as io:
        _, got = _merge(warm, rids)
    assert io["expert_remote_read"] == 0
    assert io["expert_disk_read"] > 0
    for t in golden:
        np.testing.assert_array_equal(golden[t], got[t])
    warm.close()


def test_no_disk_cache_stub_always_remote(tmp_path):
    sess, ids = _setup(tmp_path, "ws", remote=True, disk_cache=False)
    sess.close()
    s2 = Session(str(tmp_path / "ws"), block_size=BS, device="cpu")
    reader = s2.snapshots.models.open_model(ids[0])
    reader.read_range("layer0/w", 0, BS, "expert")
    reader.read_range("layer0/w", 0, BS, "expert")
    # no warm tier: the repeat read round-trips again
    assert s2.stats.bytes_read("expert_remote") == 2 * BS
    assert s2.stats.bytes_read("expert_disk") == 0
    s2.close()


def test_tiered_reader_retries_through_faults(tmp_path):
    sess, ids = _setup(tmp_path, "ws", remote=True)
    sess.evict_disk_cache(0)
    store = sess.snapshots.models.remote_store(
        os.path.join(str(tmp_path / "ws"), "bucket")
    )
    store.inject_faults(2)
    reader = sess.snapshots.models.open_model(ids[0])
    assert isinstance(reader, TieredReader)
    got = reader.read_tensor("emb", "expert")
    _, experts = _fleet()
    np.testing.assert_array_equal(got, experts[0]["emb"])
    assert reader.retries >= 2
    assert store.counters()["faults_injected"] >= 2
    sess.close()


# --------------------------------------------------------------- disk tier
def test_disk_cache_eviction_under_pressure(tmp_path):
    cache = DiskExtentCache(str(tmp_path / "dc"), max_bytes=3000)
    for i in range(3):
        cache.put(f"key{i}", 0, bytes(1000))
    assert cache.cache_stats()["usage_bytes"] == 3000
    cache.read("key0", 0, 1000)  # LRU touch: key0 becomes most-recent
    cache.put("key3", 0, bytes(1000))
    st = cache.cache_stats()
    assert st["usage_bytes"] <= 3000 and st["evictions"] >= 1
    assert cache.covers("key0", 0, 1000)  # recently-touched survived
    assert not cache.covers("key1", 0, 1000)  # LRU victim
    # an extent larger than the whole cap is served but never cached
    assert cache.put("huge", 0, bytes(4000)) is False
    # explicit clear
    freed = cache.evict(0)
    assert freed > 0 and cache.cache_stats()["usage_bytes"] == 0


def test_disk_cache_multi_extent_assembly(tmp_path):
    """Per-block fills (ANALYZE granularity) must serve a later coalesced
    multi-block read as one warm hit — and a gap must miss."""
    cache = DiskExtentCache(str(tmp_path / "dc"))
    blob = bytes(range(256)) * 32  # 8 KiB
    cache.put("k", 0, blob[:4096])
    cache.put("k", 4096, blob[4096:])
    assert cache.read("k", 0, 8192) == blob
    assert cache.read("k", 2048, 4096) == blob[2048:6144]
    cache2 = DiskExtentCache(str(tmp_path / "dc2"))
    cache2.put("k", 0, blob[:2048])
    cache2.put("k", 4096, blob[4096:])
    assert cache2.read("k", 0, 8192) is None  # hole at [2048, 4096)


def test_disk_cache_index_rebuilt_from_listing(tmp_path):
    root = str(tmp_path / "dc")
    cache = DiskExtentCache(root)
    cache.put("k", 0, bytes(2048))
    # a crash mid-fill leaves only an invisible temp file
    with open(os.path.join(root, "tmp", "fill-crash.tmp"), "wb") as f:
        f.write(bytes(512))
    reopened = DiskExtentCache(root)
    st = reopened.cache_stats()
    assert st["extents"] == 1 and st["usage_bytes"] == 2048
    assert reopened.read("k", 0, 2048) == bytes(2048)


def test_concurrent_readers_share_one_fill(tmp_path):
    cache = DiskExtentCache(str(tmp_path / "dc"))
    fetches = []
    barrier = threading.Barrier(8)
    results = []

    def fetch():
        fetches.append(1)
        return bytes(4096)

    def worker():
        barrier.wait()
        data, _ = cache.fill("k", 0, 4096, fetch)
        results.append(data)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(fetches) == 1  # single-flight: the backend saw one fetch
    assert all(r == bytes(4096) for r in results)


def test_concurrent_tiered_readers_no_double_fetch(tmp_path):
    """Two readers of the same remote model racing on the same cold
    range must produce exactly one remote data request between them."""
    sess, ids = _setup(tmp_path, "ws", remote=True)
    sess.evict_disk_cache(0)
    models = sess.snapshots.models
    store = models.remote_store(os.path.join(str(tmp_path / "ws"), "bucket"))
    r1 = models.open_model(ids[0])
    r2 = models.open_model(ids[0])
    before = store.counters()["requests"]
    barrier = threading.Barrier(2)
    out = {}

    def worker(tag, reader):
        barrier.wait()
        out[tag] = reader.read_range("layer0/w", 0, BS, "expert")

    t1 = threading.Thread(target=worker, args=("a", r1))
    t2 = threading.Thread(target=worker, args=("b", r2))
    t1.start(); t2.start(); t1.join(); t2.join()
    assert out["a"] == out["b"]
    assert store.counters()["requests"] - before == 1
    sess.close()


def test_failed_fill_waiter_becomes_filler(tmp_path):
    """When the in-flight filler dies on a remote fault, a waiter must
    retry the fill itself instead of hanging or erroring."""
    cache = DiskExtentCache(str(tmp_path / "dc"))
    gate = threading.Event()
    entered = threading.Event()

    def failing_fetch():
        entered.set()
        gate.wait(5)
        raise RemoteError("boom")

    def ok_fetch():
        return bytes(1024)

    errs = []

    def first():
        try:
            cache.fill("k", 0, 1024, failing_fetch)
        except RemoteError as e:
            errs.append(e)

    t1 = threading.Thread(target=first)
    t1.start()
    entered.wait(5)
    t2_result = []
    t2 = threading.Thread(
        target=lambda: t2_result.append(cache.fill("k", 0, 1024, ok_fetch))
    )
    t2.start()
    gate.set()
    t1.join(); t2.join()
    assert len(errs) == 1  # the original filler surfaced its fault
    assert t2_result[0] == (bytes(1024), True)  # waiter took over the fill


# ---------------------------------------------------------------- iostats
def test_total_expert_bytes_sums_every_tier():
    st = IOStats()
    st.record_read("expert", 10)
    st.record_read("expert_packed", 20)
    st.record_read("expert_remote", 30)
    st.record_read("expert_disk", 40)
    st.record_read("expert_repair", 5)
    st.record_read("base", 1000)  # never an expert category
    assert set(EXPERT_CATEGORIES) == {
        "expert", "expert_packed", "expert_remote", "expert_disk",
        "expert_repair",
    }
    assert st.total_expert_bytes == 105
    # the budget-enforced term counts cold moved bytes only (repair
    # refetches are cold moved bytes too — folded into executor slack)
    assert st.c_expert == 65
    d = st.delta_since(IOStats().snapshot())
    assert d["expert_read"] == 105
    assert d["expert_remote_read"] == 30 and d["expert_disk_read"] == 40
    assert d["expert_repair_read"] == 5


def test_cache_hit_miss_counters():
    st = IOStats()
    st.record_cache("ram", 100, hit=True)
    st.record_cache("ram", 50, hit=False)
    st.record_cache("disk", 25, hit=False)
    assert st.cache_counters("ram") == {
        "hits": 1, "hit_bytes": 100, "misses": 1, "miss_bytes": 50,
    }
    assert st.cache_counters("disk")["miss_bytes"] == 25
    snap = st.snapshot()
    assert snap["cache_hits"]["ram"]["bytes"] == 100
    st.reset()
    assert st.cache_counters("ram")["hits"] == 0


# ------------------------------------------------------------ tier billing
def test_tier_billing_admits_more_blocks_warm(tmp_path):
    """With tier-aware billing on, a warm disk tier makes remote experts
    nearly free to re-read, so the same fractional budget admits more
    blocks — while default billing keeps selections (and bytes)
    identical to flat local."""
    sess, ids = _setup(tmp_path, "ws", remote=True)
    res_default, _ = _merge(sess, ids, budget=0.4)
    sess.close()
    warm = Session(str(tmp_path / "ws"), block_size=BS, device="cpu")
    with measure(warm.stats) as io:
        res_billed, _ = _merge(warm, ids, budget=0.4, tier_billing=True)
    # budget soundness is asserted inside execute_merge (cold bytes vs
    # hat + slack) — reaching here means it held; billing must have
    # bought at least as many blocks as full-price planning
    assert (res_billed.stats["realized_expert_blocks"]
            >= res_default.stats["realized_expert_blocks"])
    assert io["expert_remote_read"] == 0  # warm: nothing actually cold
    warm.close()
