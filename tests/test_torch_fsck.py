"""The port's mergefsck (``repro_torch.store.fsck``) and block integrity
against the JAX package on the CPU, and the JAX package's own integrity
cases run on the port.

Against the JAX package: one workspace — models, a snapshot, experts
behind a remote bucket with a warm disk cache, and a packed layout — is
damaged at rest (a snapshot tensor, a disk-cache extent, packed extents,
an orphaned journal) and copied once for each package; a detecting pass
and then a repairing pass of each package's ``fsck`` count the same
findings and repairs, store by store, and leave the same exit code.
Then the port's ``merge_cli fsck --check`` exit code, and its service's
idle scrubber."""
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.api import MergeSpec as JaxMergeSpec  # noqa: E402
from repro.api import Session as JaxSession  # noqa: E402
from repro_torch.api import MergeSpec, Session  # noqa: E402
from repro_torch.launch import merge_cli  # noqa: E402
from repro_torch.store.integrity import CorruptBlockError, VerifyPolicy, block_hash  # noqa: E402
from repro_torch.store.iostats import IOStats  # noqa: E402
from repro_torch.store.tiered import DiskExtentCache  # noqa: E402
from repro_torch.testing.chaos import (  # noqa: E402
    CORRUPTION_MODES,
    corrupt_bytes,
    corrupt_file,
    inject_corruption,
)

from torch_locktrace import lock_tracer  # noqa: E402,F401
from torch_pair import assert_same_arrays, cast  # noqa: E402


BS = 4096
THETA = {"trim_frac": 0.3}


# ======================================================= against the JAX package
def _open(pkg, ws, recover=True):
    if pkg == "port":
        return Session(ws, block_size=BS, device="cpu", recover=recover)
    return JaxSession(ws, block_size=BS, recover=recover)


def _damaged_workspace(tmp_path, writer):
    """A workspace built by ``writer``, damaged at rest in every store
    mergefsck scrubs; returns its path."""
    ws = str(tmp_path / f"built-{writer}")
    port = writer == "port"
    sess = _open(writer, ws)
    base, experts = _fleet(k=3)
    sess.register_model("base", cast(base, "bfloat16", port))
    ids = []
    for i, ex in enumerate(experts):
        sess.register_model(f"e{i}", cast(ex, "bfloat16", port))
        ids.append(f"e{i}")
    sess.ensure_analyzed("base", ids)
    sess.repack(ids[:2], "base", layout_id="lay")
    sess.publish_model_remote("e2", os.path.join(ws, "bucket"),
                              profile={"latency_s": 0.0})
    spec = (MergeSpec if port else JaxMergeSpec).build(
        base="base", experts=ids, op="ties", theta=THETA, budget=0.5)
    sess.submit(spec, sid="snap")
    sess.run_all(prefer_packed=False)          # warms the disk cache
    sess.close()
    corrupt_file(sorted(glob.glob(os.path.join(
        ws, "models", "snap", "tensors", "*.bin")))[0], "bitflip")
    corrupt_file(sorted(glob.glob(os.path.join(
        ws, "diskcache", "**", "*.ext"), recursive=True))[0], "bitflip")
    _corrupt_every_block(os.path.join(ws, "packed", "lay", "extents.bin"))
    sess = _open(writer, ws, recover=False)
    with open(sess.snapshots.journal_path("snap"), "w") as f:
        f.write("{}\n")                          # an orphaned journal
    sess.close()
    return ws


def _findings(report):
    doc = report.to_dict()
    return {
        "stores": doc["stores"],
        "problems": sorted((p["store"], p["id"], p["kind"], p["repaired"])
                           for p in doc["problems"]),
        "exit_code": doc["exit_code"],
        "scrubbed_bytes": doc["scrubbed_bytes"],
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fsck_reports_agree_on_one_damaged_workspace(tmp_path, writer):
    ws = _damaged_workspace(tmp_path, writer)
    # the catalog holds absolute paths: each package gets a fresh copy of
    # the damaged workspace at the same place
    pristine = str(tmp_path / "pristine")
    shutil.copytree(ws, pristine)
    got = {}
    for pkg in ("jax", "port"):
        shutil.rmtree(ws)
        shutil.copytree(pristine, ws)
        # no recovery pass: it would remove the orphaned journal first
        sess = _open(pkg, ws, recover=False)
        check = _findings(sess.fsck(repair=False))
        repair = _findings(sess.fsck(repair=True))
        again = _findings(sess.fsck(repair=False))
        sess.close()
        got[pkg] = (check, repair, again)
    assert got["jax"] == got["port"]
    check, repair, again = got["port"]
    kinds = {k for _s, _i, k, _r in check["problems"]}
    assert check["exit_code"] == 1 and "corrupt-tensor" in kinds
    assert check["stores"]["packed"]["corrupt"] == 1
    # repair quarantines the packed extents (reads then fall back to the
    # flat source) and drops the cache extent (it refills from remote)
    packed = repair["stores"]["packed"]
    assert packed["repaired"] + packed["quarantined"] >= 1
    assert repair["stores"]["cache"]["repaired"] >= 1
    assert repair["stores"]["journals"]["repaired"] == 1
    # the snapshot has no second copy: it stays unrepaired in both
    assert again["exit_code"] == 1


def test_fsck_cli_exit_codes_and_merge_after_repair(tmp_path, capsys):
    """``merge_cli fsck --check`` exits 1 on the damaged workspace;
    ``fsck`` repairs what has a second copy (the packed extents are
    quarantined, the cache extent and the orphaned journal dropped) and
    still exits 1 for the snapshot; a packed merge afterwards is
    bit-equal to the JAX package's flat merge of the same models."""
    ws = _damaged_workspace(tmp_path, "port")
    with pytest.raises(SystemExit) as ei:
        merge_cli.main(["fsck", "--workspace", ws, "--check", "--device",
                        "cpu"])
    assert ei.value.code == 1
    assert "UNREPAIRED" in capsys.readouterr().out
    with pytest.raises(SystemExit) as ei:
        merge_cli.main(["fsck", "--workspace", ws, "--json", "--device",
                        "cpu"])
    assert ei.value.code == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["stores"]["cache"]["repaired"] >= 1
    assert os.path.exists(os.path.join(ws, "packed", "lay",
                                       "QUARANTINE.json"))
    sess = _open("port", ws)
    sess.submit(MergeSpec.build(base="base", experts=["e0", "e1"], op="ties",
                                theta=THETA, budget=0.5), sid="after")
    sess.run_all(prefer_packed="lay")
    assert sess.explain("after")["layout_id"] == "lay"
    got = sess.load("after")
    sess.close()
    ref = _open("jax", str(tmp_path / "ref"))
    base, experts = _fleet(k=3)
    ref.register_model("base", cast(base, "bfloat16", False))
    for i in range(2):
        ref.register_model(f"e{i}", cast(experts[i], "bfloat16", False))
    ref.ensure_analyzed("base", ["e0", "e1"])
    ref.submit(JaxMergeSpec.build(base="base", experts=["e0", "e1"],
                                  op="ties", theta=THETA, budget=0.5),
               sid="after")
    ref.run_all()
    assert_same_arrays(ref.load("after"), got)
    ref.close()


def test_idle_scrubber_finds_damage_and_traces_clean(tmp_path, lock_tracer):
    """The service's idle scrubber runs a repairing fsck between windows:
    on the damaged workspace it reports the damage it could not repair
    (the snapshot), under the port's lock-order tracer."""
    from repro_torch.api.service import MergeService

    ws = _damaged_workspace(tmp_path, "port")
    svc = MergeService(ws, block_size=BS, scrub_idle_s=0.05, poll_s=0.02,
                       device="cpu")
    try:
        deadline = time.time() + 10.0
        scrub = None
        while time.time() < deadline:
            scrub = svc.status()["scrub"]
            if scrub is not None:
                break
            time.sleep(0.05)
        assert scrub is not None, "idle scrubber never ran"
        assert "error" not in scrub and scrub["exit_code"] == 1
        packed = scrub["stores"]["packed"]
        # repaired by the first pass, found quarantined by any later one
        assert packed["repaired"] + packed["quarantined"] >= 1
    finally:
        svc.close()


# ============================================ the JAX package's own cases
def _fleet(k=2):
    rng = np.random.default_rng(7)
    shapes = {"layer0/w": (48, 64), "emb": (64, 32)}
    base = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    experts = []
    for i in range(k):
        r = np.random.default_rng(300 + i)
        experts.append({
            n: v + 0.02 * r.normal(size=v.shape).astype(np.float32)
            for n, v in base.items()
        })
    return base, experts


def _setup(tmp_path, name, remote=False, k=2):
    ws = str(tmp_path / name)
    sess = Session(ws, block_size=BS, stats=IOStats(debug=True),
                   device="cpu")
    base, experts = _fleet(k)
    sess.register_model("base", base)
    ids = []
    for i, ex in enumerate(experts):
        mid = f"e{i}"
        sess.register_model(mid, ex)
        if remote:
            sess.publish_model_remote(mid, os.path.join(ws, "bucket"))
        ids.append(mid)
    sess.ensure_analyzed("base", ids)
    return sess, ids


def _merge(sess, ids, sid=None, **run_kw):
    h = sess.submit(MergeSpec.build(
        base="base", experts=list(ids), op="ties", theta=THETA, budget=0.5,
    ), sid=sid)
    sess.run_all(**run_kw)
    return h.result, sess.load(h.result.sid)


def _golden(tmp_path):
    """Flat-local reference output for the deterministic fleet."""
    sess, ids = _setup(tmp_path, "golden")
    try:
        _res, arrays = _merge(sess, ids)
        return arrays
    finally:
        sess.stats.self_check()
        sess.close()


def _assert_identical(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def _corrupt_every_block(path, block_size=BS):
    """Flip one byte in every block-sized stripe of a file, so damage is
    visible no matter which blocks the budget selects."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    for off in range(0, len(buf), block_size):
        buf[off] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(buf))


# ================================================== corruption primitives
def test_corrupt_bytes_modes():
    data = bytes(range(64))
    flipped = corrupt_bytes(data, "bitflip")
    assert len(flipped) == len(data) and flipped != data
    short = corrupt_bytes(data, "truncate")
    assert len(short) < len(data)
    prev = bytes(64)
    stale = corrupt_bytes(data, "stale", prev=prev)
    assert len(stale) == len(data) and stale == prev
    # stale without a prior payload degrades to a bit-flip
    assert corrupt_bytes(data, "stale") != data


def test_block_hash_matches_analyze_contract(tmp_path):
    sess, ids = _setup(tmp_path, "hashes")
    try:
        rows = sess.catalog.block_metas("e0", BS)
        assert rows, "ANALYZE recorded no block hashes"
        reader = sess.snapshots.models.open_model("e0")
        try:
            tensor_id, block_idx, _nb, want = rows[0][:4]
            arr = reader.read_block(tensor_id, block_idx, BS, "other")
            assert block_hash(np.ascontiguousarray(arr).tobytes()) == want
        finally:
            reader.close()
    finally:
        sess.close()


# ========================================= remote GET corruption -> repair
@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_remote_get_corruption_read_repaired_bit_identical(tmp_path, mode):
    want = _golden(tmp_path)
    sess, ids = _setup(tmp_path, f"rm-{mode}", remote=True)
    try:
        sess.evict_disk_cache(0)  # analysis warmed the cache: force GETs
        with inject_corruption("remote:get", mode=mode, skip=1) as inj:
            res, got = _merge(sess, ids)
        assert inj.fired, "no remote GET was corrupted"
        _assert_identical(got, want)
        v = res.stats["verify"]
        assert v["corrupt_blocks"] >= 1
        assert v["repaired_blocks"] >= 1
        assert v["repair_bytes"] > 0
        # repair traffic is billed to its own category
        assert sess.stats.bytes_read("expert_repair") > 0
        sess.stats.self_check()
    finally:
        sess.close()


def test_repair_billing_never_double_counts_remote(tmp_path):
    """The corrupt GET's own bytes stay billed as the cold fetch they
    were; only the *refetch* lands in expert_repair — so expert_remote
    is identical to an uncorrupted run of the same plan."""
    clean_sess, ids = _setup(tmp_path, "bill-clean", remote=True)
    try:
        clean_sess.evict_disk_cache(0)
        clean_res, _ = _merge(clean_sess, ids)
        clean_remote = clean_sess.stats.bytes_read("expert_remote")
        assert clean_sess.stats.bytes_read("expert_repair") == 0
        assert "verify" in clean_res.stats
        assert clean_res.stats["verify"]["corrupt_blocks"] == 0
        clean_sess.stats.self_check()
    finally:
        clean_sess.close()

    sess, ids = _setup(tmp_path, "bill-corrupt", remote=True)
    try:
        sess.evict_disk_cache(0)
        with inject_corruption("remote:get", mode="bitflip", skip=1):
            res, _ = _merge(sess, ids)
        assert sess.stats.bytes_read("expert_remote") == clean_remote
        repair = sess.stats.bytes_read("expert_repair")
        assert repair > 0
        assert repair == res.stats["verify"]["repair_bytes"]
        sess.stats.self_check()
    finally:
        sess.close()


# =============================================== disk-cache extent rot
def test_cache_extent_rot_at_fill_detected_on_next_read(tmp_path):
    """cache:extent corruption lands in the file at fill time (the
    filler's caller still gets clean bytes); the next run's verified
    hit catches the rot, evicts, and refills as repair traffic."""
    want = _golden(tmp_path)
    sess, ids = _setup(tmp_path, "cache-rot", remote=True)
    try:
        sess.evict_disk_cache(0)  # force the merge itself to fill the cache
        with inject_corruption("cache:extent", mode="bitflip", skip=2) as inj:
            _res1, got1 = _merge(sess, ids, sid="first")
        assert inj.fired
        _assert_identical(got1, want)  # filler returned clean bytes

        before = sess.snapshots.disk_cache.corrupt_dropped
        res2, got2 = _merge(sess, ids, sid="second")
        _assert_identical(got2, want)
        assert sess.snapshots.disk_cache.corrupt_dropped > before
        assert sess.stats.bytes_read("expert_repair") > 0
        assert res2.stats["verify"]["repair_bytes"] > 0
        sess.stats.self_check()
    finally:
        sess.close()


def test_cache_extent_rot_at_rest_detected_on_hit(tmp_path):
    want = _golden(tmp_path)
    sess, ids = _setup(tmp_path, "cache-rest", remote=True)
    try:
        _merge(sess, ids, sid="warm")  # fill the cache clean
        ext_files = glob.glob(
            os.path.join(str(tmp_path / "cache-rest"), "diskcache",
                         "**", "*.ext"),
            recursive=True,
        )
        assert ext_files
        for path in ext_files:  # rot every extent: detection is certain
            corrupt_file(path, "bitflip")
        res, got = _merge(sess, ids, sid="after-rot")
        _assert_identical(got, want)
        assert sess.snapshots.disk_cache.corrupt_dropped >= 1
        assert res.stats["verify"]["repair_bytes"] > 0
        sess.stats.self_check()
    finally:
        sess.close()


def test_cache_rebuild_drops_wrong_length_files(tmp_path):
    """The rebuild must not trust filenames — a truncated
    extent file is dropped at index rebuild instead of being served."""
    root = str(tmp_path / "dc")
    cache = DiskExtentCache(root)
    payload = bytes(range(256)) * 4
    cache.put("model/t.bin", 0, payload)
    assert cache.read("model/t.bin", 0, len(payload)) == payload
    path = glob.glob(os.path.join(root, "**", "*.ext"), recursive=True)[0]
    with open(path, "r+b") as f:
        f.truncate(len(payload) // 2)
    rebuilt = DiskExtentCache(root)
    assert rebuilt.read("model/t.bin", 0, len(payload)) is None
    assert rebuilt.corrupt_dropped == 1
    assert not os.path.exists(path)


def test_cache_legacy_three_part_names_still_served(tmp_path):
    root = str(tmp_path / "dc-legacy")
    cache = DiskExtentCache(root)
    payload = b"\x5a" * 2048
    cache.put("m/t.bin", 4096, payload)
    path = glob.glob(os.path.join(root, "**", "*.ext"), recursive=True)[0]
    base = os.path.basename(path)
    kh, off, nbytes, _digest = base[:-len(".ext")].split("__")
    legacy = os.path.join(os.path.dirname(path), f"{kh}__{off}__{nbytes}.ext")
    os.rename(path, legacy)
    reopened = DiskExtentCache(root)
    assert reopened.read("m/t.bin", 4096, 2048) == payload
    # length validation still applies to digest-less names
    with open(legacy, "r+b") as f:
        f.truncate(100)
    again = DiskExtentCache(root)
    assert again.read("m/t.bin", 4096, 2048) is None


# ============================================ packed extent -> quarantine
def test_packed_corruption_quarantines_and_falls_back_flat(tmp_path):
    want = _golden(tmp_path)
    sess, ids = _setup(tmp_path, "packed")
    try:
        rep = sess.repack(ids, "base", layout_id="lay")
        assert rep["lossless"]
        with inject_corruption("packed:extent", mode="bitflip") as inj:
            res, got = _merge(sess, ids, prefer_packed="lay")
        assert inj.fired
        _assert_identical(got, want)
        qpath = os.path.join(
            str(tmp_path / "packed"), "packed", "lay", "QUARANTINE.json"
        )
        with open(qpath) as f:
            qdoc = json.load(f)
        assert qdoc["extents"], "corrupt extent was not quarantined"
        assert sess.stats.bytes_read("expert_repair") > 0
        assert res.stats["verify"]["repair_bytes"] > 0

        # quarantine is durable: a fresh open skips the extent and the
        # merge stays bit-identical without another corruption event
        res2, got2 = _merge(sess, ids, sid="again", prefer_packed="lay")
        _assert_identical(got2, want)
        assert res2.sid == "again"
        sess.stats.self_check()
    finally:
        sess.close()


# ====================================== unrepairable -> job fails, no lie
def test_persistently_corrupt_remote_fails_job_without_residue(tmp_path):
    sess, ids = _setup(tmp_path, "poison", remote=True)
    try:
        sess.evict_disk_cache(0)  # analysis warmed the cache with clean bytes
        for obj in glob.glob(os.path.join(
            str(tmp_path / "poison"), "bucket", "e0", "**", "*.bin"
        ), recursive=True):
            _corrupt_every_block(obj)  # rot at the source: refetch can't help
        with pytest.raises(RuntimeError, match="quarantined after") as ei:
            _merge(sess, ids, sid="doomed")
        # bounded retries, then a hard failure with the typed corruption
        # provenance chained on — never a silent wrong answer
        cause = ei.value.__cause__
        assert isinstance(cause, CorruptBlockError)
        assert cause.tier == "remote"
        assert "doomed" not in sess.list_snapshots()
        assert not sess.snapshots.models.exists("doomed")
        sess.stats.self_check()
    finally:
        sess.close()


def test_flat_local_rot_detected_with_flat_policy(tmp_path):
    sess, ids = _setup(tmp_path, "flat-rot")
    try:
        for tensor in glob.glob(os.path.join(
            str(tmp_path / "flat-rot"), "models", "e0", "tensors", "*.bin"
        )):
            _corrupt_every_block(tensor)
        with pytest.raises(RuntimeError, match="quarantined after") as ei:
            _merge(sess, ids, verify=VerifyPolicy(flat=True))
        cause = ei.value.__cause__
        assert isinstance(cause, CorruptBlockError)
        assert cause.tier == "flat"
        sess.stats.self_check()
    finally:
        sess.close()


def test_verify_opt_out_skips_hashing(tmp_path):
    sess, ids = _setup(tmp_path, "optout")
    try:
        res, _ = _merge(sess, ids, verify=False)
        assert "verify" not in res.stats
        res2, _ = _merge(sess, ids, sid="on", verify=True)
        assert res2.stats["verify"]["verified_blocks"] > 0
        assert res2.stats["verify"]["corrupt_blocks"] == 0
        # tier-scoped opt-out: flat disabled -> nothing verified locally
        res3, _ = _merge(
            sess, ids, sid="scoped",
            verify=VerifyPolicy(flat=False, remote=True, packed=True),
        )
        assert res3.stats["verify"]["verified_blocks"] == 0
        sess.stats.self_check()
    finally:
        sess.close()


# ================================================================ fsck
def test_fsck_clean_workspace_is_clean(tmp_path):
    sess, ids = _setup(tmp_path, "fsck-clean")
    try:
        _merge(sess, ids, sid="snap")
        report = sess.fsck(repair=True)
        assert report.exit_code() == 0
        doc = report.to_dict()
        assert doc["clean"]
        assert doc["stores"]["models"]["verified"] >= 3  # base, e0, e1, snap
        assert doc["stores"]["snapshots"]["verified"] == 1
    finally:
        sess.close()


def test_fsck_detects_corrupt_snapshot_tensor(tmp_path):
    sess, ids = _setup(tmp_path, "fsck-snap")
    try:
        res, _ = _merge(sess, ids, sid="snap")
        tensor = sorted(glob.glob(os.path.join(
            str(tmp_path / "fsck-snap"), "models", res.sid, "tensors", "*.bin"
        )))[0]
        corrupt_file(tensor, "bitflip")
        report = sess.fsck(repair=True)
        assert report.exit_code() == 1  # no redundant copy: unrepairable
        kinds = {p["kind"] for p in report.unrepaired}
        assert "corrupt-tensor" in kinds
        assert report.to_dict()["stores"]["models"]["corrupt"] >= 1
    finally:
        sess.close()


def test_fsck_repairs_cache_journals_and_packed(tmp_path):
    sess, ids = _setup(tmp_path, "fsck-fix", remote=True)
    try:
        _merge(sess, ids, sid="snap")  # warm cache + published snapshot
        ws = str(tmp_path / "fsck-fix")
        # 1. rot a cached extent at rest
        ext = sorted(glob.glob(
            os.path.join(ws, "diskcache", "**", "*.ext"), recursive=True
        ))[0]
        corrupt_file(ext, "bitflip")
        # 2. plant an orphaned journal for the already-published sid
        jpath = sess.snapshots.journal_path("snap")
        with open(jpath, "w") as f:
            f.write("{}\n")
        report = sess.fsck(repair=True)
        doc = report.to_dict()
        assert doc["stores"]["cache"]["repaired"] >= 1
        assert doc["stores"]["journals"]["repaired"] == 1
        assert not os.path.exists(jpath)
        assert report.exit_code() == 0  # everything found was repairable
        # detection-only pass is idempotent and clean afterwards
        assert sess.fsck(repair=False).exit_code() == 0
    finally:
        sess.close()


def test_fsck_quarantines_packed_extent_and_merge_survives(tmp_path):
    want = _golden(tmp_path)
    sess, ids = _setup(tmp_path, "fsck-packed")
    try:
        sess.repack(ids, "base", layout_id="lay")
        extents_bin = os.path.join(
            str(tmp_path / "fsck-packed"), "packed", "lay", "extents.bin"
        )
        corrupt_file(extents_bin, "bitflip")
        report = sess.fsck(repair=True)
        doc = report.to_dict()
        assert doc["stores"]["packed"]["corrupt"] >= 1
        assert doc["stores"]["packed"]["repaired"] >= 1
        assert report.exit_code() == 0
        # the quarantined layout still serves bit-identical merges
        _res, got = _merge(sess, ids, prefer_packed="lay")
        _assert_identical(got, want)
        sess.stats.self_check()
    finally:
        sess.close()


def test_fsck_cli_check_and_repair(tmp_path, capsys):
    from repro_torch.launch.merge_cli import _cmd_fsck

    sess, ids = _setup(tmp_path, "fsck-cli")
    res, _ = _merge(sess, ids, sid="snap")
    ws = str(tmp_path / "fsck-cli")
    sess.close()

    _cmd_fsck(["--workspace", ws, "--check", "--json", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] and doc["exit_code"] == 0

    tensor = sorted(glob.glob(os.path.join(
        ws, "models", "snap", "tensors", "*.bin"
    )))[0]
    corrupt_file(tensor, "bitflip")
    with pytest.raises(SystemExit) as ei:
        _cmd_fsck(["--workspace", ws, "--check", "--device", "cpu"])
    assert ei.value.code == 1
    out = capsys.readouterr().out
    assert "UNREPAIRED" in out


def test_service_idle_scrubber_reports(tmp_path):
    from repro_torch.api.service import MergeService

    ws = str(tmp_path / "scrub")
    base, experts = _fleet()
    boot = Session(ws, block_size=BS, device="cpu")
    boot.register_model("base", base)
    boot.register_model("e0", experts[0])
    boot.close()

    svc = MergeService(ws, block_size=BS, scrub_idle_s=0.05, poll_s=0.02,
                       device="cpu")
    try:
        deadline = time.time() + 10.0
        while time.time() < deadline:
            scrub = svc.status()["scrub"]
            if scrub is not None:
                break
            time.sleep(0.05)
        assert scrub is not None, "idle scrubber never ran"
        assert "error" not in scrub
        assert scrub["exit_code"] == 0
        assert scrub["stores"]["models"]["verified"] >= 2
    finally:
        svc.close()
