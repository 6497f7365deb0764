"""The port's shard workers (``repro_torch.dist``) against the JAX
package's (``repro.dist``) on the CPU: the same models in one workspace
per package, every operator x model kind x store (flat, packed,
tiered/remote) at 2 and 4 workers through the inline transport: the
published bytes equal to the reference's sharded run and to the port's
stream engine, per-category IOStats equal to the reference's, equal
partitions, the per-worker byte bound; recovery at each worker death
point with the crash spend in [hat, 2*hat); the lease-exhaustion abort
and the zero-selection window as the reference's.  A few runs take the
process transport (``python -m repro_torch.launch.worker``): a
bit-identical window, a crash re-issued after exit 3, and a lease naming
a card that is not there, which must abort the window.  The CLI's
``shards`` and ``worker`` subcommands run on the CPU."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import MergeSpec as JaxSpec  # noqa: E402
from repro.api import Session as JaxSession  # noqa: E402
from repro.core.planner import plan_merge as jax_plan_merge  # noqa: E402
from repro.dist import DistOptions as JaxDist  # noqa: E402
from repro.dist.partition import partition_plan as jax_partition  # noqa: E402
from repro.store.iostats import measure as jax_measure  # noqa: E402
from repro_torch.api import MergeSpec, Session  # noqa: E402
from repro_torch.core.planner import plan_merge  # noqa: E402
from repro_torch.dist import DistOptions, WorkerExit, transport  # noqa: E402
from repro_torch.dist import coordinator  # noqa: E402
from repro_torch.dist.partition import partition_plan  # noqa: E402
from repro_torch.launch import merge_cli  # noqa: E402
from repro_torch.store.iostats import measure  # noqa: E402

from conftest import make_models  # noqa: E402

BS = 4096
OPS = [("avg", {}), ("ta", {"lam": 0.5}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 7})]
OP_IDS = [op for op, _ in OPS]
IDS = ["ex0", "ex1", "ex2"]
#: every byte category a merge moves (tiers apart), checked for equality
IO = ("base_read", "expert_read", "expert_packed_read", "expert_remote_read",
      "expert_disk_read", "expert_repair_read", "out_written", "waste_read")


class Pair:
    """The same models in a JAX workspace and a port workspace (device
    "cpu"), the same merges run in both in the same order."""

    def __init__(self, root, kind, store):
        base, experts = make_models(n_experts=len(IDS))
        self.sess = {"jax": JaxSession(str(root / "jax"), block_size=BS),
                     "port": Session(str(root / "port"), block_size=BS,
                                     device="cpu")}
        self.spec = {"jax": JaxSpec, "port": MergeSpec}
        self.measure = {"jax": jax_measure, "port": measure}
        self.dist = {"jax": JaxDist, "port": DistOptions}
        self.streams = {}
        for pkg, sess in self.sess.items():
            sess.register_model("base", base)
            for mid, e in zip(IDS, experts):
                if kind == "delta":
                    e = {k: v - base[k] for k, v in e.items()}
                sess.register_model(mid, e, kind=kind)
            if store == "packed":
                sess.repack(IDS, "base")
            elif store == "remote":
                for mid in IDS:
                    sess.publish_model_remote(
                        mid, str(root / f"bucket-{pkg}"),
                        profile={"latency_s": 1e-4, "mbps": 500})

    def run(self, pkg, sid, op, theta, budget="60%", **kw):
        """One merge in one package: its result and bytes by category."""
        sess = self.sess[pkg]
        sess.submit(self.spec[pkg].build("base", IDS, op=op, theta=dict(theta),
                                         budget=budget), sid=sid)
        with self.measure[pkg](sess.stats) as io:
            res = sess.run_all(**kw)[0]
        return res, dict(io)

    def both(self, sid, op, theta, dist=None, **kw):
        """The merge in both packages (``dist``: DistOptions kwargs)."""
        out = {}
        for pkg in ("jax", "port"):
            extra = dict(kw)
            if dist is not None:
                extra["dist"] = self.dist[pkg](**dist)
            out[pkg] = self.run(pkg, sid, op, theta, **extra)
        return out

    def stream(self, op, theta):
        """The stream engine's run of ``op`` in both packages (once)."""
        if op not in self.streams:
            self.both(f"{op}-stream", op, theta, compute="stream")
            self.streams[op] = f"{op}-stream"
        return self.streams[op]

    def load(self, pkg, sid):
        return {t: a.view(np.uint8)
                for t, a in self.sess[pkg].load(sid).items()}

    def close(self):
        for sess in self.sess.values():
            sess.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}

    def get(kind="full", store="flat"):
        if (kind, store) not in made:
            made[kind, store] = Pair(
                tmp_path_factory.mktemp(f"{kind}-{store}"), kind, store)
        return made[kind, store]

    yield get
    for p in made.values():
        p.close()


def _same(a, b):
    assert set(a) == set(b)
    for t in a:
        assert np.array_equal(a[t], b[t]), t


def _no_residue(sess):
    shards = os.path.join(sess.snapshots.staging_root, "shards")
    assert not os.path.isdir(shards) or not os.listdir(shards)
    jroot = os.path.join(sess.snapshots.journal_root, "shards")
    assert not os.path.isdir(jroot) or not os.listdir(jroot)


def _shard(res, k):
    return next(s for s in res.stats["shards"] if s["shard"] == k)


# ------------------------------------ operators x kinds x stores x workers
@pytest.mark.parametrize("n_workers", [2, 4])
@pytest.mark.parametrize("store", ["flat", "packed", "remote"])
@pytest.mark.parametrize("kind", ["full", "delta"])
@pytest.mark.parametrize("op,theta", OPS, ids=OP_IDS)
def test_sharded_matches_reference(pairs, op, theta, kind, store, n_workers):
    """Bit-identical to the reference's sharded run and to the port's
    stream engine, equal bytes by category and partitions; each worker
    within ceil(hat / n) + K blocks and within its shard budget."""
    pair = pairs(kind, store)
    stream = pair.stream(op, theta)
    sid = f"{op}-w{n_workers}"
    got = pair.both(sid, op, theta,
                    dist={"n_workers": n_workers, "transport": "inline"})
    (j, j_io), (p, p_io) = got["jax"], got["port"]
    port = pair.load("port", sid)
    _same(port, pair.load("jax", sid))
    _same(port, pair.load("port", stream))
    assert {c: p_io[c] for c in IO} == {c: j_io[c] for c in IO}
    assert p.manifest["layout_id"] is None if store != "packed" else (
        p.manifest["layout_id"] is not None)
    assert p.stats["partition"] == j.stats["partition"]
    for key in ("c_expert_run", "c_expert_hat", "realized_expert_blocks",
                "n_workers", "reissued"):
        assert p.stats[key] == j.stats[key], key
    assert p.stats["kernel"] == "torch" and j.stats["kernel"] == "numpy"
    assert all(s["device"] == "cpu" for s in p.stats["shards"])
    total = p.stats["partition"]["total_expert_bytes"]
    cap = -(-total // n_workers) + len(IDS) * BS
    budgets = {s["shard"]: s["budget"] for s in p.stats["partition"]["shards"]}
    for sh in p.stats["shards"]:
        assert sh["realized_expert_bytes"] <= cap, sh
        assert sh["realized_expert_bytes"] <= budgets[sh["shard"]], sh
    _no_residue(pair.sess["port"])


# --------------------------------------------------------------- partitions
@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("align", ["block", "tensor"])
@pytest.mark.parametrize("store", ["flat", "packed"])
def test_partition_matches_reference(pairs, store, align, n):
    """partition_plan of the same plan gives the reference's spans,
    expert bytes and budgets (packed: extents billed once a shard)."""
    pair = pairs("full", store)
    parts = {}
    for pkg, plan_fn, part_fn in (("jax", jax_plan_merge, jax_partition),
                                  ("port", plan_merge, partition_plan)):
        sess = pair.sess[pkg]
        layout = sess.list_layouts()[-1] if store == "packed" else None
        pr = plan_fn(sess.catalog, "base", IDS, "ties",
                     theta={"trim_frac": 0.3}, budget_b=60_000,
                     block_size=BS, reuse=False, layout_id=layout)
        part = part_fn(pr.plan, sess.catalog, n, align=align)
        parts[pkg] = (
            [(s.shard, s.spans, s.expert_bytes, s.budget, s.n_blocks)
             for s in part.shards],
            part.total_expert_bytes, part.duplicate_extent_bytes, part.order)
    assert parts["port"] == parts["jax"]
    shards, total, _dup, order = parts["port"]
    assert sum(s[4] for s in shards) == sum(nb for _t, nb in order)
    assert total > 0


# ----------------------------------------------------------------- recovery
@pytest.mark.parametrize("point,skip", [
    ("worker:lease", 0),   # dies before any I/O: successor restarts cold
    ("worker:block", 2),   # dies mid-region: successor resumes the journal
    ("worker:commit", 0),  # dies after all I/O: successor re-validates
])
def test_worker_death_recovers_like_reference(pairs, point, skip):
    """A worker killed at each death point (inline transport: the dead
    attempt's reads are salvaged) is re-issued once, resumes as the
    reference's does, lands bit-identical, and the window's expert spend
    lies in [hat, 2*hat)."""
    pair = pairs()
    stream = pair.stream("ties", {"trim_frac": 0.3})
    sid = "crash-" + point.split(":")[1]
    got = pair.both(sid, "ties", {"trim_frac": 0.3}, dist={
        "n_workers": 2, "transport": "inline",
        "chaos": {"point": point, "skip": skip, "shard": 0}})
    (j, j_io), (p, p_io) = got["jax"], got["port"]
    _same(pair.load("port", sid), pair.load("port", stream))
    _same(pair.load("port", sid), pair.load("jax", sid))
    assert p.stats["reissued"] == j.stats["reissued"] == 1
    assert _shard(p, 0)["attempts"] == 2
    assert _shard(p, 0)["resumed_blocks"] == _shard(j, 0)["resumed_blocks"]
    if point == "worker:block":
        assert _shard(p, 0)["resumed_blocks"] > 0
    hat, spent = p.stats["c_expert_hat"], p.stats["c_expert_run"]
    assert hat <= spent < 2 * hat, (hat, spent)
    assert spent == j.stats["c_expert_run"]
    assert {c: p_io[c] for c in IO} == {c: j_io[c] for c in IO}
    _no_residue(pair.sess["port"])


def test_lease_exhaustion_aborts_window_like_reference(pairs):
    """A shard that dies on its only allowed attempt fails the window in
    both packages: nothing published, no shard residue.  (Its own
    workspaces: a failed job stays queued in its Session.)"""
    pair = pairs(store="flat, aborted")
    for pkg in ("jax", "port"):
        with pytest.raises(RuntimeError, match="attempt"):
            pair.run(pkg, "exhausted", "ties", {"trim_frac": 0.3},
                     dist=pair.dist[pkg](
                         n_workers=2, transport="inline", max_lease_attempts=1,
                         chaos={"point": "worker:block", "skip": 1,
                                "shard": 0}))
        assert "exhausted" not in pair.sess[pkg].list_snapshots()
        _no_residue(pair.sess[pkg])


def test_zero_selection_window_like_reference(pairs):
    """A 1-byte budget selects nothing: the workers pass the base through
    (an even block split), as the reference's do, bit-identical."""
    pair = pairs()
    got = pair.both("zero-w3", "ties", {"trim_frac": 0.3}, budget=1,
                    dist={"n_workers": 3, "transport": "inline"})
    (j, _), (p, _) = got["jax"], got["port"]
    assert p.stats["c_expert_run"] == j.stats["c_expert_run"] == 0
    assert p.stats["partition"] == j.stats["partition"]
    counts = [s["n_blocks"] for s in p.stats["partition"]["shards"]]
    assert max(counts) - min(counts) <= 1
    base = {t: a.view(np.uint8) for t, a in pair.sess["port"].load("base").items()}
    _same(pair.load("port", "zero-w3"), base)
    _same(pair.load("port", "zero-w3"), pair.load("jax", "zero-w3"))


# --------------------------------------------------------- process workers
def _port_ws(tmp_path):
    sess = Session(str(tmp_path / "ws"), block_size=BS, device="cpu")
    base, experts = make_models(n_experts=len(IDS))
    sess.register_model("base", base)
    for mid, e in zip(IDS, experts):
        sess.register_model(mid, e)
    return sess


def _merge(sess, sid, **kw):
    sess.submit(MergeSpec.build("base", IDS, op="ties",
                                theta={"trim_frac": 0.3}, budget="60%"),
                sid=sid)
    return sess.run_all(**kw)[0]


def test_process_workers_bit_identical(tmp_path):
    """Two ``python -m repro_torch.launch.worker`` processes on the CPU:
    bit-identical to the stream engine, the run documented (transport,
    kernel, device, one attempt a shard), no staging residue."""
    sess = _port_ws(tmp_path)
    _merge(sess, "local", compute="stream")
    r = _merge(sess, "shard", dist=DistOptions(n_workers=2))
    st = r.stats
    assert st["execution"] == "sharded" and st["transport"] == "process"
    assert st["kernel"] == "torch" and st["reissued"] == 0
    assert [s["attempts"] for s in st["shards"]] == [1, 1]
    assert all(s["device"] == "cpu" and s["first_block_at"] >= s["started_at"]
               for s in st["shards"])
    assert r.manifest["execution"] == "sharded"
    assert st["c_expert_run"] == st["c_expert_hat"]
    _same(sess.load("local"), sess.load("shard"))
    _no_residue(sess)
    sess.close()


def test_process_worker_crash_exits_3_and_is_reissued(tmp_path, monkeypatch):
    """A worker process killed mid-region (chaos in its lease) exits 3;
    its lease is re-issued once and the successor resumes its journal."""
    seen = []
    poll = transport._ProcessHandle.poll

    def recording_poll(self):
        ex = poll(self)
        if ex is not None:
            seen.append((ex.shard, ex.attempt, ex.ok, ex.crashed, ex.detail,
                         self.proc.returncode))
        return ex

    monkeypatch.setattr(transport._ProcessHandle, "poll", recording_poll)
    sess = _port_ws(tmp_path)
    _merge(sess, "local", compute="stream")
    r = _merge(sess, "shard", dist=DistOptions(n_workers=2, chaos={
        "point": "worker:block", "skip": 2, "shard": 1}))
    dead = [s for s in seen if not s[2]]
    assert len(dead) == 1 and dead[0][:4] == (1, 1, False, True)
    assert dead[0][5] == transport.CRASH_EXIT == 3
    assert "simulated crash" in dead[0][4]
    assert r.stats["reissued"] == 1
    assert _shard(r, 1)["attempts"] == 2 and _shard(r, 1)["resumed_blocks"] > 0
    _same(sess.load("local"), sess.load("shard"))
    _no_residue(sess)
    sess.close()


def test_cuda_lease_without_a_card_aborts_the_window(tmp_path):
    """A lease naming "cuda" where there is no card: the worker process
    raises through resolve_device (neither exit 0 nor the crash code
    3), and the coordinator aborts the window with its message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the lease would run on it")
    sess = _port_ws(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device requested") as info:
        _merge(sess, "shard", dist=DistOptions(n_workers=2, device="cuda"))
    assert "failed: worker exited 1" in str(info.value)
    assert "shard" not in sess.list_snapshots()
    _no_residue(sess)
    sess.close()


# --------------------------------------------------------------------- CLI
def test_cli_shards_and_worker(tmp_path, monkeypatch, capsys):
    """``merge_cli shards --device cpu`` prints the partition a sharded
    run leases out (the reference's for the same plan inputs), and
    ``merge_cli worker --device cpu`` runs a lease that names the card:
    the window, every worker through the CLI, lands bit-identical."""
    from repro.launch import merge_cli as jax_cli

    sess = _port_ws(tmp_path)
    jws = JaxSession(str(tmp_path / "jax"), block_size=BS)
    base, experts = make_models(n_experts=len(IDS))
    jws.register_model("base", base)
    for mid, e in zip(IDS, experts):
        jws.register_model(mid, e)
    jws.close()
    args = ["--base", "base", "--experts", *IDS, "--op", "ties",
            "--budget", "60%", "--theta", "trim_frac=0.3", "--block-size",
            str(BS), "--n-workers", "3", "--json"]
    monkeypatch.setattr("sys.argv", ["merge_cli", "shards", "--workspace",
                                     str(tmp_path / "jax"), *args])
    jax_cli.main()
    docs = [json.loads(capsys.readouterr().out)]
    merge_cli.main(["shards", "--workspace", str(tmp_path / "ws"), *args,
                    "--device", "cpu"])
    docs.append(json.loads(capsys.readouterr().out))
    for doc in docs:
        doc.pop("plan_id")
    assert docs[0] == docs[1] and len(docs[0]["shards"]) == 3

    class CliTransport:
        """Each lease through ``merge_cli worker --device cpu``."""

        def launch(self, workspace, lease, ctl_dir):
            assert lease.device == "cuda"
            os.makedirs(ctl_dir, exist_ok=True)
            tag = os.path.join(ctl_dir, f"shard{lease.shard}")
            lease.write(tag + ".lease.json")
            with pytest.raises(SystemExit) as done:
                merge_cli.main(["worker", "--workspace", workspace, "--lease",
                                tag + ".lease.json", "--result",
                                tag + ".result.json", "--device", "cpu"])
            assert done.value.code == 0
            with open(tag + ".result.json") as f:
                doc = json.load(f)
            return transport._InlineHandle(WorkerExit(
                lease.shard, lease.attempt, ok=True, crashed=False,
                result=doc))

    monkeypatch.setattr(coordinator, "make_transport",
                        lambda name: CliTransport())
    _merge(sess, "local", compute="stream")
    r = _merge(sess, "cli", dist=DistOptions(n_workers=2, device="cuda"))
    assert [s["device"] for s in r.stats["shards"]] == ["cpu", "cpu"]
    _same(sess.load("local"), sess.load("cli"))
    sess.close()
