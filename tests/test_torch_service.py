"""The port's v2 entry points against the JAX package on the CPU: a spec
batch with a nested merge graph and a shared budget through the port's
``Session.run_all`` and ``MergeService`` (device "cpu") against the JAX
``Session``: bit-identical snapshots, equal per-category I/O, equal plan
selections and lineage; JSON spec files (YAML refused); the port's
``merge_cli`` spool (submit / serve --once / status / cancel) and a
one-shot run; workspaces shared both ways; and the service's handling of
a kernel failure and of unported options."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.api import MergeSpec as JaxSpec  # noqa: E402
from repro.api import Session as JaxSession  # noqa: E402
from repro.store.iostats import measure as jax_measure  # noqa: E402
from repro_torch.api import (  # noqa: E402
    JobState,
    MergeService,
    MergeSpec,
    Session,
    load_spec_file,
)
from repro_torch.launch import merge_cli  # noqa: E402
from repro_torch.store.iostats import measure  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
BLOCK = 4096
# parameter bytes exactly; meta within the width of the timestamps the
# catalog rows and manifests carry (as tests/test_service.py:86-90)
IO = ("base_read", "expert_read", "out_written")
META_SLACK = 32


def _arrays(seed=0):
    """bf16 base and three full experts (ml_dtypes: the JAX form)."""
    rng = np.random.default_rng(seed)
    shapes = {"l0/w": (64, 96), "l0/b": (96,), "emb": (128, 32),
              "l1/w": (40, 70)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    out = {"base": {k: v.astype(BF16) for k, v in base.items()}}
    for e in range(3):
        out[f"e{e}"] = {k: (v + 0.02 * rng.normal(size=v.shape)).astype(BF16)
                        for k, v in base.items()}
    return out


def _register(target, arrays, port):
    for name, a in arrays.items():
        target.register_model(name, {k: v.view(np.uint16) if port else v
                                     for k, v in a.items()})


def _specs(S):
    """Two jobs over shared experts and a named two-level graph."""
    child = S.build("base", ["e1", "e2"], op="ties",
                    theta={"trim_frac": 0.3}, budget="60%", name="j-child")
    return [
        S.build("base", ["e0", "e1", "e2"], op="dare",
                theta={"density": 0.5, "seed": 3}, budget="50%", name="j-dare"),
        S.build("base", ["e0", "e1"], op="avg", budget="70%", name="j-avg"),
        S.build(child, ["e0"], op="ta", theta={"lam": 0.5}, budget="50%",
                name="j-graph"),
    ]


def _audit(sess, sid):
    """explain() without what differs between runs (ids, times, paths)."""
    ex = sess.explain(sid)
    for key in ("job", "plan_id", "output_root", "created_at"):
        ex.pop(key)
    return ex


def _outputs(sess, sids):
    return {sid: {t: a.view(np.uint8) for t, a in sess.load(sid).items()}
            for sid in sids}


def _jax_batch(ws, arrays):
    with JaxSession(ws, block_size=BLOCK) as sess:
        _register(sess, arrays, port=False)
        specs = _specs(JaxSpec)
        for s in specs:
            sess.submit(s, sid=s.name)
        with jax_measure(sess.stats) as io:
            res = sess.run_all(shared_budget="60%")
        sids = [r.sid for r in res]
        return (specs, _outputs(sess, sids), dict(io),
                {sid: _audit(sess, sid) for sid in sids},
                sess.merge_graph("j-graph"),
                [r.stats["batch"]["c_expert_hat_union"] for r in res[:1]])


def test_session_batch_matches_jax(tmp_path):
    arrays = _arrays()
    j_specs, j_out, j_io, j_audit, j_graph, j_union = _jax_batch(
        str(tmp_path / "ja"), arrays)
    with Session(str(tmp_path / "pt"), block_size=BLOCK, device="cpu") as sess:
        _register(sess, arrays, port=True)
        specs = _specs(MergeSpec)
        assert [s.spec_id for s in specs] == [s.spec_id for s in j_specs]
        for s in specs:
            sess.submit(s, sid=s.name)
        with measure(sess.stats) as io:
            res = sess.run_all(shared_budget="60%")
        sids = [r.sid for r in res]
        assert sids == ["j-dare", "j-avg", "j-graph"]
        out = _outputs(sess, sids)
        assert {c: io[c] for c in IO} == {c: j_io[c] for c in IO}
        assert abs(io["meta"] - j_io["meta"]) <= META_SLACK
        assert {sid: _audit(sess, sid) for sid in sids} == j_audit
        assert sess.merge_graph("j-graph") == j_graph
        assert res[0].stats["batch"]["c_expert_hat_union"] == j_union[0]
        assert all(sess.verify(sid) for sid in [*sids, "j-child"])
    assert out.keys() == j_out.keys()
    for sid in out:
        for t in out[sid]:
            np.testing.assert_array_equal(out[sid][t], j_out[sid][t])


def _service_run(Service, Spec, measure_fn, ws, arrays, port, **kw):
    with Service(ws, block_size=BLOCK, **kw) as svc:
        _register(svc, arrays, port=port)
        with measure_fn(svc.stats) as io:
            handles = [svc.submit(s, sid=s.name, tenant=t)
                       for s, t in zip(_specs(Spec), ("a", "b", "a"))]
            if not svc.started:
                svc.drain()
            results = [h.wait(60) for h in handles]
        assert [h.status for h in handles] == ["done"] * 3
        sids = [r.sid for r in results]
        return (_outputs(svc, sids), dict(io),
                {sid: _audit(svc, sid) for sid in sids}, svc.status())


def test_service_matches_jax_service(tmp_path):
    """The batch through the port's MergeService, inline and threaded,
    against the JAX MergeService (inline) under a tenant budget pool:
    the same bytes; inline, the same I/O, plans, windows and pool use."""
    from repro.api import MergeService as JaxService
    from repro.store.iostats import measure as jm

    arrays = _arrays(1)
    pool = {"budget": "200KiB", "tenants": {"a": 2.0, "b": 1.0}}
    j_out, j_io, j_audit, j_status = _service_run(
        JaxService, JaxSpec, jm, str(tmp_path / "ja"), arrays, False,
        start=False, **pool)
    p_out, p_io, p_audit, p_status = _service_run(
        MergeService, MergeSpec, measure, str(tmp_path / "pt"), arrays, True,
        start=False, device="cpu", **pool)
    assert {c: p_io[c] for c in IO} == {c: j_io[c] for c in IO}
    assert abs(p_io["meta"] - j_io["meta"]) <= META_SLACK
    assert p_audit == j_audit
    assert p_status["budget"] == j_status["budget"]
    assert p_status["windows_run"] == j_status["windows_run"]
    t_out, _, _, t_status = _service_run(
        MergeService, MergeSpec, measure, str(tmp_path / "pu"), arrays, True,
        device="cpu", **pool)
    assert t_status["jobs"] == {JobState.DONE: 3}
    for out in (p_out, t_out):
        assert out.keys() == j_out.keys()
        for sid in j_out:
            for t in j_out[sid]:
                np.testing.assert_array_equal(out[sid][t], j_out[sid][t])


def test_workspaces_cross_packages(tmp_path):
    """A workspace registered by one package merges in the other, to the
    same bytes as the writer's own merge."""
    arrays = _arrays(2)
    spec = {"base": "base", "experts": ["e0", "e1", "e2"], "op": "ties",
            "theta": {"trim_frac": 0.3}, "budget": "50%", "name": "x"}
    ja, pt = str(tmp_path / "ja"), str(tmp_path / "pt")
    with JaxSession(ja, block_size=BLOCK) as sess:
        _register(sess, arrays, port=False)
    with Session(pt, block_size=BLOCK, device="cpu") as sess:
        _register(sess, arrays, port=True)
    # each package merges the other's workspace, then its own
    with Session(ja, block_size=BLOCK, device="cpu") as sess:
        a = _outputs(sess, [sess.run(spec).sid])["x"]
    with JaxSession(pt, block_size=BLOCK) as sess:
        b = _outputs(sess, [sess.run(spec).sid])["x"]
        assert sess.verify("x")
    with JaxSession(ja, block_size=BLOCK) as sess:
        spec2 = dict(spec, name="y")
        c = _outputs(sess, [sess.run(spec2).sid])["y"]
        assert sess.verify("x")  # the port's snapshot verifies in JAX
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])
        np.testing.assert_array_equal(a[t], c[t])


def test_load_spec_file_json_and_yaml_refused(tmp_path):
    doc = {"jobs": [
        {"base": "base", "experts": ["e0", {"base": "base",
                                             "experts": ["e1", "e2"],
                                             "op": "avg"}],
         "op": "ties", "theta": {"trim_frac": 0.2}, "budget": "30%",
         "name": "n"},
        {"base": "base", "experts": ["e0"], "op": "ta", "budget": "2KiB"},
    ]}
    path = tmp_path / "specs.json"
    path.write_text(json.dumps(doc))
    specs = load_spec_file(str(path))
    want = [JaxSpec.from_dict(d) for d in doc["jobs"]]
    assert [s.spec_id for s in specs] == [s.spec_id for s in want]
    assert [s.to_dict() for s in specs] == [s.to_dict() for s in want]
    single = tmp_path / "one.json"
    single.write_text(json.dumps(doc["jobs"][1]))
    assert [s.spec_id for s in load_spec_file(str(single))] == [
        specs[1].spec_id]
    for suffix in (".yaml", ".yml"):
        y = tmp_path / f"specs{suffix}"
        y.write_text("base: base\nexperts: [e0]\nop: avg\n")
        with pytest.raises(RuntimeError, match="JSON"):
            load_spec_file(str(y))


def test_cli_spool_and_one_shot_on_cpu(tmp_path, capsys):
    """submit drops a job file, serve --once drains it through a real
    MergeService on the CPU, status reads the job table, cancel retracts
    an unclaimed job; a one-shot run and --spec run commit; unported
    subcommands exit non-zero (after tests/test_service.py)."""
    ws = str(tmp_path / "cliws")
    with Session(ws, block_size=BLOCK, device="cpu") as sess:
        _register(sess, _arrays(3), port=True)
    spec_doc = {"name": "cli-out", "base": "base", "experts": ["e0", "e1"],
                "op": "ties", "theta": {"trim_frac": 0.3}, "budget": "50%"}
    spec_path = tmp_path / "job.json"
    spec_path.write_text(json.dumps(spec_doc))

    merge_cli.main(["submit", "--workspace", ws, "--spec", str(spec_path),
                    "--tenant", "cli", "--priority", "2"])
    job_id = capsys.readouterr().out.split()[1]
    assert job_id.startswith("job-")
    merge_cli.main(["serve", "--workspace", ws, "--once", "--poll", "0.02",
                    "--block-size", str(BLOCK), "--device", "cpu"])
    with Session(ws, block_size=BLOCK, device="cpu") as sess:
        assert "cli-out" in sess.list_snapshots()
        row = sess.catalog.get_job(job_id)
        assert row["state"] == "done" and row["tenant"] == "cli"
    capsys.readouterr()
    merge_cli.main(["status", "--workspace", ws])
    assert "done" in capsys.readouterr().out
    merge_cli.main(["submit", "--workspace", ws, "--spec", str(spec_path)])
    job2 = capsys.readouterr().out.split()[1]
    merge_cli.main(["cancel", "--workspace", ws, job2])
    assert not os.listdir(os.path.join(ws, "service", "inbox"))

    # one-shot flags and a spec batch, then the audit record
    merge_cli.main(["--workspace", ws, "--base", "base", "--experts", "e0",
                    "e1", "e2", "--op", "dare", "--theta", "density=0.5",
                    "--budget", "40%", "--block-size", str(BLOCK),
                    "--sid", "one-shot", "--device", "cpu"])
    assert "committed one-shot" in capsys.readouterr().out
    batch = tmp_path / "batch.json"
    batch.write_text(json.dumps([dict(spec_doc, name="b1"),
                                 dict(spec_doc, name="b2", op="avg", theta={})]))
    merge_cli.main(["--workspace", ws, "--spec", str(batch), "--block-size",
                    str(BLOCK), "--shared-budget", "60%", "--device", "cpu",
                    "--pipeline-kernel", "numpy"])
    out = capsys.readouterr().out
    assert "committed b1" in out and "committed b2" in out
    merge_cli.main(["--workspace", ws, "--explain", "b1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["sid"] == "b1"
    with Session(ws, block_size=BLOCK, device="cpu") as sess:
        assert all(sess.verify(s) for s in ("one-shot", "b1", "b2"))
    for cmd in merge_cli.NOT_PORTED:
        with pytest.raises(SystemExit, match="not ported"):
            merge_cli.main([cmd, "--workspace", ws])
    # a failed job fails the run: a different spec under a taken name
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(spec_doc, name="b1", budget="20%")))
    with pytest.raises(ValueError, match="already published"):
        merge_cli.main(["--workspace", ws, "--spec", str(bad),
                        "--block-size", str(BLOCK), "--device", "cpu"])


def test_service_fails_kernel_errors_and_refuses_unported(tmp_path,
                                                          monkeypatch):
    """A kernel's RuntimeError fails its job once (never requeued as
    transient); auto-prefer finds no packed layout and a forced unknown
    one is refused; the options of unported parts (sharded execution)
    raise."""
    from repro_torch.kernels import ops

    with MergeService(str(tmp_path / "ws"), block_size=BLOCK, start=False,
                      device="cpu") as svc:
        _register(svc, _arrays(4), port=True)
        assert svc._select_layout(True, ["e0", "e1"], ["base"]) is None
        with pytest.raises(KeyError, match="not found"):
            svc._select_layout("layout-x", ["e0"], ["base"])

        def broken(*a, **k):
            raise RuntimeError("merge_blocks: CUDA launch failed with status 700")

        monkeypatch.setattr(ops, "merge_blocks", broken)
        h = svc.submit(MergeSpec.build("base", ["e0", "e1"], op="avg",
                                       budget="50%", name="bad"))
        svc.drain()
        assert h.status == JobState.FAILED
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            h.wait(0)
        assert svc.catalog.get_job(h.job_id)["attempts"] == 1
        assert "bad" not in svc.list_snapshots()
        monkeypatch.undo()
        h2 = svc.submit(MergeSpec.build("base", ["e0", "e1"], op="avg",
                                        budget="50%", name="bad"))
        svc.drain()
        assert h2.status == JobState.DONE
    with Session(str(tmp_path / "ws3"), device="cpu") as sess:
        sess.submit(MergeSpec.build("base", ["e0"], op="avg"))
        with pytest.raises(NotImplementedError):
            sess.run_all(n_workers=2)
        with pytest.raises(NotImplementedError, match="not ported"):
            sess.run_all(execution="sharded")
