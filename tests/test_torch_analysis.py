"""The port's lint (``repro_torch.analysis``) against the JAX package's
(``repro.analysis``): the same findings — path, line, pass, symbol,
message, waiver and fingerprint — on a seeded violation of every rule
and on its waiver, over the whole of ``src/repro_torch`` and over the
whole of ``src/repro`` (each package's drift check pointed at the
registry of the package it lints), the CLI's surface, and the CLI
running where neither JAX nor the JAX package can be imported."""
import glob
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import durability as jdurability
from repro.analysis import runner as jrunner
from repro.analysis.source import SourceFile as JSourceFile
from repro.testing import chaos as jchaos
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import durability, runner
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.source import SourceFile
from repro_torch.testing import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT_REGISTRIES = (
    ("chaos_point", chaos.CRASH_POINTS, "CRASH_POINTS", "armed"),
    ("chaos_corrupt", chaos.CORRUPTION_POINTS, "CORRUPTION_POINTS",
     "injected"),
)
_REF_REGISTRIES = (
    ("chaos_point", jchaos.CRASH_POINTS, "CRASH_POINTS", "armed"),
    ("chaos_corrupt", jchaos.CORRUPTION_POINTS, "CORRUPTION_POINTS",
     "injected"),
)

#: one planted violation of each rule, and each waiver (with and
#: without its reason): (pass id, snippet)
SNIPPETS = {
    "guarded_unlocked": ("guarded-by", """
        import threading

        class Gauge:
            def _init(self):
                self._lock = threading.Lock()
                self.current = 0  # guarded-by: _lock

            def bump(self):
                with self._lock:
                    self.current += 1

            def peek(self):
                return self.current
    """),
    "guarded_closure": ("guarded-by", """
        class Gauge:
            def _init(self):
                self.current = 0  # guarded-by: _lock

            def schedule(self):
                with self._lock:
                    def closure():
                        return self.current
                    return closure
    """),
    "guarded_twice": ("guarded-by", """
        class C:
            def _init(self):
                self.n = 0  # guarded-by: _lock_a

            def _reinit(self):
                self.n = 0  # guarded-by: _lock_b
    """),
    "guarded_waived": ("guarded-by", """
        class C:
            def _init(self):
                self.n = 0  # guarded-by: _lock

            def _bump(self):  # unguarded-ok: caller holds self._lock
                self.n += 1

            def peek(self):
                # unguarded-ok: a torn read is fine for a gauge
                return self.n
    """),
    "guarded_waiver_without_reason": ("guarded-by", """
        class C:
            def _init(self):
                self.n = 0  # guarded-by: _lock

            def _bump(self):  # unguarded-ok:
                self.n += 1
    """),
    "accounting_unaccounted": ("io-accounting", """
        def fetch(reader, off, n):
            return reader.read_range(off, n)

        def fetch_remote(store, key, off, n):
            return store.get_range(key, off, n)

        def raw(fd, n, off):
            return os.pread(fd, n, off)
    """),
    "accounting_accounted": ("io-accounting", """
        def fetch(reader, off, n):
            return reader.read_range(off, n, category="expert")

        def fetch2(reader, stats, off, n):
            buf = reader.read_range(off, n)
            stats.record_read("expert", len(buf))
            return buf

        def fetch3(reader, off, n, cat):
            return reader.read_range(off, n, cat)
    """),
    "accounting_unknown_category": ("io-accounting", """
        def fetch(stats, reader, n):
            stats.record_read("expret", n)
            stats.record_write(category="outt", nbytes=n)
            return reader.read_range(0, n, category="bsae")
    """),
    "accounting_waived": ("io-accounting", """
        def _pread(self, off, n):  # unaccounted-ok: caller records
            return os.pread(self._fd, n, off)

        def _get(self, off, n):
            # unaccounted-ok:
            return self.read_range(off, n)
    """),
    "except_swallowing": ("except-discipline", """
        def run(work, log):
            try:
                work()
            except:
                pass
            try:
                work()
            except Exception:
                log("oops")
            try:
                work()
            except (ValueError, BaseException):
                log("oops")
    """),
    "except_reraise_and_waived": ("except-discipline", """
        def run(work, log):
            try:
                work()
            except Exception as e:
                log(e)
                raise
            try:
                work()
            # broad-except-ok: the error is parked and re-raised by the consumer
            except Exception as e:
                log(e)
            try:
                work()
            except BaseException:  # broad-except-ok:
                pass
    """),
    "durability_no_fsync": ("durability", """
        import os

        def publish(tmp, final):
            with open(tmp, "wb") as f:
                f.write(b"data")
            chaos_point("publish:before")
            os.replace(tmp, final)
    """),
    "durability_no_chaos_point": ("durability", """
        import os

        def publish(tmp, final):
            os.fsync(3)
            os.rename(tmp, final)
    """),
    "durability_clean": ("durability", """
        import os

        def publish(tmp, final):
            with open(tmp, "wb") as f:
                f.write(b"data")
                os.fsync(f.fileno())
            chaos_point("publish:before")
            os.replace(tmp, final)
    """),
    "durability_waived": ("durability", """
        import os

        # fsync-ok: a torn cache file fails its check and is refetched
        def cache(tmp, final):  # chaos-ok: the caller's crash points cover it
            os.replace(tmp, final)

        def manifest(tmp, final):  # fsync-ok:
            chaos_point("manifest:publish")
            os.replace(tmp, final)

        def journal(tmp, final):
            os.fsync(3)
            os.replace(tmp, final)  # chaos-ok:
    """),
}

#: call sites for the repo-wide drift check: an unregistered crash point
#: and corruption point, and one registered point of each
DRIFT_SNIPPET = """
    def f(data):
        chaos_point("publish:nonexistent")
        chaos_point("%s")
        chaos_corrupt("%s", data)
        return chaos_corrupt("tier:nonexistent", data)
""" % (chaos.CRASH_POINTS[0], chaos.CORRUPTION_POINTS[0])


def _key(f):
    return (f.path, f.line, f.pass_id, f.symbol, f.message, f.waived,
            f.waive_reason, f.fingerprint)


def _keys(findings):
    return sorted(_key(f) for f in findings)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_seeded_snippet_findings_equal_reference(name):
    pass_id, text = SNIPPETS[name]
    text = textwrap.dedent(text)
    path = f"src/pkg/{name}.py"
    got = runner.ALL_PASSES[pass_id](SourceFile.parse(path, text))
    want = jrunner.ALL_PASSES[pass_id](JSourceFile.parse(path, text))
    assert _keys(got) == _keys(want)
    # every snippet plants or waives something of its pass, except the
    # clean ones, which must stay clean
    assert got or name.endswith(("_accounted", "_clean"))
    assert all(f.pass_id == pass_id for f in got)


def test_seeded_snippets_cover_every_pass_and_waiver():
    passes = {p for p, _ in SNIPPETS.values()}
    assert passes == set(runner.ALL_PASSES) == set(jrunner.ALL_PASSES)
    text = "".join(t for _, t in SNIPPETS.values())
    for key in ("unguarded-ok", "unaccounted-ok", "broad-except-ok",
                "fsync-ok", "chaos-ok"):
        assert re.search(rf"# {key}: \S", text), key
        assert f"# {key}:\n" in text, key      # and once without a reason


def test_drift_check_equals_reference(monkeypatch):
    """The repo-wide pass on planted call sites, both packages reading the
    port's registry: unregistered sites and dead points alike."""
    monkeypatch.setattr(jdurability, "_REGISTRIES", _PORT_REGISTRIES)
    text = textwrap.dedent(DRIFT_SNIPPET)
    got = durability.run_repo([SourceFile.parse("src/pkg/fake.py", text)])
    want = jdurability.run_repo([JSourceFile.parse("src/pkg/fake.py", text)])
    assert _keys(got) == _keys(want)
    assert sum("never be armed" in f.message for f in got) == 1
    assert sum("never be injected" in f.message for f in got) == 1
    dead = [f for f in got if "no live" in f.message]
    assert len(dead) == len(chaos.CRASH_POINTS) + len(
        chaos.CORRUPTION_POINTS) - 2


def _py_files(pkg):
    return sorted(glob.glob(os.path.join(ROOT, "src", pkg, "**", "*.py"),
                            recursive=True))


def test_port_findings_equal_reference_on_the_port(monkeypatch):
    monkeypatch.setattr(jdurability, "_REGISTRIES", _PORT_REGISTRIES)
    paths = _py_files("repro_torch")
    assert sorted(runner.discover(ROOT)) == paths
    got = runner.run_paths(paths, root=ROOT)
    want = jrunner.run_paths(paths, root=ROOT)
    assert got and _keys(got) == _keys(want)
    assert not [f for f in got if not f.waived]


def test_port_findings_equal_reference_on_the_reference(monkeypatch):
    monkeypatch.setattr(durability, "_REGISTRIES", _REF_REGISTRIES)
    paths = _py_files("repro")
    assert sorted(jrunner.discover(ROOT)) == paths
    got = runner.run_paths(paths, root=ROOT)
    want = jrunner.run_paths(paths, root=ROOT)
    assert got and _keys(got) == _keys(want)
    assert not [f for f in got if not f.waived]


def test_copy_lints_itself_clean():
    """The copy's own files (their docstrings and tuples name the read
    primitives and chaos_point only as strings) give no finding."""
    paths = _py_files(os.path.join("repro_torch", "analysis"))
    assert len(paths) == 10
    assert runner.run_paths(paths, root=ROOT, with_repo_passes=False) == []


def test_repo_root_and_baseline_are_the_ports(tmp_path):
    assert runner.find_repo_root(os.path.join(ROOT, "src", "repro_torch",
                                              "analysis")) == ROOT
    with pytest.raises(SystemExit, match="src/repro_torch"):
        runner.find_repo_root(str(tmp_path))
    assert baseline_mod.BASELINE_NAME == "mergelint_torch.baseline.json"
    with open(os.path.join(ROOT, baseline_mod.BASELINE_NAME)) as f:
        assert json.load(f) == {"entries": [], "version": 1}


def test_cli_exit_codes_and_json(tmp_path, capsys):
    assert lint_main(["--root", ROOT]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "mergelint: 0 finding(s), 25 waived"
    assert lint_main(["--root", ROOT, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["tool"] == "mergelint" and doc["findings"] == []
    assert len(doc["waived"]) == 25
    assert all(f["waive_reason"] for f in doc["waived"])
    assert lint_main(["--root", ROOT, "--passes", "nope"]) == 2
    assert "unknown pass(es): nope" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        lint_main(["--format", "xml"])
    assert exc.value.code == 2
    bad = tmp_path / "bad.py"
    bad.write_text("def f(r):\n    return r.read_range(0, 4)\n")
    assert lint_main(["--root", ROOT, str(bad)]) == 1
    assert "not accounted" in capsys.readouterr().out


def test_cli_list_and_select_passes(tmp_path, capsys):
    assert lint_main(["--list-passes"]) == 0
    assert capsys.readouterr().out.split() == list(runner.ALL_PASSES)
    bad = tmp_path / "bad.py"
    bad.write_text("def f(r):\n    try:\n        return r.read_range(0, 4)\n"
                   "    except Exception:\n        pass\n")
    assert lint_main(["--root", ROOT, "--format", "json", "--passes",
                      "except-discipline", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["pass"] for f in doc["findings"]] == ["except-discipline"]
    assert lint_main(["--root", ROOT, "--format", "json", "--passes",
                      "guarded-by,io-accounting", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["pass"] for f in doc["findings"]] == ["io-accounting"]
    assert lint_main(["--root", ROOT, "--passes", "guarded-by",
                      str(bad)]) == 0
    capsys.readouterr()
    assert lint_main(["--root", ROOT, "--show-waived", "--passes",
                      "io-accounting"]) == 0
    out = capsys.readouterr().out
    assert "(waived: " in out and "[io-accounting]" in out


def test_cli_update_baseline_writes_only_the_given_file(tmp_path, capsys):
    repo_baselines = {}
    for name in ("mergelint.baseline.json", baseline_mod.BASELINE_NAME):
        with open(os.path.join(ROOT, name)) as f:
            repo_baselines[name] = f.read()
    bad = tmp_path / "bad.py"
    bad.write_text("def f(r):\n    return r.read_range(0, 4)\n")
    path = tmp_path / "baseline.json"
    # one pass: the drift check over one file would add every point
    argv = ["--root", ROOT, "--passes", "io-accounting", "--baseline",
            str(path)]
    assert lint_main(argv + ["--update-baseline", str(bad)]) == 0
    assert "wrote 1 entry" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    assert [e["reason"] for e in doc["entries"]] == [""]
    # an entry without a reason waives nothing and is itself a finding
    assert lint_main(argv + [str(bad)]) == 1
    assert "has no reason" in capsys.readouterr().out
    doc["entries"][0]["reason"] = "a generated file"
    path.write_text(json.dumps(doc))
    assert lint_main(argv + [str(bad)]) == 0
    for name, text in repo_baselines.items():
        with open(os.path.join(ROOT, name)) as f:
            assert f.read() == text


_BLOCKED_RUN = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "yaml",
                                  "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "yaml", "repro"):
        del sys.modules[name]
sys.argv = ["python -m repro_torch.analysis", "--format", "json"]
runpy.run_module("repro_torch.analysis", run_name="__main__")
"""


def test_cli_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and len(doc["waived"]) == 25
    # the blocker works: the reference itself cannot be imported under it
    probe = _BLOCKED_RUN.split("sys.argv")[0] + "import repro.analysis\n"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "blocked: repro" in proc.stderr
