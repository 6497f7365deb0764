"""The port's lint (mergelint, ``repro_torch.analysis``: the guarded-by,
accounting, except-discipline and durability passes) over the port, and
the kernel build's publish order: the library is fsynced before the
rename that makes it visible, with a crash point between them, and
processes building at once compile a source once.

The lint's registry-drift check reads the chaos registry of the package
it lints; the port's copy reads ``repro_torch.testing.chaos``, whose
points (``build:publish`` among them) are the ones the port's injectors
can arm.  The findings are pinned: the ones the port's copies waive in
their own comments, and the registered points whose call sites live in
modules not ported yet (each with the ROADMAP item whose port removes
it).  Any other finding fails."""
import glob
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import durability, runner  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.testing import chaos  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "src/repro_torch/"

#: (path, symbol, message prefix) of the findings the copies waive
WAIVED = sorted([
    (PORT + "api/service.py", "_loop", "except Exception"),
    (PORT + "api/service.py", "_run_level", "except Exception"),
    (PORT + "api/service.py", "_run_window", "except Exception"),
    (PORT + "api/service.py", "_maybe_scrub", "except Exception"),
    (PORT + "core/executor.py", "_produce", "except BaseException"),
    (PORT + "dist/lease.py", "write", "durability edge os.replace"),
    (PORT + "dist/worker.py", "_write_json", "durability edge os.replace"),
    (PORT + "launch/dryrun.py", "main", "except Exception"),
    (PORT + "launch/merge_cli.py", "_cmd_submit", "durability edge os.rename"),
    (PORT + "store/blockcache.py", "CachingModelReader._admit", "read of self._blocks"),
    (PORT + "store/blockcache.py", "CachingModelReader._admit", "read of self._blocks"),
    (PORT + "store/blockcache.py", "CachingModelReader._admit", "write of self.cached_bytes"),
    (PORT + "store/packed.py", "_pread", "pread() call site not accounted"),
    (PORT + "store/packed.py", "quarantine_extent", "durability edge os.replace"),
    (PORT + "store/packed.py", "repack", "durability edge os.replace"),
    (PORT + "store/remote.py", "put_object", "durability edge os.replace"),
    (PORT + "store/snapshot.py", "_drain", "except BaseException"),
    (PORT + "store/snapshot.py", "atomic_publish", "durability edge os.replace"),
    (PORT + "store/snapshot.py", "atomic_publish", "durability edge os.replace"),
    (PORT + "store/tensorstore.py", "publish_remote", "durability edge os.replace"),
    (PORT + "store/tensorstore.py", "register_remote", "durability edge os.replace"),
    (PORT + "store/tensorstore.py", "write_model", "durability edge os.replace"),
    (PORT + "store/tiered.py", "_fetch_remote", "get_range() call site not accounted"),
    (PORT + "store/tiered.py", "_load_manifest", "durability edge os.replace"),
    (PORT + "store/tiered.py", "_load_manifest", "os.replace without a preceding os.fsync"),
])
#: registered points with no live call site yet -> the ROADMAP item
#: (queue A) whose port brings the call site (none since the shard
#: workers brought worker:lease, worker:block and worker:commit)
NOT_PORTED = {}


def _port_lint():
    # the copy's drift check reads the port's own registry, unpatched
    assert durability._REGISTRIES == (
        ("chaos_point", chaos.CRASH_POINTS, "CRASH_POINTS", "armed"),
        ("chaos_corrupt", chaos.CORRUPTION_POINTS, "CORRUPTION_POINTS",
         "injected"),
    )
    paths = sorted(glob.glob(os.path.join(ROOT, PORT, "**", "*.py"),
                             recursive=True))
    assert any(p.endswith("train/train_loop.py") for p in paths)
    return runner.run_paths(paths, root=ROOT)


def test_port_lint_gives_exactly_the_pinned_findings():
    findings = _port_lint()

    def key(f):
        prefix = next((w[2] for w in WAIVED if f.message.startswith(w[2])),
                      f.message)
        return f.path, f.symbol, prefix

    assert sorted(key(f) for f in findings if f.waived) == WAIVED
    assert all(f.waive_reason for f in findings if f.waived)
    drift = {}
    for f in findings:
        if f.waived:
            continue
        assert f.pass_id == "durability" and f.path == PORT + "testing/chaos.py", (
            f"unexpected finding: {f.render()}")
        point = f.message.split("'")[1]
        drift[(f.symbol, point)] = f.message
    assert set(drift) == set(NOT_PORTED), sorted(drift)


def test_port_registry_matches_reference_plus_build():
    from repro.testing import chaos as jchaos

    assert chaos.CRASH_POINTS == jchaos.CRASH_POINTS + ("build:publish",)
    assert chaos.CORRUPTION_POINTS == jchaos.CORRUPTION_POINTS


def _fake_build(tmp_path, monkeypatch, calls):
    """A CudaLibrary whose nvcc writes a file, with fsync / replace
    recorded in ``calls``."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(kbuild, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kbuild, "nvcc", lambda: "nvcc")

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF library")
        calls.append(("compile", os.path.basename(out)))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        calls.append(("fsync", os.path.basename(os.readlink(
            f"/proc/self/fd/{fd}"))))
        real_fsync(fd)

    def replace(a, b):
        calls.append(("replace", os.path.basename(a), os.path.basename(b)))
        real_replace(a, b)

    monkeypatch.setattr(kbuild.subprocess, "run", run)
    monkeypatch.setattr(kbuild.os, "fsync", fsync)
    monkeypatch.setattr(kbuild.os, "replace", replace)
    return kbuild.CudaLibrary("k.cu", lambda lib: None)


def test_build_fsyncs_the_library_before_publishing_it(tmp_path, monkeypatch):
    calls = []
    lib = _fake_build(tmp_path, monkeypatch, calls)
    path = lib.build()
    name, tmp = os.path.basename(path), calls[0][1]
    log, tag = os.path.basename(lib.log_path()), tmp[len(name) + 1:]
    assert [c[0] for c in calls] == ["compile", "fsync", "replace", "fsync",
                                     "replace", "fsync"]
    assert calls[1] == ("fsync", f"{log}.{tag}")      # the compiler's log,
    assert calls[2] == ("replace", f"{log}.{tag}", log)  # published first
    assert calls[3] == ("fsync", tmp)                 # the temp library
    assert calls[4] == ("replace", tmp, name)
    assert calls[5] == ("fsync", "build")             # then its directory
    with open(path, "rb") as f:
        assert f.read() == b"\x7fELF library"
    calls.clear()
    assert lib.build() == path and calls == []        # a build exists


def test_build_crash_before_rename_publishes_nothing(tmp_path, monkeypatch):
    calls = []
    lib = _fake_build(tmp_path, monkeypatch, calls)
    with chaos.inject("build:publish") as inj:
        with pytest.raises(chaos.SimulatedCrash):
            lib.build()
    assert inj.fired
    assert not os.path.exists(lib.path())             # no torn library
    assert [c[0] for c in calls] == ["compile", "fsync", "replace", "fsync"]
    assert lib.build() == lib.path()                  # the next build runs


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A source's cached library is named by a hash of the source and the
    headers it includes from its directory: a change to a header is a new
    build, a change to a header it does not include is not."""
    calls = []
    lib = _fake_build(tmp_path, monkeypatch, calls)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// kernel\n')
    (tmp_path / "common.cuh").write_text("// helpers\n")
    (tmp_path / "other.cuh").write_text("// unrelated\n")
    first = lib.path()
    (tmp_path / "other.cuh").write_text("// unrelated, changed\n")
    assert lib.path() == first
    (tmp_path / "common.cuh").write_text("// helpers, changed\n")
    second = lib.path()
    assert second != first
    assert lib.build() == second and calls[0] == ("compile", calls[0][1])


_BUILDER = """
import sys
from repro_torch.kernels import build as kbuild
kbuild.CSRC_DIR, kbuild.BUILD_DIR = sys.argv[1], sys.argv[2]
kbuild.nvcc = lambda: sys.argv[3]
print(kbuild.CudaLibrary("k.cu", lambda lib: None).build())
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes building one source on a fresh tree (shard workers
    starting together): the lock lets one run the compiler (a fake nvcc
    that takes a second), the other finds its library, and the log is
    one compile's output, whole."""
    (tmp_path / "k.cu").write_text("// kernel\n")
    count = tmp_path / "runs"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo run >> {count}\n"
        "sleep 1\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'printf "ELF library" > "$out"\n'
        "echo 'ptxas info    : Used 32 registers'\n")
    fake.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(tmp_path), str(build), str(fake)],
        stdout=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    paths = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert paths[0] == paths[1] and os.path.exists(paths[0])
    assert count.read_text() == "run\n"                  # one compile
    log = paths[0][: -len(".so")] + ".log"
    with open(log) as f:
        assert f.read() == "ptxas info    : Used 32 registers\n"
    assert not [n for n in os.listdir(build) if n.endswith(".tmp")]
