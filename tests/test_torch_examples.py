"""The JAX package's quickstart and budget-sweep examples against their
ports (``repro_torch.launch.quickstart`` / ``budget_sweep``) on the CPU,
on the same seeds: the same bytes read and written, the same plan, the
same merged shapes and merge-graph lineage, the same sweep table and
sharing factor, and rel-l2 within the contract's rtol of 2e-6."""
import ast
import importlib.util
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import budget_sweep, quickstart  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what the printed output draws from the clock: the snapshot, plan and
#: job ids, and the batch's wall
VOLATILE = re.compile(r"(snap|plan|job)-[0-9a-f]+|batch wall +: [0-9.]+s")


def _reference(name):
    """Load ``examples/<name>.py`` of the JAX package by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stable(out):
    return [VOLATILE.sub("<volatile>", ln) for ln in out.splitlines()]


def _between(out, start, end):
    """The text after the line starting ``start`` up to the line starting
    ``end``."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith(start))
    j = next(j for j in range(i + 1, len(lines)) if lines[j].startswith(end))
    return "\n".join([lines[i][len(start):]] + lines[i + 1:j])


def test_quickstart_equals_reference(capsys):
    _reference("quickstart").main()
    ref = capsys.readouterr().out
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out

    m = re.search(r"expert bytes read : ([\d,]+) \(naive would read ([\d,]+)\)",
                  ref)
    expert, naive = (int(x.replace(",", "")) for x in m.groups())
    m = re.search(r"base/out bytes    : ([\d,]+) / ([\d,]+)", ref)
    base, written = (int(x.replace(",", "")) for x in m.groups())
    assert (got["expert_read"], got["naive"]) == (expert, naive)
    assert (got["base_read"], got["out_written"]) == (base, written)
    assert got["expert_read"] <= got["planned"] <= got["budget_b"]
    assert got["expert_read"] < got["naive"]

    lineage = json.loads(_between(ref, "merge graph lineage: ",
                                  "merged tensors:"))
    assert got["lineage"] == lineage
    assert lineage["expert_ids"] == ["sub", "expert-2"]
    assert lineage["parents"][0]["expert_ids"] == ["expert-0", "expert-1"]
    shapes = ast.literal_eval(ref.split("merged tensors: ")[1].splitlines()[0])
    assert got["shapes"] == shapes
    assert set(got["snapshots"]) == {"ties", "sub", "graph"}
    # the printed report, line for line, but for the clock's ids
    assert _stable(out) == _stable(ref)
    assert got["sid"] in out


def test_budget_sweep_equals_reference(capsys, monkeypatch):
    ref_mod = _reference("budget_sweep")
    loads = []

    class RecordingSession(ref_mod.Session):
        def load(self, sid):
            arrays = super().load(sid)
            loads.append(arrays)
            return arrays

    monkeypatch.setattr(ref_mod, "Session", RecordingSession)
    ref_mod.main()
    ref = capsys.readouterr().out
    got = budget_sweep.main(["--device", "cpu"])
    out = capsys.readouterr().out

    rows = [ln.split() for ln in ref.splitlines()
            if re.match(r"^\s+\d+%\s", ln)]
    assert len(rows) == len(got["rows"]) == 5
    # the reference's rel-l2 from its own snapshots (loads: the full
    # merge, then each sweep point), as the example computes it
    full, outs = loads[0], loads[1:]
    for row, mine, merged in zip(rows, got["rows"], outs):
        assert f"{mine['budget']:.0%}" == row[0]
        assert f"{mine['planned_mb']:.2f}" == row[1]
        assert mine["blocks"] == int(row[3])
        assert mine["planned"] <= mine["budget_b"]
        num = sum(float(np.sum((merged[k] - full[k]) ** 2)) for k in merged)
        den = sum(float(np.sum(full[k] ** 2)) for k in merged)
        np.testing.assert_allclose(mine["rel_l2"], (num / den) ** 0.5,
                                   rtol=2e-6, atol=0)
    m = re.search(r"expert MB read   : ([\d.]+) \(sequential would read "
                  r"([\d.]+)\)", ref)
    assert f"{got['expert_mb']:.2f}" == m.group(1)
    assert f"{got['sequential_mb']:.2f}" == m.group(2)
    m = re.search(r"sharing factor   : ([\d.]+)x \((\d+) cached", ref)
    assert f"{got['sharing_factor']:.2f}" == m.group(1)
    assert got["cached_block_reads"] == int(m.group(2))
    assert got["expert_mb"] < got["sequential_mb"]
    assert len(got["snapshots"]) == 6
    assert _stable(out) == _stable(ref)
