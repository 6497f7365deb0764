"""The port's two end-to-end launchers at smoke size on the CPU: the
torch versions of the JAX package's ``examples/train_and_merge.py``
(train K experts from one seeded base, TIES-merge them under a budget,
evaluate every model on every skill) and ``examples/serve_merged.py``
(train two experts, merge through a live ``MergeService``, serve the
snapshot with ``ServeEngine``).  Both default to the card."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve_merged, train_and_merge  # noqa: E402


def test_train_and_merge_runs_on_the_cpu(capsys):
    table = train_and_merge.main(["--device", "cpu", "--experts", "2",
                                  "--steps", "3"])
    out = capsys.readouterr().out
    assert "budget respected: True" in out
    assert list(table) == ["base", "expert-0", "expert-1", "merged"]
    assert all(len(row) == 2 and all(math.isfinite(x) for x in row)
               for row in table.values())
    # each expert trained on its own skill moved off the base there
    assert table["expert-0"][0] != table["base"][0]
    assert table["expert-1"][1] != table["base"][1]


def test_serve_merged_runs_on_the_cpu(capsys):
    reqs = serve_merged.main(["--device", "cpu", "--steps", "3",
                              "--requests", "3"])
    out = capsys.readouterr().out
    assert "committed serve-merged" in out
    assert len(reqs) == 3
    assert all(r.done and len(r.out_tokens) == 12 for r in reqs)


def test_serve_merged_hybrid_runs_on_the_cpu(capsys):
    """train -> merge -> serve of the hybrid family (RecurrentGemma's smoke
    config: RG-LRU and local attention) through the launcher."""
    reqs = serve_merged.main(["--arch", "recurrentgemma-9b", "--device",
                              "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "committed serve-merged" in out
    assert len(reqs) == 6
    assert all(r.done and len(r.out_tokens) == 12 for r in reqs)


@pytest.mark.parametrize("launcher", [train_and_merge, serve_merged])
def test_launchers_default_to_the_card(launcher):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        launcher.main(["--steps", "1"])
