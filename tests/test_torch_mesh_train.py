"""Training under a device mesh on the CPU, in process groups of their own
(``torch_mesh_worker.py``, a subprocess each: no group is opened in a
pytest worker).  On a (2, 2) mesh of four gloo ranks under
``train_rules``, and on the (1, 1) mesh of one rank, the smoke configs of
a dense arch and of an MoE arch (whose routing goes through
``local_map``) give the meshless port's forward, loss, gradients and one
AdamW step within 2e-6 of each tensor's scale (float32), as the
reference's ``test_multidevice.py`` holds its shard_map path to its vmap
path; so do prefill and a decode step under ``serve_rules``.  And
DTensor's split of one dim over ("pod", "data") keeps the rows JAX's
``PartitionSpec(("pod", "data"))`` gives each device."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
ARCHS = ["qwen2-1.5b", "deepseek-v2-lite-16b"]
MIXERS = ["mamba2-2.7b", "recurrentgemma-9b"]
TOL = 2e-6


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _worker(tmp_path, argv, timeout=600):
    """Run the worker with OUT in its place in ``argv``; its JSON."""
    out = str(tmp_path / "out.json")
    r = subprocess.run([sys.executable, WORKER] + [out if a == "OUT" else a
                                                    for a in argv],
                       capture_output=True, text=True, timeout=timeout,
                       env=_env(), cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("world,mesh", [(4, [2, 2]), (1, [1, 1])])
def test_mesh_training_equals_meshless(tmp_path, world, mesh):
    got = _worker(tmp_path, ["train", str(world), "OUT", *ARCHS])
    assert got["mesh"] == mesh
    for arch in ARCHS:
        r = got["archs"][arch]
        assert r["batch_type"] == "DTensor"  # the pipeline placed it
        for what in ("logits", "grads", "params"):
            assert r[what] <= TOL, (arch, what, r)
        loss, want = r["loss"]
        assert abs(loss - want) <= TOL * max(abs(want), 1.0), (arch, r)


def test_mesh_training_sequence_mixers_equal_meshless(tmp_path):
    """Mamba-2's chunked SSD and the RG-LRU scan run shard by shard
    (``local_map``, batch and head / width shards kept) on (2, 2)."""
    got = _worker(tmp_path, ["train", "4", "OUT", *MIXERS])
    for arch in MIXERS:
        r = got["archs"][arch]
        for what in ("logits", "grads", "params"):
            assert r[what] <= TOL, (arch, what, r)


def test_mesh_serving_equals_meshless(tmp_path):
    """Prefill and a decode step under serve_rules on (2, 2): the dense
    cache batch- and head-sharded, MLA's latent cache sharded over its
    sequence (its one head cannot take "model"), the step's entry written
    on the rank that holds its position, the keys gathered to attend."""
    got = _worker(tmp_path, ["serve", "OUT", *ARCHS])
    assert got["qwen2-1.5b"]["placements"]["k"] == ["S(1)", "S(3)"]
    assert got["deepseek-v2-lite-16b"]["placements"]["ckv"] == ["S(1)",
                                                              "S(2)"]
    for arch in ARCHS:
        for what in ("prefill", "decode", "cache"):
            assert got[arch][what] <= TOL, (arch, what, got[arch])


def test_two_axis_batch_rows_match_jax(tmp_path):
    """Rows 0..7 split over ("pod", "data") on a (2, 2) mesh: the same
    rows at each mesh coordinate in both packages."""
    got = _worker(tmp_path, ["rows", "OUT"], timeout=300)
    code = (
        "import json, numpy as np, jax\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),"
        " ('pod', 'data'))\n"
        "idx = NamedSharding(mesh, P(('pod', 'data'))).devices_indices_map("
        "(8,))\n"
        "print(json.dumps({str((i, j)): list(range(8))[idx[mesh.devices[i,"
        " j]][0]] for i in range(2) for j in range(2)}))\n")
    env = _env()
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert got == json.loads(r.stdout.strip().splitlines()[-1])
