"""The port's packed store (``repro_torch.store.packed``) against the JAX
package on the CPU, and the JAX package's own packed-store cases run on
the port.

Against the JAX package, on the same seeded models: a repack with the
same ``layout_id`` and options writes byte-identical extent files and
the same manifest apart from its timings; a layout written by either
package reads back through the other; the bf16 sites of the copy
(downcast to bfloat16, a base-equal bf16 block holding NaN, an L2
elision threshold on bf16) agree with the reference; and for every
operator a merge planned against the layout (physical costing) selects
the same blocks, gives bit-equal outputs and moves equal per-category
bytes — ``expert_packed`` included — as the JAX ``execute_merge``.  The
port merges on ``device="cpu"`` through the torch kernel path."""
import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

from repro.core.api import MergePipe as JaxMergePipe  # noqa: E402
from repro.core.executor import execute_merge as jax_execute  # noqa: E402
from repro.core.planner import plan_merge as jax_plan_merge  # noqa: E402
from repro.store import packed as jax_packed  # noqa: E402
from repro.store.iostats import IOStats as JaxIOStats  # noqa: E402
from repro.store.iostats import measure as jax_measure  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.core.cost import packed_expert_cost  # noqa: E402
from repro_torch.core.executor import PipelineConfig, execute_merge  # noqa: E402
from repro_torch.core.operators import operator_names  # noqa: E402
from repro_torch.core.planner import plan_merge  # noqa: E402
from repro_torch.store.iostats import IOStats, measure  # noqa: E402
from repro_torch.store.packed import (  # noqa: E402
    RepackOptions,
    decode_extent,
    encode_extent,
)

from torch_pair import (  # noqa: E402
    OP_THETAS,
    assert_same_arrays,
    cast,
    tree_files,
)

BS = 4096

#: the per-category bytes a packed merge must move identically
PACKED_IO = ("base_read", "expert_read", "expert_packed_read", "out_written")


# ======================================================= against the JAX package
def _pair_fleet(dtype, seed=0):
    """(model_id, float32 arrays, kind, scale) of a fleet with frozen
    (base-equal: elided), shared (dedup) and unique tensors, a delta
    expert with an all-zero tensor and a LoRA adapter."""
    rng = np.random.default_rng(seed)
    shapes = {"layer0/w": (64, 96), "layer0/frozen": (64, 64),
              "emb": (128, 32), "ln": (96,)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    out = [("base", base, "full", 1.0)]
    shared = base["emb"] + 0.01
    for i in range(4):
        ex = {}
        for k, v in base.items():
            if k == "layer0/frozen":
                ex[k] = v.copy()
            elif k == "emb" and i >= 2:
                ex[k] = shared.copy()
            else:
                ex[k] = v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
        out.append((f"e{i}", ex, "full", 1.0))
    delta = {k: (0.02 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in base.items()}
    delta["ln"] = np.zeros_like(base["ln"])
    out.append(("ed", delta, "delta", 1.0))
    ad = {}
    for k, v in base.items():
        if v.ndim == 2:
            ad[f"{k}::lora_A"] = rng.normal(size=(4, v.shape[1])).astype(np.float32)
            ad[f"{k}::lora_B"] = rng.normal(size=(v.shape[0], 4)).astype(np.float32)
    out.append(("ea", ad, "adapter", 0.1))
    return out


def _pair(tmp_path, dtype="float32", fleet=None, analyze=True):
    """The same fleet registered in a JAX and a port MergePipe."""
    fleet = fleet if fleet is not None else _pair_fleet(dtype)
    jax_mp = JaxMergePipe(str(tmp_path / "jax"), block_size=BS,
                          stats=JaxIOStats())
    port_mp = MergePipe(str(tmp_path / "port"), block_size=BS,
                        stats=IOStats(), device="cpu")
    for mp, port in ((jax_mp, False), (port_mp, True)):
        for mid, arrays, kind, scale in fleet:
            # adapters stay float32 (their factors are not merge blocks)
            dt = "float32" if kind == "adapter" else dtype
            mp.register_model(mid, cast(arrays, dt, port), kind=kind,
                              scale=scale)
        if analyze:
            mp.ensure_analyzed("base", [m for m, *_ in fleet[1:]])
    return jax_mp, port_mp, [m for m, *_ in fleet[1:]]


def _layout_doc(root, layout_id):
    with open(os.path.join(root, "packed", layout_id, "LAYOUT.json")) as f:
        doc = json.load(f)
    doc["stats"].pop("seconds")
    return doc


def _assert_same_layout(jax_mp, port_mp, layout_id):
    """Byte-identical extent files; manifests equal but for timings;
    the same physical cost rows in both catalogs."""
    files = {}
    for name, mp in (("jax", jax_mp), ("port", port_mp)):
        root = os.path.join(mp.snapshots.workspace, "packed", layout_id)
        files[name] = {k: v for k, v in tree_files(root).items()
                       if k != "LAYOUT.json"}
    assert files["jax"] and files["jax"] == files["port"]
    assert (_layout_doc(jax_mp.snapshots.workspace, layout_id)
            == _layout_doc(port_mp.snapshots.workspace, layout_id))
    for m in jax_mp.catalog.packed_layout_members(layout_id):
        assert (jax_mp.catalog.packed_block_costs(layout_id, m)
                == port_mp.catalog.packed_block_costs(layout_id, m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("options", [
    {}, {"compress": "zlib"}, {"downcast": "bfloat16"},
    {"downcast": "float16", "compress": "zlib"},
])
def test_repack_layouts_byte_identical(tmp_path, dtype, options):
    jax_mp, port_mp, ids = _pair(tmp_path, dtype, analyze=False)
    rj = jax_mp.repack(ids, "base", layout_id="L",
                       options=jax_packed.RepackOptions(**options))
    rp = port_mp.repack(ids, "base", layout_id="L",
                        options=RepackOptions(**options))
    rj.pop("seconds"), rp.pop("seconds")
    assert rj == rp
    assert rp["elided_blocks"] > 0 and rp["dedup_blocks"] > 0
    _assert_same_layout(jax_mp, port_mp, "L")
    jax_mp.close()
    port_mp.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_reads_back_through_the_other_package(tmp_path, writer, dtype):
    """A workspace repacked by one package: every member read through
    the other's layout equals its flat checkpoint, and the other's
    packed merge is bit-equal to its flat merge."""
    jax_mp, port_mp, ids = _pair(tmp_path, dtype)
    (jax_mp if writer == "jax" else port_mp).repack(ids, "base",
                                                    layout_id="L")
    reader_ws = port_mp.snapshots.workspace if writer == "jax" else \
        jax_mp.snapshots.workspace
    src_ws = (jax_mp if writer == "jax" else port_mp).snapshots.workspace
    jax_mp.close()
    port_mp.close()
    shutil.rmtree(reader_ws)
    shutil.copytree(src_ws, reader_ws)
    if writer == "jax":
        mp = MergePipe(reader_ws, block_size=BS, device="cpu")
    else:
        mp = JaxMergePipe(reader_ws, block_size=BS, stats=JaxIOStats())
    layout = mp.snapshots.packed.open_layout("L")
    for m in ids:
        flat = mp.load(m)
        with layout.open_member(m) as r:
            for t in flat:
                got = r.read_tensor(t, "other")
                assert got.dtype == flat[t].dtype
                np.testing.assert_array_equal(
                    got.reshape(flat[t].shape), flat[t])
    layout.close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mp.merge("base", ids, "ties", theta={"trim_frac": 0.3}, budget=None,
                 sid="packed", reuse_plan=False)
        mp.merge("base", ids, "ties", theta={"trim_frac": 0.3}, budget=None,
                 sid="flat", prefer_packed=False, reuse_plan=False)
    assert mp.explain("packed")["layout_id"] == "L"
    assert_same_arrays(mp.load("flat"), mp.load("packed"))
    mp.close()


def _special_float32(n=4096, seed=5):
    """Values that exercise a downcast: rounding ties both ways, NaN of
    both signs with payloads, infinities, subnormals, overflow."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    u = x.view(np.uint32)
    u[:64] = (u[:64] & 0xFFFF0000) | 0x8000            # exact ties
    u[64:96] = (u[64:96] & 0xFFFF0000) | 0x7FFF
    u[96:104] = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                 0x7FBFFFFF, 0x7F812345, 0xFFC12345, 0x7FFFFFFF]
    x[104:108] = [np.inf, -np.inf, 1e-40, -3e38]
    x[108:112] = [3.4e38, 65504.0, 65520.0, 6e-8]
    return x


@pytest.mark.parametrize("downcast", ["bfloat16", "float16"])
@pytest.mark.parametrize("compress", ["none", "zlib"])
def test_downcast_extent_codec_matches_reference(downcast, compress):
    raw = _special_float32().tobytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pj, ej = jax_packed.encode_extent(
            raw, "float32",
            jax_packed.RepackOptions(downcast=downcast, compress=compress))
        pp, ep = encode_extent(
            raw, "float32", RepackOptions(downcast=downcast, compress=compress))
    assert ej == ep and pj == pp
    assert ep.startswith(f"cast:{downcast}")
    assert (jax_packed.decode_extent(pj, ej, "float32", len(raw))
            == decode_extent(pp, ep, "float32", len(raw)))


def test_bf16_base_equal_block_holding_nan_is_not_elided(tmp_path):
    """A bf16 block byte-equal to the base but holding NaN has no zero
    delta (NaN - NaN is NaN): both packages keep it as an extent instead
    of eliding it, and the member reads it back bit for bit."""
    fleet = _pair_fleet("bfloat16", seed=1)[:3]
    base = fleet[0][1]
    base["layer0/frozen"][0, :5] = np.nan        # block 0 of the tensor
    for _mid, ex, _k, _s in fleet[1:]:
        ex["layer0/frozen"] = base["layer0/frozen"].copy()
    jax_mp, port_mp, ids = _pair(tmp_path, "bfloat16", fleet=fleet,
                                 analyze=False)
    rj = jax_mp.repack(ids, "base", layout_id="L")
    rp = port_mp.repack(ids, "base", layout_id="L")
    assert rj["elided_blocks"] == rp["elided_blocks"] > 0
    _assert_same_layout(jax_mp, port_mp, "L")
    layout = port_mp.snapshots.packed.open_layout("L")
    with layout.open_member("e0") as r:
        elided = r.elided_blocks("layer0/frozen")
        got = r.read_tensor("layer0/frozen", "other")
    layout.close()
    assert 0 not in elided and elided            # NaN block kept, rest elided
    want = cast({"t": base["layer0/frozen"]}, "bfloat16", port=True)["t"]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    jax_mp.close()
    port_mp.close()


def test_bf16_elide_threshold_measures_values(tmp_path):
    """With ``elide_threshold > 0`` the L2 of a bf16 delta is taken over
    its float values: near-zero deltas go, the rest stay, exactly as in
    the JAX package."""
    rng = np.random.default_rng(3)
    base = {"a": rng.normal(size=(64, 64)).astype(np.float32),
            "b": rng.normal(size=(64, 64)).astype(np.float32)}
    fleet = [("base", base, "full", 1.0)]
    for i in range(2):
        fleet.append((f"e{i}", {
            "a": base["a"] + 0.05 * rng.normal(size=(64, 64)).astype(np.float32),
            # one ulp-sized nudge per block of b: a tiny L2
            "b": base["b"] * np.float32(1 + 2 ** -7 * (i + 1)),
        }, "full", 1.0))
    jax_mp, port_mp, ids = _pair(tmp_path, "bfloat16", fleet=fleet,
                                 analyze=False)
    opts = {"elide_threshold": 1.0}
    rj = jax_mp.repack(ids, "base", layout_id="L",
                       options=jax_packed.RepackOptions(**opts))
    rp = port_mp.repack(ids, "base", layout_id="L",
                        options=RepackOptions(**opts))
    assert rj["elided_blocks"] == rp["elided_blocks"]
    n_blocks = 2 * 2 * (64 * 64 * 2 // BS)
    assert 0 < rp["elided_blocks"] < n_blocks
    assert not rp["lossless"]
    _assert_same_layout(jax_mp, port_mp, "L")
    jax_mp.close()
    port_mp.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(OP_THETAS))
def test_packed_merge_matches_jax_execute_merge(tmp_path, op, dtype):
    """Half the logical budget, costed at physical bytes: the port's
    plan selects the same blocks as the JAX planner (more than a flat
    plan under the same budget), and its merge — torch kernel path on
    the CPU — is bit-equal to the JAX ``execute_merge`` with equal
    per-category bytes."""
    jax_mp, port_mp, ids = _pair(tmp_path, dtype)
    for mp in (jax_mp, port_mp):
        mp.repack(ids, "base", layout_id="L")
    budget_b = port_mp.resolve_budget(ids, 0.5)
    assert budget_b == jax_mp.resolve_budget(ids, 0.5)
    kw = dict(theta=OP_THETAS[op], budget_b=budget_b, block_size=BS,
              reuse=False)
    pj = jax_plan_merge(jax_mp.catalog, "base", ids, op, layout_id="L", **kw)
    pp = plan_merge(port_mp.catalog, "base", ids, op, layout_id="L", **kw)
    flat = plan_merge(port_mp.catalog, "base", ids, op, **kw)
    assert pp.plan.selection == pj.plan.selection
    assert (pp.plan.c_expert_hat, pp.plan.c_expert_logical_hat) == (
        pj.plan.c_expert_hat, pj.plan.c_expert_logical_hat)
    assert pp.plan.c_expert_hat <= budget_b
    assert pp.plan.total_selected_blocks() > flat.plan.total_selected_blocks()
    with jax_measure(jax_mp.stats) as io_j:
        rj = jax_execute(pj.plan, jax_mp.snapshots, jax_mp.catalog,
                         sid="out", txn=jax_mp.txn)
    with measure(port_mp.stats) as io_p:
        rp = execute_merge(pp.plan, port_mp.snapshots, port_mp.catalog,
                           sid="out", txn=port_mp.txn, compute="pipelined",
                           device="cpu")
    assert {c: io_j[c] for c in PACKED_IO} == {c: io_p[c] for c in PACKED_IO}
    assert io_p["expert_packed_read"] > 0
    assert rp.stats["c_expert_run"] == rj.stats["c_expert_run"] <= budget_b
    assert_same_arrays(jax_mp.load("out"), port_mp.load("out"))
    jax_mp.close()
    port_mp.close()


# ============================================ the JAX package's own cases
def build_fleet(tmp_path, stats=None, n=4, dup_heavy=True):
    """Base + experts of all three kinds, with frozen (base-identical),
    cross-expert-shared, and unique tensors when ``dup_heavy``."""
    mp = MergePipe(str(tmp_path / "ws"), block_size=BS, stats=stats or IOStats(),
                   device="cpu")
    rng = np.random.default_rng(0)
    shapes = {
        "layer0/w": (64, 96), "layer0/frozen": (64, 64),
        "emb": (128, 32), "ln": (96,),
    }
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mp.register_model("base", base)
    shared = base["emb"] + 0.01  # identical across experts, != base
    ids = []
    for i in range(n):
        ex = {}
        for k, v in base.items():
            if dup_heavy and k == "layer0/frozen":
                ex[k] = v.copy()  # frozen layer -> elided
            elif dup_heavy and k == "emb" and i >= n // 2:
                ex[k] = shared.copy()  # tied across experts -> dedup
            else:
                ex[k] = v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
        mp.register_model(f"e{i}", ex)
        ids.append(f"e{i}")
    # one delta-kind expert with a fully-zero tensor (elided) ...
    delta = {
        k: (0.02 * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in base.items()
    }
    delta["ln"] = np.zeros_like(base["ln"])
    mp.register_model("ed", delta, kind="delta")
    ids.append("ed")
    # ... and one LoRA adapter
    ad = {}
    for k, v in base.items():
        if v.ndim == 2:
            r = 4
            ad[f"{k}::lora_A"] = rng.normal(size=(r, v.shape[1])).astype(np.float32)
            ad[f"{k}::lora_B"] = rng.normal(size=(v.shape[0], r)).astype(np.float32)
    mp.register_model("ea", ad, kind="adapter", scale=0.1)
    ids.append("ea")
    mp.ensure_analyzed("base", ids)
    return mp, "base", ids


# ---------------------------------------------------------------- codec
def test_extent_codec_roundtrip():
    rng = np.random.default_rng(2)
    raw = rng.normal(size=1024).astype(np.float32).tobytes()
    for opts in (
        RepackOptions(),
        RepackOptions(compress="zlib"),
    ):
        payload, enc = encode_extent(raw, "float32", opts)
        assert decode_extent(payload, enc, "float32", len(raw)) == raw
    # structured data actually compresses
    zeros = b"\x00" * 4096
    payload, enc = encode_extent(zeros, "float32", RepackOptions(compress="zlib"))
    assert enc == "zlib" and len(payload) < len(zeros)
    # downcast halves the bytes and survives decode (lossy values)
    payload, enc = encode_extent(raw, "float32", RepackOptions(downcast="float16"))
    assert enc == "cast:float16" and len(payload) == len(raw) // 2
    back = np.frombuffer(
        decode_extent(payload, enc, "float32", len(raw)), np.float32
    )
    np.testing.assert_allclose(back, np.frombuffer(raw, np.float32), atol=1e-3)
    # non-castable dtypes pass through unchanged
    ints = np.arange(256, dtype=np.int32).tobytes()
    payload, enc = encode_extent(ints, "int32", RepackOptions(downcast="float16"))
    assert enc == "raw" and payload == ints
    with pytest.raises(ValueError):
        RepackOptions(compress="gzip").validate()
    with pytest.raises(ValueError):
        RepackOptions(downcast="int8").validate()


# -------------------------------------------------------------- repack
@pytest.mark.parametrize("compress", ["none", "zlib"])
def test_repack_roundtrip_bit_identical(tmp_path, compress):
    """Every member of a lossless layout reconstructs bit-exactly from
    packed extents + elision metadata (full, delta, and adapter kinds)."""
    mp, base, ids = build_fleet(tmp_path)
    rep = mp.repack(ids, base, layout_id="L",
                    options=RepackOptions(compress=compress))
    assert rep["lossless"]
    assert rep["elided_blocks"] > 0 and rep["dedup_blocks"] > 0
    assert rep["physical_bytes"] < rep["logical_bytes"]
    layout = mp.snapshots.packed.open_layout("L")
    for m in ids:
        flat = mp.load(m)
        with layout.open_member(m) as r:
            assert sorted(r.tensor_names()) == sorted(flat)
            for t in flat:
                got = r.read_tensor(t, "other")
                assert got.dtype == flat[t].dtype
                np.testing.assert_array_equal(got.reshape(flat[t].shape), flat[t])
    layout.close()
    mp.close()


def test_repack_refuses_duplicate_layout_and_unknown_member(tmp_path):
    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids[:2], base, layout_id="L")
    with pytest.raises(ValueError, match="already exists"):
        mp.repack(ids[:2], base, layout_id="L")
    layout = mp.snapshots.packed.open_layout("L")
    with pytest.raises(KeyError, match="not a member"):
        layout.open_member("ed")
    layout.close()
    mp.close()


def test_repack_lossy_downcast_not_auto_preferred(tmp_path):
    """A downcast layout reconstructs approximately, is flagged lossy,
    and the Session never auto-prefers it (explicit opt-in by id)."""
    mp, base, ids = build_fleet(tmp_path)
    rep = mp.repack(ids, base, layout_id="lossy",
                    options=RepackOptions(downcast="float16"))
    assert not rep["lossless"]
    layout = mp.snapshots.packed.open_layout("lossy")
    flat = mp.load("e0")
    with layout.open_member("e0") as r:
        got = r.read_tensor("layer0/w", "other")
        np.testing.assert_allclose(
            got.reshape(flat["layer0/w"].shape), flat["layer0/w"], atol=1e-2
        )
    layout.close()
    assert mp.catalog.find_packed_layout(ids, BS) is None  # lossless only
    sess = mp.session()
    assert sess._select_layout(True, ids, ["base"]) is None
    assert sess._select_layout("lossy", ids, ["base"]) == "lossy"  # forced
    mp.close()


# ----------------------------------------------------------- golden
@pytest.mark.parametrize("op", sorted(OP_THETAS))
def test_golden_packed_equals_flat_stream(tmp_path, op):
    """Merging from a lossless packed layout is bit-identical
    to the flat-store stream engine for every registered operator across
    full/delta/adapter experts, and the physical expert bytes moved are
    <= the flat expert bytes."""
    assert op in operator_names()
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    theta = OP_THETAS[op]
    with measure(stats) as io_flat:
        mp.merge(base, ids, op, theta=theta, budget=None, compute="stream",
                 sid="flat", prefer_packed=False, reuse_plan=False)
    with measure(stats) as io_packed:
        mp.merge(base, ids, op, theta=theta, budget=None, compute="stream",
                 sid="packed", reuse_plan=False)
    a, b = mp.load("flat"), mp.load("packed")
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])
    assert io_packed["expert_packed_read"] > 0  # really read packed
    assert io_packed["expert_read"] <= io_flat["expert_read"]
    mp.close()


def test_pipelined_packed_bit_identical_and_accounted(tmp_path):
    """The overlapped engine on a packed layout matches stream-on-packed
    bit-for-bit and moves identical per-category physical bytes."""
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    theta = {"density": 0.5, "seed": 1}
    with measure(stats) as io_s:
        mp.merge(base, ids, "dare", theta=theta, budget=0.5,
                 compute="stream", sid="s")
    with measure(stats) as io_p:
        mp.merge(base, ids, "dare", theta=theta, budget=0.5,
                 compute="pipelined", sid="p", reuse_plan=True,
                 pipeline=PipelineConfig(window_blocks=4, prefetch_windows=2))
    a, b = mp.load("s"), mp.load("p")
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])
    for cat in ("base_read", "expert_read", "expert_packed_read",
                "out_written"):
        assert io_s[cat] == io_p[cat], cat
    mp.close()


def test_extent_read_once_fans_out(tmp_path):
    """Dedup fan-out: a block selected via several experts moves its
    extent bytes once per merge (read-once, serve-many)."""
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    # e2 and e3 share identical 'emb' tensors (dedup_heavy fleet)
    with measure(stats) as io:
        mp.merge(base, ["e2", "e3"], "avg", budget=None, compute="stream",
                 sid="fan", reuse_plan=False)
    phys = packed_expert_cost(mp.catalog, "L", ["e2", "e3"])
    assert io["expert_packed_read"] == phys
    # the shared emb extents were charged once, so physical < 2x one model
    logical = 2 * sum(v.nbytes for v in mp.load("e2").values())
    assert io["expert_packed_read"] < logical
    mp.close()


# ------------------------------------------------------- planner/budget
def test_budget_enforced_against_physical_bytes(tmp_path):
    """The same byte budget admits strictly more blocks on a
    packed layout, the plan's physical cost respects B, and the realized
    physical expert reads (expert + expert_packed) stay under B at the
    storage layer."""
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    budget_b = mp.resolve_budget(ids, 0.4)
    flat = plan_merge(mp.catalog, base, ids, "ties",
                      theta={"trim_frac": 0.3}, budget_b=budget_b,
                      block_size=BS, reuse=False)
    packed = plan_merge(mp.catalog, base, ids, "ties",
                        theta={"trim_frac": 0.3}, budget_b=budget_b,
                        block_size=BS, layout_id="L", reuse=False)
    assert packed.plan.layout_id == "L"
    assert packed.plan.c_expert_hat <= budget_b
    assert packed.plan.logical_hat >= packed.plan.c_expert_hat
    # an I/O budget buys strictly more selected blocks on a packed store
    assert (
        packed.plan.total_selected_blocks() > flat.plan.total_selected_blocks()
    )
    with measure(stats) as io:
        mp.execute(packed.plan, compute="stream")
    assert io["expert_packed_read"] <= budget_b
    assert io["expert_read"] <= budget_b  # combined physical categories
    mp.close()


def test_planner_rejects_bad_layouts(tmp_path):
    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids[:2], base, layout_id="L")
    with pytest.raises(KeyError, match="not in catalog"):
        plan_merge(mp.catalog, base, ids[:2], "avg", block_size=BS,
                   layout_id="nope")
    with pytest.raises(KeyError, match="not members"):
        plan_merge(mp.catalog, base, ids, "avg", block_size=BS,
                   layout_id="L")
    with pytest.raises(ValueError, match="block_size"):
        plan_merge(mp.catalog, base, ids[:2], "avg", block_size=2 * BS,
                   layout_id="L")
    mp.close()


def test_plan_reuse_distinguishes_layouts(tmp_path):
    """A flat plan must never be reused for a packed request (physical
    vs logical costing) and vice versa."""
    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids, base, layout_id="L")
    budget_b = mp.resolve_budget(ids, 0.5)
    kw = dict(theta={}, budget_b=budget_b, block_size=BS)
    flat1 = plan_merge(mp.catalog, base, ids, "avg", **kw)
    packed1 = plan_merge(mp.catalog, base, ids, "avg", layout_id="L", **kw)
    assert packed1.plan.plan_id != flat1.plan.plan_id
    flat2 = plan_merge(mp.catalog, base, ids, "avg", **kw)
    assert flat2.stats["reused"] and flat2.plan.layout_id is None
    packed2 = plan_merge(mp.catalog, base, ids, "avg", layout_id="L", **kw)
    assert packed2.stats["reused"] and packed2.plan.layout_id == "L"
    mp.close()


# -------------------------------------------------------- explain/session
def test_explain_reports_logical_and_physical(tmp_path):
    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids, base, layout_id="L")
    mp.merge(base, ids, "ties", theta={"trim_frac": 0.3}, budget=0.5,
             sid="snap", reuse_plan=False)
    ex = mp.explain("snap")
    assert ex["layout_id"] == "L"
    assert ex["c_expert_hat"] <= ex["c_expert_logical_hat"]
    assert ex["budget_respected"]
    # flat snapshots report layout None and logical == physical
    mp.merge(base, ids, "ties", theta={"trim_frac": 0.3}, budget=0.5,
             sid="snap-flat", prefer_packed=False, reuse_plan=False)
    exf = mp.explain("snap-flat")
    assert exf["layout_id"] is None
    assert exf["c_expert_hat"] == exf["c_expert_logical_hat"]
    mp.close()


def test_session_batch_shares_packed_reads(tmp_path):
    """run_all over a packed layout: jobs share one opened layout (extent
    dedup across jobs) and results stay bit-identical to flat execution."""
    from repro_torch.api.spec import MergeSpec

    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    sess = mp.session()

    def specs():
        # unbounded budgets: selections then agree between packed and
        # flat costing, which is what makes bit-identity comparable (a
        # finite budget *should* select more blocks on the packed store)
        return [
            MergeSpec.build(base, ["e0", "e1", "ed"], op="avg",
                            reuse_plan=False),
            MergeSpec.build(base, ["e1", "e2", "e3"], op="ties",
                            theta={"trim_frac": 0.2}, reuse_plan=False),
        ]

    for s, sid in zip(specs(), ("pk0", "pk1")):
        sess.submit(s, sid=sid)
    with measure(stats) as io_packed:
        res = sess.run_all(compute="stream")
    assert res[0].stats["batch"]["layout_id"] == "L"
    assert io_packed["expert_packed_read"] > 0

    for s, sid in zip(specs(), ("fl0", "fl1")):
        sess.submit(s, sid=sid)
    with measure(stats) as io_flat:
        sess.run_all(compute="stream", prefer_packed=False)
    assert io_packed["expert_read"] <= io_flat["expert_read"]
    for pk, fl in (("pk0", "fl0"), ("pk1", "fl1")):
        a, b = mp.load(pk), mp.load(fl)
        for t in a:
            np.testing.assert_array_equal(a[t], b[t])
    mp.close()


def test_layout_never_adopted_for_different_base(tmp_path):
    """Elision is relative to the layout's base: a merge against any
    other base must not auto-adopt the layout (silent corruption), the
    planner must hard-refuse it, and outputs must match flat execution."""
    mp, base, ids = build_fleet(tmp_path)
    rng = np.random.default_rng(9)
    base2 = {
        k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        for k, v in mp.load(base).items()
    }
    mp.register_model("base2", base2)
    mp.ensure_analyzed("base2", ids[:2])
    mp.repack(ids[:2], base, layout_id="L")  # packed against `base`
    # auto-prefer: find query is base-scoped
    assert mp.catalog.find_packed_layout(ids[:2], BS, base_id=base) == "L"
    assert mp.catalog.find_packed_layout(ids[:2], BS, base_id="base2") is None
    sess = mp.session()
    assert sess._select_layout(True, ids[:2], ["base2"]) is None
    assert sess._select_layout("L", ids[:2], ["base2"]) is None  # forced: n/a
    # planner refuses outright (strict layer)
    with pytest.raises(ValueError, match="packed against base"):
        plan_merge(mp.catalog, "base2", ids[:2], "avg", block_size=BS,
                   layout_id="L")
    # end to end: merging vs base2 matches flat execution bit-for-bit
    mp.merge("base2", ids[:2], "avg", budget=None, sid="b2-auto",
             reuse_plan=False)
    mp.merge("base2", ids[:2], "avg", budget=None, sid="b2-flat",
             prefer_packed=False, reuse_plan=False)
    a, b = mp.load("b2-auto"), mp.load("b2-flat")
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])
    mp.close()


def test_forced_layout_skips_inapplicable_graph_levels(tmp_path):
    """A forced layout applies where it can and falls back to flat where
    it cannot (merge-graph upper levels read freshly-committed snapshots
    that are never layout members) — the graph must complete."""
    from repro_torch.api.spec import MergeSpec

    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids[:3], base, layout_id="L")
    sess = mp.session()
    child = MergeSpec.build(base, ids[:3], op="avg", name="child")
    top = MergeSpec.build(base, [child, "e3"], op="ta",
                          theta={"lam": 0.5}, name="top")
    res = sess.run(top, compute="stream", prefer_packed="L")
    assert res.sid == "top"
    ex = sess.explain("child")
    assert ex["layout_id"] == "L"        # packable level used it
    assert sess.explain("top")["layout_id"] is None  # upper level fell back
    mp.close()


def test_catalog_layout_tables(tmp_path):
    mp, base, ids = build_fleet(tmp_path)
    rep = mp.repack(ids, base, layout_id="L")
    assert mp.catalog.list_packed_layouts() == ["L"]
    row = mp.catalog.get_packed_layout("L")
    assert row["base_id"] == base and row["block_size"] == BS
    assert row["lossless"] is True
    assert sorted(m["model_id"] for m in row["members"]) == sorted(ids)
    assert mp.catalog.packed_layout_members("L") == sorted(ids)
    # covering query: subset covered, superset not
    assert mp.catalog.find_packed_layout(ids[:3], BS) == "L"
    assert mp.catalog.find_packed_layout([*ids, "ghost"], BS) is None
    assert mp.catalog.find_packed_layout(ids, BS + 1) is None
    # physical cost model: elided blocks are free, the rest match extents
    costs = mp.catalog.packed_block_costs("L", "e0")
    assert any(k == "elided" and p == 0 for p, _h, k in costs.values())
    assert packed_expert_cost(mp.catalog, "L", ids) == rep["physical_bytes"]
    mp.close()


def test_repack_crash_recovery_resyncs_catalog(tmp_path):
    """If the process dies between the on-disk manifest publish and the
    catalog insert, re-running repack under the same id re-registers the
    layout from LAYOUT.json instead of bricking the id."""
    mp, base, ids = build_fleet(tmp_path)
    # simulate the crash window: disk publish happened, catalog rows didn't
    rep_disk = mp.snapshots.packed.repack(base, ids, BS, layout_id="L",
                                          catalog=None)
    assert mp.snapshots.packed.exists("L")
    assert mp.catalog.get_packed_layout("L") is None
    rep = mp.repack(ids, base, layout_id="L")  # recovery path
    assert rep["recovered"] and rep["layout_id"] == "L"
    assert rep["physical_bytes"] == rep_disk["physical_bytes"]
    row = mp.catalog.get_packed_layout("L")
    assert row is not None and sorted(
        m["model_id"] for m in row["members"]
    ) == sorted(ids)
    assert packed_expert_cost(mp.catalog, "L", ids) == rep_disk["physical_bytes"]
    # the recovered catalog rows actually plan and execute
    pr = plan_merge(mp.catalog, base, ids, "avg", block_size=BS,
                    layout_id="L", budget_b=mp.resolve_budget(ids, 0.5))
    mp.execute(pr.plan, compute="stream")
    # a second repack with both disk + catalog present still refuses
    with pytest.raises(ValueError, match="already exists"):
        mp.repack(ids, base, layout_id="L")
    mp.close()


def test_dedup_verifies_bytes_on_hash_collision(tmp_path, monkeypatch):
    """Dedup hits are verified byte-for-byte against the stored payload:
    even if every block collides on the content hash, distinct contents
    get distinct extents and members reconstruct bit-exactly."""
    from repro_torch.store import packed as packed_mod

    monkeypatch.setattr(packed_mod, "content_hash", lambda raw: "deadbeef")
    mp, base, ids = build_fleet(tmp_path)
    rep = mp.repack(ids[:2], base, layout_id="L")
    assert rep["extents"] > 1  # collisions were disambiguated, not aliased
    layout = mp.snapshots.packed.open_layout("L")
    for m in ids[:2]:
        flat = mp.load(m)
        with layout.open_member(m) as r:
            for t in flat:
                np.testing.assert_array_equal(
                    r.read_tensor(t, "other").reshape(flat[t].shape), flat[t]
                )
    layout.close()
    mp.close()


def test_max_pinned_bytes_rereads_stay_budget_sound(tmp_path):
    """A tight pin cap forces shared extents to be re-read for later
    consumers; the bytes are honestly recorded, tracked as reread_bytes,
    and budget enforcement treats them as slack instead of aborting."""
    from repro_torch.core.executor import execute_merge

    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids, base, layout_id="L")
    # budget == the full physical cost: every consumer of the shared
    # extents is selected and enforcement is active (budget_b >= 0)
    pr0 = plan_merge(mp.catalog, base, ids, "avg", block_size=BS,
                     layout_id="L", reuse=False)
    pr = plan_merge(mp.catalog, base, ids, "avg", block_size=BS,
                    layout_id="L", budget_b=pr0.plan.c_expert_hat,
                    reuse=False)
    assert pr.plan.total_selected_blocks() == pr0.plan.total_selected_blocks()
    layout = mp.snapshots.packed.open_layout("L", max_pinned_bytes=0)
    try:
        # injected capped-layout readers (the Session shared-read shape):
        # enforcement must see the layout behind them and widen its slack
        readers = {e: layout.open_member(e) for e in ids}
        res = execute_merge(
            pr.plan, mp.snapshots, mp.catalog, txn=mp.txn,
            compute="stream", expert_readers=readers, enforce_budget=True,
        )
        assert layout.reread_bytes > 0  # cap really forced re-reads
        # honest accounting: realized physical = planned + rereads
        assert res.stats["c_expert_run"] <= pr.plan.c_expert_hat + layout.reread_bytes
        assert res.stats["c_expert_run"] > pr.plan.c_expert_hat  # would
        # have tripped enforcement without the reread slack
    finally:
        layout.close()
    mp.close()


def test_packed_coalesced_reads_batch_adjacent_extents(tmp_path):
    """read_blocks_coalesced on a packed member coalesces adjacent unique
    extents into few preads and returns exactly read_block's data."""
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats, dup_heavy=False)
    mp.repack(ids[:1], base, layout_id="L")
    layout = mp.snapshots.packed.open_layout("L")
    with layout.open_member(ids[0]) as r:
        n = r.num_blocks("layer0/w", BS)
        assert n >= 4
        sel = list(range(n))
        before = stats.snapshot()
        out = r.read_blocks_coalesced("layer0/w", sel, BS, "expert")
        d = stats.delta_since(before)
        calls = (
            stats.read["expert_packed"].calls
            - before["read"].get("expert_packed", {}).get("calls", 0)
        )
        # a member's unique blocks are appended consecutively at repack:
        # the whole selection collapses into far fewer physical reads
        assert calls < n
        for b in sel:
            np.testing.assert_array_equal(
                out[b], r.read_block("layer0/w", b, BS, "expert")
            )
        assert d["expert_packed_read"] == sum(
            arr.nbytes for arr in out.values()
        )
    layout.close()
    mp.close()


def test_repack_recovery_rejects_mismatched_request(tmp_path):
    """Crash recovery only adopts a disk layout that matches the repack
    request; asking for different members/base under the same id errors
    instead of returning a success-shaped report for the wrong fleet."""
    mp, base, ids = build_fleet(tmp_path)
    mp.snapshots.packed.repack(base, ids[:1], BS, layout_id="L", catalog=None)
    with pytest.raises(ValueError, match="different contents"):
        mp.repack(ids[:2], base, layout_id="L")
    # ... but the matching request recovers cleanly
    rep = mp.repack(ids[:1], base, layout_id="L")
    assert rep["recovered"]
    mp.close()


def test_forced_inapplicable_layout_warns(tmp_path):
    """Forcing a layout that cannot serve the merge falls back to flat
    with an explicit warning (misconfiguration must not be silent)."""
    from repro_torch.api.spec import MergeSpec

    mp, base, ids = build_fleet(tmp_path)
    mp.repack(ids[:2], base, layout_id="L")
    sess = mp.session()
    spec = MergeSpec.build(base, ids[:3], op="avg", reuse_plan=False)
    with pytest.warns(UserWarning, match="does not apply"):
        res = sess.run(spec, sid="warned", compute="stream",
                       prefer_packed="L")
    assert sess.explain("warned")["layout_id"] is None
    mp.close()


def test_repack_dedupes_repeated_model_ids(tmp_path):
    """Duplicate ids in a repack request must not pack twice (which would
    brick the layout on the catalog's member primary key)."""
    mp, base, ids = build_fleet(tmp_path)
    rep = mp.repack(["e0", "e0", "e1"], base, layout_id="L")
    assert rep["members"] == ["e0", "e1"]
    assert mp.catalog.packed_layout_members("L") == ["e0", "e1"]
    mp.close()


def test_elided_synthesis_never_charges_expert_bytes(tmp_path):
    """Reading a packed member directly (outside a merge) synthesizes
    elided blocks from the base checkpoint tagged 'base' — elided blocks
    move zero expert bytes on every surface."""
    stats = IOStats()
    mp, base, ids = build_fleet(tmp_path, stats=stats)
    mp.repack(ids[:1], base, layout_id="L")
    layout = mp.snapshots.packed.open_layout("L")
    with layout.open_member("e0") as r:
        elided = r.elided_blocks("layer0/frozen")
        assert elided
        before = stats.snapshot()
        for b in sorted(elided):
            r.read_block("layer0/frozen", b, BS, "expert")
        d = stats.delta_since(before)
        assert d["expert_read"] == 0 and d["expert_packed_read"] == 0
        assert d["base_read"] > 0  # the synthesis bytes, honestly tagged
    layout.close()
    mp.close()
