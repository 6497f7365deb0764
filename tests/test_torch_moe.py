"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU, float32: grok-1's and DeepSeek-V2-Lite's smoke
configs, the per-row dispatch (``moe_ffn``) and the global one
(``moe_ffn_global``), each also at a capacity that binds so pairs are
dropped.  The routing is held first (the same top-k experts and the
same kept pairs), then the values.  Inputs and weights are made with
numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import shardctx  # noqa: E402

# float32 on both sides, sums in another order
TOL = 2e-6
ARCHS = ["grok-1-314b", "deepseek-v2-lite-16b"]
# (arch, capacity_factor or None for the config's, B, S): the smoke
# configs' own capacity, and one that binds (0.5: pairs are dropped)
CASES = [(a, cf, b, s) for a in ARCHS
         for cf, b, s in ((None, 2, 24), (0.5, 2, 64))]
# the global dispatch's capacity is at least 128 pairs an expert: T = 1024
# tokens at capacity factor 0.5 bind it
GLOBAL_CASES = [(a, cf, b, s) for a in ARCHS
                for cf, b, s in ((None, 2, 24), (0.5, 4, 256))]


def _cfgs(arch, cf):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    return cfg, jcfg


def _params(cfg, seed=0):
    """One layer of MoE weights (the reference's names and shapes), numpy
    float32 from a seed; the shared experts where the config has them."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        shapes.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
    return {n: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
            for n, s in shapes.items()}


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _jax_routing(x, router, cfg, cap):
    """The reference's routing of each row of x (R, T, D), as its
    ``row_dispatch`` computes it (moe.py:95-107): top-k expert ids and
    which sorted pairs are kept."""
    k, e = cfg.experts_per_token, cfg.n_experts

    def row(x_row):
        probs = jax.nn.softmax(jnp.einsum("td,de->te", x_row, router), -1)
        _w, idx = jax.lax.top_k(probs, k)
        flat_e = idx.reshape(-1)
        sort_idx = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[sort_idx]
        counts = jnp.bincount(flat_e, length=e)
        starts = jnp.cumsum(counts) - counts
        seg_pos = jnp.arange(flat_e.shape[0]) - starts[sorted_e]
        return idx, sorted_e, seg_pos < cap

    return [np.asarray(a) for a in jax.vmap(row)(jnp.asarray(x))]


def _routing(x, router, cfg, cap):
    """The port's routing: (idx, sorted_e, keep)."""
    _w, idx = tmoe.route(torch.from_numpy(x), torch.from_numpy(router),
                         cfg.experts_per_token)
    _buf, (sorted_e, _slot, keep, _sort) = tmoe.dispatch(
        torch.from_numpy(x), idx, cfg.n_experts, cap)
    return idx.numpy(), sorted_e.numpy(), keep.numpy()


def _hold(got_routing, want_routing, got, want, drops):
    for g, w in zip(got_routing, want_routing):
        np.testing.assert_array_equal(g, w)
    keep = got_routing[2]
    assert (not keep.all()) == drops, keep.mean()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,cf,b,s", CASES)
def test_moe_ffn_matches_jax(arch, cf, b, s):
    """Per-row dispatch: the same experts and kept pairs as the
    reference, then outputs at rtol = atol = 2e-6; the binding case drops
    pairs in both."""
    cfg, jcfg = _cfgs(arch, cf)
    p, x = _params(cfg), _x(b, s, cfg.d_model)
    cap = max(cfg.experts_per_token, tmoe._row_capacity(s, cfg))
    assert cap == max(jcfg.experts_per_token, jmoe._row_capacity(s, jcfg))
    want = np.asarray(jmoe.moe_ffn({n: jnp.asarray(a) for n, a in p.items()},
                                   jnp.asarray(x), jcfg))
    got = tmoe.moe_ffn({n: torch.from_numpy(a) for n, a in p.items()},
                       torch.from_numpy(x), cfg).numpy()
    _hold(_routing(x, p["router"], cfg, cap),
          _jax_routing(x, p["router"], jcfg, cap), got, want,
          drops=cf is not None)


@pytest.mark.parametrize("arch,cf,b,s", GLOBAL_CASES)
def test_moe_ffn_global_matches_jax(arch, cf, b, s):
    """Global dispatch over all B·S tokens, as above."""
    cfg, jcfg = _cfgs(arch, cf)
    p, x = _params(cfg, seed=2), _x(b, s, cfg.d_model, seed=3)
    cap = tmoe._capacity(b * s, cfg)
    assert cap == jmoe._capacity(b * s, jcfg)
    want = np.asarray(jmoe.moe_ffn_global(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jcfg))
    got = tmoe.moe_ffn_global({n: torch.from_numpy(a) for n, a in p.items()},
                              torch.from_numpy(x), cfg).numpy()
    x2 = x.reshape(1, b * s, -1)
    _hold(_routing(x2, p["router"], cfg, cap),
          _jax_routing(x2, p["router"], jcfg, cap), got, want,
          drops=cf is not None)


@pytest.mark.parametrize("seq", [1, 7, 64, 1000, 2048])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_capacities_equal_jax(arch, seq):
    """The per-row and global capacities at the smoke and published
    configs."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      _cfgs(arch, None)):
        assert tmoe._row_capacity(seq, cfg) == jmoe._row_capacity(seq, jcfg)
        assert tmoe._capacity(seq, cfg) == jmoe._capacity(seq, jcfg)


def test_dispatch_drops_overflow_into_the_last_slot():
    """Four pairs on one expert with capacity 2: the first two (in token
    order: the sort is stable) fill slots 0 and 1, the others are dropped
    and add zeros; combine gives the dropped tokens nothing."""
    x = torch.arange(1, 5, dtype=torch.float32).reshape(1, 4, 1)
    idx = torch.zeros((1, 4, 1), dtype=torch.long)
    buf, state = tmoe.dispatch(x, idx, 2, 2)
    assert buf[0, 0, :, 0].tolist() == [1.0, 2.0]
    assert not buf[0, 1].any()
    assert state[2].tolist() == [[True, True, False, False]]
    y = tmoe.combine(buf, state, torch.ones((1, 4, 1)), torch.float32)
    assert y[0, :, 0].tolist() == [1.0, 2.0, 0.0, 0.0]


def test_shardctx_is_the_no_mesh_context():
    """No mesh: constrain is the identity and sharding_for None.  A mesh
    (anything with mesh_dim_names and shape): logical names resolve to
    placements, one per mesh dim, and the MoE sees its batch axes."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    x = torch.ones(3)
    assert shardctx.get_mesh() is None
    assert shardctx.constrain(x, ("batch",)) is x
    assert shardctx.sharding_for(("batch",), (3,)) is None
    assert tmoe._batch_axes(32, None) == ()
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 16, 16))
    shardctx.set_context(mesh, shardctx.train_rules(True))
    try:
        assert shardctx.resolve(("batch", None, "heads"), (64, 5, 16)) == (
            Shard(0), Shard(0), Shard(2))
        # kv_heads 8 cannot divide the model axis: replicated, no error
        assert shardctx.resolve((None, "kv_heads"), (4, 8)) == (
            Replicate(),) * 3
        assert shardctx.sharding_for(("batch",), (64,)) == (
            mesh, (Shard(0), Shard(0), Replicate()))
        assert shardctx.constrain(x, ("batch",)) is x  # a plain tensor
        assert tmoe._batch_axes(32, mesh) == ("pod", "data")
        assert tmoe._batch_axes(3, mesh) == ()
    finally:
        shardctx.set_context(None, None)
    assert shardctx.get_mesh() is None
