"""The port's model stack against the JAX package on the CPU: configs,
parameter names and shapes, forward / prefill / decode_step on weights
carried across (the dense family, grok-1's MoE and DeepSeek-V2-Lite's
MLA + MoE), the flat checkpoint helpers, and every family building on
the CPU (the hybrid family: tests/test_torch_griffin.py; the SSM, audio
and vision families: tests/test_torch_ssm.py, test_torch_encdec.py and
test_torch_vlm.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import arch_ids as jax_arch_ids  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.store.checkpoint import flatten_tree as jax_flatten_tree  # noqa: E402
from repro_torch.configs import arch_ids, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, from_jax_flat, load_flat  # noqa: E402
from repro_torch.store.checkpoint import (  # noqa: E402
    flatten_tree,
    unflatten_like,
)

DENSE = ["qwen2-1.5b", "granite-3-8b", "qwen3-14b", "starcoder2-7b"]
MOE = ["grok-1-314b", "deepseek-v2-lite-16b"]
# f32 on both sides; matmul sums run in another order: 1e-4
TOL = 1e-4


def _jax_model(arch, seed=0):
    model = jax_build_model(jax_smoke_config(arch))
    return model, model.init(jax.random.PRNGKey(seed))


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", jax_arch_ids())
def test_configs_are_the_jax_configs(arch):
    assert arch_ids() == jax_arch_ids()
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
        assert get(arch).param_count() == jget(arch).param_count()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-3-8b", "qwen3-14b",
                                  *MOE])
def test_flat_names_and_shapes_equal_jax(arch):
    _, params = _jax_model(arch)
    want = {k: v.shape for k, v in jax_flatten_tree(params).items()}
    model = build_model(get_smoke_config(arch), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    got = {k: v.shape for k, v in flatten_tree(model).items()}
    assert got == want


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_prefill_decode_match_jax(arch):
    jmodel, params = _jax_model(arch)
    cfg = get_smoke_config(arch)
    model = from_jax_flat(cfg, jax_flatten_tree(params), device="cpu")
    toks = _tokens((2, 13), cfg.vocab_size)
    t = torch.from_numpy(toks).long()

    want = jmodel.forward(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model(t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    with torch.no_grad():
        loss = model.loss_fn({k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
    np.testing.assert_allclose(
        float(loss),
        float(jmodel.loss_fn(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})),
        rtol=TOL)

    jl, jc = jmodel.prefill(params, jnp.asarray(toks))
    tl, tc = model.prefill(t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert tc["len"] == int(jc["len"]) == 13
    names = [n for n in tc if n != "len"]   # k, v; MLA: ckv, krope
    assert set(names) == set(jc) - {"len"}
    for name in names:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=TOL, atol=TOL)

    # three decode steps from a cache padded to 20 positions
    jcache = jmodel.init_cache(2, 20)
    tcache = model.init_cache(2, 20)
    for name in names:
        jcache[name] = jcache[name].at[:, :, :13].set(jc[name])
        tcache[name][:, :, :13] = tc[name]
    jcache["len"] = jc["len"]
    tcache["len"] = tc["len"]
    step = _tokens((2, 3), cfg.vocab_size, seed=1)
    for i in range(3):
        jl, jcache = jmodel.decode_step(params, jnp.asarray(step[:, i:i + 1]),
                                        jcache)
        tl, tcache = model.decode_step(torch.from_numpy(step[:, i:i + 1]).long(),
                                       tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert tcache["len"] == int(jcache["len"]) == 16
    for name in names:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", *MOE])
def test_cache_specs_match_jax(arch):
    jmodel, _ = _jax_model(arch)
    model = build_model(get_smoke_config(arch), device="cpu")
    want = jmodel.cache_specs(3, 40)
    got = model.cache_specs(3, 40)
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape
        assert str(dtype).replace("torch.", "") == want[name].dtype.name


def test_bf16_weights_carry_across_exactly():
    """bf16 params as ml_dtypes arrays or as the store's uint16 words."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"),
                               param_dtype="bfloat16")
    flat = jax_flatten_tree(jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    words = {k: v.view(np.uint16) for k, v in flat.items()}
    for source in (flat, words):
        model = from_jax_flat(cfg, source, device="cpu")
        assert model.attn["wq"].dtype == torch.bfloat16
        out = flatten_tree(model)
        for k, v in words.items():
            np.testing.assert_array_equal(out[k], v)


def test_init_redraws_from_the_generator():
    cfg = get_smoke_config("granite-3-8b")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b.init(torch.Generator().manual_seed(4))
    fa, fb = flatten_tree(a), flatten_tree(b)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    assert np.all(fa["ln1"] == 0)  # norms start at 0 (the 1 + w convention)


def test_checkpoint_round_trip_and_errors():
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "t": torch.arange(5, dtype=torch.int32)},
            "a": torch.ones(2, dtype=torch.bfloat16)}
    flat = flatten_tree(tree, prefix="p/")
    assert sorted(flat) == ["p/a", "p/b/t", "p/b/w"]
    assert flat["p/a"].dtype == np.uint16            # bf16 as storage words
    np.testing.assert_array_equal(flat["p/a"], [0x3F80, 0x3F80])
    back = unflatten_like(tree, flat, prefix="p/")
    np.testing.assert_array_equal(back["b"]["w"], tree["b"]["w"])
    np.testing.assert_array_equal(back["b"]["t"], np.arange(5))
    with pytest.raises(KeyError, match="checkpoint missing tensor 'p/b/w'"):
        unflatten_like(tree, {k: v for k, v in flat.items() if k != "p/b/w"},
                       prefix="p/")
    bad = dict(flat, **{"p/b/w": np.zeros((4, 3), np.float32)})
    with pytest.raises(ValueError, match=r"'p/b/w' has shape \(4, 3\), "
                                         r"model expects \(3, 4\)"):
        unflatten_like(tree, bad, prefix="p/")

    model = build_model(get_smoke_config("qwen2-1.5b"), device="cpu")
    mflat = flatten_tree(model)
    nested = unflatten_like(model, mflat)
    assert set(nested) == {"embed", "attn", "ffn", "ln1", "ln2", "ln_f"}
    assert nested["attn"]["wq"].shape == (2, 64, 4, 16)
    with pytest.raises(KeyError, match="'attn/bq'"):
        load_flat(model, {k: v for k, v in mflat.items() if k != "attn/bq"})
    with pytest.raises(ValueError, match="'ln_f' has shape"):
        load_flat(model, dict(mflat, ln_f=np.zeros(3, np.float32)))


@pytest.mark.parametrize("arch", jax_arch_ids())
def test_build_model_builds_every_family(arch):
    """Every architecture of the configs builds on the CPU, its flat
    names and shapes those of the JAX package's parameter tree."""
    _, params = _jax_model(arch)
    model = build_model(get_smoke_config(arch), device="cpu")
    assert model.device == torch.device("cpu")
    want = {k: v.shape for k, v in jax_flatten_tree(params).items()}
    assert {k: v.shape for k, v in flatten_tree(model).items()} == want
