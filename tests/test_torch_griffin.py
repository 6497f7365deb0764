"""The port's hybrid family (Griffin / RecurrentGemma: RG-LRU and local
attention) against the JAX package on the CPU: the RG-LRU gates, scan,
block and decode step on the same weights and inputs; ``GriffinLM``'s
forward, loss, prefill (logits and every cache entry) and decode steps
past the attention ring's wrap on weights carried across, with and
without the trailing recurrent layers; the flash kernel's plain version
at RecurrentGemma's head dims (256, 256) against the Pallas kernel in
interpret mode and the JAX chunked attention; and the serve engine's
greedy tokens against the JAX engine's, hybrid and dense.  Inputs are
made with numpy from a seed and handed to both packages."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.store.checkpoint import flatten_tree as jax_flatten_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import build_model, from_jax_flat  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.griffin_model import GriffinLM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.store.checkpoint import flatten_tree  # noqa: E402

ARCH = "recurrentgemma-9b"
# ROADMAP's compute contract for float32 modules: the same operations in
# the same order, matmul sums in another order
MOD_TOL = 2e-6
# whole models, float32 on both sides (tests/test_torch_model.py)
TOL = 1e-4
# the flash kernel's plain version against the Pallas kernel and the JAX
# chunked attention (tests/test_torch_mla.py): float32 sums in another
# order; bf16 outputs one bf16 rounding apart
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(n_layers):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    return (dataclasses.replace(cfg, n_layers=n_layers),
            dataclasses.replace(jcfg, n_layers=n_layers))


def _block_params(cfg, seed=0):
    """One recurrent layer's weights (the reference's names and shapes),
    numpy float32: biases and Λ drawn too, so every term counts."""
    rng = np.random.default_rng(seed)
    d, w, k = cfg.d_model, cfg.rglru_width, cfg.conv_kernel
    shapes = {"w_gate_branch": (d, w), "w_rec_branch": (d, w),
              "conv_w": (k, w), "w_r": (w, w), "w_i": (w, w), "w_out": (w, d)}
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in shapes.items()}
    for n in ("conv_b", "b_r", "b_i"):
        p[n] = (0.3 * rng.normal(size=(w,))).astype(np.float32)
    p["lam"] = (2.0 + 0.5 * rng.normal(size=(w,))).astype(np.float32)
    return p


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


def _close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ RG-LRU layer
def test_gates_match_jax():
    cfg = get_smoke_config(ARCH)
    jp, tp = _both(_block_params(cfg))
    u = np.random.default_rng(1).normal(size=(2, 9, cfg.rglru_width)).astype(
        np.float32)
    ja, jg = jrglru._gates(jp, jnp.asarray(u))
    ta, tg = rglru._gates(tp, torch.from_numpy(u))
    assert ta.dtype == tg.dtype == torch.float32
    _close(ta, ja)
    _close(tg, jg)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("t", [1, 2, 7, 33])
def test_rglru_scan_matches_jax(t, with_h0):
    """The odd–even recursion of ``jax.lax.associative_scan``, with the
    initial state folded into the first step."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.05, 0.99, size=(2, t, 12)).astype(np.float32)
    b = rng.normal(size=(2, t, 12)).astype(np.float32)
    h0 = rng.normal(size=(2, 12)).astype(np.float32) if with_h0 else None
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             None if h0 is None else jnp.asarray(h0))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (2, t, 12)
    _close(got, want)
    # and the recurrence itself, step by step in float64
    h = np.zeros((2, 12)) if h0 is None else h0.astype(np.float64)
    for i in range(t):
        h = a[:, i] * h + b[:, i]
    np.testing.assert_allclose(got[:, -1].numpy(), h, rtol=1e-5, atol=1e-5)


def test_rglru_block_and_decode_step_match_jax():
    cfg = get_smoke_config(ARCH)
    jp, tp = _both(_block_params(cfg, seed=2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    _close(rglru.rglru_block(tp, torch.from_numpy(x), cfg),
           jrglru.rglru_block(jp, jnp.asarray(x), cfg))

    w, km1 = cfg.rglru_width, cfg.conv_kernel - 1
    state = {"h": rng.normal(size=(2, w)).astype(np.float32),
             "conv": rng.normal(size=(2, km1, w)).astype(np.float32)}
    x1 = x[:, :1]
    jo, js = jrglru.rglru_decode_step(
        jp, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in state.items()},
        cfg)
    to, ts = rglru.rglru_decode_step(
        tp, torch.from_numpy(x1),
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg)
    _close(to, jo)
    assert set(ts) == set(js) == {"h", "conv"}
    for k in ts:
        _close(ts[k], js[k])


def test_decode_steps_equal_the_scan():
    """T decode steps from a zero state give the block's outputs over the
    sequence, and the last state is the scan's last element."""
    cfg = get_smoke_config(ARCH)
    _, tp = _both(_block_params(cfg, seed=4))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    want = rglru.rglru_block(tp, x, cfg)
    w, km1 = cfg.rglru_width, cfg.conv_kernel - 1
    state = {"h": torch.zeros((2, w)), "conv": torch.zeros((2, km1, w))}
    outs = []
    for t in range(x.shape[1]):
        out, state = rglru.rglru_decode_step(tp, x[:, t:t + 1], state, cfg)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=1e-5,
                               atol=1e-5)
    u = torch.einsum("btd,dw->btw", x, tp["w_rec_branch"])
    a, gated = rglru._gates(tp, rglru.causal_conv(tp, u, cfg.conv_kernel))
    torch.testing.assert_close(state["h"], rglru.rglru_scan(a, gated)[:, -1],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state["conv"], u[:, -km1:])


# ------------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def _jax_model(n_layers):
    """The JAX model with its entry points jitted, and its params, once
    per depth: eager JAX compiles each primitive at each shape, seconds a
    call."""
    jmodel = jax_build_model(_cfgs(n_layers)[1])
    for name in ("init", "forward", "loss_fn", "prefill", "decode_step"):
        setattr(jmodel, name, jax.jit(getattr(jmodel, name)))
    return jmodel, jmodel.init(jax.random.PRNGKey(n_layers))


def _models(n_layers):
    cfg = _cfgs(n_layers)[0]
    jmodel, params = _jax_model(n_layers)
    model = from_jax_flat(cfg, jax_flatten_tree(params), device="cpu")
    return cfg, jmodel, params, model


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def test_build_model_returns_griffin():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert isinstance(model, GriffinLM)
    assert (model.n_super, model.n_rest) == (1, 2)
    assert cfg == _cfgs(cfg.n_layers)[0]
    want = {k: (v.shape, v.dtype.name)
            for k, v in jax_flatten_tree(_jax_model(cfg.n_layers)[1]).items()}
    got = {k: (v.shape, v.dtype.name) for k, v in flatten_tree(model).items()}
    assert got == want
    # the published model's parameters (the smoke phase's count), from the
    # reference's shapes alone
    from repro.configs import get_config as jax_get_config

    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == \
        9_396_408_320


@pytest.mark.parametrize("n_layers", [5, 6], ids=["rest2", "rest0"])
def test_forward_and_loss_match_jax(n_layers):
    cfg, jmodel, params, model = _models(n_layers)
    assert bool(model.n_rest) == (n_layers % 3 != 0)
    toks = _tokens((2, 13), cfg.vocab_size)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.forward(params,
                                                         jnp.asarray(toks))),
                               rtol=TOL, atol=TOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    loss = model.loss_fn({k: torch.from_numpy(v).long()
                          for k, v in batch.items()})
    loss.backward()        # trains on the CPU: every parameter gets a grad
    assert all(p.grad is not None for p in model.parameters())
    np.testing.assert_allclose(
        float(loss.detach()),
        float(jmodel.loss_fn(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})),
        rtol=TOL)


def _pad_to(small, big_shape):
    """Zero-pad ``small`` at the end of each axis up to ``big_shape``."""
    out = np.zeros(big_shape, np.asarray(small).dtype)
    out[tuple(slice(0, n) for n in small.shape)] = np.asarray(small)
    return out


@pytest.mark.parametrize("s", [13, 5], ids=["past_window", "in_window"])
@pytest.mark.parametrize("n_layers", [5, 6], ids=["rest2", "rest0"])
def test_prefill_and_decode_match_jax(n_layers, s):
    """Prefill's logits and every cache entry (the k / v rings rolled, the
    LRU states, the conv tails), then six decode steps from a cache of 20
    positions, past the ring's wrap at the window of 8."""
    cfg, jmodel, params, model = _models(n_layers)
    toks = _tokens((2, s), cfg.vocab_size, seed=2)
    jl, jc = jmodel.prefill(params, jnp.asarray(toks))
    tl, tc = model.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert tc["len"] == int(jc["len"]) == s
    names = set(jc) - {"len"}
    assert set(tc) - {"len"} == names
    assert ("rest_h" in names) == (n_layers % 3 != 0)
    for name in names:
        assert tuple(tc[name].shape) == jc[name].shape, name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=TOL, atol=TOL)

    jcache = jmodel.init_cache(2, 20)
    tcache = model.init_cache(2, 20)
    assert set(tcache) == set(jcache)
    for name in names:
        assert tuple(tcache[name].shape) == jcache[name].shape
        full = _pad_to(np.asarray(jc[name]), jcache[name].shape)
        jcache[name] = jnp.asarray(full)
        tcache[name].copy_(torch.from_numpy(full))
    jcache["len"], tcache["len"] = jc["len"], tc["len"]
    step = _tokens((2, 6), cfg.vocab_size, seed=3)
    for i in range(6):
        jl, jcache = jmodel.decode_step(params, jnp.asarray(step[:, i:i + 1]),
                                        jcache)
        tl, tcache = model.decode_step(
            torch.from_numpy(step[:, i:i + 1]).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert tcache["len"] == int(jcache["len"]) == s + 6
    for name in names:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=TOL,
                                   atol=TOL)


def test_cache_specs_match_jax():
    cfg, jcfg = _cfgs(5)
    jspec = jax_build_model(jcfg).cache_specs(3, 40)
    model = build_model(cfg, device="cpu")
    spec = model.cache_specs(3, 40)
    assert set(spec) == set(jspec)
    for name, (shape, dtype) in spec.items():
        assert shape == jspec[name].shape
        assert str(dtype).replace("torch.", "") == jspec[name].dtype.name
    # the batch axis of each entry is the one of size 3
    for name, axis in model.cache_batch_axes().items():
        assert spec[name][0][axis] == 3


# ------------------------------------------------- flash attention (256)
# (B, Sq, Sk, H, Hkv, causal, window, q_offset) at (hd, hdv) = (256, 256)
FA_CASES = [
    (1, 40, 40, 4, 1, True, 0, 0),      # causal, one kv head
    (1, 50, 50, 4, 1, True, 13, 0),     # windowed
    (1, 33, 70, 4, 2, True, 17, 0),     # ragged, window, GQA
    (1, 24, 24, 16, 1, True, 8, 0),     # MQA 16 over 1, window
    (1, 9, 40, 4, 1, True, 0, 31),      # appended queries
    (1, 1, 40, 16, 1, True, 8, 39),     # decode-style, window
]


def _qkv(case, seed=0):
    b, sq, sk, h, hkv = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, 256), (b, sk, hkv, 256), (b, sk, hkv, 256))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_attention_256_matches_pallas_interpret(case, dtype):
    """The kernel's plain version at (256, 256) against the TPU kernel it
    replaces; (256, 256) is a pair the card's kernels are built for."""
    assert (256, 256) in tfa.HEAD_DIMS and (256, 256) in tfa.TC_HEAD_DIMS
    causal, window, q_offset = case[5:]
    arrs = _qkv(case, seed=1)
    want = flash_attention_pallas(
        *[jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs],
        causal=causal, window=window, q_offset=q_offset, cq=16, ck=16,
        interpret=True)
    got = tfa.flash_attention(
        *[torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
        causal=causal, window=window, q_offset=q_offset,
        skip_masked_chunks=True)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (*case[:2], case[3], 256)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_attention_256_matches_jax(case):
    """And against the JAX package's chunked attention (the model's
    path), float32, with and without the masked-chunk skip."""
    causal, window, q_offset = case[5:]
    arrs = _qkv(case, seed=2)
    for skip in (False, True):
        want = jattn.flash_attention(*[jnp.asarray(a) for a in arrs],
                                     causal=causal, window=window,
                                     q_offset=q_offset, cq=16, ck=16,
                                     skip_masked_chunks=skip)
        got = tattn.flash_attention(*[torch.from_numpy(a) for a in arrs],
                                    causal=causal, window=window,
                                    q_offset=q_offset, cq=16, ck=16,
                                    skip_masked_chunks=skip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FA_TOL["float32"],
                                   atol=FA_TOL["float32"])


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("arch", [ARCH, "qwen2-1.5b"])
def test_engine_tokens_equal_jax_engine(arch):
    """Three requests on two slots (slot recycling, the shared decode
    length); for the hybrid, prompts longer than its window of 8 (the
    ring's roll at prefill and its wrap while decoding), each spliced on
    its entries' own batch axes."""
    jcfg = jax_smoke_config(arch)
    if arch == ARCH:
        jmodel, params = _jax_model(jcfg.n_layers)
    else:
        jmodel = jax_build_model(jcfg)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 3, 9)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    JaxServeEngine(jmodel, params, batch_slots=2, max_len=32).run(jreqs)
    model = from_jax_flat(get_smoke_config(arch), jax_flatten_tree(params),
                          device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    ServeEngine(model, batch_slots=2, max_len=32).run(reqs)
    assert all(r.done and len(r.out_tokens) == 6 for r in jreqs + reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
