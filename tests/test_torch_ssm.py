"""The port's SSM family (Mamba-2's SSD, ``repro_torch.models.ssm`` and
``Mamba2LM``) against the JAX package on the CPU: the chunked SSD with
and without an initial state at lengths below, equal to and past a
multiple of the chunk; the mixer block and its decode step on the same
weights and inputs; ``Mamba2LM``'s forward, loss, gradients (against
``jax.grad``), prefill caches and decode steps on weights carried across,
with the norms and the SSM's biases redrawn so every term counts; the
serve engine's greedy tokens against the JAX engine's.  Two deliberate
differences are pinned: the SSD's gradient is finite where the
reference's is NaN (its exp before the causal mask overflows), and a
prompt shorter than the conv's K - 1 tokens decodes (the reference's
conv history is too short for its decode step).  Inputs are made with
numpy from a seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402
from repro_torch.models.mamba_model import Mamba2LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

from torch_models import (  # noqa: E402
    check_cache_specs,
    check_forward_loss_grads,
    check_prefill_decode,
    close,
    models,
    tokens,
)

ARCH = "mamba2-2.7b"
# ROADMAP's compute contract for float32 modules, with the SSD's einsums
# summed in another order (chunk sums of up to 8 terms of O(1))
MOD_TOL = 1e-5
# the zero- or one-initialised leaves, redrawn: norms, conv bias, decay
# rate, skip and step bias
DRAWS = {
    "ln": lambda rng, s: 0.2 * rng.normal(size=s),
    "ln_f": lambda rng, s: 0.2 * rng.normal(size=s),
    "out_norm": lambda rng, s: 0.2 * rng.normal(size=s),
    "conv_b": lambda rng, s: 0.2 * rng.normal(size=s),
    "A_log": lambda rng, s: 0.5 * rng.normal(size=s),
    "D": lambda rng, s: 1.0 + 0.3 * rng.normal(size=s),
    "dt_bias": lambda rng, s: 0.5 * rng.normal(size=s),
}


def _ssd_inputs(t, h=2, p=4, n=8, lo=-0.5, hi=-0.05, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            rng.uniform(lo, hi, size=(b, t, h)).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


def _block_params(cfg, seed=0):
    """One mixer layer's weights (the reference's names and shapes),
    numpy float32, every bias and rate drawn."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    d_in, h, n = ssm.ssm_dims(cfg)
    c, k = d_in + 2 * n, cfg.conv_kernel
    return {
        "in_proj": (rng.normal(size=(d, 2 * d_in + 2 * n + h))
                    / np.sqrt(d)).astype(np.float32),
        "conv_w": (rng.normal(size=(k, c)) / np.sqrt(k)).astype(np.float32),
        "conv_b": (0.2 * rng.normal(size=(c,))).astype(np.float32),
        "A_log": (0.5 * rng.normal(size=(h,))).astype(np.float32),
        "D": (1.0 + 0.3 * rng.normal(size=(h,))).astype(np.float32),
        "dt_bias": (0.5 * rng.normal(size=(h,))).astype(np.float32),
        "out_norm": (0.2 * rng.normal(size=(d_in,))).astype(np.float32),
        "out_proj": (rng.normal(size=(d_in, d))
                     / np.sqrt(d_in)).astype(np.float32),
    }


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


# ------------------------------------------------------------------- SSD
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("t", [5, 8, 19], ids=["below", "equal", "ragged"])
def test_ssd_chunked_matches_jax(t, with_s0):
    """Chunk 8: one short chunk, one whole chunk, and three chunks padded
    at the end; y and the final state."""
    xh, la, bm, cm, s0 = _ssd_inputs(t)
    s0 = s0 if with_s0 else None
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (xh, la, bm, cm)), 8,
                              None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*map(torch.from_numpy, (xh, la, bm, cm)), 8,
                             None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (2, t, 2, 4) and ts.shape == (2, 2, 4, 8)
    close(ty, jy, MOD_TOL)
    close(ts, js, MOD_TOL)


def test_ssd_chunked_equals_the_recurrence():
    """The chunked SSD against the plain recurrence, step by step in
    float64: S_t = a_t S_{t-1} + x̄_t B_tᵀ, y_t = S_t C_t."""
    xh, la, bm, cm, s0 = _ssd_inputs(19, seed=4)
    y, s_fin = ssm.ssd_chunked(*map(torch.from_numpy, (xh, la, bm, cm)), 8,
                               torch.from_numpy(s0))
    s = s0.astype(np.float64)
    ys = []
    for i in range(19):
        s = (np.exp(la[:, i])[..., None, None] * s
             + np.einsum("bhp,bn->bhpn", xh[:, i], bm[:, i]))
        ys.append(np.einsum("bhpn,bn->bhp", s, cm[:, i]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_fin.numpy(), s, rtol=1e-4, atol=1e-4)


def _ssd_grads(inputs, chunk):
    """y, the final state and d(loss)/d(log decay) of loss = Σ y·w + Σ
    s·w2, in both packages."""
    xh, la, bm, cm, _ = inputs
    rng = np.random.default_rng(9)
    w = rng.normal(size=xh.shape).astype(np.float32)
    w2 = rng.normal(size=(xh.shape[0], xh.shape[2], xh.shape[3],
                          bm.shape[-1])).astype(np.float32)

    def jloss(la_):
        y, s = jssm.ssd_chunked(jnp.asarray(xh), la_, jnp.asarray(bm),
                                jnp.asarray(cm), chunk)
        return jnp.sum(y * w) + jnp.sum(s * w2), (y, s)

    (_, (jy, js)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(la))
    tla = torch.from_numpy(la).requires_grad_()
    ty, ts = ssm.ssd_chunked(torch.from_numpy(xh), tla, torch.from_numpy(bm),
                             torch.from_numpy(cm), chunk)
    ((ty * torch.from_numpy(w)).sum() + (ts * torch.from_numpy(w2)).sum()
     ).backward()
    return (jy, js, np.asarray(jg)), (ty, ts, tla.grad)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """Deliberate difference: 256 steps of log-decay in [-1.5, -0.5] in
    chunks of 128 sum to ~128 a chunk, so the reference's exp(cum_i -
    cum_j) overflows above the diagonal before its mask; its forward is
    still right but its gradient is NaN.  The port masks the exponent
    first: the same forward, a finite gradient, and on small decays
    (log-decay in [-0.05, -0.01]) the reference's gradient.  rtol / atol
    1e-4: chunk sums of up to 128 float32 terms in another order."""
    inputs = _ssd_inputs(256, h=2, p=4, n=8, lo=-1.5, hi=-0.5, b=1)
    (jy, js, jg), (ty, ts, tg) = _ssd_grads(inputs, 128)
    assert np.isfinite(np.asarray(jy)).all()
    close(ty, jy, 1e-4)
    close(ts, js, 1e-4)
    assert not np.isfinite(jg).all()          # the reference's NaN
    assert torch.isfinite(tg).all()

    small = _ssd_inputs(256, h=2, p=4, n=8, lo=-0.05, hi=-0.01, b=1)
    (jy, js, jg), (ty, ts, tg) = _ssd_grads(small, 128)
    assert np.isfinite(jg).all()
    close(ty, jy, 1e-4)
    close(tg, jg, 1e-4)


# ------------------------------------------------------------------ block
def test_ssm_block_and_decode_step_match_jax():
    cfg = get_smoke_config(ARCH)
    jp, tp = _both(_block_params(cfg, seed=2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    close(ssm.ssm_block(tp, torch.from_numpy(x), cfg),
          jssm.ssm_block(jp, jnp.asarray(x), cfg), MOD_TOL)

    d_in, h, n = ssm.ssm_dims(cfg)
    state = {"s": rng.normal(size=(2, h, cfg.ssm_head_dim, n)).astype(
                 np.float32),
             "conv": rng.normal(size=(2, cfg.conv_kernel - 1,
                                      d_in + 2 * n)).astype(np.float32)}
    x1 = x[:, :1]
    jo, js = jssm.ssm_decode_step(
        jp, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in state.items()},
        cfg)
    to, ts = ssm.ssm_decode_step(
        tp, torch.from_numpy(x1),
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg)
    close(to, jo, MOD_TOL)
    assert set(ts) == set(js) == {"s", "conv"}
    for k in ts:
        close(ts[k], js[k], MOD_TOL)


def test_decode_steps_equal_the_block():
    """T decode steps from a zero state give the block's outputs over the
    sequence (the chunked SSD against the recurrence, conv included)."""
    cfg = get_smoke_config(ARCH)
    _, tp = _both(_block_params(cfg, seed=5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 19, cfg.d_model)).astype(np.float32))
    want = ssm.ssm_block(tp, x, cfg)
    d_in, h, n = ssm.ssm_dims(cfg)
    state = {"s": torch.zeros((2, h, cfg.ssm_head_dim, n)),
             "conv": torch.zeros((2, cfg.conv_kernel - 1, d_in + 2 * n))}
    outs = []
    for i in range(19):
        o, state = ssm.ssm_decode_step(tp, x[:, i:i + 1], state, cfg)
        outs.append(o)
    close(torch.cat(outs, 1), want.detach(), MOD_TOL)


# ------------------------------------------------------------------ model
def test_build_model_returns_mamba():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    assert isinstance(model, Mamba2LM)
    assert model.cache_batch_axes() == {"s": 1, "conv": 1}


def test_forward_loss_and_grads_match_jax():
    _, jmodel, params, model = models(ARCH, DRAWS)
    check_forward_loss_grads(jmodel, params, model,
                             tokens((2, 13), model.cfg.vocab_size))


def test_remat_gives_the_same_gradients():
    import dataclasses

    _, jmodel, params, model = models(ARCH, DRAWS)
    toks = torch.from_numpy(tokens((2, 13), model.cfg.vocab_size)).long()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    model.loss_fn(batch).backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.cfg = dataclasses.replace(model.cfg, remat=True)
    model.loss_fn(batch).backward()
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=0, atol=0)


@pytest.mark.parametrize("s", [13, 8, 3], ids=["ragged", "chunk", "short"])
def test_prefill_and_decode_match_jax(s):
    """Prefill over 13 (two chunks, the second short), 8 (one chunk) and 3
    tokens (= K - 1), then five decode steps."""
    _, jmodel, params, model = models(ARCH, DRAWS)
    check_prefill_decode(jmodel, params, model,
                         tokens((2, s), model.cfg.vocab_size, seed=2), 5, 20)


def test_cache_specs_match_jax():
    _, jmodel, _, model = models(ARCH, DRAWS)
    check_cache_specs(jmodel, model)


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_decodes_where_the_reference_fails(s):
    """Deliberate difference: after a prompt of 1 or 2 tokens (< K - 1 =
    3) the reference's prefill keeps a conv history of s rows, and its
    decode step cannot contract it with the (K, C) conv weight.  The
    port left-pads the history with zeros (what the causal conv saw), so
    prefill plus decode steps give the reference's forward over the
    extended sequence."""
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    toks = tokens((2, s), cfg.vocab_size, seed=7)
    step = tokens((2, 3), cfg.vocab_size, seed=8)
    _, jc = jmodel.prefill(params, jnp.asarray(toks))
    assert jc["conv"].shape[2] == s
    with pytest.raises((TypeError, ValueError)):
        jmodel.decode_step(params, jnp.asarray(step[:, :1]), jc)

    want = np.asarray(jmodel.forward(params, jnp.asarray(
        np.concatenate([toks, step], 1))))
    tl, tc = model.prefill(torch.from_numpy(toks).long())
    assert tuple(tc["conv"].shape[2:3]) == (cfg.conv_kernel - 1,)
    close(tl[:, 0], want[:, s - 1])
    for i in range(3):
        tl, tc = model.decode_step(torch.from_numpy(step[:, i:i + 1]).long(),
                                   tc)
        close(tl[:, 0], want[:, s + i])


def test_engine_tokens_equal_jax_engine():
    """Three requests on two slots (slot recycling), prompts of 12, 3 and
    9 tokens, each state spliced on the batch axis 1."""
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 3, 9)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    JaxServeEngine(jmodel, params, batch_slots=2, max_len=32).run(jreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    ServeEngine(model, batch_slots=2, max_len=32).run(reqs)
    assert all(r.done and len(r.out_tokens) == 6 for r in jreqs + reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


def test_engine_serves_a_one_token_prompt():
    """A 1-token prompt through the engine: greedy tokens equal the
    argmax of the forward over the growing sequence."""
    cfg, _, _, model = models(ARCH, DRAWS)
    prompt = tokens((1,), cfg.vocab_size, seed=5)
    req = Request(rid=0, prompt=prompt, max_new_tokens=4)
    ServeEngine(model, batch_slots=2, max_len=16).run([req])
    seq = list(prompt)
    with torch.no_grad():
        for t in req.out_tokens:
            logits = model(torch.tensor([seq]))
            assert int(torch.argmax(logits[0, -1])) == t
            seq.append(t)
