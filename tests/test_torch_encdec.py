"""The port's audio family (Whisper's encoder–decoder, ``EncDecLM``) and
the cross-attention it shares with the vision family, against the JAX
package on the CPU: ``cross_attention`` with Sq ≠ Sk; the encoder; the
model's forward, loss, gradients (against ``jax.grad``), prefill (logits,
the self and cross caches) and decode steps on weights carried across,
with the norms and the cross-attention gates redrawn (at init the gates
are zero, and the encoder reaches nothing); prefill plus decode steps
against the forward over the extended sequence.  Inputs (tokens and the
stubbed frontend's frame embeddings) are made with numpy from a seed and
handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402

from torch_models import (  # noqa: E402
    check_cache_specs,
    check_forward_loss_grads,
    check_prefill_decode,
    close,
    models,
    tokens,
)

ARCH = "whisper-tiny"
# one module, float32 on both sides, matmul sums in another order
MOD_TOL = 2e-5


def _norm(rng, s):
    return 0.2 * rng.normal(size=s)


# the zero-initialised leaves, redrawn: every norm and the gates
DRAWS = {name: _norm for name in ("enc_ln1", "enc_ln2", "enc_ln_f",
                                  "dec_ln1", "dec_lnx", "dec_ln2", "ln_f")}
DRAWS["gate"] = lambda rng, s: rng.uniform(0.4, 1.2, size=s)


def _audio(cfg, b=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("sq", [1, 5, 17])
def test_cross_attention_matches_jax(sq):
    """q from 5 (or 1, or 17) decoder positions over a context of 12, GQA
    4 / 2, a nonzero gate; the parameters the port draws have the
    reference's names and shapes."""
    cfg = get_smoke_config("llama-3.2-vision-90b")
    jp, _ = jattn.init_cross_attention(jax.random.PRNGKey(0),
                                       jax_smoke_config(
                                           "llama-3.2-vision-90b"), 1,
                                       jnp.float32)
    tp = tattn.init_cross_attention(cfg, 1, torch.Generator().manual_seed(0),
                                    "cpu", torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert not tp["gate"].any()               # zeros at init
    rng = np.random.default_rng(sq)
    p = {k: (rng.normal(size=v.shape) / np.sqrt(cfg.d_model)).astype(
        np.float32)[0] for k, v in jp.items()}
    p["gate"] = np.float32(0.8)
    x = rng.normal(size=(2, sq, cfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    want = jattn.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jnp.asarray(ctx), cfg)
    got = tattn.cross_attention({k: torch.from_numpy(np.asarray(v))
                                 for k, v in p.items()},
                                torch.from_numpy(x), torch.from_numpy(ctx),
                                cfg)
    assert got.shape == (2, sq, cfg.d_model)
    close(got, want, MOD_TOL)


def test_build_model_returns_encdec():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    assert isinstance(model, EncDecLM)
    assert model.cache_batch_axes() == {"k": 1, "v": 1, "xk": 1, "xv": 1}


def test_encoder_matches_jax():
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    audio = _audio(cfg)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(audio))
    close(got, jmodel.encode(params, jnp.asarray(audio)))


def test_zero_gates_hide_the_encoder():
    """At init the cross-attention gates are zero (llama-vision's tanh
    gate), so the logits do not depend on the audio: a parity test at
    init would never reach the cross-attention."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens((1, 6), cfg.vocab_size)).long()
    with torch.no_grad():
        a = model(toks, torch.from_numpy(_audio(cfg, 1, seed=1)))
        b = model(toks, torch.from_numpy(_audio(cfg, 1, seed=2)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, _, _, drawn = models(ARCH, DRAWS)
    with torch.no_grad():
        a = drawn(toks, torch.from_numpy(_audio(cfg, 1, seed=1)))
        b = drawn(toks, torch.from_numpy(_audio(cfg, 1, seed=2)))
    assert float((a - b).abs().max()) > 1e-3


def test_forward_loss_and_grads_match_jax():
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    check_forward_loss_grads(jmodel, params, model,
                             tokens((2, 13), cfg.vocab_size), _audio(cfg),
                             "audio_embeds")


@pytest.mark.parametrize("s", [13, 5])
def test_prefill_and_decode_match_jax(s):
    """Prefill's logits and its k / v and cross xk / xv caches, then five
    decode steps from caches of 20 positions."""
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    check_prefill_decode(jmodel, params, model,
                         tokens((2, s), cfg.vocab_size, seed=2), 5, 20,
                         _audio(cfg, seed=4))


def test_prefill_and_decode_equal_the_forward():
    """The cross k / v computed once at prefill serve every decode step:
    prefill plus decode steps give the forward's logits over the
    extended sequence."""
    cfg, _, _, model = models(ARCH, DRAWS)
    audio = torch.from_numpy(_audio(cfg, seed=5))
    toks = tokens((2, 11), cfg.vocab_size, seed=6)
    with torch.no_grad():
        want = model(torch.from_numpy(toks).long(), audio)
    logits, cache = model.prefill(torch.from_numpy(toks[:, :7]).long(), audio)
    full = model.init_cache(2, 16)
    for name in ("k", "v"):
        full[name][:, :, :7] = cache[name]
    for name in ("xk", "xv"):
        full[name].copy_(cache[name])
    full["len"] = cache["len"]
    close(logits[:, 0], want[:, 6])
    for i in range(7, 11):
        logits, full = model.decode_step(
            torch.from_numpy(toks[:, i:i + 1]).long(), full)
        close(logits[:, 0], want[:, i])


def test_cache_specs_match_jax():
    _, jmodel, _, model = models(ARCH, DRAWS)
    check_cache_specs(jmodel, model)
