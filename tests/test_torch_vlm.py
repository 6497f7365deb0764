"""The port's vision family (Llama-3.2-Vision's gated cross-attention,
``VisionLM``) against the JAX package on the CPU: parameters stacked
(n_super, cross_attn_every, ...) as the reference's; forward, loss,
gradients (against ``jax.grad``), prefill (logits, the self k / v with
the batch on axis 2 and the vision xk / xv with it on axis 1) and decode
steps on weights carried across, with the norms and the cross-attention
gates redrawn; a super-block runs the cross sub-layer then
``cross_attn_every`` self layers, as the reference's code does; prefill
plus decode steps against the forward over the extended sequence.
Inputs (tokens and the stubbed frontend's patch embeddings) are made
with numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.vlm import VisionLM  # noqa: E402

from torch_models import (  # noqa: E402
    check_cache_specs,
    check_forward_loss_grads,
    check_prefill_decode,
    close,
    models,
    tokens,
)

ARCH = "llama-3.2-vision-90b"


def _norm(rng, s):
    return 0.2 * rng.normal(size=s)


# the zero-initialised leaves, redrawn: every norm and the gates
DRAWS = {name: _norm for name in ("ln1", "ln2", "ln_x", "ln_f")}
DRAWS["gate"] = lambda rng, s: rng.uniform(0.4, 1.2, size=s)


def _vision(cfg, b=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def test_build_model_returns_vlm():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, VisionLM)
    assert model.n_super == cfg.n_layers // cfg.cross_attn_every == 2
    assert model.attn["wq"].shape[:2] == (2, cfg.cross_attn_every)
    assert model.xattn["gate"].shape == (2,)
    assert model.cache_batch_axes() == {"k": 2, "v": 2, "xk": 1, "xv": 1}
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        VisionLM(dataclasses.replace(cfg, n_layers=5), device="cpu")


def test_super_block_is_cross_then_every_self_layer():
    """A super-block runs the cross sub-layer, then all cross_attn_every
    self layers (the reference's code, not its docstring's every - 1):
    counted by the flash attention calls of one forward."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    calls = []
    real = tattn.flash_attention

    def counting(q, k, v, causal=True, **kw):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal=causal, **kw)

    tattn.flash_attention = counting
    try:
        with torch.no_grad():
            model(torch.from_numpy(tokens((1, 6), cfg.vocab_size)).long(),
                  torch.from_numpy(_vision(cfg, 1)))
    finally:
        tattn.flash_attention = real
    ce, sv = cfg.cross_attn_every, cfg.vision_tokens
    assert calls == [(False, 6, sv)] + [(True, 6, 6)] * ce + \
        [(False, 6, sv)] + [(True, 6, 6)] * ce


def test_forward_loss_and_grads_match_jax():
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    check_forward_loss_grads(jmodel, params, model,
                             tokens((2, 13), cfg.vocab_size), _vision(cfg),
                             "vision_embeds")


@pytest.mark.parametrize("s", [13, 5])
def test_prefill_and_decode_match_jax(s):
    """Prefill's logits and its k / v and vision xk / xv caches, then five
    decode steps from caches of 20 positions."""
    cfg, jmodel, params, model = models(ARCH, DRAWS)
    check_prefill_decode(jmodel, params, model,
                         tokens((2, s), cfg.vocab_size, seed=2), 5, 20,
                         _vision(cfg, seed=4))


def test_prefill_and_decode_equal_the_forward():
    cfg, _, _, model = models(ARCH, DRAWS)
    vision = torch.from_numpy(_vision(cfg, seed=5))
    toks = tokens((2, 11), cfg.vocab_size, seed=6)
    with torch.no_grad():
        want = model(torch.from_numpy(toks).long(), vision)
    logits, cache = model.prefill(torch.from_numpy(toks[:, :7]).long(),
                                  vision)
    full = model.init_cache(2, 16)
    for name in ("k", "v"):
        full[name][:, :, :, :7] = cache[name]
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
