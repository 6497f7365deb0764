"""The port's multi-head latent attention (DeepSeek-V2) against the JAX
package on the CPU: ``mla_project`` and ``mla_expand_kv`` on the same
weights and inputs, and the flash kernel's plain version (its CPU path)
at MLA's head dims, q.k 24 / v 16 (the smoke config) and 192 / 128
(published), against the Pallas kernel ``flash_attention_pallas`` in
interpret mode and the JAX chunked attention: causal, windowed, with a
``q_offset``.  Inputs are made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
# the tolerances of test_torch_attention.py's Pallas comparison
# (tests/test_kernels.py:133,149): float32 sums in another order; bf16
# outputs one bf16 rounding apart
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window, q_offset)
FA_CASES = [
    (2, 40, 40, 4, 4, 24, 16, True, 0, 0),      # smoke dims, causal
    (1, 50, 50, 4, 4, 24, 16, True, 13, 0),     # windowed
    (1, 9, 40, 4, 2, 24, 16, True, 0, 31),      # appended queries, GQA
    (1, 48, 48, 2, 2, 192, 128, True, 0, 0),    # published dims
    (1, 33, 70, 2, 1, 192, 128, True, 17, 0),   # ragged, window, GQA
    (1, 1, 40, 2, 2, 192, 128, True, 0, 39),    # decode-style
]


def _mla_inputs(cfg, b=2, s=7, seed=0):
    """One layer of MLA weights (the reference's names and shapes), x and
    positions, numpy float32 from a seed."""
    rng = np.random.default_rng(seed)
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    shapes = {"wq": (d, h, dn + dr), "w_dkv": (d, r + dr), "ckv_norm": (r,),
              "w_uk": (r, h, dn), "w_uv": (r, h, dv), "wo": (h, dv, d)}
    p = {n: (0.3 * rng.normal(size=sh)).astype(np.float32)
         for n, sh in shapes.items()}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + s), (b, s)).copy()
    return p, x, pos


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_mla_project_and_expand_match_jax(which):
    """q (B, S, H, dn + dr), the normed latent, the roped shared key, and
    the expanded per-head k and v, float32 (sums in another order)."""
    cfg = get_smoke_config(ARCH) if which == "smoke" else get_config(ARCH)
    jcfg = (jax_smoke_config(ARCH) if which == "smoke"
            else jax_get_config(ARCH))
    p, x, pos = _mla_inputs(cfg, s=5 if which == "published" else 7)
    want = jattn.mla_project({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x), jcfg, jnp.asarray(pos))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    got = tattn.mla_project(tp, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos))
    h = cfg.n_heads
    assert got[0].shape == (2, x.shape[1], h,
                            cfg.nope_head_dim + cfg.rope_head_dim)
    assert got[1].shape == (2, x.shape[1], cfg.kv_lora_rank)
    assert got[2].shape == (2, x.shape[1], cfg.rope_head_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    jk, jv = jattn.mla_expand_kv({n: jnp.asarray(a) for n, a in p.items()},
                                 *want[1:], jnp.float32)
    k, v = tattn.mla_expand_kv(tp, *got[1:], torch.float32)
    assert k.shape[-1] == cfg.nope_head_dim + cfg.rope_head_dim
    assert v.shape[-1] == cfg.v_head_dim
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


def _qkv(case, seed=0):
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_attention_mla_matches_pallas_interpret(case, dtype):
    """The kernel's plain version at hd != hdv against the TPU kernel it
    replaces: output (B, Sq, H, hdv)."""
    causal, window, q_offset = case[7:]
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
    assert got.shape == (*case[:2], case[3], case[6])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", FA_CASES[:4])
def test_plain_flash_attention_mla_matches_jax(case):
    """And against the JAX package's chunked attention (the model's
    path), float32, with and without the masked-chunk skip."""
    causal, window, q_offset = case[7:]
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
                                   rtol=TOL["float32"], atol=TOL["float32"])


def test_mla_decode_attention_matches_jax():
    """Decode over an expanded MLA cache: q.k at 24, v at 16."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 24)).astype(np.float32)
    kc = rng.normal(size=(2, 30, 4, 24)).astype(np.float32)
    vc = rng.normal(size=(2, 30, 4, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(17))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), 17)
    assert got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
