"""The port's attention against the JAX package on the CPU: the plain
flash attention (the kernel's CPU path) against the JAX chunked
``flash_attention`` and the Pallas kernel in interpret mode, with and
without ``skip_masked_chunks``; ``decode_attention``; ``qkv_project``;
and the layers it is built from.  Inputs are made with numpy from a
seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

# (B, Sq, Sk, H, Hkv, hd, causal, window, q_offset): tests/test_kernels.py
FA_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0),    # GQA causal
    (1, 50, 50, 4, 1, 8, True, 13, 0),    # MQA local window
    (2, 33, 70, 6, 6, 16, False, 0, 0),   # cross (ragged, MHA)
    (1, 1, 40, 4, 2, 16, True, 0, 39),    # decode-style single query
]
# tests/test_kernels.py:133,149: float32 sums in another order (2e-5);
# bf16 outputs one bf16 rounding apart (2e-2)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(case, seed=0):
    b, sq, sk, h, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("skip", [False, True], ids=["scan", "skip"])
@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_attention_matches_jax(case, skip):
    causal, window, q_offset = case[6:]
    arrs = _qkv(case)
    want = jattn.flash_attention(*_jax(arrs, "float32"), causal=causal,
                                 window=window, q_offset=q_offset, cq=16,
                                 ck=16, skip_masked_chunks=skip)
    got = tattn.flash_attention(*_torch(arrs, "float32"), causal=causal,
                                window=window, q_offset=q_offset, cq=16,
                                ck=16, skip_masked_chunks=skip)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_attention_matches_pallas_interpret(case, dtype):
    """The kernel's plain version against the TPU kernel it replaces."""
    causal, window, q_offset = case[6:]
    arrs = _qkv(case, seed=1)
    want = flash_attention_pallas(*_jax(arrs, dtype), causal=causal,
                                  window=window, q_offset=q_offset, cq=16,
                                  ck=16, interpret=True)
    got = tfa.flash_attention(*_torch(arrs, dtype), causal=causal,
                              window=window, q_offset=q_offset,
                              skip_masked_chunks=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (B, S, H, Hkv, hd, causal, window): training shapes (q_offset 0)
GRAD_CASES = [
    (2, 40, 4, 2, 16, True, 0),     # GQA causal
    (1, 50, 4, 1, 8, True, 13),     # MQA local window
    (1, 33, 6, 2, 16, True, 7),     # GQA window, ragged chunks
    (2, 24, 4, 4, 8, False, 0),     # MHA, no mask
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_plain_flash_attention_grads_match_jax(case):
    """dq, dk, dv by autograd through the plain version (the CPU path of
    ``flash_attention``) against ``jax.grad`` of the JAX package's
    chunked attention, float32, on the same upstream gradient."""
    b, s, h, hkv, hd, causal, window = case
    arrs = _qkv((b, s, s, h, hkv, hd))
    do = np.random.default_rng(5).normal(size=(b, s, h, hd)).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, window=window,
                                  cq=16, ck=16)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    qkv = [t.requires_grad_() for t in _torch(arrs, "float32")]
    out = tattn.flash_attention(*qkv, causal=causal, window=window, cq=16,
                                ck=16)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_fully_masked_rows_give_zero():
    """Window 1 with q_offset past every key: each row attends nothing."""
    arrs = _qkv((1, 4, 8, 2, 1, 8))
    got = tattn.flash_attention(*_torch(arrs, "float32"), causal=True,
                                window=1, q_offset=20)
    want = jattn.flash_attention(*_jax(arrs, "float32"), causal=True,
                                 window=1, q_offset=20)
    assert not np.any(_f32(got))
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("length", [1, 17, 24])
def test_decode_attention_matches_jax(length, window):
    rng = np.random.default_rng(length)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 24, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 24, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(length),
                                  window=window)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), length, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_qkv_project_matches_jax(arch):
    """QKV bias (qwen2) and qk-norm (qwen3), RoPE at rope_theta."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    rng = np.random.default_rng(2)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
         "bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd),
         "q_norm": (hd,), "k_norm": (hd,)}
    p = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7))
    want = jattn.qkv_project({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn.qkv_project({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg,
                            torch.from_numpy(pos.copy()))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-5)


def test_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    np.testing.assert_allclose(
        _f32(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        _f32(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    mlp = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in
           {"w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32)}.items()}
    np.testing.assert_allclose(
        _f32(tlayers.swiglu_mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                                torch.from_numpy(x))),
        _f32(jlayers.swiglu_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                                jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    xr = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6) * 1000, (2, 6)).copy()
    np.testing.assert_allclose(
        _f32(tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                                1e6)),
        _f32(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5))
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(tlayers.softmax_cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m))),
            float(jlayers.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m))),
            rtol=1e-6)


def test_kernel_checks_refuse_cpu_operands():
    q, k, v = _torch(_qkv((1, 8, 8, 4, 2, 16)), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(q, k, v, 0, 0)


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_route_rule(dtype, hd):
    """bf16 with hd >= 16 goes to the tensor-core kernel; float32 and bf16
    with hd = 8 to the FMA kernel."""
    route = tfa._route(getattr(torch, dtype), hd)
    assert route == ("tc" if dtype == "bfloat16" and hd >= 16 else "fma")
    assert route in tfa.ROUTES


def test_tc_alignment_check():
    """The tensor-core route's operand rule: 16-byte storage starts and
    b / s / h strides in multiples of 8 elements (a dimension of length 1
    has no stride to check)."""
    qkv = torch.zeros((2, 40, 8, 64), dtype=torch.bfloat16)
    tfa._check_tc(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
    tfa._check_tc(torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
                  .as_strided((1, 1, 4, 16), (3, 5, 16, 1)))
    buf = torch.zeros(4 * 8 * 16 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_tc(buf[1:513].view(1, 8, 4, 16))       # 2-byte offset
    tfa._check_tc(buf[8:520].view(1, 8, 4, 16))           # 16-byte offset
    wide = torch.zeros((1, 8, 2, 20), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa._check_tc(wide[..., :16])                     # h stride 20


def test_launch_refuses_unknown_route():
    q, k, v = _torch(_qkv((1, 8, 8, 4, 2, 16)), "bfloat16")
    with pytest.raises(ValueError, match="route"):
        tfa.launch(q, k, v, True, 0, 0, route="wgmma")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch(q, k, v, True, 0, 0, route="tc")       # CPU operands
