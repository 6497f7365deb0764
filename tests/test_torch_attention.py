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
    # the served cross-attention shapes cut down: Llama-3.2-Vision's (hd
    # 128, g = 8, Sq != Sk, no mask) and whisper's decoder's (hd 64, Sq !=
    # Sk, no mask)
    (1, 40, 24, 16, 2, 128, False, 0, 0),
    (2, 48, 80, 3, 3, 64, False, 0, 0),
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


# (B, S, H, Hkv, hd, hdv, causal, window): training shapes (q_offset 0),
# at the backward kernels' pairs: hd == hdv, DeepSeek-V2-Lite's MLA (24,
# 16) smoke and (192, 128) published, RecurrentGemma-9B's (256, 256) with
# a window and its smoke config's (16, 16) over one kv head, window 8
GRAD_CASES = [
    (2, 40, 4, 2, 16, 16, True, 0),      # GQA causal
    (1, 50, 4, 1, 8, 8, True, 13),       # MQA local window
    (1, 33, 6, 2, 16, 16, True, 7),      # GQA window, ragged chunks
    (2, 24, 4, 4, 8, 8, False, 0),       # MHA, no mask
    (2, 40, 4, 4, 24, 16, True, 0),      # MLA smoke, causal
    (1, 20, 2, 2, 192, 128, True, 0),    # MLA published, short
    (1, 40, 4, 1, 256, 256, True, 24),   # RecurrentGemma, window
    (2, 30, 4, 1, 16, 16, True, 8),      # RecurrentGemma smoke
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_plain_flash_attention_grads_match_jax(case):
    """dq, dk, dv by autograd through the plain version (the CPU path of
    ``flash_attention``) against ``jax.grad`` of the JAX package's
    chunked attention, float32, on the same upstream gradient."""
    b, s, h, hkv, hd, hdv, causal, window = case
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hdv))]
    do = np.random.default_rng(5).normal(size=(b, s, h, hdv)).astype(
        np.float32)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, window=window,
                                  cq=16, ck=16)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    qkv = [t.requires_grad_() for t in _torch(arrs, "float32")]
    out = tattn.flash_attention(*qkv, causal=causal, window=window, cq=16,
                                ck=16)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    # float32 sums in another order: the error of a sum over the head dim
    # grows as its square root (1e-6 at hd 16, 4e-6 at 256)
    atol = 1e-6 * max(1.0, (max(hd, hdv) / 16) ** 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)


# (B, Sq, Sk, H, Hkv, hd, hdv, causal, window, q_offset): the forward at
# the pairs past hd 128, which the tensor cores run in the warp-specialised
# CTA: DeepSeek-V2-Lite's MLA (192, 128) and RecurrentGemma-9B's (256, 256)
# with a window, each also ragged with Sq != Sk and a q_offset
WIDE_FA_CASES = [
    (1, 20, 20, 2, 2, 192, 128, True, 0, 0),     # MLA, causal
    (1, 13, 29, 2, 1, 192, 128, True, 0, 16),    # ragged, appended queries
    (1, 40, 40, 4, 1, 256, 256, True, 24, 0),    # RecurrentGemma, window
    (1, 11, 37, 4, 2, 256, 256, True, 9, 26),    # ragged, window, offset
]


def _wide(case, seed):
    b, sq, sk, h, hkv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hdv))]


def _wide_atol(hd, hdv):
    # the GRAD_CASES rule: float32 sums in another order, the error of a
    # sum over the head dim growing as its square root
    return 1e-6 * max(1.0, (max(hd, hdv) / 16) ** 0.5)


@pytest.mark.parametrize("case", WIDE_FA_CASES,
                         ids=[f"{c[5]}-{c[6]}-{i}"
                              for i, c in enumerate(WIDE_FA_CASES)])
def test_plain_flash_attention_wide_pairs_match_jax(case):
    """The plain forward (the CPU path of ``flash_attention``) at (192,
    128) and (256, 256) against the JAX package's chunked
    ``flash_attention`` (``src/repro/models/attention.py:92``), float32."""
    hd, hdv, causal, window, q_offset = case[5:]
    arrs = _wide(case, seed=3)
    want = jattn.flash_attention(*_jax(arrs, "float32"), causal=causal,
                                 window=window, q_offset=q_offset, cq=16,
                                 ck=16)
    got = tfa.flash_attention(*_torch(arrs, "float32"), causal=causal,
                              window=window, q_offset=q_offset,
                              skip_masked_chunks=True)
    assert got.shape == (*case[:2], case[3], hdv)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                               atol=_wide_atol(hd, hdv))


@pytest.mark.parametrize("case", WIDE_FA_CASES,
                         ids=[f"{c[5]}-{c[6]}-{i}"
                              for i, c in enumerate(WIDE_FA_CASES)])
def test_plain_flash_attention_wide_pairs_match_pallas_interpret(case):
    """The same cases against the TPU kernel the forward replaces
    (``flash_attention_pallas``, which takes v's own head dim) in
    interpret mode, float32."""
    hd, hdv, causal, window, q_offset = case[5:]
    arrs = _wide(case, seed=4)
    want = flash_attention_pallas(*_jax(arrs, "float32"), causal=causal,
                                  window=window, q_offset=q_offset, cq=16,
                                  ck=16, interpret=True)
    got = tfa.flash_attention(*_torch(arrs, "float32"), causal=causal,
                              window=window, q_offset=q_offset,
                              skip_masked_chunks=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                               atol=_wide_atol(hd, hdv))


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


@pytest.mark.parametrize("hd", [hd for hd, _hdv in tfa.HEAD_DIMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_route_rule(dtype, hd):
    """With hd >= 16 (the pairs of TC_HEAD_DIMS) bf16 goes to the
    tensor-core kernel and float32 to the split-TF32 tensor-core kernel
    ("tf32x3"); hd = 8 (and float16, which no kernel takes) to the FMA
    kernel, at each (hd, hdv) pair.  The backward follows the same rule
    at every pair, MLA's hd != hdv and hd 256 included, but float32 at
    FMA_BACKWARD_PAIRS ((16, 16), where the "tf32x3" backward lost in
    turns), which keeps the FMA backward, from the shapes alone (at a
    narrow pair's short heads, the tensor-core route's one launch); the
    float32 tensor-core plans fit a CTA's 232,448 bytes at the serving
    and training shapes, named where the rule keeps the FMA backward."""
    hdv = dict(tfa.HEAD_DIMS)[hd]
    route = tfa._route(getattr(torch, dtype), hd, hdv)
    assert route == ("fma" if hd < 16 or dtype == "float16"
                     else "tc" if dtype == "bfloat16" else "tf32x3")
    assert route in tfa.ROUTES
    bwd_route = tfa._route(getattr(torch, dtype), hd, hdv, backward=True)
    assert tfa.FMA_BACKWARD_PAIRS == ((16, 16),)
    assert bwd_route == ("fma" if dtype == "float32" and hd == 16
                         else route)
    plan = tfa.backward_plan(2, 64, 64, 4, 2, hd, getattr(torch, dtype),
                             hdv=hdv)
    assert plan["route"] == bwd_route
    if bwd_route == "tc" and (hd, hdv) in tfa.NARROW_PAIRS:
        assert plan["kernels"] == [("fa_bwd_narrow_tc_kernel", (16,))]
    else:
        assert plan["kernels"][1][0] == {
            "tc": "fa_bwd_dkdv_tc_kernel", "tf32x3": "fa_bwd_dkdv_tf32_kernel",
            "fma": "fa_bwd_dkdv_kernel"}[bwd_route]
    if route == "tf32x3":
        for b, s, h, hkv in ((1, 2048, 16, 16), (2, 1024, 12, 2),
                             (1, 3072, 16, 1)):
            fwd = tfa.forward_plan(b, s, s, h, hkv, hd, torch.float32,
                                   hdv=hdv)
            assert fwd["kernel"] == "flash_attention_tf32_kernel"
            assert fwd["smem_bytes"] + fwd["static_smem_bytes"] <= 232448
            bwd = tfa.backward_plan(b, s, s, h, hkv, hd, torch.float32,
                                    "tf32x3", hdv=hdv)
            assert bwd["kernels"][-1][0] == "fa_bwd_dq_tf32_kernel"
            assert max(bwd["smem_bytes"].values()) <= 232448


@pytest.mark.parametrize("hd,hdv", [(256, 128), (192, 192), (128, 64),
                                    (16, 8), (96, 96)])
def test_unported_head_dims_are_refused_before_the_device(hd, hdv):
    """Pairs outside HEAD_DIMS have no kernel and raise ValueError from
    the shapes, naming the pairs that are built, before the operands'
    device: the forward's check, launch(), the backward and its plan on
    every route, and the autograd Function before its forward launches."""
    q = torch.zeros((1, 8, 4, hd), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 4, hdv), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match=r"no kernel is built for head dims "
                                         r".*the kernels take \(hd, hdv\) in "
                                         r".*\(256, 256\)"):
        tfa._check(q, q, v, 0, 0)
    with pytest.raises(ValueError, match="no kernel is built"):
        tfa.launch(q, q, v, True, 0, 0, route="fma")
    for route in (None, "tc", "fma"):
        with pytest.raises(ValueError, match="no kernel is built"):
            tfa.backward_plan(1, 8, 8, 4, 4, hd, torch.bfloat16, route,
                              hdv=hdv)
        with pytest.raises(ValueError, match="no kernel is built"):
            tfa.backward(v, q, q, v, v, lse, True, 0, route=route)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="no kernel is built"):
        tfa.FlashAttentionFn.apply(q, q, v, True, 0)
    assert set(tfa.LAUNCHES.values()) == {0}
    assert tfa._route(torch.bfloat16, hd, hdv) == "fma"


@pytest.mark.parametrize("dtype,hd", [("float32", 16), ("float32", 128),
                                      ("bfloat16", 8)])
def test_backward_tc_route_refuses_before_launch(dtype, hd):
    """``backward(route="tc")`` refuses what the tensor-core route does
    not take (float32, hd 8) from the shapes and dtype alone, before it
    looks at the device; an unknown route too."""
    q, k, v = _torch(_qkv((1, 8, 8, 4, 2, hd)), dtype)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="tensor-core route takes"):
        tfa.backward(q, q, k, v, q, lse, True, 0, route="tc")
    with pytest.raises(ValueError, match="tensor-core route takes"):
        tfa.backward_plan(1, 8, 8, 4, 2, hd, getattr(torch, dtype), "tc")
    with pytest.raises(ValueError, match="route"):
        tfa.backward(q, q, k, v, q, lse, True, 0, route="wgmma")
    with pytest.raises(ValueError, match="CUDA"):            # the FMA route
        tfa.backward(q, q, k, v, q, lse, True, 0, route="fma")


def test_backward_plan_hand_counts():
    """The backward's launches against counts by hand (64-row tiles; the
    reduction's CTAs take 256 threads of four elements; both routes keep
    per-query-head partials where H > Hkv)."""
    bf16 = torch.bfloat16
    # the train step: B 4, S 1024, H 12, Hkv 2, hd 128
    plan = tfa.backward_plan(4, 1024, 1024, 12, 2, 128, bf16)
    assert plan == {"route": "tc", "kernels": [
        ("fa_bwd_preprocess_tc_kernel", (16, 48)),
        ("fa_bwd_dkdv_tc_kernel", (48, 16)),           # 768 CTAs
        ("fa_bwd_gqa_reduce_kernel", (1024,)),         # 4*1024*2*128 / 4 / 256
        ("fa_bwd_dq_tc_kernel", (48, 16))],
        "scratch_floats": 2 * 4 * 1024 * 12 * 128}     # 2 x 25.2 MB
    fma = tfa.backward_plan(4, 1024, 1024, 12, 2, 128, bf16, "fma")
    assert fma["kernels"][1] == ("fa_bwd_dkdv_kernel", (16, 48))  # 768 CTAs
    assert fma["kernels"][2] == ("fa_bwd_gqa_reduce_kernel", (1024,))
    assert fma["scratch_floats"] == 2 * 4 * 1024 * 12 * 128
    # ragged, and MHA (g = 1: no partials, no reduction)
    assert tfa.backward_plan(2, 1000, 1000, 12, 2, 128, bf16)["kernels"][2] \
        == ("fa_bwd_gqa_reduce_kernel", (500,))         # 128,000 / 256
    assert tfa.backward_plan(1, 100, 150, 4, 4, 32, bf16) == {
        "route": "tc", "kernels": [("fa_bwd_preprocess_tc_kernel", (2, 4)),
                                   ("fa_bwd_dkdv_tc_kernel", (4, 3)),
                                   ("fa_bwd_dq_tc_kernel", (4, 2))],
        "scratch_floats": 0}
    assert tfa.backward_plan(1, 200, 200, 6, 2, 8, torch.float32) == {
        "route": "fma", "kernels": [("fa_bwd_preprocess_kernel", (4, 6)),
                                    ("fa_bwd_dkdv_kernel", (4, 6)),
                                    ("fa_bwd_gqa_reduce_kernel", (4,)),
                                    ("fa_bwd_dq_kernel", (4, 6))],
        "scratch_floats": 200 * 6 * (8 + 8)}          # 800 / 256 -> 4


# (name, (B, S, H, Hkv, hd, hdv), dtype, want): the plans of the training
# phases' attention by hand; the grids count 64-row tiles (the FMA route's
# 32-row streamed tiles past hd 128 run inside a CTA, not in its grid)
PAIR_PLANS = [
    # DeepSeek-V2-Lite's MLA at 2 x 2048: H = Hkv, so no partials and no
    # reduction; 2 * 16 (b, head) rows of 32 key tiles
    ("mla_train", (2, 2048, 16, 16, 192, 128), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_preprocess_tc_kernel", (32, 32)),
                                 ("fa_bwd_dkdv_tc_kernel", (32, 32)),
                                 ("fa_bwd_dq_tc_kernel", (32, 32))],
      "scratch_floats": 0}),
    # RecurrentGemma-9B at 1 x 3072, 16 query heads over one kv head (g =
    # 16): partials of 3072 * 16 * (256 + 256) floats (100.7 MB), and the
    # reduction over 3072 * 1 * 256 / 4 = 196,608 threads in 768 CTAs
    ("rg_train", (1, 3072, 16, 1, 256, 256), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_preprocess_tc_kernel", (48, 16)),
                                 ("fa_bwd_dkdv_tc_kernel", (16, 48)),
                                 ("fa_bwd_gqa_reduce_kernel", (768,)),
                                 ("fa_bwd_dq_tc_kernel", (16, 48))],
      "scratch_floats": 3072 * 16 * (256 + 256)}),
    # MLA with GQA (g = 2): dK's partials at 192, dV's at 128, the
    # reduction over max(192, 128) / 4 = 48 column quads a key
    ("mla_gqa", (1, 100, 4, 2, 192, 128), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_preprocess_tc_kernel", (2, 4)),
                                 ("fa_bwd_dkdv_tc_kernel", (4, 2)),
                                 ("fa_bwd_gqa_reduce_kernel", (38,)),
                                 ("fa_bwd_dq_tc_kernel", (4, 2))],
      "scratch_floats": 100 * 4 * (192 + 128)}),     # 9,600 / 256 -> 38
    # the float32 tensor-core route ("tf32x3", the rule's) at (256, 256):
    # the FMA route's D, a dK / dV CTA a query head and 16-key tile (192 a
    # head), the same partials and reduction, a dQ CTA a query tile; K, V
    # and their lo parts (16 x 256 floats each), Q and dO rows (64 x 260),
    # P^T, dS^T and their lo parts (16 x 64 each) or dS and its lo part (64
    # x 32 each) and the rows' lse and D, 1,024 bytes of slack: 216,576
    # bytes either kernel
    ("rg_f32", (1, 3072, 16, 1, 256, 256), torch.float32,
     {"route": "tf32x3",
      "kernels": [("fa_bwd_preprocess_kernel", (48, 16)),
                  ("fa_bwd_dkdv_tf32_kernel", (16, 192)),
                  ("fa_bwd_gqa_reduce_kernel", (768,)),
                  ("fa_bwd_dq_tf32_kernel", (16, 48))],
      "scratch_floats": 3072 * 16 * (256 + 256), "threads": 128, "keys": 16,
      "smem_bytes": {"dkdv": 4 * (4 * 16 * 256 + 2 * 64 * 260 + 4 * 16 * 64
                              + 2 * 64) + 1024,
                     "dq": 4 * (4 * 16 * 256 + 2 * 64 * 260 + 2 * 64)
                     + 2 * 64 * 128 + 1024}}),
    # and at MLA's smoke (24, 16): 32-key tiles, widths padded to 32
    ("mla_smoke", (2, 64, 4, 4, 24, 16), torch.float32,
     {"route": "tf32x3",
      "kernels": [("fa_bwd_preprocess_kernel", (1, 8)),
                  ("fa_bwd_dkdv_tf32_kernel", (8, 2)),
                  ("fa_bwd_dq_tf32_kernel", (8, 1))],
      "scratch_floats": 0, "threads": 128, "keys": 32,
      "smem_bytes": {"dkdv": 62976, "dq": 46592}}),
    # the FMA route, named, at both (a dK / dV CTA a query head and 64-key
    # tile, the same partials and reduction)
    ("rg_f32_fma", (1, 3072, 16, 1, 256, 256), torch.float32,
     {"route": "fma", "kernels": [("fa_bwd_preprocess_kernel", (48, 16)),
                                  ("fa_bwd_dkdv_kernel", (48, 16)),
                                  ("fa_bwd_gqa_reduce_kernel", (768,)),
                                  ("fa_bwd_dq_kernel", (48, 16))],
      "scratch_floats": 3072 * 16 * (256 + 256)}),
    ("mla_smoke_fma", (2, 64, 4, 4, 24, 16), torch.float32,
     {"route": "fma", "kernels": [("fa_bwd_preprocess_kernel", (1, 8)),
                                  ("fa_bwd_dkdv_kernel", (1, 8)),
                                  ("fa_bwd_dq_kernel", (1, 8))],
      "scratch_floats": 0}),
    # the smoke pair in bf16 up to NARROW_MAX_LEN: one launch, a cluster
    # of four CTAs (one a query tile) of four warpgroups (one a key tile)
    # per (b, kv head), no scratch; a CTA's shared memory: K (256 x 32
    # bf16), V (256 x 16), its Q (64 x 32) and dO (64 x 16), lse and D
    # (64 floats each), four warpgroups' P^T, dS^T hi and lo (64 x 64
    # bf16), two sets of four dQ partials (64 x 32 float32), 1,024 bytes
    # of slack
    ("mla_smoke_bf16", (2, 256, 4, 4, 24, 16), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_narrow_tc_kernel", (32,))],
      "scratch_floats": 0, "threads": 512, "cluster": 4,
      "smem_bytes": (256 + 64) * 2 * (32 + 16) + 2 * 64 * 4
      + 4 * 3 * 8192 + 2 * 4 * 64 * 32 * 4 + 1024}),    # 196,096
    # GQA: a cluster per kv head walks its g = 4 query heads
    ("mla_smoke_gqa", (3, 100, 8, 2, 24, 16), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_narrow_tc_kernel", (24,))],
      "scratch_floats": 0, "threads": 512, "cluster": 4,
      "smem_bytes": 196096}),
    # one past the limit: the three kernels (H = Hkv)
    ("mla_smoke_257", (2, 257, 4, 4, 24, 16), torch.bfloat16,
     {"route": "tc", "kernels": [("fa_bwd_preprocess_tc_kernel", (5, 8)),
                                 ("fa_bwd_dkdv_tc_kernel", (8, 5)),
                                 ("fa_bwd_dq_tc_kernel", (8, 5))],
      "scratch_floats": 0}),
]


@pytest.mark.parametrize("shape,dtype,want",
                         [p[1:] for p in PAIR_PLANS],
                         ids=[p[0] for p in PAIR_PLANS])
def test_backward_plan_hand_counts_at_pairs(shape, dtype, want):
    """The backward's launches at hd != hdv and at (256, 256) against
    counts by hand: the scratch is b·sk·h·(hd + hdv) floats where H >
    Hkv, none where H == Hkv.  The rule's route unless the FMA route is
    named (a case ending in ``_fma``)."""
    b, s, h, hkv, hd, hdv = shape
    rule = tfa._route(dtype, hd, hdv)
    assert want["route"] in (rule, "fma")
    assert tfa.backward_plan(b, s, s, h, hkv, hd, dtype,
                             None if want["route"] == rule else "fma",
                             hdv=hdv) == want


# ((hd, hdv), dK / dV layout, its hd-units a warpgroup, dQ layout, its
# hd-units a warpgroup): the tensor-core backward's work per (64-query,
# 64-key) tile by hand, counting a 64 x N product over the tile's 64 rows
# as N (S over hd, dP and dV over hdv, dK and dQ over hd twice: dS as hi
# + lo).  Up to hd 128 one warpgroup, widths padded to 64; past it each
# of two warpgroups does half of every product.  (A split by role, each
# warpgroup computing S (and dP) again, would cost 320 + 704 and 576 +
# 448 at (192, 128), 512 + 1,024 and 768 + 768 at (256, 256).)
TILE_WORK = [
    ((16, 16), "one_warpgroup", [320], "one_warpgroup", [256]),
    # past NARROW_MAX_LEN (narrow=False); test_backward_tile_work_narrow
    # has the one-launch CTA
    ((24, 16), "one_warpgroup", [320], "one_warpgroup", [256]),
    ((32, 32), "one_warpgroup", [320], "one_warpgroup", [256]),
    ((64, 64), "one_warpgroup", [320], "one_warpgroup", [256]),
    ((128, 128), "one_warpgroup", [640], "one_warpgroup", [512]),
    # 96 + 64 + 64 + 2 * 96; 96 + 64 + 2 * 96
    ((192, 128), "by_queries", [416, 416], "by_keys", [352, 352]),
    # 128 + 128 + 128 + 2 * 128; 128 + 128 + 2 * 128
    ((256, 256), "by_columns", [640, 640], "by_keys", [512, 512]),
]


@pytest.mark.parametrize("pair,dkdv_layout,dkdv,dq_layout,dq", TILE_WORK,
                         ids=[f"{p[0][0]}-{p[0][1]}" for p in TILE_WORK])
def test_backward_tile_work_hand_counts(pair, dkdv_layout, dkdv, dq_layout,
                                        dq):
    """The products a tile and each warpgroup's tensor work against
    counts by hand; past hd 128 the warpgroups are balanced (within 25%,
    here equal) and the two CTAs together do S and dP once each plus dV
    and the split dK and dQ: 1,536 hd-units at (192, 128), 2,304 at (256,
    256), against 2,048 and 3,072 for a split by role."""
    work = tfa.backward_tile_work(*pair, narrow=False)
    assert work == {
        "dkdv": {"layout": dkdv_layout,
                 "products": ["S", "dP", "dV", "dK hi", "dK lo"],
                 "hd_units": dkdv},
        "dq": {"layout": dq_layout, "products": ["S", "dP", "dQ hi", "dQ lo"],
               "hd_units": dq}}
    for units in (dkdv, dq):
        assert max(units) <= 1.25 * min(units)
    hd, hdv = pair
    if hd > 128:
        assert sum(dkdv) + sum(dq) == 2 * (hd + hdv) + hdv + 4 * hd
        assert sum(dkdv) + sum(dq) == {192: 1536, 256: 2304}[hd]


def test_backward_tile_work_narrow():
    """The one-launch CTA at (24, 16), the pair's default: four
    warpgroups, each one key tile doing all seven products a (64-query,
    64-key) tile once, at widths padded to the next k16 step (S, dK hi /
    lo, dQ hi / lo at 32; dP, dV at 16): 192 hd-units against the three
    kernels' 320 + 256 (S and dP twice, widths padded to 64).  Refused
    at a pair without it."""
    work = tfa.backward_tile_work(24, 16)
    assert work == {"one_launch": {
        "layout": "key_tile_per_warpgroup",
        "products": ["S", "dP", "dV", "dK hi", "dK lo", "dQ hi", "dQ lo"],
        "hd_units": [192] * 4}}
    assert 192 == 5 * 32 + 2 * 16
    general = tfa.backward_tile_work(24, 16, narrow=False)
    assert sum(general["dkdv"]["hd_units"] + general["dq"]["hd_units"]) \
        == 576
    for pair in ((16, 16), (192, 128)):
        assert "one_launch" not in tfa.backward_tile_work(*pair)
        with pytest.raises(ValueError, match="no one-launch kernel"):
            tfa.backward_tile_work(*pair, narrow=True)


def test_backward_tile_work_refuses_fma_pairs():
    """hd 8 has no tensor-core kernel, nor has a pair outside HEAD_DIMS."""
    for pair in ((8, 8), (96, 96), (128, 64)):
        with pytest.raises(ValueError, match="no tensor-core kernel"):
            tfa.backward_tile_work(*pair)


# (name, (B, Sq, H, Hkv, hd, hdv), dtype, route, want): the forward's launch
# by hand.  Past hd 128 (bf16) the warp-specialised CTA: 128 q rows, 384
# threads, Q (two warpgroups' 64 rows) and a ring of K / V stages (3 at
# (192, 128), 2 at (256, 256)) plus 1,024 bytes of alignment slack, its
# mbarriers padded to 1,024 static bytes; up to hd 128 one warpgroup over
# 64 rows with Q and two K / V stages at widths padded to 64; the FMA
# route's float32 tiles (K rows padded by one, P 65 wide, three row stats)
FORWARD_PLANS = [
    ("mla_prefill", (1, 2048, 16, 16, 192, 128), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_ws_kernel", "grid": (16, 16),
      "threads": 384, "rows": 128, "stages": 3,
      "smem_bytes": 2 * 64 * (2 * 192 + 3 * (192 + 128)) + 1024,   # 173,056
      "static_smem_bytes": 1024}),
    ("mla_train", (2, 2048, 16, 16, 192, 128), torch.bfloat16, "tc",
     {"route": "tc", "kernel": "flash_attention_ws_kernel", "grid": (32, 16),
      "threads": 384, "rows": 128, "stages": 3, "smem_bytes": 173056,
      "static_smem_bytes": 1024}),
    ("rg_prefill", (1, 3072, 16, 1, 256, 256), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_ws_kernel", "grid": (16, 24),
      "threads": 384, "rows": 128, "stages": 2,
      "smem_bytes": 2 * 64 * (2 * 256 + 2 * 512) + 1024,           # 197,632
      "static_smem_bytes": 1024}),
    ("rg_ragged", (3, 129, 4, 1, 256, 256), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_ws_kernel", "grid": (12, 2),
      "threads": 384, "rows": 128, "stages": 2, "smem_bytes": 197632,
      "static_smem_bytes": 1024}),
    ("prefill_128", (1, 2048, 12, 2, 128, 128), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_tc_kernel", "grid": (12, 32),
      "threads": 128, "rows": 64,
      "smem_bytes": 2 * 64 * (3 * 128 + 2 * 128) + 1024,           # 82,944
      "static_smem_bytes": 0}),
    # DeepSeek-V2-Lite's smoke pair up to NARROW_MAX_LEN keys: the narrow
    # CTAs, a cluster of four one-warpgroup CTAs a q tile, one key tile
    # each; a CTA's Q and K tiles 32 wide, its V tile 16 wide, three CTAs'
    # hand-over of 12 floats a thread, 1,024 bytes of slack
    ("mla_smoke", (2, 256, 4, 4, 24, 16), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_narrow_kernel",
      "grid": (32, 4), "threads": 128, "rows": 64, "cluster": 4,
      "smem_bytes": 2 * 64 * (2 * 32 + 16) + 3 * 12 * 128 * 4 + 1024,
      "static_smem_bytes": 0}),                                    # 29,696
    # one key past it: the one-warpgroup kernel, widths padded to 64
    ("mla_smoke_257", (2, 257, 4, 4, 24, 16), torch.bfloat16, None,
     {"route": "tc", "kernel": "flash_attention_tc_kernel", "grid": (8, 5),
      "threads": 128, "rows": 64, "smem_bytes": 2 * 64 * 5 * 64 + 1024,
      "static_smem_bytes": 0}),
    # float32 at MLA's prefill: the rule's tensor-core kernel, one
    # warpgroup a 64-row q tile over 32-key tiles; 12 of Q's 24 k-steps in
    # registers, the other 96 columns in rows of 100 floats, K and its lo
    # part (32 x 192), V^T and its lo part (128 x 32), 1,024 bytes of
    # slack: two CTAs an SM
    ("mla_f32_tf32x3", (1, 2048, 16, 16, 192, 128), torch.float32, None,
     {"route": "tf32x3", "kernel": "flash_attention_tf32_kernel",
      "grid": (16, 32), "threads": 128, "rows": 64, "keys": 32,
      "q_reg_steps": 12,
      "smem_bytes": 4 * (64 * 100 + 2 * 32 * 192 + 2 * 128 * 32) + 1024,
      "static_smem_bytes": 0}),                                    # 108,544
    ("rg_f32_tf32x3", (1, 3072, 16, 1, 256, 256), torch.float32, None,
     {"route": "tf32x3", "kernel": "flash_attention_tf32_kernel",
      "grid": (16, 48), "threads": 128, "rows": 64, "keys": 32,
      "q_reg_steps": 0,
      "smem_bytes": 4 * (64 * 260 + 2 * 32 * 256 + 2 * 256 * 32) + 1024,
      "static_smem_bytes": 0}),                                    # 198,656
    # the FMA kernel, named
    ("mla_f32", (1, 2048, 16, 16, 192, 128), torch.float32, "fma",
     {"route": "fma", "kernel": "flash_attention_kernel", "grid": (32, 16),
      "threads": 256, "rows": 64,
      "smem_bytes": 4 * (64 * 192 + 64 * 193 + 64 * 128 + 64 * 65 + 3 * 64),
      "static_smem_bytes": 0}),
    ("rg_bf16_fma", (1, 3072, 16, 1, 256, 256), torch.bfloat16, "fma",
     {"route": "fma", "kernel": "flash_attention_kernel", "grid": (48, 16),
      "threads": 256, "rows": 64, "smem_bytes": 214272,
      "static_smem_bytes": 0}),
]


@pytest.mark.parametrize("shape,dtype,route,want",
                         [p[1:] for p in FORWARD_PLANS],
                         ids=[p[0] for p in FORWARD_PLANS])
def test_forward_plan_hand_counts(shape, dtype, route, want):
    """The forward's kernel, grid, threads and shared memory from the
    shapes alone against counts by hand; every layout fits the 232,448
    bytes a block may opt into."""
    b, s, h, hkv, hd, hdv = shape
    plan = tfa.forward_plan(b, s, s, h, hkv, hd, dtype, route, hdv=hdv)
    assert plan == want
    assert plan["smem_bytes"] + plan["static_smem_bytes"] <= 232448


def test_forward_plan_refuses():
    """A pair outside HEAD_DIMS, an unknown route, and the tensor-core
    route for float32 or hd 8 raise before anything is built."""
    with pytest.raises(ValueError, match="head dims"):
        tfa.forward_plan(1, 64, 64, 4, 4, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="route"):
        tfa.forward_plan(1, 64, 64, 4, 4, 128, torch.bfloat16, "wgmma")
    for dtype, hd in ((torch.float32, 192), (torch.bfloat16, 8)):
        with pytest.raises(ValueError, match="tensor-core route takes"):
            tfa.forward_plan(1, 64, 64, 4, 4, hd, dtype, "tc",
                             hdv=128 if hd == 192 else hd)


# ((hd, hdv), kernel, rows, roles, hd-units a warpgroup, hd-units per 64
# query rows): the tensor-core forward's work per 64-key tile by hand,
# counting a 64 x N product over a warpgroup's 64 rows as N (S over hd,
# P.V over hdv).  Up to hd 128 one warpgroup copies and multiplies at
# widths padded to 64; past it the producer does no products and each
# consumer hd + hdv.  (The two-warpgroup CTA it replaces at (256, 256)
# computed S in both warpgroups beside a half of P.V each: 2 * 256 + 256 =
# 768 a tile of 64 rows.)
FORWARD_WORK = [
    ((16, 16), "flash_attention_tc_kernel", 64, ["copy_and_multiply"],
     [128], 128),
    # the narrow CTAs (the pair's default): each of four warpgroups (one
    # a CTA of the cluster) one key tile of the range, S at 32, P.V at 16
    ((24, 16), "flash_attention_narrow_kernel", 64, ["key_tile"] * 4,
     [48] * 4, 48),
    ((128, 128), "flash_attention_tc_kernel", 64, ["copy_and_multiply"],
     [256], 256),
    ((192, 128), "flash_attention_ws_kernel", 128,
     ["producer", "consumer", "consumer"], [0, 320, 320], 320),
    ((256, 256), "flash_attention_ws_kernel", 128,
     ["producer", "consumer", "consumer"], [0, 512, 512], 512),
]


@pytest.mark.parametrize("pair,kernel,rows,roles,units,per64", FORWARD_WORK,
                         ids=[f"{w[0][0]}-{w[0][1]}" for w in FORWARD_WORK])
def test_forward_tile_work_hand_counts(pair, kernel, rows, roles, units,
                                       per64):
    """Each warpgroup's role and tensor work a tile against counts by
    hand: past hd 128, S once for each (query, key), 512 hd-units per 64
    rows at (256, 256) against the replaced CTA's 768, and the consumers
    balanced."""
    work = tfa.forward_tile_work(*pair)
    assert work == {"kernel": kernel, "rows": rows, "roles": roles,
                    "hd_units": units, "hd_units_per_64_rows": per64}
    hd, hdv = pair
    if hd > 128:
        assert per64 == hd + hdv and sum(units) * 64 == per64 * rows
        assert per64 < 2 * hd + hdv   # S twice: 768 at (256, 256)


def test_forward_tile_work_general_at_narrow_pairs():
    """Past NARROW_MAX_LEN keys (narrow=False) the narrow pair takes the
    one-warpgroup kernel at widths padded to 64; ``narrow=True`` at a
    pair without a narrow CTA is refused."""
    assert tfa.forward_tile_work(24, 16, narrow=False) == {
        "kernel": "flash_attention_tc_kernel", "rows": 64,
        "roles": ["copy_and_multiply"], "hd_units": [128],
        "hd_units_per_64_rows": 128}
    with pytest.raises(ValueError, match="no narrow forward"):
        tfa.forward_tile_work(16, 16, narrow=True)


def test_forward_tile_work_refuses_fma_pairs():
    """hd 8 has no tensor-core forward, nor has a pair outside
    HEAD_DIMS."""
    for pair in ((8, 8), (96, 96), (128, 64)):
        with pytest.raises(ValueError, match="no tensor-core forward"):
            tfa.forward_tile_work(*pair)


def test_backward_wrapper_marshals_each_route(monkeypatch):
    """What the wrapper hands the C entry points, with a stand-in library
    (no card): the tensor-core route gets a 16-byte-aligned copy of a
    misaligned upstream gradient; both routes two float32 partials where H
    > Hkv (none where H == Hkv), and hd and hdv; the FMA route the
    gradient as it is and the dtype; the launch counters count each call
    and the tensor-core ones."""
    import contextlib
    import types

    calls = []

    class Lib:
        def fa_backward_tc(self, *args):
            calls.append(("tc", args))
            return 0

        def fa_backward_narrow(self, *args):
            calls.append(("narrow", args))
            return 0

        def fa_backward(self, *args):
            calls.append(("fma", args))
            return 0

    monkeypatch.setattr(tfa.BWD_LIBRARY, "load", lambda: Lib())
    monkeypatch.setattr(tfa, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    bf16 = torch.bfloat16
    q = torch.zeros((2, 8, 4, 16), dtype=bf16)
    kv = torch.zeros((2, 8, 2, 16), dtype=bf16)
    lse = torch.zeros((2, 4, 8))
    buf = torch.zeros(q.numel() + 8, dtype=bf16)
    do = buf[1:1 + q.numel()].view(q.shape)              # 2 bytes off
    assert not tfa._tc_aligned(do)
    # MLA's smoke pair with GQA: q, k at 24, v, o, dO at 16
    q24 = torch.zeros((2, 8, 4, 24), dtype=bf16)
    k24 = torch.zeros((2, 8, 2, 24), dtype=bf16)
    tfa.reset_launches()
    tfa.backward(do, q, kv, kv, q, lse, True, 0)
    tfa.backward(do, q, q, q, q, lse, True, 0)           # MHA
    tfa.backward(do, q, kv, kv, q, lse, True, 0, route="fma")
    tfa.backward(q, q24, k24, kv, q, lse, True, 0)
    tfa.backward(q, q24, k24, kv, q, lse, True, 0, route="fma")
    # the same pair past NARROW_MAX_LEN queries: the three (four) kernels
    s = tfa.NARROW_MAX_LEN + 1
    q24_long = torch.zeros((2, s, 4, 24), dtype=bf16)
    q16_long = torch.zeros((2, s, 4, 16), dtype=bf16)
    tfa.backward(q16_long, q24_long, k24, kv, q16_long,
                 torch.zeros((2, 4, s)), True, 0)
    (r0, a0), (r1, a1), (r2, a2), (r3, a3), (r4, a4), (r5, a5) = calls
    assert (r0, r1, r2, r3, r4, r5) == ("tc", "tc", "fma", "narrow", "fma",
                                        "tc")
    assert a0[4] % 16 == 0 and a0[4] != do.data_ptr()    # the copy
    assert a0[10] is not None and a0[11] is not None     # the partials
    assert a0[11] - a0[10] == 2 * 8 * 4 * 16 * 4         # (B, Sk, H, hd) f32
    assert a1[10] is None and a1[11] is None
    assert a2[4] == do.data_ptr() and a2[-2] == 1        # as is; bf16
    assert len(a0) == 25 and len(a2) == 25
    assert a0[23] == 0 and a1[23] == 0                   # separate launches
    # hd and hdv through the ABI: (b, sq, sk, h, hkv, hd, hdv, causal,
    # window) after the strides
    assert a0[13:22] == (2, 8, 8, 4, 2, 16, 16, 1, 0)
    assert a4[13:22] == (2, 8, 8, 4, 2, 24, 16, 1, 0)
    assert a5[13:22] == (2, s, 8, 4, 2, 24, 16, 1, 0)
    for a, hd in ((a2, 16), (a4, 24), (a5, 24)):         # dK's at hd
        assert a[11] - a[10] == 2 * 8 * 4 * hd * 4
    assert a5[22] == pytest.approx(1 / 24 ** 0.5)        # 1/sqrt(hd)
    # the one launch: q, k, v, o, dO, lse, dq, dk, dv (no D, no
    # partials), the strides, the same ints, the scale, the stream
    assert len(a3) == 21 and a3[4] == q.data_ptr()
    assert a3[10:19] == (2, 8, 8, 4, 2, 24, 16, 1, 0)
    assert a3[19] == pytest.approx(1 / 24 ** 0.5)
    assert tfa.LAUNCHES["flash_attention_bwd"] == 6
    assert tfa.LAUNCHES["flash_attention_bwd_tc"] == 4
    assert tfa.LAUNCHES["flash_attention_bwd_narrow"] == 1


def _parent_forward_plan(b, sq, sk, h, hkv, hd, dtype, route, hdv):
    """forward_plan as it stood before the narrow CTA (for the pairs and
    shapes that do not take it)."""
    t = 64
    if route is None:
        route = tfa._route(dtype, hd, hdv)
    if route == "fma":
        floats = t * hd + t * (hd + 1) + t * hdv + t * (t + 1) + 3 * t
        return {"route": route, "kernel": "flash_attention_kernel",
                "grid": (-(-sq // t), b * h), "threads": 256, "rows": t,
                "smem_bytes": 4 * floats, "static_smem_bytes": 0}
    if hd <= 128:
        hdp, hdvp = max(hd, t), max(hdv, t)
        return {"route": route, "kernel": "flash_attention_tc_kernel",
                "grid": (b * h, -(-sq // t)), "threads": 128, "rows": t,
                "smem_bytes": 2 * t * (3 * hdp + 2 * hdvp) + 1024,
                "static_smem_bytes": 0}
    stages = 2 if hd + hdv > 320 else 3
    return {"route": route, "kernel": "flash_attention_ws_kernel",
            "grid": (b * h, -(-sq // (2 * t))), "threads": 384,
            "rows": 2 * t, "stages": stages,
            "smem_bytes": 2 * t * (2 * hd + stages * (hd + hdv)) + 1024,
            "static_smem_bytes": -(-8 * (1 + 4 * stages) // 1024) * 1024}


def _parent_backward_plan(b, sq, sk, h, hkv, hd, dtype, route, hdv):
    """backward_plan as it stood before the one-launch kernel."""
    t = 64
    if route is None:
        route = tfa._route(dtype, hd, hdv)
    nq, nk = -(-sq // t), -(-sk // t)
    if route == "fma":
        kernels = [("fa_bwd_preprocess_kernel", (nq, b * h)),
                   ("fa_bwd_dkdv_kernel", (nk, b * h))]
        last = ("fa_bwd_dq_kernel", (nq, b * h))
    else:
        kernels = [("fa_bwd_preprocess_tc_kernel", (nq, b * h)),
                   ("fa_bwd_dkdv_tc_kernel", (b * h, nk))]
        last = ("fa_bwd_dq_tc_kernel", (b * h, nq))
    scratch = 0
    if h != hkv:
        scratch = b * sk * h * (hd + hdv)
        kernels.append(("fa_bwd_gqa_reduce_kernel",
                        (-(-(b * sk * hkv * max(hd, hdv) // 4) // 256),)))
    return {"route": route, "kernels": kernels + [last],
            "scratch_floats": scratch}


@pytest.mark.parametrize("pair", tfa.HEAD_DIMS,
                         ids=[f"{a}-{b}" for a, b in tfa.HEAD_DIMS])
def test_plans_unchanged_off_the_narrow_shapes(pair):
    """Every pair's forward and backward plans, on both routes and on both
    sides of NARROW_MAX_LEN, equal the plans from before the narrow
    kernels, except the narrow pair's tensor-core route at short shapes:
    its forward up to NARROW_MAX_LEN keys, its backward up to
    NARROW_MAX_LEN queries and keys; the one-grid backward of the
    pair (64, 64) with H == Hkv (the same CTAs in one launch); and the
    float32 tensor-core route (the rule's or named), which has its own
    kernels at every shape."""
    hd, hdv = pair
    n = tfa.NARROW_MAX_LEN
    narrowed = tf32 = 0
    for dtype in (torch.float32, torch.bfloat16):
        for route in (None, "tc", "tf32x3", "fma"):
            if route in ("tc", "tf32x3") and tfa._route(dtype, hd,
                                                        hdv) != route:
                continue
            for b, sq, sk, h, hkv in ((2, n, n, 4, 4), (1, n + 1, n, 4, 2),
                                      (1, n, n + 1, 8, 2), (1, 1, n, 4, 4),
                                      (3, 100, 40, 2, 1),
                                      (1, 2048, 2048, 16, 16)):
                args = (b, sq, sk, h, hkv, hd, dtype, route, hdv)
                plan = tfa.forward_plan(*args[:-1], hdv=hdv)
                bplan = tfa.backward_plan(*args[:-1], hdv=hdv)
                if (route or tfa._route(dtype, hd, hdv)) == "tf32x3":
                    assert plan["kernel"] == "flash_attention_tf32_kernel"
                    if (route or tfa._route(dtype, hd, hdv,
                                            backward=True)) == "tf32x3":
                        assert (bplan["kernels"][1][0]
                                == "fa_bwd_dkdv_tf32_kernel")
                    else:   # FMA_BACKWARD_PAIRS: the FMA backward
                        assert bplan == _parent_backward_plan(
                            *args[:-2], "fma", hdv)
                    tf32 += 1
                    continue
                tc = (route or tfa._route(dtype, hd, hdv)) == "tc"
                if tc and pair in tfa.NARROW_PAIRS and sk <= n:
                    assert plan["kernel"] == "flash_attention_narrow_kernel"
                    narrowed += 1
                else:
                    assert plan == _parent_forward_plan(*args)
                if tc and pair in tfa.NARROW_PAIRS and max(sq, sk) <= n:
                    assert bplan["kernels"] == [
                        ("fa_bwd_narrow_tc_kernel", (4 * b * hkv,))]
                elif tc and tfa._one_grid(hd, hdv, h, hkv):
                    parent = _parent_backward_plan(*args)["kernels"]
                    assert bplan["kernels"] == parent[:1] + [
                        ("fa_bwd_dkdv_dq_tc_kernel",
                         (b * h, parent[1][1][1] + parent[2][1][1]))]
                else:
                    assert bplan == _parent_backward_plan(*args)
    # bf16 on the rule's route and named "tc", four shapes with sk <= n;
    # float32 on the rule's route and named "tf32x3", six shapes
    assert narrowed == (8 if pair in tfa.NARROW_PAIRS else 0)
    assert tf32 == (12 if pair in tfa.TC_HEAD_DIMS else 0)


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


# (label, (B, Sq, Sk, H, Hkv, hd, hdv), causal, forward plan): the split
# route by hand.  whisper-tiny's encoder at serving: 6 x 12 = 72 CTAs of
# 128 rows, two an SM: 264 // 72 = 3 a cluster (grid (18, 12)); the rest
# stay on the one-warpgroup kernel: Llama-3.2-Vision's cross-attention at
# its longest and shortest prompts (hd 128: no split), whisper's training
# encoder (576 CTAs), its decoder's self-attention (causal) and cross-
# attention (8 x 6 x 4 = 192 CTAs: 264 // 192 = 1), its decoding
# cross-attention (4 queries), a decode step of the vision model
_TC = {"route": "tc", "kernel": "flash_attention_tc_kernel", "threads": 128,
       "rows": 64, "static_smem_bytes": 0}
NEW_FORWARD_PLANS = [
    ("whisper_encoder", (1, 1500, 1500, 6, 6, 64, 64), False,
     {"route": "tc", "kernel": "flash_attention_ws_kernel", "grid": (18, 12),
      "threads": 288, "rows": 128, "stages": 3, "cluster": 3,
      "static_smem_bytes": 1024,                    # two consumers, a warp
      "smem_bytes": 2 * 64 * (2 * 64 + 3 * 128) + 1024}),        # 66,560
    ("vlm_cross", (1, 2048, 1024, 64, 8, 128, 128), False,
     {**_TC, "grid": (64, 32), "smem_bytes": 82944}),
    ("vlm_cross_768", (1, 768, 1024, 64, 8, 128, 128), False,
     {**_TC, "grid": (64, 12), "smem_bytes": 82944}),
    ("whisper_train", (8, 1500, 1500, 6, 6, 64, 64), False,
     {**_TC, "grid": (48, 24), "smem_bytes": 2 * 64 * 5 * 64 + 1024}),
    ("whisper_dec_self", (8, 448, 448, 6, 6, 64, 64), True,
     {**_TC, "grid": (48, 7), "smem_bytes": 41984}),
    ("whisper_dec_cross", (8, 448, 1500, 6, 6, 64, 64), False,
     {**_TC, "grid": (48, 7), "smem_bytes": 41984}),
    ("whisper_serve_cross", (1, 4, 1500, 6, 6, 64, 64), False,
     {**_TC, "grid": (6, 1), "smem_bytes": 41984}),
    ("vlm_decode", (1, 1, 1024, 64, 8, 128, 128), False,
     {**_TC, "grid": (64, 1), "smem_bytes": 82944}),
]


@pytest.mark.parametrize("shape,causal,want",
                         [p[1:] for p in NEW_FORWARD_PLANS],
                         ids=[p[0] for p in NEW_FORWARD_PLANS])
def test_forward_plan_hand_counts_split(shape, causal, want):
    """The forward's launch at the shape the split was built for, and
    beside it, against counts by hand; the float32 route of the same
    shapes takes the split-TF32 kernel (no split), the FMA kernel when
    named."""
    b, sq, sk, h, hkv, hd, hdv = shape
    plan = tfa.forward_plan(b, sq, sk, h, hkv, hd, torch.bfloat16, hdv=hdv,
                            causal=causal)
    assert plan == want
    assert plan["smem_bytes"] + plan["static_smem_bytes"] <= 232448
    f32 = tfa.forward_plan(b, sq, sk, h, hkv, hd, torch.float32, hdv=hdv,
                           causal=causal)
    assert f32["kernel"] == "flash_attention_tf32_kernel"
    assert f32["grid"] == (b * h, -(-sq // 64)) and "cluster" not in f32
    fma = tfa.forward_plan(b, sq, sk, h, hkv, hd, torch.float32, "fma",
                           hdv=hdv, causal=causal)
    assert fma["kernel"] == "flash_attention_kernel"


def test_split_rule():
    """The split rule from the shapes alone: (64, 64), no mask, at least
    128 queries, and S = min(MAX_SPLIT, 264 // CTAs, key tiles) of 2 or
    more (0: no split); never at another pair."""
    c = tfa._split
    assert c(1, 1500, 1500, 6, 6, 64, 64, False, 0) == 3
    assert c(1, 1500, 1500, 6, 6, 64, 64, True, 0) == 0
    assert c(1, 1500, 1500, 6, 6, 64, 64, False, 64) == 0
    assert c(1, 127, 1500, 6, 6, 64, 64, False, 0) == 0
    assert c(8, 1500, 1500, 6, 6, 64, 64, False, 0) == 0        # 576 CTAs
    assert c(1, 256, 1024, 66, 66, 64, 64, False, 0) == 2
    assert c(1, 256, 1024, 67, 67, 64, 64, False, 0) == 0       # 134 CTAs
    # at most MAX_SPLIT, and at most the key tiles
    assert c(1, 128, 1024, 1, 1, 64, 64, False, 0) == 4
    assert c(1, 128, 100, 1, 1, 64, 64, False, 0) == 2
    assert c(1, 128, 64, 1, 1, 64, 64, False, 0) == 0
    for pair in ((16, 16), (32, 32), (128, 128), (192, 128), (256, 256),
                 (24, 16)):
        assert c(1, 1500, 1500, 6, 6, *pair, False, 0) == 0


# (label, (B, Sq, Sk, H, Hkv), causal, kernels): the backward at hd 64 by
# hand.  With H == Hkv, D then one grid of the dK / dV CTAs (rows below
# nk = ceil(Sk / 64)) and the dQ CTAs (nq = ceil(Sq / 64) rows more), any
# mask; GQA keeps the four kernels
NEW_BACKWARD_PLANS = [
    ("whisper_train", (8, 1500, 1500, 6, 6), False,
     [("fa_bwd_preprocess_tc_kernel", (24, 48)),
      ("fa_bwd_dkdv_dq_tc_kernel", (48, 48))]),
    ("whisper_dec_cross", (8, 448, 1500, 6, 6), False,
     [("fa_bwd_preprocess_tc_kernel", (7, 48)),
      ("fa_bwd_dkdv_dq_tc_kernel", (48, 31))]),
    ("whisper_dec_self", (8, 448, 448, 6, 6), True,
     [("fa_bwd_preprocess_tc_kernel", (7, 48)),
      ("fa_bwd_dkdv_dq_tc_kernel", (48, 14))]),
    ("hd64_gqa", (2, 1024, 1024, 8, 2), True,
     [("fa_bwd_preprocess_tc_kernel", (16, 16)),
      ("fa_bwd_dkdv_tc_kernel", (16, 16)),
      ("fa_bwd_gqa_reduce_kernel", (256,)),
      ("fa_bwd_dq_tc_kernel", (16, 16))]),
]


@pytest.mark.parametrize("shape,causal,kernels",
                         [p[1:] for p in NEW_BACKWARD_PLANS],
                         ids=[p[0] for p in NEW_BACKWARD_PLANS])
def test_backward_plan_hand_counts_one_grid(shape, causal, kernels):
    """The backward's launches at whisper-tiny's training shapes and beside
    them against counts by hand: no partials where H == Hkv; the float32
    route takes the split-TF32 kernels (no one grid)."""
    b, sq, sk, h, hkv = shape
    plan = tfa.backward_plan(b, sq, sk, h, hkv, 64, torch.bfloat16)
    assert plan["kernels"] == kernels
    assert plan["scratch_floats"] == (0 if h == hkv
                                      else b * sk * h * 128)
    f32 = tfa.backward_plan(b, sq, sk, h, hkv, 64, torch.float32)
    assert f32["route"] == "tf32x3"
    assert [n for n, _ in f32["kernels"]] == (
        ["fa_bwd_preprocess_kernel", "fa_bwd_dkdv_tf32_kernel"]
        + (["fa_bwd_gqa_reduce_kernel"] if h != hkv else [])
        + ["fa_bwd_dq_tf32_kernel"])


def test_tile_work_of_the_new_kernels():
    """The split's CTA by hand: the consumers' work as past hd 128 (hd +
    hdv a 64 x 64 tile); the one-grid backward's CTAs keep the two
    kernels' work (dK / dV 320, dQ 256 hd-units a tile)."""
    assert tfa.forward_tile_work(64, 64, split=True) == {
        "kernel": "flash_attention_ws_kernel", "rows": 128,
        "roles": ["producer", "consumer", "consumer"],
        "hd_units": [0, 128, 128], "hd_units_per_64_rows": 128}
    for bad in ((128, 128), (192, 128)):
        with pytest.raises(ValueError, match="no split forward"):
            tfa.forward_tile_work(*bad, split=True)
    two = tfa.backward_tile_work(64, 64)
    assert (two["dkdv"]["hd_units"], two["dq"]["hd_units"]) == ([320],
                                                               [256])


@pytest.mark.parametrize("pair", tfa.HEAD_DIMS,
                         ids=[f"{a}-{b}" for a, b in tfa.HEAD_DIMS])
def test_plans_unchanged_off_the_new_routes(pair):
    """Every pair's forward and backward plans, on both routes, causal or
    not, with and without a window, equal the plans from before the
    narrow kernels except where a later route takes them: the narrow
    pair's short shapes, the split (a tensor-core forward at (64, 64)
    without a mask, by _split), the one-grid backward (at (64, 64),
    H == Hkv) and the float32 tensor-core route (its own kernels at every
    shape and mask, never split, never one grid)."""
    hd, hdv = pair
    n = tfa.NARROW_MAX_LEN
    moved = {"split": 0, "one_grid": 0, "tf32x3": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for route in (None, "tc", "tf32x3", "fma"):
            if route in ("tc", "tf32x3") and tfa._route(dtype, hd,
                                                        hdv) != route:
                continue
            tc = (route or tfa._route(dtype, hd, hdv)) == "tc"
            tf32 = (route or tfa._route(dtype, hd, hdv)) == "tf32x3"
            for b, sq, sk, h, hkv in ((2, n + 1, n + 1, 4, 4),
                                      (1, 1500, 1500, 6, 6),
                                      (8, 1500, 1500, 6, 6),
                                      (1, 2048, 1024, 64, 8),
                                      (3, 100, 400, 2, 1),
                                      (1, 1, 300, 4, 4)):
                args = (b, sq, sk, h, hkv, hd, dtype, route, hdv)
                for causal, window in ((True, 0), (False, 0), (True, 64),
                                       (False, 64)):
                    kw = {"hdv": hdv, "causal": causal, "window": window}
                    plan = tfa.forward_plan(*args[:-1], **kw)
                    bplan = tfa.backward_plan(*args[:-1], hdv=hdv)
                    if tf32:
                        assert plan["kernel"] == (
                            "flash_attention_tf32_kernel")
                        assert "cluster" not in plan
                        if (route or tfa._route(dtype, hd, hdv,
                                                backward=True)) == "tf32x3":
                            assert (bplan["kernels"][1][0],
                                    bplan["kernels"][-1][0]) == (
                                "fa_bwd_dkdv_tf32_kernel",
                                "fa_bwd_dq_tf32_kernel")
                        else:   # FMA_BACKWARD_PAIRS: the FMA backward
                            assert bplan == _parent_backward_plan(
                                *args[:-2], "fma", hdv)
                        moved["tf32x3"] += 1
                        continue
                    split = (tfa._split(b, sq, sk, h, hkv, hd, hdv, causal,
                                        window) if tc else 0)
                    if split:
                        assert plan["cluster"] == split
                        assert pair in tfa.SPLIT_PAIRS
                        assert not causal and window == 0
                        moved["split"] += 1
                    else:
                        assert plan == _parent_forward_plan(*args)
                    if tc and tfa._one_grid(hd, hdv, h, hkv):
                        assert bplan["kernels"][-1][0] == (
                            "fa_bwd_dkdv_dq_tc_kernel")
                        assert pair == (64, 64) and h == hkv
                        moved["one_grid"] += 1
                    else:
                        assert bplan == _parent_backward_plan(*args)
    # bf16 on the rule's route and named "tc" (two routes), unmasked, at
    # (64, 64): (2, 257, 257, 4, 4) (24 CTAs) and whisper's serving encoder
    # (72) split; (3, 100, 400) is under 128 queries.  The one-grid
    # backward: the four shapes with H == Hkv, at each of the four masks
    # float32 on the rule's route and named "tf32x3": the six shapes at
    # each of the four masks, at every tensor-core pair
    tf32 = 48 if pair in tfa.TC_HEAD_DIMS else 0
    want = {(64, 64): {"split": 4, "one_grid": 32, "tf32x3": tf32}}
    assert moved == want.get(pair, {"split": 0, "one_grid": 0,
                                    "tf32x3": tf32})


def test_backward_wrapper_marshals_the_one_grid_launch(monkeypatch):
    """What the wrapper hands fa_backward_tc for the one-grid launch, with
    a stand-in library (no card): q, k, v, o, dO, lse, D, dq, dk, dv, no
    partials, the strides, (b, sq, sk, h, hkv, hd, hdv, causal, window),
    the scale, one_grid 1 and the stream; flash_attention_bwd_one_grid
    counts it.  GQA at the same head dims, and the separate launches a
    caller names, get one_grid 0; the FMA route refuses one_grid."""
    import contextlib
    import types

    calls = []

    class Lib:
        def fa_backward_tc(self, *args):
            calls.append(("tc", args))
            return 0

    monkeypatch.setattr(tfa.BWD_LIBRARY, "load", lambda: Lib())
    monkeypatch.setattr(tfa, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros((2, 130, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 200, 4, 64), dtype=torch.bfloat16)
    kv2 = torch.zeros((2, 200, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 4, 130))
    tfa.reset_launches()
    tfa.backward(q, q, kv, kv, q, lse, True, 0)
    tfa.backward(q, q, kv2, kv2, q, lse, False, 0)
    tfa.backward(q, q, kv, kv, q, lse, True, 0, one_grid=False)
    (r0, a0), (r1, a1), (r2, a2) = calls
    assert (r0, r1, r2) == ("tc", "tc", "tc")
    assert len(a0) == 25
    assert a0[5] == lse.data_ptr() and a0[6] is not None   # lse, then D
    assert a0[10] is None and a0[11] is None               # no partials
    assert a0[13:22] == (2, 130, 200, 4, 4, 64, 64, 1, 0)
    assert a0[22] == pytest.approx(1 / 8)
    assert (a0[23], a1[23], a2[23]) == (1, 0, 0)
    assert a1[10] is not None and a2[10] is None
    assert tfa.LAUNCHES["flash_attention_bwd_one_grid"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_tc"] == 3
    q32 = q.float()
    with pytest.raises(ValueError, match="one grid"):
        tfa.backward(q32, q32, kv.float(), kv.float(), q32, lse, True, 0,
                     one_grid=True)
    assert len(calls) == 3
