"""Card-only tests of the port: the Hopper kernels against their plain
versions, merge_blocks on the card against the CPU, MergePipe on the
card against the numpy stream engine, and the model's prefill on the
card against the CPU.  Imports nothing of JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is False."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import merge_block as tmb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_model, load_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.store.checkpoint import flatten_tree  # noqa: E402

pytestmark = pytest.mark.cuda

OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mk(nb, k, w, seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(nb, w)).astype(np.float32)
    D = (0.02 * rng.normal(size=(nb, k, w))).astype(np.float32)
    masks = rng.random((nb, k, w)) < 0.5
    return x0, D, masks


@pytest.mark.parametrize("shape", [(3, 257), (32, 65536), (5, 700)])
@pytest.mark.parametrize("k", [1, 4])
def test_kernels_match_plain_bitwise(cuda, shape, k):
    """Vector (W % 4 == 0) and scalar widths: bit for bit."""
    nb, w = shape
    x0, D, masks = _mk(nb, k, w)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    mc = torch.from_numpy(masks).to(cuda)
    thresh = tref.ties_thresholds(Dc, 0.3).contiguous()
    pairs = [
        (tmb.linear_merge(x0c, Dc, 1.0, float(k + 1)), tref.avg_ref(x0c, Dc)),
        (tmb.linear_merge(x0c, Dc, 0.7, 1.0), tref.ta_ref(x0c, Dc, 0.7)),
        (tmb.ties_merge(x0c, Dc, thresh, 0.9),
         tref.ties_apply_ref(x0c, Dc, thresh, 0.9)),
        (tmb.dare_merge(x0c, Dc, mc, 0.5, 1.1),
         tref.dare_ref(x0c, Dc, mc, 0.5, 1.1)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_refuse_bad_operands(cuda):
    x0, D, _ = _mk(2, 2, 64)
    x0c, Dc = torch.from_numpy(x0).to(cuda), torch.from_numpy(D).to(cuda)
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c.double(), Dc)               # dtype
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c, Dc.transpose(0, 1))        # shape / layout
    with pytest.raises(ValueError):
        tmb.linear_merge(x0c[:, ::2], Dc[:, :, ::2])     # not contiguous
    with pytest.raises(ValueError):
        tmb.ties_merge(x0c, Dc, torch.zeros(2, 2))       # thresholds on CPU


@pytest.mark.parametrize("op,theta", OPS)
def test_merge_blocks_card_equals_cpu(cuda, op, theta):
    x0, D, masks = _mk(6, 3, 1000)
    kw = {"masks": masks} if op == "dare" else {}
    tmb.reset_launches()
    a = ops.merge_blocks(op, x0, D, theta, device="cuda", **kw)
    b = ops.merge_blocks(op, x0, D, theta, device="cpu", **kw)
    np.testing.assert_array_equal(a, b)
    assert sum(tmb.LAUNCHES.values()) == 1


@pytest.mark.parametrize("op,theta", OPS)
def test_mergepipe_on_card_matches_stream(cuda, tmp_path, op, theta):
    """bf16 checkpoints registered from card tensors; the card's
    pipelined merge equals the numpy stream engine bit for bit."""
    g = torch.Generator().manual_seed(0)
    shapes = {f"l{i}": (64, 96 + i) for i in range(3)}
    base = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096)
    mp.register_model("base", {k: v.to(torch.bfloat16).to(cuda)
                               for k, v in base.items()})
    ids = [f"e{e}" for e in range(3)]
    for e in ids:
        mp.register_model(e, {
            k: (v + 0.02 * torch.randn(v.shape, generator=g)).to(
                torch.bfloat16).to(cuda)
            for k, v in base.items()})
    tmb.reset_launches()
    rk = mp.merge("base", ids, op, theta=theta, budget=0.5)
    assert sum(tmb.LAUNCHES.values()) > 0
    rs = mp.merge("base", ids, op, theta=theta, budget=0.5, compute="stream")
    a, b = mp.load(rk.sid), mp.load(rs.sid)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    mp.close()


# (B, Sq, Sk, H, Hkv, hd, causal, window, q_offset): the JAX package's
# FA_CASES (tests/test_kernels.py) and the smoke's three shapes
FA_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0),
    (1, 50, 50, 4, 1, 8, True, 13, 0),
    (2, 33, 70, 6, 6, 16, False, 0, 0),
    (1, 1, 40, 4, 2, 16, True, 0, 39),
    (1, 2048, 2048, 12, 2, 128, True, 0, 0),
    (1, 2048, 2048, 12, 2, 128, True, 512, 0),
    (1, 1, 2048, 12, 2, 128, True, 0, 2047),
    (2, 100, 300, 4, 4, 64, False, 70, 200),
]
# tests/test_kernels.py:133,149: float32 sums in another order; bf16
# outputs one rounding apart
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, device, seed=0):
    b, sq, sk, h, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device=device, dtype=dtype)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    causal, window, q_offset = case[6:]
    q, k, v = _qkv(case, dtype, cuda)
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    assert tfa.LAUNCHES["flash_attention"] == 1
    want = tref.flash_attention_ref(q, k, v, causal, window, q_offset,
                                    skip_masked_chunks=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                               atol=FA_TOL[dtype])


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q/k/v sliced out of a fused projection: strides, no copies."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(2, 40, 8, 16)).astype(
        np.float32)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_wrapper_refuses(cuda):
    q, k, v = _qkv((1, 8, 8, 4, 2, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(q.cpu(), k.cpu(), v.cpu(), 0, 0)        # CPU operands
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k.cpu(), v)                  # mixed devices
    with pytest.raises(ValueError, match="grad"):
        tfa.flash_attention(q.clone().requires_grad_(), k, v)
    q96, k96, v96 = _qkv((1, 8, 8, 4, 2, 96), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q96, k96, v96)                  # head dim 96
    with pytest.raises(ValueError, match="hdv"):
        tfa.flash_attention(q, k, v[..., :8])               # MLA-style hdv
    with pytest.raises(ValueError):
        tfa.flash_attention(q.half(), k.half(), v.half())   # float16
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v.bfloat16())             # mixed dtypes


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_prefill_and_serve_on_card_match_cpu(cuda, arch):
    """float32: DecoderLM.prefill through the kernel on the card against
    the plain version on the CPU (1e-4: sums in another order), and the
    same greedy tokens from both engines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = load_flat(build_model(cfg, device=cuda), flatten_tree(cpu))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 70)))
    tfa.reset_launches()
    lc, cc = card.prefill(toks.to(cuda))
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    lh, ch = cpu.prefill(toks)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-4,
                                   atol=1e-4)

    prompts = [np.arange(n, dtype=np.int32) * 7 % cfg.vocab_size
               for n in (5, 40, 12, 70, 3)]
    out = []
    for model in (card, cpu):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        ServeEngine(model, batch_slots=2, max_len=96).run(reqs)
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]
