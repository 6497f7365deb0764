"""Card-only tests of the port: the Hopper kernels against their plain
versions, merge_blocks on the card against the CPU, and MergePipe on the
card against the numpy stream engine.  Imports nothing of JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is False."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.kernels import merge_block as tmb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

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
