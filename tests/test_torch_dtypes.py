"""bfloat16 without ml_dtypes: the port's upcast / downcast against
ml_dtypes, and checkpoints written by one package read back by the
other byte for byte."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.store.iostats import IOStats  # noqa: E402
from repro.store.tensorstore import CheckpointStore as JaxStore  # noqa: E402
from repro_torch.store import dtypes  # noqa: E402
from repro_torch.store.iostats import IOStats as TorchIOStats  # noqa: E402
from repro_torch.store.tensorstore import CheckpointStore as TorchStore  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)


def test_upcast_all_bit_patterns():
    words = np.arange(1 << 16, dtype=np.uint16)
    want = words.view(BF16).astype(np.float32)
    got = dtypes.to_float32(words)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _downcast_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=1 << 16).astype(np.float32)
    with np.errstate(over="ignore"):  # some scales overflow to inf: wanted
        x *= np.float32(10.0) ** rng.integers(-40, 39, size=x.size).astype(np.float32)
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45,
         3.4e38, -3.4e38, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8),
         2.0**-126 + 2.0**-134],  # exact ties (even / odd) and a subnormal tie
        dtype=np.float32)
    ties = (np.arange(1 << 16, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    payload_nans = np.array([0x7F800001, 0xFFC12345, 0x7FFFFFFF],
                            np.uint32).view(np.float32)
    return np.concatenate([x, specials, ties, payload_nans])


def test_downcast_matches_ml_dtypes():
    x = _downcast_inputs()
    with np.errstate(invalid="ignore"):
        want = x.astype(BF16).view(np.uint16)
    got = dtypes.from_float32(x, dtypes.BFLOAT16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_torch_tensors_store_as_words():
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    words = dtypes.as_storage(t)
    assert words.dtype == dtypes.BFLOAT16
    np.testing.assert_array_equal(
        words, np.array([1.0, -2.5, 3.140625], np.float32).astype(BF16).view(np.uint16))
    assert dtypes.dtype_name(words.dtype) == "bfloat16"


def _bf16_model():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(37, 41)).astype(BF16),
            "b": rng.normal(size=(41,)).astype(BF16),
            "f": rng.normal(size=(5, 7)).astype(np.float32)}


def test_jax_written_bf16_reads_back_in_port(tmp_path):
    model = _bf16_model()
    JaxStore(str(tmp_path), IOStats()).write_model("m", model)
    with TorchStore(str(tmp_path), TorchIOStats()).open_model("m") as r:
        assert r.spec("w")["dtype"] == "bfloat16"
        for name, arr in model.items():
            got = r.read_tensor(name, "base")
            assert got.shape == arr.shape
            assert got.tobytes() == arr.tobytes()


def test_port_written_bf16_reads_back_in_jax(tmp_path):
    model = _bf16_model()
    words = {k: (v.view(np.uint16) if v.dtype == BF16 else v)
             for k, v in model.items()}
    TorchStore(str(tmp_path), TorchIOStats()).write_model("m", words)
    with JaxStore(str(tmp_path), IOStats()).open_model("m") as r:
        for name, arr in model.items():
            got = r.read_tensor(name, "base")
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)
