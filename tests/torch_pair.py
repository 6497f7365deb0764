"""Shared helpers of the port's store tests: the same seeded numpy models
registered in a JAX-package workspace and a port workspace (bf16 as
``ml_dtypes.bfloat16`` there, as ``uint16`` words here), and the checks
that hold the two packages' results to each other."""
import os

import numpy as np

import ml_dtypes

BF16 = np.dtype(ml_dtypes.bfloat16)

#: the operators and parameters every cross-package merge runs
OP_THETAS = {
    "avg": {},
    "ta": {"lam": 0.7},
    "ties": {"trim_frac": 0.3},
    "dare": {"density": 0.5, "seed": 3},
}


def cast(arrays, dtype, port):
    """float32 arrays in checkpoint dtype ``dtype`` for one package."""
    if dtype == "float32":
        return {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    out = {k: np.asarray(v, np.float32).astype(BF16) for k, v in arrays.items()}
    return {k: v.view(np.uint16) for k, v in out.items()} if port else out


def words(a):
    """Any array as raw bits (bf16 of either package as uint16)."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_arrays(want, got):
    """Bit-equal tensors under the same names (the JAX package's bf16
    against the port's words)."""
    assert set(want) == set(got)
    for t in want:
        np.testing.assert_array_equal(words(want[t]), words(got[t]), err_msg=t)


def tree_files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out
