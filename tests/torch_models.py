"""Shared helpers of the port's model-family tests (tests/test_torch_ssm.py,
test_torch_encdec.py, test_torch_vlm.py): a JAX smoke model whose
zero-initialised leaves (norms, cross-attention gates, SSM biases) are
redrawn from a numpy seed so every term counts, the port's model carrying
the same weights, and the checks that hold the two packages' forward,
loss, gradients, prefill and decode steps to each other."""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.store.checkpoint import flatten_tree as jax_flatten_tree
from repro.store.checkpoint import unflatten_like as jax_unflatten_like
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_jax_flat
from repro_torch.train.train_state import model_params

# whole models, float32 on both sides (tests/test_torch_model.py)
TOL = 1e-4


def redraw(params, draws, seed):
    """``params`` with each leaf whose last name is a key of ``draws``
    replaced by ``draws[name](rng, shape)`` (numpy float32)."""
    rng = np.random.default_rng(seed)
    flat = jax_flatten_tree(params)
    for n, a in flat.items():
        draw = draws.get(n.split("/")[-1])
        if draw is not None:
            flat[n] = np.asarray(draw(rng, a.shape), a.dtype)
    return jax.tree.map(jnp.asarray, jax_unflatten_like(params, flat))


def models(arch, draws, seed=0):
    """(cfg, JAX model, its params with ``draws`` redrawn, the port's
    model on the CPU holding the same weights)."""
    jmodel = jax_build_model(jax_smoke_config(arch))
    params = redraw(jmodel.init(jax.random.PRNGKey(seed)), draws, seed + 1)
    cfg = get_smoke_config(arch)
    return cfg, jmodel, params, from_jax_flat(cfg, jax_flatten_tree(params),
                                              device="cpu")


def tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=tol, atol=tol)


def check_forward_loss_grads(jmodel, params, model, toks, ctx=None,
                             ctx_key=None):
    """Forward logits, the loss and every parameter's gradient (against
    ``jax.grad``), on ``toks`` (B, S) and the context embeddings ``ctx``
    (passed as the batch's ``ctx_key``) where the family takes them."""
    t = torch.from_numpy(toks).long()
    jargs = (jnp.asarray(toks),) + (() if ctx is None else
                                    (jnp.asarray(ctx),))
    targs = (t,) + (() if ctx is None else (torch.from_numpy(ctx),))
    with torch.no_grad():
        close(model(*targs), jmodel.forward(params, *jargs))
    labels = np.roll(toks, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": t, "labels": torch.from_numpy(labels).long()}
    if ctx is not None:
        jbatch[ctx_key] = jnp.asarray(ctx)
        batch[ctx_key] = torch.from_numpy(ctx)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(params, jbatch)
    loss = model.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    jflat = jax_flatten_tree(jgrads)
    got = model_params(model)
    assert got.keys() == jflat.keys()
    for n, p in got.items():
        # float32 sums in another order: an absolute slack at the scale of
        # the tensor's largest gradient (tests/test_torch_train.py)
        want = np.asarray(jflat[n])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=TOL,
                                   atol=TOL * max(1.0, float(np.abs(want)
                                                             .max())),
                                   err_msg=n)
        p.grad = None


def _pad_to(small, big_shape):
    """Zero-pad ``small`` at the end of each axis up to ``big_shape``."""
    out = np.zeros(big_shape, np.asarray(small).dtype)
    out[tuple(slice(0, n) for n in small.shape)] = np.asarray(small)
    return out


def check_prefill_decode(jmodel, params, model, toks, steps, max_len,
                         ctx=None):
    """Prefill's logits and every cache entry, then ``steps`` decode steps
    from caches of ``max_len`` positions (each prefill entry zero-padded
    into them): the logits of every step and the final caches."""
    jctx = () if ctx is None else (jnp.asarray(ctx),)
    tctx = () if ctx is None else (torch.from_numpy(ctx),)
    b, s = toks.shape
    jl, jc = jmodel.prefill(params, jnp.asarray(toks), *jctx)
    tl, tc = model.prefill(torch.from_numpy(toks).long(), *tctx)
    close(tl, jl)
    assert tc["len"] == int(jc["len"]) == s
    names = set(jc) - {"len"}
    assert set(tc) - {"len"} == names
    for name in names:
        assert tuple(tc[name].shape) == jc[name].shape, name
        close(tc[name], jc[name])
    jcache = jmodel.init_cache(b, max_len)
    tcache = model.init_cache(b, max_len)
    assert set(tcache) == set(jcache)
    for name in names:
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        full = _pad_to(np.asarray(jc[name]), jcache[name].shape)
        jcache[name] = jnp.asarray(full)
        tcache[name].copy_(torch.from_numpy(full))
    jcache["len"], tcache["len"] = jc["len"], tc["len"]
    step = tokens((b, steps), model.cfg.vocab_size, seed=3)
    for i in range(steps):
        jl, jcache = jmodel.decode_step(params, jnp.asarray(step[:, i:i + 1]),
                                        jcache)
        tl, tcache = model.decode_step(
            torch.from_numpy(step[:, i:i + 1]).long(), tcache)
        close(tl, jl)
    assert tcache["len"] == int(jcache["len"]) == s + steps
    for name in names:
        close(tcache[name], jcache[name])


def check_cache_specs(jmodel, model, batch=3, max_len=40):
    """Cache entries, shapes and dtypes as the reference's; each entry's
    batch axis (``cache_batch_axes``) the one of size ``batch``."""
    want = jmodel.cache_specs(batch, max_len)
    got = model.cache_specs(batch, max_len)
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape, name
        assert str(dtype).replace("torch.", "") == want[name].dtype.name
    axes = model.cache_batch_axes()
    assert set(axes) == set(got) - {"len"}
    for name, axis in axes.items():
        assert got[name][0][axis] == batch
