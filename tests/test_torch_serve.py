"""The port's ServeEngine against the JAX package's on the CPU: greedy
tokens of several requests on fewer slots (slot recycling, the shared
decode length), the reference decode loop, seeded temperature sampling,
and merge -> serve: a TIES merge of JAX-layout weights through the
port's MergePipe, served by both engines."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.store.checkpoint import flatten_tree as jax_flatten_tree  # noqa: E402
from repro.store.checkpoint import unflatten_like as jax_unflatten_like  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.api import MergePipe  # noqa: E402
from repro_torch.models import from_jax_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _serve_both(arch, params, prompts, slots=2, max_len=32, new=6):
    jmodel = jax_build_model(jax_smoke_config(arch))
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    JaxServeEngine(jmodel, params, batch_slots=slots, max_len=max_len).run(jreqs)
    model = from_jax_flat(get_smoke_config(arch), jax_flatten_tree(params),
                          device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    ServeEngine(model, batch_slots=slots, max_len=max_len).run(reqs)
    assert all(r.done for r in jreqs + reqs)
    return [r.out_tokens for r in jreqs], [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-1.5b", "qwen3-14b",
                                  "grok-1-314b", "deepseek-v2-lite-16b"])
def test_greedy_tokens_equal_jax_engine(arch):
    """Five requests of mixed lengths on two slots: slots are recycled and
    the active slots decode from the longest length."""
    params = jax_build_model(jax_smoke_config(arch)).init(jax.random.PRNGKey(3))
    prompts = _prompts(257, [4, 9, 3, 7, 5])
    want, got = _serve_both(arch, params, prompts)
    assert got == want
    assert all(len(t) == 6 for t in got)


def test_engine_matches_reference_decode_loop():
    """tests/test_train_and_serve.py's check, on the port alone."""
    cfg = get_smoke_config("granite-3-8b")
    params = jax_build_model(jax_smoke_config("granite-3-8b")).init(
        jax.random.PRNGKey(0))
    model = from_jax_flat(cfg, jax_flatten_tree(params), device="cpu")
    prompt = np.array([5, 9, 2, 7], np.int32)
    lg, cache = model.prefill(torch.from_numpy(prompt).long()[None])
    full = model.init_cache(1, 32)
    for name in ("k", "v"):
        full[name][:, :, :4] = cache[name]
    full["len"] = cache["len"]
    tok = int(torch.argmax(lg[0, 0]))
    want = [tok]
    for _ in range(3):
        lg, full = model.decode_step(torch.tensor([[tok]]), full)
        tok = int(torch.argmax(lg[0, 0]))
        want.append(tok)
    eng = ServeEngine(model, batch_slots=2, max_len=32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=4)
    eng.run([req])
    assert req.done and req.out_tokens == want


def test_temperature_sampling_is_seeded():
    cfg = get_smoke_config("qwen2-1.5b")
    params = jax_build_model(jax_smoke_config("qwen2-1.5b")).init(
        jax.random.PRNGKey(1))
    model = from_jax_flat(cfg, jax_flatten_tree(params), device="cpu")
    prompts = _prompts(cfg.vocab_size, [5, 8, 6])

    def run(seed):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8, temperature=1.5)
                for i, p in enumerate(prompts)]
        ServeEngine(model, batch_slots=2, max_len=32, rng_seed=seed).run(reqs)
        return [r.out_tokens for r in reqs]

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_merge_then_serve_equals_jax(tmp_path):
    """A TIES merge of JAX-layout flat weights through the port's
    MergePipe on the CPU; both engines serve the snapshot alike."""
    arch = "qwen2-1.5b"
    jmodel = jax_build_model(jax_smoke_config(arch))
    base = jmodel.init(jax.random.PRNGKey(0))
    flat = jax_flatten_tree(base)
    rng = np.random.default_rng(0)
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096, device="cpu")
    mp.register_model("base", flat)
    ids = []
    for e in range(3):
        mp.register_model(f"e{e}", {
            k: v + (0.02 * rng.normal(size=v.shape)).astype(v.dtype)
            for k, v in flat.items()})
        ids.append(f"e{e}")
    res = mp.merge("base", ids, "ties", theta={"trim_frac": 0.3}, budget=0.5)
    merged = mp.load(res.sid)
    mp.close()
    assert set(merged) == set(flat)
    assert any(not np.array_equal(merged[k], flat[k]) for k in flat)
    params = jax_unflatten_like(base, {k: jnp.asarray(v)
                                       for k, v in merged.items()})
    prompts = _prompts(257, [6, 3, 10, 4])
    want, got = _serve_both(arch, params, prompts)
    assert got == want
