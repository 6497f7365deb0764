"""The port's training against the JAX package on the CPU: AdamW, the
learning-rate schedule and clipping elementwise, int8 gradient
compression bit for bit, the synthetic data, the train step (loss,
gradients, a 5-step trajectory) on weights carried from the JAX
package's ``init_train_state``, remat, crash-resume, train checkpoints
written by either package and loaded by the other, and the launcher.
Inputs are made with numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.store import checkpoint as jckpt  # noqa: E402
from repro.store.snapshot import SnapshotStore as JaxSnapshotStore  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_state import init_train_state as jax_init_train_state  # noqa: E402
from repro.train.train_state import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import train_state_from_flat  # noqa: E402
from repro_torch.store import checkpoint as tckpt  # noqa: E402
from repro_torch.store.snapshot import SnapshotStore  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_loop import TrainLoop  # noqa: E402
from repro_torch.train.train_state import (  # noqa: E402
    init_train_state,
    make_train_step,
    model_params,
)

# the dense family, DeepSeek-V2-Lite (MLA + MoE) and RecurrentGemma-9B
# (RG-LRU + local attention), at their smoke configs
ARCHS = ["qwen2-1.5b", "granite-3-8b", "deepseek-v2-lite-16b",
         "recurrentgemma-9b"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _jax_state(arch, seed=0, grad_compression=False):
    model = jax_build_model(jax_smoke_config(arch))
    return model, jax_init_train_state(model, jax.random.PRNGKey(seed),
                                       grad_compression=grad_compression)


def _port_state(arch, jstate, grad_compression=False, **cfg_changes):
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_changes)
    model = build_model(cfg, device="cpu")
    flat = jckpt.flatten_tree(jstate)
    return model, train_state_from_flat(model, flat, grad_compression)


def _tensors(flat):
    return {n: torch.from_numpy(np.array(a)) for n, a in flat.items()}


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_scaled(got, want, rtol, scaled_atol):
    """rtol elementwise, plus an absolute slack of ``scaled_atol`` times
    the tensor's largest magnitude: float32 sums in another order leave
    errors at the scale of the terms summed, which entries that cancel to
    near zero cannot hide behind a relative bar."""
    want = np.asarray(want)
    _close(got, want, rtol, scaled_atol * float(np.abs(want).max()))


def _batch(cfg, step=0, batch=2, seq=12, seed=1, skill=0):
    b = jdata.synth_batch(seed, step, batch, seq, cfg.vocab_size, skill)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


# ------------------------------------------------------------ optimizer
def _opt_inputs(arch, seed=0):
    """Params of the smoke model's shapes, grads, and moments at step 3."""
    _, jstate = _jax_state(arch)
    names = jckpt.flatten_tree(jstate.params)
    rng = np.random.default_rng(seed)
    p = {n: rng.normal(size=a.shape).astype(np.float32) for n, a in names.items()}
    g = {n: rng.normal(size=a.shape).astype(np.float32) for n, a in p.items()}
    m = {n: (0.1 * rng.normal(size=a.shape)).astype(np.float32)
         for n, a in p.items()}
    v = {n: (0.01 * rng.random(size=a.shape)).astype(np.float32)
         for n, a in p.items()}
    return p, g, m, v


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches_jax(arch, clip):
    p, g, m, v = _opt_inputs(arch)
    cfg = dict(OPT, grad_clip=clip)
    jp, jo, jm = jopt.adamw_update(
        jopt.AdamWConfig(**cfg), {n: jnp.asarray(a) for n, a in p.items()},
        {n: jnp.asarray(a) for n, a in g.items()},
        jopt.OptState({n: jnp.asarray(a) for n, a in m.items()},
                      {n: jnp.asarray(a) for n, a in v.items()},
                      jnp.asarray(3, jnp.int32)))
    tp = _tensors(p)
    state = topt.OptState(_tensors(m), _tensors(v),
                          torch.tensor(3, dtype=torch.int32))
    tp2, to, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp, _tensors(g),
                                    state)
    assert tp2 is tp and to is state        # in place
    assert to.step.dtype == torch.int32 and int(to.step) == int(jo.step) == 4
    # the clip scale comes from a norm summed in another order (an ulp
    # apart), and m = b1 m + (1 - b1) g cancels near zero
    for n in p:
        _close_scaled(tp[n], jp[n], 1e-6, 1e-6)
        _close_scaled(to.m[n], jo.m[n], 1e-6, 1e-6)
        _close_scaled(to.v[n], jo.v[n], 1e-6, 1e-6)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
    _close(tm["lr"], jm["lr"], 1e-6)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 10, 19, 20, 25])
def test_lr_schedule_matches_jax(step):
    cfg = dict(OPT, warmup_steps=3)
    got = topt.lr_schedule(topt.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    want = jopt.lr_schedule(jopt.AdamWConfig(**cfg),
                            jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
@pytest.mark.parametrize("arch", ARCHS)
def test_clip_by_global_norm_matches_jax(arch, max_norm):
    _, g, _, _ = _opt_inputs(arch, seed=2)
    jg, jn = jopt.clip_by_global_norm({n: jnp.asarray(a) for n, a in g.items()},
                                      max_norm)
    tg, tn = topt.clip_by_global_norm(_tensors(g), max_norm)
    _close(tn, jn, 1e-6)
    for n in g:
        _close(tg[n], jg[n], 1e-6)


def test_init_opt_state_is_zero_float32():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(2)}
    st = topt.init_opt_state(params)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    for tree in (st.m, st.v):
        assert all(t.dtype == torch.float32 and not t.any() for t in tree.values())
    assert st.m["a"].data_ptr() != st.v["a"].data_ptr()


# --------------------------------------------------------- compression
def test_grad_compress_bit_for_bit_with_error_feedback():
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 48), "b": (48,), "e": (7, 3, 5)}
    jef = jgc.init_error_feedback({n: jnp.zeros(s) for n, s in shapes.items()})
    tef = tgc.init_error_feedback({n: torch.zeros(s) for n, s in shapes.items()})
    for _ in range(3):
        g = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
        g["b"][:4] = np.float32(0.0)
        jg, jef = jgc.compress_decompress({n: jnp.asarray(a) for n, a in g.items()},
                                          jef)
        tg, tef = tgc.compress_decompress(_tensors(g), tef)
        for n in shapes:
            np.testing.assert_array_equal(tg[n].numpy(), np.asarray(jg[n]))
            np.testing.assert_array_equal(tef[n].numpy(), np.asarray(jef[n]))


def test_torch_round_is_half_to_even_as_jnp():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("skill", [0, 1, 2])
def test_synth_batch_equals_jax(skill):
    for step in (0, 5):
        got = tdata.synth_batch(3, step, 2, 9, 101, skill)
        want = jdata.synth_batch(3, step, 2, 9, 101, skill)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_stateless_indexing_on_device():
    pipe = tdata.DataPipeline(101, batch=2, seq=8, seed=3, skill=1,
                              start_step=5, device="cpu")
    try:
        for step in (5, 6, 7):
            b = next(pipe)
            want = tdata.synth_batch(3, step, 2, 8, 101, 1)
            for k in ("tokens", "labels"):
                assert b[k].dtype == torch.int64 and b[k].device.type == "cpu"
                np.testing.assert_array_equal(b[k].numpy(), want[k])
        assert pipe.state() == {"seed": 3, "step": 8, "skill": 1}
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
    with pytest.raises(RuntimeError, match="CUDA"):
        _no_card(lambda: tdata.DataPipeline(101, 2, 8))


def _no_card(fn):
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        return fn()
    finally:
        torch.cuda.is_available = real


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_loss_and_grads_match_jax(arch):
    jmodel, jstate = _jax_state(arch)
    model, state = _port_state(arch, jstate)
    cfg = get_smoke_config(arch)
    jb, tb = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(jstate.params, jb)
    loss = model.loss_fn(tb)
    loss.backward()
    _close(loss.detach(), jloss, 1e-5)
    jflat = jckpt.flatten_tree(jgrads)
    params = model_params(model)
    assert params.keys() == jflat.keys()
    # float32 sums in another order; the gradients are differences of
    # logit-sized terms (the smoke models' logits have std ~8)
    for n, p in params.items():
        _close_scaled(p.grad, jflat[n], 1e-4, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_step_trajectory_matches_jax(arch):
    jmodel, jstate = _jax_state(arch)
    model, state = _port_state(arch, jstate)
    cfg = get_smoke_config(arch)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    step = make_train_step(model, topt.AdamWConfig(**OPT))
    for i in range(5):
        jb, tb = _batch(cfg, step=i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k], 1e-4)
        assert all(p.grad is None for p in model.parameters())
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    jflat = jckpt.flatten_tree(jstate)
    for n, a in tckpt.flatten_tree(state).items():
        _close(a, jflat[n], 1e-3, 1e-5)


def test_remat_gives_equal_gradients():
    arch = "qwen2-1.5b"
    _, jstate = _jax_state(arch)
    cfg = get_smoke_config(arch)
    _, tb = _batch(cfg)
    grads = []
    for remat in (False, True):
        model, _ = _port_state(arch, jstate, remat=remat)
        model.loss_fn(tb).backward()
        grads.append({n: p.grad.clone() for n, p in model_params(model).items()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0)


def test_train_step_refuses_foreign_params():
    _, jstate = _jax_state("qwen2-1.5b")
    model, state = _port_state("qwen2-1.5b", jstate)
    other, _ = _port_state("qwen2-1.5b", jstate)
    step = make_train_step(other, topt.AdamWConfig(**OPT))
    _, tb = _batch(get_smoke_config("qwen2-1.5b"))
    with pytest.raises(ValueError, match="parameters"):
        step(state, tb)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_flat_names_equal_jax(arch):
    for gc in (False, True):
        _, jstate = _jax_state(arch, grad_compression=gc)
        _, state = _port_state(arch, jstate, grad_compression=gc)
        want = jckpt.flatten_tree(jstate)
        got = tckpt.flatten_tree(state)
        assert got.keys() == want.keys()
        for n in want:
            assert got[n].shape == want[n].shape
            assert got[n].dtype == want[n].dtype
            np.testing.assert_array_equal(got[n], want[n])
    if arch == "qwen2-1.5b":
        assert len(tckpt.flatten_tree(state)) == 43 + 14  # + ef/<14 params>


def test_flatten_tree_of_a_cpu_state_is_a_snapshot():
    """A flat copy taken before a step keeps its values after the step
    updates the state in place (a CPU tensor's numpy view would not)."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    before = tckpt.flatten_tree(state)
    kept = {n: a.copy() for n, a in before.items()}
    state, _ = make_train_step(model, topt.AdamWConfig(**OPT))(
        state, _batch(cfg)[1])
    after = tckpt.flatten_tree(state)
    for n in before:
        np.testing.assert_array_equal(before[n], kept[n])
    assert not np.array_equal(after["params/attn/wq"], kept["params/attn/wq"])
    assert int(after["opt/step"]) == 1


def test_init_train_state_redraws_from_the_generator():
    cfg = get_smoke_config("qwen2-1.5b")
    a, b = (init_train_state(build_model(cfg, device="cpu"),
                             torch.Generator().manual_seed(7))
            for _ in range(2))
    for n in a.params:
        torch.testing.assert_close(a.params[n], b.params[n], rtol=0, atol=0)
    assert a.ef is None and int(a.opt.step) == 0


# -------------------------------------------------- loop and checkpoints
def _loop(tmp_path, sub, arch="qwen2-1.5b"):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, topt.AdamWConfig(**OPT))
    snaps = SnapshotStore(str(tmp_path / f"ws{sub}"))
    return cfg, model, TrainLoop(model, step, snaps, ckpt_every=4,
                                 log_fn=lambda s: None)


def _pipe(cfg, start=0):
    return tdata.DataPipeline(cfg.vocab_size, batch=4, seq=16, seed=1,
                              start_step=start, device="cpu")


def test_crash_resume_is_bit_exact(tmp_path):
    def gen():
        return torch.Generator().manual_seed(0)

    cfg, model, loop_a = _loop(tmp_path, "a")
    pipe = _pipe(cfg)
    st = loop_a.run(init_train_state(model, gen()), pipe, num_steps=8)
    pipe.close()

    cfg, model, loop_b = _loop(tmp_path, "b")
    pipe = _pipe(cfg)
    with pytest.raises(RuntimeError):
        loop_b.run(init_train_state(model, gen()), pipe, num_steps=8,
                   crash_at_step=6)
    pipe.close()
    st_r, start = loop_b.restore_or_init(init_train_state(model, gen()))
    assert start == 4  # last durable checkpoint
    pipe = _pipe(cfg, start)
    st_resumed = loop_b.run(st_r, pipe, num_steps=8, start_step=start)
    pipe.close()
    a, b = tckpt.flatten_tree(st), tckpt.flatten_tree(st_resumed)
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])


def test_straggler_deadline_is_recorded(tmp_path):
    cfg, model, loop = _loop(tmp_path, "s")
    loop.step_deadline_s = 1e-9
    pipe = _pipe(cfg)
    try:
        loop.run(init_train_state(model, torch.Generator().manual_seed(0)),
                 pipe, num_steps=2)
    finally:
        pipe.close()
    assert loop.straggler_steps == [0, 1]


def test_jax_checkpoint_loads_into_port_and_continues(tmp_path):
    arch = "qwen2-1.5b"
    jmodel, jstate = _jax_state(arch)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    cfg = get_smoke_config(arch)
    for i in range(2):
        jstate, _ = jstep(jstate, _batch(cfg, step=i)[0])
    ws = str(tmp_path / "ws")
    sid = jckpt.save_train_checkpoint(JaxSnapshotStore(ws), 2, jstate)

    model = build_model(cfg, device="cpu")
    snaps = SnapshotStore(ws)
    assert tckpt.latest_checkpoint(snaps) == sid
    template = init_train_state(model, torch.Generator().manual_seed(5))
    state, step = tckpt.load_train_checkpoint(snaps, sid, template)
    assert step == 2 and state is template
    jflat = jckpt.flatten_tree(jstate)
    for n, a in tckpt.flatten_tree(state).items():
        np.testing.assert_array_equal(a, jflat[n])
    # both continue from step 2 on the same batch
    tstep = make_train_step(model, topt.AdamWConfig(**OPT))
    jb, tb = _batch(cfg, step=2)
    jstate, jm = jstep(jstate, jb)
    state, m = tstep(state, tb)
    _close(m["loss"], jm["loss"], 1e-5)
    assert int(state.opt.step) == 3


def test_port_checkpoint_loads_into_jax(tmp_path):
    arch = "granite-3-8b"
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(2),
                             grad_compression=True)
    step = make_train_step(model, topt.AdamWConfig(**OPT), grad_compression=True)
    state, _ = step(state, _batch(cfg)[1])
    ws = str(tmp_path / "ws")
    sid = tckpt.save_train_checkpoint(SnapshotStore(ws), 1, state)
    assert sid == "train-step-00000001"

    _, jtemplate = _jax_state(arch, grad_compression=True)
    jsnaps = JaxSnapshotStore(ws)
    assert jckpt.latest_checkpoint(jsnaps) == sid
    jstate, jstep = jckpt.load_train_checkpoint(jsnaps, sid, jtemplate)
    assert jstep == 1
    want = tckpt.flatten_tree(state)
    got = jckpt.flatten_tree(jstate)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


# ------------------------------------------------------------- launcher
def _train_checkpoint_resume(tmp_path, capsys, arch):
    """``launch.train --smoke --device cpu``: 4 steps checkpointed every 2,
    then a rerun to 6 resumes from the latest checkpoint."""
    ws = str(tmp_path / "ws")
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
            "--steps", "4", "--ckpt-every", "2", "--batch", "2", "--seq",
            "16", "--workspace", ws]
    train_cli.main(argv)
    snaps = SnapshotStore(ws)
    assert tckpt.latest_checkpoint(snaps) == "train-step-00000004"
    assert sorted(snaps.list_snapshots()) == ["train-step-00000002",
                                              "train-step-00000004"]
    train_cli.main(argv[:6] + ["6"] + argv[7:])
    out = capsys.readouterr().out
    assert "resumed from train-step-00000004 at step 4" in out
    assert tckpt.latest_checkpoint(SnapshotStore(ws)) == "train-step-00000006"


def test_launch_train_trains_checkpoints_and_resumes(tmp_path, capsys):
    _train_checkpoint_resume(tmp_path, capsys, "qwen2-1.5b")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_launch_train_trains_mla_and_hybrid_families(tmp_path, capsys, arch):
    """DeepSeek-V2-Lite (MLA + MoE), RecurrentGemma-9B and Mamba-2 (SSD)
    through the launcher as the dense family goes."""
    _train_checkpoint_resume(tmp_path, capsys, arch)


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod"])
def test_launch_train_mesh_flags_not_ported(tmp_path, flag):
    """The production meshes are taken, and need a group of 256 / 512
    ranks: one process fails loudly, and closes the group it opened."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="production mesh needs a process "
                                           "group of (256|512) ranks"):
        train_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                        "--workspace", str(tmp_path / "ws"), flag])
    assert not dist.is_initialized()


def test_launch_train_defaults_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        _no_card(lambda: train_cli.main(
            ["--arch", "qwen2-1.5b", "--smoke", "--workspace",
             str(tmp_path / "ws")]))


@pytest.mark.parametrize("arch,embeds", [
    ("llama-3.2-vision-90b", "vision_embeds"),
    ("whisper-tiny", "audio_embeds")])
def test_launch_train_refuses_other_families(tmp_path, arch, embeds):
    """The vision and audio families need context embeddings in every
    batch, which the launcher's data pipeline (as the reference's) does
    not make: one clear error, before any model is built."""
    with pytest.raises(SystemExit, match=f"needs {embeds} in every batch"):
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--workspace", str(tmp_path / "ws")])
