"""Process-group runs for ``test_torch_mesh_train.py``: each opens its own
gloo group, so none runs inside a pytest worker.

    python tests/torch_mesh_worker.py train WORLD OUT ARCH...
        WORLD ranks on the CPU (1: the (1, 1) mesh; 4: (2, 2)) under
        train_rules: each smoke config's forward, loss (remat on, its
        backward on a thread of its own, as a card's) and one AdamW step
        through the launcher's path (parameters distributed by
        param_specs, batches placed by the data pipeline) against the
        meshless port from the same seed.  Rank 0 writes the largest
        differences to OUT as JSON.
    python tests/torch_mesh_worker.py serve OUT ARCH...
        4 ranks, (2, 2) under serve_rules: a prompt's prefill and one
        decode step against a cache placed by cache_logical_specs (MLA's
        latent cache sequence-sharded over "model"), against the meshless
        port; rank 0 writes the differences and the cache's placements.
    python tests/torch_mesh_worker.py rows OUT
        4 ranks on a (2, 2) ("pod", "data") mesh: which rows of an
        8-row tensor each mesh coordinate keeps under Shard(0) on both
        dims (logical "batch" over ("pod", "data")).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import free_port, make_debug_mesh  # noqa: E402
from repro_torch.launch.sharding import distribute_parameters  # noqa: E402
from repro_torch.models import build_model, shardctx  # noqa: E402
from repro_torch.train.data import DataPipeline  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_state import (  # noqa: E402
    TrainState,
    make_train_step,
    model_params,
)

BATCH, SEQ = 4, 16


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(max |want|, 1)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                   1.0)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _backward_on_another_thread(loss: torch.Tensor) -> None:
    """``loss.backward()`` from a thread of its own, as autograd runs a
    card's backward (and remat's recompute) on its device thread, which
    carries the caller's thread-local state (DTensor's implicit
    replication among it) but not Python's ``threading.local``."""
    from torch.distributed.tensor.experimental import implicit_replication

    errors = []

    def run():
        try:
            with implicit_replication():
                loss.backward()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    if errors:
        raise errors[0]


def _run(cfg, mesh, seed: int):
    """forward logits, loss, gradients and the parameters after one step
    (AdamW with eps 1e-3: its first step is g / (|g| + eps), which for
    eps ~ 0 is sign(g) and turns a rounding-level difference in a
    near-zero gradient into a full step)."""
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    if mesh is not None:
        distribute_parameters(model, mesh, shardctx.get_rules())
    params = model_params(model)
    state = TrainState(params, init_opt_state(params), None)
    step = make_train_step(model, AdamWConfig(lr=1e-3, eps=1e-3,
                                              warmup_steps=1))
    pipe = DataPipeline(cfg.vocab_size, batch=BATCH, seq=SEQ, seed=seed,
                        device="cpu")
    try:
        batch = next(pipe)
    finally:
        pipe.close()
    with torch.no_grad():
        logits = _whole(model.forward(batch["tokens"]))
    _backward_on_another_thread(model.loss_fn(batch))
    grads = {n: _whole(p.grad) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    _, metrics = step(state, batch)
    return logits, float(metrics["loss"]), grads, {
        n: _whole(p.detach()) for n, p in params.items()}, type(
            batch["tokens"]).__name__


def _train(rank: int, world: int, port: int, out: str, archs) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = make_debug_mesh(device_type="cpu")
        result = {"mesh": list(mesh.shape), "archs": {}}
        for arch in archs:
            # remat: the backward recomputes each layer under the mesh
            cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
            want = _run(cfg, None, seed=7)
            with shardctx.use_mesh(mesh, shardctx.train_rules(False)):
                got = _run(cfg, mesh, seed=7)
            result["archs"][arch] = {
                "logits": _rel(got[0], want[0]),
                "loss": [got[1], want[1]],
                "grads": max(_rel(got[2][n], want[2][n]) for n in want[2]),
                "params": max(_rel(got[3][n], want[3][n]) for n in want[3]),
                "batch_type": got[4],
            }
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _serve(rank: int, world: int, port: int, out: str, archs) -> None:
    from repro_torch.launch.sharding import (
        batch_sharding,
        distribute,
        spec_to_sharding,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = make_debug_mesh(device_type="cpu")
        rules = shardctx.serve_rules(False)
        result = {}
        for arch in archs:
            cfg = get_smoke_config(arch)
            tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ - 4),
                                   generator=torch.Generator().manual_seed(4))
            ref = build_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
            first, prompt = ref.prefill(tokens)
            cache = ref.init_cache(BATCH, SEQ)
            for k, v in prompt.items():
                if k == "len":
                    cache[k] = v
                else:
                    cache[k][:, :, :v.shape[2]] = v
            start = {k: v if k == "len" else v.clone()
                     for k, v in cache.items()}
            nxt = first.argmax(-1)
            step, cache = ref.decode_step(nxt, cache)
            with shardctx.use_mesh(mesh, rules):
                model = build_model(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(3))
                distribute_parameters(model, mesh, rules)

                def placed(t):
                    return distribute(t, mesh, batch_sharding(
                        mesh, rules, tuple(t.shape)))

                got_first, _ = model.prefill(placed(tokens))
                logical = model.cache_logical_specs()
                got_cache = {k: v if k == "len" else distribute(
                    v, mesh, spec_to_sharding(mesh, rules, logical[k],
                                              tuple(v.shape)))
                    for k, v in start.items()}
                got_step, got_cache = model.decode_step(placed(nxt),
                                                        got_cache)
                result[arch] = {
                    "prefill": _rel(_whole(got_first), first),
                    "decode": _rel(_whole(got_step), step),
                    "cache": max(_rel(_whole(got_cache[k]), cache[k])
                                 for k in cache if k != "len"),
                    "placements": {k: [str(p) for p in v.placements]
                                   for k, v in got_cache.items()
                                   if k != "len"},
                }
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _rows(rank: int, world: int, port: int, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        t = distribute_tensor(torch.arange(8), mesh, [Shard(0), Shard(0)],
                              src_data_rank=None)
        mine = (list(mesh.get_coordinate()), t.to_local().tolist())
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({str(tuple(c)): rows for c, rows in every}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "train":
        world = int(sys.argv[2])
        mp.spawn(_train, args=(world, free_port(), sys.argv[3], sys.argv[4:]),
                 nprocs=world)
    elif what == "serve":
        mp.spawn(_serve, args=(4, free_port(), sys.argv[2], sys.argv[3:]),
                 nprocs=4)
    elif what == "rows":
        mp.spawn(_rows, args=(4, free_port(), sys.argv[2]), nprocs=4)
    else:
        raise SystemExit(f"unknown run {what!r}")
