"""Multi-pod dry-run: prove the distribution config is coherent — the JAX
package's ``launch/dryrun.py`` over ``torch.distributed``.

For every (architecture × input shape) cell this runs the production
step — the train step (forward, backward, AdamW) for train shapes,
``prefill`` for prefill shapes, ``decode_step`` for decode shapes —
against the single-pod (16, 16) mesh and the 2-pod (2, 16, 16) mesh,
with parameters (and the AdamW moments) placed by ``param_specs`` under
``train_rules`` / ``serve_rules`` and inputs by ``batch_sharding`` /
``cache_logical_specs``, on ``meta`` tensors (no allocation).  Where the
reference compiles against 512 placeholder XLA devices, the process
opens a fake process group of 256 or 512 ranks (the collectives do
nothing, DTensor plans them all the same) and follows rank 0:

* ``memory``: per-device bytes, counted exactly from the local shards:
  ``argument_bytes`` (state and inputs held when the step starts),
  ``output_bytes`` (what the step returns; the train step and decode
  update their buffers in place), ``temp_bytes`` (the most bytes the
  step's own tensors held at once: activations, gradients, collective
  buffers) and ``peak_bytes`` (arguments plus temporaries).
* ``cost``: per-device ``flops``, by ``torch.utils.flop_counter``'s
  registry (FlopCounterMode's) applied to each local op (FlopCounterMode
  alone would count a DTensor op at its global shape), and
  ``bytes_accessed``, each local op's operand and result bytes.  On
  ``meta`` the port's plain kernel versions run, so attention's products
  are counted: the plain flash attention's full masked tiles at training
  (the kernels skip them), its causal reach at prefill.
* ``collectives``: :func:`collective_stats` over ``CommDebugMode``'s
  record (not HLO text): each collective's result bytes by kind, in the
  reference's kind names.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod | --both-meshes] [--out dryrun.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Run it as a process of its own: it opens the fake group before anything
else touches ``torch.distributed``.  It needs no card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import weakref
from collections import defaultdict
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import arch_ids, get_config
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.launch.sharding import (
    batch_sharding,
    distribute,
    distribute_parameters,
    spec_to_sharding,
)
from repro_torch.models import SHAPES, build_model, input_specs, shape_applicable
from repro_torch.models import shardctx
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_state import TrainState, make_train_step, model_params

#: NVIDIA H100 SXM from its data sheet (the cards this port runs on:
#: "NVIDIA H100 80GB HBM3, 700.00 W" by nvidia-smi), per device, for the
#: roofline terms.  A 16-wide model axis spans two 8-GPU NVLink domains
#: (450 GB/s each way inside one), so its collectives cross the nodes'
#: InfiniBand, one 400 Gb/s NDR port a GPU: that link bounds them.
HW = {
    "peak_flops_bf16": 989e12,      # FLOP/s, dense
    "hbm_bw": 3.35e12,              # B/s
    "link_bw": 50e9,                # B/s, the model axis's slowest hop
}

#: functional collectives -> the reference's (HLO) kind names
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def open_fake_group(world: int) -> None:
    """The default group as ``world`` fake ranks (this process is rank
    0), reopened where it has another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of the tensors in ``tree`` (each
    storage once)."""
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class CollectiveRecorder(CommDebugMode):
    """``CommDebugMode``, which also keeps each collective's result bytes
    (the bytes one rank receives or keeps) by kind."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_by_kind: Dict[str, int] = defaultdict(int)
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = getattr(getattr(func, "_overloadpacket", None), "__name__", "")
        if out is not NotImplemented and name in KINDS:
            self.bytes_by_kind[KINDS[name]] += sum(
                t.nbytes for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
            self.n_ops += 1
        return out


def collective_stats(comm: CollectiveRecorder) -> Dict[str, Any]:
    """Per-device collective bytes by kind, from ``CommDebugMode``'s
    record of the functional collectives DTensor issued (the reference
    parses the compiled HLO's text instead)."""
    per_kind = dict(comm.bytes_by_kind)
    return {"bytes_by_kind": per_kind, "total_bytes": sum(per_kind.values()),
            "n_ops": comm.n_ops}


class LocalCost(TorchDispatchMode):
    """FLOPs, bytes accessed and live bytes of one rank's local ops.

    A DTensor op returns ``NotImplemented`` here, so DTensor runs it and
    its local ops (and the collectives it plans) come back through this
    mode.  A new storage is counted live from the op that made it until
    it is freed (a finalizer on the storage object, which lives as long
    as any tensor or autograd node holds the storage); storages that
    existed before the mode was entered are the arguments.  The global-
    shape stand-ins DTensor's sharding propagation builds to infer an
    op's output metadata are no rank's data: ops under it are not
    counted."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0

    def _release(self, key: int, nbytes: int) -> None:
        # the storage is gone; a new one may come at its address
        self.live -= nbytes
        self._known.discard(key)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._known = set()
        self._quiet = 0
        self._restore = []
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            infer = ShardingPropagator.__dict__.get(name)
            if callable(infer):
                self._restore.append((name, infer))
                setattr(ShardingPropagator, name, self._quieted(infer))
        return super().__enter__()

    def _quieted(self, infer):
        def quiet(prop, *args, **kwargs):
            self._quiet += 1
            try:
                return infer(prop, *args, **kwargs)
            finally:
                self._quiet -= 1

        return quiet

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, infer in self._restore:
            setattr(ShardingPropagator, name, infer)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._quiet:
            return func(*args, **kwargs)
        before = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes_accessed += sum(
                t.nbytes for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)) + sum(t.nbytes for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in before or key in self._known:
                continue
            self._known.add(key)
            # a collective's meta version may return a view of a larger
            # stand-in: a rank holds the result alone
            nbytes = t.nbytes if packet.__name__ in KINDS else st.nbytes()
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, nbytes)
        return out


@contextlib.contextmanager
def card_alltoall():
    """DTensor moves a shard from one dim to another with an all-to-all
    on the card (NCCL), and with an all-gather plus a chunk on a mesh of
    CPU ranks (gloo has none).  The fake group stands for the card's:
    inside, the all-to-all is planned (its meta version gives each rank's
    result shape, which is what it moves)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    users = [m for m in (placement_types, _collective_utils)
             if hasattr(m, "shard_dim_alltoall")]
    cpu_fallback = [m.shard_dim_alltoall for m in users]
    for m in users:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(users, cpu_fallback):
            m.shard_dim_alltoall = f


def _rules(shape: str, multi_pod: bool) -> Dict:
    if SHAPES[shape]["kind"] == "train":
        return shardctx.train_rules(multi_pod)
    return shardctx.serve_rules(multi_pod)


def build_step(cfg, kind: str, specs: Dict[str, Any], mesh, rules: Dict,
               cache_len: int = 0):
    """(step, arguments) of a ``kind`` cell ("train", "prefill" or
    "decode") of ``cfg`` over the meta inputs ``specs`` (as
    ``input_specs`` makes them), inside ``use_mesh(mesh, rules)``: the
    model on ``meta``, parameters and inputs distributed."""
    model = build_model(cfg, device="meta")
    if kind != "train":
        # Serving runs on compute-dtype weights (bf16), as the reference
        # casts them once at model load.
        model.to(getattr(torch, cfg.compute_dtype))
    distribute_parameters(model, mesh, rules)
    params = model_params(model)

    def placed(t):
        return distribute(t, mesh, batch_sharding(mesh, rules,
                                                  tuple(t.shape)))

    if kind == "train":
        state = TrainState(params, init_opt_state(params), None)
        batch = {k: placed(v) for k, v in specs["batch"].items()}
        step = make_train_step(model, AdamWConfig())
        return (lambda: step(state, batch)), (state, batch)

    if kind == "prefill":
        ctx = [placed(v) for k, v in specs.items() if k != "tokens"]
        tokens = placed(specs["tokens"])
        return (lambda: model.prefill(tokens, *ctx)), (params, tokens, ctx)

    logical = model.cache_logical_specs()
    cache = {name: distribute(t, mesh, spec_to_sharding(
        mesh, rules, logical[name], tuple(t.shape)))
        for name, t in specs["cache"].items() if name != "len"}
    cache["len"] = cache_len - 1   # the last free position
    tokens = placed(specs["tokens"])
    return (lambda: model.decode_step(tokens, cache)), (params, tokens, cache)


def measure(step, args) -> Dict[str, Any]:
    """Run ``step`` once under the counters: memory, cost and collectives
    per device, as :func:`run_cell` records them."""
    arg_bytes = local_bytes(args)
    with card_alltoall(), CollectiveRecorder() as comm, LocalCost() as cost:
        out = step()
    return {
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": local_bytes(out),
                   "temp_bytes": cost.peak,
                   "peak_bytes": arg_bytes + cost.peak},
        "cost": {"flops": cost.flops, "bytes_accessed": cost.bytes_accessed},
        "collectives": collective_stats(comm),
    }


def train_memory(cfg, batch: int, seq: int, mesh, rules: Dict) -> Dict:
    """The per-device memory of one train step of ``cfg`` over ``batch`` x
    ``seq`` tokens on ``mesh``, counted as :func:`run_cell` counts it (the
    smoke's ``mesh`` phase holds a card's peak to it)."""
    tokens = torch.empty((batch, seq), dtype=torch.int64, device="meta")
    specs = {"batch": {"tokens": tokens, "labels": tokens.clone()}}
    with shardctx.use_mesh(mesh, rules):
        return measure(*build_step(cfg, "train", specs, mesh, rules))[
            "memory"]


def run_cell(arch: str, shape: str, multi_pod: bool) -> Dict[str, Any]:
    cfg = get_config(arch)
    skip = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if skip:
        rec["status"] = skip
        return rec

    t0 = time.time()
    open_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips, _ = mesh_info(mesh)
    rules = _rules(shape, multi_pod)
    with shardctx.use_mesh(mesh, rules):
        step, args = build_step(cfg, SHAPES[shape]["kind"],
                                input_specs(cfg, shape), mesh, rules,
                                SHAPES[shape]["seq"])
        t_build = time.time() - t0
        got = measure(step, args)
        t_step = time.time() - t0 - t_build
    flops, coll = got["cost"]["flops"], got["collectives"]
    terms = {
        "compute_s": flops / HW["peak_flops_bf16"],
        "memory_s": got["cost"]["bytes_accessed"] / HW["hbm_bw"],
        "collective_s": coll["total_bytes"] / HW["link_bw"],
    }
    dominant = max(terms, key=lambda k: terms[k])

    # model-FLOPs utilization sanity: 6·N·D for train shapes
    model_flops_term = None
    if SHAPES[shape]["kind"] == "train":
        n_active = cfg.active_param_count()
        tokens = SHAPES[shape]["batch"] * SHAPES[shape]["seq"]
        model_flops = 6 * n_active * tokens / n_chips  # per device
        model_flops_term = {
            "model_flops_per_device": model_flops,
            "useful_fraction": (model_flops / flops) if flops else None,
        }

    rec.update(
        status="ok",
        n_chips=n_chips,
        build_s=round(t_build, 1),
        step_s=round(t_step, 1),
        memory=got["memory"],
        cost=got["cost"],
        collectives=coll,
        roofline_terms=terms,
        dominant_term=dominant,
        model_flops=model_flops_term,
    )
    return rec


def cells(args) -> list:
    if args.all:
        return [(a, s, mp) for a in arch_ids() for s in SHAPES
                for mp in (False, True)]
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    return [(args.arch, args.shape, mp) for mp in meshes]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=arch_ids())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape x mesh) cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    if not args.all and (not args.arch or not args.shape):
        ap.error("--arch and --shape required (or --all)")

    out_f = open(args.out, "a") if args.out else None
    try:
        for a, s, mp in cells(args):
            try:
                rec = run_cell(a, s, mp)
            # broad-except-ok: the sweep records the failure as the
            # cell's result and goes on; offline tool, no merge state
            except Exception as e:  # noqa: BLE001
                rec = {"arch": a, "shape": s,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": f"FAIL: {type(e).__name__}: {e}"}
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()


if __name__ == "__main__":
    main()
