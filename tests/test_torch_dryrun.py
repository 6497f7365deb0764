"""``python -m repro_torch.launch.dryrun``, in a process of its own (its
fake 256-rank group never opens in a pytest worker): a train cell and a
decode cell on the (16, 16) production mesh give the reference's record
keys with ``status == "ok"``; per-device argument bytes equal the local
shards that ``spec_to_sharding`` implies for the state and the inputs;
training moves bytes through collectives; and the model-FLOPs share is
what the layout allows.

qwen2-1.5b's 12 query heads (2 kv heads) cannot split over a 16-wide
model axis, so the rules replicate its attention there, as the
reference's do: every model rank computes its batch shard's whole
attention, most of its FLOPs, and its useful share is ~0.12.
DeepSeek-V2-Lite's 16 heads, experts' widths and vocabulary all divide
the model axis: its share lies in [0.5, 2]."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Shard

from repro_torch.configs import get_config
from repro_torch.launch import sharding
from repro_torch.models import SHAPES, build_model, shardctx

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KEYS = {"arch", "shape", "mesh", "status", "n_chips", "memory", "cost",
        "collectives", "roofline_terms", "dominant_term", "model_flops"}
KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute"}


class StandIn:
    mesh_dim_names = ("data", "model")
    shape = (16, 16)


def _dryrun(arch, shape):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape],
                       capture_output=True, text=True, timeout=900, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec["status"]
    assert KEYS <= rec.keys()
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["temp_bytes"])
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert set(rec["collectives"]["bytes_by_kind"]) <= KINDS
    assert set(rec["roofline_terms"]) == {"compute_s", "memory_s",
                                          "collective_s"}
    assert rec["dominant_term"] in rec["roofline_terms"]
    return rec


def _local_numel(logical, shape, rules) -> int:
    placements = sharding.spec_to_sharding(StandIn(), rules, logical, shape)
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= StandIn.shape[m]
    return math.prod(local)


def _param_numels(arch, rules):
    model = build_model(get_config(arch), device="meta")
    specs = model.param_specs()
    return model, [(p, _local_numel(specs[n.replace(".", "/")],
                                    tuple(p.shape), rules))
                   for n, p in model.named_parameters()]


def _tokens_bytes(shape, seq) -> int:
    b = SHAPES[shape]["batch"]
    return (b // 16 if b % 16 == 0 else b) * seq * 8   # int64


def test_dryrun_train_cell_records_the_reference_keys():
    rec = _dryrun("qwen2-1.5b", "train_4k")
    rules = shardctx.train_rules(False)
    _, numels = _param_numels("qwen2-1.5b", rules)
    # params, AdamW's m and v (float32), its step (int32), tokens, labels
    want = sum(n * (p.element_size() + 8) for p, n in numels) + 4
    want += 2 * _tokens_bytes("train_4k", SHAPES["train_4k"]["seq"])
    assert rec["memory"]["argument_bytes"] == want
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["n_ops"] > 0
    mf = rec["model_flops"]
    assert mf["useful_fraction"] == pytest.approx(
        mf["model_flops_per_device"] / rec["cost"]["flops"])
    assert 0.1 <= mf["useful_fraction"] <= 2


def test_dryrun_moe_train_cell_useful_fraction():
    rec = _dryrun("deepseek-v2-lite-16b", "train_4k")
    assert 0.5 <= rec["model_flops"]["useful_fraction"] <= 2


def test_dryrun_decode_cell_records_the_reference_keys():
    rec = _dryrun("qwen2-1.5b", "decode_32k")
    rules = shardctx.serve_rules(False)
    model, numels = _param_numels("qwen2-1.5b", rules)
    want = sum(n * 2 for _, n in numels)                  # bf16 weights
    logical = model.cache_logical_specs()
    b, s = SHAPES["decode_32k"]["batch"], SHAPES["decode_32k"]["seq"]
    for name, (shape, dtype) in model.cache_specs(b, s).items():
        if name != "len":
            want += _local_numel(logical[name], shape, rules) * torch.empty(
                (), dtype=dtype).element_size()
    want += _tokens_bytes("decode_32k", 1)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["model_flops"] is None
