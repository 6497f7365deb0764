"""``launch/flops.py`` — the analytic FLOPs / HBM-byte model — against the
JAX package's, for every arch x shape: the same numbers."""
import dataclasses

import pytest

from repro.configs import arch_ids
from repro.configs import get_config as jget_config
from repro.launch import flops as jflops
from repro_torch.configs import get_config
from repro_torch.launch import flops
from repro_torch.models import SHAPES


@pytest.mark.parametrize("arch", arch_ids())
def test_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert flops.model_flops_per_token(cfg) == \
        jflops.model_flops_per_token(jcfg)
    for shape, sh in SHAPES.items():
        for skip in (False, True):
            got = flops.forward_cost(cfg, sh["batch"], sh["seq"], skip)
            want = jflops.forward_cost(jcfg, sh["batch"], sh["seq"], skip)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for kind in ("train", "prefill"):
                for remat in (False, True):
                    assert got.totals(kind, remat) == want.totals(kind,
                                                                  remat)
            for n_chips in (1, 256, 512):
                assert flops.cell_cost(cfg, shape, n_chips, skip) == \
                    jflops.cell_cost(jcfg, shape, n_chips, skip), (shape,
                                                                   n_chips)
        if sh["kind"] == "decode":
            assert flops.decode_cost(cfg, sh["batch"], sh["seq"]) == \
                jflops.decode_cost(jcfg, sh["batch"], sh["seq"])
