"""Analytic FLOPs / HBM-byte model per (arch × shape) — roofline inputs;
a copy of the JAX package's ``launch/flops.py`` (the same numbers).

Why analytic: XLA's ``compiled.cost_analysis()`` counts each while-loop
body ONCE (trip counts are not in HLO), so any scan-over-layers program
under-reports FLOPs by ~n_layers and chunked attention by ~n_chunks.
The dry-run records the raw HLO numbers anyway; the roofline uses these
closed-form per-device estimates, which follow the standard 6·N·D
methodology extended with exact attention/SSD/LRU terms.

Conventions:
  * matmul (m, k)x(k, n): 2·m·k·n FLOPs
  * training = fwd + bwd = 3x fwd matmul FLOPs; remat(nothing_saveable)
    adds one more fwd => 4x (flag ``remat``)
  * causal attention scores+pv: 2 · B·H·S²·hd ( * 1/2 causal, but our
    chunked kernel computes masked full tiles => no 1/2 discount; the
    block-skip optimization in §Perf claims it back — both variants are
    modeled via ``causal_skip``)
  * HBM bytes: params read once per step (+grad +opt traffic for train)
    plus activation traffic ~ 2 bytes/elem in + out per major op.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import SHAPES


@dataclasses.dataclass
class CostBreakdown:
    flops_fwd: float = 0.0        # global forward FLOPs
    attn_flops_fwd: float = 0.0   # included in flops_fwd
    param_bytes: float = 0.0      # all-param footprint (param dtype)
    act_bytes_fwd: float = 0.0    # global activation HBM traffic (fwd)

    def totals(self, kind: str, remat: bool) -> Dict[str, float]:
        if kind == "train":
            mult = 4.0 if remat else 3.0
            flops = self.flops_fwd * mult
            # params read (fwd+bwd) + grad write + adam m/v read/write (f32)
            opt_bytes = self.param_bytes * (2 + 1 + 4 * 2)
            act = self.act_bytes_fwd * (2.0 if not remat else 3.0)
            return {"flops": flops, "hbm_bytes": opt_bytes + act}
        flops = self.flops_fwd
        return {"flops": flops, "hbm_bytes": self.param_bytes + self.act_bytes_fwd}


def _attention_flops(cfg, b, s_q, s_kv, causal_skip=False) -> float:
    hd = cfg.resolved_head_dim
    h = cfg.n_heads
    if cfg.mla:
        hd_k = cfg.nope_head_dim + cfg.rope_head_dim
        f = 2 * b * h * s_q * s_kv * hd_k + 2 * b * h * s_q * s_kv * cfg.v_head_dim
    else:
        f = 4 * b * h * s_q * s_kv * hd
    if causal_skip and s_q == s_kv:
        f *= 0.5
    return f


def forward_cost(
    cfg: ModelConfig, batch: int, seq: int, causal_skip: bool = False
) -> CostBreakdown:
    """Global forward cost of one pass over (batch, seq) tokens."""
    c = CostBreakdown()
    d = cfg.d_model
    t = batch * seq
    pb = 4 if cfg.param_dtype == "float32" else 2
    c.param_bytes = cfg.param_count() * pb
    act = 0.0

    def mm(tokens, k, n):  # matmul over tokens
        return 2.0 * tokens * k * n

    n_layers = cfg.n_layers
    for _ in range(1):  # per-layer terms multiplied below
        pass

    per_layer_flops = 0.0
    per_layer_attn = 0.0
    if cfg.attention_free:  # mamba2 SSD
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        h = d_in // cfg.ssm_head_dim
        q = cfg.ssm_chunk
        per_layer_flops += mm(t, d, 2 * d_in + 2 * n + h)  # in_proj
        per_layer_flops += mm(t, d_in, d)                  # out_proj
        # SSD: intra-chunk (Q x Q per head) + state updates
        per_layer_flops += 2.0 * t * q * (n + cfg.ssm_head_dim * h) / 1.0
        per_layer_flops += 4.0 * t * h * cfg.ssm_head_dim * n  # state in/out
        act += t * (2 * d_in + 2 * n + h) * 2
    else:
        hd = cfg.resolved_head_dim
        if cfg.mla:
            r = cfg.kv_lora_rank
            dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
            per_layer_flops += mm(t, d, cfg.n_heads * (dn + dr))       # q
            per_layer_flops += mm(t, d, r + dr)                         # dkv
            per_layer_flops += mm(t, r, cfg.n_heads * (dn + dv))        # uk/uv
            per_layer_flops += mm(t, cfg.n_heads * dv, d)               # wo
        else:
            per_layer_flops += mm(t, d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd)
            per_layer_flops += mm(t, cfg.n_heads * hd, d)
        s_kv = min(seq, cfg.local_window) if cfg.local_window else seq
        a = _attention_flops(cfg, batch, seq, s_kv, causal_skip)
        per_layer_attn += a
        per_layer_flops += a
        if cfg.moe:
            ff = cfg.moe_d_ff or cfg.d_ff
            k = cfg.experts_per_token * cfg.capacity_factor
            per_layer_flops += mm(t, d, cfg.n_experts)  # router
            per_layer_flops += k * 3 * mm(t, d, ff)
            per_layer_flops += cfg.n_shared_experts * 3 * mm(t, d, ff)
        else:
            per_layer_flops += 3 * mm(t, d, cfg.d_ff)
        act += t * d * 6 * 2  # residual stream traffic (bf16)

    if cfg.rglru:
        # 2 of 3 layers are recurrent instead of attention
        w = cfg.rglru_width or d
        rec_flops = 3 * mm(t, d, w) + 2 * mm(t, w, w) + mm(t, w, d) + 10.0 * t * w
        att_layer = per_layer_flops
        per_layer_flops = (2 * (rec_flops + 3 * mm(t, d, cfg.d_ff))
                           + (att_layer + 0)) / 3.0
        per_layer_attn = per_layer_attn / 3.0

    flops = n_layers * per_layer_flops
    attn_total = n_layers * per_layer_attn

    if cfg.cross_attn_every:
        # gated cross-attn every Nth layer over vision_tokens
        n_cross = cfg.n_layers // cfg.cross_attn_every
        hd = cfg.resolved_head_dim
        xa = (
            mm(t, d, 2 * cfg.n_heads * hd)
            + _attention_flops(cfg, batch, seq, cfg.vision_tokens)
            + 2 * mm(batch * cfg.vision_tokens, d, cfg.n_kv_heads * hd)
        )
        flops += n_cross * xa

    if cfg.encoder_decoder:
        te = batch * cfg.encoder_seq
        hd = cfg.resolved_head_dim
        enc_layer = (
            mm(te, d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd)
            + mm(te, cfg.n_heads * hd, d)
            + _attention_flops(cfg, batch, cfg.encoder_seq, cfg.encoder_seq)
            + 3 * mm(te, d, cfg.d_ff)
        )
        flops += cfg.n_encoder_layers * enc_layer
        # decoder cross-attn over encoder_seq
        flops += cfg.n_layers * (
            _attention_flops(cfg, batch, seq, cfg.encoder_seq)
            + mm(t, d, cfg.n_heads * hd)
            + 2 * mm(batch * cfg.encoder_seq, d, cfg.n_kv_heads * hd)
        )

    # embedding + unembed
    flops += 2.0 * t * d * cfg.vocab_size
    act += t * cfg.vocab_size * 2  # logits traffic

    c.flops_fwd = flops
    c.attn_flops_fwd = attn_total
    c.act_bytes_fwd = act + t * d * 4
    return c


def decode_cost(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, float]:
    """One serve_step (single new token, cache of cache_len)."""
    c = forward_cost(cfg, batch, 1)
    flops = c.flops_fwd
    cache_bytes = 0.0
    if not cfg.attention_free:
        s_kv = min(cache_len, cfg.local_window) if cfg.local_window else cache_len
        if cfg.rglru:
            att_layers = cfg.n_layers // 3
        else:
            att_layers = cfg.n_layers
        if cfg.mla:
            per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
            # latent expansion for all cached positions
            flops += att_layers * 2 * batch * s_kv * cfg.kv_lora_rank * \
                cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
        flops += att_layers * _attention_flops(cfg, batch, 1, s_kv)
        cache_bytes = att_layers * batch * s_kv * per_tok * 2.0
    else:
        d_in = cfg.ssm_expand * cfg.d_model
        h = d_in // cfg.ssm_head_dim
        cache_bytes = cfg.n_layers * batch * h * cfg.ssm_head_dim * \
            cfg.ssm_state * 4.0
        flops += cfg.n_layers * 4.0 * batch * h * cfg.ssm_head_dim * cfg.ssm_state
    pb = 4 if cfg.param_dtype == "float32" else 2
    return {
        "flops": flops,
        "hbm_bytes": cfg.param_count() * pb + cache_bytes + c.act_bytes_fwd,
    }


def cell_cost(
    cfg: ModelConfig, shape: str, n_chips: int, causal_skip: bool = False
) -> Dict[str, float]:
    """Per-device analytic {flops, hbm_bytes} for an (arch × shape) cell."""
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        c = forward_cost(cfg, sh["batch"], sh["seq"], causal_skip)
        tot = c.totals("train", cfg.remat)
    elif sh["kind"] == "prefill":
        c = forward_cost(cfg, sh["batch"], sh["seq"], causal_skip)
        tot = c.totals("prefill", False)
    else:
        tot = decode_cost(cfg, sh["batch"], sh["seq"])
    return {k: v / n_chips for k, v in tot.items()}


def model_flops_per_token(cfg: ModelConfig) -> float:
    """6·N_active·(1 token) — the MODEL_FLOPS convention for §Roofline."""
    return 6.0 * cfg.active_param_count()
