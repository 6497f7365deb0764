"""Decoder-only transformer LM (dense GQA / MoE / MLA families) — the JAX
package's ``models/transformer.py`` in torch.

Covers qwen2 (QKV bias), granite, starcoder2, qwen3 (qk-norm), grok-1
(MoE FFN) and deepseek-v2-lite (MLA attention + MoE FFN with shared
experts).  The parameter tree is the reference's: ``embed.embedding``,
``attn.wq`` of shape (L, d, H, hd) (MLA: ``attn.w_dkv``, ``ckv_norm``,
``w_uk``, ``w_uv``) and the other layer-stacked tensors, ``ffn.w_*``
(MoE: ``ffn.router`` and the (L, E, ...) expert stacks), ``ln1``,
``ln2``, ``ln_f``, so the flat names (``/``-joined) equal the JAX
``flatten_tree`` names and weights carry across both ways.  The
reference's ``scan`` over layers is a Python loop over layer ``i``; its
sharding hints have no meaning on one card and are dropped.  Under
``cfg.remat`` and grad mode, each layer of ``forward`` runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` with nothing saveable: a layer's
activations are recomputed in the backward.  MLA's decode cache holds the
compressed latent ``ckv`` (L, B, max_len, r) and the roped shared key
``krope`` (L, B, max_len, dr); each decode step expands the whole cache,
as the reference does.

Entry points:
    init(generator)                          redraw every parameter
    forward(tokens) / loss_fn(batch)         full-sequence logits / NLL
    prefill(tokens) -> (logits, cache)       last-token logits, full cache
    decode_step(tokens, cache)               one position, cache in place
    cache_specs(batch, max_len) / init_cache(batch, max_len)
    cache_batch_axes()                       each entry's batch axis

``decode_step`` writes the new position into ``cache`` in place and
returns it (the reference returns an updated copy): the cache is the
largest tensor of serving, and one copy of it is enough.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.shardctx import constrain


class DecoderLM(L.StackedLM):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self._hold(self._draw(resolve_device(device), generator))

    # ------------------------------------------------------------- params
    def _draw(self, device, generator) -> Dict:
        cfg = self.cfg
        pd = L.torch_dtype(cfg.param_dtype)
        n, d = cfg.n_layers, cfg.d_model
        init_attn = attn.init_mla if cfg.mla else attn.init_attention
        return {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "attn": init_attn(cfg, n, generator, device, pd),
            "ffn": (moe_mod.init_moe(cfg, n, generator, device, pd)
                    if cfg.moe else
                    L.init_mlp(n, d, cfg.d_ff, generator, device, pd)),
            "ln1": torch.zeros((n, d), dtype=pd, device=device),
            "ln2": torch.zeros((n, d), dtype=pd, device=device),
            "ln_f": torch.zeros((d,), dtype=pd, device=device),
        }

    def _spec_tree(self) -> Dict:
        cfg = self.cfg
        return {
            "embed": L.EMBED_SPECS,
            "attn": attn.MLA_SPECS if cfg.mla else attn.attention_specs(cfg),
            "ffn": moe_mod.moe_specs(cfg) if cfg.moe else L.MLP_SPECS,
            "ln1": ("stack", None),
            "ln2": ("stack", None),
            "ln_f": (None,),
        }

    def _layers(self):
        """Each layer's (attn, ffn, ln1, ln2) parameters, as views
        (:func:`layers.unbind_stack`)."""
        n = self.cfg.n_layers
        return list(zip(L.unbind_stack(self.attn, n),
                        L.unbind_stack(self.ffn, n), self.ln1.unbind(0),
                        self.ln2.unbind(0)))

    # ------------------------------------------------------------ forward
    def _ffn(self, pf, h):
        if self.cfg.moe:
            return moe_mod.moe_ffn(pf, h, self.cfg)
        return L.swiglu_mlp(pf, h)

    def _block(self, layer, x, positions, skip_masked_chunks: bool):
        """One layer (its ``_layers()`` entry) over a whole sequence;
        returns (x, cache entries): (k, v), or MLA's (c_kv, k_rope)."""
        cfg = self.cfg
        pa, pf, ln1, ln2 = layer
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        if cfg.mla:
            q, c_kv, k_rope = attn.mla_project(pa, h, cfg, positions)
            k, v = attn.mla_expand_kv(pa, c_kv, k_rope, h.dtype)
            cached = (c_kv, k_rope)
        else:
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            cached = (k, v)
        o = attn.flash_attention(q, k, v, causal=True, window=cfg.local_window,
                                 skip_masked_chunks=skip_masked_chunks)
        x = x + L.contract(o, pa["wo"], 2)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return x + self._ffn(pf, h), cached

    def _layer(self, x, positions, layer):
        """One layer of the training forward (no masked-chunk skip)."""
        x = self._block(layer, x, positions, skip_masked_chunks=False)[0]
        return constrain(x, ("batch", None, None))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_tokens(self.embed, tokens, self._compute_dtype())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self._layers():
            if remat:
                x = checkpoint(self._layer, x, positions, layer,
                               use_reentrant=False)
            else:
                x = self._layer(x, positions, layer)
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return L.unembed(self.embed, x)

    def loss_fn(self, batch: Dict) -> torch.Tensor:
        logits = self.forward(batch["tokens"])
        return L.softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("mask"))

    # ------------------------------------------------------------ serving
    def _cache_names(self) -> Tuple[str, str]:
        return ("ckv", "krope") if self.cfg.mla else ("k", "v")

    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each cache entry but ``len``: (L, B, S, ...)."""
        return {name: 1 for name in self._cache_names()}

    def cache_logical_specs(self) -> Dict:
        """Each cache entry's logical axes."""
        if self.cfg.mla:
            return {"ckv": ("stack", "batch", "seq", None),
                    "krope": ("stack", "batch", "seq", None), "len": ()}
        return {"k": ("stack", "batch", "seq", "kv_heads", None),
                "v": ("stack", "batch", "seq", "kv_heads", None), "len": ()}

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        cd = self._compute_dtype()
        if cfg.mla:
            lead = (cfg.n_layers, batch, max_len)
            return {"ckv": (lead + (cfg.kv_lora_rank,), cd),
                    "krope": (lead + (cfg.rope_head_dim,), cd),
                    "len": ((), torch.int32)}
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": (shape, cd), "v": (shape, cd), "len": ((), torch.int32)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward over the prompt; returns (last-token logits (B, 1, V),
        cache with k / v of shape (L, B, S, Hkv, hd) — MLA: ckv (L, B, S,
        r) and krope (L, B, S, dr) — and ``len`` S)."""
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        entries = ([], [])
        for layer in self._layers():
            # inference: no grad, so the key loop skips masked chunks
            x, cached = self._block(layer, x, positions,
                                    skip_masked_chunks=True)
            for out, t in zip(entries, cached):
                out.append(t)
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        cache = {name: torch.stack(ts)
                 for name, ts in zip(self._cache_names(), entries)}
        cache["len"] = s
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); appends one position to ``cache`` (in place)."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = int(cache["len"])
        x = self._embed(tokens)
        positions = torch.full((b, 1), pos, device=tokens.device)
        names = self._cache_names()
        for i, (pa, pf, ln1, ln2) in enumerate(self._layers()):
            h = L.rmsnorm(x, ln1, cfg.norm_eps)
            if cfg.mla:
                q, *new = attn.mla_project(pa, h, cfg, positions)
            else:
                q, *new = attn.qkv_project(pa, h, cfg, positions)
            layer_cache = [cache[name][i] for name in names]
            for c, t in zip(layer_cache, new):
                L.write_position(c, pos, t[:, 0])
            if cfg.mla:  # the whole compressed cache, expanded
                k_c, v_c = attn.mla_expand_kv(pa, *layer_cache, h.dtype)
            else:
                k_c, v_c = layer_cache
            o = attn.decode_attention(q, k_c, v_c, pos + 1,
                                      window=cfg.local_window)
            x = x + L.contract(o, pa["wo"], 2)
            h = L.rmsnorm(x, ln2, cfg.norm_eps)
            x = x + self._ffn(pf, h)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = pos + 1
        return L.unembed(self.embed, x), cache
