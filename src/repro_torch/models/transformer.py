"""Decoder-only transformer LM, dense GQA family — the JAX package's
``models/transformer.py`` in torch.

Covers qwen2 (QKV bias), granite, starcoder2 and qwen3 (qk-norm).  The
parameter tree is the reference's: ``embed.embedding``, ``attn.wq`` of
shape (L, d, H, hd) and the other layer-stacked tensors, ``ffn.w_*``,
``ln1``, ``ln2``, ``ln_f``, so the flat names (``/``-joined) equal the
JAX ``flatten_tree`` names and weights carry across both ways.  The
reference's ``scan`` over layers is a Python loop over layer ``i``; its
sharding hints have no meaning on one card and are dropped.  Under
``cfg.remat`` and grad mode, each layer of ``forward`` runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` with nothing saveable: a layer's
activations are recomputed in the backward.  MoE and MLA raise "not
ported yet".

Entry points:
    init(generator)                          redraw every parameter
    forward(tokens) / loss_fn(batch)         full-sequence logits / NLL
    prefill(tokens) -> (logits, cache)       last-token logits, full cache
    decode_step(tokens, cache)               one position, cache in place
    cache_specs(batch, max_len) / init_cache(batch, max_len)

``decode_step`` writes the new position into ``cache`` in place and
returns it (the reference returns an updated copy): the cache is the
largest tensor of serving, and one copy of it is enough.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.moe:
            raise NotImplementedError(f"{cfg.name}: MoE is not ported yet")
        if cfg.mla:
            raise NotImplementedError(f"{cfg.name}: MLA is not ported yet")
        self.cfg = cfg
        tree = self._draw(resolve_device(device), generator)
        self.embed = nn.ParameterDict(tree["embed"])
        self.attn = nn.ParameterDict(tree["attn"])
        self.ffn = nn.ParameterDict(tree["ffn"])
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.ln_f = nn.Parameter(tree["ln_f"])

    # ------------------------------------------------------------- params
    def _draw(self, device, generator) -> Dict:
        cfg = self.cfg
        pd = L.torch_dtype(cfg.param_dtype)
        n, d = cfg.n_layers, cfg.d_model
        return {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "attn": attn.init_attention(cfg, n, generator, device, pd),
            "ffn": L.init_mlp(n, d, cfg.d_ff, generator, device, pd),
            "ln1": torch.zeros((n, d), dtype=pd, device=device),
            "ln2": torch.zeros((n, d), dtype=pd, device=device),
            "ln_f": torch.zeros((d,), dtype=pd, device=device),
        }

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "DecoderLM":
        """Redraw every parameter from ``generator``, in place."""
        tree = self._draw(self.device, generator)
        for name, p in self.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            p.copy_(node)
        return self

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _layers(self):
        """Each layer's (attn, ffn, ln1, ln2) parameters, as views from one
        ``unbind`` per layer-stacked tensor: autograd stacks the layers'
        gradients once, where indexing ``v[i]`` per layer would add a
        full-size, zero-filled gradient per layer (L² traffic)."""
        attn_l = {k: v.unbind(0) for k, v in self.attn.items()}
        ffn_l = {k: v.unbind(0) for k, v in self.ffn.items()}
        ln1, ln2 = self.ln1.unbind(0), self.ln2.unbind(0)
        return [({k: t[i] for k, t in attn_l.items()},
                 {k: t[i] for k, t in ffn_l.items()}, ln1[i], ln2[i])
                for i in range(self.cfg.n_layers)]

    # ------------------------------------------------------------ forward
    def _block(self, layer, x, positions, skip_masked_chunks: bool):
        """One layer (its ``_layers()`` entry) over a whole sequence;
        returns (x, (k, v))."""
        cfg = self.cfg
        pa, pf, ln1, ln2 = layer
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        q, k, v = attn.qkv_project(pa, h, cfg, positions)
        o = attn.flash_attention(q, k, v, causal=True, window=cfg.local_window,
                                 skip_masked_chunks=skip_masked_chunks)
        x = x + torch.einsum("bshk,hkd->bsd", o, pa["wo"].to(x.dtype))
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return x + L.swiglu_mlp(pf, h), (k, v)

    def _layer(self, x, positions, layer):
        """One layer of the training forward (no masked-chunk skip)."""
        return self._block(layer, x, positions, skip_masked_chunks=False)[0]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_tokens(self.embed, tokens,
                              L.torch_dtype(self.cfg.compute_dtype))

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
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        cd = L.torch_dtype(cfg.compute_dtype)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": (shape, cd), "v": (shape, cd), "len": ((), torch.int32)}

    def init_cache(self, batch: int, max_len: int) -> Dict:
        cache = {name: torch.zeros(shape, dtype=dt, device=self.device)
                 for name, (shape, dt) in self.cache_specs(batch, max_len).items()
                 if name != "len"}
        cache["len"] = 0
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward over the prompt; returns (last-token logits (B, 1, V),
        cache with k / v of shape (L, B, S, Hkv, hd) and ``len`` S)."""
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        ks, vs = [], []
        for layer in self._layers():
            # inference: no grad, so the key loop skips masked chunks
            x, (k, v) = self._block(layer, x, positions, skip_masked_chunks=True)
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "len": s}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); appends one position to ``cache`` (in place)."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = int(cache["len"])
        x = self._embed(tokens)
        positions = torch.full((b, 1), pos, device=tokens.device)
        for i, (pa, pf, ln1, ln2) in enumerate(self._layers()):
            h = L.rmsnorm(x, ln1, cfg.norm_eps)
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            k_c, v_c = cache["k"][i], cache["v"][i]
            k_c[:, pos] = k[:, 0].to(k_c.dtype)
            v_c[:, pos] = v[:, 0].to(v_c.dtype)
            o = attn.decode_attention(q, k_c, v_c, pos + 1,
                                      window=cfg.local_window)
            x = x + torch.einsum("bshk,hkd->bsd", o, pa["wo"].to(x.dtype))
            h = L.rmsnorm(x, ln2, cfg.norm_eps)
            x = x + L.swiglu_mlp(pf, h)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = pos + 1
        return L.unembed(self.embed, x), cache
