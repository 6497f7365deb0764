"""Vision-language decoder (llama-3.2-vision family backbone) — the JAX
package's ``models/vlm.py`` in torch.

The modality frontend is a stub, as in the reference: the caller
provides precomputed patch embeddings (B, vision_tokens, d_model).  The
language backbone is a decoder-only transformer run as super-blocks:
each opens with a tanh-gated cross-attention sub-layer over the vision
context (llama-vision ordering), then runs ``cross_attn_every``
self-attention layers.  That is what the reference's code runs; its
docstring's "(every - 1) self layers + 1 cross+self layer" does not
describe it, and its ``n_self`` is never used.  The cross-attention runs
:func:`attention.flash_attention` with ``causal=False`` over the vision
tokens (Sq ≠ Sk; on the card the Hopper kernels at head dim 128, GQA
64 / 8 for llama-3.2-vision-90b).

Parameters are stacked as the reference stacks them, so the flat names
and shapes equal the JAX ``flatten_tree``'s: ``attn`` / ``mlp`` (n_super,
cross_attn_every, ...), ``xattn`` (n_super, ...), ``ln1`` / ``ln2``
(n_super, cross_attn_every, d), ``ln_x`` (n_super, d), ``ln_f``,
``embed``.

Decode caches, with the reference's layouts: ``k`` / ``v`` (n_super,
cross_attn_every, B, max_len, Hkv, hd), the batch on axis 2; the vision
``xk`` / ``xv`` (n_super, B, vision_tokens, Hkv, hd), computed once at
prefill, the batch on axis 1 (:meth:`VisionLM.cache_batch_axes`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.shardctx import constrain


class VisionLM(L.StackedLM):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.cross_attn_every <= 1 or cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must be a "
                             f"multiple of cross_attn_every "
                             f"{cfg.cross_attn_every} > 1")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.cross_attn_every
        self._hold(self._draw(resolve_device(device), generator))

    # ------------------------------------------------------------- params
    def _draw(self, device, generator) -> Dict:
        cfg = self.cfg
        pd = L.torch_dtype(cfg.param_dtype)
        d, ns, ce = cfg.d_model, self.n_super, cfg.cross_attn_every
        att = attn.init_attention(cfg, ns * ce, generator, device, pd)
        mlp = L.init_mlp(ns * ce, d, cfg.d_ff, generator, device, pd)
        return {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "attn": {k: v.reshape(ns, ce, *v.shape[1:])
                     for k, v in att.items()},
            "xattn": attn.init_cross_attention(cfg, ns, generator, device,
                                               pd),
            "mlp": {k: v.reshape(ns, ce, *v.shape[1:])
                    for k, v in mlp.items()},
            "ln1": torch.zeros((ns, ce, d), dtype=pd, device=device),
            "ln2": torch.zeros((ns, ce, d), dtype=pd, device=device),
            "ln_x": torch.zeros((ns, d), dtype=pd, device=device),
            "ln_f": torch.zeros((d,), dtype=pd, device=device),
        }

    def _spec_tree(self) -> Dict:
        return {
            "embed": L.EMBED_SPECS,
            "attn": L.stacked_twice(attn.attention_specs(self.cfg)),
            "xattn": attn.CROSS_SPECS,
            "mlp": L.stacked_twice(L.MLP_SPECS),
            "ln1": ("stack", None, None), "ln2": ("stack", None, None),
            "ln_x": ("stack", None), "ln_f": (None,),
        }

    def _supers(self):
        """Each super-block's (attn, xattn, mlp, ln1, ln2, ln_x); attn /
        mlp / ln1 / ln2 still stacked over its cross_attn_every layers."""
        ns = self.n_super
        return list(zip(L.unbind_stack(self.attn, ns),
                        L.unbind_stack(self.xattn, ns),
                        L.unbind_stack(self.mlp, ns), self.ln1.unbind(0),
                        self.ln2.unbind(0), self.ln_x.unbind(0)))

    # ------------------------------------------------------------ forward
    def _self_layer(self, pa, ln1, ln2, pm, x, positions, skip_chunks=False):
        """One self-attention layer over a whole sequence; returns (x, (k,
        v))."""
        cfg = self.cfg
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        q, k, v = attn.qkv_project(pa, h, cfg, positions)
        o = attn.flash_attention(q, k, v, causal=True,
                                 skip_masked_chunks=skip_chunks)
        x = x + L.contract(o, pa["wo"], 2)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return x + L.swiglu_mlp(pm, h), (k, v)

    def _super_block(self, x, positions, vision, block):
        pa, px, pm, ln1, ln2, ln_x = block
        # gated cross-attention sub-layer first (llama-vision ordering)
        h = L.rmsnorm(x, ln_x, self.cfg.norm_eps)
        x = x + attn.cross_attention(px, h, vision, self.cfg)
        for j in range(self.cfg.cross_attn_every):
            x, _ = self._self_layer({k: v[j] for k, v in pa.items()}, ln1[j],
                                    ln2[j], {k: v[j] for k, v in pm.items()},
                                    x, positions)
        return constrain(x, ("batch", None, None))

    def forward(self, tokens: torch.Tensor,
                vision: torch.Tensor) -> torch.Tensor:
        """tokens (B, S), vision (B, S_v, D) -> logits (B, S, V)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        vision = vision.to(self._compute_dtype())
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self._supers():
            if remat:
                x = checkpoint(self._super_block, x, positions, vision, block,
                               use_reentrant=False)
            else:
                x = self._super_block(x, positions, vision, block)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        return L.unembed(self.embed, x)

    def loss_fn(self, batch: Dict) -> torch.Tensor:
        logits = self.forward(batch["tokens"], batch["vision_embeds"])
        return L.softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("mask"))

    # ------------------------------------------------------------ serving
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        cd = self._compute_dtype()
        hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        kv = (self.n_super, cfg.cross_attn_every, batch, max_len, hkv, hd)
        xkv = (self.n_super, batch, cfg.vision_tokens, hkv, hd)
        return {"k": (kv, cd), "v": (kv, cd), "xk": (xkv, cd),
                "xv": (xkv, cd), "len": ((), torch.int32)}

    def cache_logical_specs(self) -> Dict:
        """Each cache entry's logical axes."""
        return {
            "k": ("stack", None, "batch", "seq", "kv_heads", None),
            "v": ("stack", None, "batch", "seq", "kv_heads", None),
            "xk": ("stack", "batch", "seq", "kv_heads", None),
            "xv": ("stack", "batch", "seq", "kv_heads", None),
            "len": (),
        }

    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each cache entry but ``len``."""
        return {"k": 2, "v": 2, "xk": 1, "xv": 1}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                vision: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward over the prompt; returns (last-token logits (B, 1, V),
        cache with k / v (n_super, ce, B, S, Hkv, hd), the vision xk / xv
        (n_super, B, S_v, Hkv, hd) and ``len`` S)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        vision = vision.to(self._compute_dtype())
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        entries = {"k": [], "v": [], "xk": [], "xv": []}
        for pa, px, pm, ln1, ln2, ln_x in self._supers():
            h = L.rmsnorm(x, ln_x, cfg.norm_eps)
            xk = L.contract(vision, px["wk"])
            xv = L.contract(vision, px["wv"])
            q = L.contract(h, px["wq"])
            o = attn.flash_attention(q, xk, xv, causal=False)
            o = L.contract(o, px["wo"], 2)
            x = x + torch.tanh(px["gate"]).to(x.dtype) * o
            ks, vs = [], []
            for j in range(cfg.cross_attn_every):
                x, (k, v) = self._self_layer(
                    {n: t[j] for n, t in pa.items()}, ln1[j], ln2[j],
                    {n: t[j] for n, t in pm.items()}, x, positions,
                    skip_chunks=True)
                ks.append(k)
                vs.append(v)
            for name, t in zip(entries, (torch.stack(ks), torch.stack(vs),
                                         xk, xv)):
                entries[name].append(t)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        cache = {name: torch.stack(ts) for name, ts in entries.items()}
        cache["len"] = s
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); appends one position to every self layer's k / v
        (in place) and attends over the cached vision k / v."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = int(cache["len"])
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = torch.full((b, 1), pos, device=tokens.device)
        for i, (pa, px, pm, ln1, ln2, ln_x) in enumerate(self._supers()):
            h = L.rmsnorm(x, ln_x, cfg.norm_eps)
            q = L.contract(h, px["wq"])
            xk = cache["xk"][i]
            o = attn.decode_attention(q, xk, cache["xv"][i], xk.shape[1])
            o = L.contract(o, px["wo"], 2)
            x = x + torch.tanh(px["gate"]).to(x.dtype) * o
            for j in range(cfg.cross_attn_every):
                pl = {n: t[j] for n, t in pa.items()}
                h = L.rmsnorm(x, ln1[j], cfg.norm_eps)
                q, k, v = attn.qkv_project(pl, h, cfg, positions)
                k_c, v_c = cache["k"][i, j], cache["v"][i, j]
                L.write_position(k_c, pos, k[:, 0])
                L.write_position(v_c, pos, v[:, 0])
                o = attn.decode_attention(q, k_c, v_c, pos + 1)
                x = x + L.contract(o, pl["wo"], 2)
                h = L.rmsnorm(x, ln2[j], cfg.norm_eps)
                x = x + L.swiglu_mlp({n: t[j] for n, t in pm.items()}, h)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = pos + 1
        return L.unembed(self.embed, x), cache
