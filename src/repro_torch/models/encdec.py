"""Encoder–decoder audio model (Whisper family backbone) — the JAX
package's ``models/encdec.py`` in torch.

The conv frontend is a stub, as in the reference: the caller provides
precomputed frame embeddings (B, encoder_seq, d_model).  Encoder layers
are bidirectional self-attention (with RoPE, as the reference's
``qkv_project``) + SwiGLU MLP; decoder layers are causal self-attention
+ tanh-gated cross-attention over the encoder output + MLP.  Every
attention runs :func:`attention.flash_attention`: the encoder and the
cross-attention with ``causal=False`` (Sq ≠ Sk for the cross), on the
card the Hopper kernels at head dim 64 (whisper-tiny).

The parameter tree is the reference's (``embed``, ``enc_attn``,
``enc_mlp``, ``enc_ln1`` / ``enc_ln2`` / ``enc_ln_f``, ``dec_attn``,
``dec_xattn``, ``dec_mlp``, ``dec_ln1`` / ``dec_lnx`` / ``dec_ln2``,
``ln_f``), so the flat names equal the JAX ``flatten_tree`` names.

Decode: the self k / v cache (L, B, max_len, Hkv, hd) grows a token a
step; the cross k / v ``xk`` / ``xv`` (L, B, encoder_seq, Hkv, hd) are
computed once at prefill.  ``prefill(tokens, audio_embeds)`` computes the
cross-attention inline, as the reference's prefill does, and
``forward`` through :func:`attention.cross_attention`.
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


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


class EncDecLM(L.StackedLM):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self._hold(self._draw(resolve_device(device), generator))

    # ------------------------------------------------------------- params
    def _draw(self, device, generator) -> Dict:
        cfg = self.cfg
        pd = L.torch_dtype(cfg.param_dtype)
        d, ne, nd = cfg.d_model, cfg.n_encoder_layers, cfg.n_layers

        def z(*shape):
            return torch.zeros(shape, dtype=pd, device=device)

        return {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "enc_attn": attn.init_attention(cfg, ne, generator, device, pd),
            "enc_mlp": L.init_mlp(ne, d, cfg.d_ff, generator, device, pd),
            "enc_ln1": z(ne, d), "enc_ln2": z(ne, d), "enc_ln_f": z(d),
            "dec_attn": attn.init_attention(cfg, nd, generator, device, pd),
            "dec_xattn": attn.init_cross_attention(cfg, nd, generator,
                                                   device, pd),
            "dec_mlp": L.init_mlp(nd, d, cfg.d_ff, generator, device, pd),
            "dec_ln1": z(nd, d), "dec_lnx": z(nd, d), "dec_ln2": z(nd, d),
            "ln_f": z(d),
        }

    def _spec_tree(self) -> Dict:
        attn_s = attn.attention_specs(self.cfg)
        return {
            "embed": L.EMBED_SPECS,
            "enc_attn": attn_s, "enc_mlp": L.MLP_SPECS,
            "enc_ln1": ("stack", None), "enc_ln2": ("stack", None),
            "enc_ln_f": (None,),
            "dec_attn": attn_s, "dec_xattn": attn.CROSS_SPECS,
            "dec_mlp": L.MLP_SPECS,
            "dec_ln1": ("stack", None), "dec_lnx": ("stack", None),
            "dec_ln2": ("stack", None), "ln_f": (None,),
        }

    def _enc_layers(self):
        ne = self.cfg.n_encoder_layers
        return list(zip(L.unbind_stack(self.enc_attn, ne),
                        L.unbind_stack(self.enc_mlp, ne),
                        self.enc_ln1.unbind(0), self.enc_ln2.unbind(0)))

    def _dec_layers(self):
        nd = self.cfg.n_layers
        return list(zip(L.unbind_stack(self.dec_attn, nd),
                        L.unbind_stack(self.dec_xattn, nd),
                        L.unbind_stack(self.dec_mlp, nd),
                        self.dec_ln1.unbind(0), self.dec_lnx.unbind(0),
                        self.dec_ln2.unbind(0)))

    def _maybe_remat(self, fn, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ------------------------------------------------------------- encoder
    def _enc_layer(self, x, positions, layer):
        cfg = self.cfg
        pa, pm, ln1, ln2 = layer
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        q, k, v = attn.qkv_project(pa, h, cfg, positions)
        o = attn.flash_attention(q, k, v, causal=False)
        x = x + L.contract(o, pa["wo"], 2)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return x + L.swiglu_mlp(pm, h)

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """audio_embeds (B, S_enc, D) — the stubbed conv frontend's output."""
        x = audio_embeds.to(self._compute_dtype())
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for layer in self._enc_layers():
            x = self._maybe_remat(self._enc_layer, x, positions, layer)
        return L.rmsnorm(x, self.enc_ln_f, self.cfg.norm_eps)

    # ------------------------------------------------------------- decoder
    def _dec_layer(self, x, positions, enc_out, layer):
        cfg = self.cfg
        pa, px, pm, ln1, lnx, ln2 = layer
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        q, k, v = attn.qkv_project(pa, h, cfg, positions)
        o = attn.flash_attention(q, k, v, causal=True)
        x = x + L.contract(o, pa["wo"], 2)
        h = L.rmsnorm(x, lnx, cfg.norm_eps)
        x = x + attn.cross_attention(px, h, enc_out, cfg)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return constrain(x + L.swiglu_mlp(pm, h), ("batch", None, None))

    def forward(self, tokens: torch.Tensor,
                audio_embeds: torch.Tensor) -> torch.Tensor:
        """tokens (B, S), audio_embeds (B, S_enc, D) -> logits (B, S, V)."""
        enc_out = self.encode(audio_embeds)
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = _positions(b, s, tokens.device)
        for layer in self._dec_layers():
            x = self._maybe_remat(self._dec_layer, x, positions, enc_out,
                                  layer)
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return L.unembed(self.embed, x)

    def loss_fn(self, batch: Dict) -> torch.Tensor:
        logits = self.forward(batch["tokens"], batch["audio_embeds"])
        return L.softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("mask"))

    # ------------------------------------------------------------ serving
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        cd = self._compute_dtype()
        hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        kv = (cfg.n_layers, batch, max_len, hkv, hd)
        xkv = (cfg.n_layers, batch, cfg.encoder_seq, hkv, hd)
        return {"k": (kv, cd), "v": (kv, cd), "xk": (xkv, cd),
                "xv": (xkv, cd), "len": ((), torch.int32)}

    def cache_logical_specs(self) -> Dict:
        """Each cache entry's logical axes."""
        kv = ("stack", "batch", "seq", "kv_heads", None)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv, "len": ()}

    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each cache entry but ``len``."""
        return {"k": 1, "v": 1, "xk": 1, "xv": 1}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                audio_embeds: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Encode, then the decoder over the prompt; returns (last-token
        logits (B, 1, V), cache with k / v (L, B, S, Hkv, hd), the cross
        xk / xv (L, B, S_enc, Hkv, hd) and ``len`` S)."""
        cfg = self.cfg
        enc_out = self.encode(audio_embeds)
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = _positions(b, s, tokens.device)
        entries = {"k": [], "v": [], "xk": [], "xv": []}
        for pa, px, pm, ln1, lnx, ln2 in self._dec_layers():
            h = L.rmsnorm(x, ln1, cfg.norm_eps)
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            o = attn.flash_attention(q, k, v, causal=True,
                                     skip_masked_chunks=True)
            x = x + L.contract(o, pa["wo"], 2)
            h = L.rmsnorm(x, lnx, cfg.norm_eps)
            xk = L.contract(enc_out, px["wk"])
            xv = L.contract(enc_out, px["wv"])
            q2 = L.contract(h, px["wq"])
            o = attn.flash_attention(q2, xk, xv, causal=False)
            o = L.contract(o, px["wo"], 2)
            x = x + torch.tanh(px["gate"]).to(x.dtype) * o
            h = L.rmsnorm(x, ln2, cfg.norm_eps)
            x = x + L.swiglu_mlp(pm, h)
            for name, t in zip(entries, (k, v, xk, xv)):
                entries[name].append(t)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        cache = {name: torch.stack(ts) for name, ts in entries.items()}
        cache["len"] = s
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); appends one position to the self k / v cache (in
        place) and attends over the cached cross k / v."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = int(cache["len"])
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = torch.full((b, 1), pos, device=tokens.device)
        for i, (pa, px, pm, ln1, lnx, ln2) in enumerate(self._dec_layers()):
            h = L.rmsnorm(x, ln1, cfg.norm_eps)
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            k_c, v_c = cache["k"][i], cache["v"][i]
            L.write_position(k_c, pos, k[:, 0])
            L.write_position(v_c, pos, v[:, 0])
            o = attn.decode_attention(q, k_c, v_c, pos + 1)
            x = x + L.contract(o, pa["wo"], 2)
            h = L.rmsnorm(x, lnx, cfg.norm_eps)
            q2 = L.contract(h, px["wq"])
            xk = cache["xk"][i]
            o = attn.decode_attention(q2, xk, cache["xv"][i], xk.shape[1])
            o = L.contract(o, px["wo"], 2)
            x = x + torch.tanh(px["gate"]).to(x.dtype) * o
            h = L.rmsnorm(x, ln2, cfg.norm_eps)
            x = x + L.swiglu_mlp(pm, h)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = pos + 1
        return L.unembed(self.embed, x), cache
