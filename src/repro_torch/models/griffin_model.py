"""Griffin / RecurrentGemma hybrid LM: RG-LRU + local attention, 1:2 — the
JAX package's ``models/griffin_model.py`` in torch.

Layer pattern repeats (recurrent, recurrent, local-attention); every
layer is followed by a SwiGLU MLP.  Super-blocks of 3 layers (n_layers
// 3 groups; the reference's ``lax.scan``, here a Python loop) are
followed by the remainder layers (38 % 3 = 2 for the 9B config), which
run with their own parameters.

The parameter tree is the reference's, so the flat names (``/``-joined)
equal the JAX ``flatten_tree`` names: ``embed.embedding``, ``rec`` of
shape (n_super, 2, ...), ``attn`` (n_super, ...), ``mlp`` (n_super, 3,
...), ``ln_t`` / ``ln_c`` (n_super, 3, d), ``ln_f`` and, where n_layers
% 3, ``rest_rec``, ``rest_mlp``, ``rest_ln_t``, ``rest_ln_c``.  The MLP
stack is drawn for the n_super * 3 layers it keeps (the reference draws
n_layers and drops the tail; the draws differ from ``jax.random``'s
anyway).  The attention layers run :func:`attention.flash_attention` with
``window=cfg.local_window``: on the card the Hopper kernel at head dims
(256, 256) (RecurrentGemma-9B), on the CPU its plain version.  With grad
on the card hd 256 raises (no backward kernel there yet), so this family
trains on the CPU only at its published head dim.

Decode caches: per-rec-layer LRU state ``h`` (float32) and conv tail
``conv``, per-attn-layer a *windowed* KV ring ``k`` / ``v`` of
min(local_window, max_len) entries (position p in slot p % win).
``decode_step`` writes them in place and returns the cache, as
``DecoderLM`` does.  :meth:`GriffinLM.cache_batch_axes` names each
entry's batch axis for the engine's splice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import rglru
from repro_torch.models.shardctx import constrain


class GriffinLM(L.StackedLM):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.n_super = cfg.n_layers // 3
        self.n_rest = cfg.n_layers % 3  # trailing recurrent layers
        self._hold(self._draw(resolve_device(device), generator))

    # ------------------------------------------------------------- params
    def _draw(self, device, generator) -> Dict:
        cfg = self.cfg
        pd = L.torch_dtype(cfg.param_dtype)
        d, ns = cfg.d_model, self.n_super
        # two rec layers per super-block, stacked (n_super, 2, ...)
        rec = rglru.init_rglru_block(cfg, ns * 2, generator, device, pd)
        mlp = L.init_mlp(ns * 3, d, cfg.d_ff, generator, device, pd)
        tree = {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "rec": {k: v.reshape(ns, 2, *v.shape[1:]) for k, v in rec.items()},
            "attn": attn.init_attention(cfg, ns, generator, device, pd),
            "mlp": {k: v.reshape(ns, 3, *v.shape[1:]) for k, v in mlp.items()},
            "ln_t": torch.zeros((ns, 3, d), dtype=pd, device=device),
            "ln_c": torch.zeros((ns, 3, d), dtype=pd, device=device),
            "ln_f": torch.zeros((d,), dtype=pd, device=device),
        }
        if self.n_rest:
            nr = self.n_rest
            tree["rest_rec"] = rglru.init_rglru_block(cfg, nr, generator,
                                                      device, pd)
            tree["rest_mlp"] = L.init_mlp(nr, d, cfg.d_ff, generator, device,
                                          pd)
            tree["rest_ln_t"] = torch.zeros((nr, d), dtype=pd, device=device)
            tree["rest_ln_c"] = torch.zeros((nr, d), dtype=pd, device=device)
        return tree

    def _spec_tree(self) -> Dict:
        tree = {
            "embed": L.EMBED_SPECS,
            "rec": L.stacked_twice(rglru.RGLRU_SPECS),
            "attn": attn.attention_specs(self.cfg),
            "mlp": L.stacked_twice(L.MLP_SPECS),
            "ln_t": ("stack", None, None),
            "ln_c": ("stack", None, None),
            "ln_f": (None,),
        }
        if self.n_rest:
            tree.update(rest_rec=rglru.RGLRU_SPECS, rest_mlp=L.MLP_SPECS,
                        rest_ln_t=("stack", None), rest_ln_c=("stack", None))
        return tree

    def _supers(self):
        """Each super-block's parameters: (rec, attn, mlp, ln_t, ln_c),
        rec / mlp / ln_* still stacked over the block's 2 / 3 layers."""
        ns = self.n_super
        return list(zip(L.unbind_stack(self.rec, ns),
                        L.unbind_stack(self.attn, ns),
                        L.unbind_stack(self.mlp, ns), self.ln_t.unbind(0),
                        self.ln_c.unbind(0)))

    def _rests(self):
        """Each rest layer's (rec, mlp, ln_t, ln_c)."""
        nr = self.n_rest
        if not nr:
            return []
        return list(zip(L.unbind_stack(self.rest_rec, nr),
                        L.unbind_stack(self.rest_mlp, nr),
                        self.rest_ln_t.unbind(0), self.rest_ln_c.unbind(0)))

    # ------------------------------------------------------------ forward
    def _rec_layer(self, pl_rec, ln_t, ln_c, pl_mlp, x):
        cfg = self.cfg
        h = L.rmsnorm(x, ln_t, cfg.norm_eps)
        x = x + rglru.rglru_block(pl_rec, h, cfg)
        h = L.rmsnorm(x, ln_c, cfg.norm_eps)
        return x + L.swiglu_mlp(pl_mlp, h)

    def _attn_layer(self, pl_attn, ln_t, ln_c, pl_mlp, x, positions):
        cfg = self.cfg
        h = L.rmsnorm(x, ln_t, cfg.norm_eps)
        q, k, v = attn.qkv_project(pl_attn, h, cfg, positions)
        o = attn.flash_attention(q, k, v, causal=True, window=cfg.local_window)
        o = L.contract(o, pl_attn["wo"], 2)
        x = x + o
        h = L.rmsnorm(x, ln_c, cfg.norm_eps)
        return x + L.swiglu_mlp(pl_mlp, h)

    def _super_block(self, x, positions, block):
        pr, pa, pm, ln_t, ln_c = block
        for j in (0, 1):  # two recurrent layers
            x = self._rec_layer({k: v[j] for k, v in pr.items()}, ln_t[j],
                                ln_c[j], {k: v[j] for k, v in pm.items()}, x)
        x = self._attn_layer(pa, ln_t[2], ln_c[2],
                             {k: v[2] for k, v in pm.items()}, x, positions)
        return constrain(x, ("batch", None, None))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self._supers():
            if remat:
                x = checkpoint(self._super_block, x, positions, block,
                               use_reentrant=False)
            else:
                x = self._super_block(x, positions, block)
        for pr, pm, ln_t, ln_c in self._rests():
            x = self._rec_layer(pr, ln_t, ln_c, pm, x)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        return L.unembed(self.embed, x)

    def loss_fn(self, batch: Dict) -> torch.Tensor:
        logits = self.forward(batch["tokens"])
        return L.softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("mask"))

    # ------------------------------------------------------------ serving
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        cd = self._compute_dtype()
        w = cfg.rglru_width or cfg.d_model
        hd = cfg.resolved_head_dim
        win = min(cfg.local_window, max_len)
        km1 = cfg.conv_kernel - 1
        kv = (self.n_super, batch, win, cfg.n_kv_heads, hd)
        spec = {
            "h": ((self.n_super, 2, batch, w), torch.float32),
            "conv": ((self.n_super, 2, batch, km1, w), cd),
            "k": (kv, cd),
            "v": (kv, cd),
            "len": ((), torch.int32),
        }
        if self.n_rest:
            spec["rest_h"] = ((self.n_rest, batch, w), torch.float32)
            spec["rest_conv"] = ((self.n_rest, batch, km1, w), cd)
        return spec

    def cache_logical_specs(self) -> Dict:
        """Each cache entry's logical axes."""
        spec = {
            "h": ("stack", None, "batch", "mlp"),
            "conv": ("stack", None, "batch", None, "mlp"),
            "k": ("stack", "batch", "seq", "kv_heads", None),
            "v": ("stack", "batch", "seq", "kv_heads", None),
            "len": (),
        }
        if self.n_rest:
            spec["rest_h"] = ("stack", "batch", "mlp")
            spec["rest_conv"] = ("stack", "batch", None, "mlp")
        return spec

    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each cache entry but ``len``."""
        axes = {"h": 2, "conv": 2, "k": 1, "v": 1}
        if self.n_rest:
            axes.update(rest_h=1, rest_conv=1)
        return axes

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """One token; LRU states update in O(1), attention KV is a ring
        buffer of local_window entries (position pos % window).  Writes
        the new states into ``cache`` in place."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = int(cache["len"])
        win = cache["k"].shape[2]
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = torch.full((b, 1), pos, device=tokens.device)
        slot = pos % win
        for i, (pr, pa, pm, ln_t, ln_c) in enumerate(self._supers()):
            for j in (0, 1):
                h = L.rmsnorm(x, ln_t[j], cfg.norm_eps)
                state = {"h": cache["h"][i, j], "conv": cache["conv"][i, j]}
                out, ns = rglru.rglru_decode_step(
                    {k: v[j] for k, v in pr.items()}, h, state, cfg)
                x = x + out
                h = L.rmsnorm(x, ln_c[j], cfg.norm_eps)
                x = x + L.swiglu_mlp({k: v[j] for k, v in pm.items()}, h)
                cache["h"][i, j] = ns["h"]
                cache["conv"][i, j] = ns["conv"]
            # local attention layer with ring-buffer cache
            h = L.rmsnorm(x, ln_t[2], cfg.norm_eps)
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            k_c, v_c = cache["k"][i], cache["v"][i]
            L.write_position(k_c, slot, k[:, 0])
            L.write_position(v_c, slot, v[:, 0])
            # ring buffer holds the last min(pos+1, win) tokens — all valid
            o = attn.decode_attention(q, k_c, v_c, min(pos + 1, win),
                                      window=0)
            x = x + L.contract(o, pa["wo"], 2)
            h = L.rmsnorm(x, ln_c[2], cfg.norm_eps)
            x = x + L.swiglu_mlp({k: v[2] for k, v in pm.items()}, h)

        for i, (pr, pm, ln_t, ln_c) in enumerate(self._rests()):
            h = L.rmsnorm(x, ln_t, cfg.norm_eps)
            state = {"h": cache["rest_h"][i], "conv": cache["rest_conv"][i]}
            out, ns = rglru.rglru_decode_step(pr, h, state, cfg)
            x = x + out
            h = L.rmsnorm(x, ln_c, cfg.norm_eps)
            x = x + L.swiglu_mlp(pm, h)
            cache["rest_h"][i] = ns["h"]
            cache["rest_conv"][i] = ns["conv"]

        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = pos + 1
        return L.unembed(self.embed, x), cache

    def _lru(self, pr, h):
        """The LRU branch of one recurrent layer over the prompt: the scan
        (B, S, W) float32 and the conv tail (B, K-1, W) of the branch's
        projection, before the conv."""
        k = self.cfg.conv_kernel
        u = L.contract(h, pr["w_rec_branch"])
        conv_tail = u[:, -(k - 1):, :]
        a, gated = rglru._gates(pr, rglru.causal_conv(pr, u, k))
        return rglru.rglru_scan(a, gated), conv_tail

    def _rec_prefill(self, pr, h):
        """One recurrent layer's block over the prompt, as the reference's
        prefill runs it: (output (B, S, D), final LRU state (B, W)
        float32, conv tail)."""
        gate = F.gelu(
            L.contract(h, pr["w_gate_branch"]),
            approximate="tanh")
        hh, conv_tail = self._lru(pr, h)
        out = L.contract(hh.to(h.dtype) * gate, pr["w_out"])
        return out, hh[:, -1], conv_tail

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Forward over the prompt; returns (last-token logits (B, 1, V),
        cache with the LRU states from the scan's last element, the conv
        tails, the k / v rings of min(local_window, S) entries rolled so
        that position p sits in slot p % win, and ``len`` S)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        win = min(cfg.local_window, s)
        # ring-buffer layout: token at absolute position p lives in slot
        # p % win (decode inserts at pos % win), so roll the tail
        shift = (s - win) % win
        entries = {"h": [], "conv": [], "k": [], "v": []}
        for pr, pa, pm, ln_t, ln_c in self._supers():
            new_h, new_conv = [], []
            for j in (0, 1):
                h = L.rmsnorm(x, ln_t[j], cfg.norm_eps)
                out, hl, tail = self._rec_prefill(
                    {k: v[j] for k, v in pr.items()}, h)
                new_h.append(hl)
                new_conv.append(tail)
                x = x + out
                h = L.rmsnorm(x, ln_c[j], cfg.norm_eps)
                x = x + L.swiglu_mlp({k: v[j] for k, v in pm.items()}, h)
            h = L.rmsnorm(x, ln_t[2], cfg.norm_eps)
            q, k, v = attn.qkv_project(pa, h, cfg, positions)
            # inference: no grad, so the key loop skips masked chunks
            o = attn.flash_attention(q, k, v, causal=True,
                                     window=cfg.local_window,
                                     skip_masked_chunks=True)
            x = x + L.contract(o, pa["wo"], 2)
            h = L.rmsnorm(x, ln_c[2], cfg.norm_eps)
            x = x + L.swiglu_mlp({k: v[2] for k, v in pm.items()}, h)
            entries["h"].append(torch.stack(new_h))
            entries["conv"].append(torch.stack(new_conv))
            entries["k"].append(torch.roll(k[:, -win:], shift, dims=1))
            entries["v"].append(torch.roll(v[:, -win:], shift, dims=1))
        cache = {name: torch.stack(ts) for name, ts in entries.items()}

        rh, rc = [], []
        for pr, pm, ln_t, ln_c in self._rests():
            h = L.rmsnorm(x, ln_t, cfg.norm_eps)
            out = rglru.rglru_block(pr, h, cfg)
            # final LRU state via one extra gated pass, as the reference
            hh, tail = self._lru(pr, h)
            rh.append(hh[:, -1])
            rc.append(tail)
            x = x + out
            h = L.rmsnorm(x, ln_c, cfg.norm_eps)
            x = x + L.swiglu_mlp(pm, h)
        if rh:
            cache["rest_h"] = torch.stack(rh)
            cache["rest_conv"] = torch.stack(rc)

        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        cache["len"] = s
        return logits, cache
