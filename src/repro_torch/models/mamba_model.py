"""Mamba-2 language model (attention-free SSM family) — the JAX package's
``models/mamba_model.py`` in torch.

A uniform stack of [pre-norm -> SSD mixer -> residual] layers (Mamba has
no separate FFN; the mixer's expand factor carries the capacity).  The
parameter tree is the reference's, so the flat names (``/``-joined)
equal the JAX ``flatten_tree`` names: ``embed/embedding``, ``mixer/*``
stacked over layers (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
``D``, ``dt_bias``, ``out_norm``, ``out_proj``), ``ln`` and ``ln_f``.
The reference's ``scan`` over layers is a Python loop; under
``cfg.remat`` and grad mode each layer runs under
``torch.utils.checkpoint``.

Decode carries an O(1) state cache, no KV cache: ``s`` (L, B, H, P, N)
float32 and the conv history ``conv`` (L, B, K-1, C), both with the
batch on axis 1 (:meth:`Mamba2LM.cache_batch_axes`).  ``decode_step``
writes them in place and returns the cache, as ``DecoderLM`` does.
A prompt shorter than K - 1 tokens gets its conv history left-padded
with zeros (:func:`ssm.conv_tail`), where the reference keeps a shorter
history its decode step cannot use.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.shardctx import constrain


class Mamba2LM(L.StackedLM):
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
        return {
            "embed": L.init_embed(cfg.vocab_size, d, generator, device, pd),
            "mixer": ssm.init_ssm(cfg, n, generator, device, pd),
            "ln": torch.zeros((n, d), dtype=pd, device=device),
            "ln_f": torch.zeros((d,), dtype=pd, device=device),
        }

    def _spec_tree(self) -> Dict:
        return {"embed": L.EMBED_SPECS, "mixer": ssm.SSM_SPECS,
                "ln": ("stack", None), "ln_f": (None,)}

    def _layers(self):
        """Each layer's (mixer, ln) parameters, as views
        (:func:`layers.unbind_stack`)."""
        return list(zip(L.unbind_stack(self.mixer, self.cfg.n_layers),
                        self.ln.unbind(0)))

    # ------------------------------------------------------------ forward
    def _layer(self, x, layer):
        pm, ln = layer
        h = L.rmsnorm(x, ln, self.cfg.norm_eps)
        return constrain(x + ssm.ssm_block(pm, h, self.cfg),
                         ("batch", None, None))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self._layers():
            if remat:
                x = checkpoint(self._layer, x, layer, use_reentrant=False)
            else:
                x = self._layer(x, layer)
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return L.unembed(self.embed, x)

    def loss_fn(self, batch: Dict) -> torch.Tensor:
        logits = self.forward(batch["tokens"])
        return L.softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("mask"))

    # ------------------------------------------------------------ serving
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """name -> (shape, dtype); the state cache is O(1) in max_len."""
        cfg = self.cfg
        d_in, h, n = ssm.ssm_dims(cfg)
        # float32, as the SSD's math (float64 where the compute dtype is)
        state = torch.promote_types(self._compute_dtype(), torch.float32)
        return {
            "s": ((cfg.n_layers, batch, h, cfg.ssm_head_dim, n), state),
            "conv": ((cfg.n_layers, batch, cfg.conv_kernel - 1, d_in + 2 * n),
                     self._compute_dtype()),
            "len": ((), torch.int32),
        }

    def cache_logical_specs(self) -> Dict:
        """Each cache entry's logical axes."""
        return {"s": ("stack", "batch", "heads", None, None),
                "conv": ("stack", "batch", None, "mlp"), "len": ()}

    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each cache entry but ``len``."""
        return {"s": 1, "conv": 1}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Chunked SSD over the prompt; returns (last-token logits (B, 1,
        V), cache with each layer's final state ``s``, its conv history
        ``conv`` and ``len`` S)."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        states, tails = [], []
        for pm, ln in self._layers():
            h = L.rmsnorm(x, ln, cfg.norm_eps)
            out, s_fin, xbc = ssm.ssm_mixer(pm, h, cfg)
            states.append(s_fin)
            tails.append(ssm.conv_tail(xbc, cfg.conv_kernel))
            x = x + out
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:])
        return logits, {"s": torch.stack(states), "conv": torch.stack(tails),
                        "len": s}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); advances every layer's state (in place)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, self._compute_dtype())
        for i, (pm, ln) in enumerate(self._layers()):
            h = L.rmsnorm(x, ln, cfg.norm_eps)
            state = {"s": cache["s"][i], "conv": cache["conv"][i]}
            out, new = ssm.ssm_decode_step(pm, h, state, cfg)
            cache["s"][i] = new["s"]
            cache["conv"][i] = new["conv"].to(cache["conv"].dtype)
            x = x + out
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        cache["len"] = int(cache["len"]) + 1
        return L.unembed(self.embed, x), cache
