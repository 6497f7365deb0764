"""Serving substrate: batched prefill/decode engine."""
