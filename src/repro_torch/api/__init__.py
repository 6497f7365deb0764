"""Typed budgets (:mod:`repro_torch.api.budget`).  Session, MergeService
and spec files are not ported yet."""
