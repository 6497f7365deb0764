"""Test-support utilities that ship with the library: the chaos
crash-point harness (:mod:`repro_torch.testing.chaos`)."""
