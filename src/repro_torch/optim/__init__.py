"""Optimizers of the port.  Counterpart of :mod:`repro.optim`."""
