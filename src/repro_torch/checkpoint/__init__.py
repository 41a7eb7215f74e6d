"""Checkpoints of the port.  Counterpart of :mod:`repro.checkpoint`."""
