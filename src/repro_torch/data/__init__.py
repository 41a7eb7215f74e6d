"""Data pipeline of the port.  Counterpart of :mod:`repro.data`."""
