"""Training runtime of the port.  Counterpart of :mod:`repro.runtime`."""
