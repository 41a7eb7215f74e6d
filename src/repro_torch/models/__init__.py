"""The port's decoder LM (train mode).  Counterpart of :mod:`repro.models`."""
