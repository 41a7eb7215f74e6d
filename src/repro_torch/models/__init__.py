"""The port's decoder LM (training, prefill and decode).  Counterpart of :mod:`repro.models`."""
