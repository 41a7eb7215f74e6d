"""Layers of the port's LM: FAµST linear, norms, rotary, attention, MLP,
embedding.  Counterpart of :mod:`repro.layers` (train mode)."""
