"""Layers of the port's LM: FAµST linear, norms, rotary, attention with KV
caches, MLP, embedding.  Counterpart of :mod:`repro.layers`."""
