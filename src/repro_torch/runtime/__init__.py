"""Training and serving runtime of the port: the trainer, the
continuous-batching engine, the server shim and fault injection.
Counterpart of :mod:`repro.runtime`."""
