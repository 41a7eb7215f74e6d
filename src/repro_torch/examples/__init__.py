"""Runnable examples of the port, each a module with ``main(argv)``:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.compress_operator [--device cpu]
    python -m repro_torch.examples.train_tiny_lm [--faust] [--device cpu]
    python -m repro_torch.examples.serve_lm [--arch gemma3_27b] [--device cpu]

Counterparts of the reference's ``examples/*.py``; without ``--device``
they run on the CUDA card and raise when there is none.
"""
