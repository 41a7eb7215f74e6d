"""FAµST on PyTorch and CUDA — the port of :mod:`repro` to one NVIDIA H100.

The package mirrors the JAX package's layout (``core/``, ``kernels/``,
``api/``, ``launch/``) so each module's counterpart is easy to find, and
imports neither JAX nor anything of ``repro``.  Arrays cross between the
two packages as numpy (:mod:`repro_torch.bridge`).

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device given it raises.  A CUDA
tensor runs the hand-written kernels (``kernels/csrc``), a CPU tensor runs
their plain PyTorch versions.
"""
