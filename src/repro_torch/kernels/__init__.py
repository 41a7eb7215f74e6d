"""Block-sparse FAµST apply: hand-written CUDA kernels (``csrc/``), their
ctypes wrappers (``bsr_matmul``, ``chain``), the plain PyTorch versions
(``ref``) and the entry points that pad, slice and dispatch (``ops``)."""
