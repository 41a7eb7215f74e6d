"""Feed-forward blocks (GeGLU/SwiGLU, GELU, squared ReLU), each projection
dense or FAµST.  Counterpart of :mod:`repro.layers.mlp`.

The GELU is the tanh approximation (``jax.nn.gelu(approximate=True)``),
not torch's default erf form."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.layers.embedding import dense_param
from repro_torch.layers.faust_linear import FaustLinear, FaustSpec

GLU_KINDS = ("geglu", "swiglu")


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind in ("geglu", "gelu"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "swiglu":
        return torch.nn.functional.silu(x)
    if kind == "sq_relu":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


class MLP(nn.Module):
    """``w_up``/``w_gate``/``w_down``: dense ``(in, out)`` parameters, or
    :class:`FaustLinear` layers when ``faust`` is given."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, generator, dtype, device,
                 faust: FaustSpec | None = None):
        super().__init__()
        self.act = act
        names = [("w_up", d_model, d_ff), ("w_down", d_ff, d_model)]
        if act in GLU_KINDS:
            names.append(("w_gate", d_model, d_ff))
        for name, i, o in names:
            if faust is None:
                setattr(self, name, dense_param(i, o, generator=generator, dtype=dtype, device=device))
            else:
                setattr(self, name, FaustLinear(i, o, faust, generator=generator, dtype=dtype, device=device))

    def _proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = getattr(self, name)
        return w(x) if isinstance(w, FaustLinear) else x @ w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self._proj("w_up", x)
        if self.act in GLU_KINDS:
            h = _act(self.act, self._proj("w_gate", x)) * up
        else:
            h = _act(self.act, up)
        return self._proj("w_down", h)
