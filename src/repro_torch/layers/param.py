"""The logical axes and shapes of every parameter.  Counterpart of the
annotations of :mod:`repro.layers.param` (``annotate``, ``dense_init``,
``stack_annotated``) as the reference's layer inits attach them.

:func:`param_table` lists, for ``LM(cfg)``'s state dict (parameters, and
the FAµST supports ``in_idx``), each entry's shape and logical axes,
computed from the config alone (no tensor is made, so it runs at any
width).  Logical axes:

* ``"embed"``: the model width (and a norm's vector);
* ``"vocab"``: the vocabulary;
* ``"heads_flat"`` / ``"kv_flat"``: flattened query / KV heads × head_dim;
  ``"heads"``: a mamba block's heads;
* ``"mlp"``: the FFN's hidden width; ``"experts"``: the MoE expert axis;
* ``"inner_flat"``: a mamba block's inner width;
* ``"blocks"``, ``"block_k"``: a FAµST factor's out-blocks and kept blocks;
* ``"layers"``: a stacked leading axis (musicgen's per-codebook tables
  and heads, stacked in both packages);
* ``None``: replicated.

The reference stacks each stage's layers on a leading ``"layers"`` axis;
here each layer is its own module, so that axis is not in the table (it
maps to ``None`` in every policy).
"""
from __future__ import annotations

from repro_torch.layers.mlp import GLU_KINDS

Axes = tuple


def _norm(prefix: str, kind: str, d: int) -> dict:
    if kind == "rms":
        return {prefix: ((d,), ("embed",))}
    return {f"{prefix}.scale": ((d,), ("embed",)), f"{prefix}.bias": ((d,), ("embed",))}


def _dense(name: str, shape: tuple, axes: Axes) -> dict:
    return {name: (tuple(shape), tuple(axes))}


def _faust(prefix: str, in_dim: int, out_dim: int, spec, n: int = 1) -> dict:
    """A FAµST projection's factors and λ (``n > 1``: stacked heads)."""
    lead, lead_axes = ((n,), ("layers",)) if n > 1 else ((), ())
    dims = spec.chain_dims(in_dim, out_dim)
    out = {}
    for i in range(spec.n_factors):
        ib, ob = -(-dims[i] // spec.block), -(-dims[i + 1] // spec.block)
        k = min(spec.k, ib)
        out[f"{prefix}.factors.{i}.values"] = (lead + (ob, k, spec.block, spec.block),
                                               lead_axes + ("blocks", "block_k", None, None))
        out[f"{prefix}.factors.{i}.in_idx"] = (lead + (ob, k), lead_axes + ("blocks", "block_k"))
    out[f"{prefix}.lam"] = (lead, lead_axes)
    return out


def _mlp(prefix: str, d: int, ff: int, act: str, faust) -> dict:
    names = [("w_up", d, ff, ("embed", "mlp")), ("w_down", ff, d, ("mlp", "embed"))]
    if act in GLU_KINDS:
        names.append(("w_gate", d, ff, ("embed", "mlp")))
    out = {}
    for name, i, o, axes in names:
        if faust is None:
            out.update(_dense(f"{prefix}.{name}", (i, o), axes))
        else:
            out.update(_faust(f"{prefix}.{name}", i, o, faust))
    return out


def _attn_layer(prefix: str, cfg, kind: str) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = _norm(f"{prefix}norm1", cfg.norm, d)
    out.update(_dense(f"{prefix}attn.wq", (d, h * hd), ("embed", "heads_flat")))
    out.update(_dense(f"{prefix}attn.wk", (d, kh * hd), ("embed", "kv_flat")))
    out.update(_dense(f"{prefix}attn.wv", (d, kh * hd), ("embed", "kv_flat")))
    out.update(_dense(f"{prefix}attn.wo", (h * hd, d), ("heads_flat", "embed")))
    if cfg.qk_norm:
        out.update(_dense(f"{prefix}attn.q_norm", (hd,), (None,)))
        out.update(_dense(f"{prefix}attn.k_norm", (hd,), (None,)))
    out.update(_norm(f"{prefix}norm2", cfg.norm, d))
    if kind == "moe":
        m = cfg.moe
        out.update(_dense(f"{prefix}moe.router", (d, m.n_experts), ("embed", "experts")))
        out.update(_dense(f"{prefix}moe.w_up", (m.n_experts, d, m.d_ff), ("experts", "embed", "mlp")))
        out.update(_dense(f"{prefix}moe.w_down", (m.n_experts, m.d_ff, d), ("experts", "mlp", "embed")))
        if m.act in GLU_KINDS:
            out.update(_dense(f"{prefix}moe.w_gate", (m.n_experts, d, m.d_ff), ("experts", "embed", "mlp")))
        if m.shared_expert_ff:
            out.update(_mlp(f"{prefix}moe.shared", d, m.shared_expert_ff, m.act, None))
    else:
        out.update(_mlp(f"{prefix}mlp", d, cfg.d_ff, cfg.act, cfg.faust_mlp))
    return out


def _ssm_layer(prefix: str, cfg) -> dict:
    s = cfg.ssm
    d, di, h = cfg.d_model, s.d_inner, s.n_heads
    out = _norm(f"{prefix}norm", cfg.norm, d)
    m = f"{prefix}mamba."
    out.update(_dense(m + "in_proj", (d, 2 * di + 2 * s.n_groups * s.d_state + h), ("embed", "inner_flat")))
    out.update(_dense(m + "conv_w", (s.d_conv, s.conv_dim), (None, "inner_flat")))
    out.update(_dense(m + "conv_b", (s.conv_dim,), ("inner_flat",)))
    for name in ("a_log", "d_skip", "dt_bias"):
        out.update(_dense(m + name, (h,), ("heads",)))
    out.update(_dense(m + "norm_w", (di,), ("inner_flat",)))
    out.update(_dense(m + "out_proj", (di, d), ("inner_flat", "embed")))
    return out


def param_table(cfg) -> dict[str, tuple[tuple, Axes]]:
    """``{state dict key: (shape, logical axes)}`` of ``LM(cfg)``."""
    d, v, n = cfg.d_model, cfg.vocab, cfg.n_codebooks
    out = {}
    if n > 1:
        out.update(_dense("embed.table", (n, v, d), ("layers", "vocab", "embed")))
    else:
        out.update(_dense("embed.table", (v, d), ("vocab", "embed")))
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        if kind == "ssm":
            out.update(_ssm_layer(f"layers.{i}.", cfg))
        elif kind != "shared":
            out.update(_attn_layer(f"layers.{i}.", cfg, kind))
    if "shared" in kinds:
        out.update(_attn_layer("shared.", cfg, "attn"))
    out.update(_norm("final_norm", cfg.norm, d))
    if not cfg.tie_embeddings:
        if cfg.faust_unembed is not None:
            out.update(_faust("unembed.faust", d, v, cfg.faust_unembed, n))
        elif n > 1:
            out.update(_dense("unembed.w", (n, d, v), ("layers", "embed", "vocab")))
        else:
            out.update(_dense("unembed.w", (d, v), ("embed", "vocab")))
    return out


def param_axes(cfg) -> dict[str, Axes]:
    """``{state dict key: logical axes}`` of ``LM(cfg)``."""
    return {k: axes for k, (_, axes) in param_table(cfg).items()}


def param_shapes(cfg) -> dict[str, tuple]:
    """``{state dict key: shape}`` of ``LM(cfg)``, without making it."""
    return {k: shape for k, (shape, _) in param_table(cfg).items()}
