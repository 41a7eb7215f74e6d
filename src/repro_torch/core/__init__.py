"""Optimization-side FAµST: factors, projections, PALM (one matrix or a
stack), the hierarchical algorithm and its dictionary variant, sparse
coding (``dictionary``), plus the packed deployment formats
and the drivers that compress a model's weights into them
(``compress``)."""
from repro_torch.core.compress import (
    BlockFaust,
    BlockSparseFactor,
    PackedChain,
    compress_layers,
    compress_model,
    pack_chain,
    pack_dense,
    random_block_factor,
    unpack_chain,
)
from repro_torch.core.faust import Faust, default_init, dense_flops, faust_flops
from repro_torch.core.hierarchical import (
    CacheStats,
    HierarchicalInfo,
    HierarchicalSpec,
    hadamard_matrix,
    hadamard_spec,
    hierarchical_dictionary,
    hierarchical_factorization,
    hierarchical_factorization_batched,
    meg_style_spec,
    reset_trace_cache,
    trace_cache_stats,
)
from repro_torch.core.lipschitz import spectral_norm, spectral_norm_batched
# the function ``palm4msa`` is not re-exported: ``repro_torch.core.palm4msa`` stays the module
from repro_torch.core.palm4msa import PalmResult, palm4msa_batched, palm4msa_faust, product

__all__ = [
    "BlockFaust",
    "BlockSparseFactor",
    "CacheStats",
    "Faust",
    "HierarchicalInfo",
    "HierarchicalSpec",
    "PackedChain",
    "PalmResult",
    "compress_layers",
    "compress_model",
    "default_init",
    "dense_flops",
    "faust_flops",
    "hadamard_matrix",
    "hadamard_spec",
    "hierarchical_dictionary",
    "hierarchical_factorization",
    "hierarchical_factorization_batched",
    "meg_style_spec",
    "pack_chain",
    "pack_dense",
    "palm4msa_batched",
    "palm4msa_faust",
    "product",
    "random_block_factor",
    "reset_trace_cache",
    "spectral_norm",
    "spectral_norm_batched",
    "trace_cache_stats",
    "unpack_chain",
]
