"""Optimization-side FAµST: factors, projections, PALM (one matrix or a
stack), the hierarchical algorithm and its dictionary variant, sparse
coding (``dictionary``), plus the packed deployment formats
(``compress``)."""
