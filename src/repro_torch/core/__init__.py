"""Optimization-side FAµST: factors, projections, PALM and the hierarchical
algorithm, plus the packed deployment formats (``compress``)."""
