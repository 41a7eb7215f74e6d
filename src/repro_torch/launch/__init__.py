"""Device constants the dispatch cost model prices with (``roofline``)."""
