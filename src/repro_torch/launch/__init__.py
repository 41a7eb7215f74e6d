"""Entry points of the port (``train``, ``serve``, ``calibrate``) and the
device constants the dispatch cost model prices with (``roofline``)."""
