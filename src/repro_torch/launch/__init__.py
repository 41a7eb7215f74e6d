"""Entry points of the port (``train``, ``serve``, ``calibrate``, and the
report: ``dryrun``, ``report``), the device constants the dispatch cost
model and the report price with (``roofline``), and the report's parts
(``mesh``, ``specs``, ``steps``, ``step_cost``)."""
