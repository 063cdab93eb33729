"""Cost analysis of the port: the per-op cost counter (``op_costs``), the
H100 roofline (``roofline``) and the beam hop's byte model
(``hop_traffic``)."""
