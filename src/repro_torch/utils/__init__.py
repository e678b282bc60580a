"""Host-side utilities of the port: the dry run's op-level cost counter
(``op_cost``)."""
