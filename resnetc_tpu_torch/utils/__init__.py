"""Step metrics (``metrics``) and analytic FLOP counts (``flops``)."""
