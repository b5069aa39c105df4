"""Step metrics and profiling hooks (``metrics``), analytic FLOP counts
(``flops``), device timing (``timing``) and debugging aids (``debug``)."""
