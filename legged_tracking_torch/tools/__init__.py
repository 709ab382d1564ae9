"""The port's measurement tools, counterparts of the repo's ``tools/``
(which stay the JAX package's): ``profile_bench`` (a stack-carrying
``torch.profiler`` trace of the bench, and its ops, launches and syncs by
source line), ``analyze_trace`` (device time by source line and the idle
share), ``roofline`` (the matrix-product FLOP of an iteration against the
card's peaks), ``scaling_bench`` (ranks at fixed total envs),
``ji22_ledger`` (the velocity rewards' negative ledger) and
``planner_menu_bench`` (the offline planner menu on random tunnels).  Each
runs as ``python -m legged_tracking_torch.tools.<name>``."""
