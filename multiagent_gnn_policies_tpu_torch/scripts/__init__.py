"""Measurement and checking tools of the port, each run as ``python -m
multiagent_gnn_policies_tpu_torch.scripts.<name>``: ``smoke_env``,
``bench_large_n``, ``profile_large_n``, ``run_1m`` and ``verify_cells``."""
