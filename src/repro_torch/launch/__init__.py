"""Launch layer of the port: the forecast-serving driver
(``python -m repro_torch.launch.serve``, the CLI over ``repro_torch.serving``),
the single-device training launcher (``python -m repro_torch.launch.train``),
device meshes over the process group (``mesh``), and one process per rank
(``ranks.run_ranks``)."""
