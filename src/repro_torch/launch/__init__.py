"""Launch layer of the port: the forecast-serving driver
(``python -m repro_torch.launch.serve``, the CLI over ``repro_torch.serving``),
the training launcher (``python -m repro_torch.launch.train``, on one device
or sharded over a mesh), device meshes over the process group (``mesh``),
one process per rank (``ranks.run_ranks``), the input specs and sharding
trees of every cell (``specs``), and the dry run on a fake process group
(``python -m repro_torch.launch.dryrun``) with its cost walk (``hlo_count``)."""
