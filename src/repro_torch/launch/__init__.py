"""Launch layer of the port: the forecast-serving driver
(``python -m repro_torch.launch.serve``, the CLI over ``repro_torch.serving``)."""
