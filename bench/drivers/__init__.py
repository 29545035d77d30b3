"""One module a timed entry point, named by the traffic file's ``driver``:
``build(cfg, traffic, seed, device, rank, world)`` returns a
``common.Session`` whose ``call`` is one call of that entry."""
