"""The inputs of a configuration family, made on the device from the seed:
one module a family, named by its configuration's ``inputs``."""
