"""Launch layer of the port: the serving entry point (``serve``). Training steps,
shapes, sharding, variants and the dry run are later slices."""
