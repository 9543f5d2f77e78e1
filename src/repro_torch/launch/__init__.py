"""Launch layer of the port: the serving entry point (``serve``), the scenario
sweep (``sweep``), the figure campaign (``campaign``), its results store
(``results_store``) and report (``report``). Training steps, shapes,
sharding, variants and the dry run are later slices."""
