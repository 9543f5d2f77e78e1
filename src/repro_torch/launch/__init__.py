"""Launch layer of the port: the serving entry point (``serve``), the scenario
sweep (``sweep``), the figure campaign (``campaign``), its results store
(``results_store``) and report (``report``), and the process groups and
meshes of the vehicle-sharded backend (``mesh``). Training steps, shapes,
sharding of the model zoo, variants and the dry run are later slices."""
