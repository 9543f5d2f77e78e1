"""Launch layer of the port: the serving entry point (``serve``), the training
entry point of the paper's CNN federations (``train``), the scenario sweep
(``sweep``), the figure campaign (``campaign``), its results store
(``results_store``) and report (``report``), and the process groups and
meshes of the vehicle-sharded backend (``mesh``). Training steps, shapes,
sharding of the model zoo, variants and the dry run are later slices.

``serve`` and ``train`` are entry points (``python -m``) and are not
imported here."""
from . import campaign, mesh, report, results_store, sweep
