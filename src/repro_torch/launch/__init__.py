"""Launch layer of the port: the serving and training entry points (``serve``,
``train``: the paper's CNN federations and DFL-DDS over the transformer zoo),
the DDS training round and the serving steps (``steps``), the step builders'
variants (``variants``), the scenario sweep (``sweep``), the figure campaign
(``campaign``), its results store (``results_store``) and report (``report``),
and the process groups and meshes of the vehicle-sharded backend (``mesh``).
The model zoo's shapes, sharding and dry run are a later slice.

``serve`` and ``train`` are entry points (``python -m``) and are not
imported here."""
from . import campaign, mesh, report, results_store, steps, sweep, variants
