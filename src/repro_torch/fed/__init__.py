from . import engine, metrics, mobility, partition, simulator, topology  # noqa: F401
from .engine import ContactStream, EngineContext  # noqa: F401
from .mobility import ManhattanMobility, MobilityConfig, contact_schedule  # noqa: F401
from .simulator import SimulationConfig, SimulationResult, run_simulation  # noqa: F401
from .topology import RoadNetwork, contact_matrix, make_road_network  # noqa: F401
