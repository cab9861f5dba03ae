from repro_torch.serving.cluster import (
    ClusterConfig,
    MPICCluster,
    StuckFleetError,
)
from repro_torch.serving.engine import EngineConfig, MPICEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever
from repro_torch.serving.router import (
    ROUTERS,
    AffinityRouter,
    LeastLoadedRouter,
    RandomRouter,
    ReplicaView,
    Router,
    RoutingDecision,
    heartbeat_view,
    make_router,
)
from repro_torch.serving.scheduler import PipelinedScheduler, WaitingQueue

__all__ = ["AffinityRouter", "ClusterConfig", "EngineConfig",
           "LeastLoadedRouter", "MPICCluster", "MPICEngine",
           "PipelinedScheduler", "ROUTERS", "RandomRouter", "ReplicaView",
           "Request", "Retriever", "Router", "RoutingDecision", "State",
           "StuckFleetError", "WaitingQueue", "heartbeat_view",
           "make_router"]
