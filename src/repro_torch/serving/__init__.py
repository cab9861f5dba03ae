from repro_torch.serving.engine import EngineConfig, MPICEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever
from repro_torch.serving.scheduler import PipelinedScheduler, WaitingQueue

__all__ = ["EngineConfig", "MPICEngine", "PipelinedScheduler", "Request",
           "Retriever", "State", "WaitingQueue"]
