from repro_torch.serving.engine import EngineConfig, MPICEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever

__all__ = ["EngineConfig", "MPICEngine", "Request", "Retriever", "State"]
