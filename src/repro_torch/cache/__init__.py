from repro_torch.cache.backends import (
    BlockMetadata,
    DiskBackend,
    KVPayload,
    MemoryBackend,
    NetworkBackend,
    StorageBackend,
    content_key,
    payload_from_bytes,
    payload_to_bytes,
    scope_digest,
    verify_payload,
)
from repro_torch.cache.faults import FaultPlan, FaultRule, ReplicaCrash
from repro_torch.cache.library import (
    TIER_DISK,
    TIER_HBM,
    TIER_HOST,
    TIER_NETWORK,
    Entry,
    KVLibrary,
)
from repro_torch.cache.net import (
    DictBlockStore,
    KVPeerServer,
    PeerBreaker,
    PeerTransport,
)
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.cache.quant import QuantizedKV, dequantize_kv, quantize_kv
from repro_torch.cache.transfer import (
    LoadRecord,
    ParallelLoader,
    PrefetchHandle,
    TransferPlan,
    plan_transfers,
)

__all__ = [
    "BlockMetadata", "DictBlockStore", "DiskBackend", "Entry", "FaultPlan",
    "FaultRule", "KVLibrary", "KVPayload", "KVPeerServer", "LoadRecord",
    "MemoryBackend", "NetworkBackend", "PagedConfig", "PagedKVPool",
    "ParallelLoader", "PeerBreaker", "PeerTransport", "PrefetchHandle",
    "QuantizedKV", "ReplicaCrash", "StorageBackend", "TIER_DISK", "TIER_HBM",
    "TIER_HOST", "TIER_NETWORK", "TransferPlan", "content_key", "dequantize_kv",
    "payload_from_bytes", "payload_to_bytes", "plan_transfers",
    "quantize_kv", "scope_digest", "verify_payload",
]
