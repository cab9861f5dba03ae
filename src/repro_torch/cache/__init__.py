from repro_torch.cache.backends import (
    BlockMetadata,
    DiskBackend,
    KVPayload,
    MemoryBackend,
    StorageBackend,
    content_key,
    scope_digest,
    verify_payload,
)
from repro_torch.cache.library import (
    TIER_DISK,
    TIER_HBM,
    TIER_HOST,
    Entry,
    KVLibrary,
)
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.cache.quant import QuantizedKV, dequantize_kv, quantize_kv
from repro_torch.cache.transfer import (
    LoadRecord,
    ParallelLoader,
    PrefetchHandle,
)

__all__ = [
    "BlockMetadata", "DiskBackend", "Entry", "KVLibrary", "KVPayload",
    "LoadRecord", "MemoryBackend", "PagedConfig", "PagedKVPool",
    "ParallelLoader", "PrefetchHandle", "QuantizedKV", "StorageBackend",
    "TIER_DISK", "TIER_HBM", "TIER_HOST", "content_key", "dequantize_kv",
    "quantize_kv", "scope_digest", "verify_payload",
]
