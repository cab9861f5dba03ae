from repro_torch.cache.library import Entry, KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool

__all__ = ["Entry", "KVLibrary", "PagedConfig", "PagedKVPool"]
