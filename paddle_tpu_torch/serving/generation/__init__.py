"""Continuous-batching autoregressive decode serving over a paged KV cache
(the port of ``paddle_tpu.serving.generation``)."""
from .engine import GenerationServer, StreamingFuture
from .kv_cache import PagedKVCache
from .model_fns import CachedDecoder, supports_cached_decode
from .sampling import sample_next_tokens

__all__ = ["GenerationServer", "StreamingFuture", "PagedKVCache",
           "CachedDecoder", "supports_cached_decode", "sample_next_tokens"]
