"""Continuous-batching autoregressive decode serving over a paged KV cache,
with the shared-prefix cache and speculative decoding (the port of
``paddle_tpu.serving.generation``)."""
from .engine import (DecodeMetrics, GenerationServer, StreamingFuture,
                     engines_statusz)
from .kv_cache import PagedKVCache
from .model_fns import CachedDecoder, supports_cached_decode
from .prefix_cache import PrefixCache
from .sampling import sample_next_tokens
from .spec_decode import accept_tokens

__all__ = ["GenerationServer", "StreamingFuture", "DecodeMetrics",
           "engines_statusz", "PagedKVCache",
           "CachedDecoder", "supports_cached_decode", "PrefixCache",
           "accept_tokens", "sample_next_tokens"]
