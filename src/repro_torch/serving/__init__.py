"""Continuous-batching serving engine of the port (paged KV cache + FCFS
scheduler): ``kv_cache`` and ``scheduler`` are host-side copies of the JAX
package's, ``block_table`` mirrors the device block table, ``engine`` ties
them to the model's unified paged step."""
from repro_torch.serving.engine import (Engine, EngineConfig, EngineOOM,
                                        EngineStats)
from repro_torch.serving.kv_cache import (PagePool, PagePoolOOM, PrefixCache,
                                          chain_hashes)
from repro_torch.serving.scheduler import FCFSScheduler, Request

__all__ = ["Engine", "EngineConfig", "EngineOOM", "EngineStats",
           "FCFSScheduler", "PagePool", "PagePoolOOM", "PrefixCache",
           "Request", "chain_hashes"]
