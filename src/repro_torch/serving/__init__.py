"""Continuous-batching serving engine of the port (paged KV cache + FCFS
scheduler): ``kv_cache``, ``scheduler`` and ``router`` are host-side
copies of the JAX package's, ``block_table`` mirrors the device block
table, ``model_bank`` holds Horn's circuits, ``speculative`` runs a
circuit as the draft of speculative decoding, ``engine`` ties them to the
model's unified paged step."""
from repro_torch.serving.engine import (Engine, EngineConfig, EngineOOM,
                                        EngineStats)
from repro_torch.serving.kv_cache import (PagePool, PagePoolOOM, PrefixCache,
                                          chain_hashes)
from repro_torch.serving.model_bank import DraftModel, ModelBank
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import (EnsembleGroup, FCFSScheduler,
                                           Request, speculative_draft_len)
from repro_torch.serving.speculative import DraftRunner

__all__ = ["DraftModel", "DraftRunner", "Engine", "EngineConfig", "EngineOOM",
           "EngineStats", "EnsembleGroup", "FCFSScheduler", "ModelBank",
           "PagePool", "PagePoolOOM", "PrefixCache", "Request", "Router",
           "chain_hashes", "speculative_draft_len"]
