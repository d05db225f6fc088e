"""Step factories: the train step, prefill and dense-cache decode, the
unified paged serving step (greedy or sampled, over one model or a bank
of circuits) and the device-side KV page copy.

PyTorch runs eagerly, so a "step" is a plain function; nothing is traced
or compiled per shape.  Serving casts the parameters to the compute dtype
once, when the engine is built (``models/params.py::cast_params``); the
prefill and decode steps cast on every call, which costs nothing when the
caller passes compute-dtype parameters; the train step refreshes a compute-dtype copy from the f32 masters every step
and differentiates that copy, as the JAX step differentiates
``cast_tree(params, compute_dtype)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import prng
from repro_torch.core.parallel_dropout import make_horn_state
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import (cast_params, copy_into, init_params,
                                       load_jax_flat, to_jax_flat)
from repro_torch.optim.sgd import clip_by_global_norm, make_optimizer

f32 = torch.float32


# ---------------------------------------------------------------------------
# Train state and step
# ---------------------------------------------------------------------------
def init_state(run: RunConfig, device="cuda") -> Dict:
    """{"params", "opt", "step", "rng"}: f32 (``run.param_dtype``) master
    parameters drawn from ``run.seed``, the optimizer's zero moments, step 0
    and the run's seed (the Horn masks' root)."""
    params = init_params(run.model, run.seed, device=device,
                         dtype=dtype_of(run.param_dtype))
    opt_init, _ = make_optimizer(run.optimizer)
    return {"params": params, "opt": opt_init(list(params.parameters())),
            "step": 0, "rng": run.seed}


def state_to_jax_flat(state: Dict, run: RunConfig) -> Dict[str, np.ndarray]:
    """The train state in the JAX package's checkpoint layout, {keystr:
    numpy array}: ``['params']...`` as ``to_jax_flat`` lays out the LM, each
    optimizer moment under its parameter's path (``['opt']['mom']...``, or
    ``['opt']['m'|'v']...`` and ``['opt']['t']`` int32), ``['step']``
    int32 and ``['rng']`` the uint32 key data of ``jax.random.key(seed)``,
    ``[0, seed]``."""
    cfg, params = run.model, state["params"]
    names = [n for n, _ in params.named_parameters()]
    flat = {"['params']" + k: v for k, v in to_jax_flat(params, cfg).items()}
    for moment in ("mom", "m", "v"):
        if moment in state["opt"]:
            flat.update({f"['opt']['{moment}']" + k: v for k, v in to_jax_flat(
                dict(zip(names, state["opt"][moment])), cfg).items()})
    if "t" in state["opt"]:
        flat["['opt']['t']"] = np.asarray(state["opt"]["t"], np.int32)
    seed = int(state["rng"])
    flat["['step']"] = np.asarray(state["step"], np.int32)
    flat["['rng']"] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    return flat


def state_from_jax_flat(flat, run: RunConfig, device="cuda") -> Dict:
    """The train state ``state_to_jax_flat`` (or the JAX package's
    checkpoint of ``init_state`` for the same config and optimizer) lays
    out, on ``device``: f32 masters, moments, step and seed."""
    dev = resolve_device(device)
    params = load_jax_flat(flat, run.model, device=dev,
                           dtype=dtype_of(run.param_dtype),
                           prefix="['params']")
    opt_init, _ = make_optimizer(run.optimizer)
    opt = opt_init(list(params.parameters()))
    names = [n for n, _ in params.named_parameters()]
    for moment in ("mom", "m", "v"):
        if moment in opt:
            load_jax_flat(flat, run.model, device=dev,
                          prefix=f"['opt']['{moment}']",
                          into=dict(zip(names, opt[moment])))
    if "t" in opt:
        opt["t"] = int(flat["['opt']['t']"])
    hi, lo = (int(x) for x in np.asarray(flat["['rng']"]))
    return {"params": params, "opt": opt, "step": int(flat["['step']"]),
            "rng": (hi << 32) | lo}


def make_train_step(run: RunConfig, device="cuda"):
    """step(state, batch) -> (new state, metrics).

    ``batch`` holds "tokens" and "labels" [B, S] (numpy or tensors).  The
    loss is differentiated against a compute-dtype copy of the masters
    (bf16 by default: the gradients come out in bf16, as in JAX), clipped
    at global norm 1.0 and applied to the masters by the optimizer, in
    place.  With ``run.microbatches`` M > 1 the batch splits into M equal
    parts whose gradients are summed in f32 and averaged; every
    microbatch sees the step's Horn masks (the same step and seed).

    The update is applied only where the loss and the grad norm are
    finite, decided on the device (no host sync): a non-finite step leaves
    the masters and the moments as they were, bit for bit.  The step
    returns a new state dict, with ``"step"`` one on and a new ``"opt"``
    dict (AdamW's ``"t"`` one on) over the same tensors, and leaves the
    old dict as it was, so a caller that drops the step (the fault-
    tolerant loop's "skip") keeps the old dict and nothing of the step
    remains.  A finite step gives the bits it gave before this rule.
    ``state["rng"]`` stays.  Metrics are 0-dim device tensors: "loss",
    "xent", "grad_norm"."""
    cfg = run.model
    dev = resolve_device(device)
    _, opt_update = make_optimizer(run.optimizer)
    cdtype = dtype_of(run.compute_dtype)
    held = {}                       # the masters and their compute copy

    def grads_of(cparams, batch, horn):
        leaves = list(cparams.parameters())
        loss, metrics = api.model_loss(cparams, batch, cfg, horn=horn,
                                       remat=run.remat != "none")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss, metrics, list(grads)

    def train_step(state, batch):
        params = state["params"]
        if held.get("params") is not params:
            held.update(params=params, cparams=cast_params(params, cdtype))
            for p in held["cparams"].parameters():
                p.requires_grad_(True)
        cparams = copy_into(held["cparams"], params)
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("tokens", "labels")}
        horn = make_horn_state(state["rng"], run.horn, state["step"], dev)
        M = max(1, run.microbatches)
        if M == 1:
            _, metrics, grads = grads_of(cparams, batch, horn)
        else:
            per = batch["tokens"].shape[0] // M
            grads, parts = None, []
            for i in range(M):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                _, m, g = grads_of(cparams, mb, horn)
                if grads is None:
                    grads = [gi.to(f32) for gi in g]
                else:
                    for a, gi in zip(grads, g):
                        a.add_(gi)
                parts.append(m)
            for a in grads:
                a.div_(M)
            metrics = {k: torch.stack([m[k] for m in parts]).mean()
                       for k in parts[0]}
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        finite = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        masters = list(params.parameters())
        opt = dict(state["opt"])
        if run.optimizer == "sgdm":
            opt_update(grads, opt, masters, lr=run.learning_rate,
                       momentum=run.momentum,
                       weight_decay=run.weight_decay, apply=finite)
        else:
            opt_update(grads, opt, masters, lr=run.learning_rate,
                       weight_decay=run.weight_decay, apply=finite)
        return dict(state, opt=opt, step=state["step"] + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(run: RunConfig, device="cuda"):
    """step(params, batch) -> (logits [B, vocab] at the last position, the
    decode cache of this shape cell), ``batch["tokens"]`` [B, S] (numpy or
    a tensor), S at most ``run.shape.seq_len``.  Runs ``api.prefill`` under
    inference mode on ``params`` cast to the compute dtype on every call,
    as the JAX step casts inside every call (``cast_params`` returns
    ``params`` itself when they already are in it: a caller that steps
    many times casts once and passes that).  Mamba layers run their
    chunked SSD through ``ssd_chunk_scan``.  Each attention layer's (k, v)
    is copied into buffers of ``run.shape.seq_len`` tokens
    (``T.decode_cache_of_prefill``), so ``make_decode_step`` continues the
    cache at position S."""
    cfg = run.model
    dev = resolve_device(device)
    cdtype = dtype_of(run.compute_dtype)

    @torch.inference_mode()
    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        logits, cache = api.prefill(cast_params(params, cdtype),
                                    {"tokens": tokens}, cfg)
        return logits, T.decode_cache_of_prefill(cfg, cache,
                                                 run.shape.seq_len)

    return prefill_step


def decode_cache_specs(run: RunConfig):
    """The decode cache of this shape cell (batch ``global_batch``, length
    ``seq_len``, bf16 buffers as in the JAX package) on the meta device:
    shapes and dtypes, no memory."""
    return T.init_cache(run.model, run.shape.global_batch, run.shape.seq_len,
                        device="meta")


def make_decode_step(run: RunConfig, device="cuda"):
    """step(params, cache, tokens [B, 1], pos) -> (logits [B, vocab], the
    new cache): one token at position ``pos`` (an int) for every sequence,
    under inference mode, on ``params`` cast to the compute dtype on every
    call as in ``make_prefill_step``.  Attention buffers are written in
    place (``pos`` must lie inside them); mamba states are replaced."""
    cfg = run.model
    dev = resolve_device(device)
    cdtype = dtype_of(run.compute_dtype)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos):
        tokens = torch.as_tensor(tokens, device=dev)
        return api.decode_step(cast_params(params, cdtype), cache, tokens,
                               pos, cfg)

    return decode_step


def _segment_sum(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [B, ...] summed into B segments (``seg`` [B] holds each
    row's segment) in row order, one row at a time, so the float sums
    round the same way on every device and every run (one ``index_add_``
    of all rows would race on a card)."""
    out = torch.zeros_like(x)
    for b in range(x.shape[0]):
        out.index_add_(0, seg[b:b + 1], x[b:b + 1])
    return out


def make_unified_paged_step(cfg: ModelConfig, *, temperature: float = 0.0,
                            bank_masks=None):
    """THE serving step: one call per engine tick, whatever the tick holds
    (decode tokens and prompt chunks packed into [B, C]).  Appends every
    token's K/V to the pools in place, runs paged attention over them and
    samples the next token of each slot at its last valid chunk position
    on the device.  Idle slots and mid-prompt chunks produce tokens the
    engine discards.

    step(params, cache, tokens [B, C], starts [B], chunk_lens [B],
         block_tables [B, maxp], req_ids [B], sample_steps [B],
         submodel_ids [B], seg_ids [B], vote_flags [B], root_key [2],
         *, ensembles=False) -> sampled [B] int32

    Greedy (argmax, ties to the first index) when ``temperature <= 0``;
    otherwise a categorical draw of ``logits / temperature`` with the key
    ``fold_in(fold_in(root_key, req_id), sample_step)`` of each slot
    (``core/prng.py``, the JAX package's threefry keys), so no key is
    reused across requests or steps.

    Multi-submodel serving (``bank_masks``: ``ModelBank.device_masks``,
    leading axis G + 1 with the dense sentinel last): each slot's circuit
    masks are gathered by ``submodel_ids`` once a tick on the device, so
    tokens of different circuits co-batch in one call.  ``seg_ids`` groups
    slots into ensembles (each slot carries its group leader's slot, a
    solo slot its own).  On a tick the engine flags with ``ensembles``,
    the slots' logits are combined on the device before sampling:
    mean-logit (segment sums over the counts; members carry the leader's
    ``req_id``, so one key decides the group) or, where ``vote_flags`` is
    set, a majority vote over the members' own samples (ties to the
    lowest token id).  A solo slot is a segment of one and samples the
    same token either way.  Ticks without an ensemble skip the combine.
    The speculative verify window (ROADMAP slice 3, item 14) is not
    ported: every slot samples at S_v == 1.
    """
    def pick(noise, logits, temp):
        if noise is None:
            return torch.argmax(logits, dim=-1)
        return prng.categorical_with(noise, logits.to(f32) / temp)

    @torch.inference_mode()
    def step(params, cache, tokens, starts, chunk_lens, block_tables,
             req_ids, sample_steps, submodel_ids, seg_ids, vote_flags,
             root_key, *, ensembles: bool = False):
        C = tokens.shape[1]
        serve_masks = None
        if bank_masks is not None:
            serve_masks = {k: m.index_select(0, submodel_ids)
                           for k, m in bank_masks.items()}
        widx = torch.clamp(chunk_lens.long() - 1, 0, C - 1)[:, None]
        logits, _ = api.paged_step(params, cache, tokens, starts, chunk_lens,
                                   block_tables, cfg, logit_index=widx,
                                   serve_masks=serve_masks)
        logits = logits[:, 0]
        B, V = logits.shape
        noise = temp = None
        if temperature > 0:
            keys = prng.fold_in(prng.fold_in(root_key, req_ids),
                                sample_steps)
            noise = prng.gumbel(keys, (V,))
            # a device tensor: a card divides a float by a host scalar
            # through its reciprocal, which rounds differently
            temp = torch.full((), temperature, dtype=f32,
                              device=logits.device)
        if not (ensembles and bank_masks is not None):
            return pick(noise, logits, temp).to(torch.int32)
        seg = seg_ids.long()
        lf = logits.to(f32)
        counts = torch.zeros(B, dtype=f32, device=lf.device).index_add_(
            0, seg, torch.ones(B, dtype=f32, device=lf.device))
        mean = _segment_sum(lf, seg) / torch.clamp(counts, min=1.0)[:, None]
        mean_tok = pick(noise, mean[seg], temp)
        own_tok = pick(noise, lf, temp)
        votes = torch.zeros_like(lf).index_add_(
            0, seg, torch.nn.functional.one_hot(own_tok, V).to(f32))
        vote_tok = torch.argmax(votes, dim=-1)[seg]
        return torch.where(vote_flags.bool(), vote_tok,
                           mean_tok).to(torch.int32)

    return step


def make_page_copy_step():
    """Device-side KV page copy for copy-on-write: ``copy(cache, src, dst)``
    duplicates page ``src[i]`` into page ``dst[i]`` in every layer's K and
    V pool, in place, and in the int8 mode the pages' [P, KH] scale rows
    with them.  Every leaf is [P, ...], so the page axis is always 0."""

    @torch.inference_mode()
    def copy(cache, src, dst):
        for pools in cache:
            for pool in pools:
                pool[dst] = pool[src]
        return cache

    return copy
