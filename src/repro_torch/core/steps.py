"""Step factories: the train step, prefill and dense-cache decode, the
unified paged serving step (greedy or sampled, over one model or a bank
of circuits, with the speculative verify window), the draft step of
speculative decoding and the device-side KV page copy.

PyTorch runs eagerly, so a "step" is a plain function; nothing is traced
or compiled per shape.  The train step also runs on a ``DeviceMesh``
(``make_train_step(mesh=)``): the state as DTensors laid out by
``state_shardings`` (the logical axes of ``launch/mesh.py``), each rank on
its rows of the global batch, gradients averaged over the data ranks.  Serving casts the parameters to the compute dtype
once, when the engine is built (``models/params.py::cast_params``); the
prefill and decode steps cast on every call, which costs nothing when the
caller passes compute-dtype parameters; the train step refreshes a compute-dtype copy from the f32 masters every step
and differentiates that copy, as the JAX step differentiates
``cast_tree(params, compute_dtype)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import prng
from repro_torch.core.group_sync import psum_mean
from repro_torch.core.parallel_dropout import make_horn_state
from repro_torch.launch.mesh import (NamedSharding, ShardingCtx, local_range,
                                     local_shard, sharding_rules,
                                     tree_shardings)
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import (cast_params, copy_into, empty_params,
                                       init_params, layer_axes, load_jax_flat,
                                       to_jax_flat)
from repro_torch.optim.sgd import clip_by_global_norm, make_optimizer

f32 = torch.float32


def make_ctx(model_cfg: ModelConfig, mesh, shape=None) -> ShardingCtx:
    return ShardingCtx(mesh=mesh,
                       rules=sharding_rules(model_cfg, mesh, shape))


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


def state_axes(run: RunConfig) -> Dict:
    """The logical axes of the train state, in its own tree: "params"
    {parameter name: axes} (each layer's ``AXES``), the optimizer moments
    a list in parameter order mirroring them (ZeRO-style: the "parameter
    server" state lives wherever its parameter's shard lives), AdamW's
    "t", "step" and "rng" replicated."""
    paxes = layer_axes(empty_params(run.model, "meta"))
    moment = list(paxes.values())
    opt = ({"mom": moment} if run.optimizer == "sgdm"
           else {"m": moment, "v": moment, "t": ()})
    return {"params": paxes, "opt": opt, "step": (), "rng": (None,)}


def state_shardings(run: RunConfig, mesh) -> Dict:
    """``state_axes`` laid onto ``mesh`` (``NamedSharding`` leaves; None
    off-mesh)."""
    return tree_shardings(state_axes(run), make_ctx(run.model, mesh,
                                                    run.shape))


def batch_axes(run: RunConfig) -> Dict[str, Tuple]:
    cfg = run.model
    ax: Dict[str, Tuple] = {"tokens": ("batch", "seq"),
                            "labels": ("batch", "seq")}
    if cfg.is_encoder_decoder:
        ax["frames"] = ("batch", None, None)
    if cfg.num_patches:
        ax["patch_embeds"] = ("batch", None, None)
    return ax


def batch_shardings(run: RunConfig, mesh) -> Dict:
    ctx = make_ctx(run.model, mesh, run.shape)
    ax = batch_axes(run)
    if run.shape.kind != "train":
        ax.pop("labels", None)
    return {k: ctx.sharding(*v) for k, v in ax.items()}


def state_to_jax_flat(state: Dict, run: RunConfig) -> Dict[str, np.ndarray]:
    """The train state in the JAX package's checkpoint layout, {keystr:
    numpy array}: ``['params']...`` as ``to_jax_flat`` lays out the model
    (an encoder-decoder's under ``['encoder']`` and ``['decoder']``), each
    optimizer moment under its parameter's path (``['opt']['mom']...``, or
    ``['opt']['m'|'v']...`` and ``['opt']['t']`` int32), ``['step']``
    int32 and ``['rng']`` the uint32 key data of ``jax.random.key(seed)``,
    ``[0, seed]``.  A DTensor state is gathered whole (every rank of its
    mesh must call this)."""
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


def make_train_step(run: RunConfig, device="cuda", mesh=None):
    """step(state, batch) -> (new state, metrics).

    ``batch`` holds "tokens" and "labels" [B, S] (numpy or tensors), and
    "patch_embeds" [B, num_patches, d_model] for a multimodal config or
    "frames" [B, encoder_seq, d_model] for an encoder-decoder (the
    encoder's stream keeps their dtype).  The
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
    "xent", the MoE aux ("load_balance_loss", "router_z_loss",
    "dropped_frac": zeros for a dense model) and "grad_norm".

    ``mesh`` (a ``DeviceMesh`` on ``device``'s type, the ranks of this
    step's job): the parameters and moments are DTensors, as
    ``state_shardings`` lays them out (FSDP on "embed" over data, the wide
    dims over model; ``runtime/elastic.py::remesh_state`` puts a state
    there).  Every rank passes the same global batch and computes on its
    rows of it, by the "batch" rule over data (and pod), on plain local
    tensors: the parameters gathered whole in the compute dtype.  Ranks
    along "model" compute the same rows (the function of JAX's GSPMD step,
    not its tensor-parallel compute).  Gradients are averaged over the
    data ranks (``group_sync.psum_mean``, written back in their dtype),
    clipped, and each rank updates its own shard of the masters and
    moments.  Loss and grad norm are the global ones: every rank holds
    the same token count, so the mean of the ranks' losses is the batch's.
    A Horn row keeps its group by its global index; ``num_groups=0``
    means one group a data shard, as in JAX.  An MoE config is refused on
    more than one data rank: its router losses are not means over rows."""
    cfg = run.model
    dev = resolve_device(device)
    _, opt_update = make_optimizer(run.optimizer)
    cdtype = dtype_of(run.compute_dtype)
    ctx = None
    if mesh is not None:
        ctx = make_ctx(cfg, mesh, run.shape)
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh for a step on "
                             f"{dev}")
        if cfg.num_experts and ctx.dp_size > 1:
            raise NotImplementedError(
                "MoE router losses over a batch split across data ranks "
                "(ROADMAP item 32)")
    held = {}                       # the masters and their compute copy

    def grads_of(cparams, batch, horn):
        leaves = list(cparams.parameters())
        loss, metrics = api.model_loss(cparams, batch, cfg, horn=horn,
                                       remat=run.remat != "none")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss, metrics, list(grads)

    def loss_and_grads(cparams, batch, horn):
        M = max(1, run.microbatches)
        if M == 1:
            _, metrics, grads = grads_of(cparams, batch, horn)
            return metrics, grads
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
        return ({k: torch.stack([m[k] for m in parts]).mean()
                 for k in parts[0]}, grads)

    def compute_copy(params):
        if held.get("params") is not params:
            held.update(params=params, cparams=(
                cast_params(params, cdtype) if mesh is None
                else empty_params(cfg, dev, cdtype)))
            for p in held["cparams"].parameters():
                p.requires_grad_(True)
        if mesh is None:
            return copy_into(held["cparams"], params)
        with torch.no_grad():           # cast locally, gather in cdtype
            for c, p in zip(held["cparams"].parameters(),
                            params.parameters()):
                if isinstance(p, DTensor):
                    p = DTensor.from_local(
                        p.to_local().to(cdtype), p.device_mesh,
                        p.placements, run_check=False).full_tensor()
                c.copy_(p)
        return held["cparams"]

    def rank_rows(batch):
        """(this rank's rows, (first row, global batch) or None)."""
        if mesh is None:
            return batch, None
        B = batch["tokens"].shape[0]
        # equal rows a rank (local_range raises on an uneven split): the
        # mean of the ranks' losses is then the batch's
        lo, hi = local_range(B, mesh, ctx.placements("batch"), 0)
        return {k: v[lo:hi] for k, v in batch.items()}, (lo, B)

    def merge(metrics, grads):
        """Means over the data ranks, each gradient's written back into it
        (its dtype and its strides: a reduction over it then runs in the
        order it runs off-mesh)."""
        if mesh is None:
            return metrics, grads
        groups = ctx.dp_groups
        merged = psum_mean(dict(enumerate(grads)), groups)
        with torch.no_grad():
            for i, g in enumerate(grads):
                g.copy_(merged[i])
        return psum_mean(metrics, groups), grads

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def train_step(state, batch):
        params = state["params"]
        cparams = compute_copy(params)
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("tokens", "labels", "patch_embeds", "frames")
                 if k in batch}
        batch, rows = rank_rows(batch)
        kw = {} if mesh is None else dict(dp_size=ctx.dp_size, rows=rows)
        horn = make_horn_state(state["rng"], run.horn, state["step"], dev,
                               **kw)
        metrics, grads = loss_and_grads(cparams, batch, horn)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics, grads = merge(metrics, grads)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        metrics["grad_norm"] = gnorm
        finite = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        masters = list(params.parameters())
        opt = dict(state["opt"])
        with torch.no_grad():           # each rank's own shards
            grads = [local_shard(g, NamedSharding(p.device_mesh,
                                                  p.placements))
                     if isinstance(p, DTensor) else g
                     for g, p in zip(grads, masters)]
            lopt = {k: ([local(x) for x in v] if isinstance(v, list) else v)
                    for k, v in opt.items()}
            lmasters = [local(p) for p in masters]
        if run.optimizer == "sgdm":
            opt_update(grads, lopt, lmasters, lr=run.learning_rate,
                       momentum=run.momentum,
                       weight_decay=run.weight_decay, apply=finite)
        else:
            opt_update(grads, lopt, lmasters, lr=run.learning_rate,
                       weight_decay=run.weight_decay, apply=finite)
        opt.update((k, v) for k, v in lopt.items()
                   if not isinstance(v, list))
        return dict(state, opt=opt, step=state["step"] + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(run: RunConfig, device="cuda"):
    """step(params, batch) -> (logits [B, vocab] at the last position, the
    decode cache of this shape cell), ``batch["tokens"]`` [B, S] (numpy or
    a tensor) behind ``batch["patch_embeds"]`` [B, num_patches, d] for a
    multimodal config, patches plus S at most ``run.shape.seq_len``.  An
    encoder-decoder's step encodes ``batch["frames"]`` [B, S_enc, d] and
    returns the encoder output as a third value, which its decode step
    takes.  Runs
    ``api.prefill`` under inference mode on ``params`` cast to the compute
    dtype on every call, as the JAX step casts inside every call
    (``cast_params`` returns ``params`` itself when they already are in
    it: a caller that steps many times casts once and passes that).  Mamba layers run their
    chunked SSD through ``ssd_chunk_scan``.  Each attention layer's (k, v)
    is copied into buffers of ``run.shape.seq_len`` tokens
    (``T.decode_cache_of_prefill``), so ``make_decode_step`` continues the
    cache at the position after the prompt (patches plus S)."""
    cfg = run.model
    dev = resolve_device(device)
    cdtype = dtype_of(run.compute_dtype)

    @torch.inference_mode()
    def prefill_step(params, batch):
        inputs = {k: torch.as_tensor(batch[k], device=dev)
                  for k in ("tokens", "patch_embeds", "frames")
                  if k in batch}
        logits, cache, *enc = api.prefill(cast_params(params, cdtype),
                                          inputs, cfg)
        return (logits, T.decode_cache_of_prefill(cfg, cache,
                                                  run.shape.seq_len), *enc)

    return prefill_step


def decode_cache_specs(run: RunConfig):
    """The decode cache of this shape cell (batch ``global_batch``, length
    ``seq_len``, bf16 buffers as in the JAX package) on the meta device:
    shapes and dtypes, no memory."""
    return T.init_cache(run.model, run.shape.global_batch, run.shape.seq_len,
                        device="meta")


def make_decode_step(run: RunConfig, device="cuda"):
    """step(params, cache, tokens [B, 1], pos, encoder_out=None) ->
    (logits [B, vocab], the new cache): one token at position ``pos`` (an
    int) for every sequence, under inference mode, on ``params`` cast to
    the compute dtype on every call as in ``make_prefill_step``.
    Attention buffers are written in place (``pos`` must lie inside them);
    mamba states are replaced.  An encoder-decoder needs ``encoder_out``,
    its prefill step's third value."""
    cfg = run.model
    dev = resolve_device(device)
    cdtype = dtype_of(run.compute_dtype)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos, encoder_out=None):
        tokens = torch.as_tensor(tokens, device=dev)
        return api.decode_step(cast_params(params, cdtype), cache, tokens,
                               pos, cfg, encoder_out=encoder_out)

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


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, as it computes it: the
    exponentials of ``x - max`` over their sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _temperature(temperature: float, like: torch.Tensor) -> torch.Tensor:
    # a device tensor: a card divides a float by a host scalar through its
    # reciprocal, which rounds differently
    return torch.full((), temperature, dtype=f32, device=like.device)


def make_unified_paged_step(cfg: ModelConfig, *, temperature: float = 0.0,
                            bank_masks=None):
    """THE serving step: one call per engine tick, whatever the tick holds
    (decode tokens, prompt chunks and speculative verify chunks packed into
    [B, C]).  Appends every token's K/V to the pools in place, runs paged
    attention over them and samples (or verifies) the next token of each
    slot on the device.  Idle slots and mid-prompt chunks produce tokens
    the engine discards.

    step(params, cache, tokens [B, C], starts [B], chunk_lens [B],
         block_tables [B, maxp], req_ids [B], sample_steps [B],
         submodel_ids [B], seg_ids [B], vote_flags [B], draft_lens [B],
         draft_probs [B, S_v - 1, Vq], root_key [2], *, ensembles=False)
      -> (sampled [B] int32, accepted [B] int32)

    Greedy (argmax, ties to the first index) when ``temperature <= 0``;
    otherwise a categorical draw of ``logits / temperature`` with the key
    ``fold_in(fold_in(root_key, req_id), sample_step)`` of each slot
    (``core/prng.py``, the JAX package's threefry keys), so no key is
    reused across requests or steps.

    Speculative verify (``draft_lens``, ``draft_probs``): a speculating
    slot's chunk is [pending token, d_1 .. d_dl], the drafts a draft
    circuit proposed, and the step scores a window of S_v =
    ``draft_probs.shape[1] + 1`` positions a slot in the same call: left-
    aligned on the chunk for a speculating slot, right-aligned on the last
    valid position for the others, so their position S_v - 1 is the
    classic sampling position.  Greedy accepts the longest prefix of drafts
    equal to the parent's argmax and emits the parent's token after it (the
    correction, or the bonus token when every draft matched).  At
    temperature > 0 it is rejection sampling against the draft's
    distribution q: draft j is accepted when ``u * q_j(d_j) < p_j(d_j)``,
    ``u`` the uniform of ``fold_in(fold_in(kb, step + j), 1)`` (``kb`` the
    request's key); at the first rejection the token is drawn from
    ``norm(max(p - q, 0))`` (p itself when that vanishes) under salt 2 of
    the bonus key ``fold_in(kb, step + accepted)``.  ``accepted[b]`` drafts
    are good and ``sampled[b]`` is the verified token after them; a slot
    that does not speculate reports 0.  The non-speculative engine passes
    S_v == 1 (``draft_probs`` [B, 0, 1]), which is the classic sampling
    path bit for bit.

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
    same token either way.  Ticks without an ensemble skip the combine;
    ensemble members never speculate, and a speculating slot's verdict
    stands beside the combine.
    """
    def pick(noise, logits, temp):
        if noise is None:
            return torch.argmax(logits, dim=-1)
        return prng.categorical_with(noise, logits.to(f32) / temp)

    zeros = {}

    def no_drafts(like):
        """A [B] int32 zero tensor made once per batch width and device, so
        a tick without drafts launches nothing for its ``accepted``."""
        key = (like.shape[0], like.device)
        if key not in zeros:
            zeros[key] = torch.zeros(like.shape[0], dtype=torch.int32,
                                     device=like.device)
        return zeros[key]

    def plain_noise(root_key, req_ids, sample_steps, V):
        keys = prng.fold_in(prng.fold_in(root_key, req_ids), sample_steps)
        return prng.gumbel(keys, (V,))

    def verify(logits_w, tokens, draft_lens, draft_probs, req_ids,
               sample_steps, root_key, noise, temp):
        """(sampled [B], accepted [B]) of every slot against its window
        ``logits_w`` [B, S_v, V]: position j holds the parent's
        distribution of the token after chunk position j.  ``noise``: the
        classic draw's Gumbel noise at T > 0, which S_v == 1 uses; ``temp``
        the temperature as a device tensor."""
        B, S_v, V = logits_w.shape
        if S_v == 1:                     # no drafts anywhere: classic
            return pick(noise, logits_w[:, 0], temp), no_drafts(draft_lens)
        rows = torch.arange(B, device=logits_w.device)
        dl = draft_lens.long()
        drafts = tokens[:, 1:S_v].long()                   # [B, S_v - 1]
        jj = torch.arange(S_v - 1, device=logits_w.device)
        live = jj[None, :] < dl[:, None]
        if temperature <= 0:
            tgt = torch.argmax(logits_w, dim=-1)           # [B, S_v]
            ok = (tgt[:, :S_v - 1] == drafts) & live
            acc = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)
            # acc accepted drafts put the decision at window position acc:
            # the correction when acc < dl, the bonus when acc == dl
            at = torch.where(dl > 0, acc, S_v - 1)
            return tgt[rows, at], acc
        lw = logits_w.to(f32) / temp
        kb = prng.fold_in(root_key, req_ids)               # [B, 2]
        p_w = _softmax(lw)                                 # [B, S_v, V]
        # the accept-uniform of draft j folds in the step the token would
        # take (sample_step + j), then salt 1: never the key of the
        # categorical draw at that step (no salt) or of the resample (2)
        ukeys = prng.fold_in(prng.fold_in(
            kb[:, None], sample_steps.long()[:, None] + jj[None, :]), 1)
        u = prng.uniform(ukeys)                            # [B, S_v - 1]
        pd = torch.gather(p_w[:, :S_v - 1], 2, drafts[..., None])[..., 0]
        qd = torch.gather(draft_probs, 2, drafts[..., None])[..., 0]
        ok = (u * torch.clamp(qd, min=1e-30) < pd) & live
        acc = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)
        rejected = (dl > 0) & (acc < dl)
        at = torch.where(dl > 0, acc, S_v - 1)
        # the bonus (and plain) draw: the classic (req_id, step) key on the
        # scaled logits at the decision's position
        kp = prng.fold_in(kb, sample_steps.long() + torch.where(
            dl > 0, at, 0))
        bonus = prng.categorical(kp, lw[rows, at])
        # the rejection resample from norm(max(p - q, 0)) at the first
        # rejected position, p itself where that residual vanishes
        ridx = torch.clamp(at, max=S_v - 2)
        p_r = p_w[rows, ridx]
        res = torch.clamp(p_r - draft_probs[rows, ridx], min=0.0)
        res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_r)
        rtok = prng.categorical(prng.fold_in(kp, 2),
                                torch.log(torch.clamp(res, min=1e-30)))
        return torch.where(rejected, rtok, bonus), acc

    def combine(logits_w, draft_lens, seg_ids, vote_flags, noise, temp):
        """Each ensemble's token from its members' logits at their last
        valid position (mean-logit or majority vote)."""
        B, S_v, V = logits_w.shape
        if S_v == 1:
            lf = logits_w[:, 0].to(f32)
        else:                            # a speculating slot's row 0
            rows = torch.arange(B, device=logits_w.device)
            lf = logits_w[rows, torch.where(draft_lens > 0, 0, S_v - 1)
                          ].to(f32)
        seg = seg_ids.long()
        counts = torch.zeros(B, dtype=f32, device=lf.device).index_add_(
            0, seg, torch.ones(B, dtype=f32, device=lf.device))
        mean = _segment_sum(lf, seg) / torch.clamp(counts, min=1.0)[:, None]
        mean_tok = pick(noise, mean[seg], temp)
        own_tok = pick(noise, lf, temp)
        votes = torch.zeros_like(lf).index_add_(
            0, seg, torch.nn.functional.one_hot(own_tok, V).to(f32))
        vote_tok = torch.argmax(votes, dim=-1)[seg]
        return torch.where(vote_flags.bool(), vote_tok, mean_tok)

    @torch.inference_mode()
    def step(params, cache, tokens, starts, chunk_lens, block_tables,
             req_ids, sample_steps, submodel_ids, seg_ids, vote_flags,
             draft_lens, draft_probs, root_key, *, ensembles: bool = False):
        C = tokens.shape[1]
        S_v = draft_probs.shape[1] + 1
        serve_masks = None
        if bank_masks is not None:
            serve_masks = {k: m.index_select(0, submodel_ids)
                           for k, m in bank_masks.items()}
        cl = chunk_lens.long()[:, None]
        if S_v == 1:
            widx = torch.clamp(cl - 1, 0, C - 1)
        else:
            j = torch.arange(S_v, device=tokens.device)[None, :]
            widx = torch.where(draft_lens.long()[:, None] > 0,
                               torch.minimum(j, torch.clamp(cl - 1, min=0)),
                               torch.clamp(cl - S_v + j, 0, C - 1))
        logits_w, _ = api.paged_step(params, cache, tokens, starts,
                                     chunk_lens, block_tables, cfg,
                                     logit_index=widx,
                                     serve_masks=serve_masks)
        combined = ensembles and bank_masks is not None
        noise = temp = None
        if temperature > 0:
            temp = _temperature(temperature, logits_w)
            if S_v == 1 or combined:
                # the classic (req_id, step) draw's noise, drawn once for
                # the plain sample and the ensemble combine
                noise = plain_noise(root_key, req_ids, sample_steps,
                                    logits_w.shape[-1])
        sampled, accepted = verify(logits_w, tokens, draft_lens,
                                   draft_probs, req_ids, sample_steps,
                                   root_key, noise, temp)
        if combined:
            sampled = torch.where(draft_lens > 0, sampled, combine(
                logits_w, draft_lens, seg_ids, vote_flags, noise, temp))
            accepted = torch.where(draft_lens > 0, accepted, 0)
        return sampled.to(torch.int32), accepted.to(torch.int32)

    return step


def make_draft_spec_step(cfg: ModelConfig, *, k: int,
                         temperature: float = 0.0, draft_salt: int = 0x5bec):
    """One *draft tick* of speculative decoding: catch the draft circuit
    up on each slot's committed stream, then propose ``k`` tokens a slot.

    step(params, cache, tokens [B, C], starts [B], chunk_lens [B],
         block_tables [B, maxp], req_ids [B], sample_steps [B], root_key)
      -> (drafts [B, k] int32, draft_probs [B, k, Vq] f32)

    ``tokens`` is the catch-up chunk: the committed tokens whose K/V the
    draft has not written yet, ending with the pending token, so the
    chunk's last-position logits propose d_1.  The other k - 1 proposals
    are C == 1 paged steps that feed each draft back in (the JAX step's
    ``lax.scan``; here a loop of eager calls), appending the K/V of d_1 ..
    d_{k-1} to the draft's own pools as they go (d_k's is written by the
    next catch-up, like the engine's pending token).  Slots with
    ``chunk_lens`` 0 do not draft: they take no key in the C == 1 steps
    (their decode lengths are 0), so nothing of theirs is read or written.

    Greedy drafts are the argmax and ``draft_probs`` is a [B, k, 1]
    dummy; at temperature > 0 each proposal is a categorical draw under
    the draft's own key chain (``fold_in(root_key, draft_salt)``, then
    (req_id, sample_step + i)), independent of every draw of the verify,
    and ``draft_probs`` holds the full softmax q_i the rejection sampler
    needs."""
    def sample(logits, req_ids, steps, droot):
        lf = logits.to(f32)
        if temperature > 0:
            keys = prng.fold_in(prng.fold_in(droot, req_ids), steps)
            lw = lf / _temperature(temperature, lf)
            return prng.categorical(keys, lw), _softmax(lw)
        return torch.argmax(lf, dim=-1), lf.new_zeros(lf.shape[:-1] + (1,))

    @torch.inference_mode()
    def step(params, cache, tokens, starts, chunk_lens, block_tables,
             req_ids, sample_steps, root_key):
        droot = prng.fold_in(root_key, draft_salt)
        logits, _ = api.paged_step(params, cache, tokens, starts, chunk_lens,
                                   block_tables, cfg)
        tok, q = sample(logits, req_ids, sample_steps, droot)
        drafts, probs = [tok], [q]
        pos = starts + chunk_lens
        live = (chunk_lens > 0).to(torch.int32)
        for i in range(1, k):
            logits, _ = api.paged_step(
                params, cache, tok.to(torch.int32)[:, None], pos, live,
                block_tables, cfg)
            tok, q = sample(logits, req_ids, sample_steps + i, droot)
            drafts.append(tok)
            probs.append(q)
            pos = pos + 1
        return (torch.stack(drafts, 1).to(torch.int32),
                torch.stack(probs, 1))

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
