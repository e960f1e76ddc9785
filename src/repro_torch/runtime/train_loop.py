"""Training step factory (the reference's ``runtime/train_loop.py``): the
loss's gradient, gradient accumulation over microbatches, optional int8
error-feedback compression, global-norm clipping, the LR schedule and
AdamW.

The state is a plain dict ``{"params", "opt", ("err")}`` as in the
reference: float32 master parameters (leaves that require grad), the
AdamW moments and step, and the compression error.  A step updates it in
place and returns it (the reference returns a new state; one card would
hold the 2.7B-parameter model's 43.6 GB twice).  Microbatch gradients
accumulate into each parameter's ``.grad`` (summed, then divided by the
count, as the reference's scan does), so no second gradient buffer
exists.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.kernels import charged_unit
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     init_opt_state)
from repro_torch.optim.grad_compress import (compress_tree, decompress_tree,
                                             init_error)
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.parallel.param_sharding import owns, shard_params
from repro_torch.tree import leaves, unflatten_like

State = Dict[str, Any]
Batch = Mapping[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_state(model, generator: torch.Generator,
               tcfg: TrainConfig) -> State:
    """Parameters from ``model.init`` in ``cfg.param_dtype`` (the float32
    masters), requiring grad; zero AdamW moments; the compression error
    when ``tcfg.grad_compress``."""
    params = model.init(generator, dtype=_DTYPES[model.cfg.param_dtype])
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params)}
    if tcfg.grad_compress:
        state["err"] = init_error(params)
    return state


def batch_to(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) on ``device``: token ids as
    int64, the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def loss_fn(model, cfg: ArchConfig, params, batch: Batch) -> torch.Tensor:
    """The model's training loss on a batch of tensors: whisper takes the
    batch's ``frames``, the VLM its ``patch_embeds`` in front."""
    if cfg.family == "audio":
        return model.train_loss(params, batch["tokens"], batch["labels"],
                                batch["frames"])
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["extra_embeds"] = batch["patch_embeds"]
    return model.train_loss(params, batch["tokens"], batch["labels"],
                            **kwargs)


@charged_unit
def _learning_rate(schedule, step: torch.Tensor,
                   device: torch.device) -> torch.Tensor:
    """The step's learning rate, a 0-dim float32 on ``device``: the
    schedule runs on the host from the step's value (bookkeeping an op
    profiler charges nothing).  A ``meta`` step has no value to read, and
    its rate is a ``meta`` stand-in."""
    if step.device.type == "meta":
        return torch.empty((), dtype=torch.float32, device=step.device)
    return schedule(step.cpu()).to(device)


def make_train_step(model, cfg: ArchConfig, tcfg: TrainConfig
                    ) -> Callable[[State, Batch],
                                  Tuple[State, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``: metrics ``loss``
    (the microbatches' mean), ``grad_norm`` (before clipping), ``lr`` and
    ``step`` (after the update), 0-dim tensors on the model's device."""
    if tcfg.schedule == "wsd":
        schedule = partial(SCHEDULES["wsd"], peak_lr=tcfg.lr,
                           total_steps=tcfg.steps,
                           warmup_steps=tcfg.warmup_steps,
                           decay_frac=tcfg.decay_frac)
    else:
        schedule = partial(SCHEDULES[tcfg.schedule], peak_lr=tcfg.lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.steps)

    def train_step(state: State, batch: Batch):
        params = state["params"]
        plist = leaves(params)
        batch = batch_to(batch, plist[0].device)
        sp = model.spmd("train", next(iter(batch.values())).shape[0]) \
            if hasattr(model, "spmd") else None
        if sp is not None:
            return _sharded_step(model, cfg, tcfg, schedule, sp, state,
                                 batch)
        mb = tcfg.microbatches
        for p in plist:
            p.grad = None
        if mb > 1:
            # gradient accumulation over leading-batch microslices; the
            # reference reshapes to (mb, b // mb, ...), so a batch that
            # does not split into mb equal slices is refused, not cut
            sizes = {k: v.shape[0] for k, v in batch.items()}
            b = next(iter(sizes.values()))
            if len(set(sizes.values())) != 1:
                raise ValueError(
                    f"batch leaves disagree on their leading size: {sizes}")
            if b % mb:
                raise ValueError(f"microbatches={mb} does not divide the "
                                 f"batch of {b}")
            loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
            for i in range(mb):
                micro = {k: v[i * (b // mb):(i + 1) * (b // mb)]
                         for k, v in batch.items()}
                part = loss_fn(model, cfg, params, micro)
                part.backward()
                loss = loss + part.detach()
            loss = loss / mb
        else:
            loss = loss_fn(model, cfg, params, batch)
            loss.backward()
            loss = loss.detach()
        grads = []
        for p in plist:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            if mb > 1:
                g.div_(mb)
            grads.append(g)
        grads = unflatten_like(params, grads)

        if tcfg.grad_compress and "err" in state:
            # int8 + error feedback, quantised and dequantised in place of
            # the all-reduce's payload, one scale for the layers the
            # reference stacks into one leaf
            groups = model.stacked_groups(params) \
                if hasattr(model, "stacked_groups") else None
            q, scales, state["err"] = compress_tree(grads, state["err"],
                                                    groups)
            grads = decompress_tree(q, scales)

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = _learning_rate(schedule, state["opt"]["step"],
                            plist[0].device)
        adamw_update(params, grads, state["opt"], lr=lr, b1=tcfg.b1,
                     b2=tcfg.b2, eps=tcfg.eps,
                     weight_decay=tcfg.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": state["opt"]["step"]}
        return state, metrics

    return train_step


def _microbatches(batch: Dict[str, torch.Tensor], mb: int):
    """The batch's ``mb`` leading-row slices; refuses leaves of unequal
    leading size and a batch ``mb`` does not divide (the reference
    reshapes to (mb, b // mb, ...))."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    b = next(iter(sizes.values()))
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"batch leaves disagree on their leading size: {sizes}")
    if b % mb:
        raise ValueError(f"microbatches={mb} does not divide the "
                         f"batch of {b}")
    return [{k: v[i * (b // mb):(i + 1) * (b // mb)]
             for k, v in batch.items()} for i in range(mb)]


def _block_of(sp, x: torch.Tensor, spec, k: int) -> torch.Tensor:
    """Position ``k``'s block of a state tensor: a view where it lives on
    the position's device, else a copy on it."""
    view = sp.block(x, spec, k, copy=False)
    return view if view.device == sp.device(k) else \
        view.to(sp.device(k), copy=True)


def _sharded_step(model, cfg: ArchConfig, tcfg: TrainConfig, schedule,
                  sp, state: State, batch: Dict[str, torch.Tensor]):
    """The train step under a mesh: each position holds its blocks of
    the parameters as leaves of their own (``shard_params``; FSDP-only
    under ``attn_seq_shard``), each microbatch's rows go over the batch
    axes (and, under ``attn_seq_shard``, each row's sequence over
    ``model``, ``train_loss_sharded``) and its loss runs sharded
    (``train_loss_sharded``: the weights all-gathered at each use and
    their gradients reduce-scattered back to the shard), the clip's
    global norm is a ``psum`` of the positions' sums of squares over the
    blocks they own, and AdamW updates each block once, on the position
    that owns it (its replicas hold the same block and the same gradient,
    and are dropped after the step), with its blocks of the moments.  The
    parameter blocks are written back to the state's tensors; the
    moments are updated in place where the position's device holds them
    (on a mesh of ``meta`` entries every block is a view).  Whisper's
    frames and the VLM's patch embeddings go with their rows."""
    if tcfg.grad_compress:
        raise NotImplementedError(
            "grad_compress under a mesh: the sharded step reduce-"
            "scatters full-precision gradients")
    params = state["params"]
    P = shard_params(sp, params, as_leaves=True)
    mb = tcfg.microbatches
    loss = None
    for micro in _microbatches(batch, mb):
        rows = {k: model._rows(sp, v) for k, v in micro.items()}
        extra = rows.get("frames") if cfg.family == "audio" else \
            rows.get("patch_embeds")
        part = model.train_loss_sharded(
            sp, P, rows["tokens"], rows["labels"], extra, rows.get("mask"))
        part.backward()
        loss = part.detach() if loss is None else loss + part.detach()
    loss = loss / mb
    specs = [tuple(ns.spec) for ns in leaves(P.specs)]
    blocks = [leaves(b) for b in P.blocks]
    grads = []
    for k in range(sp.n):
        gk = []
        for x, spec in zip(blocks[k], specs):
            if not owns(sp, spec, k):        # a replica: no gradient
                gk.append(None)
                continue
            g = x.grad if x.grad is not None else torch.zeros_like(x)
            x.grad = None
            gk.append(g.div_(mb) if mb > 1 else g)
        grads.append(gk)
    sq = [sum((torch.sum(torch.square(g.to(torch.float32)))
               for g, spec in zip(grads[k], specs) if owns(sp, spec, k)),
              torch.zeros((), device=sp.device(k))) for k in range(sp.n)]
    norm = torch.sqrt(sp.unreplicate(sp.psum(sq, sp.mesh.axis_names)))
    scale = torch.clamp(tcfg.grad_clip / torch.clamp(norm, min=1e-9),
                        max=1.0)
    lr = _learning_rate(schedule, state["opt"]["step"],
                        leaves(params)[0].device)
    step = state["opt"]["step"]
    trees = [leaves(params), leaves(state["opt"]["m"]),
             leaves(state["opt"]["v"])]
    with torch.no_grad():
        for k in range(sp.n):
            mine = [i for i, spec in enumerate(specs) if owns(sp, spec, k)]
            g = [grads[k][i].mul_(scale.to(grads[k][i].device,
                                           grads[k][i].dtype))
                 for i in mine]
            # the moments' blocks: views where the position's device holds
            # the state, else copies written back after the update
            m, v = ([_block_of(sp, t[i], specs[i], k) for i in mine]
                    for t in trees[1:])
            opt = {"m": m, "v": v, "step": step}
            adamw_update([blocks[k][i] for i in mine], g, opt,
                         lr=lr.to(sp.device(k)), b1=tcfg.b1, b2=tcfg.b2,
                         eps=tcfg.eps, weight_decay=tcfg.weight_decay)
            if not sp.one_position:
                for tree, per_pos in zip(trees, ([blocks[k][i] for i in mine],
                                                 m, v)):
                    for i, x in zip(mine, per_pos):
                        view = sp.block(tree[i], specs[i], k, copy=False)
                        if view.untyped_storage()._cdata != \
                                x.untyped_storage()._cdata:
                            view.copy_(x)
            grads[k] = None
        state["opt"]["step"] = opt["step"]
    metrics = {"loss": loss, "grad_norm": norm, "lr": lr,
               "step": state["opt"]["step"]}
    return state, metrics


def train_loop(model, cfg: ArchConfig, tcfg: TrainConfig, data_iter,
               state: Optional[State] = None,
               generator: Optional[torch.Generator] = None,
               hooks=()) -> Tuple[State, list]:
    """Host loop used by the example and the tests: from ``state`` (or a
    fresh one from ``generator``, default seeded with ``tcfg.seed`` on
    the model's device) to ``tcfg.steps``; the history holds each step's
    metrics as Python numbers; ``hooks`` get (step, state, metrics)."""
    if state is None:
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(
                tcfg.seed)
        state = init_state(model, generator, tcfg)
    step_fn = make_train_step(model, cfg, tcfg)
    history = []
    start = int(state["opt"]["step"])
    for step in range(start, tcfg.steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        for h in hooks:
            h(step, state, history[-1])
    return state, history


__all__ = ["batch_to", "init_state", "loss_fn", "make_train_step",
           "train_loop"]
