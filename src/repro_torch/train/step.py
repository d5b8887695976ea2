"""Train and eval steps (port of ``repro.train.step``): loss and gradients,
micro-batch accumulation, AdamW, and the non-finite skip-step.

The train state is ``{"params": tree, "opt": {"m", "v", "step"[,
"master"]}[, "compress": {"err": tree}]}`` of device tensors.
``train_step(state, batch)`` updates it in place and returns ``(state,
metrics)`` with 0-dim device tensors as metrics: nothing is read back to
the host, so the caller decides when to synchronise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import model
from repro_torch.models.config import ModelCfg
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compress import Compressor


def init_train_state(cfg: ModelCfg, opt: AdamW, generator: torch.Generator,
                     compressor: Optional[Compressor] = None,
                     device=None) -> dict:
    """Random params drawn from ``generator`` (on ``device``; ``None``
    means cuda) and the optimizer state, each tree packed into one buffer
    (``tree.pack``) so the update and the skip-step run on whole vectors
    without concatenating the leaves; with a ``compressor`` other than
    ``none``, its error-feedback state too."""
    params = tree.pack(model.init_params(cfg, generator, device))
    state = {"params": params, "opt": opt.init(params)}
    if compressor is not None and compressor.codec != "none":
        state["compress"] = compressor.init(params)
    return state


def loss_and_grads(cfg: ModelCfg, params, batch):
    """(metrics, grads) of ``model.loss_fn`` at ``params``."""
    live = tree.map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree.leaves(live))
    it = iter(grads)
    return metrics, tree.map(lambda _: next(it), live)


def make_train_step(cfg: ModelCfg, opt: AdamW,
                    compressor: Optional[Compressor] = None,
                    nan_guard: bool = True):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``cfg.grad_accum > 1`` splits the batch micro-batch-major (micro-batch
    ``i`` takes rows ``i, i + accum, ...``, as the reference lays it out)
    and sums the gradients with Kahan compensation, so the mean stays
    within an ulp of the exact sum whatever ``accum`` is.

    ``nan_guard=True`` adds the skip-step: when the loss or the gradient
    norm is not finite, every state tensor keeps its old value (selected
    on the device with a 0-dim ``ok`` flag, no host sync) and
    ``metrics["nonfinite"]`` is 1.

    A ``"_fault_poison"`` batch key (a float scalar) multiplies the
    gradients and the loss metric by NaN when nonzero; it is removed before
    the batch reaches the model.

    With a ``compressor`` and a ``"compress"`` entry in the state, the
    gradients go through its lossy round trip (error feedback) before the
    optimizer update; the skip-step keeps the error state too."""
    accum = max(cfg.grad_accum, 1)

    def grads_of(params, batch):
        if accum == 1:
            return loss_and_grads(cfg, params, batch)
        gsum = gcomp = msum = None
        for i in range(accum):
            micro = {k: v.reshape(v.shape[0] // accum, accum,
                                  *v.shape[1:])[:, i] for k, v in batch.items()}
            m, g = loss_and_grads(cfg, params, micro)
            if gsum is None:
                gsum, msum = g, m
                gcomp = tree.map(torch.zeros_like, g)
                continue
            y = tree.map(torch.sub, g, gcomp)
            t = tree.map(torch.add, gsum, y)
            gcomp = tree.map(lambda t_, s, y_: (t_ - s) - y_, t, gsum, y)
            gsum = t
            msum = {k: msum[k] + m[k] for k in msum}
        return ({k: v / accum for k, v in msum.items()},
                tree.map(lambda g: g / accum, gsum))

    def train_step(state, batch):
        batch = dict(batch)
        poison = batch.pop("_fault_poison", None)
        params = state["params"]
        metrics, grads = grads_of(params, batch)
        if poison is not None:
            dev = metrics["loss"].device
            nanify = torch.where(torch.as_tensor(poison, device=dev) != 0,
                                 torch.tensor(float("nan"), device=dev),
                                 torch.tensor(1.0, device=dev))
            grads = tree.map(lambda g: g * nanify.to(g.dtype), grads)
            metrics = dict(metrics, loss=metrics["loss"] * nanify)
        new = {}
        if "compress" in state and compressor is not None:
            grads, new["compress"] = compressor.compress_decompress(
                grads, state["compress"])
        new_params, new_opt, om = opt.update(grads, state["opt"], params)
        metrics = dict(metrics, **om)
        new.update(params=new_params, opt=new_opt)
        ok = None
        if nan_guard:
            ok = (torch.isfinite(metrics["loss"])
                  & torch.isfinite(om["grad_norm"]))
            metrics["nonfinite"] = (~ok).float()
        _copy_in(state, new, ok)
        return state, metrics

    return train_step


@torch.no_grad()
def _copy_in(state, new, ok) -> None:
    """Copy ``new`` into ``state``, or (``ok`` a 0-dim bool on the device)
    ``where(ok, new, old)``: a bad step then leaves every state tensor
    bitwise unchanged, without a host sync.  Each of the params, the
    moments and the master copy is selected as one vector (its packed
    buffer, see ``tree.pack``, or a concatenation) and copied back in one
    go, and so is a compressor's error state."""
    for key in sorted(new["opt"]):
        _copy_vec(tree.leaves(state["opt"][key]),
                  tree.leaves(new["opt"][key]), ok)
    _copy_vec(tree.leaves(state["params"]), tree.leaves(new["params"]), ok)
    if "compress" in new and new["compress"]:
        _copy_vec(tree.leaves(state["compress"]),
                  tree.leaves(new["compress"]), ok)


def _copy_vec(olds, news, ok) -> None:
    buf = tree.packed(olds)
    old = buf if buf is not None else tree.flat(olds)
    fresh = tree.flat(news).to(old.dtype)
    sel = fresh if ok is None else torch.where(ok, fresh, old)
    if buf is not None:
        buf.copy_(sel)
    else:
        torch._foreach_copy_(olds, tree.unflat(sel, olds))


def make_eval_step(cfg: ModelCfg):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model.loss_fn(cfg, params, batch)
        return metrics
    return eval_step
