"""Step functions shared by the trainer and the server (the port of
``repro/launch/steps.py``).

The reference's train step is one pure jitted function that the driver
retries whole.  Here the training state is updated in place (at
phi4-mini's full size a second copy of the 46 GB state does not fit the
card), so a step has two parts: :meth:`TrainStep.loss_and_grads`, which
mutates nothing and may be retried, and :meth:`TrainStep.apply`, the
optimizer's commit, which runs once.  A batch is {"tokens": (B, S)} plus,
for a model with a frontend, its inputs (``frame_embed`` / ``patch_embed``),
which travel with the tokens into the loss and into a prefill
(``repro/launch/steps.py:73-78``).

On a mesh (installed in ``meshctx`` before the step is built) the params,
grads and moments are this rank's shards (``tp_shardings``) and the batch
is its rows.  Each rank's loss is the mean over its rows, and the ranks
hold equal rows, so the global loss is the mean of the ranks' losses:
:meth:`TrainStep.loss_and_grads` returns that mean and the gradients of
it.  A leaf replicated over data gets the mean of the ranks' gradients
(one ``all_reduce`` a leaf, in the gradient's dtype, as the reference's
psum); an FSDP leaf's gradient is already the ranks' sum (the gather's
reduce-scatter) and is divided by the data size.  The optimizer's norm
is taken over every rank's shards.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import meshctx
from repro_torch.distributed.collectives import all_reduce_, data_mean
from repro_torch.distributed.sharding import spec_axes, tp_shardings
from repro_torch.nn.model import Model
from repro_torch.optim.adamw import AdamW, OptState, tree_items, tree_map


class TrainState(NamedTuple):
    params: Dict
    opt: OptState
    step: int


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


class TrainStep:
    """One training step of ``model`` under ``optimizer``; ``microbatches``
    > 1 accumulates each micro-batch's gradients (in the param dtype) into
    an f32 buffer, as ``steps.py:38-56`` (on a data axis, micro-batch i is
    each rank's i-th block of its rows)."""

    def __init__(self, model: Model, optimizer: AdamW, microbatches: int = 1):
        self.model, self.optimizer = model, optimizer
        self.microbatches = microbatches
        mesh = meshctx.get_mesh()
        self.specs = tp_shardings(model, mesh) if mesh is not None else None

    def _data_mean(self, loss: torch.Tensor, grads: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
        """The loss and the gradients averaged over the data axis (module
        docstring); as they are with no data axis."""
        ax = meshctx.data_axis()
        if ax is None:
            return loss, grads
        specs = dict(tree_items(self.specs))
        out = {}
        for path, g in tree_items(grads):
            if "data" in spec_axes(specs[path]):
                out[path] = g.div(ax.size)
            else:
                out[path] = all_reduce_(g, ax.group).div_(ax.size)
        return data_mean(loss, ax.group, ax.size), _unflatten(out)

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch on the model's device: tokens int64, the frontend's
        inputs as they are."""
        out = {}
        for name, t in batch.items():
            if isinstance(t, np.ndarray):
                t = torch.from_numpy(t)
            out[name] = (t.to(device=self.model.device, dtype=torch.int64)
                         if name == "tokens" else t.to(self.model.device))
        return out

    def _value_and_grad(self, params: Dict, batch: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict]:
        paths, leaves = zip(*tree_items(params))
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = self.model.loss(_unflatten(dict(zip(paths, live))), batch)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), _unflatten(dict(zip(paths, grads)))

    def loss_and_grads(self, params: Dict, batch: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
        """(the f32 loss, the grads in the param dtype); mutates nothing."""
        batch = self._batch(batch)
        n = self.microbatches
        if n == 1:
            return self._data_mean(*self._value_and_grad(params, batch))
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} does not split into "
                             f"{n} micro-batches")
        loss_sum, gacc = None, None
        for i in range(n):
            micro = {name: t.reshape(n, -1, *t.shape[1:])[i]
                     for name, t in batch.items()}
            loss, g = self._value_and_grad(params, micro)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if gacc is None:
                gacc = tree_map(lambda t: t.float(), g)
            else:
                for (_, a), (_, b) in zip(tree_items(gacc), tree_items(g)):
                    a.add_(b.float())
        grads = _unflatten({
            path: (a / n).to(p.dtype)
            for (path, a), (_, p) in zip(tree_items(gacc),
                                         tree_items(params))})
        return self._data_mean(loss_sum / n, grads)

    def apply(self, state: TrainState, loss: torch.Tensor, grads: Dict
              ) -> Tuple[TrainState, Dict]:
        """The optimizer's commit, in place on the params and moments."""
        opt, om = self.optimizer.update(grads, state.opt, state.params,
                                        self.specs)
        return (TrainState(params=state.params, opt=opt, step=state.step + 1),
                {"loss": loss, **om})

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict]:
        return self.apply(state, *self.loss_and_grads(state.params, batch))


def make_train_step(model: Model, optimizer: AdamW, microbatches: int = 1
                    ) -> TrainStep:
    """The train step of a model of any family (dense, MoE, SSM, hybrid,
    audio, vlm: ``nn/config.py``'s, all ported)."""
    return TrainStep(model, optimizer, microbatches)


def make_serve_step(model: Model) -> Callable:
    def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                   pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return model.decode_step(params, cache, tokens, pos)
    return serve_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params: Dict, batch: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return model.prefill(params, batch["tokens"], extras=extras or None)
    return prefill_step
