"""AdamW with global-norm clipping (the port of ``repro/optim/adamw.py``).

Moments are kept in f32 whatever the param dtype (bf16 params + f32 state,
as in the reference).  The reference is functional; here the update runs
leaf by leaf in place (params, moments), so a step needs no second copy of
the training state: at phi4-mini's full size the state is 46 GB of the
card's 80.  The arithmetic and its order are the reference's
(``adamw.py:43-76``); the leaves are visited in the reference's order
(sorted keys, as ``jax.tree_util`` flattens a dict).

On a mesh each rank updates its own shards (the moments mirror the params'
specs, ``opt_shardings``): the update is elementwise, and only the
clipping norm needs every rank's leaves (:func:`global_norm` with
``specs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import meshctx
from repro_torch.optim.schedule import Schedule


class OptState(NamedTuple):
    m: Dict
    v: Dict
    count: int


def tree_items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict, keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def tree_map(fn, tree: Dict) -> Dict:
    return {k: (tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def global_norm(tree: Dict, specs: Optional[Dict] = None) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares; a 0-dim f32 tensor.

    ``specs`` (a tree like ``tree``): the leaves are this rank's shards on
    the installed mesh.  Each shard's sum of squares
    is summed over the axes its leaf is sharded on (one ``all_reduce`` a
    set of axes, leaves grouped by it); a replicated leaf counts once.
    Every rank gets the same norm."""
    if specs is None:
        total = None
        for _, x in tree_items(tree):
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)
    from repro_torch.distributed.collectives import all_reduce_
    from repro_torch.distributed.sharding import spec_axes
    mesh = meshctx.get_mesh()
    flat_specs = dict(tree_items(specs))
    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, x in tree_items(tree):
        axes = tuple(a for a in spec_axes(flat_specs[path])
                     if mesh.shape[a] > 1)
        s = torch.sum(torch.square(x.float()))
        parts[axes] = s if axes not in parts else parts[axes] + s
    total = None
    for axes in sorted(parts):
        s = parts[axes].reshape(1)
        for a in axes:
            s = all_reduce_(s, mesh.group(a))
        total = s[0] if total is None else total + s[0]
    return torch.sqrt(total)


@dataclass(frozen=True)
class AdamW:
    lr: Union[float, Schedule] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Dict) -> OptState:
        zeros = lambda t: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), t)
        return OptState(m=zeros(params), v=zeros(params), count=0)

    def update(self, grads: Dict, state: OptState, params: Dict,
               specs: Optional[Dict] = None) -> Tuple[OptState, Dict]:
        """Apply one step in place to ``params`` and the moments of
        ``state``; returns (the new state, metrics {"grad_norm", "lr"}).
        ``specs``: the leaves are this rank's shards under the installed
        mesh (the norm is taken over every rank's)."""
        count = state.count + 1
        gnorm = global_norm(grads, specs)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        else:
            scale = torch.ones_like(gnorm)
        lr = self.lr(count) if callable(self.lr) else float(
            torch.tensor(self.lr, dtype=torch.float32))
        c = torch.tensor(count, dtype=torch.float32)
        b1c = float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        b2c = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        flat_m, flat_v = dict(tree_items(state.m)), dict(tree_items(state.v))
        with torch.no_grad():
            for path, g in tree_items(grads):
                p = _leaf(params, path)
                m, v = flat_m[path], flat_v[path]
                g32 = g.to(torch.float32, copy=True).mul_(scale)
                m.mul_(self.b1).add_(g32, alpha=1 - self.b1)
                v.mul_(self.b2).add_(g32.square_(), alpha=1 - self.b2)
                # step = (m / b1c) / (sqrt(v / b2c) + eps) + wd p, in g32
                den = torch.div(v, b2c, out=g32).sqrt_().add_(self.eps)
                step = torch.div(m, b1c).div_(den)
                del den, g32
                p32 = p.float()
                if self.weight_decay:
                    step.add_(p32, alpha=self.weight_decay)
                p.copy_(p32 - step.mul_(lr))
        return (OptState(m=state.m, v=state.v, count=count),
                {"grad_norm": gnorm, "lr": lr})


def _leaf(tree: Dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree
