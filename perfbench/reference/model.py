"""The plain reference decoder: the published equations in plain PyTorch,
f32 with TF32 off, one sequence at a time.

It follows the configuration as run (``spec.as_run``): GQA attention with
rotate-half RoPE over the rotary fraction of each head, RMSNorm (scale
only), a SwiGLU MLP silu(x W_g) * (x W_u) W_d, or the MoE layer: an f32
softmax router, the top k renormalised, each token's k experts summed
under their gates.  Where the configuration sets ``capacity_factor``, the
positions of a prompt are dispatched with C = max(8, ceil8(int(T k cf /
E))) slots an expert for the prompt's padded length T, and a copy past an
expert's C-th, in token order (token-major, then its k choices), is
dropped; later positions, decoded one at a time, drop nothing.  Every
product goes through ``mm``, which the control swaps for a lower
precision.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         frac: float) -> torch.Tensor:
    """x (S, H, d): rotate-half over the first ``frac`` of each head."""
    d = x.shape[-1]
    rot = int(d * frac)
    half = rot // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (S, H, d), k and v (S, Hkv, d), a
    block of ``chunk`` queries at a time."""
    S, H, d = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, S, d)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    outs = []
    for i0 in range(0, S, chunk):
        i1 = min(i0 + chunk, S)
        s = (q[i0:i1].transpose(0, 1) @ k[:, :i1].transpose(1, 2)) \
            * (d ** -0.5)                                  # (H, c, i1)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        outs.append((torch.softmax(s, -1) @ v[:, :i1]).transpose(0, 1))
    return torch.cat(outs, 0)


def capacity(run: Dict, tokens: int) -> int:
    c = int(tokens * int(run["num_experts_per_tok"])
            * float(run["capacity_factor"]) / int(run["num_local_experts"]))
    return max(8, -(-c // 8) * 8)


def attn_block(h: torch.Tensor, p: Dict, run: Dict, mm: MM) -> torch.Tensor:
    S = h.shape[0]
    H, Hkv = int(run["num_attention_heads"]), int(run["num_key_value_heads"])
    hd = int(run["head_dim"])
    x = rmsnorm(h, p["attn/norm/scale"], float(run["rms_norm_eps"]))
    pos = torch.arange(S, device=h.device)
    theta = float(run["rope_theta"])
    frac = float(run.get("partial_rotary_factor") or 1.0)
    q = rope(mm(x, p["attn/wq"]).view(S, H, hd), pos, theta, frac)
    k = rope(mm(x, p["attn/wk"]).view(S, Hkv, hd), pos, theta, frac)
    v = mm(x, p["attn/wv"]).view(S, Hkv, hd)
    return h + mm(attention(q, k, v).reshape(S, H * hd), p["attn/wo"])


def mlp_block(h: torch.Tensor, p: Dict, run: Dict, mm: MM) -> torch.Tensor:
    x = rmsnorm(h, p["mlp/norm/scale"], float(run["rms_norm_eps"]))
    return h + mm(F.silu(mm(x, p["mlp/wg"])) * mm(x, p["mlp/wu"]),
                  p["mlp/wd"])


def moe_block(h: torch.Tensor, p: Dict, run: Dict, mm: MM,
              n_prompt: int = 0, padded: int = 0,
              margins: Optional[list] = None) -> torch.Tensor:
    """The MoE layer over h (S, D): the first ``n_prompt`` positions are a
    prompt dispatched with capacity for ``padded`` tokens.  ``margins``
    (a list) receives each position's router margin: its k-th largest
    router logit less its (k+1)-th."""
    E, K = int(run["num_local_experts"]), int(run["num_experts_per_tok"])
    x = rmsnorm(h, p["moe/norm/scale"], float(run["rms_norm_eps"]))
    lg = mm(x, p["moe/router"])
    if margins is not None:
        top = torch.topk(lg, K + 1, -1).values
        margins.append(top[:, K - 1] - top[:, K])
    probs = torch.softmax(lg, -1)
    vals, ids = torch.topk(probs, K, -1)
    vals = vals / vals.sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if n_prompt and run.get("capacity_factor"):
        flat = ids[:n_prompt].reshape(-1)
        rank = torch.cumsum(F.one_hot(flat, E), 0).gather(1, flat[:, None])
        keep[:n_prompt] = (rank[:, 0] - 1 < capacity(run, padded)) \
            .view(n_prompt, K)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        a = F.silu(mm(xe, p["moe/wg"][e])) * mm(xe, p["moe/wu"][e])
        y.index_add_(0, tok, mm(a, p["moe/wd"][e]) * vals[tok, slot, None])
    return h + y


def layer(h: torch.Tensor, p: Dict, run: Dict, mm: MM,
          n_prompt: int = 0, padded: int = 0,
          margins: Optional[list] = None) -> torch.Tensor:
    """One decoder layer; ``p`` maps the layer's leaf names without the
    "layers/" prefix to f32 tensors."""
    h = attn_block(h, p, run, mm)
    if int(run.get("num_local_experts") or 0):
        return moe_block(h, p, run, mm, n_prompt, padded, margins)
    return mlp_block(h, p, run, mm)


def layer_weights(flat: Dict, i: int) -> Dict:
    """Layer ``i``'s leaves in f32, named without the "layers/" prefix."""
    return {path[len("layers/"):]: t[i].float()
            for path, t in flat.items() if path.startswith("layers/")}


def head(flat: Dict, run: Dict) -> torch.Tensor:
    """(D, V) in f32."""
    if run["tie_word_embeddings"]:
        return flat["embed"].float().t()
    return flat["lm_head"].float()


def logits_at(flat: Dict, run: Dict, seqs, mm: MM = f32_mm,
              margins: Optional[list] = None) -> list:
    """For each (tokens (S,), first, n, n_prompt, padded) of ``seqs``: the
    f32 logits (n, V) at positions first .. first + n - 1 of a full pass
    over ``tokens``.  Layer by layer over all sequences, so each layer's
    weights are made f32 once.  ``margins`` (a list) receives for each
    sequence the smallest router margin over the layers at those
    positions (none for a dense model)."""
    eps = float(run["rms_norm_eps"])
    hs = [flat["embed"][t].float() for t, *_ in seqs]
    least: List[Optional[torch.Tensor]] = [None] * len(seqs)
    for i in range(int(run["num_hidden_layers"])):
        p = layer_weights(flat, i)
        for j, (_, first, n, n_prompt, padded) in enumerate(seqs):
            got: list = []
            hs[j] = layer(hs[j], p, run, mm, n_prompt, padded, got)
            if got:
                m = got[0][first:first + n]
                least[j] = m if least[j] is None \
                    else torch.minimum(least[j], m)
        del p
    if margins is not None:
        margins.extend(least)
    w, out = head(flat, run), []
    final = flat["final_norm/scale"].float()
    for h, (_, first, n, _, _) in zip(hs, seqs):
        out.append(mm(rmsnorm(h[first:first + n], final, eps), w))
    return out
