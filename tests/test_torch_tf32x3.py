"""The f32 routes' split-TF32 products and the calibration probes' timed
form, on the CPU.

The f32 GEMM (``csrc/matmul.cu``) and the f32 flash attention, forward and
backward (``csrc/flash_attention.cu``), compute every product as three
TF32 tensor-core products of split operands (``csrc/tf32x3.cuh``).  The
kernels run only on the card; here a plain PyTorch emulation of that
rounding (a test helper, on no path of the port; for the GEMM also with
a model of the tensor cores' accumulator, which rounds toward zero
within a 32-deep slab's products) is held against the JAX package's f32
reference, so the error budget is shown before the card: the GEMM at
zamba2-7b's K within ``tests/test_kernels.py``'s f32 GEMM tolerance
(rtol 1e-5 / atol 1e-4·√K), the attention forward (out and lse, with the
kernel's tiles, key halves and -inf guards) and backward at small widths
within the f32 attention tolerance (rtol 1e-4 / atol 2e-5).  One TF32
product alone misses the GEMM tolerance, which is why the kernels take
three, and so does one accumulator over the whole K, which is why they
add each 32-deep slab's sum to a running f32 sum.

The plans of the new kernels (tiles, stages, grids, shared bytes) are held
to the card's limits at the shapes the main paths launch, and the probes'
timed form to the same fixed work a call for the latency and the wave
sweep (the calibration subtracts one intercept from the other).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ops as jops
from repro.nn import attention as jattention
from repro_torch.calib import device as cdev
from repro_torch.calib import probes as cprobes
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.selector import select_gemm_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import probes

SMEM_MAX = 232448             # 227 KB of opt-in shared memory a block


# ---------------------------------------------------------------------------
# The emulation (test helpers).
# ---------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round f32 to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits of the result are zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 bit pattern given as a .tf32
    operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The kernels' split: hi rounded to nearest, lo = x - hi (exact in
    f32) as the tensor cores read it."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: lo hi + hi lo, then hi hi, each
    product exact in f32 (11 x 11 significant bits), sums in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _rz_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mm_tf32x3_sliced(a: torch.Tensor, b: torch.Tensor,
                     slice_k: int = 32) -> torch.Tensor:
    """a @ b as the f32 GEMM kernel sums it, with a model of the tensor
    cores' accumulator: each mma adds its 8 exact products to the f32
    accumulator and rounds toward zero; every ``slice_k`` of K the slice's
    accumulator goes to the running sum by a rounded f32 add."""
    ah, al = (x.double() for x in split_tf32(a))
    bh, bl = (x.double() for x in split_tf32(b))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _rz_f32(part.double() + x[:, ks] @ y[ks])
        if (k0 + 8) % slice_k == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: what a single tensor-core pass would give."""
    return tf32_rna(a) @ tf32_rna(b)


def _rng(seed):
    return np.random.default_rng(seed)


def test_tf32_rounding_emulation():
    """hi keeps 11 significant bits, rounded to nearest with ties away from
    zero; hi + lo (lo truncated) keeps x within 2^-21 |x|."""
    x = torch.from_numpy(_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all())
    # 1 + 2^-11 lies halfway between two TF32 values: away from zero.
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


# ---------------------------------------------------------------------------
# The GEMM at zamba2-7b's K: the split-TF32 sum within the f32 tolerance of
# the JAX package's f32 reference; one TF32 product outside it.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [3584, 7168, 14336])
def test_split_tf32_gemm_meets_the_f32_tolerance_at_zamba2_k(K):
    M, N = 16, 64
    r = _rng(K)
    a = r.standard_normal((M, K)).astype(np.float32)
    b = r.standard_normal((K, N)).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                  out_dtype=jnp.float32,
                                  backend="reference"))
    rtol, atol = 1e-5, 1e-4 * math.sqrt(K)
    got = mm_tf32x3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    sliced = mm_tf32x3_sliced(torch.from_numpy(a),
                              torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(sliced, want, rtol=rtol, atol=atol)
    # One accumulator over the whole K (no slices) drifts past it at the
    # out_proj's and the shared block's wd's K.
    if K >= 7168:
        whole = mm_tf32x3_sliced(torch.from_numpy(a), torch.from_numpy(b),
                                 slice_k=K).numpy()
        assert np.any(np.abs(whole - want) > atol + rtol * np.abs(want))
    one = mm_tf32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.any(np.abs(one - want) > atol + rtol * np.abs(want))


# ---------------------------------------------------------------------------
# The attention forward as the split-TF32 kernel computes it: S = Q K^T in
# split TF32, scaled into base 2 in f32; each of the CTA's key halves runs
# its own online softmax over its share of every ring stage (the -inf
# guards: a row with no valid key keeps m = -inf and alpha = 0), adding
# alpha O and P V (P split as the A operand) a stage at a time; the halves
# merge in order, then O / l and lse = m ln 2 + ln l (+inf where l is 0).
# ---------------------------------------------------------------------------

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _exp2_guarded(x, ref):
    """exp2(x - ref), 0 where x is -inf (a masked score or an empty row's
    m) whatever ref is."""
    safe = torch.where(ref == float("-inf"), torch.zeros_like(ref), ref)
    return torch.where(x == float("-inf"), torch.zeros_like(x),
                       torch.exp2(x - safe))


def _visible(Sq, Skv, causal, window):
    """The (query, key) pairs the kernels see: key j of query i iff j <= i
    under causal and i - j < window where window > 0."""
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window > 0:
        keep &= i - j < window
    return keep


def attention_fwd_tf32x3(q, k, v, *, causal, scale, kv_rows, splits=2,
                         mm=mm_tf32x3, window=0):
    """(o, lse) of the f32 forward kernel: a CTA a 64-row q block walking
    the ring stages of ``kv_rows`` keys from ``kfa.kv_walk`` (the first
    holds its first row's first visible key under a window; the last its
    last row's diagonal under causal), each stage's keys split into
    ``splits`` warp shares; ``mm`` takes both products (``mm_tf32``: one
    TF32 product each)."""
    B, H, Sq, d = q.shape
    Skv = k.shape[2]
    rep = H // k.shape[1]
    kk, vv = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    s = mm(q, kk.transpose(-1, -2)) * scale_log2
    s = s.masked_fill(~_visible(Sq, Skv, causal, window), float("-inf"))
    kw = kv_rows // splits
    rows = kfa.FWD_F32_Q_ROWS
    outs, lses = [], []
    for i in range(-(-Sq // rows)):
        qs = slice(i * rows, min((i + 1) * rows, Sq))
        lo, hi = kfa.kv_walk(i, Sq, Skv, rows, kv_rows, causal, window)
        halves = []
        for sp in range(splits):
            n = qs.stop - qs.start
            m = torch.full((B, H, n, 1), float("-inf"))
            l = torch.zeros((B, H, n, 1))
            o = torch.zeros((B, H, n, d))
            for kb in range(lo, hi):
                k0 = kb * kv_rows + sp * kw
                if k0 >= Skv:      # past the key end: masked, adds nothing
                    continue
                blk = s[..., qs, k0:k0 + kw]
                vb = vv[..., k0:k0 + kw, :]
                m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
                alpha = _exp2_guarded(m, m_new)
                p = _exp2_guarded(blk, m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + mm(p, vb)
                m = m_new
            halves.append((m, l, o))
        m, l, o = halves[0]
        for mb, lb, ob in halves[1:]:
            mn = torch.maximum(m, mb)
            fa, fb = _exp2_guarded(m, mn), _exp2_guarded(mb, mn)
            m, l, o = mn, l * fa + lb * fb, o * fa + ob * fb
        live = l > 0
        inv = torch.where(live,
                          1.0 / torch.where(live, l, torch.ones_like(l)),
                          torch.zeros_like(l))
        lse = torch.where(live, m * LN2 + torch.log(torch.where(
            live, l, torch.ones_like(l))), torch.full_like(l, float("inf")))
        outs.append(o * inv)
        lses.append(lse[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


@pytest.mark.parametrize("d", [8, 64, 112, 256])
@pytest.mark.parametrize("causal,Hkv,S", [(True, 2, 150), (False, 4, 150),
                                          (True, 2, 77), (False, 2, 40)],
                         ids=str)
def test_split_tf32_attention_fwd_meets_the_f32_tolerance(d, causal, Hkv, S):
    """Out against the JAX reference and lse against a float64 logsumexp
    of the scaled, masked scores, at the kernel's tiles (64-row q blocks,
    ring stages of 64 keys, 32 past a padded d of 128): causal with GQA,
    non-causal, an S that is no multiple of either block (77: the last
    stage straddles the causal diagonal and the key end), and an S under
    one block.  Under causal the first rows' second key half sees no key
    in the first stage: its m stays -inf up to the merge."""
    B, H = 1, 4
    r = _rng(d + 10 * Hkv + S)
    q = r.standard_normal((B, H, S, d)).astype(np.float32)
    k, v = (r.standard_normal((B, Hkv, S, d)).astype(np.float32)
            for _ in range(2))
    plan = kfa.plan_attention_f32(S, d, batch=B, heads=H)
    assert S % plan.q_block and S % plan.kv_block
    got, lse = attention_fwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, scale=d ** -0.5,
                                    kv_rows=plan.kv_block)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        backend="reference"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    # One TF32 product each misses the tolerance: why the kernel takes three.
    one, _ = attention_fwd_tf32x3(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        scale=d ** -0.5, kv_rows=plan.kv_block, mm=mm_tf32)
    assert np.any(np.abs(one.numpy() - want) > 2e-5 + 1e-4 * np.abs(want))
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=1)
    s64 = q.astype(np.float64) @ kk.transpose(0, 1, 3, 2) * d ** -0.5
    if causal:
        s64 = np.where(np.tril(np.ones((S, S), bool)), s64, -np.inf)
    mx = s64.max(-1, keepdims=True)
    lse64 = (mx + np.log(np.exp(s64 - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse64, rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# The attention backward at small widths: every product (S, dP, dV, dK, dQ)
# in split TF32, the softmax algebra in f32, from the f32 forward's o and
# lse, as the kernels compute it.
# ---------------------------------------------------------------------------

def attention_bwd_tf32x3(q, k, v, do, *, causal, scale, window=0):
    B, H, S, d = q.shape
    rep = H // k.shape[1]
    kk, vv = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    keep = _visible(S, S, causal, window)
    s32 = (q @ kk.transpose(-1, -2)) * scale
    s32 = s32.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s32, dim=-1, keepdim=True)
    o = torch.softmax(s32, dim=-1) @ vv                 # the f32 forward
    delta = (do * o).sum(-1, keepdim=True)
    s = mm_tf32x3(q, kk.transpose(-1, -2)) * scale
    p = torch.exp(s - lse).masked_fill(~keep, 0.0)
    dp = mm_tf32x3(do, vv.transpose(-1, -2))
    ds = p * (dp - delta)
    dv = mm_tf32x3(p.transpose(-1, -2), do)
    dk = mm_tf32x3(ds.transpose(-1, -2), q) * scale
    dq = mm_tf32x3(ds, kk) * scale

    def fold(x):   # the GQA group's heads summed onto their kv head
        return x.reshape(B, H // rep, rep, S, d).sum(2)
    return dq, fold(dk), fold(dv)


@pytest.mark.parametrize("d", [16, 64, 112])
@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 4)], ids=str)
def test_split_tf32_attention_bwd_meets_the_f32_tolerance(d, causal, Hkv):
    B, H, S = 1, 4, 40
    r = _rng(d + Hkv)
    q, cot = (r.standard_normal((B, H, S, d)).astype(np.float32)
              for _ in range(2))
    k, v = (r.standard_normal((B, Hkv, S, d)).astype(np.float32)
            for _ in range(2))

    def f(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal,
                                   backend="reference")
        return jnp.sum(out * cot)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    got = attention_bwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v, cot)),
                               causal=causal, scale=d ** -0.5)
    for name, x, w in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-5, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# The sliding window (mixtral-8x22b's SWA) in the f32 forward and backward:
# windows around the 64-row block edges, held to the reference's
# ``chunked_attention(..., sliding_window=w)`` and its vjp.
# ---------------------------------------------------------------------------

WINDOWS = (1, 7, 31, 32, 33, 64)


def _window_inputs(d, Hkv, S, seed):
    r = _rng(seed)
    q, cot = (r.standard_normal((1, 4, S, d)).astype(np.float32)
              for _ in range(2))
    k, v = (r.standard_normal((1, Hkv, S, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, cot


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d,Hkv", [(64, 2), (64, 4), (160, 2)], ids=str)
def test_split_tf32_windowed_fwd_meets_the_f32_tolerance(window, d, Hkv):
    """Out against the JAX reference's ``chunked_attention`` with the
    window and lse against a float64 logsumexp of the windowed scores, at
    S 150 (three 64-row q blocks, the last ragged), under GQA and MHA, and
    at a padded head dim past 128 (ring stages of 32 keys); the emulated
    walk skips the stages before each q block's first visible key, as the
    kernel does."""
    S = 150
    q, k, v, _ = _window_inputs(d, Hkv, S, d + Hkv + window)
    plan = kfa.plan_attention_f32(S, d, batch=1, heads=4)
    got, lse = attention_fwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=True, scale=d ** -0.5,
                                    kv_rows=plan.kv_block, window=window)
    want = np.asarray(jattention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sliding_window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    kk = np.repeat(k.astype(np.float64), 4 // Hkv, axis=1)
    s64 = q.astype(np.float64) @ kk.transpose(0, 1, 3, 2) * d ** -0.5
    s64 = np.where(_visible(S, S, True, window).numpy(), s64, -np.inf)
    mx = s64.max(-1, keepdims=True)
    lse64 = (mx + np.log(np.exp(s64 - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse64, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("Hkv", [2, 4])
def test_split_tf32_windowed_bwd_meets_the_f32_tolerance(window, Hkv):
    """dq, dk, dv against ``jax.vjp`` of the reference's windowed
    ``chunked_attention`` at S 150, under GQA and MHA."""
    d, S = 64, 150
    q, k, v, cot = _window_inputs(d, Hkv, S, 7 * window + Hkv)
    _, vjp = jax.vjp(lambda q_, k_, v_: jattention.chunked_attention(
        q_, k_, v_, causal=True, sliding_window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(cot))
    got = attention_bwd_tf32x3(*(torch.from_numpy(x) for x in (q, k, v, cot)),
                               causal=True, scale=d ** -0.5, window=window)
    for name, x, w in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-5, err_msg=f"d{name}")


def q_walk(j, s_q, block_kv, block_q, causal, window):
    """The q blocks [lo, hi) the dK/dV kernels' CTA of kv block j walks, as
    ``flash_bwd_dkdv_wgmma`` and ``flash_bwd_dkdv_tf32x3`` compute them:
    from the block of its first key under causal, up to the block of query
    k0 + block_kv - 1 + window - 1 under a window."""
    n_qb = -(-s_q // block_q)
    k0 = j * block_kv
    lo = min(k0 // block_q, n_qb) if causal else 0
    hi = (min(n_qb, (k0 + block_kv - 1 + window - 1) // block_q + 1)
          if window > 0 else n_qb)
    return lo, max(lo, hi)


@pytest.mark.parametrize("S", [64, 150, 300, 512])
@pytest.mark.parametrize("window", (0,) + WINDOWS + (100, 128, 4096))
def test_windowed_walks_cover_exactly_the_visible_blocks(S, window):
    """For every (q block, kv block) pair of every kernel's tiling, the
    walk covers it iff the pair holds a visible (query, key) pair: the
    forward's and the dQ kernels' kv walk (``kfa.kv_walk``: the bf16
    forward's menu, the f32 forward's 64 q rows over stages of 64 or 32
    keys, the dQ kernels' 64 q rows over 64 keys or the f32 stages of 32
    and 16) and the dK/dV kernels' q walk (64 kv rows over 64-row q blocks,
    or the f32 stages of 32 and 16 rows)."""
    vis = _visible(S, S, True, window)
    tilings = {(bq, bkv) for bq in kfa.BLOCK_MENU for bkv in kfa.BLOCK_MENU}
    tilings |= {(64, 64), (64, 32), (64, 16)}
    for bq, bkv in sorted(tilings):
        for i in range(-(-S // bq)):
            lo, hi = kfa.kv_walk(i, S, S, bq, bkv, True, window)
            for j in range(-(-S // bkv)):
                seen = bool(vis[i * bq:(i + 1) * bq,
                                j * bkv:(j + 1) * bkv].any())
                assert (lo <= j < hi) == seen, (bq, bkv, i, j, lo, hi)
    for qr in (64, 32, 16):
        for j in range(-(-S // 64)):
            lo, hi = q_walk(j, S, 64, qr, True, window)
            for i in range(-(-S // qr)):
                seen = bool(vis[i * qr:(i + 1) * qr,
                                j * 64:(j + 1) * 64].any())
                assert (lo <= i < hi) == seen, (qr, i, j, lo, hi)
    # Heaviest first: under the window a q block's kv count never falls as
    # it moves on, and a kv block's q count never rises.
    steps = kfa.kv_steps(S, S, 64, 64, True, window)
    assert steps == sorted(steps)
    counts = [hi - lo for lo, hi in (q_walk(j, S, 64, 64, True, window)
                                     for j in range(-(-S // 64)))]
    assert counts == sorted(counts, reverse=True)


# ---------------------------------------------------------------------------
# The new kernels' plans.
# ---------------------------------------------------------------------------

ZAMBA2_MAMBA = [(7168, 3584), (7168, 3584), (64, 3584), (64, 3584),
                (112, 3584), (3584, 7168)]


@pytest.mark.parametrize("M", [4, 474])
def test_f32_gemm_tiling_at_zamba2_shapes(M):
    """The f32 kernel's tiling at the selector's config for zamba2-7b's six
    mamba GEMMs: its passes cover the tile, 64 rows a consumer warpgroup
    and at most 128 columns (64 running sums a thread), a ring of at least
    two 32-deep stages in 227 KB; a 256-row tile takes two row passes."""
    for N, K in ZAMBA2_MAMBA:
        cfg = select_gemm_config(M, N, K, in_dtype="float32",
                                 out_dtype="float32",
                                 hw=GPU_H100_LIKE).config
        for ta, tb in ((False, False), (True, False), (False, True)):
            t = kmm.f32_tiling(cfg, trans_a=ta, trans_b=tb)
            assert t.rows * t.pass_n * t.passes == cfg.bm * cfg.bn
            assert t.rows <= 64 * t.nwg and t.pass_n <= 128
            assert 2 <= t.stages <= 8 and t.smem <= SMEM_MAX
            assert t.ks == 32
            assert t.passes == (2 if cfg.bm == 256 else 1) \
                * (2 if cfg.bn == 256 else 1)
        plan = kmm.work_plan(M, N, K, cfg, 1, 132)
        assert 1 <= plan.ctas <= 132


def test_f32_gemm_tiling_covers_the_menu():
    """Every (bm, bn) of the menu and several k-steps: one of the kernel's
    six instantiations (consumer warpgroups, pass width), the same in
    every operand layout, the stages filling the shared memory they may
    beside the B slab's hi / lo copies."""
    from repro_torch.core.latency import TileConfig
    seen = set()
    for bm in (32, 64, 128, 256):
        for bn in (32, 64, 128, 256):
            for bk in (48, 64, 128):
                tilings = {kmm.f32_tiling(TileConfig(bm, bn, bk),
                                          trans_a=ta, trans_b=tb)
                           for ta, tb in ((False, False), (True, False),
                                          (False, True))}
                assert len(tilings) == 1
                t = tilings.pop()
                seen.add((t.nwg, t.pass_n))
                stage = (t.rows + t.pass_n) * 32 * 4
                assert t.smem <= SMEM_MAX
                assert t.stages == 8 or t.smem + stage > SMEM_MAX
    assert seen == {(1, 32), (1, 64), (1, 128), (2, 32), (2, 64), (2, 128)}


@pytest.mark.parametrize("d", kfa.HEAD_DIMS)
def test_flash_fwd_f32_plan_every_head_dim(d):
    """The split-TF32 forward's plan at every head dim: 64 q rows a CTA,
    ring stages of 64 keys up to a padded head dim of 128 and 32 past it,
    the Q tile and two stages within 227 KB; the grid at zamba2-7b's f32
    prefill (32 heads, S 474: 8 q blocks) and at the f32 training shape
    (2 x 24 heads, S 512), and an S under one block."""
    dp = kfa.padded_head_dim(d)
    plan = kfa.plan_attention_f32(474, d, batch=1, heads=32)
    assert (plan.route, plan.q_block, plan.ctas) == ("tf32x3", 64, 256)
    assert plan.kv_block == kfa.fwd_f32_kv_rows(d) \
        == {64: 64, 128: 64, 192: 32, 256: 32}[dp]
    assert plan.smem == 4 * (64 + 2 * 2 * plan.kv_block) * (dp + 4)
    assert plan.smem <= SMEM_MAX
    # the merge of the two key halves reuses the dead ring: 64 rows fit
    assert 2 * 2 * plan.kv_block >= 64
    assert kfa.plan_attention_f32(512, d, batch=2, heads=24).ctas == 384
    short = kfa.plan_attention_f32(40, d, batch=2, heads=8)
    assert short.ctas == 16 and short.smem == plan.smem


@pytest.mark.parametrize("d", kfa.HEAD_DIMS)
def test_flash_bwd_f32_plan_every_head_dim(d):
    """The split-TF32 backward's plan at every head dim: the C entry's
    tiles (64 kv rows a dK/dV CTA, 64 q rows a dQ CTA), the grids of the
    f32 training shape (a dK/dV CTA per q head, not per kv head: 384, not
    128), and shared bytes within 227 KB; the ring's stage rows fall past
    a padded head dim of 128."""
    plan = kfa.plan_attention_bwd(512, 512, d, batch=2, heads=24,
                                  kv_heads=8, in_dtype="float32")
    assert (plan.route, plan.kv_block, plan.q_block, plan.sq_pad,
            plan.kv_ctas, plan.q_ctas) == ("tf32x3", 64, 64, 512, 384, 384)
    assert plan.kv_smem <= SMEM_MAX and plan.q_smem <= SMEM_MAX
    dp = kfa.padded_head_dim(d)
    step = kfa.bwd_f32_step_rows(d)
    assert step == {64: 64, 128: 64, 192: 32, 256: 16}[dp]
    ld = dp + 4
    assert plan.kv_smem == 4 * (2 * 64 * ld + 2 * (2 * step * ld + 2 * step)
                                + 4 * 32 * step // 2)
    assert plan.q_smem == 4 * (2 * 64 * ld + 2 * 2 * step * ld)


def test_flash_bwd_f32_plan_at_zamba2_and_ragged_shapes():
    """zamba2-7b's attention (32 heads of 112, no GQA) at its longest
    served prompt, and an S shorter than one block: grids over 64-row
    blocks of the padded q rows."""
    plan = kfa.plan_attention_bwd(474, 474, 112, batch=1, heads=32,
                                  kv_heads=32, in_dtype="float32")
    assert (plan.sq_pad, plan.kv_ctas, plan.q_ctas) == (512, 256, 256)
    short = kfa.plan_attention_bwd(40, 40, 64, heads=8, kv_heads=2,
                                   in_dtype="float32")
    assert (short.sq_pad, short.kv_ctas, short.q_ctas) == (64, 8, 8)


# ---------------------------------------------------------------------------
# C7: the latency sweep and the wave sweep time the same fixed work a call.
# ---------------------------------------------------------------------------

class _AtenOps(TorchDispatchMode):
    """Records the aten ops a call dispatches (allocations, fills, sums)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def fake_card(monkeypatch):
    """The probe wrappers' card route on CPU tensors, the C entry replaced
    by a recorder: what a call enqueues besides its one launch shows as
    aten ops."""
    calls = []
    monkeypatch.setattr(probes, "_route", lambda t, what: "kernel")
    monkeypatch.setattr(probes, "_sm_count", lambda index: 132)
    monkeypatch.setattr(probes, "_run",
                        lambda fn, dev, what, *args: calls.append(fn))
    return calls


def test_latency_and_wave_probes_enqueue_the_same_fixed_work(fake_card):
    """In the timed form (``out`` given, as ``TorchDevice`` calls them) the
    latency sweep's stream probe, the wave probe and the compute probe
    are each one launch with no allocation, fill or reduction beside it;
    without ``out`` the chains' probes allocate their slots (no fill) and
    the stream probe also sums its CTAs' slots."""
    x = probes.stream_data(1 << 16, "cpu")
    a, b = probes.mma_operands("bfloat16", "cpu",
                               torch.Generator().manual_seed(0))
    out = torch.empty(4096, dtype=torch.int64)
    timed = {}
    for name, fn in (
            ("latency", lambda: probes.stream_read(x, 65536.0, 1 << 16, 1,
                                                   out=out)),
            ("wave", lambda: probes.wave_grid(a, b, 2 * 132, 285, out=out)),
            ("compute", lambda: probes.mma_chain(a, b, 4000, 132, out=out))):
        with _AtenOps() as rec:
            assert fn() is out
        timed[name] = rec.ops
    assert timed == {"latency": [], "wave": [], "compute": []}
    assert fake_card == ["repro_probe_stream", "repro_probe_mma",
                         "repro_probe_mma"]
    with _AtenOps() as rec:
        probes.wave_grid(a, b, 132, 285)
    assert rec.ops == ["empty"]
    with _AtenOps() as rec:
        probes.stream_read(x, 65536.0, 1 << 16, 1)
    assert rec.ops == ["empty", "sum"]
    with pytest.raises(ValueError, match="at least 264"):
        probes.wave_grid(a, b, 264, 285, out=out[:100])


def test_torch_device_times_the_probes_in_their_timed_form(monkeypatch):
    """``TorchDevice``'s stream, compute and wave timings each pass one
    buffer it owns as ``out``, sized for the call and made before the
    timing (so never inside a captured graph)."""
    got = {}
    buf = torch.empty(4096, dtype=torch.int64)

    def record(name):
        def fn(*args, out=None):
            got[name] = out
        return fn
    for name in ("stream_read", "mma_chain", "wave_grid"):
        monkeypatch.setattr(probes, name, record(name))
    dev = cdev.TorchDevice(device="cpu", l2_bytes=1 << 20)
    sizes = []
    monkeypatch.setattr(dev, "_slots", lambda n: sizes.append(n) or buf)
    monkeypatch.setattr(dev, "_time",
                        lambda fn, calls=cdev.GRAPH_CALLS: fn() or 1.0)
    dev.stream_time(65536.0, 65536, 1)
    dev.compute_time("bfloat16", 1000, 132)
    dev.wave_time(3 * 132, 285, "bfloat16")
    assert got == {"stream_read": buf, "mma_chain": buf, "wave_grid": buf}
    assert sizes == [probes.STREAM_SLOTS_MAX, 132 * probes.CHAINS_PER_CTA,
                     3 * 132]
    assert cdev.TorchDevice(device="cpu")._slots(10) is None


# ---------------------------------------------------------------------------
# C7: every fetch of the latency sweep misses the L2.
# ---------------------------------------------------------------------------

def test_latency_windows_pass_twice_the_l2_budget_between_reads():
    """The rotation is sized from the topology's L2 budget (the largest
    cache inside the backing memory, as ``level_windows`` sizes the HBM
    window): at least twice it passes between two reads of one window, at
    every point of the H100 preset's latency sweep."""
    l2 = cdev.l2_budget(GPU_H100_LIKE)
    assert l2 == int(0.75 * 50 * 1024**2)
    assert cdev.TorchDevice(device="cpu").l2_bytes == l2
    bw = GPU_H100_LIKE.backing.bandwidth
    for T in cprobes.LATENCY_TARGETS_S:
        window = int(T * bw)
        n = cdev.latency_windows(window, l2)
        assert (n - 1) * window >= 2 * l2 > (n - 2) * window
    # the sweep's first point: 1.675 MB windows, 48 of them
    assert cdev.latency_windows(int(0.5e-6 * bw), l2) == 48


@pytest.mark.parametrize("window", [4096, 65536, 100000])
def test_latency_probe_reads_a_window_of_its_own_each_call(monkeypatch,
                                                           fake_card,
                                                           window):
    """``TorchDevice.stream_time`` in the latency form times a graph of
    one call a window: the windows are pairwise distinct, laid out as
    ``stream_data`` lays one out, and together at least 2x the L2 budget
    beyond the one being read; each timed call is still the probe's one
    launch with no aten op beside it.  The stream and bandwidth sweeps
    keep one window and ``GRAPH_CALLS`` calls."""
    l2 = 1 << 20
    dev = cdev.TorchDevice(device="cpu", l2_bytes=l2)
    buf = torch.empty(4096, dtype=torch.int64)
    monkeypatch.setattr(dev, "_slots", lambda n: buf)
    seen, timed = [], {}

    def fake_time(fn, calls=cdev.GRAPH_CALLS):
        timed["calls"] = calls
        for _ in range(3):                      # graph_time's warm-up calls
            fn()
        seen.clear()
        with _AtenOps() as rec:
            for _ in range(calls):              # the captured calls
                fn()
        timed["ops"] = rec.ops
        return 1.0

    monkeypatch.setattr(dev, "_time", fake_time)
    real = probes.stream_read

    def spy(x, nbytes, w, n_chunks, *, out=None):
        seen.append((x.data_ptr(), x.numel()))
        return real(x, nbytes, w, n_chunks, out=out)
    spy.launches = 0        # the wrapper counts on its module's name
    monkeypatch.setattr(probes, "stream_read", spy)
    dev.stream_time(float(window), window, 1)
    n = cdev.latency_windows(window, l2)
    assert timed["calls"] == n == len(seen) == len(set(seen))
    assert timed["ops"] == []
    assert fake_card == ["repro_probe_stream"] * (n + 3)
    floats = window // probes.VEC_BYTES * 4
    ptrs = sorted(p for p, _ in seen)
    assert all(numel == floats for _, numel in seen)
    assert all(b - a >= floats * 4 for a, b in zip(ptrs, ptrs[1:]))
    assert (n - 1) * window >= 2 * l2
    for i, x in enumerate(dev.rotation(window)):
        want = (torch.arange(i * floats, (i + 1) * floats) % 13).float()
        assert torch.equal(x, want)
    # The stream sweep's form: one window, GRAPH_CALLS calls.
    seen.clear()
    dev.stream_time(4.0 * window, window, 4)
    assert timed["calls"] == cdev.GRAPH_CALLS
    assert len(set(seen)) == 1


def test_marginal_time_cancels_what_a_replay_costs_once(monkeypatch):
    """``marginal_time`` times graphs of ``calls`` and ``2 calls`` calls:
    a fixed cost of each replay cancels, one call's own time remains."""
    per_call, once = 3.0e-6, 1.7e-6 * 5

    def fake_graph_time(fn, calls, reps, side=None):
        return (once + calls * per_call) / calls    # graph_time's form
    monkeypatch.setattr(cdev, "graph_time", fake_graph_time)
    assert cdev.marginal_time(None, 5, 5) == pytest.approx(per_call)
    assert cdev.marginal_time(None, 48, 5) == pytest.approx(per_call)


def test_probes_take_the_marginal_time_and_gemms_one_graph(monkeypatch):
    """The probe primitives are timed by ``marginal_time`` (so the latency
    and wave sweeps carry the same fixed cost a call); ``gemm_time`` by
    one graph."""
    dev = cdev.TorchDevice(device="cpu", l2_bytes=1 << 20)
    seen = []
    monkeypatch.setattr(dev, "_time", lambda fn, calls=cdev.GRAPH_CALLS,
                        marginal=True: seen.append(marginal) or 1.0)
    dev.stream_time(65536.0, 65536, 1)
    dev.stream_time(4.0 * 65536, 65536, 4)
    dev.compute_time("bfloat16", 1000, 4)
    dev.wave_time(264, 285, "bfloat16")
    from repro_torch.core.latency import GemmProblem, TileConfig
    dev.gemm_time(GemmProblem(64, 64, 64), TileConfig(32, 32, 32))
    assert seen == [True, True, True, True, False]
