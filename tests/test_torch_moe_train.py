"""The grouped GEMM's backward against the JAX package's, on shared numpy
inputs.

``kernels/ops.py::expert_matmul`` under autograd runs ``_ExpertMatmul``,
whose backward on this CPU host computes with the grouped kernels' plain
versions (the transposed-operand grouped products and the grouped epilogue
backward); the JAX side is ``jax.grad`` through the reference's
``expert_matmul`` (backend ``reference``), as ``tests/test_torch_train.py``
holds the dense GEMM's backward.  Tolerances are ``tests/test_kernels.py``'s
with K the gradient's reduction length (N for dX, M for dW and dbias, 1 for
the elementwise dgate and dresidual): f32 rtol 1e-5 / atol 1e-4·√K, bf16
rtol 3e-2 / atol 0.3·√K.  The grouped epilogue backward's plain version is
held to a per-expert loop of the dense one: the same elementwise arithmetic
(within 1e-6 in f32, where the CPU's vector and scalar sigmoid differ in the
last bits, and one bf16 rounding in bf16), and dbias sums each expert's
rows.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Epilogue as JEpilogue
from repro.kernels import ops as jops
from repro_torch.core.latency import Epilogue
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops

EPILOGUES = [
    Epilogue(),
    Epilogue(bias=True),
    Epilogue(activation="gelu"),
    Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"),
    Epilogue(residual=True),
    Epilogue(bias=True, residual=True),
]
# (E, M, K, N): a shape of multiples of 8 and a ragged one.
SHAPES = [(4, 24, 40, 56), (3, 17, 37, 45)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt, K):
    if dt == "f32":
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 0.3 * math.sqrt(K)


def _case(ep, shape, seed):
    E, M, K, N = shape
    r = np.random.default_rng(seed)
    arrs = {"x": r.standard_normal((E, M, K)),
            "w": r.standard_normal((E, K, N)) * 0.2,
            "cot": r.standard_normal((E, M, N))}
    if ep.bias:
        arrs["bias"] = r.standard_normal((E, N))
    if ep.activation == "swiglu_gate":
        arrs["gate"] = r.standard_normal((E, M, N))
    if ep.residual:
        arrs["residual"] = r.standard_normal((E, M, N))
    return {k: np.asarray(v, np.float32) for k, v in arrs.items()}


def _operands(arrs):
    return [k for k in ("x", "w", "bias", "gate", "residual") if k in arrs]


def _jax_grads(ep, arrs, jdt):
    names = _operands(arrs)
    jep = JEpilogue(bias=ep.bias, activation=ep.activation,
                    residual=ep.residual)

    def f(*xs):
        kw = dict(zip(names, xs))
        out = jops.expert_matmul(kw.pop("x"), kw.pop("w"), epilogue=jep,
                                 backend="reference", **kw)
        return jnp.sum(out.astype(jnp.float32) * arrs["cot"])
    grads = jax.grad(f, argnums=tuple(range(len(names))))(
        *(jnp.asarray(arrs[k], jdt) for k in names))
    return dict(zip(names, (np.asarray(g.astype(jnp.float32))
                            for g in grads)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_expert_matmul_backward_matches_jax(ep, shape, dt):
    jdt, tdt = DTYPES[dt]
    arrs = _case(ep, shape, seed=sum(shape) + len(str(ep)))
    want = _jax_grads(ep, arrs, jdt)
    ts = {k: torch.from_numpy(arrs[k]).to(tdt).requires_grad_()
          for k in _operands(arrs)}
    n0 = (kmm.tiled_expert_matmul.launches, kmm.epilogue_bwd.launches)
    out = ops.expert_matmul(ts["x"], ts["w"], epilogue=ep,
                            **{k: ts[k] for k in ("bias", "gate", "residual")
                               if k in ts})
    assert type(out.grad_fn).__name__ == "_ExpertMatmulBackward"
    assert out.dtype == tdt
    (out.float() * torch.from_numpy(arrs["cot"])).sum().backward()
    # the CPU route is the plain versions: no kernel launch is counted
    assert (kmm.tiled_expert_matmul.launches,
            kmm.epilogue_bwd.launches) == n0
    E, M, K, N = shape
    red = {"x": N, "w": M, "bias": M, "gate": 1, "residual": 1}
    for name, w in want.items():
        g = ts[name].grad
        assert g is not None and g.dtype == tdt, name
        rtol, atol = _tol(dt, red[name])
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", ["tn", "nt"])
def test_transposed_expert_product_plain(layout):
    """The plain grouped product of an operand stored transposed is each
    expert's product of the transposed view."""
    r = np.random.default_rng(11)
    E, M, K, N = 3, 20, 36, 28
    x = torch.from_numpy(r.standard_normal(
        (E, K, M) if layout == "tn" else (E, M, K)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal(
        (E, N, K) if layout == "nt" else (E, K, N)).astype(np.float32))
    got = ops._expert_gemm(x, w, Epilogue(), torch.float32,
                           ops.get_default_hardware(),
                           trans_a=layout == "tn", trans_b=layout == "nt")
    for e in range(E):
        xe = x[e].t() if layout == "tn" else x[e]
        we = w[e].t() if layout == "nt" else w[e]
        torch.testing.assert_close(got[e], xe @ we, rtol=1e-5,
                                   atol=1e-4 * math.sqrt(K))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("ep", [
    Epilogue(activation="gelu"), Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"), Epilogue(bias=True),
    Epilogue(bias=True, activation="gelu"),
    Epilogue(bias=True, activation="swiglu_gate", residual=True)], ids=str)
def test_grouped_epilogue_bwd_plain_is_per_expert(ep, dt):
    r = np.random.default_rng(12)
    E, M, N = 4, 21, 30

    def rnd(*shape, dtype=dt, scale=1.0):
        return torch.from_numpy(
            (r.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    dout = rnd(E, M, N)
    z = rnd(E, M, N, dtype=torch.float32, scale=3.0) if ep.activation \
        else None
    gate = rnd(E, M, N) if ep.activation == "swiglu_gate" else None
    kw = dict(epilogue=ep, dz_dtype=dt, want_bias=ep.bias)
    dz, dgate, dbias = kmm.epilogue_bwd(dout, z, gate=gate, **kw)
    assert dz.shape == (E, M, N) and dz.dtype == dt
    assert (dbias is not None) == ep.bias
    if ep.bias:
        assert dbias.shape == (E, N) and dbias.dtype == torch.float32
    tol = (dict(rtol=1e-6, atol=1e-6) if dt == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    for e in range(E):
        dz_e, dgate_e, dbias_e = kmm.epilogue_bwd(
            dout[e], None if z is None else z[e],
            gate=None if gate is None else gate[e], **kw)
        torch.testing.assert_close(dz[e], dz_e, **tol)
        if gate is not None:
            torch.testing.assert_close(dgate[e], dgate_e, **tol)
        if ep.bias:
            torch.testing.assert_close(dbias[e], dbias_e, rtol=1e-5,
                                       atol=1e-5 * M)
