"""The product of any shape on the matmul kernel and its gradient
(``ops.matmul_any``, ``ops.MatmulBf16F32``) against JAX's bf16 product.

The JAX side is ``jax.grad`` of ``jnp.dot(a.astype(bf16), b.astype(bf16),
preferred_element_type=f32)`` on the CPU.  Its backward multiplies the f32
cotangent by the saved bf16 operand in f32 (a mixed ``dot_general``), then
rounds the result to bf16, the dtype of that operand.  The Function returns
that f32 product (the caller's bf16 cast rounds it, as in the train step),
so it is held against JAX's own ``dot_general`` before the rounding, and
the rounding is checked to be all that ``jax.grad`` adds.  Tolerance: 1e-5
of the gradient's largest magnitude (f32 sums taken in another order).

On the CPU the wrapper runs its plain version on the padded operands, so
these tests reach the padding, the three-term split and the block rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from tpu_operator_torch.validator import ops, workloads as wl

BF16, F32 = jnp.bfloat16, jnp.float32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Several worker processes run the suite at once; one intra-op thread
    each keeps the cores for the timing tests beside these."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16_valued(rng, *shape):
    return np.array(jnp.asarray(rng.standard_normal(shape, np.float32),
                                BF16).astype(F32))


def _jax_product_and_grads(a, b, w):
    """JAX's bf16 product, ``jax.grad`` of ``sum(product * w)`` and the f32
    values its backward rounds to bf16 to give that gradient."""
    def loss(a, b):
        return jnp.sum(jnp.dot(a.astype(BF16), b.astype(BF16),
                               preferred_element_type=F32) * w)

    grads = jax.grad(loss, argnums=(0, 1))(a, b)
    jaxpr = jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(a, b).jaxpr
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    # the forward product and the two of the transpose, each bf16 operands
    # or f32 cotangent x bf16 operand, f32 out
    assert len(dots) == 3, jaxpr
    assert all(e.params["preferred_element_type"] == F32 for e in dots)
    assert [str(v.aval.dtype) for v in dots[1].invars] == ["float32",
                                                           "bfloat16"]
    a16, b16, w32 = (jnp.asarray(a, BF16), jnp.asarray(b, BF16),
                     jnp.asarray(w))
    ga = jax.lax.dot_general(w32, b16, (((1,), (1,)), ((), ())),
                             preferred_element_type=F32)
    gb = jax.lax.dot_general(w32, a16, (((0,), (0,)), ((), ())),
                             preferred_element_type=F32).T
    # the rounding to bf16 is all jax.grad adds to those products
    for got, pre in zip(grads, (ga, gb)):
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(pre.astype(BF16)
                                                 .astype(F32)))
    forward = jnp.dot(a16, b16, preferred_element_type=F32)
    return np.asarray(forward), np.asarray(ga), np.asarray(gb)


def _close(got, want):
    scale = max(float(np.max(np.abs(want))), np.finfo(np.float32).tiny)
    assert float(np.max(np.abs(got - want))) <= 1e-5 * scale


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(m=st.integers(1, 300), k=st.integers(1, 300), n=st.integers(1, 300),
       seed=st.integers(0, 2 ** 32 - 1))
@example(m=1, k=1, n=1, seed=0)
@example(m=64, k=32, n=64, seed=1)            # on the tiles
@example(m=8, k=128, n=256, seed=2)           # the train step's first
@example(m=300, k=300, n=300, seed=3)
@example(m=129, k=33, n=65, seed=4)           # one past every tile
def test_function_matches_jax_grad(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a, b = _bf16_valued(rng, m, k), _bf16_valued(rng, k, n)
    w = rng.standard_normal((m, n), np.float32)
    want_out, want_ga, want_gb = _jax_product_and_grads(a, b, w)

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = ops.MatmulBf16F32.apply(ta, tb)
    assert out.shape == (m, n) and out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), want_out)
    _close(ta.grad.numpy(), want_ga)
    _close(tb.grad.numpy(), want_gb)


@pytest.mark.parametrize("lo,hi", [(-100, 100), (-20, 20), (-3, 3)])
def test_split_reconstructs_f32_exactly(lo, hi):
    """hi + mid + lo == g bit for bit over normal-range f32 (exponents
    2^lo .. 2^hi, full 24-bit significands), each term a bf16 value."""
    rng = np.random.default_rng(lo + 1000)
    sig = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    sign = rng.choice(np.array([-1.0, 1.0], np.float32), 4096)
    g = np.ldexp(sig * sign, rng.integers(lo, hi + 1, 4096)).astype(
        np.float32)
    g[:3] = [0.0, np.float32(1 + 2 ** -23), -np.float32(2 - 2 ** -23)]
    terms = ops.split_bf16x3(torch.from_numpy(g))
    assert all(t.dtype == torch.bfloat16 for t in terms)
    parts = [t.double().numpy() for t in terms]
    np.testing.assert_array_equal(parts[0] + parts[1] + parts[2],
                                  g.astype(np.float64))
    hi_, mid, lo_ = (t.float() for t in terms)
    np.testing.assert_array_equal(((hi_ + mid) + lo_).numpy(), g)


def test_one_rounding_of_the_cotangent_is_another_program():
    """Why the cotangent is split: rounding it once to bf16 moves the
    gradient by about a bf16 ulp of the cotangent, far past the Function's
    f32 accuracy."""
    rng = np.random.default_rng(0)
    a, b = _bf16_valued(rng, 128, 64), _bf16_valued(rng, 64, 96)
    w = rng.standard_normal((128, 96), np.float32)
    _, _, want_gb = _jax_product_and_grads(a, b, w)
    once = ops.matmul_bf16_f32_plain(torch.from_numpy(a).t().bfloat16(),
                                     torch.from_numpy(w).bfloat16()).numpy()
    tb = torch.from_numpy(b).requires_grad_()
    (ops.MatmulBf16F32.apply(torch.from_numpy(a), tb)
     * torch.from_numpy(w)).sum().backward()
    scale = float(np.max(np.abs(want_gb)))
    assert float(np.max(np.abs(once - want_gb))) > 10 * 1e-5 * scale
    _close(tb.grad.numpy(), want_gb)


def test_padding_is_zeros(monkeypatch):
    """The padded operands' buffers start as NaN: every pad cell must be
    written with zero, or NaN reaches the product."""
    rng = np.random.default_rng(5)
    a, b = _bf16_valued(rng, 37, 45), _bf16_valued(rng, 45, 70)
    w = torch.from_numpy(rng.standard_normal((37, 70), np.float32))

    def run():
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        out = ops.MatmulBf16F32.apply(ta, tb)
        (out * w).sum().backward()
        return out.detach(), ta.grad, tb.grad

    clean = run()
    made = []

    def poisoned(rows, cols, device):
        made.append((rows, cols))
        return torch.full((rows, cols), float("nan"), dtype=torch.bfloat16,
                          device=device)

    monkeypatch.setattr(ops, "_buffer", poisoned)
    dirty = run()
    # forward: both operands padded; backward: both of each product, K
    # 3 * 70 = 210 -> 224 for dA and 3 * 37 = 111 -> 128 for dB
    assert made == [(64, 64), (64, 128), (64, 224), (224, 64), (64, 128),
                    (128, 128)]
    for got, want in zip(dirty, clean):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_launches_only_the_asked_products(monkeypatch):
    """One wrapper call forward; backward one per input that needs a
    gradient, none for the others — the train step's first product asks
    for dW1 only."""
    calls = []
    inner = ops.matmul_bf16_f32

    def counting(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), kw))
        return inner(a, b, **kw)

    monkeypatch.setattr(ops, "matmul_bf16_f32", counting)
    x = torch.randn(8, 128).bfloat16().float()
    w1 = torch.randn(128, 256).bfloat16().float().requires_grad_()
    ops.MatmulBf16F32.apply(x, w1).sum().backward()
    # x.T (128 x 8) stacked three times along K: 24, padded to 32
    assert calls == [((64, 128), (128, 256), {"block": 64}),
                     ((128, 32), (32, 256), {"block": 64})]
    assert w1.grad.shape == (128, 256)
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("m,n,sms,block", [
    (512, 512, 132, 64), (2048, 2048, 132, 128), (1024, 1024, 132, 64),
    (256, 256, 132, 64), (8, 256, 132, 64), (2048, 2048, 300, 64),
    (1536, 1536, 132, 128), (129, 129, 4, 128)])
def test_block_rule(m, n, sms, block):
    assert ops.matmul_block(m, n, sms) == block


def test_cpu_pads_as_the_h100():
    assert ops.sm_count(torch.device("cpu")) == ops.H100_SMS == 132


@pytest.mark.parametrize("size,block", [(512, 64), (2048, 128), (192, 64)])
def test_burn_in_takes_the_rule_block(monkeypatch, size, block):
    seen = []
    inner = ops.matmul_bf16_f32

    def spy(a, b, kt=0, block=128):
        seen.append(block)
        return inner(a, b, kt=kt, block=block)

    monkeypatch.setattr(ops, "matmul_bf16_f32", spy)
    x = torch.randn(size, size).bfloat16()
    wl._burn_in_fn(x, x, 1)
    assert seen == [block]


@pytest.mark.parametrize("a_shape,b_shape", [((3, 4), (5, 6)),
                                             ((0, 4), (4, 6)),
                                             ((3, 0), (0, 6))])
def test_matmul_any_rejects_what_does_not_multiply(a_shape, b_shape):
    with pytest.raises(ValueError):
        ops.matmul_any(torch.zeros(a_shape), torch.zeros(b_shape))
