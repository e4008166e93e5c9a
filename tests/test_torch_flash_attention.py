"""PyTorch port: the cache-free flash attention's plain version against the
reference's Pallas kernel (interpret mode on the CPU) and its oracle.

The reference's cases (``test_flash_attention.py``) plus a wider GQA case
and a ragged length that the Pallas kernel's blocks do not divide (the port
masks the edge itself; there the reference's oracle alone is compared). The
two frameworks do not pin the f32 reduction order of the einsums and the
softmax sum: outputs agree within the reference's own tolerance
(atol 3e-5, rtol 1e-4). The Hopper kernel is held against the plain version
on the card in ``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=3e-5, rtol=1e-4)
CASES = [
    # b, sq, sk, h, kv, d, causal (the reference's, then GQA with 4 groups)
    (2, 128, 128, 4, 2, 32, True),
    (1, 256, 256, 2, 2, 64, True),
    (2, 64, 64, 4, 1, 16, False),
    (1, 96, 96, 3, 3, 32, True),
    (1, 64, 64, 8, 8, 128, True),
    (2, 64, 64, 16, 4, 128, True),
]


def _inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _oracle(q, k, v, causal):
    """The reference's ``attention_ref`` behind its wrapper's GQA repeat."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kb, vb = np.repeat(k, g, 2), np.repeat(v, g, 2)
    out = attention_ref(*(jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
                          for a in (q, kb, vb)), causal=causal)
    return np.asarray(out).reshape(b, h, sq, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", CASES)
def test_plain_version_matches_pallas_kernel_and_oracle(b, sq, sk, h, kv, d, causal):
    q, k, v = _inputs(b, sq, sk, h, kv, d, seed=sq + h + d)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, sq, h, d)
    ref = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert torch.equal(got, ref)  # a CPU tensor runs the plain version
    pallas = np.asarray(jax_flash(q, k, v, causal=causal, bq=32, bk=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, causal), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_oracle(causal):
    """S = 70 divides no power-of-two block; the kernel masks the edge."""
    q, k, v = _inputs(2, 70, 70, 4, 2, 32, seed=70)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, causal), **TOL)


def test_bf16_output_in_q_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 40, 40, 2, 1, 16, 5))
    got = flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = flash_attention(q.float(), k.float(), v.float()).to(torch.bfloat16)
    assert torch.equal(got, want)  # f32 arithmetic on the bf16 values, one rounding
