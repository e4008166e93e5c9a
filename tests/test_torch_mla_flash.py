"""PyTorch port: the cache-free MLA flash attention's plain version against
the reference's Pallas kernel (interpret mode on the CPU), its oracle and its
model-quantity wrapper.

The reference's kernel takes the concatenated ``q_cat = [q_lat, q_rope]``,
``k_cat = [c_kv, k_rope]`` and scales by 1/sqrt(R + r); its wrapper folds the
model's scale into q. The port takes the model's quantities and applies the
scale once: the cases split the reference's ``dk`` into a latent and a rope
part and pass scale = 1/sqrt(dk) to compare with the kernel, and the model's
own scale to compare with the wrapper. Outputs agree within the reference's
tolerance (atol 3e-5, rtol 1e-4). The Hopper kernel is held against the plain
version on the card in ``test_torch_kernels_gpu.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mla_flash.kernel import mla_flash  # noqa: E402
from repro.kernels.mla_flash.ops import mla_flash_attention as jax_wrapper  # noqa: E402
from repro.kernels.mla_flash.ref import mla_attention_ref  # noqa: E402
from repro_torch.kernels.mla_flash import mla_flash_attention, mla_flash_attention_ref  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=3e-5, rtol=1e-4)
CASES = [
    # b, sq, h, R, r, causal: the reference's (dk = R + r, dv = R) cases
    (2, 128, 4, 32, 16, True),
    (1, 256, 8, 64, 32, True),
    (2, 64, 2, 32, 0, False),
]


def _inputs(b, s, h, r, rd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, r), (b, s, h, rd), (b, s, r), (b, s, rd))]


@pytest.mark.parametrize("b,s,h,r,rd,causal", CASES)
def test_plain_version_matches_pallas_kernel_and_oracle(b, s, h, r, rd, causal):
    ql, qr, ck, kr = _inputs(b, s, h, r, rd, seed=s + h)
    scale = 1.0 / math.sqrt(r + rd)  # the kernel's own 1/sqrt(dk)
    got = mla_flash_attention(*(torch.from_numpy(a) for a in (ql, qr, ck, kr)), scale=scale,
                              causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, r)
    ref = mla_flash_attention_ref(*(torch.from_numpy(a) for a in (ql, qr, ck, kr)), scale=scale,
                                  causal=causal)
    assert torch.equal(got, ref)  # a CPU tensor runs the plain version
    q_cat, k_cat = np.concatenate([ql, qr], -1), np.concatenate([ck, kr], -1)
    pallas = np.asarray(mla_flash(q_cat, k_cat, ck, causal=causal, bq=32, bk=32, bh=2,
                                  interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    oracle = np.asarray(mla_attention_ref(jnp.asarray(q_cat), jnp.asarray(k_cat),
                                          jnp.asarray(ck), causal=causal))
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


@pytest.mark.parametrize("s", [64, 70], ids=["s64", "ragged_s70"])
def test_model_scale_applied_once_as_the_wrapper_folds_it(s):
    """The model's score scale 1/sqrt(nope + rope) is not the kernel's
    1/sqrt(R + r) (deepseek-v3: 1/sqrt(192) against 1/sqrt(576)). The
    reference folds it into q; the port applies it once: the same product.
    S = 70 is a ragged length, which the port serves as any other."""
    ql, qr, ck, kr = _inputs(2, s, 4, 32, 16, seed=s)
    scale = 1.0 / math.sqrt(16 + 8)
    got = mla_flash_attention(*(torch.from_numpy(a) for a in (ql, qr, ck, kr)), scale=scale)
    want = np.asarray(jax_wrapper(*(jnp.asarray(a) for a in (ql, qr, ck, kr)), scale=scale,
                                  interpret=True, bq=s, bk=s, bh=4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
