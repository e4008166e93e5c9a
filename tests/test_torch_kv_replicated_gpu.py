"""Kernels 2 and 7 on a tensor-parallel rank's q heads against the whole kv
heads (replicated kv heads), on the card.

Every test here is marked ``gpu`` and skips without a CUDA card; the file
imports only torch and the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kv_replicated_gpu.py

A rank's q heads ``h0 .. h0 + h_loc - 1`` read kv head (h0 + i) // groups of
the whole K/V in place (``head_offset``, ``groups``). Its rows must equal
the whole call's rows for those heads bit for bit (the GQA split keys
planned from the global counts, ``plan_dims``), on both GQA paths and in
flash, also where a rank's heads span two kv heads unevenly, and agree with
the plain versions to ``TOLERANCE``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (TOLERANCE, gqa_decode_attention,  # noqa: E402
                                                  gqa_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402

# (H, KV, q heads a rank, first q head): yi-9b at 8 (rank 5), qwen3-8b at 16
# (rank 3), internvl2-2b at 16 (rank 7), and shares spanning two kv heads
SHARES = [(32, 4, 4, 20), (32, 8, 2, 6), (16, 8, 1, 7), (12, 3, 6, 6), (40, 8, 10, 10)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,h_loc,h0", SHARES)
@pytest.mark.parametrize("b,s", [(4, 1), (2, 5), (1, 16), (1, 64)])
def test_gqa_rank_rows_bitwise_the_whole_call(cuda, h, kv, h_loc, h0, b, s):
    t, hd = 300, 128
    gen = torch.Generator(device=cuda).manual_seed(h0 * 100 + s)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    ck, cv = (torch.randn((b, t, kv, hd), generator=gen, device=cuda) for _ in range(2))
    pos = torch.randint(-1, t, (b, s), generator=gen, device=cuda).to(torch.int32)
    scale = 1.0 / math.sqrt(hd)
    share = dict(head_offset=h0, groups=h // kv)
    lq = q[:, :, h0:h0 + h_loc].contiguous()
    whole = gqa_decode_attention(q, ck, cv, pos, scale=scale)[:, :, h0:h0 + h_loc]
    got = gqa_decode_attention(lq, ck, cv, pos, scale=scale, plan_dims=(b, h, kv), **share)
    assert torch.equal(got, whole)
    want = gqa_decode_attention_ref(lq, ck, cv, pos, scale=scale, **share)
    assert (got - want).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,h_loc,h0", SHARES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_rank_rows_bitwise_the_whole_call(cuda, h, kv, h_loc, h0, causal):
    s, hd = 200, 128
    gen = torch.Generator(device=cuda).manual_seed(h0)
    q = torch.randn((1, s, h, hd), generator=gen, device=cuda)
    k, v = (torch.randn((1, s, kv, hd), generator=gen, device=cuda) for _ in range(2))
    share = dict(head_offset=h0, groups=h // kv)
    lq = q[:, :, h0:h0 + h_loc].contiguous()
    whole = flash_attention(q, k, v, causal=causal)[:, :, h0:h0 + h_loc]
    got = flash_attention(lq, k, v, causal=causal, **share)
    assert torch.equal(got, whole)
    want = flash_attention_ref(lq, k, v, causal=causal, **share)
    assert (got - want).abs().max().item() <= TOLERANCE
