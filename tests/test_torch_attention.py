"""The port's attention against the reference on the CPU: the flash
kernel's plain version against the Pallas kernel (interpret mode) and its
oracle, and the model's dense / chunked / decode attention against the
reference's, on the same numpy inputs.

Tolerances: 2e-5 in fp32 and 5e-2 in bf16, those of
``tests/test_kernels.py`` (the two sides add in another order; bf16 rounds
its inputs and output to 8 bits of mantissa)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import layers as TL

FLASH_CASES = [
    # (b, sq, sk, h, hkv, d, causal, window): tests/test_kernels.py:25-34
    (1, 128, 128, 2, 2, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 384, 384, 8, 1, 32, True, None),
    (1, 128, 128, 4, 4, 128, False, None),
    (2, 200, 200, 2, 2, 64, True, 64),
    (1, 512, 512, 2, 1, 64, True, 128),
    (1, 96, 96, 2, 2, 16, True, None),
]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def _qkv(case, seed=0):
    b, sq, sk, h, hkv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_reference_kernel_and_oracle(case, dtype):
    causal, window = case[6], case[7]
    jd, td = DTYPES[dtype]
    q, k, v = _qkv(case)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    before = tfa.LAUNCHES["flash_attention"].count
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tfa.LAUNCHES["flash_attention"].count == before   # plain, no launch
    assert got.dtype == td and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))
    port_oracle = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                           window=window)
    np.testing.assert_allclose(_f32(port_oracle), _f32(oracle),
                               **_tol(dtype))


def test_flash_fully_masked_rows_give_zero():
    """Rows past the keys under a one-key window see no key at all: the
    reference kernel clamps l and outputs 0, so does the port."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 4, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 4, 2, 16)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, window=1, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False, window=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not got[:, 4:].any()


@pytest.mark.parametrize("d", [8, 24, 272])
def test_flash_rejects_unsupported_head_dim(d):
    x = torch.zeros((1, 4, 2, d))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(x, x, x)


ATTN_CASES = [
    # (b, s, h, hkv, d, causal, window)
    (2, 64, 4, 2, 16, True, None),
    (1, 96, 4, 1, 32, True, 16),
    (2, 64, 4, 4, 16, False, None),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_dense_and_chunked_match_reference(case):
    b, s, h, hkv, d, causal, window = case
    q, k, v = _qkv((b, s, s, h, hkv, d, causal, window), seed=2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = JL.attention_dense(jq, jk, jv, causal=causal, window=window)
    got = TL.attention_dense(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    want_c = JL.attention_chunked(jq, jk, jv, causal=causal, window=window,
                                  chunk_q=32, chunk_k=16)
    got_c = TL.attention_chunked(tq, tk, tv, causal=causal, window=window,
                                 chunk_q=32, chunk_k=16)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_chunked_bf16_matches_reference(case):
    """bf16 inputs: both packages cast each key block's softmax to bf16
    before its product with v, which the flash plain version (fp32
    throughout) does not."""
    b, s, h, hkv, d, causal, window = case
    q, k, v = _qkv((b, s, s, h, hkv, d, causal, window), seed=5)
    want = JL.attention_chunked(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), causal=causal,
                                window=window, chunk_q=32, chunk_k=16)
    got = TL.attention_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), causal=causal,
                               window=window, chunk_q=32, chunk_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("bf16"))


@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("valid_len", [1, 13, 32])
def test_attention_decode_matches_reference(cache_dtype, valid_len):
    """fp32 query against an fp32 or bf16 cache: the bf16 case casts the
    softmax to bf16 before the product with v in both packages."""
    jd, td = DTYPES[cache_dtype]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = JL.attention_decode(jnp.asarray(q), jnp.asarray(kc, jd),
                               jnp.asarray(vc, jd), valid_len)
    got = TL.attention_decode(torch.from_numpy(q),
                              torch.from_numpy(kc).to(td),
                              torch.from_numpy(vc).to(td), valid_len)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(cache_dtype))


def test_rope_matches_reference():
    pos = np.arange(40)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 16)).astype(
        np.float32)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    got = TL.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
