"""The cached decode's attention (`ops.decode_attention`) on the CPU: its
plain version against the eager arithmetic that `SelfAttention.decode_step`
and `CrossAttention` ran before it, bit for bit, in bfloat16 and float32;
the kernel's gate; the wrapper on a CPU tensor runs the plain version and
launches nothing.  The kernel itself
is held to the plain version on the card (``tests/test_torch_cuda.py``)."""

import math

import pytest
import torch

from layoutdm_tpu_torch.ops import decode_attention as da

B, L, H, HD = 3, 7, 2, 6


def _former(q, keys, values, n, new=None):
    """The eager arithmetic before the kernel: `SelfAttention.decode_step`'s
    cache write and einsums (with ``new``), else `CrossAttention`'s."""
    Bq, S, Hq, hd = q.shape
    if new is not None:
        keys[:, n - 1] = new[0][:, 0]
        values[:, n - 1] = new[1][:, 0]
        keys, values = keys[:, :n], values[:, :n]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) / math.sqrt(hd)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, values).reshape(Bq, S, Hq * hd)


def _inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    slab = (torch.randn((B, 1, 3, H, HD), generator=g) * 2).to(dtype)
    q, k, v = slab.unbind(2)
    # the cross keys and values as views of a packed (B, L, 2, H, hd) slab
    kv = torch.randn((B, L, 2, H, HD), generator=g).to(dtype)
    return q, k, v, kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_former_arithmetic(dtype):
    q, k, v, kv = _inputs(dtype)
    ck, cv = kv.unbind(2)
    assert torch.equal(da.decode_attention_reference(q, ck, cv, L), _former(q, ck, cv, L))
    for n in (1, 4, L):
        caches = [torch.randn((B, L, H, HD)).to(dtype) for _ in range(2)]
        mine = [c.clone() for c in caches]
        got = da.decode_attention_reference(q, *mine, n, (k, v))
        want = _former(q, *caches, n, (k, v))
        assert torch.equal(got, want) and got.shape == (B, 1, H * HD)
        assert all(torch.equal(a, b) for a, b in zip(mine, caches))
        assert torch.equal(mine[0][:, n - 1], k[:, 0]) and torch.equal(mine[1][:, n - 1], v[:, 0])
    # the full-sequence cross-attention (teacher forcing) keeps it too
    qs = torch.randn((B, 5, H, HD)).to(dtype)
    assert torch.equal(da.decode_attention_reference(qs, ck, cv, L), _former(qs, ck, cv, L))


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v, kv = _inputs(torch.bfloat16, seed=1)
    before = da.LAUNCHES_DECODE_ATTN
    caches = [torch.zeros((B, L, H, HD), dtype=torch.bfloat16) for _ in range(2)]
    got = da.decode_attention(q, *caches, 3, (k, v))
    assert torch.equal(got, _former(q, *[torch.zeros_like(c) for c in caches], 3, (k, v)))
    assert torch.equal(da.decode_attention(q, *kv.unbind(2), L),
                       _former(q, *kv.unbind(2), L))
    assert da.LAUNCHES_DECODE_ATTN == before
    with pytest.raises(ValueError):
        da.decode_attention(torch.zeros((B, 2, H, HD)), *caches, 1)  # one query a row
    with pytest.raises(ValueError):
        da.decode_attention(q, *caches, L + 1)


@pytest.mark.parametrize("H,hd,L,dtype,admits", [
    (8, 42, 126, torch.bfloat16, True),   # BART's cell
    (8, 42, 126, torch.float32, True),
    (8, 64, 126, torch.bfloat16, True),   # LayoutTransformer's
    (16, 64, 1024, torch.float32, True),  # the limits
    (8, 41, 126, torch.float32, False),   # odd head width
    (17, 8, 126, torch.bfloat16, False),  # heads
    (2, 6, 126, torch.bfloat16, False),   # a 24-byte row is no whole 16-byte vectors
    (16, 66, 126, torch.bfloat16, False),  # wider than 1024
    (8, 42, 1025, torch.bfloat16, False),  # positions
    (8, 42, 126, torch.float16, False),
])
def test_gate(H, hd, L, dtype, admits):
    assert da.can_use_decode_attention(H, hd, L, dtype) is admits



@pytest.mark.parametrize("call", ["self", "cross"])
def test_kv_cache_attend_on_cpu_is_the_plain_version(call):
    """`KVCache.attend` on CPU tensors: the plain version on the cache's own
    tensors (the self call writes this step's k and v at ``index``), no
    launch and no operand check."""
    from layoutdm_tpu_torch.models.nn import KVCache

    q, k, v, kv = _inputs(torch.bfloat16, seed=2)
    cache = KVCache(2, B, L, H, HD, torch.bfloat16, "cpu")
    flipped = kv.flip(1)  # another layer's cross keys and values
    cache.cross_keys = [kv[:, :, 0], flipped[:, :, 0]]
    cache.cross_values = [kv[:, :, 1], flipped[:, :, 1]]
    cache.index = 3
    before = da.LAUNCHES_DECODE_ATTN
    if call == "self":
        want = _former(q, *[c.clone() for c in (cache.keys[1], cache.values[1])], 4, (k, v))
        got = cache.attend(q, 1, (k, v))
        assert torch.equal(cache.keys[1][:, 3], k[:, 0]) and torch.equal(cache.values[1][:, 3],
                                                                          v[:, 0])
    else:
        want = _former(q, cache.cross_keys[1], cache.cross_values[1], L)
        got = cache.attend(q, 1)
    assert torch.equal(got, want)
    assert da.LAUNCHES_DECODE_ATTN == before and not cache.checked
