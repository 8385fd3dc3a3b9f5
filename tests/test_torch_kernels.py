"""The port's flash attention against the JAX package's.

Same seeded numpy inputs through the JAX Pallas kernel (interpret mode, as
the JAX kernel tests run it on the CPU) and through the port's
``ops.flash_attention`` on CPU tensors, which is the CUDA kernel's plain
PyTorch version. The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the same plain version.

Tolerances are the JAX kernel tests' (``tests/test_kernels.py``): f32
2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(rng, B, Sq, H, K, D, Sk=None):
    Sk = Sq if Sk is None else Sk
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, D)).astype(np.float32),
            rng.normal(size=(B, Sk, K, D)).astype(np.float32))


def _both(arrays, dtype, jax_fn, torch_fn, **kw):
    """(JAX result, port result) as float32 numpy, from the same arrays."""
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    want = np.asarray(jax_fn(*jx, **kw), np.float32)
    got = torch_fn(*tx, **kw).float().numpy()
    return got, want


def _vs_pallas(arrays, dtype="float32", **kw):
    launches = tfa.launches
    got, want = _both(arrays, dtype, lambda *a, **k: jops.flash_attention(
        *a, interpret=True, **k), tops.flash_attention, **kw)
    assert tfa.launches == launches  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(got, want, **TOL[dtype])


# ---------------------------------------------------------------------------
# the grid of tests/test_kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 128, 256])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2), (4, 1)])
def test_flash_attention_causal_gqa(rng, S, H, K):
    _vs_pallas(_qkv(rng, 2, S, H, K, 64), causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes(rng, dtype):
    _vs_pallas(_qkv(rng, 2, 128, 4, 2, 64), dtype, causal=True)


@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_flash_attention_head_dims(rng, D):
    _vs_pallas(_qkv(rng, 1, 128, 2, 2, D), causal=True)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_attention_local_window(rng, window):
    _vs_pallas(_qkv(rng, 1, 128, 2, 2, 64), causal=True, local_window=window)


def test_flash_attention_softcap(rng):
    _vs_pallas(_qkv(rng, 1, 128, 2, 2, 64), causal=True, logit_softcap=30.0)


def test_flash_attention_bidirectional(rng):
    _vs_pallas(_qkv(rng, 1, 128, 2, 2, 64), causal=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_glm4_heads(rng, dtype):
    """glm4-9b's head layout (32 q heads over 2 kv heads of 128) at S=64."""
    _vs_pallas(_qkv(rng, 1, 64, 32, 2, 128), dtype, causal=True)


# ---------------------------------------------------------------------------
# q_offset: the JAX Pallas branch drops it, so the port follows the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Sk,q_offset,window", [
    (16, 96, 80, 0),    # the last 16 rows of a 96-token causal prefix
    (32, 128, 40, 0),   # rows in the middle: keys past the row are masked
    (24, 96, 72, 16),   # with a sliding window
])
def test_flash_attention_q_offset(rng, Sq, Sk, q_offset, window):
    arrays = _qkv(rng, 2, Sq, 4, 2, 64, Sk=Sk)
    kw = dict(causal=True, local_window=window, q_offset=q_offset)
    got, want = _both(arrays, "float32", jref.attention_ref, tops.flash_attention, **kw)
    np.testing.assert_allclose(got, want, **TOL["float32"])


def test_flash_attention_rows_without_keys(rng):
    """Rows with every key masked get the mean of V, as the oracle gives."""
    arrays = _qkv(rng, 1, 40, 2, 1, 32)
    for kw in (dict(causal=True, q_offset=-5),
               dict(causal=True, local_window=8, q_offset=100)):
        got, want = _both(arrays, "float32", jref.attention_ref, tops.flash_attention, **kw)
        np.testing.assert_allclose(got, want, **TOL["float32"])


# ---------------------------------------------------------------------------
# the plain references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False), dict(causal=True, local_window=32),
    dict(causal=True, logit_softcap=20.0), dict(causal=True, q_offset=16),
])
def test_attention_chunked_matches_attention_ref(rng, kwargs):
    """The port's chunked recurrence equals its dense oracle and the JAX
    package's chunked reference (S=200 over chunks of 64: a ragged tail)."""
    arrays = _qkv(rng, 2, 200, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    got = tref.attention_chunked(tq, tk, tv, chunk=64, **kwargs).numpy()
    want = tref.attention_ref(tq, tk, tv, **kwargs).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    jwant = np.asarray(jref.attention_chunked(*map(jnp.asarray, arrays), chunk=64, **kwargs))
    np.testing.assert_allclose(got, jwant, atol=2e-5, rtol=2e-5)


def test_mask_bias_matches_jax():
    q_pos, k_pos = np.arange(10) + 5, np.arange(20)
    for causal, window in [(True, 0), (False, 4), (True, 3)]:
        got = tref._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                              causal, window).numpy()
        want = np.asarray(jref._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                          causal, window))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the wrapper: a kernel launch or an error, never the plain version
# ---------------------------------------------------------------------------


def test_kernel_wrapper_refuses_tensors_off_the_card():
    """The kernel's wrapper takes only CUDA tensors: a CPU or meta tensor
    raises before anything is built or launched, and ``ops`` sends every
    tensor that is not on the CPU to the wrapper."""
    launches = tfa.launches
    for device in ("cpu", "meta"):
        q = torch.zeros((1, 8, 2, 16), device=device)
        k = torch.zeros((1, 8, 1, 16), device=device)
        with pytest.raises(ValueError, match="not CUDA"):
            tfa.flash_attention(q, k, k)
    meta = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        tops.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    assert tfa.launches == launches


def test_library_name_follows_the_source(tmp_path):
    """A built library's name holds a hash of its source and flags, so an
    edited source is rebuilt and an unchanged one is loaded as it is."""
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build.library_path(src) != first
    assert [p.name for p in _build.sources()] == ["flash_attention.cu", "gather_rows.cu",
                                                  "ssd.cu"]
