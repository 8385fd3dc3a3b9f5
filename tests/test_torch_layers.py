"""The port's layer primitives against the JAX package's.

Every test makes its inputs and weights with numpy from one seed and hands
the same arrays to ``repro.models.layers`` (JAX on the CPU, the Pallas
attention kernel in interpret mode) and to ``repro_torch.models.layers``
(``device="cpu"``, where the kernel is its plain version). Tolerances: f32
2e-5 and bf16 2e-2, as the JAX kernel tests; decode against full attention
3e-5, as ``tests/test_kernels.py`` holds it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import analysis as janalysis
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models.sharding import MeshCtx as JMeshCtx
from repro_torch.configs import get_arch
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _cfgs(**over):
    """Reduced glm4-9b (4 q heads over 2 kv heads of 16, rotary on half
    of each head) in both packages."""
    return (dataclasses.replace(jget_arch("glm4-9b").reduced(), **over),
            dataclasses.replace(get_arch("glm4-9b").reduced(), **over))


def _unit(jcfg, name):
    return janalysis.build_plan(jcfg, None, n_groups=2).get(name)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _load(module, arrays):
    """Copy numpy weights into a port module, in its parameters' dtypes."""
    module.load_state_dict({
        k: torch.from_numpy(np.asarray(arrays[k], np.float32)).to(p.dtype)
        for k, p in module.state_dict().items()
    })
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(rng, dtype):
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-5)
    got = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_f32(got), _f32(want), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_apply_rope(rng, fraction):
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 40]).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if fraction < 1.0:  # the unrotated half passes through untouched
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


def test_mlp(rng):
    jcfg, tcfg = _cfgs()
    d, f = jcfg.d_model, jcfg.d_ff
    w = {"wi_gate": rng.normal(size=(d, f)) * d**-0.5,
         "wi_up": rng.normal(size=(d, f)) * d**-0.5,
         "wo": rng.normal(size=(f, d)) * f**-0.5}
    x = rng.normal(size=(2, 11, d)).astype(np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v, jnp.float32) for k, v in w.items()},
                        jnp.asarray(x, jnp.bfloat16), jcfg, JMeshCtx(None),
                        _unit(jcfg, "g0/ffn"), act=jcfg.act)
    mlp = _load(TL.MLP(tcfg, "cpu"), w)
    got = mlp(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def _attn_weights(rng, cfg):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    return {"wq": rng.normal(size=(d, H, hd)) * d**-0.5,
            "wk": rng.normal(size=(d, K, hd)) * d**-0.5,
            "wv": rng.normal(size=(d, K, hd)) * d**-0.5,
            "wo": rng.normal(size=(H, hd, d)) * (H * hd) ** -0.5}


@pytest.mark.parametrize("over", [{}, {"attn_logit_softcap": 20.0}])
def test_attention_prefill(rng, over):
    """The attention layer at prefill: output and the post-RoPE k, v it
    hands back for the decode cache."""
    jcfg, tcfg = _cfgs(**over)
    w = _attn_weights(rng, jcfg)
    B, S = 2, 24
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, wkv = JL.attention_apply(
        {k: jnp.asarray(v, jnp.float32) for k, v in w.items()},
        jnp.asarray(x, jnp.bfloat16), jcfg, JMeshCtx(None), _unit(jcfg, "g0/attn"),
        jnp.asarray(pos), return_kv=True, interpret=True)
    attn = _load(TL.Attention(tcfg, "cpu"), w)
    got, tkv = attn(torch.from_numpy(x).to(torch.bfloat16),
                    torch.from_numpy(pos.copy()).long(), return_kv=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tkv[key]), _f32(wkv[key]), **BF16)


def _decode_case(rng, W, S_pos):
    """q (B,1,H,D), new k/v (B,1,K,D), a filled cache of W slots, and each
    row's absolute position."""
    B, H, K, D = 2, 4, 2, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    ck = rng.normal(size=(B, W, K, D)).astype(np.float32)
    cv = rng.normal(size=(B, W, K, D)).astype(np.float32)
    pos = np.asarray(S_pos, np.int32)[:, None]
    return q, kn, vn, ck, cv, pos


@pytest.mark.parametrize("layout,window,W,S_pos", [
    ("direct", 0, 40, [17, 31]),
    ("direct", 8, 40, [17, 31]),
    ("rotating", 16, 16, [5, 37]),
    ("rotating", 16, 16, [16, 100]),
])
def test_decode_attention(rng, layout, window, W, S_pos):
    q, kn, vn, ck, cv, pos = _decode_case(rng, W, S_pos)
    rotating = layout == "rotating"
    kw = dict(local_window=window, logit_softcap=0.0, rotating=rotating)
    jout, jcache = JL.decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(pos), **kw)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    tout, tcache = TL.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        cache, torch.from_numpy(pos).long(), **kw)
    assert tcache is cache  # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))


def test_decode_attention_softcap(rng):
    q, kn, vn, ck, cv, pos = _decode_case(rng, 24, [9, 20])
    kw = dict(local_window=0, logit_softcap=5.0)
    jout, _ = JL.decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(pos), **kw)
    tout, _ = TL.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        {"k": torch.from_numpy(ck), "v": torch.from_numpy(cv)},
        torch.from_numpy(pos).long(), **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)


def test_decode_attention_matches_full_attention(rng):
    """Decoding token S against a cache of the first S equals row S of full
    causal attention over S + 1 tokens."""
    B, S, H, K, D = 2, 32, 4, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, S + 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S + 1, K, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S + 1, K, D)).astype(np.float32))
    full = tref.attention_ref(q, k, v, causal=True)
    pad = torch.zeros((B, 8, K, D))
    cache = {"k": torch.cat([k[:, :S], pad], 1), "v": torch.cat([v[:, :S], pad], 1)}
    pos = torch.full((B, 1), S, dtype=torch.long)
    out, _ = TL.decode_attention(q[:, S:], k[:, S:], v[:, S:], cache, pos,
                                 local_window=0, logit_softcap=0.0)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, S].numpy(), atol=3e-5, rtol=3e-5)
    # and the JAX oracle agrees on the same row
    jfull = jref.attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), causal=True)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(jfull[:, S]), atol=3e-5, rtol=3e-5)


def test_ring_cache_is_not_ported_yet(rng):
    q, kn, vn, ck, cv, pos = _decode_case(rng, 8, [3, 4])
    cache = {"k": torch.from_numpy(ck), "v": torch.from_numpy(cv),
             "k_ring": torch.from_numpy(ck), "v_ring": torch.from_numpy(cv)}
    with pytest.raises(NotImplementedError, match="ring"):
        TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kn),
                            torch.from_numpy(vn), cache, torch.from_numpy(pos).long(),
                            local_window=0, logit_softcap=0.0)
