"""The port's Mamba-2 SSD scan, decode recurrence, causal conv and SSD block
against the JAX package's.

Every test makes its inputs with numpy from one seed and hands the same
arrays to ``repro`` (JAX on the CPU) and to ``repro_torch`` on CPU tensors,
where ``ops.ssd_scan`` runs the CUDA kernel's plain version. The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the same plain version.

Tolerances: the SSD tolerance of the JAX kernel tests (``tests/test_kernels.py``),
atol 2e-4 and rtol 2e-3, for float32 scans and states; bf16 outputs at
2e-2, the JAX kernel tests' bf16 tolerance (both sides round a float32
result to bf16, so they differ by at most one bf16 ulp); the SSD block
against ``ssd_apply`` run op by op (``jax.disable_jit()``) at 2e-5 but for
rare bf16 rounding flips (``_close_but_for_flips``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import analysis as janalysis
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro.models.sharding import MeshCtx as JMeshCtx
from repro_torch.configs import get_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.models import mamba as tmamba
from repro_torch.models.convert import params_from_jax

SSD = dict(atol=2e-4, rtol=2e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=2e-5, rtol=2e-5)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, B, S, H, P, N):
    """x, dt, A, B, C as float32 numpy, with the JAX kernel tests' ranges."""
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.1, size=(B, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 1.5, size=(H,))).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


def _cast(arrays, dtype):
    """(JAX arrays, torch tensors): x, B and C in ``dtype``, dt and A float32."""
    dts = [dtype, "float32", "float32", dtype, dtype]
    return ([jnp.asarray(a, JDT[d]) for a, d in zip(arrays, dts)],
            [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, dts)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_oracle(jx, chunk):
    """The reference's prefill path (``ssd_apply`` with ``return_cache``):
    the chunk cut to S, zero padding to a multiple of it, then
    ``ssd_ref(return_state=True)``."""
    x, dt, A, Bm, Cm = jx
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    x, dt, Bm, Cm = (jnp.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
                     for a in (x, dt, Bm, Cm))
    y, state = jref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_state=True)
    return y[:, :S], state


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [64, 50, 256])
def test_ssd_scan_matches_pallas(rng, S, chunk):
    """f32 scan against the JAX ``ops.ssd_scan`` running the Pallas kernel
    in interpret mode; S = 50 pads a ragged tail."""
    jx, tx = _cast(_inputs(rng, 2, S, 2, 16, 16), "float32")
    launches = tssd.launches
    want = jops.ssd_scan(*jx, chunk=chunk, interpret=True)
    got = tops.ssd_scan(*tx, chunk=chunk)
    assert tssd.launches == launches  # a CPU tensor never reaches the kernel
    assert got.shape == (2, S, 2, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **SSD)


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (37, 256)])
def test_ssd_scan_final_state(rng, S, chunk):
    """y and the final state against ``ssd_ref(return_state=True)`` on the
    reference's prefill padding; S = 37 with chunk 256 is one chunk of 37."""
    jx, tx = _cast(_inputs(rng, 2, S, 3, 8, 16), "float32")
    wy, ws = _jax_oracle(jx, chunk)
    gy, gs = tops.ssd_scan(*tx, chunk=chunk, return_state=True)
    assert gs.shape == (2, 3, 8, 16) and gs.dtype == torch.float32
    np.testing.assert_allclose(_f32(gy), _f32(wy), **SSD)
    np.testing.assert_allclose(_f32(gs), _f32(ws), **SSD)


def test_ssd_scan_bf16_matches_the_oracle(rng):
    """bf16 x, B and C: y (bf16) and the final state (float32) against
    ``ssd_ref``, which takes ``x * dt`` in float32, as the port does."""
    jx, tx = _cast(_inputs(rng, 1, 96, 2, 16, 16), "bfloat16")
    wy, ws = _jax_oracle(jx, 32)
    gy, gs = tops.ssd_scan(*tx, chunk=32, return_state=True)
    assert gy.dtype == torch.bfloat16 and gs.dtype == torch.float32
    np.testing.assert_allclose(_f32(gy), _f32(wy), **BF16)
    np.testing.assert_allclose(_f32(gs), _f32(ws), **SSD)


def test_pallas_path_rounds_x_dt_where_the_oracle_does_not(rng):
    """The reference's Pallas path rounds ``x * dt`` to x's dtype
    (``ssd_pallas``), its oracle ``ssd_ref`` keeps it in float32. With bf16
    x, on these inputs, the Pallas path's y differs from the oracle's at 410
    of 1,024 elements, by up to a bf16 ulp (0.0078 at |y| up to 2.34); the
    port follows the oracle and differs from it at none."""
    jx, tx = _cast(_inputs(rng, 1, 64, 2, 8, 8), "bfloat16")
    pallas = _f32(jops.ssd_scan(*jx, chunk=16, interpret=True))
    oracle = _f32(jref.ssd_ref(*jx, chunk=16))
    port = _f32(tops.ssd_scan(*tx, chunk=16))
    np.testing.assert_allclose(pallas, oracle, **BF16)
    assert (pallas != oracle).mean() > 0.2
    np.testing.assert_allclose(port, oracle, **BF16)
    assert (port != oracle).mean() < 0.01


def test_ssd_decode_matches_jax(rng):
    """One token of the recurrence, bf16 x as the model feeds it."""
    B, H, P, N = 2, 4, 8, 16
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, size=(B, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    jx, tx = _cast((x, dt, A, Bm, Cm), "bfloat16")
    wy, ws = jops.ssd_decode(*jx, jnp.asarray(state))
    gy, gs = tops.ssd_decode(*tx, torch.from_numpy(state))
    assert gy.dtype == torch.bfloat16 and gs.dtype == torch.float32
    np.testing.assert_allclose(_f32(gy), _f32(wy), **BF16)
    np.testing.assert_allclose(_f32(gs), _f32(ws), **F32)


def test_segsum_matches_jax(rng):
    x = rng.normal(size=(3, 12)).astype(np.float32)
    want = np.asarray(jref._segsum(jnp.asarray(x)))
    got = tref._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **F32)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """The wrapper launches or raises; a tensor off the card raises before
    anything is built, and ``ops`` sends every tensor that is not on the
    CPU to the wrapper."""
    launches = tssd.launches
    x = torch.zeros((1, 32, 2, 8))
    dt, A = torch.zeros((1, 32, 2)), torch.zeros((2,))
    bm = torch.zeros((1, 32, 16))
    cases = [
        ((x, dt, A, bm, bm), {}, ValueError, "not CUDA"),
        ((x.to("meta"), dt.to("meta"), A.to("meta"), bm.to("meta"), bm.to("meta")), {},
         ValueError, "not CUDA"),
    ]
    for args, kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            tssd.ssd_scan(*args, chunk=16, **kw)
    with pytest.raises(ValueError, match="not CUDA"):
        tops.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"), bm.to("meta"),
                      bm.to("meta"), chunk=16)
    assert tssd.launches == launches


def test_kernel_wrapper_checks_dtypes_and_shapes(monkeypatch):
    """With the device check passed, the wrapper's other checks raise on
    what the kernel does not take, before anything is built."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    x = torch.zeros((1, 32, 2, 8))
    dt, A, bm = torch.zeros((1, 32, 2)), torch.zeros((2,)), torch.zeros((1, 32, 16))
    cases = [
        ((x.half(), dt, A, bm, bm), 16, TypeError, "one dtype"),
        ((x, dt, A, bm.bfloat16(), bm), 16, TypeError, "one dtype"),
        ((x, dt.double(), A, bm, bm), 16, TypeError, "float32 dt"),
        ((x, dt[:, :16], A, bm, bm), 16, ValueError, "shapes"),
        ((torch.zeros((1, 32, 8, 2)).transpose(2, 3), dt, A, bm, bm), 16, ValueError,
         "unit stride"),
        ((x, dt, A, torch.zeros((1, 16, 32)).transpose(1, 2), bm), 16, ValueError,
         "unit stride"),
        ((x, dt, A, torch.zeros((1, 32, 129)), torch.zeros((1, 32, 129))), 16, ValueError,
         "N=129"),
        ((x, dt, A, bm, bm), 12, ValueError, "not a multiple"),
        ((x, dt, A, bm, bm), 512, ValueError, "chunk 512"),
    ]
    for args, chunk, exc, match in cases:
        with pytest.raises(exc, match=match):
            tssd._check(*args, chunk)


# ---------------------------------------------------------------------------
# the causal conv and the SSD block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_cache", [False, True], ids=["no-cache", "cache"])
def test_causal_conv_matches_jax(rng, with_cache):
    """bf16 input, float32 taps summed in the reference's order: equal."""
    B, S, C, W = 2, 9 if not with_cache else 1, 24, 4
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    w = (rng.normal(size=(W, C)) * 0.1).astype(np.float32)
    cache = rng.normal(size=(B, W - 1, C)).astype(np.float32) if with_cache else None
    bf = jnp.bfloat16
    wy, wc = jmamba._causal_conv(jnp.asarray(x, bf), jnp.asarray(w),
                                 None if cache is None else jnp.asarray(cache, bf))
    gy, gc = tmamba._causal_conv(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                 None if cache is None else torch.from_numpy(cache).bfloat16())
    assert gy.dtype == torch.bfloat16 and gc.shape == (B, W - 1, C)
    np.testing.assert_array_equal(_f32(gy), _f32(wy))
    np.testing.assert_array_equal(_f32(gc), _f32(wc))


def _block_pair():
    """Reduced mamba2-1.3b (d 64, inner 128, 8 heads of 16, N 16, chunk 32)
    in both packages, the JAX weights from ``ssd_init`` carried into the
    port's ``SSD`` by ``params_from_jax``."""
    jcfg = jget_arch("mamba2-1.3b").reduced()
    tcfg = get_arch("mamba2-1.3b").reduced()
    jp = jmamba.ssd_init(jax.random.key(3), jcfg)
    state = {k.removeprefix("ssd."): v for k, v in
             params_from_jax({"ssd": jax.tree.map(np.asarray, jp)}).items()}
    block = tmamba.SSD(tcfg, "cpu")
    block.load_state_dict(state)
    unit = janalysis.build_plan(jcfg, None, n_groups=2).get("g0/ssd")
    return jcfg, jp, unit, block


def test_ssd_params_keep_the_reference_dtypes():
    _, jp, _, block = _block_pair()
    got = {k: v.dtype for k, v in block.state_dict().items()}
    assert set(got) == set(jp)
    for k, dt in got.items():
        assert dt == (torch.float32 if k in tmamba.F32_LEAVES else torch.bfloat16), k
    np.testing.assert_array_equal(block.A_log.numpy(), np.asarray(jp["A_log"]))


def _close_but_for_flips(got, want):
    """Equal to 2e-5 but for rare bf16 rounding flips. The CPU matmuls of
    XLA and of PyTorch sum in other orders, so now and then a float32
    result a few ulps apart rounds to the neighbouring bf16 value (about
    one element in 3,000 after the B|C projection on these inputs), and
    what follows carries it on by about a bf16 ulp. So every element is
    held at bf16's 2e-2, and at most 0.1% of them may be beyond 2e-5: a
    wrong cast or a wrong padded tail moves far more."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, **BF16)
    off = ~np.isclose(g, w, **F32)
    assert off.mean() <= 1e-3, f"{int(off.sum())} of {off.size} elements beyond 2e-5"


@pytest.mark.parametrize("S", [11, 45])
def test_ssd_block_train_and_prefill_match_jax(rng, S):
    """The cache-free forward and the prefill (output, conv tails, final
    state); S = 45 is a full chunk of 32 and a padded tail."""
    jcfg, jp, unit, block = _block_pair()
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jxb, txb = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    mctx = JMeshCtx(None)
    with jax.disable_jit():
        wy, _ = jmamba.ssd_apply(jp, jxb, jcfg, mctx, unit)
        wpy, wc = jmamba.ssd_apply(jp, jxb, jcfg, mctx, unit, return_cache=True)
    gy, none = block(txb)
    gpy, gc = block(txb, return_cache=True)
    assert none is None and gy.dtype == torch.bfloat16
    _close_but_for_flips(gy, wy)
    _close_but_for_flips(gpy, wpy)
    for key in ("conv_x", "conv_bc", "state"):
        assert gc[key].shape == wc[key].shape and gc[key].dtype == TDT[str(wc[key].dtype)], key
        _close_but_for_flips(gc[key], wc[key])


def test_ssd_block_decode_matches_jax(rng):
    """Three decode steps from a prefilled cache, the port's updated in
    place."""
    jcfg, jp, unit, block = _block_pair()
    mctx = JMeshCtx(None)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        _, jc = jmamba.ssd_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg, mctx, unit,
                                 return_cache=True)
    _, tc = block(torch.from_numpy(x).bfloat16(), return_cache=True)
    for step in range(3):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        with jax.disable_jit():
            wy, jc = jmamba.ssd_apply(jp, jnp.asarray(xt, jnp.bfloat16), jcfg, mctx, unit,
                                      cache=jc)
        before = tc["state"]
        gy, tc2 = block(torch.from_numpy(xt).bfloat16(), cache=tc)
        assert tc2 is tc and tc["state"] is before  # updated in place
        _close_but_for_flips(gy, wy)
        for key in ("conv_x", "conv_bc", "state"):
            _close_but_for_flips(tc[key], jc[key])
