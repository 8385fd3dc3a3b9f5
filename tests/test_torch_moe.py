"""The port's MoE path against the JAX package's.

The same seeded numpy inputs go through both packages: the row gather
(the JAX Pallas kernel in interpret mode, as the JAX kernel tests run it,
against the port's plain version, which is what its CUDA kernel computes),
``moe_permute`` forward and backward, the capacity routing, and the whole
MoE layer at reduced moonshot-v1-16b-a3b widths. A gather is a copy, so
gathers are held to exact equality; the layer is held at the f32 tolerance
of the JAX kernel tests, 2e-5, once under a routing that drops nothing and
once under a skewed one that drops assignments.
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
from repro.kernels.gather_rows import gather_rows_pallas
from repro.models import moe as jmoe
from repro.models.sharding import MeshCtx as JMeshCtx
from repro_torch.configs import get_arch
from repro_torch.kernels import gather_rows as tgr
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32 = dict(atol=2e-5, rtol=2e-5)
ARCH = "moonshot-v1-16b-a3b"


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# the row gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,M,d", [(23, 17, 32), (40, 64, 128), (9, 5, 80), (7, 13, 1)])
def test_gather_rows_plain_matches_pallas(rng, dtype, N, M, d):
    """-1 rows, M not a multiple of the kernel's 8 rows per block, d = 1."""
    src = rng.normal(size=(N, d)).astype(np.float32)
    idx = rng.integers(-1, N, size=(M,)).astype(np.int32)
    idx[0] = -1
    want = gather_rows_pallas(jnp.asarray(src, JDT[dtype]), jnp.asarray(idx), interpret=True)
    got = tgr.gather_rows_plain(torch.from_numpy(src).to(TDT[dtype])[None],
                                torch.from_numpy(idx)[None])[0]
    assert got.dtype == TDT[dtype] and got.shape == (M, d)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_clips_like_the_jnp_branch(rng, dtype):
    """Indices past the last row read the last row, as the reference's
    clipped ``take_along_axis`` does (the Pallas kernel is never handed
    one)."""
    G, N, M, d = 2, 11, 30, 16
    src = rng.normal(size=(G, N, d)).astype(np.float32)
    idx = rng.integers(-1, N + 6, size=(G, M)).astype(np.int32)
    assert (idx >= N).any() and (idx < 0).any()
    want = jops._rows(jnp.asarray(src, JDT[dtype]), jnp.asarray(idx), False, "ref")
    got = tgr.gather_rows_plain(torch.from_numpy(src).to(TDT[dtype]), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_gather_kernel_wrapper_refuses_what_it_does_not_take():
    """The wrapper launches or raises; a tensor off the card raises before
    anything is built, and ``ops`` sends every tensor that is not on the
    CPU to the wrapper."""
    launches = tgr.launches
    src, idx = torch.zeros((2, 8, 16)), torch.zeros((2, 5), dtype=torch.int32)
    cases = [
        (src.half(), idx, TypeError, "float32 or bfloat16"),
        (src, idx.long(), TypeError, "int32"),
        (src[0], idx, ValueError, r"\(G, N, d\)"),
        (src, idx[:1], ValueError, r"\(G, N, d\)"),
        (src.transpose(1, 2), idx, ValueError, "unit stride"),
        (torch.zeros((65536, 1, 1)), torch.zeros((65536, 1), dtype=torch.int32),
         ValueError, "G=65536"),
        (src, idx, ValueError, "not CUDA"),
        (src.to("meta"), idx.to("meta"), ValueError, "not CUDA"),
    ]
    for s, i, exc, match in cases:
        with pytest.raises(exc, match=match):
            tgr.gather_rows(s, i)
    with pytest.raises(ValueError, match="not CUDA"):
        tops.moe_permute(src.to("meta"), idx.to("meta"), idx.to("meta"), 1)
    assert tgr.launches == launches


# ---------------------------------------------------------------------------
# moe_permute and the capacity routing
# ---------------------------------------------------------------------------


def _routing(rng, T, k, E, skew):
    """(T, k) distinct expert ids per token; ``skew`` puts expert 0 in
    every token's choice, so that it overflows its capacity."""
    eids = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    if skew:
        eids[:, 0] = 0
        eids[:, 1:] = np.stack([1 + rng.permutation(E - 1)[: k - 1] for _ in range(T)])
    return eids


def _port_route(eids, E, cap):
    """The port's route per group: (G, ...) int32 numpy arrays."""
    outs = [tmoe.route(torch.from_numpy(e), E, cap) for e in eids]
    return [np.stack([o[j].numpy() for o in outs]) for j in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_permute_forward_matches_jax(rng, dtype):
    """Dispatch and combine at G=2 equal the JAX op through the Pallas
    kernel in interpret mode, element for element."""
    G, T, k, E, d = 2, 12, 2, 4, 16
    cap = tmoe.capacity(T, k, E)
    eids = np.stack([_routing(rng, T, k, E, skew=(g == 1)) for g in range(G)])
    buf_src, tok_slots, flat_of_slot = _port_route(eids, E, cap)
    x = rng.normal(size=(G, T, d)).astype(np.float32)
    yb = rng.normal(size=(G, E * cap, d)).astype(np.float32)
    for src, out_idx, inv_idx, k_inv in ((x, buf_src, tok_slots, k),
                                         (yb, tok_slots, flat_of_slot, 1)):
        want = jops.moe_permute(jnp.asarray(src, JDT[dtype]), jnp.asarray(out_idx),
                                jnp.asarray(inv_idx), k_inv, True)
        got = tops.moe_permute(torch.from_numpy(src).to(TDT[dtype]),
                               torch.from_numpy(out_idx), torch.from_numpy(inv_idx), k_inv)
        assert got.dtype == TDT[dtype]
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_moe_permute_gradient_matches_jax(rng):
    """A dispatch / expert product / combine round trip with drops at G=2:
    the port's autograd gradient equals ``jax.grad`` through the JAX op."""
    G, T, k, E, d = 2, 12, 2, 4, 8
    cap = tmoe.capacity(T, k, E)
    eids = np.stack([_routing(rng, T, k, E, skew=True) for _ in range(G)])
    bs, ts, fs = _port_route(eids, E, cap)
    assert (ts < 0).any()  # some assignments are dropped
    x = rng.normal(size=(G, T, d)).astype(np.float32)
    w = rng.normal(size=(d, d)).astype(np.float32)

    def jloss(x):
        buf = jops.moe_permute(x, jnp.asarray(bs), jnp.asarray(ts), k, True)
        y = jops.moe_permute(buf @ jnp.asarray(w), jnp.asarray(ts), jnp.asarray(fs), 1, True)
        return (y**2).sum()

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tbs, tts, tfs = (torch.from_numpy(a) for a in (bs, ts, fs))
    buf = tops.moe_permute(tx, tbs, tts, k)
    y = tops.moe_permute(buf @ torch.from_numpy(w), tts, tfs, 1)
    tv = (y**2).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5)


@dataclasses.dataclass(frozen=True)
class _GroupedCtx(JMeshCtx):
    """Runs ``moe_apply``'s grouped branch on one CPU device: ``groups``
    token groups, every sharding constraint the identity. It needs a mesh
    to be chosen, so ``mesh`` is a stand-in that is not None."""

    mesh: object = "one device"
    groups: int = 2

    @property
    def dp_size(self):
        return self.groups

    @property
    def dp_axes(self):
        return ("data",)

    @property
    def model_size(self):
        return 1

    def wsc(self, x, *entries, enabled=True):
        return x


def _layer(rng, skew):
    """Reduced moonshot MoE params (JAX init, then a skewed router column
    when asked), an input x (B, S, d) and the JAX expert ids of its tokens."""
    cfg = jget_arch(ARCH).reduced()
    params = jmoe.moe_init(jax.random.key(0), cfg)
    B, S, d = 2, 24, cfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if skew:
        u = rng.normal(size=(d,)).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 3.0 * u
        params["router"] = params["router"].at[:, 0].add(jnp.asarray(2.0 * u))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    xt = jnp.asarray(x, jnp.bfloat16).reshape(B * S, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], axis=-1)
    _, jeids = jax.lax.top_k(probs, cfg.moe.top_k)
    return cfg, params, x, np.array(jeids)


def _port_moe(params):
    tcfg = get_arch(ARCH).reduced()
    state = params_from_jax({"moe": jax.tree.map(np.asarray, params)})
    moe = tmoe.MoE(tcfg, "cpu")
    moe.load_state_dict({key[len("moe."):]: v for key, v in state.items()})
    return tcfg, moe


@pytest.mark.parametrize("skew", [False, True], ids=["no-drops", "skewed-drops"])
def test_route_matches_jax(rng, monkeypatch, skew):
    """The port's route, group by group, against the index vectors that the
    JAX grouped branch hands to ``moe_permute``."""
    cfg, params, x, jeids = _layer(rng, skew)
    seen = []

    def record(src, out_idx, inv_idx, k_inv, *rest):
        seen.append((np.asarray(out_idx), np.asarray(inv_idx)))
        return jops._rows(src, out_idx, False, "ref")

    monkeypatch.setattr(jops, "moe_permute", record)
    jplan = janalysis.build_plan(cfg, None, n_groups=2)
    unit = dataclasses.replace(jplan.unit("g0/moe"), grouped_dispatch=True)
    ctx = _GroupedCtx()
    jmoe.moe_apply(params, jnp.asarray(x, jnp.bfloat16), cfg, ctx, unit)
    (buf_src, tok_slots), (tok_slots2, flat_of_slot) = seen
    np.testing.assert_array_equal(tok_slots, tok_slots2)

    E, k, G = cfg.moe.num_experts, cfg.moe.top_k, ctx.groups
    Tg = x.shape[0] * x.shape[1] // G
    cap = tmoe.capacity(Tg, k, E)
    got = _port_route(jeids.reshape(G, Tg, k), E, cap)
    for g, w in zip(got, (buf_src, tok_slots, flat_of_slot)):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (tok_slots < 0).any() == skew  # the skewed routing drops, the other not


@pytest.mark.parametrize("skew", [False, True], ids=["no-drops", "skewed-drops"])
def test_moe_layer_matches_jax(rng, skew):
    """The port's MoE against ``moe_apply`` with no mesh and the plan's
    ``g0/moe`` unit, op by op: the same experts for every token, the aux
    loss within 2e-5 and y within 2e-5 once widened to float32."""
    cfg, params, x, jeids = _layer(rng, skew)
    jplan = janalysis.build_plan(cfg, None, n_groups=2)
    with jax.disable_jit():
        jy, jaux = jmoe.moe_apply(params, jnp.asarray(x, jnp.bfloat16), cfg,
                                  JMeshCtx(None), jplan.unit("g0/moe"))
    tcfg, moe = _port_moe(params)
    assert moe.router.dtype == torch.float32 and moe.wi_gate.dtype == torch.bfloat16
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _, _, teids = moe.gate(tx.reshape(-1, tcfg.d_model))
    np.testing.assert_array_equal(teids.numpy(), jeids)
    T, k, E = x.shape[0] * x.shape[1], cfg.moe.top_k, cfg.moe.num_experts
    _, tok_slots, _ = tmoe.route(teids, E, tmoe.capacity(T, k, E))
    assert bool((tok_slots < 0).any()) == skew
    ty, taux = moe(tx)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **F32)
