"""The port's model and serving engine against the JAX package's.

Reduced glm4-9b (dense), reduced moonshot-v1-16b-a3b (MoE, 4 experts,
top-2, a shared expert) and reduced mamba2-1.3b (SSD layers: 8 heads of 16,
state 16, chunk 32), each with four layers, so that each of the two layer
groups stacks two. The JAX init draws the weights from one key;
``params_from_jax`` carries them into the port. The JAX side runs the
Pallas attention kernel in interpret mode; the port runs on the CPU, where
every kernel is its plain version. The JAX mamba2 model runs with
``interpret=False``: on the CPU its SSD scan is then ``ssd_ref``, which
takes ``x * dt`` in float32 as the port does, where the Pallas body would
round it to bfloat16 first and land a bfloat16 ulp away.

The JAX side runs with ``jax.disable_jit()``: compiled, XLA fuses the layer
scan and drops some of the bf16 roundings that the model's code writes
(the logits of reduced glm4-9b then move by up to about 0.05). Op by op,
the two packages round at the same places, and the logits are held at the
f32 tolerance of the JAX kernel tests, 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import analysis as janalysis
from repro.models.model import Model as JModel
from repro.serve import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.core import analysis
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import engine as tengine

F32 = dict(atol=2e-5, rtol=2e-5)
CTX = 64


def _seeded_init(jmodel, key):
    """``jmodel.init(key)`` with the layer stacks drawn again from keys that
    depend on ``key`` alone, by the reference's own per-layer init.
    ``Model.init`` folds ``hash(<stack name>)`` into each group's key, and
    Python salts ``str`` hashes per process, so its layer weights differ
    from one test process to the next."""
    params = jmodel.init(key)
    for gi, g in enumerate(jmodel.groups):
        assert g.kind in ("attn_mlp", "attn_moe", "ssd"), g.kind
        keys = jax.random.split(jax.random.fold_in(key, 1000 + gi), g.n_layers)
        params[g.name] = {"layers": jax.vmap(lambda r: jmodel._layer_init(r, g.kind))(keys)}
    return params


ARCHS = {"glm4-9b": "attn_mlp", "moonshot-v1-16b-a3b": "attn_moe",
         "mamba2-1.3b": "ssd"}  # arch: group kind


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(JAX cfg, plan, model, params; port cfg, plan, state dict)."""
    jcfg = dataclasses.replace(jget_arch(request.param).reduced(), n_layers=4)
    jplan = janalysis.build_plan(jcfg, None, n_groups=2)
    jmodel = JModel(jcfg, jplan, interpret=ARCHS[request.param] != "ssd")
    params = _seeded_init(jmodel, jax.random.key(0))
    tcfg = dataclasses.replace(get_arch(request.param).reduced(), n_layers=4)
    tplan = analysis.build_plan(tcfg, None, n_groups=2)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    return jcfg, jplan, jmodel, params, tcfg, tplan, state


def test_plan_and_groups_match(pair):
    jcfg, jplan, jmodel, _, tcfg, tplan, _ = pair
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.asdict(u) for u in tplan.units] == \
        [dataclasses.asdict(u) for u in jplan.units]
    tmodel = Model(tcfg, tplan, device="cpu")
    kind = ARCHS[tcfg.name]
    assert [(g.name, g.kind, g.n_layers) for g in tmodel.groups] == \
        [(g.name, g.kind, g.n_layers) for g in jmodel.groups] == \
        [("g0", kind, 2), ("g1", kind, 2)]


def test_params_from_jax_carries_every_weight(pair):
    _, _, jmodel, params, tcfg, tplan, state = pair
    model = Model(tcfg, tplan, device="cpu", params=state)  # strict load
    got = model.state_dict()
    assert got["final_norm.scale"].dtype == torch.float32
    if tcfg.ssm is None:
        np.testing.assert_array_equal(
            got["g1.layers.1.attn.wq"].float().numpy(),
            np.asarray(params["g1"]["layers"]["attn"]["wq"][1].astype(jnp.bfloat16), np.float32))
        assert got["g0.layers.0.norm_attn.scale"].dtype == torch.float32
        assert got["unembed.kernel"].dtype == torch.bfloat16
    else:
        assert "unembed.kernel" not in got  # tied embeddings
    # Every SSD leaf: its name, its shape and its dtype. The six small
    # leaves that the reference reads in float32 stay float32, exactly.
    ssd = {key: (tuple(t.shape), t.dtype) for key, t in got.items() if ".ssd." in key}
    want_ssd = {}
    if tcfg.ssm is not None:
        bf, f32 = torch.bfloat16, torch.float32
        d, N, W = tcfg.d_model, tcfg.ssm.state_dim, tcfg.ssm.conv_width
        inner = tcfg.ssm.expand * d
        H = inner // tcfg.ssm.head_dim
        leaves = {"w_z": ((d, inner), bf), "w_x": ((d, inner), bf), "w_bc": ((d, 2 * N), bf),
                  "w_dt": ((d, H), bf), "conv_x": ((W, inner), f32),
                  "conv_bc": ((W, 2 * N), f32), "dt_bias": ((H,), f32), "A_log": ((H,), f32),
                  "Dskip": ((H,), f32), "norm": ((inner,), f32), "w_out": ((inner, d), bf)}
        want_ssd = {f"{g.name}.layers.{i}.ssd.{leaf}": v for g in jmodel.groups
                    for i in range(g.n_layers) for leaf, v in leaves.items()}
        jssd = params["g1"]["layers"]["ssd"]
        for leaf in ("A_log", "dt_bias", "conv_x", "conv_bc", "norm", "Dskip"):
            np.testing.assert_array_equal(got[f"g1.layers.1.ssd.{leaf}"].numpy(),
                                          np.asarray(jssd[leaf][1]))
        np.testing.assert_array_equal(
            got["g1.layers.1.ssd.w_x"].float().numpy(),
            np.asarray(jssd["w_x"][1].astype(jnp.bfloat16), np.float32))
    assert ssd == want_ssd
    # Every MoE leaf: its name, its shape and its dtype (float32 router).
    moe = {key: (tuple(t.shape), t.dtype) for key, t in got.items() if ".moe." in key}
    want = {}
    if tcfg.moe is not None:
        d, f, E = tcfg.d_model, tcfg.d_ff, tcfg.moe.num_experts
        fs = f * tcfg.moe.shared_experts
        leaves = {"router": ((d, E), torch.float32), "wi_gate": ((E, d, f), torch.bfloat16),
                  "wi_up": ((E, d, f), torch.bfloat16), "wo": ((E, f, d), torch.bfloat16),
                  "shared.wi_gate": ((d, fs), torch.bfloat16),
                  "shared.wi_up": ((d, fs), torch.bfloat16),
                  "shared.wo": ((fs, d), torch.bfloat16)}
        want = {f"{g.name}.layers.{i}.moe.{leaf}": v for g in jmodel.groups
                for i in range(g.n_layers) for leaf, v in leaves.items()}
        np.testing.assert_array_equal(
            got["g0.layers.1.moe.router"].numpy(), np.asarray(params["g0"]["layers"]["moe"]["router"][1]))
    assert moe == want


def test_forward_logits_at_every_position(pair, rng):
    """Logits at every position, and the MoE layers' summed aux loss."""
    _, _, jmodel, params, tcfg, tplan, state = pair
    model = Model(tcfg, tplan, device="cpu", params=state)
    tokens = rng.integers(0, tcfg.vocab, size=(2, 11)).astype(np.int32)
    with jax.disable_jit():
        jlog, _, jaux = jmodel.forward(params, {"tokens": jnp.asarray(tokens)})
    tlog, raw, taux = model(torch.from_numpy(tokens).long())
    assert raw == {} and tlog.shape == (2, 11, model.vp)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    assert taux.dtype == torch.float32 and (float(taux) > 0) == (tcfg.moe is not None)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def test_prefill_and_decode_logits(pair, rng):
    """Prefill logits and three decode steps (same tokens fed to both)."""
    _check_prefill_and_decode(pair, rng, 13)


@pytest.mark.parametrize("pair", ["mamba2-1.3b"], indirect=True)
def test_prefill_over_a_chunk_and_a_padded_tail(pair, rng):
    """A 45-token prompt is longer than the reduced SSD chunk (32) and not a
    multiple of it: the scan runs a full chunk and a zero-padded one."""
    _check_prefill_and_decode(pair, rng, 45)


def _check_prefill_and_decode(pair, rng, S):
    _, _, jmodel, params, tcfg, tplan, state = pair
    model = Model(tcfg, tplan, device="cpu", params=state)
    tokens = rng.integers(0, tcfg.vocab, size=(2, S)).astype(np.int32)
    with jax.disable_jit():
        jlog, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)}, ctx_len=CTX)
    tlog, tcache = model.prefill(torch.from_numpy(tokens).long(), ctx_len=CTX)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    for step in range(3):
        nxt = np.array(jnp.argmax(jlog[:, : tcfg.vocab], -1), np.int32)[:, None]
        pos = np.full((2, 1), tokens.shape[1] + step, np.int32)
        with jax.disable_jit():
            jlog, jcache = jmodel.decode_step(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlog, tcache = model.decode_step(
            tcache, torch.from_numpy(nxt).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, model.vp)


def _reference_serve(jmodel, params, prompts, slots, max_new):
    """The JAX engine's schedule driven by hand over the reference's
    ``Model.prefill`` and ``Model.decode_step``: fill free slots in order,
    one batched decode step a tick, a request done at ``max_new`` tokens.
    Each prefill's cache is written into its slot along axis 1, the batch
    axis of every stacked cache leaf. (The JAX engine writes along axis
    ``ndim - 4``, which for the 4-D conv caches of an SSD model is the layer
    axis, so it cannot serve one.) Returns [(request id, tokens)] in the
    order the requests finish."""
    V = jmodel.cfg.vocab
    cache = jmodel.init_cache(slots, CTX)
    queue = list(enumerate(prompts))
    slot_req = [None] * slots
    pos = np.zeros((slots,), np.int32)
    last = np.zeros((slots,), np.int32)
    done = []
    while queue or any(r is not None for r in slot_req):
        for s in range(slots):
            if slot_req[s] is None and queue:
                rid, prompt = queue.pop(0)
                logits, c1 = jmodel.prefill(params, {"tokens": jnp.asarray(prompt[None])},
                                            ctx_len=CTX)
                cache = jax.tree.map(lambda full, one: full.at[:, s:s + 1].set(one), cache, c1)
                slot_req[s] = (rid, [int(jnp.argmax(logits[0, :V]))])
                pos[s], last[s] = len(prompt), slot_req[s][1][0]
        logits, cache = jmodel.decode_step(params, cache, jnp.asarray(last[:, None]),
                                           jnp.asarray(pos[:, None]))
        nxt = np.asarray(jnp.argmax(logits[:, :V], axis=-1), np.int32)
        for s in range(slots):
            if slot_req[s] is None:
                continue
            slot_req[s][1].append(int(nxt[s]))
            pos[s] += 1
            last[s] = nxt[s]
            if len(slot_req[s][1]) >= max_new or pos[s] >= CTX - 1:
                done.append(slot_req[s])
                slot_req[s] = None
    return done


def test_engine_greedy_tokens_match(pair):
    """3 requests over 2 slots, prompts of 8-24 tokens, 6 new tokens each:
    the port's engine gives the JAX engine's greedy tokens, token for token.
    For the SSD model, which the JAX engine cannot serve, the reference is
    its ``Model.prefill`` and ``Model.decode_step`` on the engine's slot
    schedule (``_reference_serve``)."""
    jcfg, jplan, jmodel, params, tcfg, tplan, state = pair
    lens = np.random.default_rng(1).integers(8, 25, size=3)
    prompts = [np.random.default_rng(2 + i).integers(0, tcfg.vocab, size=n).astype(np.int32)
               for i, n in enumerate(lens)]
    teng = tengine.Engine(tcfg, tplan, state, tengine.ServeConfig(slots=2, ctx_len=CTX),
                          device="cpu")
    for i, p in enumerate(prompts):
        teng.submit(tengine.Request(request_id=i, prompt=p, max_new_tokens=6))
    if ARCHS[tcfg.name] == "ssd":
        with jax.disable_jit():
            want = _reference_serve(jmodel, params, prompts, slots=2, max_new=6)
    else:
        jeng = jengine.Engine(jcfg, jplan, params, jengine.ServeConfig(slots=2, ctx_len=CTX),
                              interpret=True)
        for i, p in enumerate(prompts):
            jeng.submit(jengine.Request(request_id=i, prompt=p, max_new_tokens=6))
        with jax.disable_jit():
            want = [(r.request_id, r.output) for r in jeng.run_until_done()]
    got = [(r.request_id, r.output) for r in teng.run_until_done()]
    assert got == want
    assert all(len(out) == 6 for _, out in got)
    assert len(teng.prefill_s) == 3 and teng.decode_tokens == 3 * 5


def test_entry_points_need_the_card_by_default(pair, monkeypatch):
    """Without a GPU the default device raises; nothing carries on on the CPU."""
    _, _, _, _, tcfg, tplan, state = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(tcfg, tplan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.Engine(tcfg, tplan, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.build_engine(tcfg.name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_serves_on_the_cpu_when_asked(arch):
    stats = launcher.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                           "--slots", "2", "--prompt-len", "10", "--max-new", "4"])
    assert stats["requests"] == 3 and stats["tokens"] == 12
    assert stats["decode_steps"] == 6  # 3 steps serve requests 0 and 1 together, 3 request 2
    assert stats["peak_mem_gb"] is None  # read only on a CUDA device


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "gemma2-27b"])
def test_unported_group_kinds_raise(arch):
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, analysis.build_plan(cfg, None, n_groups=2), device="cpu")
