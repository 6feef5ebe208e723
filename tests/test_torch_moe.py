"""The port's MoE block kind on the CPU against ``repro.models.moe``.

The reference's parameters (``init_moe`` / ``init_lm`` from a fixed
``jax.random.key``) are carried across as numpy arrays, and the same
numpy-seeded hidden states go through both packages in f32 at
``reduced()`` sizes (d_model 64, 8 experts, top-2, expert width 32).
Both routers: olmoe-1b-7b's softmax router, and deepseek-v3-671b's
sigmoid router with its shared expert (deepseek-v3 itself, with MLA
attention and MTP, still raises at the LM level).  Held: expert indices
exactly; keep masks exactly, against a numpy re-derivation from the
reference's ``_route`` (per-group queue positions against the per-group
capacity); outputs and the aux loss within ``atol=1e-5`` (f32 sums in
another order).  Then olmoe's ``init_lm`` tree and ``param_count``, its
``lm_forward`` (logits, hidden, aux) under capacity dispatch and
dropless, a plan of two groups (a leading dense layer before the MoE
layers), ``pooled_unit_embed`` and ``run_service`` end to end.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.launch.serve as jserve
from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving.embedder import pooled_unit_embed as j_pooled
from repro.serving.service import SSSJService as JService
import repro_torch.launch.serve as tserve
from repro_torch import configs as tconfigs
from repro_torch.models import (
    init_lm,
    init_lm_caches,
    lm_decode_step,
    lm_forward,
    param_count,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Initializer
from repro_torch.serving import LMEmbedder, SSSJService, pooled_unit_embed

CPU = "cpu"
ATOL = 1e-5
BAND = 1e-5
OLMOE = "olmoe-1b-7b"
ROUTERS = {"softmax": OLMOE, "sigmoid": "deepseek-v3-671b"}


def _cfgs(arch):
    return jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(np.shape(x)), tree)


def _moe_params(arch, seed=11):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = jmoe.init_moe(jcommon.Initializer(jax.random.key(seed)), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), CPU)


def _keep_numpy(idx: np.ndarray, E: int, G: int, cap_g: int) -> np.ndarray:
    """Which of the ``(T·K,)`` slots fit: each group's slots in order,
    counted per expert against the per-group capacity."""
    slots = idx.reshape(G, -1)
    keep = np.zeros(slots.shape, bool)
    for g in range(G):
        seen = np.zeros(E, np.int64)
        for j, e in enumerate(slots[g]):
            keep[g, j] = seen[e] < cap_g
            seen[e] += 1
    return keep.reshape(-1)


# (B, S, dropless, zero rows): T = 1,024 in 16 groups of 64 tokens (per-group
# capacity 20 slots, 16 expected: drops); T = 111, not a multiple of 16 (one
# group, capacity 35); dropless; all-zero hidden rows (E equal router scores)
CASES = {
    "groups_with_drops": (4, 256, False, ()),
    "one_group": (3, 37, False, ()),
    "dropless": (2, 20, True, ()),
    "zero_rows": (2, 24, False, ((0, 3), (1, 7), (1, 23))),
}


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_init_moe_mirrors_the_reference_tree(router):
    jcfg, tcfg, jp, _ = _moe_params(ROUTERS[router])
    got = params_to_numpy(tmoe.init_moe(Initializer(torch.Generator().manual_seed(0), CPU),
                                        tcfg))
    assert _shapes(got) == _shapes(_np(jp))
    assert ("shared" in got) == bool(jcfg.moe.n_shared_experts) == (router == "sigmoid")
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(got))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_matches(router, case):
    jcfg, tcfg, jp, tp = _moe_params(ROUTERS[router])
    B, S, dropless, zero_rows = CASES[case]
    mc = jcfg.moe
    x = np.random.default_rng(12).standard_normal((B, S, 64)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    T, E, K = B * S, mc.n_experts, mc.top_k

    # routing: expert indices exact, keep masks exact against numpy
    logits = x.reshape(T, 64) @ np.asarray(jp["router"])
    _, jidx, _ = jmoe._route(mc, jnp.asarray(logits))
    jidx = np.asarray(jidx)
    gate, idx, probs = tmoe._route(tcfg.moe, torch.from_numpy(logits))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    G, cap_g, keep, pos_c, g_of = tmoe._dispatch(tcfg.moe, idx, dropless)
    want_g = 1 if dropless or T % mc.dispatch_groups else mc.dispatch_groups
    want_cap = T if dropless else max(math.ceil(T // want_g * K / E * mc.capacity_factor), 4)
    assert (G, cap_g) == (want_g, want_cap)
    want_keep = _keep_numpy(jidx, E, G, cap_g)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case == "groups_with_drops":
        assert not want_keep.all()          # the reference drops slots here
    if dropless:
        assert want_keep.all()
    for b, s in zero_rows:                  # ties go to the lowest indices
        np.testing.assert_array_equal(idx[b * S + s].numpy(), np.arange(K))

    want_y, want_aux = jmoe.moe(jp, jcfg, jnp.asarray(x), dropless=dropless)
    y, aux = tmoe.moe(tp, tcfg, torch.from_numpy(x), dropless=dropless)
    assert y.shape == (B, S, 64) and y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y, want_y)
    _close(aux, want_aux)


def test_moe_dropped_slot_contributes_nothing():
    """A token whose slots are all dropped gets no routed output: with
    capacity dispatch and no shared expert, its row of ``y`` is 0."""
    _, tcfg, _, tp = _moe_params(OLMOE)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((4, 256, 64))
                         .astype(np.float32))
    _, idx, _ = tmoe._route(tcfg.moe, x.reshape(-1, 64) @ tp["router"])
    keep = tmoe._dispatch(tcfg.moe, idx, False)[2].view(-1, tcfg.moe.top_k)
    y, _ = tmoe.moe(tp, tcfg, x)
    lost = ~keep.any(1)
    assert bool(lost.any())
    assert not y.reshape(-1, 64)[lost].any()
    assert bool(y.reshape(-1, 64)[keep.all(1)].abs().sum(1).gt(0).all())


# --------------------------------------------------------------------- #
# olmoe-1b-7b through the LM stack
# --------------------------------------------------------------------- #
_REF = {}


def _ref_params():
    if "p" not in _REF:
        jcfg, _ = _cfgs(OLMOE)
        _REF["p"] = jlm.init_lm(jax.random.key(7), jcfg)
    return _REF["p"]


def test_olmoe_init_lm_tree_and_param_count():
    jcfg, tcfg = _cfgs(OLMOE)
    got = params_to_numpy(init_lm(Initializer(torch.Generator().manual_seed(0), CPU), tcfg))
    assert _shapes(got) == _shapes(_np(_ref_params()))
    assert set(got["groups"][0]["stacked"]) == {"norm1", "attn", "norm2", "moe"}
    assert param_count(tcfg) == jlm.param_count(jcfg)
    full = tconfigs.get_config(OLMOE)
    assert param_count(full) == jlm.param_count(jconfigs.get_config(OLMOE)) == 6_919_100_416
    # the MoE tree round-trips through numpy unchanged
    again = params_to_numpy(params_from_numpy(got, CPU))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,S,dropless", [(2, 40, False), (4, 64, False), (2, 40, True),
                                          (3, 21, False)])
def test_olmoe_lm_forward_matches(B, S, dropless):
    """Logits, hidden state and the summed aux loss, f32: T a multiple of
    16 (16 dispatch groups; at 4 x 64 the per-group capacity of 5 drops
    slots), dropless, and T = 63 (one group)."""
    jcfg, tcfg = _cfgs(OLMOE)
    jp = _ref_params()
    tp = params_from_numpy(_np(jp), CPU)
    toks = np.random.default_rng(14 + S).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    wl, waux, _, wh = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                     compute_dtype=jnp.float32, return_hidden=True,
                                     moe_dropless=dropless)
    gl, aux, gc, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                                 compute_dtype=torch.float32, return_hidden=True,
                                 moe_dropless=dropless)
    assert gc is None and gl.shape == (B, S, jcfg.vocab_size)
    assert float(aux) > 0.0
    _close(gh, wh)
    _close(gl, wl)
    _close(aux, waux)


def _with_dense_layers(cfg):
    """``cfg`` with its first MoE layer a dense block of width 48 (the
    plan's two groups, ``attn_dense`` then ``attn_moe``, as in
    DeepSeek-style configs)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_dense_layers=1,
                                                            d_ff_dense=48))


def test_moe_plan_with_leading_dense_layers_matches():
    """Two scan groups: the tree, the forward (logits, aux) and a decode
    step with caches for both groups, against the reference's."""
    jcfg, tcfg = (_with_dense_layers(c) for c in _cfgs(OLMOE))
    jp = jlm.init_lm(jax.random.key(8), jcfg)
    assert [g.kind for g in jlm.make_plan(jcfg)] == ["attn_dense", "attn_moe"]
    got = params_to_numpy(init_lm(Initializer(torch.Generator().manual_seed(0), CPU), tcfg))
    assert _shapes(got) == _shapes(_np(jp))
    assert got["groups"][0]["stacked"]["mlp"]["w_gate"].shape == (1, 64, 48)
    tp = params_from_numpy(_np(jp), CPU)
    toks = np.random.default_rng(16).integers(1, 512, (2, 32)).astype(np.int32)
    wl, waux, _ = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                 compute_dtype=jnp.float32)
    gl, aux, _ = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                            compute_dtype=torch.float32)
    _close(gl, wl)
    _close(aux, waux)

    f32 = dict(compute_dtype=jnp.float32)
    _, _, wc = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks[:, :31]),
                              caches=jlm.init_lm_caches(jcfg, 2, 40, jnp.float32),
                              cache_len=jnp.int32(0), moe_dropless=True, **f32)
    wd, _ = jlm.lm_decode_step(jp, jcfg, jnp.asarray(toks[:, 31:]), wc, jnp.int32(31), **f32)
    caches = init_lm_caches(tcfg, 2, 40, torch.float32, CPU)
    assert len(caches) == 2 and caches[0].k.shape[0] == 1 and caches[1].k.shape[0] == 3
    _, _, caches = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks[:, :31]), caches=caches,
                              cache_len=0, moe_dropless=True, compute_dtype=torch.float32)
    gd, _ = lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, 31:]), caches, 31,
                           compute_dtype=torch.float32)
    _close(gd, wd)


def test_olmoe_pooled_unit_embed_matches():
    """The embedder under the reference's capacity dispatch (no
    ``moe_dropless``), padded and all-pad rows included."""
    jcfg, tcfg = _cfgs(OLMOE)
    jp = _ref_params()
    tp = params_from_numpy(_np(jp), CPU)
    toks = np.random.default_rng(15).integers(1, 512, (16, 32)).astype(np.int32)
    toks[1, 20:] = 0
    toks[2, :] = 0
    want = j_pooled(jp, jcfg, jnp.asarray(toks))
    got = pooled_unit_embed(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    assert not got[2].any()
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[3:], axis=1), 1.0, atol=1e-5)


def _recording(base, log):
    class Recording(base):
        def submit(self, batch, timestamps):
            pairs = super().submit(batch, timestamps)
            log.append((np.array(batch), pairs))
            return pairs
    return Recording


def _outside_band(pairs, theta):
    return {(a, b) for a, b, s in pairs if abs(s - theta) > BAND}


def test_olmoe_run_service_matches_the_reference(monkeypatch):
    """``run_service("olmoe-1b-7b")`` in both packages, the port's
    embedder on the reference run's parameters: the same pairs request by
    request outside the ε-band, scores within 1e-5, the same groups."""
    kw = dict(requests=16, batch=16, seq=64, theta=0.85, lam=0.05, verbose=False)
    ref_log, log = [], []
    monkeypatch.setattr(jserve, "SSSJService", _recording(JService, ref_log))
    ref_svc, ref_groups, ref_trends = jserve.run_service(OLMOE, **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_svc.embed_fn.params), CPU)
    monkeypatch.setattr(tserve, "SSSJService", _recording(SSSJService, log))
    monkeypatch.setattr(
        tserve, "LMEmbedder",
        lambda cfg, generator=None, device=None: LMEmbedder(cfg, params, device=device))
    svc, groups, trends = tserve.run_service(OLMOE, device=CPU, **kw)

    assert len(log) == len(ref_log) == 16
    n_pairs = 0
    for (tok, pairs), (jtok, jpairs) in zip(log, ref_log):
        np.testing.assert_array_equal(tok, jtok)
        assert _outside_band(pairs, 0.85) == _outside_band(jpairs, 0.85)
        js = {(a, b): s for a, b, s in jpairs}
        for a, b, s in pairs:
            if (a, b) in js:
                assert abs(s - js[(a, b)]) <= ATOL
        n_pairs += len(pairs)
    assert n_pairs > 10
    assert groups == ref_groups and trends == ref_trends
    assert svc.stats.n_items == ref_svc.stats.n_items == 16 * 16


def test_olmoe_run_service_smoke_on_cpu(capsys):
    svc, groups, _ = tserve.run_service(OLMOE, requests=6, batch=16, device=CPU)
    assert "items=96" in capsys.readouterr().out
    assert svc.stats.n_items == 96 and groups
