"""The port's LM embedder and serving entry point on the CPU against the JAX
package.

Parameters are the reference's (``LMEmbedder(qwen3-0.6b.reduced(),
key=jax.random.key(0))``, d_model 64, 4 layers), carried across as numpy
arrays.  Held: ``pooled_unit_embed`` within ``atol=1e-5`` (f32 sums in
another order), unit norms within 1e-5, an all-pad row's zero vector;
and the slice end to end: the reference's ``launch.serve.run_service``
and the port's, each driving its ``SSSJService`` with its ``LMEmbedder``
on the same parameters and the same token stream, emit the same pairs
request by request outside an ε-band of 1e-5 around θ (scores within
1e-5) and the same duplicate groups and trends.  The same for
xlstm-350m (``reduced()``: two units of an mLSTM and an sLSTM block),
its embeddings within ``XLSTM_ATOL``, and for zamba2-2.7b (``reduced()``:
two units of two Mamba2 layers and the shared attention block), within
``ATOL``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.launch.serve as jserve
from repro.configs import ARCHS as JARCHS
from repro.serving.embedder import LMEmbedder as JEmbedder
from repro.serving.embedder import pooled_unit_embed as j_pooled
from repro.serving.service import SSSJService as JService
import repro_torch.launch.serve as tserve
from repro_torch.configs import ARCHS
from repro_torch.models import params_from_numpy
from repro_torch.serving import LMEmbedder, SSSJService, pooled_unit_embed

CPU = "cpu"
ATOL = 1e-5
BAND = 1e-5
ARCH = "qwen3-0.6b"
XLSTM = "xlstm-350m"
# unit embeddings of xlstm-350m: its four recurrent blocks compound their
# f32 differences from the reference (tests/test_torch_models.py)
XLSTM_ATOL = 2e-5
HYBRID = "zamba2-2.7b"


@pytest.fixture(scope="module")
def ref_embedder():
    return JEmbedder(JARCHS[ARCH].reduced(), key=jax.random.key(0))


@pytest.fixture(scope="module")
def embedder(ref_embedder):
    params = params_from_numpy(jax.tree.map(np.asarray, ref_embedder.params), CPU)
    return LMEmbedder(ARCHS[ARCH].reduced(), params=params, device=CPU)


def _tokens(seed, B=6, S=32):
    toks = np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)
    toks[1, 20:] = 0          # a padded document
    toks[2, :] = 0            # an all-pad row
    return toks


def test_pooled_unit_embed_matches(ref_embedder, embedder):
    toks = _tokens(1)
    want = j_pooled(ref_embedder.params, ref_embedder.cfg, jnp.asarray(toks))
    got = pooled_unit_embed(embedder.params, embedder.cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (6, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not got[2].any()   # all-pad: the zero vector, inert in the join
    # an explicit mask
    mask = np.ones_like(toks, bool)
    mask[:, 16:] = False
    want = j_pooled(ref_embedder.params, ref_embedder.cfg, jnp.asarray(toks),
                    jnp.asarray(mask))
    got = pooled_unit_embed(embedder.params, embedder.cfg, torch.from_numpy(toks),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_embedder_matches_and_is_unit_norm(ref_embedder, embedder):
    toks = np.random.default_rng(2).integers(1, 500, (4, 32)).astype(np.int32)
    got = embedder(toks)
    assert got.shape == (4, 64) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref_embedder(toks), atol=ATOL, rtol=0)


def test_embedder_draws_its_params_from_the_generator():
    cfg = ARCHS[ARCH].reduced()
    toks = np.random.default_rng(3).integers(1, 500, (2, 16)).astype(np.int32)
    a, b, c = (LMEmbedder(cfg, generator=torch.Generator().manual_seed(s), device=CPU)(toks)
               for s in (5, 5, 6))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3


def _recording(base, log):
    """``base`` whose ``submit`` also logs each request and its pairs."""
    class Recording(base):
        def submit(self, batch, timestamps):
            pairs = super().submit(batch, timestamps)
            log.append((np.array(batch), np.array(timestamps), pairs))
            return pairs
    return Recording


def _outside_band(pairs, theta):
    return {(a, b) for a, b, s in pairs if abs(s - theta) > BAND}


def test_run_service_matches_the_reference(monkeypatch):
    """The slice as a whole: ``run_service`` in both packages, the port's
    embedder on the reference run's parameters."""
    kw = dict(requests=24, batch=16, seq=64, theta=0.85, lam=0.05, verbose=False)
    ref_log, log = [], []
    monkeypatch.setattr(jserve, "SSSJService", _recording(JService, ref_log))
    ref_svc, ref_groups, ref_trends = jserve.run_service(ARCH, **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_svc.embed_fn.params), CPU)
    monkeypatch.setattr(tserve, "SSSJService", _recording(SSSJService, log))
    monkeypatch.setattr(
        tserve, "LMEmbedder",
        lambda cfg, generator=None, device=None: LMEmbedder(cfg, params, device=device))
    svc, groups, trends = tserve.run_service(ARCH, device=CPU, **kw)

    assert len(log) == len(ref_log) == 24
    n_pairs = 0
    for (tok, ts, pairs), (jtok, jts, jpairs) in zip(log, ref_log):
        np.testing.assert_array_equal(tok, jtok)        # the same token stream
        np.testing.assert_array_equal(ts, jts)
        assert _outside_band(pairs, 0.85) == _outside_band(jpairs, 0.85)
        js = {(a, b): s for a, b, s in jpairs}
        for a, b, s in pairs:
            if (a, b) in js:
                assert abs(s - js[(a, b)]) <= ATOL
        n_pairs += len(pairs)
    assert n_pairs > 20                                 # planted copies did emit
    assert groups == ref_groups and trends == ref_trends
    assert groups and trends
    assert svc.stats.n_items == ref_svc.stats.n_items == 24 * 16


def test_run_service_smoke_on_cpu(capsys):
    svc, groups, trends = tserve.run_service(ARCH, requests=6, batch=16, device=CPU)
    out = capsys.readouterr().out
    assert "duplicate groups" in out and "items=96" in out
    assert svc.stats.n_items == 96 and svc.engine.device.type == "cpu"
    assert all(len(g) >= 3 for g in trends)


def test_token_requests_plant_copies():
    stream, planted = tserve.token_requests(512, requests=5, batch=8, seq=20, seed=1)
    assert len(stream) == 5 and planted > 0
    for r, (toks, ts) in enumerate(stream):
        assert toks.shape == (8, 20) and toks.dtype == np.int32
        assert toks.min() >= 1 and toks.max() < 512
        np.testing.assert_allclose(ts, r + np.arange(8) * 0.01)


# --------------------------------------------------------------------- #
# xlstm-350m
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def xlstm_ref():
    return JEmbedder(JARCHS[XLSTM].reduced(), key=jax.random.key(1))


def test_xlstm_pooled_unit_embed_matches(xlstm_ref):
    """The recurrent stack's embeddings, padded and all-pad rows
    included, through ``pooled_unit_embed`` and ``LMEmbedder``."""
    params = params_from_numpy(jax.tree.map(np.asarray, xlstm_ref.params), CPU)
    toks = _tokens(4, B=8, S=48)
    want = j_pooled(xlstm_ref.params, xlstm_ref.cfg, jnp.asarray(toks))
    got = pooled_unit_embed(params, ARCHS[XLSTM].reduced(), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=XLSTM_ATOL, rtol=0)
    assert not got[2].any()
    emb = LMEmbedder(ARCHS[XLSTM].reduced(), params=params, device=CPU)(toks)
    np.testing.assert_allclose(np.linalg.norm(emb[3:], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(emb, xlstm_ref(toks), atol=XLSTM_ATOL, rtol=0)


def test_xlstm_run_service_matches_the_reference(monkeypatch):
    """``run_service("xlstm-350m")`` in both packages, the port's
    embedder on the reference run's parameters: the same pairs request
    by request outside the ε-band, scores within ``XLSTM_ATOL``, the
    same groups and trends."""
    kw = dict(requests=16, batch=16, seq=64, theta=0.85, lam=0.05, verbose=False)
    ref_log, log = [], []
    monkeypatch.setattr(jserve, "SSSJService", _recording(JService, ref_log))
    ref_svc, ref_groups, ref_trends = jserve.run_service(XLSTM, **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_svc.embed_fn.params), CPU)
    monkeypatch.setattr(tserve, "SSSJService", _recording(SSSJService, log))
    monkeypatch.setattr(
        tserve, "LMEmbedder",
        lambda cfg, generator=None, device=None: LMEmbedder(cfg, params, device=device))
    svc, groups, trends = tserve.run_service(XLSTM, device=CPU, **kw)

    assert len(log) == len(ref_log) == 16
    n_pairs = 0
    for (tok, ts, pairs), (jtok, jts, jpairs) in zip(log, ref_log):
        np.testing.assert_array_equal(tok, jtok)
        assert _outside_band(pairs, 0.85) == _outside_band(jpairs, 0.85)
        js = {(a, b): s for a, b, s in jpairs}
        for a, b, s in pairs:
            if (a, b) in js:
                assert abs(s - js[(a, b)]) <= XLSTM_ATOL
        n_pairs += len(pairs)
    assert n_pairs >= 5        # planted copies did emit (7 with these weights)
    assert groups and groups == ref_groups and trends == ref_trends
    assert svc.stats.n_items == ref_svc.stats.n_items == 16 * 16


def test_xlstm_run_service_smoke_on_cpu(capsys):
    svc, groups, _ = tserve.run_service(XLSTM, requests=6, batch=16, device=CPU)
    assert "items=96" in capsys.readouterr().out
    assert svc.stats.n_items == 96 and svc.engine.device.type == "cpu" and groups


# --------------------------------------------------------------------- #
# zamba2-2.7b
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def hybrid_ref():
    return JEmbedder(JARCHS[HYBRID].reduced(), key=jax.random.key(2))


def test_hybrid_pooled_unit_embed_matches(hybrid_ref):
    """The Mamba2 hybrid's embeddings (one SSD chunk of 32 a layer),
    padded and all-pad rows included, through ``pooled_unit_embed`` and
    ``LMEmbedder`` (measured within 3.4e-7)."""
    params = params_from_numpy(jax.tree.map(np.asarray, hybrid_ref.params), CPU)
    toks = _tokens(5, B=8, S=32)
    want = j_pooled(hybrid_ref.params, hybrid_ref.cfg, jnp.asarray(toks))
    got = pooled_unit_embed(params, ARCHS[HYBRID].reduced(), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not got[2].any()
    emb = LMEmbedder(ARCHS[HYBRID].reduced(), params=params, device=CPU)(toks)
    np.testing.assert_allclose(np.linalg.norm(emb[3:], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(emb, hybrid_ref(toks), atol=ATOL, rtol=0)


def test_hybrid_run_service_matches_the_reference(monkeypatch):
    """``run_service("zamba2-2.7b")`` in both packages (documents of 64
    tokens, two SSD chunks of 32 a layer), the port's embedder on the
    reference run's parameters: the same pairs request by request
    outside the ε-band, scores within ``ATOL``, the same groups and
    trends."""
    kw = dict(requests=16, batch=16, seq=64, theta=0.85, lam=0.05, verbose=False)
    ref_log, log = [], []
    monkeypatch.setattr(jserve, "SSSJService", _recording(JService, ref_log))
    ref_svc, ref_groups, ref_trends = jserve.run_service(HYBRID, **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_svc.embed_fn.params), CPU)
    monkeypatch.setattr(tserve, "SSSJService", _recording(SSSJService, log))
    monkeypatch.setattr(
        tserve, "LMEmbedder",
        lambda cfg, generator=None, device=None: LMEmbedder(cfg, params, device=device))
    svc, groups, trends = tserve.run_service(HYBRID, device=CPU, **kw)

    assert len(log) == len(ref_log) == 16
    n_pairs = 0
    for (tok, ts, pairs), (jtok, jts, jpairs) in zip(log, ref_log):
        np.testing.assert_array_equal(tok, jtok)
        assert _outside_band(pairs, 0.85) == _outside_band(jpairs, 0.85)
        js = {(a, b): s for a, b, s in jpairs}
        for a, b, s in pairs:
            if (a, b) in js:
                assert abs(s - js[(a, b)]) <= ATOL
        n_pairs += len(pairs)
    assert n_pairs >= 5        # planted copies did emit
    assert groups and groups == ref_groups and trends == ref_trends
    assert svc.stats.n_items == ref_svc.stats.n_items == 16 * 16


def test_hybrid_run_service_smoke_on_cpu(capsys):
    svc, groups, _ = tserve.run_service(HYBRID, requests=6, batch=16, device=CPU)
    assert "items=96" in capsys.readouterr().out
    assert svc.stats.n_items == 96 and svc.engine.device.type == "cpu" and groups
