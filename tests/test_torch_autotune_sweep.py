"""The port's timed autotune sweep and its cache file
(``repro_torch.kernels.autotune``), the counterpart of the JAX package's
``TestAutotuneCache`` (``tests/test_frontier_grads.py``) and its manifest
test (``tests/test_fault.py``).

On the CPU the sweep times the plain path's rows per chunk, which is what
makes its bookkeeping testable here: a JSON round trip through a cleared
cache, a sweep entry outranking a model entry wherever they meet, a file
section of another card never read, the swept results bitwise the model's
(row chunking leaves every row's arithmetic unchanged), the cache riding a
checkpoint manifest, a candidate that misses its plain version or does not
repeat its bits raising, and the candidates on the card (the model's
split and its neighbours, each within the card's limits). The card's own
sweep is held in ``tests/test_torch_cuda_kernels.py -k sweep``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.ckpt import restore_pipeline, save_pipeline
from repro_torch.kernels import autotune, ops
from repro_torch.sched import UncertaintyAwareBalancer

DEV = "cpu"
SHAPE = (16, 3, 64)    # F, K, T


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch, tmp_path):
    """Every test starts and ends with an empty in-process cache (the
    previous contents restored after), no card name, and a default cache
    file of its own (a file a developer's sweeps left is never read)."""
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE_PATH",
                        str(tmp_path / "default_cache.json"))
    saved = autotune.cache_state()
    card = dict(autotune._CARD)
    autotune.clear_cache()
    yield
    autotune.clear_cache()
    autotune.load_cache_state(saved)
    autotune._CARD.clear()
    autotune._CARD.update(card)


def _sweep(path, mode="grad", dist_id="normal", **kw):
    F, K, T = SHAPE
    kw.setdefault("candidates", ((4,), (8,), (16,)))
    return autotune.sweep(F, K, T, mode=mode, dist_id=dist_id, repeats=2,
                          cache_path=str(path), device=DEV, **kw)


@pytest.mark.parametrize("mode", autotune.MODES)
@pytest.mark.parametrize("dist_id", ["normal", "drift", "defective",
                                     "empirical", "lognormal"])
def test_plain_sweep_round_trips_through_the_file(tmp_path, mode, dist_id):
    path = tmp_path / "autotune_cache.json"
    entry = _sweep(path, mode, dist_id)
    F, K, T = SHAPE
    assert entry["source"] == "sweep" and entry["value"] in (4, 8, 16)
    assert set(entry["timings"]) == {"4", "8", "16"}
    assert entry["us"] == min(entry["timings"].values())
    key = autotune._key(F, K, T, "plain", mode, dist_id)
    on_disk = json.load(open(path))
    assert on_disk["cpu"][key]["value"] == entry["value"]
    autotune.clear_cache()
    assert autotune.lookup(F, K, T, backend="plain", mode=mode,
                           dist_id=dist_id, cache_path=str(path)) == \
        entry["value"]
    assert autotune.last_outcome() == "sweep"


def test_a_second_sweep_keeps_the_first_in_the_file(tmp_path):
    path = tmp_path / "c.json"
    a = _sweep(path, "fwd")
    b = _sweep(path, "grad")
    disk = json.load(open(path))["cpu"]
    F, K, T = SHAPE
    assert disk[autotune._key(F, K, T, "plain", "fwd", "normal")] == a
    assert disk[autotune._key(F, K, T, "plain", "grad", "normal")] == b


def test_lookup_order_and_outcomes(tmp_path):
    F, K, T = SHAPE
    model = autotune.pick_block_rows(F, K, T, "grad", "normal")
    assert autotune.lookup(F, K, T, backend="plain", mode="grad",
                           cache_path=str(tmp_path / "none.json")) == model
    assert autotune.last_outcome() == "model"
    autotune.lookup(F, K, T, backend="plain", mode="grad")
    assert autotune.last_outcome() == "hit"


def test_a_sweep_entry_outranks_a_model_entry(tmp_path):
    F, K, T = SHAPE
    path = tmp_path / "c.json"
    key = autotune._key(F, K, T, "plain", "grad", "normal")
    entry = _sweep(path, candidates=((5,),))
    autotune.clear_cache()
    # a model entry in the process gives way to the file's sweep entry...
    autotune._CACHE[key] = {"value": 16, "source": "model"}
    autotune._load_json(str(path), "plain")
    assert autotune._CACHE[key] == entry
    # ...and a restored snapshot's model entry to the process's sweep
    autotune.load_cache_state({key: {"value": 16, "source": "model"}})
    assert autotune._CACHE[key]["value"] == 5
    # while a file's model entry never displaces a sweep in the process
    other = tmp_path / "model.json"
    other.write_text(json.dumps({"cpu": {key: {"value": 16,
                                               "source": "model"}}}))
    autotune._load_json(str(other), "plain")
    assert autotune._CACHE[key]["value"] == 5
    # a snapshot's sweep entry does replace a model entry
    autotune.clear_cache()
    autotune._CACHE[key] = {"value": 16, "source": "model"}
    autotune.load_cache_state({key: entry})
    assert autotune.lookup(F, K, T, backend="plain", mode="grad") == 5


def test_another_cards_section_is_never_read(tmp_path):
    F, K, T = 3, 1024, 1024
    key = autotune._key(F, K, T, "split", "grad", "normal")
    swept = {"value": [8, 32, 256, 8], "threads": 128, "source": "sweep"}
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"NVIDIA A100-SXM4-80GB": {key: swept}}))
    autotune._CARD["name"] = "NVIDIA H100 80GB HBM3"
    model = autotune.pick_split(F, K, T, "grad", "normal")
    assert autotune.lookup_split(F, K, T, cache_path=str(path)) == model
    assert autotune.last_outcome() == "model"
    # the same entry under this card's name is read, threads and all
    autotune.clear_cache()
    path.write_text(json.dumps({"NVIDIA H100 80GB HBM3": {key: swept}}))
    assert list(autotune.lookup_split(F, K, T, cache_path=str(path))) == \
        swept["value"]
    assert autotune.last_outcome() == "sweep"
    # without a card no section is read at all
    autotune.clear_cache()
    autotune._CARD["name"] = None
    assert autotune.lookup_split(F, K, T, cache_path=str(path)) == model


def test_a_swept_plan_carries_its_threads():
    F, K, T = 3, 1024, 1024
    key = autotune._key(F, K, T, "split", "grad", "normal")
    th, split, outcome = autotune.plan_outcome(F, K, T, "grad", "normal")
    assert (th, outcome) == (autotune.DEFAULT_THREADS, "model")
    assert autotune.plan_outcome(F, K, T, "grad", "normal")[2] == "hit"
    autotune.clear_cache()
    autotune._CACHE[key] = {"value": [8, 32, 256, 8], "threads": 128,
                            "source": "sweep"}
    th, split, outcome = autotune.plan_outcome(F, K, T, "grad", "normal")
    assert (th, list(split), outcome) == (128, [8, 32, 256, 8], "sweep")
    assert autotune.launch_plan(F, K, T, "grad", "normal")[:2] == \
        (128, split)
    assert autotune.plan_outcome(F, K, T, "grad", "normal")[2] == "sweep"


@pytest.mark.parametrize("mode", autotune.MODES)
def test_swept_plain_results_are_the_models_bit_for_bit(tmp_path, mode):
    F, K, T = SHAPE
    _sweep(tmp_path / "c.json", mode, "drift", candidates=((1,), (5,)))
    W, mus, sgs, fam = autotune._sweep_inputs(F, K, 0, "drift")
    W, mus, sgs = (torch.tensor(a) for a in (W, mus, sgs))
    fn = (ops.frontier_moments if mode == "fwd" else
          lambda *a, **kw: ops.frontier_moments_with_grads(
              *a, param_grads=mode == "pgrad", **kw))
    swept = fn(W, mus, sgs, num_t=T, device=DEV, family=fam)
    model = fn(W, mus, sgs, num_t=T, device=DEV, family=fam,
               block_rows=autotune.pick_block_rows(F, K, T, mode, "drift"))
    assert all(torch.equal(a, b) for a, b in zip(swept, model))


def test_the_cache_rides_the_manifest(tmp_path):
    F, K, T = SHAPE
    entry = _sweep(tmp_path / "c.json")
    key = autotune._key(F, K, T, "plain", "grad", "normal")
    bal = UncertaintyAwareBalancer(num_channels=3, lam=0.05, explore=0.0,
                                   device=DEV)
    save_pipeline(str(tmp_path / "ck"), 1, bal)
    autotune.clear_cache()
    assert key not in autotune.cache_state()
    restore_pipeline(str(tmp_path / "ck"), device=DEV)
    assert autotune.cache_state()[key] == entry
    assert autotune.lookup(F, K, T, backend="plain", mode="grad") == \
        entry["value"]
    assert autotune.last_outcome() == "sweep"


def test_a_candidate_that_misses_its_plain_version_raises(tmp_path,
                                                          monkeypatch):
    # on the CPU the timed call is the plain path itself: make it miss
    orig = ops.frontier_moments_with_grads

    def off_by_a_little(*a, **kw):
        out = orig(*a, **kw)
        return (out[0] * 1.01,) + tuple(out[1:])

    monkeypatch.setattr(ops, "frontier_moments_with_grads", off_by_a_little)
    with pytest.raises(RuntimeError, match="misses its plain version: mu"):
        _sweep(tmp_path / "c.json")
    assert not (tmp_path / "c.json").exists()
    assert autotune.cache_state() == {}   # nothing of the sweep is left


def test_a_candidate_whose_bits_do_not_repeat_raises(tmp_path, monkeypatch):
    orig = ops.frontier_moments_with_grads
    calls = {"n": 0}

    def drifting(*a, **kw):
        calls["n"] += 1
        out = orig(*a, **kw)
        return (out[0] * (1.0 + calls["n"] * 1e-6),) + tuple(out[1:])

    monkeypatch.setattr(ops, "frontier_moments_with_grads", drifting)
    with pytest.raises(RuntimeError, match="did not repeat"):
        _sweep(tmp_path / "c.json")


@pytest.mark.parametrize("F,K,T,mode", [
    (4096, 1024, 256, "fwd"), (4096, 1024, 256, "grad"),
    (4096, 1024, 256, "pgrad"), (3, 1024, 2048, "fwd"),
    (3, 1024, 1024, "grad"), (1, 1024, 1024, "pgrad"), (8, 6, 128, "grad")])
def test_card_candidates_are_the_model_and_its_neighbours(F, K, T, mode):
    cands = autotune.sweep_candidates(F, K, T, mode, "normal")
    th0 = autotune.pick_threads(T, mode, "normal")
    s0 = autotune.pick_split(F, K, T, mode, "normal")
    assert cands[0] == (th0, s0)
    assert 3 <= len(cands) <= 13 and len(set(cands)) == len(cands)
    for th, s in cands[1:]:
        changed = [f for f in s._fields if getattr(s, f) != getattr(s0, f)]
        assert len(changed) + (th != th0) == 1
        if changed:
            (f,) = changed
            assert getattr(s, f) in (getattr(s0, f) // 2,
                                     getattr(s0, f) * 2)
        else:
            assert th in (128, 256, 512)
        autotune.check_launch(th, T, mode, "normal", s)
    if mode == "fwd":
        assert all(s.t_chunk == s.k_chunk == s.ep_chunk == 0
                   for _, s in cands)


def test_sweep_inputs_are_the_references_draws():
    # the JAX package's sweep draws its rows the same way (autotune.sweep)
    rng = np.random.default_rng(3)
    e = rng.exponential(size=(5, 4))
    W, mus, sgs, fam = autotune._sweep_inputs(5, 4, 3, "normal")
    np.testing.assert_array_equal(W, (e / e.sum(1, keepdims=True))
                                  .astype(np.float32))
    assert fam == "normal" and mus.shape == sgs.shape == (4,)
