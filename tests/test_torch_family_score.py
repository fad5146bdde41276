"""Online family selection: ``core.bayes.score_families`` on the CPU (the
``family_score`` kernel's plain version) against the JAX package's, and
the kernel (``kernels/family_score.py``) against it on the card.

On the CPU the port's numpy is the reference's numpy, so every result is
held bitwise: the four BICs, the winner, the channel count, the drift
regression's rho and the fitted mixture, at several window sizes and
channel counts, for numpy and tensor inputs, with the edge cases of the
scoring pass in every window (a channel below ``min_obs``, an all-masked
channel, nonpositive rates, a channel of zero variance, a channel whose
drift regression is singular (``det_ok`` false), a negative slope). The
kernel runs only on the card (marked ``cuda``), held there bit for bit
against the numpy (on an AVX2/AVX512F host, whose float32 exp and log the
kernel re-implements) and a second call against the first, at the plan's
edges too; here its launch plan is checked, and a CUDA request is shown to
raise, never to reach the numpy. JAX is imported inside the tests that
compare with it, so the ``cuda`` cases also run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_family_score.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bayes
from repro_torch.kernels import family_score as fs

FAMILY_SETS = [("normal", "lognormal", "drift", "empirical"),
               ("normal", "drift"), ("lognormal", "empirical")]


def _window(N, K, seed, edges=True):
    """(rates, works, mask) (N, K): lognormal rates with a drift channel,
    ~90% of samples valid, and (with ``edges``) the edge channels."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.5, 2.0, K)
    works = rng.uniform(0.5 / K, 2.0 / K, (N, K))
    rates = rng.lognormal(np.log(mu), 0.3, (N, K))
    mask = (rng.random((N, K)) < 0.9).astype(np.float64)
    # a straggler whose rate grows with its share (drift, rho ~ 2)
    rates[:, K - 1] = mu[K - 1] * (1.0 + 1.0 * works[:, K - 1] * K) \
        + rng.normal(0.0, 0.01, N)
    if edges:
        mask[:, 0] = 0.0
        mask[:3, 0] = 1.0                 # below min_obs
        mask[:, 1] = 0.0                  # all masked
        rates[2, 2], rates[5, 2] = -0.5, 0.0   # nonpositive rates
        rates[:, 3] = 1.25                # zero variance
        works[:, 4] = 0.01                # singular regression: det_ok false
        rates[:, 5] = 3.0 - 50.0 * works[:, 5]  # a negative slope
    return rates, works, mask


def _same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.bics == want.bics
    assert got.winner == want.winner
    assert got.n_channels == want.n_channels
    assert np.array_equal(got.rho, want.rho)
    assert (got.gmm is None) == (want.gmm is None)
    if want.gmm is not None:
        for g, w in zip(got.gmm, want.gmm):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("families", FAMILY_SETS, ids=lambda f: "+".join(f))
@pytest.mark.parametrize("N,K", [(12, 8), (48, 33), (96, 64), (128, 16)])
def test_cpu_scoring_is_bitwise_the_reference(N, K, families):
    from repro.core import bayes as jbayes
    rates, works, mask = _window(N, K, seed=N + K)
    kw = dict(min_obs=8, max_rho=8.0, families=families)
    want = jbayes.score_families(rates, works, mask, **kw)
    _same(bayes.score_families(rates, works, mask, **kw), want)
    # float32 history, as the balancer keeps it
    r32, w32, m32 = (a.astype(np.float32) for a in (rates, works, mask))
    _same(bayes.score_families(r32, w32, m32, **kw),
          jbayes.score_families(r32, w32, m32, **kw))


def test_cpu_tensors_and_the_cpu_device_take_the_numpy(monkeypatch):
    rates, works, mask = _window(96, 24, seed=5)
    want = bayes.score_families(rates, works, mask)
    assert want is not None and want.n_channels == 24 - 2
    tens = [torch.tensor(a) for a in (rates, works, mask)]
    _same(bayes.score_families(*tens), want)
    _same(bayes.score_families(rates, works, mask, device="cpu"), want)

    def card(*a, **k):
        raise AssertionError("the kernel ran for host inputs")

    monkeypatch.setattr(fs, "family_score", card)
    _same(bayes.score_families(*tens, device="cpu"), want)


def test_no_channel_with_enough_history_scores_none():
    rates, works, mask = _window(12, 6, seed=1, edges=False)
    mask[4:] = 0.0
    assert bayes.score_families(rates, works, mask, min_obs=8) is None


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself a CUDA tensor, to follow the
    dispatch without a card."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_request_never_reaches_the_numpy(monkeypatch):
    rates, works, mask = _window(48, 16, seed=2)

    def plain(*a, **k):
        raise AssertionError("the numpy ran for a CUDA request")

    def build():
        raise RuntimeError("family_score kernel build")

    monkeypatch.setattr(bayes, "_score_families_np", plain)
    if not torch.cuda.is_available():
        # no card: asking for one raises, it does not move to the host
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            bayes.score_families(rates, works, mask, device="cuda")
    monkeypatch.setattr(fs, "build", build)
    tens = [torch.tensor(a).as_subclass(_CudaLooking)
            for a in (rates, works, mask)]
    with pytest.raises(RuntimeError, match="family_score kernel build"):
        bayes.score_families(*tens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.family_score(*(torch.tensor(a) for a in (rates, works, mask)),
                        min_obs=8, max_rho=8.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("families", FAMILY_SETS, ids=lambda f: "+".join(f))
@pytest.mark.parametrize("N,K", [(12, 8), (96, 1024), (128, 64), (500, 40)])
def test_kernel_matches_numpy_on_the_card(card, N, K, families):
    rates, works, mask = _window(N, K, seed=N + K)
    want = bayes.score_families(rates, works, mask, families=families)
    n = fs.LAUNCHES["family_score"]
    got = bayes.score_families(rates, works, mask, families=families,
                               device=card)
    assert fs.LAUNCHES["family_score"] == n + 1
    _same(got, want)
    again = bayes.score_families(rates, works, mask, families=families,
                                 device=card)
    _same(again, got)


@pytest.mark.parametrize("N", [1, 12, 96, 4096])
@pytest.mark.parametrize("K", [1, 8, 33, 1024, 1025])
def test_launch_plan_fits_and_covers_every_channel(N, K):
    """The channel launch's plan: a block's windows fit the 227 KB a block
    may opt into, and block b's warps score channels b c .. b c + c - 1
    below K, so every channel is scored exactly once."""
    cpb, blocks, smem = fs.launch_plan(N, K)
    assert 1 <= cpb <= min(fs.MAX_CHANNELS_A_BLOCK, K)
    assert smem == cpb * fs.channel_bytes(N) <= fs.SMEM_MAX
    assert fs.channel_bytes(N) % 8 == 0 and fs.channel_bytes(N) >= 52 * N
    # the window's rows: the product rows after the dead float64 rows'
    # start, the works after both, one sample of two rows in two banks
    D, P, W, X, total = fs.window_of(N)
    assert D % 16 == 1 and P % 32 == 1 and W % 2 == 0
    assert W >= 9 * P and W >= 8 * D and X == W + 2 * D
    assert total == X + 2 * P and 4 * total <= fs.channel_bytes(N)
    seen = [b * cpb + w for b in range(blocks) for w in range(cpb)
            if b * cpb + w < K]
    assert sorted(seen) == list(range(K))
    if N == 96 and K >= 8:
        assert cpb == 8
    if N == 4096:
        assert cpb == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,min_obs", [(4096, 9, 8), (96, 1025, 8),
                                         (1, 8, 1)])
def test_kernel_at_the_plan_edges_on_the_card(card, N, K, min_obs):
    """The longest window (one channel a block), a ragged last block, and
    one observation a channel: bit for bit the numpy, twice."""
    rates, works, mask = _window(N, K, seed=N * K, edges=N >= 6)
    want = bayes.score_families(rates, works, mask, min_obs=min_obs)
    got = bayes.score_families(rates, works, mask, min_obs=min_obs,
                               device=card)
    assert want is not None
    _same(got, want)
    _same(bayes.score_families(rates, works, mask, min_obs=min_obs,
                               device=card), got)
