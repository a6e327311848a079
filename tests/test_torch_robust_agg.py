"""The port's byzantine-robust aggregation on the CPU, one process.

The plain versions of the four robust-aggregation kernels against the
reference's Pallas kernels run in interpret mode (a D of several 256-wide
tiles with a ragged tail), the statistics and strategies against the
reference's, the attack registry and ``ByzantineGradients``' validation
against the reference's.  The Hopper kernels themselves are held against
the plain versions on a GPU in ``test_torch_cuda.py``; four ranks in
``test_torch_byzantine_multirank.py``."""
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (pins torch's CPU threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import get_strategy as jget_strategy  # noqa: E402
from repro.kernels import robust_agg as jra  # noqa: E402
from repro.serverless import adversarial as jadv  # noqa: E402
from repro.serverless import faults as jfaults  # noqa: E402
from repro.serverless import recovery as jrec  # noqa: E402
from repro_torch.core import get_strategy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import robust_agg as tra  # noqa: E402
from repro_torch.serverless import adversarial as tadv  # noqa: E402
from repro_torch.serverless import recovery as trec  # noqa: E402
from repro_torch.serverless.faults import ByzantineGradients  # noqa: E402

WS = [3, 4, 5, 7, 8, 12]
D = 1000            # four 256-wide tiles of the reference, the last ragged
TILE = 256


def _stack(W, seed=0, d=D, huge=True):
    """Mixed-scale rows with constant columns, ties and (``huge``) a
    stretch of one row scaled by 1e30."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(W, d) * rs.choice([1.0, 100.0], size=(W, 1))).astype(
        np.float32)
    x[:, :5] = 2.5                      # constant columns
    x[1, 5:40] = x[2, 5:40]             # ties
    x[:, 40:60] = np.round(x[:, 40:60])
    if huge:
        x[0, 60:90] *= 1e30
    return x


def _close(got, want, rtol):
    """``rtol`` relative to each value, and to the largest value for
    the ones near zero."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", WS)
def test_trimmed_mean_plain_matches_pallas(W):
    """Masked trim=1 pass and sorting network alike: fp32 sums of the
    same values in other orders, 1e-6 relative.  The 1e30 stretch is
    masked away and nothing turns NaN."""
    x = _stack(W, seed=W)
    for trim in (1, 2, 3):
        if W <= 2 * trim:
            continue
        got = tref.trimmed_mean(torch.from_numpy(x), trim).numpy()
        want = jra.trimmed_mean(jnp.asarray(x), trim, interpret=True,
                                tile_d=TILE)
        assert np.isfinite(got).all()
        _close(got, want, 1e-6)
        np.testing.assert_array_equal(got[:5], 2.5)  # constant columns
        # and the wrapper on a CPU tensor is the plain version
        np.testing.assert_array_equal(
            tops.trimmed_mean(torch.from_numpy(x), trim).numpy(), got)


@pytest.mark.parametrize("W", WS)
def test_coordinate_median_plain_matches_pallas(W):
    """The network gives exact order statistics and the even-W mean is
    one add and an exact halving: bit-exact."""
    x = _stack(W, seed=W + 1)
    got = tref.coordinate_median(torch.from_numpy(x)).numpy()
    want = np.asarray(jra.coordinate_median(jnp.asarray(x), interpret=True,
                                            tile_d=TILE))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tops.coordinate_median(torch.from_numpy(x)).numpy(), got)
    np.testing.assert_allclose(got, np.median(x.astype(np.float64), 0),
                               rtol=1e-6)


@pytest.mark.parametrize("W", WS)
def test_krum_pairwise_plain_matches_pallas(W):
    """Gram-form distances summed over the whole D against the Pallas
    kernel's sums of clamped per-tile distances: 1e-6 of the largest."""
    x = _stack(W, seed=W + 2, huge=False)
    got = tref.krum_pairwise(torch.from_numpy(x)).numpy()
    want = np.asarray(jra.krum_pairwise(jnp.asarray(x), interpret=True,
                                        tile_d=TILE))
    assert got.shape == (W, W) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(want.max()))
    np.testing.assert_array_equal(
        tops.krum_pairwise(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("W", WS)
def test_weiszfeld_step_plain_matches_pallas(W):
    """Direct distances summed in another order, then the same weights:
    1e-6 of the largest value."""
    x = _stack(W, seed=W + 3, huge=False)
    z = np.median(x, axis=0).astype(np.float32)
    floor = 1e-12 * float(np.linalg.norm(x, axis=1).max())
    got = tref.weiszfeld_step(torch.from_numpy(x), torch.from_numpy(z),
                              floor).numpy()
    want = jra.weiszfeld_step(jnp.asarray(x), jnp.asarray(z), floor,
                              interpret=True, tile_d=TILE)
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(
        tops.weiszfeld_step(torch.from_numpy(x), torch.from_numpy(z),
                            floor).numpy(), got)


def test_wrappers_on_cpu_launch_nothing_and_keep_shapes():
    """A CPU tensor takes the plain version and counts no launch; the
    stack is cast to fp32 and the trailing shape kept; bf16 and float64
    stacks give the fp32 result of their fp32 values."""
    x = torch.from_numpy(_stack(5, d=60, huge=False)).reshape(5, 12, 5)
    before = dict(tra.LAUNCHES)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        s = x.to(dtype)
        for got, want in (
                (tra.trimmed_mean(s, 2), tref.trimmed_mean(s.float(), 2)),
                (tra.coordinate_median(s), tref.coordinate_median(
                    s.float()))):
            assert got.dtype == torch.float32 and got.shape == (12, 5)
            assert torch.equal(got, want)
        assert tra.krum_pairwise(s).shape == (5, 5)
    assert tra.LAUNCHES == before


def test_wrappers_validate_like_the_reference():
    x = torch.zeros(4, 10)
    for fn, args in ((tra.trimmed_mean, (x, 2)), (tra.trimmed_mean, (x, 0)),
                     (tra.weiszfeld_step, (x, torch.zeros(9), 1.0))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError, match="W > 2"):
        jra.trimmed_mean(jnp.zeros((4, 10)), 2)


def test_trimmed_mean_survives_huge_outliers():
    """The reference's adversarial case: a 1e8-scaled row must not wipe
    out the honest mean by fp32 cancellation."""
    honest = np.asarray([[1e-3], [2e-3], [3e-3], [4e-3]], np.float32)
    for evil in (1e8, -1e8, 3e7, 1e30):
        x = np.concatenate([honest, np.full((1, 1), evil, np.float32)])
        got = float(tref.trimmed_mean(torch.from_numpy(x), 1)[0])
        want = float(np.asarray(jrec.trimmed_mean_sort(jnp.asarray(x), 1))[0])
        assert got == pytest.approx(want, rel=1e-6)
        assert honest.min() <= got <= honest.max()


# ---------------------------------------------------------------------------
# statistics and strategies against the reference's
# ---------------------------------------------------------------------------
def _stats_for(W):
    out = [("trimmed_mean", dict(trim=1)), ("coordinate_median", {}),
           ("geometric_median", dict(tol=1e-6, max_iter=60))]
    if W > 4:
        out.append(("trimmed_mean", dict(trim=2)))
    if W >= 5:
        out.append(("krum", dict(f=1, m=2)))
    return out


@pytest.mark.parametrize("W,shape", [(5, (257,)), (8, (33, 5)), (12, (40,))])
def test_statistics_match_reference(W, shape):
    """Each statistic against the reference's with ``use_pallas=True``
    (the geometric median against the direct form, ``use_pallas=False``,
    which its kernel computes), under a 1e4-scaled row and a trailing
    shape: 5e-5 relative to the largest value, as the reference's own
    kernel-vs-jnp test; for the geometric median the two loops may stop
    one iteration apart, so the bound adds 2 * tol * scale."""
    rs = np.random.RandomState(7)
    x = rs.randn(W, *shape).astype(np.float32)
    x[0] *= 1e4
    for name, kw in _stats_for(W):
        got = getattr(trec, name)(torch.from_numpy(x), **kw)
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        want = np.asarray(getattr(jrec, name)(
            jnp.asarray(x), use_pallas=name != "geometric_median", **kw))
        scale = float(np.abs(want).max())
        atol = 5e-5 * scale
        if name == "geometric_median":
            atol += 2 * kw["tol"] * float(
                np.linalg.norm(x.reshape(W, -1), axis=1).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=atol,
                                   err_msg=f"{name} {kw}")
        kernel = getattr(trec, name)(torch.from_numpy(x), use_kernel=False,
                                     **kw)
        assert torch.equal(kernel, got)   # on the CPU both are the plain


def test_trimmed_mean_sort_and_validation_match_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(7, 11).astype(np.float32)
    for trim in (1, 2, 3):
        np.testing.assert_allclose(
            trec.trimmed_mean_sort(torch.from_numpy(x), trim).numpy(),
            np.asarray(jrec.trimmed_mean_sort(jnp.asarray(x), trim)),
            rtol=1e-6)
    for fn, jfn, args in (
            (trec.trimmed_mean, jrec.trimmed_mean, (2,)),
            (trec.krum, jrec.krum, (1,)),
            (trec.geometric_median, jrec.geometric_median, (0.0,))):
        with pytest.raises(ValueError) as mine:
            fn(torch.zeros(4, 3), *args)
        with pytest.raises(ValueError) as theirs:
            jfn(jnp.zeros((4, 3)), *args)
        assert str(mine.value) == str(theirs.value)


def test_geometric_median_counts_iterations():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(5, 64).astype(np.float32))
    before = trec.ITERATIONS["geometric_median"]
    trec.geometric_median(x, tol=1e-6, max_iter=7)
    assert trec.ITERATIONS["geometric_median"] == before + 7
    identical = torch.ones(5, 64)       # z0 is the answer: one step
    before = trec.ITERATIONS["geometric_median"]
    out = trec.geometric_median(identical)
    assert trec.ITERATIONS["geometric_median"] == before + 1
    assert torch.equal(out, torch.ones(64))


@pytest.mark.parametrize("name,kw", [
    ("trimmed_mean", dict(trim=1)), ("trimmed_mean", dict(trim=2)),
    ("coordinate_median", {}), ("krum", dict(f=1, m=1)),
    ("geometric_median", dict(tol=1e-6, max_iter=40))])
def test_strategy_reduce_matches_reference(name, kw):
    """``get_strategy`` wiring and each strategy's reduction against the
    reference's (kernels on; the geometric median against its direct
    form), plus the names and the wire volume."""
    rs = np.random.RandomState(2)
    x = rs.randn(7, 90).astype(np.float32)
    mine = get_strategy(name, **kw)
    theirs = jget_strategy(name, use_pallas=name != "geometric_median", **kw)
    assert mine.name == theirs.name and mine.use_kernel
    assert mine.microbatches == theirs.microbatches == 1
    got = mine._reduce(torch.from_numpy(x)).numpy()
    want = np.asarray(theirs._reduce(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5 * float(
        np.abs(want).max()) + 2e-6 * float(np.linalg.norm(x, axis=1).max()))
    like = [np.ones((8, 8), np.float32), np.ones(3, np.float32)]
    assert mine.comm_bytes(like, 4) == theirs.comm_bytes(
        [jnp.ones((8, 8)), jnp.ones(3)], 4)
    assert get_strategy(name, microbatches=4, **kw).microbatches == 4


def test_get_strategy_wires_byzantine_like_reference():
    tm = get_strategy("trimmed_mean", trim=1, microbatches=4)
    byz = get_strategy("byzantine", inner=tm, workers=(0,), scale=-8.0)
    assert byz.microbatches == 4 and byz.scale == -8.0
    like = [np.ones((8, 8), np.float32)]
    assert byz.comm_bytes(like, 4) == tm.comm_bytes(like, 4) == 4 * 256
    with pytest.raises(ValueError):
        get_strategy("byzantine")
    with pytest.raises(ValueError):
        get_strategy("byzantine", inner=get_strategy("allreduce"),
                     microbatches=4)
    with pytest.raises(KeyError, match="geometric_median"):
        get_strategy("no_such_strategy")


# ---------------------------------------------------------------------------
# ByzantineGradients validation against the reference
# ---------------------------------------------------------------------------
BAD_KWARGS = [
    dict(),                                            # no inner
    dict(inner="allreduce", microbatches=4),           # conflicting K
    dict(inner="spirt", microbatches=2),
    dict(inner="allreduce", workers=()),
    dict(inner="allreduce", workers=(1, 1)),
    dict(inner="allreduce", workers=(-1,)),
    dict(inner="allreduce", workers=(0.5,)),
    dict(inner="allreduce", n_workers=0),
    dict(inner="allreduce", workers=(4,), n_workers=4),
    dict(inner="allreduce", workers=(0, 1), n_workers=4),  # majority
    dict(inner="allreduce", workers=(0,), n_workers=2),
    dict(inner="allreduce", attack="no_such_attack"),
    dict(inner="allreduce", scale=float("inf")),
    dict(inner="allreduce", attack="zero", scale=float("nan")),
]


def _byz(module_get, kw):
    kw = dict(kw)
    if "inner" in kw:
        kw["inner"] = module_get(kw["inner"])
    return kw


@pytest.mark.parametrize("kw", BAD_KWARGS, ids=lambda k: repr(k)[:60])
def test_byzantine_validation_matches_reference(kw):
    """The same ValueError, with the same message, at construction."""
    with pytest.raises(ValueError) as theirs:
        jfaults.ByzantineGradients(**_byz(jget_strategy, kw))
    with pytest.raises(ValueError) as mine:
        ByzantineGradients(**_byz(get_strategy, kw))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    dict(inner="allreduce"), dict(inner="spirt", workers=(2,)),
    dict(inner="spirt", microbatches=4, attack="gaussian_noise"),
    dict(inner="trimmed_mean", workers=(0, 3), n_workers=5,
         attack="little_is_enough", scale=0.5),
    dict(inner="krum", attack="sign_flip", n_workers=3)])
def test_byzantine_fields_match_reference(kw):
    """Resolved scale, inherited microbatches and workers agree; the
    state is (step counter, inner state)."""
    mine = ByzantineGradients(**_byz(get_strategy, kw))
    theirs = jfaults.ByzantineGradients(**_byz(jget_strategy, kw))
    for f in ("scale", "microbatches", "workers", "attack", "seed",
              "n_workers"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.init_state([torch.zeros(3)])[0] == 0


# ---------------------------------------------------------------------------
# the attack registry
# ---------------------------------------------------------------------------
def test_attack_registry_matches_reference():
    assert tadv.list_attacks() == jadv.list_attacks()
    for name in tadv.list_attacks():
        mine, theirs = tadv.get_attack(name), jadv.get_attack(name)
        assert (mine.default_scale, mine.colluding) == \
            (theirs.default_scale, theirs.colluding)
    with pytest.raises(ValueError, match="registered: sign_flip"):
        tadv.get_attack("nope")
    spec = tadv.AttackSpec(name="sign_flip", apply_rows=None,
                           torch_apply=None)
    with pytest.raises(ValueError, match="already registered"):
        tadv.register_attack(spec)
    tadv.register_attack(tadv.AttackSpec("probe", None, None))
    assert tadv.list_attacks()[-1] == "probe"
    tadv.unregister_attack("probe")
    assert tadv.list_attacks() == jadv.list_attacks()


@pytest.mark.parametrize("name", jadv.list_attacks())
def test_attack_rows_are_the_reference_copy(name):
    """The numpy realizations are copies: equal outputs, batch dims and
    the same seeded draws included; honest rows bit-unchanged."""
    rs = np.random.RandomState(5)
    stacked = rs.randn(3, 6, 17)
    mask = np.zeros((3, 6), bool)
    mask[:, 0] = True
    mask[1, 4] = True
    got = tadv.get_attack(name).rows(stacked, mask,
                                     np.random.default_rng(9))
    want = jadv.get_attack(name).rows(stacked, mask,
                                      np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~mask], stacked[~mask])


def test_noise_seed_separates_streams():
    seeds = {tadv.noise_seed(s, r, t, i) for s in range(2) for r in range(4)
             for t in range(3) for i in range(5)}
    assert len(seeds) == 2 * 4 * 3 * 5
    assert all(0 <= s < 2 ** 64 for s in seeds)
    assert tadv.noise_seed(0, 1, 2, 3) == tadv.noise_seed(0, 1, 2, 3)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group for the attacks that read the rank."""
    path = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_gaussian_noise_attack_statistics(one_rank):
    """The reference draws from jax.random, which torch cannot reproduce,
    so the test is statistical: honest rows bit-unchanged; the byzantine
    row's noise has mean 0 and std ``scale`` (over 2e5 draws: |mean| <
    5 sigma of the mean, std within 1%); fresh draws every step and every
    leaf; the same seed gives the same draws, another seed others."""
    gauss = tadv.get_attack("gaussian_noise").torch_apply
    rs = np.random.RandomState(6)
    grads = [torch.from_numpy(rs.randn(400, 250).astype(np.float32)),
             torch.from_numpy(rs.randn(7).astype(np.float32))]
    honest = gauss(grads, False, None, 10.0, 0, 0)
    assert all(a is b for a, b in zip(honest, grads))
    out = gauss(grads, True, None, 10.0, 0, 0)
    noise = (out[0] - grads[0]).double()
    assert abs(float(noise.mean())) < 5 * 10.0 / math.sqrt(noise.numel())
    assert float(noise.std()) == pytest.approx(10.0, rel=0.01)
    again = gauss(grads, True, None, 10.0, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    nxt = gauss(grads, True, None, 10.0, 0, 1)
    other = gauss(grads, True, None, 10.0, 1, 0)
    assert not torch.equal(nxt[0], out[0])
    assert not torch.equal(other[0], out[0])
    assert not torch.allclose(out[1] - grads[1],
                              (out[0] - grads[0]).reshape(-1)[:7])


@pytest.mark.parametrize("name", ["sign_flip", "scale", "zero"])
def test_local_attacks_on_one_rank(one_rank, name):
    """The attacks that need no fleet statistics, on one rank: the
    corrupted list equals ``apply_rows`` of its one-row stack; an honest
    rank gets its own list back."""
    spec = tadv.get_attack(name)
    rs = np.random.RandomState(8)
    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((3, 4), (5,))]
    assert spec.torch_apply(grads, False, None, -8.0, 0, 0) is grads
    out = spec.torch_apply(grads, True, None, -8.0, 0, 0)
    for g, o in zip(grads, out):
        want = spec.apply_rows(g.numpy().reshape(1, -1).astype(float),
                               np.ones(1, bool), None, -8.0)
        np.testing.assert_array_equal(o.numpy().reshape(1, -1),
                                      want.astype(np.float32))
