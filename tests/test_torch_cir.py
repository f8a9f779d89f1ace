"""rfx_torch.cir against rfx.cir on the same numpy inputs: hard and soft
binning (the histogram's plain version, what a CPU tensor runs) against
rfx.cir's scatter path, and the RX-power metric."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracle import OracleTracer, sample_sphere_directions
from rfx import cir as jcir
from rfx_torch import cir

torch.set_num_threads(1)

KW = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)


def _paths(n=100_000, seed=17):
    rng = np.random.default_rng(seed)
    amp = rng.random(n).astype(np.float32)
    # Up to 70 m: ~23,000 delay bins, so some paths fall outside the window.
    dist = (rng.random(n) * 70.0).astype(np.float32)
    cap = rng.random(n) < 0.3
    return amp, dist, cap


@pytest.mark.parametrize("soft", [False, True])
def test_binning_matches_rfx_scatter(soft):
    amp, dist, cap = _paths()
    got = cir.bin_impulse_response(torch.from_numpy(amp), torch.from_numpy(dist),
                                   torch.from_numpy(cap), soft=soft, **KW).numpy()
    want = np.asarray(jcir.bin_impulse_response(jnp.asarray(amp), jnp.asarray(dist),
                                                jnp.asarray(cap), soft=soft, method="scatter",
                                                **KW))
    assert got.shape == (20_000,) and got.dtype == np.float32
    np.testing.assert_array_equal(got != 0, want != 0)  # identical bins
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _rows(n=5003, seed=23):
    """(6, n) rows: dense, sparse, empty, one path, everything in one bin,
    and paths around the window's last bin. n is no multiple of 16."""
    rng = np.random.default_rng(seed)
    amp = rng.random((6, n)).astype(np.float32)
    dist = (rng.random((6, n)) * 70.0).astype(np.float32)
    cap = rng.random((6, n)) < np.array([0.6, 0.01, 0.0, 0.0, 1.0, 0.5])[:, None]
    cap[3, n - 682] = True
    dist[4] = np.float32(31.0)
    last = np.float32(20_000 * 2.998e8 / 100e9)
    dist[5] = last - (rng.random(n) * 0.01 - 0.004).astype(np.float32)
    return amp, dist, cap


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_batched_binning_matches_vmap_of_rfx_scatter(soft):
    amp, dist, cap = _rows()
    got = cir.bin_impulse_response(torch.from_numpy(amp), torch.from_numpy(dist),
                                   torch.from_numpy(cap), soft=soft, **KW)
    one = jax.vmap(lambda a, d, c: jcir.bin_impulse_response(a, d, c, soft=soft,
                                                            method="scatter", **KW))
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        want = np.asarray(one(jnp.asarray(amp), jnp.asarray(dist), jnp.asarray(cap)))
    assert got.shape == (6, 20_000) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)  # identical bins
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[2].any() and int((got[3] != 0).sum()) == (2 if soft else 1)
    assert int((got[4] != 0).sum()) == (2 if soft else 1)
    for r in range(6):  # a row alone is the row in the batch, bit for bit
        alone = cir.bin_impulse_response(torch.from_numpy(amp[r]), torch.from_numpy(dist[r]),
                                         torch.from_numpy(cap[r]), soft=soft, **KW)
        assert alone.shape == (20_000,) and torch.equal(alone, got[r]), r


@pytest.mark.parametrize("mode", [cir.HARD, cir.SOFT_LO, cir.SOFT_HI])
def test_histogram_plain_rows_are_the_single_row_calls(mode):
    amp, dist, cap = (torch.from_numpy(a) for a in _rows(n=1001))
    rows = cir.histogram_plain(amp, dist, cap, mode=mode, **KW)
    assert rows.shape == (6, 20_000)
    for r in range(6):
        assert torch.equal(rows[r], cir.histogram_plain(amp[r], dist[r], cap[r], mode=mode, **KW))
    none = cir.histogram_plain(amp[:0], dist[:0], cap[:0], mode=mode, **KW)
    assert none.shape == (0, 20_000)
    empty = cir.bin_impulse_response(amp[:, :0], dist[:, :0], cap[:, :0], soft=mode != cir.HARD,
                                     **KW)
    assert empty.shape == (6, 20_000) and not empty.any()


@pytest.mark.parametrize("n, tiles", [(1, 1), (2033, 1), (2034, 2), (4_194_304, 2049),
                                      (5_242_880, 2561)])
def test_mask_tiles_cover_an_unaligned_row(n, tiles):
    """A row of n mask bytes that starts 15 bytes into a 16-byte word spans
    ceil((n + 15) / 16) words, 128 words a tile."""
    assert cir.mask_tiles(n) == tiles
    assert cir.mask_tiles(n) * 128 * 16 >= n + 15


def test_binning_truncates_and_drops_out_of_window():
    c, rate = KW["light_speed_mps"], KW["sample_rate_hz"]
    # delays 0.5, 1.99, 19999.5 (last bin), 20000.2 (dropped), -1 (dropped)
    delays = np.array([0.5, 1.99, 19999.5, 20000.2, -1.0, 3.0])
    dist = (delays / rate * c).astype(np.float32)
    amp = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    cap = np.array([True, True, True, True, True, False])
    ir = cir.bin_impulse_response(torch.from_numpy(amp), torch.from_numpy(dist),
                                  torch.from_numpy(cap), **KW).numpy()
    assert ir[0] == 1.0 and ir[1] == 2.0 and ir[19999] == 3.0 and ir[3] == 0.0
    assert ir.sum() == 6.0


def test_cir_from_trace_scales_by_tx_power_over_rays():
    from rfx_torch.tracer import TraceResult

    amp, dist, cap = _paths(n=5000, seed=3)
    res = TraceResult(torch.from_numpy(cap), torch.from_numpy(amp), torch.from_numpy(dist),
                      torch.zeros(5000, dtype=torch.int32))
    got = cir.cir_from_trace(res, tx_power=2.0, num_rays=5000, **KW).numpy()
    from rfx.tracer import TraceResult as JTraceResult

    jres = JTraceResult(jnp.asarray(cap), jnp.asarray(amp), jnp.asarray(dist),
                        jnp.zeros(5000, jnp.int32))
    want = np.asarray(jcir.cir_from_trace(jres, tx_power=2.0, num_rays=5000, method="scatter",
                                          **KW))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_histogram_checks_inputs():
    amp, dist, cap = (torch.from_numpy(a) for a in _paths(n=10))
    with pytest.raises(TypeError):
        cir.bin_impulse_response(amp.double(), dist, cap, **KW)
    with pytest.raises(TypeError):
        cir.bin_impulse_response(amp, dist, cap.int(), **KW)
    with pytest.raises(ValueError):
        cir.bin_impulse_response(amp, dist[:5], cap, **KW)
    with pytest.raises(ValueError):  # (N,) or (R, N) only
        cir.bin_impulse_response(amp.reshape(1, 2, 5), dist.reshape(1, 2, 5),
                                 cap.reshape(1, 2, 5), **KW)
    with pytest.raises(ValueError):
        cir.bin_impulse_response(amp, dist, cap, nbins=0, light_speed_mps=1.0, sample_rate_hz=1.0)
    before = cir.HISTOGRAM_KERNEL.launches
    cir.bin_impulse_response(amp, dist, cap, **KW)
    assert cir.HISTOGRAM_KERNEL.launches == before  # a CPU tensor runs the plain version


def _oracle_ir(room, n_rays, seed):
    dirs = sample_sphere_directions(n_rays, seed=seed)
    tr = OracleTracer(room, 2.998e8, 100e9, 200e-9, 4)
    _, ir = tr.compute_cir(np.array([10.0, 0.0, 5.0]), 1.0, np.array([-10.0, 0.0, 5.0]), 1.0,
                           dirs)
    return ir.astype(np.float32)


def test_rx_power_dbm_matches_rfx(box_room):
    ir = _oracle_ir(box_room, 4000, 5)
    assert (ir != 0).sum() > 10
    dbm, sig = cir.rx_power_dbm(torch.from_numpy(ir), 200e-9)
    jdbm, jsig = jcir.rx_power_dbm(jnp.asarray(ir), 200e-9)
    sig, jsig = sig.numpy(), np.asarray(jsig)
    assert (sig != 0).sum() == (jsig != 0).sum()
    np.testing.assert_allclose(sig, jsig, rtol=0, atol=1e-4 * np.abs(jsig).max())
    assert abs(float(dbm) - float(jdbm)) < 1e-3


def test_rx_power_dbm_batched_and_empty(box_room):
    ir = _oracle_ir(box_room, 2000, 9)
    batch = np.stack([ir, np.zeros_like(ir), ir * 0.5])
    dbm, out = cir.rx_power_dbm(torch.from_numpy(batch), 200e-9)
    jdbm, _ = jcir.rx_power_dbm(jnp.asarray(batch), 200e-9)
    assert out.shape == batch.shape
    assert dbm[1] == -np.inf and np.asarray(jdbm)[1] == -np.inf
    np.testing.assert_allclose(dbm.numpy()[[0, 2]], np.asarray(jdbm)[[0, 2]], atol=1e-3)
    # Half the amplitude is a quarter of the power: -6.02 dB.
    assert float(dbm[0] - dbm[2]) == pytest.approx(20 * np.log10(2.0), abs=1e-3)


# The RX-power kernel's plain version (what a CPU tensor, or one that
# requires grad, runs) against rfx.cir.rx_power_dbm on JAX-CPU.
POWER_WINDOW = 200e-9
POWER_CASES = ["sparse", "bin_0", "bin_lo", "bin_last", "zero_row", "single_ir"]


def _power_case(nbins: int, case: str) -> np.ndarray:
    """IRs of one case: sparse rows of either sign at 1e-9..1e-6 (0.2% to 5%
    nonzero), beside a row of one bin at 0, at lo = (nbins - 1) // 2 or at
    nbins - 1, or beside an all-zero row; `single_ir` is one (nbins,) IR."""
    g = np.random.default_rng(nbins)
    share = np.array([0.01, 0.05, 0.002])[:, None]
    rows = np.where(g.random((3, nbins)) < share,
                    g.uniform(1e-9, 1e-6, (3, nbins)) * g.choice([-1.0, 1.0], (3, nbins)), 0.0)
    rows = rows.astype(np.float32)
    if case == "single_ir":
        return rows[1]
    if case == "zero_row":
        rows[1] = 0.0
        return rows
    if case.startswith("bin_"):
        k = {"bin_0": 0, "bin_lo": (nbins - 1) // 2, "bin_last": nbins - 1}[case]
        rows[2] = 0.0
        rows[2, k] = np.float32(3.5e-7)
    return rows


@pytest.mark.parametrize("case", POWER_CASES)
@pytest.mark.parametrize("nbins", [1998, 1999], ids=["even", "odd"])
def test_rx_power_plain_matches_rfx(nbins, case):
    """The same nonzero samples per row, the signal within 1e-4 of its
    largest sample (test_rx_power_dbm_matches_rfx's bar), dBm within 1e-3 dB
    and -inf alike; a CPU tensor counts no kernel launch. The sizes are ones
    where rfx's compiled linspace rounds the carrier's grid as (window /
    (nbins - 1)) * i, as it does at 10,000 and 20,000 bins and as the port
    does; at some sizes (2,000 and 2,001 bins among them) XLA rounds it
    otherwise, which moves the carrier by up to 2.4e-4 (ROADMAP C)."""
    ir = _power_case(nbins, case)
    before = cir.RX_POWER_KERNEL.launches
    dbm, sig = cir.rx_power_dbm(torch.from_numpy(ir), POWER_WINDOW)
    assert cir.RX_POWER_KERNEL.launches == before
    jdbm, jsig = jcir.rx_power_dbm(jnp.asarray(ir), POWER_WINDOW)
    sig, jsig = sig.numpy(), np.asarray(jsig)
    assert sig.shape == jsig.shape == ir.shape and dbm.shape == ir.shape[:-1]
    np.testing.assert_array_equal((sig != 0).sum(axis=-1), (jsig != 0).sum(axis=-1))
    np.testing.assert_allclose(sig, jsig, rtol=0, atol=1e-4 * np.abs(jsig).max())
    dbm, jdbm = np.atleast_1d(dbm.numpy()), np.atleast_1d(np.asarray(jdbm))
    fin = np.isfinite(jdbm)
    assert fin.sum() >= (2 if case == "zero_row" else len(fin))
    np.testing.assert_array_equal(np.isfinite(dbm), fin)
    np.testing.assert_array_equal(dbm[~fin], jdbm[~fin])
    np.testing.assert_allclose(dbm[fin], jdbm[fin], rtol=0, atol=1e-3)
    if case.startswith("bin_"):  # one tap a sample: the samples bin k reaches, no more
        k = int(np.flatnonzero(ir[2])[0])
        lo = (nbins - 1) // 2
        reach = min(nbins - 1, k - lo + nbins - 1) - max(0, k - lo) + 1
        # carrier[0] = sin(0) = 0 zeroes sample j = k - lo, where it exists.
        assert int((sig[2] != 0).sum()) == reach - (1 if k >= lo else 0)


def test_carrier_cache_returns_the_carrier():
    """The RX-power kernel's carrier comes from a cache keyed by (nbins,
    window, carrier, device): `_carrier`'s tensor bit for bit, the same
    object on a second call, and a new one for another size or window."""
    a = cir.carrier_cached(1999, POWER_WINDOW, 2.4e9, torch.device("cpu"))
    assert torch.equal(a, cir._carrier(1999, POWER_WINDOW, 2.4e9, "cpu"))
    assert cir.carrier_cached(1999, POWER_WINDOW, 2.4e9, torch.device("cpu")) is a
    for args in ((1998, POWER_WINDOW), (1999, 2 * POWER_WINDOW)):
        b = cir.carrier_cached(*args, 2.4e9, torch.device("cpu"))
        assert b is not a and b.shape == (args[0],)
        assert torch.equal(b, cir._carrier(*args, 2.4e9, "cpu"))
    assert not torch.equal(cir.carrier_cached(1999, 2 * POWER_WINDOW, 2.4e9, torch.device("cpu")),
                           a)


def test_rx_power_plain_rows_alone_equal_the_batch():
    """A row's (dBm, signal) in the plain version is the same bits alone as in
    a batch, as the kernel's is."""
    ir = np.concatenate([_power_case(1999, "sparse"), _power_case(1999, "bin_lo"),
                         np.zeros((1, 1999), np.float32)])
    dbm, sig = cir.rx_power_dbm_plain(torch.from_numpy(ir), POWER_WINDOW)
    assert dbm.shape == (7,) and dbm[6] == -np.inf
    for r in range(7):
        d1, s1 = cir.rx_power_dbm_plain(torch.from_numpy(ir[r]), POWER_WINDOW)
        assert torch.equal(s1, sig[r]) and torch.equal(d1, dbm[r]), r


def test_rx_power_gradient_takes_the_plain_version_and_matches_jax():
    """A CPU IR that requires grad runs the plain versions (no launch of the
    kernel or of its backward), whose gradient is the dense convolution's, as
    jax.grad of rfx.cir.rx_power_dbm: zero bins get one too. The adjoint sums ~2,000 taps of either sign in
    another order than XLA's, so the bar has an absolute floor of 1e-5 of the
    largest entry."""
    ir = _power_case(1998, "sparse")
    x = torch.from_numpy(ir).requires_grad_()
    before = (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches)
    dbm, _ = cir.rx_power_dbm(x, POWER_WINDOW)
    dbm.sum().backward()
    assert (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches) == before
    want = np.asarray(jax.grad(lambda a: jnp.sum(jcir.rx_power_dbm(a, POWER_WINDOW)[0]))(
        jnp.asarray(ir)))
    got = x.grad.numpy()
    assert (got != 0).sum() > 2 * (ir != 0).sum()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


POWER_COTANGENTS = ["dbm", "signal", "both"]


def _power_cotangents(shape, cotangent, seed=5):
    """Cotangents of the dBm (one a row) and of the signal, numpy f32, None
    where the case has none."""
    g = np.random.default_rng(seed)
    g_dbm = g.standard_normal(shape[:-1]).astype(np.float32)
    g_sig = (g.standard_normal(shape) * 1e6).astype(np.float32)
    return (g_dbm if cotangent != "signal" else None, g_sig if cotangent != "dbm" else None)


def _power_loss(dbm, sig, g_dbm, g_sig, xp):
    """sum g_dbm dBm over the rows that received something, plus sum g_sig
    signal: the cotangents of the case, -inf rows given none."""
    loss = 0.0
    if g_dbm is not None:
        loss = loss + xp.sum(xp.where(xp.isfinite(dbm), dbm, 0.0) * g_dbm)
    if g_sig is not None:
        loss = loss + xp.sum(sig * g_sig)
    return loss


@pytest.mark.parametrize("cotangent", POWER_COTANGENTS)
@pytest.mark.parametrize("nbins", [1998, 1999], ids=["even", "odd"])
def test_rx_power_backward_plain_matches_autograd_of_plain(nbins, cotangent):
    """The closed form of the backward (rx_power_backward_plain: g_eff from
    the forward's signal and its row sums, then the transposed convolution)
    against autograd through rx_power_dbm_plain, on rows with an empty one
    (its dBm term absent: g_ir from the signal's cotangent alone) and on a
    1-D IR; rtol 1e-4 with an absolute floor of 1e-5 of the largest entry."""
    for ir in (_power_case(nbins, "zero_row"), _power_case(nbins, "single_ir")):
        g_dbm, g_sig = _power_cotangents(ir.shape, cotangent)
        x = torch.from_numpy(ir).requires_grad_()
        dbm, sig = cir.rx_power_dbm_plain(x, POWER_WINDOW)
        t = [None if a is None else torch.from_numpy(a) for a in (g_dbm, g_sig)]
        _power_loss(dbm, sig, *t, torch).backward()
        rows = sig.detach().reshape(-1, nbins)
        count, sq = cir._power_sums_plain(rows)
        got = cir.rx_power_backward_plain(
            None if t[0] is None else t[0].reshape(-1), None if t[1] is None else t[1].reshape(-1, nbins),
            rows, torch.stack([sq, count.float()], dim=1), cir._carrier(nbins, POWER_WINDOW, 2.4e9, "cpu"))
        want = x.grad.reshape(-1, nbins)
        assert int((got != 0).sum()) > 2 * int((ir != 0).sum())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("cotangent", POWER_COTANGENTS)
@pytest.mark.parametrize("nbins", [1998, 1999], ids=["even", "odd"])
def test_rx_power_gradient_matches_jax(nbins, cotangent):
    """rx_power_dbm's autograd Function on the CPU (the plain forward, the
    plain backward, no launch) against jax.grad of rfx.cir.rx_power_dbm: rows
    with an empty one, and a 1-D IR; cotangents on the dBm, the signal or
    both; the bar of test_rx_power_gradient_takes_the_plain_version_and_matches_jax."""
    for ir in (_power_case(nbins, "zero_row"), _power_case(nbins, "single_ir")):
        g_dbm, g_sig = _power_cotangents(ir.shape, cotangent)
        x = torch.from_numpy(ir).requires_grad_()
        before = (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches)
        dbm, sig = cir.rx_power_dbm(x, POWER_WINDOW)
        t = [None if a is None else torch.from_numpy(a) for a in (g_dbm, g_sig)]
        _power_loss(dbm, sig, *t, torch).backward()
        assert (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches) == before
        j = [None if a is None else jnp.asarray(a) for a in (g_dbm, g_sig)]
        want = np.asarray(jax.grad(lambda a: _power_loss(*jcir.rx_power_dbm(a, POWER_WINDOW), *j,
                                                         jnp))(jnp.asarray(ir)))
        got = x.grad.numpy()
        assert got.shape == ir.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_rx_power_dbm_refuses_a_device_without_the_kernel():
    """Neither a kernel nor the plain version for a device that is neither
    the CPU nor CUDA: the call raises rather than guess."""
    with pytest.raises(ValueError, match="no RX-power kernel for device meta"):
        cir.rx_power_dbm(torch.zeros((2, 100), device="meta"), 1e-9)


PHASOR_CASES = ["dbm_only", "diagnostics", "rows", "out_of_window"]


@pytest.mark.parametrize("case", PHASOR_CASES)
def test_rx_power_dbm_phasor_matches_rfx(case):
    """The phasor metric on paths (rx_power_dbm_phasor: per-path sums, then
    phasor_metric, the formulas the phasor kernel's wrapper applies to its
    sums) against rfx.cir.rx_power_dbm_phasor: dBm within 1e-3 dB, -inf alike;
    ratio and spread within rtol 1e-4, 1 and 0 where nothing lands in the
    window. `rows` reduces (4, K) paths row by row, one row with no capture;
    `out_of_window` has every path beyond the last bin."""
    g = np.random.default_rng(41)
    k, nbins = 60, 1999
    kw = dict(sample_window_s=POWER_WINDOW, nbins=nbins, light_speed_mps=2.998e8,
              sample_rate_hz=nbins / POWER_WINDOW)
    shape = (4, k) if case == "rows" else (k,)
    amp = g.uniform(1e-6, 1e-4, shape).astype(np.float32)
    reach = 70.0 if case == "out_of_window" else 55.0  # the window holds ~59.96 m
    dist = g.uniform(3.0, reach, shape).astype(np.float32)
    if case == "out_of_window":
        dist += np.float32(60.0)
    cap = g.random(shape) < 0.7
    if case == "rows":
        cap[2] = False
    cancel = case != "dbm_only"
    got = cir.rx_power_dbm_phasor(torch.from_numpy(amp), torch.from_numpy(dist),
                                  torch.from_numpy(cap), return_cancellation=cancel, **kw)
    got = [x.numpy() for x in (got if cancel else (got,))]

    def ref(a, d, c):
        out = jcir.rx_power_dbm_phasor(jnp.asarray(a), jnp.asarray(d), jnp.asarray(c),
                                       return_cancellation=cancel, **kw)
        return [np.asarray(x) for x in (out if cancel else (out,))]

    want = ([np.stack(x) for x in zip(*(ref(*row) for row in zip(amp, dist, cap)))]
            if case == "rows" else ref(amp, dist, cap))
    assert [x.shape for x in got] == [x.shape for x in want] == [shape[:-1]] * len(want)
    fin = np.isfinite(want[0])
    assert fin.sum() == {"rows": 3, "out_of_window": 0}.get(case, 1)
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    np.testing.assert_array_equal(got[0][~fin], want[0][~fin])
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=0, atol=1e-3)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=0)
        assert (a[~fin] == (1.0 if a is got[1] else 0.0)).all()
