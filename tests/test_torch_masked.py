"""Port parity for the Option-stream calculus (`idsp_tpu_torch.masked`)
against `idsp_tpu.masked`: the same seeded inputs through both, every
result held bit for bit (the adapters only select, count and frame).

The reference contracts are those of tests/test_masked.py: the Hold
doctest (adapters.rs:100-106), the TryDecimator tick contract and error
taxonomy (adapters.rs:157-222), Interpolator/Downsample framing
(adapters.rs:26-83) and the Map lift (adapters.rs:240-257).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import masked as jmasked
from idsp_tpu.filters import rpll as jrpll

from idsp_tpu_torch import masked
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import rpll
from idsp_tpu_torch.masked import Masked

CPU = torch.device("cpu")
# the JAX package's hold is an associative scan: jitted, it runs at once
_jhold = jax.jit(jmasked.hold, static_argnames="axis")


def _pair(valid, value):
    """The same Option stream for both packages."""
    return (jmasked.Masked(jnp.asarray(valid), jnp.asarray(value)),
            Masked(torch.from_numpy(np.array(valid)),
                   torch.from_numpy(np.array(value))))


def _eq(got, want):
    g = got if isinstance(got, np.ndarray) else to_numpy(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def test_codes_equal_jax():
    assert (masked.OK, masked.NO_TICK, masked.EXTRA_TICK) == (
        jmasked.OK, jmasked.NO_TICK, jmasked.EXTRA_TICK)


def test_hold_reference_doctest():
    # Hold(5): None -> 5, Some(7) -> 7, None -> 7 (adapters.rs:100-106)
    jm, m = _pair([False, True, False], np.array([0, 7, 0], np.int32))
    carry, y = masked.hold(torch.tensor(5, dtype=torch.int32), m)
    jcarry, jy = _jhold(jnp.int32(5), jm)
    assert y.tolist() == [5, 7, 7] and int(carry) == 7
    _eq(y, jy)
    _eq(carry, jcarry)


@pytest.mark.parametrize("axis", [-1, 0])
def test_hold_equals_jax(axis):
    rng = np.random.default_rng(0)
    shape = (5, 96) if axis == -1 else (96, 5)
    v = rng.random(shape) < 0.1
    x = rng.integers(-100, 100, size=shape).astype(np.int32)
    carry0 = np.full((5,), -1, np.int32)
    jm, m = _pair(v, x)
    jc, jy = _jhold(jnp.asarray(carry0), jm, axis=axis)
    c, y = masked.hold(torch.from_numpy(carry0), m, axis=axis)
    _eq(y, jy)
    _eq(c, jc)


def test_hold_two_chunks_equal_one():
    """The carry makes a stream held in two chunks equal one held at
    once, and both equal the JAX package's."""
    rng = np.random.default_rng(1)
    t, c = 256, 3
    v = rng.random((c, t)) < 0.05
    v[1] = False  # a lane that never ticks keeps the initial carry
    x = rng.integers(-100, 100, size=(c, t)).astype(np.int32)
    carry0 = torch.full((c,), -1, dtype=torch.int32)
    _, m = _pair(v, x)
    c_one, y_one = masked.hold(carry0, m)
    carry, outs = carry0, []
    for lo in (0, 100):
        hi = t if lo else 100
        carry, y = masked.hold(carry, Masked(m.valid[:, lo:hi],
                                             m.value[:, lo:hi]))
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=-1), y_one)
    assert torch.equal(carry, c_one)
    assert (y_one[1] == -1).all()
    _eq(y_one, _jhold(jnp.asarray(carry0.numpy()),
                            jmasked.Masked(jnp.asarray(v), jnp.asarray(x)))[1])


def test_try_decimate_reference_contract():
    # alternating tick (adapters.rs:144-156): [1, 2] ticking on slot 1 -> 2
    for valid, want_y, want_err in (
            ([False, True], 2, masked.OK),
            ([True, True], 1, masked.EXTRA_TICK),  # first value kept
            ([False, False], 2, masked.NO_TICK)):  # none: the last value
        jm, m = _pair(valid, np.array([1, 2], np.int32))
        y, err = masked.try_decimate(m, 2)
        jy, jerr = jmasked.try_decimate(jm, 2)
        assert (int(y[0]), int(err[0])) == (want_y, want_err)
        _eq(y, jy)
        _eq(err, jerr)


@pytest.mark.parametrize("r, p_valid", [(8, 0.1), (8, 0.25), (3, 0.5)])
def test_try_decimate_equals_jax(r, p_valid):
    """Frames with no tick (the frame's last value, NO_TICK), one tick and
    several (the first, EXTRA_TICK), on both packages."""
    rng = np.random.default_rng(r)
    t = 64 * r
    v = rng.random((4, t)) < p_valid
    x = rng.integers(-1000, 1000, size=(4, t)).astype(np.int32)
    jm, m = _pair(v, x)
    y, err = masked.try_decimate(m, r)
    jy, jerr = jmasked.try_decimate(jm, r)
    _eq(y, jy)
    _eq(err, jerr)
    empty = v.reshape(4, -1, r).sum(-1) == 0
    assert empty.any()
    np.testing.assert_array_equal(y.numpy()[empty],
                                  x.reshape(4, -1, r)[..., -1][empty])
    assert (err.numpy()[empty] == masked.NO_TICK).all()


def test_try_decimate_time_major():
    rng = np.random.default_rng(4)
    v = rng.random((32, 6)) < 0.3
    x = rng.normal(size=(32, 6)).astype(np.float32)
    jm, m = _pair(v, x)
    y, err = masked.try_decimate(m, 4, axis=0)
    jy, jerr = jmasked.try_decimate(jm, 4, axis=0)
    _eq(y, jy)
    _eq(err, jerr)


def test_decimate_counters_accumulate():
    t, r = 32, 4
    v = np.zeros(t, bool)
    v[0] = True  # frame 0: one tick
    v[4] = v[5] = True  # frame 1: extra
    jm, m = _pair(v, np.arange(t, dtype=np.int32))
    y, ctr = masked.decimate(m, r)
    assert ctr.tolist() == [6, 1] and ctr.dtype == torch.int64
    y2, ctr2 = masked.decimate(m, r, counters=ctr)
    assert ctr2.tolist() == [12, 2]
    jy, jctr = jmasked.decimate(jm, r)
    _eq(y, jy)
    _eq(ctr, jctr)


@pytest.mark.parametrize("r, phase", [(3, 1), (4, 0), (4, 3)])
def test_downsample_interpolate_equal_jax(r, phase):
    x = np.arange(4 * r, dtype=np.int32).reshape(2, 2 * r)
    m = masked.downsample(torch.from_numpy(x), r, phase=phase)
    jm = jmasked.downsample(jnp.asarray(x), r, phase=phase)
    _eq(m.valid, jm.valid)
    _eq(m.value, jm.value)
    y, err = masked.try_decimate(m, r)
    assert (err == masked.OK).all()
    np.testing.assert_array_equal(y.numpy(), x[:, phase::r])
    lo = np.array([[5, 9], [-2, 7]], np.int32)
    for axis in (-1, 0):
        mi = masked.interpolate(torch.from_numpy(lo), r, phase=phase,
                                fill=-3, axis=axis)
        jmi = jmasked.interpolate(jnp.asarray(lo), r, phase=phase, fill=-3,
                                  axis=axis)
        _eq(mi.valid, jmi.valid)
        _eq(mi.value, jmi.value)


def test_interpolate_then_hold_is_a_staircase():
    mi = masked.interpolate(torch.tensor([5, 9], dtype=torch.int32), 4,
                            phase=2)
    _, yz = masked.hold(torch.tensor(0, dtype=torch.int32), mi)
    assert yz.tolist() == [0, 0, 5, 5, 5, 5, 9, 9]


def test_mask_lift_state_advances_only_on_valid():
    # a lifted integrator equals the dense one on the valid subsequence
    def step(cfg, s, x):
        s2 = s + x
        return s2, s2

    lifted = masked.mask_lift(step)
    rng = np.random.default_rng(2)
    t = 128
    v = rng.random(t) < 0.3
    x = rng.integers(-10, 10, size=t).astype(np.int32)
    s = torch.tensor(0, dtype=torch.int32)
    got = []
    for i in range(t):
        s, my = lifted(None, s, Masked(torch.tensor(v[i]),
                                       torch.tensor(x[i])))
        if v[i]:
            got.append(int(my.value))
    assert got == np.cumsum(x[v]).tolist()


def test_masked_update_over_a_state_tree():
    """A NamedTuple of tensors advances where valid, leaf by leaf."""
    old = rpll.init((4,), device=CPU)
    new = rpll.RpllState(*(torch.full((4,), k, dtype=torch.int32)
                           for k in range(1, 5)))
    valid = torch.tensor([True, False, True, False])
    got = masked.masked_update(valid, new, old)
    assert isinstance(got, rpll.RpllState)
    assert got.y.tolist() == [4, 0, 4, 0]


def test_map_masked_keeps_framing():
    jm, m = _pair([True, False, True], np.array([1, 2, 3], np.int32))
    out = masked.map_masked(lambda v: v * 3, m)
    jout = jmasked.map_masked(lambda v: v * 3, jm)
    _eq(out.valid, jout.valid)
    _eq(out.value, jout.value)


def test_rpll_block_masked_equals_block_and_jax():
    cfg = rpll.RpllConfig(dt2=5, shift_frequency=12, shift_phase=10)
    jcfg = jrpll.RpllConfig(dt2=5, shift_frequency=12, shift_phase=10)
    rng = np.random.default_rng(3)
    t = 256
    v = rng.random((t, 2)) < 0.05
    x = np.cumsum(rng.integers(0, 1 << 6, size=(t, 2)),
                  axis=0).astype(np.int32)
    jm, m = _pair(v, x)
    st = rpll.init((2,), device=CPU)
    s1, (y1, f1) = rpll.block_masked(cfg, st, m)
    s2, (y2, f2) = rpll.block(cfg, st, m.value, m.valid)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)
    js, (jy, jf) = jrpll.block_masked(jcfg, jrpll.init((2,)), jm)
    _eq(y1, jy)
    _eq(f1, jf)
    for g, w in zip(to_numpy(s1), js, strict=True):
        _eq(g, w)


def test_convert_masked_round_trip():
    jm, _ = _pair([True, False], np.array([4, 5], np.int32))
    m = to_torch(jm, CPU)
    assert isinstance(m, Masked) and m.valid.dtype == torch.bool
    back = to_numpy(m)
    np.testing.assert_array_equal(back.valid, np.asarray(jm.valid))
    np.testing.assert_array_equal(back.value, np.asarray(jm.value))
