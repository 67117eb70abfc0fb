"""K9/K10's time-range plan (`idsp_tpu_torch.filters.cic_cuda`): the
carry map T^L against the plain cascade, `cic_plan`'s rules and
refusals, and `cic_ranges_plain` -- the kernels' algorithm in plain
PyTorch: the range split, each range's local pass from zero, the carries
folded with T^L (and T^(L warps) across a cluster's CTAs), the second
pass -- against the plain versions and the interpret-mode JAX kernels.

Wrapping int32 arithmetic throughout: every comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import cic as jcic
from idsp_tpu.filters.cic_pallas import (
    cic_dec_bank as j_cic_dec_bank,
    cic_int_bank as j_cic_int_bank,
)

from idsp_tpu_torch.convert import to_numpy
from idsp_tpu_torch.filters import cic
from idsp_tpu_torch.filters.cic import _integrator_chain
from idsp_tpu_torch.filters.cic_cuda import (
    MAP_WORDS,
    CIC_WARPS,
    MAX_CLUSTER,
    MAX_SMEM,
    WARPS_PER_SM,
    CicPlan,
    carry_map,
    cic_dec_bank,
    cic_dec_bank_plain,
    cic_int_bank,
    cic_int_bank_plain,
    cic_plan,
    cic_ranges_plain,
    cic_smem,
    plan_maps,
)

CPU = torch.device("cpu")
SMS = 132  # an H100's SMs
ROWS = 19  # kept rows (K9) or slow rows (K10) a block


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _state(rng, n, m, c):
    return cic.CicState(*(_i32(rng, tuple(v.shape))
                          for v in cic.init(n, m, (c,), device=CPU)))


def _eq_jax(have, want):
    for a, b in zip(jax.tree.leaves(to_numpy(have)), jax.tree.leaves(want),
                    strict=True):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        if isinstance(g, tuple):
            _equal(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


# --- T^L ----------------------------------------------------------------------


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 7, 16, 255, 4096, 20000,
                                   2**15])
def test_carry_map_is_the_cascade_from_unit_states(steps):
    for n in range(1, 9):
        unit = torch.eye(n, dtype=torch.int32)  # row j: e_j
        end, _ = (_integrator_chain(unit, torch.zeros((n, steps),
                                                      dtype=torch.int32))
                  if steps else (unit, None))
        words = carry_map(n, steps)
        tl = np.zeros((n, n), np.int64)
        tl[np.tril_indices(n)] = words
        # column j of T^L is the end from e_j, as uint32 words
        assert np.array_equal(tl.T, end.numpy().astype(np.int64) & 0xFFFFFFFF)
        assert all(tl[i, i] == 1 for i in range(n))


def test_plan_maps_are_range_then_cta():
    plan = cic_plan(32768, 512, 3, 16, sms=SMS)
    words = plan_maps(plan, 3, 16, True)
    assert len(words) == 2 * MAP_WORDS
    assert words[:6] == carry_map(3, plan.length)
    assert words[MAP_WORDS:MAP_WORDS + 6] == carry_map(
        3, plan.length * plan.warps)
    assert not any(words[6:MAP_WORDS]) and not any(words[MAP_WORDS + 6:])
    itp = cic_plan(2048, 512, 3, 16, dec=False, sms=SMS)
    assert plan_maps(itp, 3, 16, False)[:6] == carry_map(3, 16 * itp.length)


# --- cic_plan -----------------------------------------------------------------


@pytest.mark.parametrize("t,c,n,r,dec", [
    (32768, 512, 3, 16, True), (32768, 1024, 3, 16, True),
    (32768, 512, 3, 4, True), (2048, 512, 3, 16, False),
    (2048, 1024, 3, 16, False), (8192, 200, 8, 1, True),
    (16, 1, 1, 16, True), (1, 50, 3, 4, False), (4, 4224 * 2, 2, 4, True)])
def test_default_plan_rules(t, c, n, r, dec):
    plan = cic_plan(t, c, n, r, dec=dec, sms=SMS)
    assert plan.tiles == -(-c // 32)
    assert 1 <= plan.cluster <= MAX_CLUSTER
    # a power of two up to CIC_WARPS, WARPS_PER_SM warps an SM at most
    assert plan.warps & (plan.warps - 1) == 0 and plan.warps <= CIC_WARPS
    room = plan.tiles * MAX_CLUSTER * plan.warps
    assert room <= WARPS_PER_SM * SMS or plan.warps == 1
    assert plan.warps == CIC_WARPS or 2 * room > WARPS_PER_SM * SMS
    if dec:  # every kept row (0, r, 2r, ...) inside one range
        assert plan.length % r == 0
    assert plan.ranges == -(-t // plan.length) <= plan.cluster * plan.warps
    # no CTA without rows, and the ranges as even as whole rows allow
    assert (plan.cluster - 1) * plan.warps < plan.ranges
    unit = r if dec else 1
    assert plan.length == -(-(t // unit) // (plan.cluster * plan.warps)) * unit
    assert plan.smem == cic_smem(n, plan.warps) <= MAX_SMEM


def test_default_plans_at_the_main_paths_widths():
    assert cic_plan(32768, 512, 3, 16, sms=SMS) == CicPlan(
        tiles=16, cluster=8, warps=16, length=256, ranges=128, smem=6528)
    assert cic_plan(32768, 1024, 3, 16, sms=SMS) == CicPlan(
        tiles=32, cluster=8, warps=8, length=512, ranges=64, smem=3456)
    assert cic_plan(2048, 512, 3, 16, dec=False, sms=SMS).length == 16


@pytest.mark.parametrize("args,kw", [
    ((100, 128, 3, 16), {}),  # 100 % 16 != 0
    ((0, 128, 3, 16), {}), ((32, 0, 3, 16), {}),
    ((32, 128, 0, 16), {}), ((32, 128, 9, 16), {}), ((32, 128, 3, 0), {}),
    ((32, 128, 3, 16), {"warps": 0}), ((32, 128, 3, 16), {"warps": 33}),
    ((32, 128, 3, 16), {"sms": None, "cluster": 2}),
    ((32, 128, 3, 16), {"cluster": 0}), ((32, 128, 3, 16), {"cluster": 9}),
    ((64, 128, 3, 16), {"length": 24}),  # kept rows across ranges
    ((64, 128, 3, 16), {"length": 0}),
    ((4096, 128, 3, 16), {"length": 16, "warps": 32, "cluster": 7}),
    ((4096, 128, 3, 16), {"sms": None}), ((32, 128, 3, 16), {"sms": 0}),
    ((2**27, 128, 3, 16), {"dec": False}),  # t * r past int32
])
def test_plan_refusals(args, kw):
    kw = {"sms": SMS, **kw}
    with pytest.raises(ValueError):
        cic_plan(*args, **kw)


def test_zero_rows_return_the_state():
    rng = np.random.default_rng(3)
    st = _state(rng, 3, 2, 8)
    for fn in (cic_dec_bank, cic_int_bank):
        got, y = fn(st, torch.zeros((0, 8), dtype=torch.int32), 15)
        assert got is st and tuple(y.shape) == (0, 8)


# --- the kernels' algorithm -----------------------------------------------------

# forced range lengths in kept (K9) or slow (K10) rows: one row a range, a
# single range, a ragged last range, the default
FORCED = {"one_row": dict(length=1, warps=4, cluster=5),
          "single": dict(length=ROWS, warps=2, cluster=1),
          "ragged": dict(length=4, warps=3, cluster=2),
          "default": dict(sms=SMS, warps=4)}


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("dec", [True, False])
@pytest.mark.parametrize("form", list(FORCED))
def test_ranges_equal_plain(n, r, dec, form):
    c = 200
    rng = np.random.default_rng(100 * n + r + dec)
    kw = dict(FORCED[form])
    if "length" in kw and dec:
        kw["length"] *= r
    t = ROWS * r if dec else ROWS
    plan = cic_plan(t, c, n, r, dec=dec, **kw)
    if form == "ragged":
        assert t % plan.length and plan.ranges > 1
    st = st_p = _state(rng, n, 2, c)
    for _ in range(2):  # carried blocks
        x = _i32(rng, (t, c))  # full range: the sums wrap
        st, y = cic_ranges_plain(st, x, r - 1, plan, dec=dec)
        st_p, y_p = (cic_dec_bank_plain if dec else cic_int_bank_plain)(
            st_p, x, r - 1)
        _equal((st, y), (st_p, y_p))


@pytest.mark.parametrize("n,r", [(3, 16), (1, 4), (8, 2)])
def test_ranges_equal_jax_kernels(n, r):
    c = 128  # the JAX kernels take c % 128 == 0
    rng = np.random.default_rng(200 + n)
    st0 = _state(rng, n, 1, c)
    jst = jcic.CicState(*(jnp.asarray(v.numpy()) for v in st0))
    dec, itp, jdec, jint = st0, st0, jst, jst
    lim = 2**31 // jcic.gain(r - 1, n, 1) // 4
    for _ in range(2):
        x = _i32(rng, (16 * r, c))
        plan = cic_plan(16 * r, c, n, r, length=4 * r, warps=2, cluster=2)
        jdec, jy = j_cic_dec_bank(jdec, jnp.asarray(x.numpy()), r - 1,
                                  time_chunk=16 * r, interpret=True)
        dec, y = cic_ranges_plain(dec, x, r - 1, plan)
        _eq_jax((dec, y), (jdec, jy))
        xl = _i32(rng, (8, c), -lim, lim)
        plan = cic_plan(8, c, n, r, dec=False, length=3, warps=1, cluster=3)
        jint, jyi = j_cic_int_bank(jint, jnp.asarray(xl.numpy()), r - 1,
                                   time_chunk=8 * r, interpret=True)
        itp, yi = cic_ranges_plain(itp, xl, r - 1, plan, dec=False)
        _eq_jax((itp, yi), (jint, jyi))
