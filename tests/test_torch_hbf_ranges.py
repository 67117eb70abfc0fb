"""The time-range plan of K7 `hbf_dec_cascade_bank` and K8
`hbf_int_cascade_bank` (`filters/hbf_cuda.py` `dec_range_plan`,
`int_range_plan`), held on the CPU with the kernels' plain versions.

The kernels cut a block of time into ranges, one CUDA block per lane
tile and range, and warm each range up on a halo of input rows before
it, the plan's numbers.  These tests show, for `HBF_TAPS` and
`HBF_TAPS_98` at depths 1-4:

* the plain cascade started from a random state ``halo`` input rows
  before a range start gives exactly the one-shot output from the range
  start on, bit for bit, and one step less of halo (one last-stage row,
  2**depth input rows, for K7; one input row for K8) does not;
* the plain version run range by range as the kernels walk (range 0, or
  any range whose walk starts at row 0, from the carried tails; every
  other from a random state; ranges shorter than the halo included)
  equals the one-shot plain version bit for bit over two carried blocks,
  and the interpret-mode JAX kernels within the 16 ULP of
  tests/test_torch_rate_conversion.py;
* the same two for K22 `hbf_dec_cascade_mxu` and K23
  `hbf_int_cascade_mxu` at precision "highest", which run K7's and K8's
  walks with K7's and K8's plans (`hbf_dec_cascade_mxu_plain`,
  `hbf_int_cascade_mxu_plain`: the band order of `hbf_mxu._sum_band`):
  the halo is exact and one step less is not, and the walk range by range
  equals one shot bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.hbf_pallas import (
    hbf_dec_cascade_bank as j_hbf_dec_cascade_bank,
    hbf_int_cascade_bank as j_hbf_int_cascade_bank,
)

from idsp_tpu_torch.filters import hbf
from idsp_tpu_torch.filters.hbf_mxu import (
    hbf_dec_cascade_mxu_plain,
    hbf_int_cascade_mxu_plain,
)
from idsp_tpu_torch.filters.hbf_cuda import (
    RangePlan,
    dec_range_plan,
    default_ranges,
    hbf_dec_cascade_bank_plain,
    hbf_int_cascade_bank_plain,
    int_range_plan,
)

CPU = torch.device("cpu")
TAPS = ["HBF_TAPS", "HBF_TAPS_98"]
DEPTHS = [1, 2, 3, 4]
# the interpolators: K8 and K23 "highest" (K8's walk, the band order);
# "dec" and "highest" (K22's) are the decimators
INT = ("int", "int_highest")


def _f32(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _ms(kernel, taps, depth):
    """Stage tap counts in stage order."""
    order = reversed(range(depth)) if kernel not in INT else range(depth)
    return [len(taps[i]) for i in order]


def _plan(kernel, taps, depth, t, ranges):
    fn = dec_range_plan if kernel not in INT else int_range_plan
    return fn(_ms(kernel, taps, depth), t, ranges)


def _state(kernel, taps, depth, c, rng, scale=1.0):
    """A random carried state of the cascade, N(0, scale**2)."""
    def f(shape):
        return _f32(rng, shape) * scale

    if kernel not in INT:
        return tuple(hbf.HbfDecState(f(s.odd.shape), f(s.even.shape))
                     for s in hbf.hbf_dec_cascade_init(
                         depth, (c,), taps=taps, axis=0, device=CPU))
    return tuple(hbf.HbfIntState(f(s.x.shape))
                 for s in hbf.hbf_int_cascade_init(
                     depth, (c,), taps=taps, axis=0, device=CPU))


def _plain(kernel, states, xs, taps):
    if kernel == "highest":  # K22 "highest": K7's cascade, the band order
        return hbf_dec_cascade_mxu_plain(states, xs, taps=taps,
                                         precision="highest")
    if kernel == "int_highest":  # K23 "highest": K8's, the band order
        return hbf_int_cascade_mxu_plain(states, xs, taps=taps,
                                         precision="highest")
    fn = (hbf_dec_cascade_bank_plain if kernel == "dec"
          else hbf_int_cascade_bank_plain)
    return fn(states, xs, taps=taps)


def _out_rows(kernel, depth, n_in):
    """Output rows of n_in input rows."""
    return n_in >> depth if kernel not in INT else n_in << depth


def _walk(kernel, plan, taps, depth, states, xs, rng):
    """The kernels' walk on the plain version: each range from its
    span's walk start, from the carried states where that is row 0 and
    from random ones elsewhere, its outputs from the range start on; the
    new states are the last range's."""
    c = xs.shape[1]
    ys = []
    for k in range(plan.ranges):
        p0, start, stop = plan.span(k)
        st = states if p0 == 0 else _state(kernel, taps, depth, c, rng)
        st, y = _plain(kernel, st, xs[p0:stop], taps)
        ys.append(y[_out_rows(kernel, depth, start - p0):])
    return st, torch.cat(ys)


def _equal(a, b):
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,), strict=True):
        if isinstance(u, tuple):
            _equal(u, v)
        else:
            assert u.dtype == v.dtype and u.shape == v.shape
            assert torch.equal(u, v)


def _ulp_gate(have, want, k=16):
    """|have - want| <= k * spacing(max |want|) (tests/test_hbf_pallas.py)."""
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape, (have.shape, want.shape)
    scale = np.float32(max(np.abs(want).max(), 1.0))
    err = np.abs(have.astype(np.float64) - want).max()
    assert err <= k * np.spacing(scale), (err, k * np.spacing(scale))


def test_plan_numbers_hbf_taps_depth4():
    dec = dec_range_plan([4, 5, 10, 23], 32768, 17)
    # 2*447 + 13 = 907 full-rate rows, rounded up to 57 output rows
    assert dec == RangePlan(rows=2048, seg=121, ranges=17, halo=912,
                            stage_halo=(447, 215, 89, 0), scale=16)
    itp = int_range_plan([23, 10, 5, 4], 2048, 17)
    assert itp == RangePlan(rows=2048, seg=121, ranges=17, halo=57,
                            stage_halo=(13, 6, 4, 0), scale=1)
    assert dec.span(0) == (0, 0, 1936)
    assert dec.span(1) == (1024, 1936, 3872)
    assert dec.span(16) == (30064, 30976, 32768)
    assert itp.span(16) == (1879, 1936, 2048)


@pytest.mark.parametrize("kernel", ["dec", "int"])
@pytest.mark.parametrize("ranges", [1, 2, 3, 7, 64, 10**6])
def test_plan_spans_cut_the_block(kernel, ranges):
    t = 4096
    plan = _plan(kernel, hbf.HBF_TAPS, 4, t, ranges)
    assert 1 <= plan.ranges <= ranges
    stops = [plan.span(k) for k in range(plan.ranges)]
    assert stops[0][:2] == (0, 0)
    assert stops[-1][2] == t
    for (_, _, stop), (p0, start, _) in zip(stops, stops[1:]):
        assert start == stop  # no row twice, none left out
        assert p0 == max(0, start - plan.halo)
    assert all(start < stop for _, start, stop in stops)


def test_default_ranges_needs_a_card():
    with pytest.raises(ValueError):
        default_ranges(2048, 512, CPU)


@pytest.mark.parametrize("kernel", ["dec", "int", "highest", "int_highest"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("tname", TAPS)
def test_halo_warm_start_is_exact(kernel, depth, tname):
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(80 + depth)
    c, step = 4, (1 << depth if kernel not in INT else 1)
    plan = _plan(kernel, taps, depth, 4096, 1)
    start = plan.halo + 3 * step  # a range start, one more step allowed
    xs = _f32(rng, (start + 8 * step, c))
    _, want = _plain(kernel, _state(kernel, taps, depth, c, rng), xs, taps)
    want = want[_out_rows(kernel, depth, start):]
    # a wrong row can reach the output through products of the smallest
    # taps (7.6e-7 * 1.1e-5 in HBF_TAPS): a state of 1e12 shows it
    for halo in (plan.halo, plan.halo - step):
        _, y = _plain(kernel, _state(kernel, taps, depth, c, rng, 1e12),
                      xs[start - halo:], taps)
        y = y[_out_rows(kernel, depth, halo):]
        assert y.shape == want.shape
        if halo == plan.halo:
            assert torch.equal(y, want)
        else:  # the first output still reads a row of the random state
            assert not torch.equal(y[0], want[0])


@pytest.mark.parametrize("kernel", ["dec", "int"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("tname", TAPS)
def test_walk_by_ranges_equals_one_shot_and_jax(kernel, depth, tname):
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(90 + depth)
    c = 128  # the JAX kernels take c % 128 == 0
    t = 2048 if kernel == "dec" else 2048 >> depth
    st0 = _state(kernel, taps, depth, c, rng)
    xs = [_f32(rng, (t, c)) for _ in range(2)]
    rows = _plan(kernel, taps, depth, t, 1).rows
    # 1 range, a few, ranges shorter than the halo, one row each
    for ranges in (1, 2, 5, rows // 8, rows):
        plan = _plan(kernel, taps, depth, t, ranges)
        st, st_w = st0, st0
        for x in xs:
            st, y = _plain(kernel, st, x, taps)
            st_w, y_w = _walk(kernel, plan, taps, depth, st_w, x, rng)
            _equal((st_w, y_w), (st, y))

    # the one-shot plain version against the interpret-mode JAX kernel
    if kernel == "dec":
        jst = tuple(jhbf.HbfDecState(jnp.asarray(s.odd.numpy()),
                                     jnp.asarray(s.even.numpy()))
                    for s in st0)
        jfn, tc = j_hbf_dec_cascade_bank, 256
    else:
        jst = tuple(jhbf.HbfIntState(jnp.asarray(s.x.numpy())) for s in st0)
        jfn, tc = j_hbf_int_cascade_bank, min(t, 32)
    st = st0
    for x in xs:
        st, y = _plain(kernel, st, x, taps)
        jst, jy = jfn(jst, jnp.asarray(x.numpy()), taps=taps, time_chunk=tc,
                      interpret=True)
        _ulp_gate(y.numpy(), jy)
    for s, js in zip(st, jst, strict=True):
        for a, b in zip(s, js, strict=True):
            _ulp_gate(a.numpy(), b)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("tname", TAPS)
def test_highest_walk_by_ranges_equals_one_shot(depth, tname):
    """K22 "highest" walked as the kernel walks it (K7's plan) equals
    its one-shot plain version bit for bit over two carried blocks, at
    one range, a few, ranges shorter than the halo and one row each."""
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(100 + depth)
    c, t = 8, 2048
    st0 = _state("highest", taps, depth, c, rng)
    xs = [_f32(rng, (t, c)) for _ in range(2)]
    rows = _plan("highest", taps, depth, t, 1).rows
    for ranges in (1, 2, 5, rows // 8, rows):
        plan = _plan("highest", taps, depth, t, ranges)
        st, st_w = st0, st0
        for x in xs:
            st, y = _plain("highest", st, x, taps)
            st_w, y_w = _walk("highest", plan, taps, depth, st_w, x, rng)
            _equal((st_w, y_w), (st, y))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("tname", TAPS)
def test_int_highest_walk_by_ranges_equals_one_shot(depth, tname):
    """K23 "highest" walked as the kernel walks it (K8's plan) equals its
    one-shot plain version bit for bit over two carried blocks, at one
    range, a few, ranges shorter than the halo and one row each."""
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(110 + depth)
    c, t = 8, 2048 >> depth
    st0 = _state("int_highest", taps, depth, c, rng)
    xs = [_f32(rng, (t, c)) for _ in range(2)]
    rows = _plan("int_highest", taps, depth, t, 1).rows
    for ranges in (1, 2, 5, rows // 8, rows):
        plan = _plan("int_highest", taps, depth, t, ranges)
        st, st_w = st0, st0
        for x in xs:
            st, y = _plain("int_highest", st, x, taps)
            st_w, y_w = _walk("int_highest", plan, taps, depth, st_w, x,
                              rng)
            _equal((st_w, y_w), (st, y))
