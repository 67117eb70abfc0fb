"""Port parity for `idsp_tpu_torch.design` against `idsp_tpu.design`:
the nine cookbook builders and `WebAudio`, `freqz`/`freqz_ba5`,
`PidBuilder`/`Pid` (float and Q<29>), `BiquadConfig` (four tags, dict
round trip, every `DesignError` path) and the two `_round_sat_i32`s.

The port copies the JAX package's numpy code, so every float64 result is
held equal to the JAX package's (tolerance 0) and every quantized one bit
for bit.  The cookbook transfer gates of tests/test_cookbook_gates.py run
on the port's builders with that file's own tolerances.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

import idsp_tpu.compat as j_compat
import idsp_tpu.design as jd
import idsp_tpu.design.config as jcfg
from idsp_tpu.design.pid import ClampedCoeffs as JClampedCoeffs

import idsp_tpu_torch.compat as t_compat
import idsp_tpu_torch.design as td
import idsp_tpu_torch.design.config as tcfg
from idsp_tpu_torch.convert import clamped_coeffs
from idsp_tpu_torch.design.pid import ClampedCoeffs
from idsp_tpu_torch.filters import biquad


def _ns(d, cfg):
    return SimpleNamespace(
        Filter=d.Filter, FilterType=d.FilterType, Shape=d.Shape,
        WebAudio=d.WebAudio, PidBuilder=d.PidBuilder, Pid=d.Pid,
        Units=d.Units, Action=d.Action, Order=d.Order, DesignError=d.DesignError,
        BiquadConfig=cfg.BiquadConfig, BaConfig=cfg.BaConfig,
        FilterConfig=cfg.FilterConfig, PidConfig=cfg.PidConfig,
        GainsConfig=cfg.GainsConfig, RawConfig=cfg.RawConfig)


J, T = _ns(jd, jcfg), _ns(td, tcfg)
TYPES = [ft.value for ft in jd.FilterType]


def _same(got, want):
    """Equal values of (nested) results: arrays bit for bit, ClampedCoeffs
    field by field."""
    if isinstance(want, JClampedCoeffs):
        assert isinstance(got, ClampedCoeffs)
        np.testing.assert_array_equal(got.ba, want.ba)
        assert np.asarray(got.ba).dtype == np.asarray(want.ba).dtype
        for k in ("u", "min", "max"):
            g, w = getattr(got, k), getattr(want, k)
            assert type(g) is type(w) and (g == w or (g != g and w != w)), k
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- cookbook builders -------------------------------------------------------

FILTERS = {
    "q_default": lambda d: d.Filter().critical_frequency(0.07),
    "gain_shelf_q": lambda d: (d.Filter().critical_frequency(0.02)
                               .gain_db(-10.0).shelf_db(20.0).q(3.0)),
    "bandwidth": lambda d: (d.Filter().frequency_of(1e3, 48e3)
                            .bandwidth(2.0).gain_linear(1.5)),
    "slope": lambda d: (d.Filter().critical_frequency(0.2).shelf_db(-6.0)
                        .shelf_slope(0.7)),
    "inverse_q": lambda d: (d.Filter().angular_critical_frequency(1.1)
                            .inverse_q(0.2).shelf_linear(2.5)),
    "nyquist_edge": lambda d: d.Filter().critical_frequency(0.499).q(0.5),
}


@pytest.mark.parametrize("typ", TYPES)
@pytest.mark.parametrize("case", sorted(FILTERS))
def test_cookbook_builders_equal_jax(typ, case):
    jf, tf = FILTERS[case](J), FILTERS[case](T)
    want = getattr(jf, typ)()
    _same(getattr(tf, typ)(), want)
    _same(tf.build(T.FilterType(typ)), want)
    _same(tf.try_build(T.FilterType(typ)), jf.try_build(J.FilterType(typ)))


WEBAUDIO = [
    dict(),
    dict(frequency_hz=1200.0, detune_cents=-300.0, q=4.0, gain_db=6.0),
    dict(frequency_hz=20.0, sample_rate_hz=192e3, q=0.3, gain_db=-12.0),
]


@pytest.mark.parametrize("typ", TYPES)
@pytest.mark.parametrize("i", range(len(WEBAUDIO)))
def test_webaudio_equals_jax(typ, i):
    jw = J.WebAudio(typ=J.FilterType(typ), **WEBAUDIO[i])
    tw = T.WebAudio(typ=T.FilterType(typ), **WEBAUDIO[i])
    _same(tw.build(), jw.build())
    _same(tw.try_build(), jw.try_build())
    assert tw.filter() == T.Filter(**{k: getattr(jw.filter(), k) for k in (
        "frequency", "gain", "shelf")}, shape=T.Shape(
            jw.filter().shape.kind, jw.filter().shape.value))


# --- frequency response ------------------------------------------------------


def test_freqz_and_freqz_ba5_equal_jax():
    rng = np.random.default_rng(70)
    freqs = np.concatenate([[0.0, 0.5], rng.uniform(0, 0.5, 64)])
    for _ in range(4):
        b, a = rng.normal(size=3), rng.normal(size=3)
        _same(td.freqz(b, a, freqs), jd.freqz(b, a, freqs))
    ba5 = biquad.from_cookbook(td.Filter().critical_frequency(0.1).notch())
    _same(td.freqz_ba5(ba5, freqs), jd.freqz_ba5(ba5, freqs))
    ba_q = biquad.quantize_ba(ba5, 29)
    _same(td.freqz_ba5(ba_q, freqs, f_shift=29),
          jd.freqz_ba5(ba_q, freqs, f_shift=29))
    _same(td.freqz_ba5(np.stack([ba5, ba5 * 0.5]), 0.1),
          jd.freqz_ba5(np.stack([ba5, ba5 * 0.5]), 0.1))


# --- PID ---------------------------------------------------------------------

PIDS = {
    "golden": lambda d: (d.PidBuilder().with_gain(d.Action.I, 1e-3)
                         .with_gain(d.Action.P, 1.0).with_gain(d.Action.D, 1e2)
                         .with_limit(d.Action.I, 1e3)
                         .with_limit(d.Action.D, 1e1)),
    "i_only": lambda d: d.PidBuilder().ki(1e-4),
    "order_p": lambda d: d.PidBuilder(order=d.Order.P).kp(3.0).kd(0.5)
    .kd2(0.01).limit_d(4.0).limit_d2(9.0),
    "order_i2": lambda d: d.PidBuilder(order=d.Order.I2).ki2(-1e-6).ki(-1e-3)
    .kp(-2.0).limit_i2(-50.0).limit_i(-20.0),
}


@pytest.mark.parametrize("how", ["f64", "f32", "q29"])
@pytest.mark.parametrize("case", sorted(PIDS))
def test_pid_builder_equals_jax(case, how):
    kw = {"f64": {}, "f32": {"dtype": np.float32}, "q29": {"f": 29}}[how]
    for period in (1.0, 1e-3):
        _same(PIDS[case](T).build(period, **kw),
              PIDS[case](J).build(period, **kw))
        _same(PIDS[case](T).try_build(period, **kw),
              PIDS[case](J).try_build(period, **kw))


PID_UNITS = {
    "pi_setpoint": (lambda d: d.Pid().kp(1.0).ki(1e-3).with_setpoint(0.5)
                    .output_limits(-3.0, 4.0), (1e-3, 2.0, 4.0)),
    "negative_p": (lambda d: d.Pid().kp(-2.0).ki(1e-4).limit_of(d.Action.I,
                                                                100.0)
                   .with_setpoint(-1.5), (1.0, 1.0, 1.0)),
    "pid_unbounded": (lambda d: d.Pid(order=d.Order.P).kp(0.5).kd(1e-2)
                      .limit_of(d.Action.D, float("nan")), (1e-4, 0.5, 2.0)),
    "saturating": (lambda d: d.Pid().kp(1.0).ki(0.5).output_limits(-1e12,
                                                                   1e12),
                   (1.0, 1e-3, 1e-3)),
}


@pytest.mark.parametrize("f", [None, 29])
@pytest.mark.parametrize("case", sorted(PID_UNITS))
def test_pid_with_units_equals_jax(case, f):
    make, (t, x, y) = PID_UNITS[case]
    jpid, tpid = make(J), make(T)
    want = jpid.build(J.Units(t, x, y), f=f)
    _same(tpid.build(T.Units(t, x, y), f=f), want)
    _same(clamped_coeffs(want), want)


# --- BiquadConfig ------------------------------------------------------------

CONFIGS = {
    "ba": lambda d: d.BiquadConfig("Ba", d.BaConfig(
        ba=[[0.3, 0.2, 0.1], [1.0, -0.4, 0.2]], offset=12.5, min=-1e3,
        max=2e3)),
    "raw": lambda d: d.BiquadConfig("Raw", d.RawConfig(
        ba=[1, 2, 3, 4, 5], u=7, min=-9, max=9)),
    "pid": lambda d: d.BiquadConfig("Pid", d.PidConfig(
        order="I", gain=d.GainsConfig(i=1e-3, p=1.0),
        limit=d.GainsConfig.splat(math.inf), setpoint=0.5, min=-1e6,
        max=1e6)),
    "filter_notch": lambda d: d.BiquadConfig("Filter", d.FilterConfig(
        typ="notch", frequency=0.2, min=-1e4, max=1e4)),
    "filter_shelf": lambda d: d.BiquadConfig("Filter", d.FilterConfig(
        typ="highshelf", frequency=0.05, gain_db=-3.0, shelf_db=6.0,
        shape=d.Shape.slope(0.8), offset=-40.0)),
}
UNITS = [(1.0, 1.0, 1.0), (1e-5, 2.0, 0.25)]


@pytest.mark.parametrize("f", [None, 29])
@pytest.mark.parametrize("units", range(len(UNITS)))
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_biquad_config_build_equals_jax(case, units, f):
    u = UNITS[units]
    jc, tc = CONFIGS[case](J), CONFIGS[case](T)
    for validate in (True, False):
        _same(tc.build(T.Units(*u), f=f, validate=validate),
              jc.build(J.Units(*u), f=f, validate=validate))


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_biquad_config_dict_round_trip_equals_jax(case):
    d = CONFIGS[case](J).to_dict()
    assert CONFIGS[case](T).to_dict() == d
    back = tcfg.BiquadConfig.from_dict(d)
    assert back.to_dict() == d
    _same(back.build(f=29), jcfg.BiquadConfig.from_dict(d).build(f=29))


@pytest.mark.parametrize("tag", ["Ba", "Raw", "Pid", "Filter"])
def test_biquad_config_from_tag_equals_jax(tag):
    jc, tc = J.BiquadConfig.from_tag(tag), T.BiquadConfig.from_tag(tag)
    assert tc.to_dict() == jc.to_dict()
    if tag != "Filter":  # the default Filter (frequency 0) builds NaNs
        _same(tc.build(f=29), jc.build(f=29))


# every DesignError the JAX package raises, on the same inputs
ERRORS = {
    "filter_nan_frequency": lambda d: d.Filter().angular_critical_frequency(
        math.nan).try_build(d.FilterType.LOWPASS),
    "filter_frequency_range": lambda d: d.Filter()
    .angular_critical_frequency(4.0).try_build(d.FilterType.LOWPASS),
    "filter_gain": lambda d: d.Filter().critical_frequency(0.1)
    .gain_linear(0.0).try_build(d.FilterType.PEAKING),
    "filter_shelf": lambda d: d.Filter().critical_frequency(0.1)
    .shelf_linear(-1.0).try_build(d.FilterType.LOWSHELF),
    "filter_shape_nan": lambda d: d.Filter().critical_frequency(0.1)
    .bandwidth(math.inf).try_build(d.FilterType.BANDPASS),
    "filter_q": lambda d: d.Filter().critical_frequency(0.1).q(0.0)
    .try_build(d.FilterType.NOTCH),
    "filter_slope": lambda d: d.Filter().critical_frequency(0.1)
    .shelf_slope(-1.0).try_build(d.FilterType.HIGHSHELF),
    "webaudio_nan": lambda d: d.WebAudio(detune_cents=math.nan).try_build(),
    "webaudio_rate": lambda d: d.WebAudio(sample_rate_hz=0.0).try_build(),
    "webaudio_q": lambda d: d.WebAudio(q=-1.0).try_build(),
    "webaudio_range": lambda d: d.WebAudio(frequency_hz=30e3).try_build(),
    "pid_period_nan": lambda d: d.PidBuilder().ki(1.0).try_build(math.inf),
    "pid_period": lambda d: d.PidBuilder().ki(1.0).try_build(0.0),
    "pid_gain_nan": lambda d: d.PidBuilder().ki(math.nan).try_build(1.0),
    "pid_limit_nan": lambda d: d.PidBuilder().limit_i(math.nan)
    .try_build(1.0),
    "pid_limit_zero": lambda d: d.PidBuilder().ki(1.0).limit_i(0.0)
    .try_build(1.0),
    "pid_sign": lambda d: d.PidBuilder().ki(1.0).limit_i(-5.0)
    .try_build(1.0),
    "pid_inverted": lambda d: d.Pid().kp(1.0).output_limits(1.0, -1.0)
    .try_build(d.Units()),
    "pid_units_nan": lambda d: d.Pid().kp(1.0).try_build(d.Units(x=math.nan)),
    "pid_units": lambda d: d.Pid().kp(1.0).try_build(d.Units(y=-2.0)),
    "config_tag": lambda d: d.BiquadConfig.from_tag("Unknown"),
    "config_build_tag": lambda d: d.BiquadConfig("Nope", None).build(),
    "config_offset": lambda d: d.BiquadConfig("Ba", d.BaConfig(
        offset=math.inf)).build(),
    "config_limits_nan": lambda d: d.BiquadConfig("Ba", d.BaConfig(
        min=math.nan)).build(),
    "config_inverted": lambda d: d.BiquadConfig("Ba", d.BaConfig(
        min=1.0, max=-1.0)).build(d.Units()),
    "config_ba_nan": lambda d: d.BiquadConfig("Ba", d.BaConfig(
        ba=[[math.nan, 0.0, 0.0], [1.0, 0.0, 0.0]])).build(),
    "config_units": lambda d: d.BiquadConfig("Ba").build(d.Units(x=0.0)),
    "config_filter_t": lambda d: d.BiquadConfig("Filter", d.FilterConfig(
        frequency=0.1)).build(d.Units(t=math.inf)),
    "config_filter_range": lambda d: d.BiquadConfig("Filter", d.FilterConfig(
        frequency=0.7)).build(),
    "config_pid": lambda d: d.BiquadConfig("Pid", d.PidConfig(
        gain=d.GainsConfig(i=1.0, p=1.0), limit=d.GainsConfig(i=-1.0)))
    .build(),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_design_errors_equal_jax(case):
    with pytest.raises(jd.DesignError) as je:
        ERRORS[case](J)
    with pytest.raises(td.DesignError) as te:
        ERRORS[case](T)
    assert (te.value.kind, te.value.name) == (je.value.kind, je.value.name)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("which", ["compat", "config"])
def test_round_sat_i32_equals_jax(which):
    """compat.py's trunc(v +- 0.5) and config.py's floor/ceil form, each
    against its JAX twin at the rounding ties, the int32 edges and the
    non-finite values."""
    got_fn = {"compat": t_compat, "config": tcfg}[which]._round_sat_i32
    want_fn = {"compat": j_compat, "config": jcfg}[which]._round_sat_i32
    vals = [0.5, -0.5, 1.5, -1.5, 2.5, -2.49999, 2.0**31, -(2.0**31),
            2.0**31 - 1, 2.0**31 - 0.5, -(2.0**31) - 0.5, 2.0**31 - 1.5,
            1e300, -1e300, math.nan, math.inf, -math.inf, 0.0, -0.0]
    for v in vals:
        got, want = got_fn(v), want_fn(v)
        assert type(got) is int and got == want, (v, got, want)


# --- the cookbook transfer gates (tests/test_cookbook_gates.py) ---------------

GATES = {
    "lowpass": (lambda: td.Filter().critical_frequency(0.01).gain_db(20.0)
                .lowpass(),
                [(1e-3, "db", 20.0, 0.01), (0.01, "db", 17.0, 0.02),
                 (0.4, "below", -40.0)]),
    "highpass": (lambda: td.Filter().critical_frequency(0.1).gain_db(-2.0)
                 .highpass(),
                 [(1e-3, "below", -40.0), (0.1, "db", -5.0, 0.02),
                  (0.4, "db", -2.0, 0.01)]),
    "bandpass": (lambda: td.Filter().critical_frequency(0.02).bandwidth(2.0)
                 .gain_db(3.0).bandpass(),
                 [(1e-4, "below", -35.0), (0.01, "db", 0.0, 0.02),
                  (0.02, "db", 3.0, 0.01), (0.04, "db", 0.0, 0.04),
                  (0.4, "below", -25.0)]),
    "allpass": (lambda: td.Filter().critical_frequency(0.02).gain_db(-10.0)
                .allpass(),
                [(f, "db", -10.0, 0.01) for f in (1e-4, 0.01, 0.02, 0.04,
                                                  0.4)]),
    "notch": (lambda: td.Filter().critical_frequency(0.02).bandwidth(2.0)
              .notch(),
              [(1e-4, "db", 0.0, 0.01), (0.01, "db", -3.0, 0.02),
               (0.02, "below", -140.0), (0.04, "db", -3.0, 0.02),
               (0.4, "db", 0.0, 0.01)]),
    "peaking": (lambda: td.Filter().critical_frequency(0.02).bandwidth(2.0)
                .gain_db(-10.0).shelf_db(20.0).peaking(),
                [(1e-4, "db", -10.0, 0.01), (0.01, "db", 0.0, 0.04),
                 (0.02, "db", 10.0, 0.01), (0.04, "db", 0.0, 0.04),
                 (0.4, "db", -10.0, 0.05)]),
    "highshelf": (lambda: td.Filter().critical_frequency(0.02).gain_db(-10.0)
                  .shelf_db(-20.0).highshelf(),
                  [(1e-6, "db", -10.0, 0.01), (1e-4, "db", -10.0, 0.01),
                   (0.02, "db", -20.0, 0.01), (0.4, "db", -30.0, 0.01)]),
    "lowshelf": (lambda: td.Filter().critical_frequency(0.02).gain_db(-10.0)
                 .shelf_db(-20.0).lowshelf(),
                 [(1e-6, "db", -30.0, 0.01), (1e-4, "db", -30.0, 0.01),
                  (0.02, "db", -20.0, 0.01), (0.4, "db", -10.0, 0.01)]),
    "iho": (lambda: td.Filter().critical_frequency(0.01).gain_db(-20.0)
            .shelf_db(10.0).q(10.0).iho(),
            [(1e-5, "db", 40.0, 0.01), (0.01, "below", -40.0),
             (4.99e-1, "db", -10.0, 0.01)]),
}


def _check_gates(ba, gates, tag):
    for f, kind, *args in gates:
        h = td.freqz(ba[0], ba[1], f)
        g = 10.0 * np.log10(np.abs(h) ** 2)
        if kind == "db":
            want, tol = args
            assert abs(g - want) <= tol, (tag, f, g, want)
        else:
            assert g <= args[0], (tag, f, g, args[0])


@pytest.mark.parametrize("name", sorted(GATES))
def test_cookbook_gates_on_port_builders(name):
    make, gates = GATES[name]
    ba = make()
    _check_gates(ba, gates, "float")
    # Q32<30> and back (biquad.rs From<[[f64;3];2]>), then the same gates
    baf = biquad.quantize_ba(biquad.from_cookbook(np.asarray(ba)),
                             30).astype(np.float64) * 2.0**-30
    _check_gates([[baf[0], baf[1], baf[2]], [1.0, -baf[3], -baf[4]]], gates,
                 "quantized")
