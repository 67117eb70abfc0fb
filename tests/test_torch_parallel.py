"""Port parity for the rest of `idsp_tpu_torch.parallel` and
`channelizer.channelize_tp`: `sharded_df1_float`, `sharded_df1_q_relay`,
both pipelines (`run_pipelined_sos`, replicated and sharded I/O),
`channelize_tp` in both ``out_mode``s, the meshes and `distributed`
helpers, and channel sharding.

As in tests/test_torch_halo.py, the port runs in 8 spawned gloo
processes (one spawn for the module), each case on the ranks [0, P) of
a subgroup, P = 1, 4 and 8 (the replicated pipeline and the relay at 1
and 4, the sizes of their JAX tests), on CPU tensors.  References on
the same seeded numpy inputs: the JAX function under `shard_map` on P
devices of the 8-device CPU mesh (tests/conftest.py), and JAX's
unsharded function.  Tolerances are the JAX tests': integers bit for
bit; the float DF1 within 1e-9 (tests/test_parallel.py:86-90); the
channelizer within 1e-5 (:226-231).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from idsp_tpu.design import Filter
from idsp_tpu.filters import biquad as jbq
from idsp_tpu.parallel import make_mesh, sharded_df1_float
from idsp_tpu.parallel.pipeline import run_pipelined_sos
from idsp_tpu.parallel.stream import sharded_df1_q_relay
from idsp_tpu.pipelines import channelizer as jchz

from idsp_tpu_torch import parallel
from idsp_tpu_torch.chain import DdcChain
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.parallel import distributed

import torch_ranks

SIZES = (1, 4, 8)
RNG = np.random.default_rng(11)
# sharded_df1_float: tests/test_parallel.py:51-67 (float64, n=256, c=3)
F_BA = jbq.from_cookbook(Filter().critical_frequency(0.05).lowpass())
F_X = RNG.normal(size=(256, 3))
F_SX, F_SY = RNG.normal(size=(3, 2)), RNG.normal(size=(3, 2))
# the relay: tests/test_sp_relay.py:16-35 (Q29 lowpass at 0.05)
Q_BA = jbq.quantize_ba(
    jbq.from_cookbook(Filter().critical_frequency(0.05).lowpass()), 29)
Q_X = RNG.integers(-(2**24), 2**24, size=(256, 3)).astype(np.int32)
Q_SX, Q_SY = (RNG.integers(-(2**20), 2**20, size=(3, 2)).astype(np.int32)
              for _ in range(2))


def _stages(p):
    """The JAX tests' Q29 lowpass stages: 0.05-0.14 for 4 (and 1), 0.03 +
    0.01 i for 8 (tests/test_pipeline_parallel.py:17-26, :110-118)."""
    fcs = (0.05, 0.08, 0.11, 0.14) if p <= 4 else [0.03 + 0.01 * i
                                                   for i in range(p)]
    return np.stack([jbq.quantize_ba(jbq.from_cookbook(
        Filter().critical_frequency(fc).lowpass()), 29) for fc in fcs[:p]])


PIPE_X = RNG.integers(-(2**24), 2**24, size=(6, 64, 3)).astype(np.int32)
# sharded I/O: (nb, tb, c) as the JAX tests (:67, :119: S=8 with one
# block a rank), 2 blocks for one rank
PIPE_SH_X = {p: RNG.integers(-(2**24), 2**24, size=shape).astype(np.int32)
             for p, shape in ((1, (2, 32, 3)), (4, (8, 32, 3)),
                              (8, (8, 32, 2)))}
# channelize_tp: tests/test_parallel.py:206-216 (m=16, 8 taps, n=32)
CH_M, CH_TAPS = 16, 8
CH_X = [RNG.normal(size=(32, CH_M, 2)).astype(np.float32) for _ in range(2)]
# channel sharding: DdcChain fold3 over 8 channels
CC_STEPS = RNG.integers(1 << 24, 1 << 30, size=(8,)).astype(np.int32)
CC_X = RNG.integers(-(2**27), 2**27, size=(2, 256)).astype(np.int32)


def _cases():
    cases = {"mesh": ("mesh_info", 8, {})}
    for p in SIZES:
        cases[f"float{p}"] = ("df1_float", p, dict(ba=F_BA, sx=F_SX, sy=F_SY,
                                                   xs=F_X))
        cases[f"sharded{p}"] = ("pipeline", p, dict(
            bas=_stages(p), x=PIPE_SH_X[p], f=29, shard_io=True))
        for mode in ("replicated", "scatter"):
            cases[f"tp{p}_{mode}"] = ("chan_tp", p, dict(
                xs=CH_X, m=CH_M, taps=CH_TAPS, out_mode=mode))
    for p in (1, 4):
        cases[f"relay{p}"] = ("relay", p, dict(ba=Q_BA, sx=Q_SX, sy=Q_SY,
                                               xs=Q_X, f=29))
        cases[f"pipe{p}"] = ("pipeline", p, dict(bas=_stages(p), x=PIPE_X,
                                                 f=29, shard_io=False))
        cases[f"chan{p}"] = ("chain_channels", p, dict(steps=CC_STEPS,
                                                       x=CC_X, blocks=2))
    return cases


@pytest.fixture(scope="module")
def runs():
    return torch_ranks.spawn(8, _cases())


def _ranks(runs, key, p):
    return [runs[r][key] for r in range(p)]


def _sharded(fn, p, in_specs, out_specs, axis="sp"):
    return jax.jit(shard_map(fn, mesh=make_mesh({axis: p}),
                             in_specs=in_specs, out_specs=out_specs))


def _sweep(bas, x):
    """The sequential stage-major sweep (JAX)."""
    nb, tb, c = x.shape
    y = jnp.asarray(x.reshape(nb * tb, c))
    for ba in bas:
        _, y = jbq.df1_process_q(jnp.asarray(ba), 29,
                                 jbq.df1_init((c,), jnp.int32), y)
    return np.asarray(y).reshape(x.shape)


def test_children_import_no_jax(runs):
    assert not any(out["jax_imported"] for out in runs)


@pytest.mark.parametrize("p", SIZES)
def test_sharded_df1_float(runs, p):
    outs = _ranks(runs, f"float{p}", p)
    st = jbq.Df1State(x=jnp.asarray(F_SX), y=jnp.asarray(F_SY))
    ba = jnp.asarray(F_BA)
    st_sh, ys_sh = _sharded(lambda v: sharded_df1_float(ba, st, v, "sp"), p,
                            P("sp"), (P(), P("sp")))(jnp.asarray(F_X))
    st_ref, ys_ref = jbq.df1_process(ba, st, jnp.asarray(F_X))
    ys = np.concatenate([o[2] for o in outs])
    for want_st, want_ys in ((st_sh, ys_sh), (st_ref, ys_ref)):
        np.testing.assert_allclose(ys, np.asarray(want_ys), rtol=1e-9,
                                   atol=1e-9)
        for sx, sy, _ in outs:  # replicated on every rank
            np.testing.assert_allclose(sy, np.asarray(want_st.y), rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_array_equal(sx, np.asarray(want_st.x))


@pytest.mark.parametrize("p", (1, 4))
def test_sharded_df1_q_relay(runs, p):
    outs = _ranks(runs, f"relay{p}", p)
    st = jbq.Df1State(x=jnp.asarray(Q_SX), y=jnp.asarray(Q_SY))
    st_sh, ys_sh = _sharded(
        lambda v: sharded_df1_q_relay(Q_BA, st, v, 29, "sp"), p, P("sp"),
        (P(), P("sp")))(jnp.asarray(Q_X))
    st_ref, ys_ref = jbq.df1_process_q(jnp.asarray(Q_BA), 29, st,
                                       jnp.asarray(Q_X))
    ys = np.concatenate([o[2] for o in outs])
    for want_st, want_ys in ((st_sh, ys_sh), (st_ref, ys_ref)):
        np.testing.assert_array_equal(ys, np.asarray(want_ys))
        for sx, sy, _ in outs:
            np.testing.assert_array_equal(sx, np.asarray(want_st.x))
            np.testing.assert_array_equal(sy, np.asarray(want_st.y))


@pytest.mark.parametrize("p", (1, 4))
def test_pipelined_sos_cascade(runs, p):
    bas = _stages(p)
    want = np.asarray(run_pipelined_sos(make_mesh({"pp": p}),
                                        jnp.asarray(bas),
                                        jnp.asarray(PIPE_X), 29))
    np.testing.assert_array_equal(want, _sweep(bas, PIPE_X))
    for got in _ranks(runs, f"pipe{p}", p):  # replicated output
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", SIZES)
def test_pipelined_sos_cascade_sharded(runs, p):
    bas, x = _stages(p), PIPE_SH_X[p]
    want = np.asarray(run_pipelined_sos(make_mesh({"pp": p}),
                                        jnp.asarray(bas), jnp.asarray(x), 29,
                                        shard_io=True))
    np.testing.assert_array_equal(want, _sweep(bas, x))
    outs = _ranks(runs, f"sharded{p}", p)
    got = np.stack([outs[b % p][b // p] for b in range(x.shape[0])])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["replicated", "scatter"])
@pytest.mark.parametrize("p", SIZES)
def test_channelize_tp(runs, p, mode):
    """Two chained blocks against JAX's `channelize_tp` under shard_map
    and the unsharded `channelize` within 1e-5; the branch histories bit
    for bit."""
    outs = _ranks(runs, f"tp{p}_{mode}", p)
    y_spec = P() if mode == "replicated" else P(None, "tp", None)
    f = _sharded(lambda st, v: jchz.channelize_tp(
        st, v, "tp", m=CH_M, taps=CH_TAPS, out_mode=mode), p,
        (P(None, "tp", None), P(None, "tp", None)),
        (P(None, "tp", None), y_spec), axis="tp")
    st_tp = st_ref = jchz.init(CH_M, CH_TAPS)
    for i, x in enumerate(CH_X):
        st_tp, y_tp = f(st_tp, jnp.asarray(x))
        st_ref, y_ref = jchz.channelize(st_ref, jnp.asarray(x), m=CH_M,
                                        taps=CH_TAPS)
        hist = np.concatenate([o[i][0] for o in outs], axis=-2)
        np.testing.assert_array_equal(hist, np.asarray(st_tp.hist))
        np.testing.assert_array_equal(hist, np.asarray(st_ref.hist))
        if mode == "replicated":
            ys = [o[i][1] for o in outs]
        else:
            ys = [np.concatenate([o[i][1] for o in outs], axis=-2)]
        for y in ys:
            for want in (y_tp, y_ref):
                np.testing.assert_allclose(y, np.asarray(want), rtol=0,
                                           atol=1e-5)


@pytest.mark.parametrize("p", (1, 4))
def test_channel_sharded_chain_bitexact(runs, p):
    """`DdcChain` ``fold3`` on each rank's slice of 8 channels equals the
    same columns of the unsharded run, bit for bit (channels are
    independent; tests/test_parallel.py:267-335 holds the JAX kernel to
    the same bar)."""
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)
    chain = DdcChain("fold3", torch.from_numpy(CC_STEPS), ba, time_chunk=64)
    state = chain.init_state()
    outs = _ranks(runs, f"chan{p}", p)
    c_loc = len(CC_STEPS) // p
    for i in range(CC_X.shape[0]):
        state, (zi, zq) = chain(state, torch.from_numpy(CC_X[i]))
        for r in range(p):
            cols = slice(r * c_loc, (r + 1) * c_loc)
            np.testing.assert_array_equal(outs[r][i][0], zi[:, cols].numpy())
            np.testing.assert_array_equal(outs[r][i][1], zq[:, cols].numpy())


def test_meshes_and_process_info(runs):
    """In the 8-rank world: a 1-D mesh and a (dp 2, sp 4) mesh with their
    groups, `process_info`, `initialize_from_env` returning True once the
    group is up, a mesh of the wrong size refused, and a DTensor placed by
    `channel_sharding` holding this rank's `channel_slice`."""
    for r, out in enumerate(runs):
        info = out["mesh"]
        assert info["flat"] == (8, r)
        assert info["two"] == (4, r % 4, 2, r // 4)
        assert info["info"] == {"process_index": r, "process_count": 8,
                                "local_devices": 1, "global_devices": 8}
        assert info["init_again"] is True
        assert info["refused"] is True
        assert info["dtensor_equals_slice"] is True


ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "NUM_PROCESSES",
            "JAX_PROCESS_ID", "PROCESS_ID")


def test_distributed_helpers_single_process():
    """Single process: `initialize_from_env` stays inert (returns False,
    starts no group), `process_info` reports the 1-process topology, a
    partial launch description raises (tests/test_parallel.py:239-264)."""
    assert parallel.__all__ == ["halo_exchange_prev", "local_mesh",
                                "make_mesh", "sharded_df1_float",
                                "time_sharded_prev"]
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        assert distributed.initialize_from_env() is False
        assert not torch.distributed.is_initialized()
        os.environ["WORLD_SIZE"] = "2"
        with pytest.raises(ValueError, match="incomplete"):
            distributed.initialize_from_env()
    finally:
        os.environ.pop("WORLD_SIZE", None)
        os.environ.update(saved)
    assert distributed.process_info("cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}


def test_backend_choice():
    """gloo for the CPU; an unknown device raises; a CUDA launch without a
    card raises instead of going to the CPU."""
    assert distributed._backend("cpu", 8) == "gloo"
    with pytest.raises(ValueError, match="device_type"):
        distributed._backend("xpu", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            distributed._backend("cuda", 1)
    else:
        n = torch.cuda.device_count()
        assert distributed._backend("cuda", n) == "nccl"
        assert distributed._backend("cuda", n + 1) == "gloo"
