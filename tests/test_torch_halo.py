"""Port parity for the halo paths of `idsp_tpu_torch.parallel`: the
plain version of K41 `halo_exchange_prev_rdma`, `halo_exchange_prev`,
`time_sharded_prev` and `sharded_hbf_dec` (ppermute and rdma forms).

The port's functions run in 8 spawned gloo processes (one spawn for the
module, `torch_ranks.spawn`), each case on the ranks [0, P) of a
subgroup, P = 1, 4 and 8, on CPU tensors (so K41's wrapper takes its
plain version, the gloo ring).  Each is held against two references on
the same seeded numpy inputs: the JAX function under `shard_map` on P
devices of the 8-device CPU mesh of tests/conftest.py (the Pallas
`halo_exchange_prev_rdma` in interpret mode, as
tests/test_halo_rdma.py:31-43 runs it), and the unsharded result
(numpy for the halos, JAX's `hbf.hbf_dec_block` for the decimator).
Tolerances are the JAX tests': integers bit for bit; the decimator's
output within 2e-6 (tests/test_parallel.py:159-160) and its state bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.parallel import make_mesh
from idsp_tpu.parallel.halo_rdma import halo_exchange_prev_rdma as j_rdma
from idsp_tpu.parallel.stream import (
    halo_exchange_prev as j_halo,
    sharded_hbf_dec as j_hbf_dec,
    time_sharded_prev as j_time_prev,
)

import torch_ranks

SIZES = (1, 4, 8)
RNG = np.random.default_rng(0)
# K41's plain version at the JAX test's shapes (16 rows a rank, 8 lanes,
# h=3, fill -7), int32 and f32
RDMA_X = {
    "i32": RNG.integers(-(2**30), 2**30, size=(8 * 16, 8),
                        dtype=np.int64).astype(np.int32),
    "f32": RNG.normal(size=(8 * 16, 8)).astype(np.float32),
}
HALO_X = RNG.integers(-(2**30), 2**30, size=(8 * 8, 3),
                      dtype=np.int64).astype(np.int32)
PREV_X = RNG.integers(-1000, 1000, size=(8 * 4,)).astype(np.int32)
HBF_TAPS = jhbf.HBF_TAPS[2]
HBF_X = [RNG.normal(size=(3, 8 * 32)).astype(np.float32) for _ in range(2)]


def _cases():
    cases = {}
    for p in SIZES:
        n = 8 * p
        cases[f"halo{p}"] = ("halo", p, dict(x=HALO_X[:n], h=2, fill=-1))
        for k, x in RDMA_X.items():
            cases[f"rdma_{k}{p}"] = ("halo_rdma", p,
                                     dict(x=x[:16 * p], h=3, fill=-7))
        cases[f"prev{p}"] = ("time_prev", p, dict(
            x=PREV_X[:4 * p], state_prev=np.int32(-7),
            state_valid=np.bool_(False)))
        for rdma in (False, True):
            cases[f"hbf{p}_{rdma}"] = ("hbf_dec", p, dict(
                taps=HBF_TAPS, xs=[x[:, :32 * p] for x in HBF_X],
                use_rdma=rdma))
    return cases


@pytest.fixture(scope="module")
def runs():
    return torch_ranks.spawn(8, _cases())


def _ranks(runs, key, p):
    return [runs[r][key] for r in range(p)]


def _sharded(fn, p, in_specs, out_specs, *, check_vma=True):
    return jax.jit(shard_map(fn, mesh=make_mesh({"sp": p}),
                             in_specs=in_specs, out_specs=out_specs,
                             check_vma=check_vma))


def _prev_rows(x, p, h, fill):
    """The unsharded answer: block r-1's last h rows, fill for block 0."""
    blocks = np.split(x, p)
    return np.concatenate([np.full_like(b[-h:], fill) if r == 0 else
                           blocks[r - 1][-h:] for r, b in enumerate(blocks)])


def test_children_import_no_jax(runs):
    assert not any(out["jax_imported"] for out in runs)


@pytest.mark.parametrize("p", SIZES)
def test_halo_exchange_prev(runs, p):
    x = HALO_X[:8 * p]
    got = np.concatenate(_ranks(runs, f"halo{p}", p))
    want = _sharded(lambda v: j_halo(v, "sp", 2, fill=-1), p, P("sp"),
                    P("sp"))(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _prev_rows(x, p, 2, -1))


@pytest.mark.parametrize("kind", sorted(RDMA_X))
@pytest.mark.parametrize("p", SIZES)
def test_halo_exchange_prev_rdma_plain(runs, p, kind):
    """K41's plain version (the gloo ring) against the interpret-mode
    Pallas kernel and the ppermute form, bit for bit; P = 1 is the self
    ring, all fill."""
    x = RDMA_X[kind][:16 * p]
    got = np.concatenate(_ranks(runs, f"rdma_{kind}{p}", p))
    # JAX 0.9.0 interpret-mode vma limitation (tests/test_halo_rdma.py)
    want = _sharded(lambda v: j_rdma(v, "sp", 3, fill=-7, interpret=True),
                    p, P("sp"), P("sp"), check_vma=False)(jnp.asarray(x))
    pp = _sharded(lambda v: j_halo(v, "sp", 3, fill=-7), p, P("sp"),
                  P("sp"))(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(pp))
    np.testing.assert_array_equal(got, _prev_rows(x, p, 3, -7))
    if p == 1:
        assert (got == -7).all()


@pytest.mark.parametrize("p", SIZES)
def test_time_sharded_prev(runs, p):
    x = PREV_X[:4 * p]
    outs = _ranks(runs, f"prev{p}", p)
    prev = np.concatenate([o[0] for o in outs])
    valid = np.concatenate([o[1] for o in outs])
    want_prev, want_valid = _sharded(
        lambda v: j_time_prev(v, "sp", jnp.int32(-7), jnp.asarray(False)),
        p, P("sp"), (P("sp"), P("sp")))(jnp.asarray(x))
    np.testing.assert_array_equal(prev, np.asarray(want_prev))
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    np.testing.assert_array_equal(prev, np.concatenate([[-7], x[:-1]]))
    assert not valid[0] and valid[1:].all()


@pytest.mark.parametrize("rdma", [False, True], ids=["ppermute", "rdma"])
@pytest.mark.parametrize("p", SIZES)
def test_sharded_hbf_dec(runs, p, rdma):
    """Two chained blocks: outputs within 2e-6 of the JAX shard_map run
    and of the unsharded `hbf_dec_block`, the carried state bit for bit."""
    m = len(HBF_TAPS)
    outs = _ranks(runs, f"hbf{p}_{rdma}", p)
    f = _sharded(
        lambda st, v: j_hbf_dec(HBF_TAPS, st, v, "sp", use_rdma=rdma,
                                rdma_interpret=True if rdma else None),
        p, (P(), P(None, "sp")), (P(), P(None, "sp")), check_vma=not rdma)
    st_sh = st_ref = jhbf.hbf_dec_init(m, (3,))
    for i, x in enumerate(HBF_X):
        x = jnp.asarray(x[:, :32 * p])
        st_sh, y_sh = f(st_sh, x)
        st_ref, y_ref = jhbf.hbf_dec_block(HBF_TAPS, st_ref, x)
        got_y = np.concatenate([o[i][2] for o in outs], axis=-1)
        for want in (y_sh, y_ref):
            np.testing.assert_allclose(got_y, np.asarray(want), rtol=0,
                                       atol=2e-6)
        for r in range(p):  # the state is replicated on every rank
            odd, even, _ = outs[r][i]
            for want in (st_sh, st_ref):
                np.testing.assert_array_equal(odd, np.asarray(want.odd))
                np.testing.assert_array_equal(even, np.asarray(want.even))
