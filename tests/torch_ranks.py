"""Rank bodies of the parallel-layer parity tests, and the spawner.

`spawn(world, cases)` starts ``world`` processes (the ``spawn`` start
method) that join one gloo process group through a file store, make the
subgroups of ranks [0, p) for every p the cases name, run each case on
the ranks of its group and send the results back as numpy.  A case is
``key -> (body name, p, kwargs)``; the body gets its group, this rank
and the kwargs (numpy arrays of the whole input: each rank cuts its own
block).  The children import torch, numpy and `idsp_tpu_torch` only,
never jax: each reports whether jax got imported.

With ``device="cuda"`` the bodies get their tensors on the card (every
rank on card 0: the several-processes-on-one-card layout of K41).
"""

from __future__ import annotations

import os
import queue as queue_mod
import sys
import tempfile
import traceback

import numpy as np

JOIN_S = 120


def _block(x, p, r, axis=0):
    return np.ascontiguousarray(np.split(np.asarray(x), p, axis=axis)[r])


def _t(a, dev):
    import torch

    return torch.from_numpy(np.array(a)).to(dev)  # a contiguous copy


def _np(t):
    if isinstance(t, tuple):
        return tuple(_np(v) for v in t)
    return t.cpu().numpy()


# ---- rank bodies: (group, rank, p, dev, **kwargs) -> numpy ---------------


def halo(g, r, p, dev, x, h, fill):
    from idsp_tpu_torch.parallel.stream import halo_exchange_prev

    return _np(halo_exchange_prev(_t(_block(x, p, r), dev), g, h, fill=fill))


def halo_rdma(g, r, p, dev, x, h, fill):
    from idsp_tpu_torch.parallel.halo_rdma import halo_exchange_prev_rdma

    return _np(halo_exchange_prev_rdma(_t(_block(x, p, r), dev), g, h,
                                       fill=fill))


def halo_rdma_vs_plain(g, r, p, dev, xs, h, fill):
    """K41 on the card against the plain version on CPU copies of the same
    blocks, over several back-to-back puts on the same slots; returns the
    kernel's outputs and the number of launches."""
    import torch

    from idsp_tpu_torch.parallel.halo_rdma import halo_exchange_prev_rdma

    halo_exchange_prev_rdma.launches = 0
    got, want = [], []
    for x in xs:
        blk = _t(_block(x, p, r), dev)
        got.append(halo_exchange_prev_rdma(blk, g, h, fill=fill))
        want.append(halo_exchange_prev_rdma(blk.cpu(), g, h, fill=fill))
    torch.cuda.synchronize()
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    return same, halo_exchange_prev_rdma.launches, _np(tuple(got))


def time_prev(g, r, p, dev, x, state_prev, state_valid):
    from idsp_tpu_torch.parallel.stream import time_sharded_prev

    return _np(time_sharded_prev(_t(_block(x, p, r), dev), g,
                                 _t(state_prev, dev), _t(state_valid, dev)))


def df1_float(g, r, p, dev, ba, sx, sy, xs):
    from idsp_tpu_torch.filters.biquad import Df1State
    from idsp_tpu_torch.parallel.stream import sharded_df1_float

    st, ys = sharded_df1_float(_t(ba, dev), Df1State(_t(sx, dev), _t(sy, dev)),
                               _t(_block(xs, p, r), dev), g)
    return _np((st.x, st.y, ys))


def relay(g, r, p, dev, ba, sx, sy, xs, f):
    from idsp_tpu_torch.filters.biquad import Df1State
    from idsp_tpu_torch.parallel.stream import sharded_df1_q_relay

    st, ys = sharded_df1_q_relay(ba, Df1State(_t(sx, dev), _t(sy, dev)),
                                 _t(_block(xs, p, r), dev), f, g)
    return _np((st.x, st.y, ys))


def hbf_dec(g, r, p, dev, taps, xs, use_rdma):
    """Chained blocks from the zero state; (state, y) after each."""
    from idsp_tpu_torch.filters import hbf
    from idsp_tpu_torch.parallel.stream import sharded_hbf_dec

    st = hbf.hbf_dec_init(len(taps), (xs[0].shape[0],), device=dev)
    outs = []
    for x in xs:
        st, y = sharded_hbf_dec(taps, st, _t(_block(x, p, r, axis=-1), dev),
                                g, use_rdma=use_rdma)
        outs.append(_np((st.odd, st.even, y)))
    return outs


def pipeline(g, r, p, dev, bas, x, f, shard_io):
    from idsp_tpu_torch.parallel.pipeline import run_pipelined_sos

    return _np(run_pipelined_sos(g, bas, _t(x, dev), f, shard_io=shard_io))


def chan_tp(g, r, p, dev, xs, m, taps, out_mode):
    """Chained blocks of `channelize_tp` on this rank's branch slice."""
    from idsp_tpu_torch.pipelines import channelizer

    m_loc = m // p
    st = channelizer.BankState(hist=_t(np.zeros((taps - 1, m_loc, 2),
                                                np.float32), dev))
    outs = []
    for x in xs:
        st, y = channelizer.channelize_tp(
            st, _t(_block(x, p, r, axis=-2), dev), g, m=m, taps=taps,
            out_mode=out_mode)
        outs.append(_np((st.hist, y)))
    return outs


def mesh_info(g, r, p, dev):
    """Meshes over the whole world (1-D and 2-D), `process_info` and a
    channel-sharded DTensor against `channel_slice`."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from idsp_tpu_torch.parallel import distributed, local_mesh, make_mesh
    from idsp_tpu_torch.parallel.stream import (
        channel_sharding, channel_slice,
    )

    flat = distributed.global_mesh({"sp": p}, device_type="cpu")
    two = local_mesh(("dp", 2), ("sp", p // 2), device_type="cpu")
    sp, dp = two.get_group("sp"), two.get_group("dp")
    x = torch.arange(p * 3 * 5, dtype=torch.int32).reshape(p * 3, 5)
    local = distribute_tensor(x, flat, channel_sharding(flat, "sp")).to_local()
    try:
        make_mesh({"sp": p + 1}, device_type="cpu")
        refused = False
    except ValueError:
        refused = True
    import torch.distributed as dist

    return {"flat": (flat.get_group("sp").size(), flat.get_local_rank("sp")),
            "two": (dist.get_world_size(sp), dist.get_rank(sp),
                    dist.get_world_size(dp), dist.get_rank(dp)),
            "info": distributed.process_info("cpu"),
            "init_again": distributed.initialize_from_env(),
            "dtensor_equals_slice": bool(torch.equal(
                local, channel_slice(x, flat.get_group("sp")))),
            "refused": refused}


def chain_channels(g, r, p, dev, steps, x, blocks):
    """`DdcChain` ``fold3`` on this rank's slice of the channels."""
    from idsp_tpu_torch.chain import DdcChain
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.parallel.stream import channel_slice

    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)
    chain = DdcChain("fold3", channel_slice(_t(steps, dev), g), ba,
                     time_chunk=64)
    state = chain.init_state()
    outs = []
    for i in range(blocks):
        state, (zi, zq) = chain(state, _t(x[i], dev))
        outs.append(_np((zi, zq)))
    return outs


BODIES = {f.__name__: f for f in (
    halo, halo_rdma, halo_rdma_vs_plain, time_prev, df1_float, relay,
    hbf_dec, pipeline, chan_tp, mesh_info, chain_channels)}


def _child(rank, world, store, cases, device, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        groups = {}
        for p in sorted({p for _, p, _ in cases.values()}):
            groups[p] = None if p == world else dist.new_group(list(range(p)))
        out = {}
        for key, (body, p, kw) in cases.items():
            if rank < p:
                out[key] = BODIES[body](groups[p], rank, p, device, **kw)
        if device == "cuda":
            from idsp_tpu_torch.parallel import halo_rdma

            for p, g in groups.items():
                if rank < p:
                    halo_rdma.close(g)
        out["jax_imported"] = any(
            m in ("jax", "idsp_tpu") or m.startswith(("jax.", "idsp_tpu."))
            for m in sys.modules)
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def spawn(world, cases, *, device="cpu", timeout_s=JOIN_S):
    """Run ``cases`` on ``world`` spawned ranks; returns a list, per rank,
    of {key: result} (ranks outside a case's group have no key)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child,
                             args=(r, world, store, cases, device, results))
                 for r in range(world)]
        for q in procs:
            q.start()
        got = {}
        try:
            for _ in range(world):
                rank, out = results.get(timeout=timeout_s)
                if isinstance(out, str):
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        except queue_mod.Empty:
            raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))}"
                               f" sent nothing in {timeout_s} s") from None
        finally:
            for q in procs:
                q.join(timeout=30)
                if q.is_alive():
                    q.kill()
                    q.join()
        for q in procs:
            if q.exitcode != 0:
                raise RuntimeError(f"a rank exited with {q.exitcode}")
    return [got[r] for r in range(world)]
