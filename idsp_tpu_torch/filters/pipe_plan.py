"""The host plan of the depth-0 pipeline of a serial recurrence that K6,
K12 and K13 (`ddc_bank_cuda`), K14 (`ddc_cuda`), K15 (`fm_cuda`), K16
(`ddc_lockin_cuda`), K1, K11, K18 and K25-K33 (`biquad_cuda`), K34
(`svf_cuda`), K35 and K36 (`normal_cuda`), K37 (`rpll_cuda`), K4
(`lowpass_cuda`) and K5 (`pll_cuda`) run: ``csrc/df1_ring.cuh``
`run_pipe` (K1, K4, K11, K18, K26, K27, K6/K12/K13: `run_roles`); and
K24's chain of such blocks, one or two a CTA, over a thread-block cluster
(`sos_plan`, ``df1_ring.cuh`` `run_chain`).

A CUDA block is a tile of LANES lanes: the serial warp (warp 0; the DF1 warp of
K12-K15, the Lowpass serial warp of K4 and K6, the PLL serial warp of K5), the
other warps of its scheduler idle, ``producers`` warps that fill its input ring
and one store warp that writes its output ring to device memory (K6, K12/K13: a
back-end warp that writes the kept rows, and for K6 and K13 steps the PLL, K6
writing its output; K1, K4, K11, K18, K26, K27: a store warp that keeps K4's and
K11's rows and converts K1's f32).  A row of a slot holds ``win`` (input) or
``wout`` (output) 32-bit words a lane.  `pipe_plan` picks the warps, chunk and
ring depth and sums the shared memory; ``df1_ring.cuh`` `pipe_plan_ok` refuses
a plan that is not its own.
"""

from __future__ import annotations

from typing import NamedTuple

LANES = 32  # lanes of a tile (df1_ring.cuh kLanes)
MAX_WARPS = 16  # warps of a block (kMaxWarps)
# the dynamic shared memory a block may have: an SM's 227 KB less 1 KB for
# the kernels' static lookup tables (kMaxPipeSmem)
MAX_PIPE_SMEM = 232448 - 1024
PIPE_CHUNK, PIPE_RING = 256, 3  # rows a chunk, slots a ring (the most)


def pipe_smem(chunk: int, ring: int, win: int = 1, wout: int = 1) -> int:
    """Shared memory of a launch (df1_ring.cuh `pipe_smem`): 32 bytes of
    mbarriers a slot, the input and the output ring (``ring`` slots of
    ``chunk`` rows x LANES x ``win`` and x ``wout`` 32-bit words)."""
    return 32 * ring + ring * chunk * LANES * 4 * (win + wout)


class PipePlan(NamedTuple):
    """How K1, K4, K5, K11-K16, K18, K26-K31, K33 and K34-K37 run a
    launch: a CUDA block is a tile of LANES lanes and ``warps`` warps: warp
    0 the serial warp, the others of its scheduler (warp % 4 == 0) idle,
    of the rest ``producers`` that fill its input ring (K12/K13, K14: the
    mix of their rows mod their count; K15: dphi of a span of each chunk;
    K16: the mix and the feed-forward sum of a span; K1, K11, K18,
    K26-K31, K33, K35, K36: the feed-forward sums of a span; K4, K5,
    K34: the x rows of a span; K37: the x and dt words of a span) and the
    next one
    the store warp (K12/K13: the back end), the rest idle; with
    ``cluster`` 2 (K15) a tile is a cluster of that block and a partner CTA
    whose ``warps`` warps are all producers; chunks of ``chunk`` rows,
    rings of ``ring`` slots of ``win`` (input) and ``wout`` (output) 32-bit
    words a row and lane, ``smem`` bytes a CTA."""

    warps: int
    producers: int
    chunk: int
    ring: int
    smem: int
    tiles: int  # tiles of LANES over the launch's lanes
    cluster: int = 1  # CTAs a tile
    win: int = 1  # 32-bit words a row and lane of an input slot
    wout: int = 1  # ... of an output slot

    @property
    def all_producers(self) -> int:
        """The producer warps of a tile, the partner CTA's too."""
        return self.producers + (self.warps if self.cluster > 1 else 0)


def _warps(producers: int, warps: int | None, most: int) -> int:
    """The warps of a block (at most ``most``): unless given, the fewest (a
    multiple of 4) that hold the serial warp, ``producers`` and the store
    warp beside the serial warp's scheduler."""
    if producers < 1:
        raise ValueError(f"need producers >= 1, got {producers}")
    if warps is None:
        warps = 4 * -(-(producers + 1) // 3)
    if warps % 4 or not 4 <= warps <= most or \
            producers + 1 > warps - warps // 4:
        raise ValueError(f"warps must be a multiple of 4 up to {most} "
                         f"holding {producers} producers and the store warp "
                         f"off the serial warp's scheduler, got {warps}")
    return warps


def _chunk_ring(chunk: int | None, ring: int | None,
                smem_of) -> tuple[int, int, int]:
    """(chunk, ring, smem) of a block whose shared memory is
    ``smem_of(chunk, ring)``: unless given, the largest of PIPE_CHUNK,
    PIPE_CHUNK / 2, ... rows a chunk of which 2 slots fit MAX_PIPE_SMEM,
    and the most of PIPE_RING .. 2 slots that fit."""
    if chunk is None:
        chunk = PIPE_CHUNK
        while chunk > 1 and smem_of(chunk, 2) > MAX_PIPE_SMEM:
            chunk //= 2
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1 row, got {chunk}")
    if ring is None:
        fits = [r for r in range(PIPE_RING, 1, -1)
                if smem_of(chunk, r) <= MAX_PIPE_SMEM]
        if not fits:
            raise ValueError(f"no ring of 2+ slots of {chunk} rows fits "
                             f"{MAX_PIPE_SMEM} bytes")
        ring = fits[0]
    if ring < 2:
        raise ValueError(f"ring must have 2+ slots, got {ring}")
    smem = smem_of(chunk, ring)
    if smem > MAX_PIPE_SMEM:
        raise ValueError(f"{smem} bytes of shared memory, more than "
                         f"{MAX_PIPE_SMEM}")
    return chunk, ring, smem


def pipe_plan(lanes: int, *, producers: int, warps: int | None = None,
              chunk: int | None = None, ring: int | None = None,
              cluster: int = 1, win: int = 1, wout: int = 1) -> PipePlan:
    """The plan of a launch over ``lanes`` lanes with ``win`` / ``wout``
    words a row and lane in the input / output slots: the fewest warps (a
    multiple of 4) that hold the serial warp, ``producers`` and the store
    warp beside the serial warp's scheduler; unless given, the largest of
    PIPE_CHUNK, PIPE_CHUNK / 2, ... rows a chunk of which 2 slots fit
    MAX_PIPE_SMEM, and the most of PIPE_RING .. 2 slots that fit; one CTA a
    tile, or ``cluster`` 2 (K15 only).  Raises ValueError for a plan the
    kernel cannot run."""
    if lanes < 1:
        raise ValueError(f"need lanes >= 1, got {lanes}")
    if cluster not in (1, 2):
        raise ValueError(f"cluster must be 1 or 2 CTAs, got {cluster}")
    warps = _warps(producers, warps, MAX_WARPS)
    chunk, ring, smem = _chunk_ring(
        chunk, ring, lambda ch, r: pipe_smem(ch, r, win, wout))
    return PipePlan(warps=warps, producers=producers, chunk=chunk, ring=ring,
                    smem=smem, tiles=-(-lanes // LANES), cluster=cluster,
                    win=win, wout=wout)


# ---- K24: a chain of depth-0 blocks over a cluster --------------------------

SOS_MAX_STAGES = 8  # stages of one K24 launch (csrc/biquad_bank.cu)
# warps of a K24 CTA at most, with one rank (a thread may hold 168
# registers) and with two (df1_ring.cuh kChainWarps, kChainWarps2)
CHAIN_WARPS, CHAIN_WARPS2 = 12, 20
MAX_CLUSTER = 8  # CTAs of a K24 tile at most: the portable cluster size
# producer warps of a rank by default, with one and with two ranks a CTA
# (4 of 64-row chunks: a span of one 16-row batch)
SOS_PRODUCERS, SOS_PRODUCERS2 = 8, 4


def chain_smem(chunk: int, ring: int, cluster: int, halves: int = 1) -> int:
    """Shared memory of a K24 CTA (df1_ring.cuh `chain_smem`): ``halves``
    ranks of `pipe_smem` with two words a row and lane in and one out and,
    in a cluster of 2+ CTAs or a CTA of two ranks, the x ring: 16 bytes of
    mbarriers a slot and ``ring`` slots of ``chunk`` + 2 rows x LANES int32
    words."""
    x = ring * (16 + (chunk + 2) * LANES * 4) if cluster > 1 or halves > 1 \
        else 0
    return halves * (pipe_smem(chunk, ring, 2, 1) + x)


class SosPlan(NamedTuple):
    """How K24 runs a launch of ``stages`` stages: a tile of LANES lanes is
    a chain of ceil(stages / ``group``) ranks, rank j running stages [j
    group, (j + 1) group), over a cluster of ``cluster`` CTAs of
    ``halves`` ranks each; each rank a depth-0 block (its serial warp, warp
    0 or, for a CTA's second rank, warp 2, alone on its scheduler;
    ``producers`` producer warps and a store warp on the other schedulers)
    in a CTA of ``warps`` warps; chunks of ``chunk`` rows, rings of
    ``ring`` slots (two 32-bit words a row and lane in, one out; ranks past
    0 an x ring of ``chunk`` + 2 rows), ``smem`` bytes a CTA."""

    warps: int
    producers: int
    chunk: int
    ring: int
    smem: int
    tiles: int  # tiles of LANES over the launch's lanes
    cluster: int  # CTAs a tile
    group: int  # stages a rank (the last rank's may be fewer)
    stages: int
    halves: int = 1  # ranks a CTA: 1, or 2 of one stage each


def _chain_warps(producers: int | None, warps: int | None,
                 halves: int) -> tuple[int, int]:
    """(producers, warps) of a K24 CTA: one rank's roles beside its serial
    warp's scheduler (`_warps`), or two ranks' roles, ``producers`` and a
    store warp each, on the warps of schedulers 1 and 3 (half of a
    multiple of 4)."""
    if halves == 1:
        producers = SOS_PRODUCERS if producers is None else producers
        return producers, _warps(producers, warps, CHAIN_WARPS)
    producers = SOS_PRODUCERS2 if producers is None else producers
    if producers < 1:
        raise ValueError(f"need producers >= 1, got {producers}")
    if warps is None:
        warps = 4 * (producers + 1)
    if warps % 4 or not 4 <= warps <= CHAIN_WARPS2 or \
            2 * (producers + 1) > warps // 2:
        raise ValueError(f"warps must be a multiple of 4 up to {CHAIN_WARPS2} "
                         f"holding two ranks' {producers} producers and "
                         f"store warp on schedulers 1 and 3, got {warps}")
    return producers, warps


def sos_plan(c: int, n: int, *, sms: int | None = None,
             group: int | None = None, halves: int | None = None,
             producers: int | None = None, warps: int | None = None,
             chunk: int | None = None, ring: int | None = None,
             co_resident=None) -> SosPlan:
    """K24's plan over ``c`` lanes and ``n`` stages (1 <= n <=
    SOS_MAX_STAGES, so at most MAX_CLUSTER CTAs a tile).  Unless ``group``
    is given, the first of these whose ceil(c / LANES) tiles x CTAs fit
    ``sms`` CTAs, one CTA an SM, and, where ``co_resident`` (a plan -> the
    clusters the card holds at once) is given, whose tiles' clusters the
    card holds at once: one stage a rank and a CTA (clusters of n), one
    stage a rank and two ranks a CTA (clusters of ceil(n / 2)), then g = 2,
    3, ... stages a rank and a CTA; g = n (one CTA a tile) where none does.
    ``halves`` (1, or 2 with g = 1) goes with a given ``group``.  The roles:
    `_chain_warps` (SOS_PRODUCERS or SOS_PRODUCERS2 producers a rank by
    default); unless given, the largest of PIPE_CHUNK, PIPE_CHUNK / 2, ...
    rows a chunk of which 2 slots fit MAX_PIPE_SMEM, and the most of
    PIPE_RING .. 2 slots that fit.  Raises ValueError for a plan the kernel
    cannot run."""
    if c < 1:
        raise ValueError(f"need lanes >= 1, got {c}")
    if not 1 <= n <= SOS_MAX_STAGES:
        raise ValueError(f"a launch runs 1 to {SOS_MAX_STAGES} stages, "
                         f"got {n}")
    tiles = -(-c // LANES)

    def make(g: int, h: int) -> SosPlan:
        if h not in (1, 2) or (h == 2 and g != 1):
            raise ValueError(f"halves must be 1, or 2 with one stage a rank; "
                             f"got {h} with {g}")
        cl = -(-(-(-n // g)) // h)  # at most SOS_MAX_STAGES = MAX_CLUSTER
        pr, wa = _chain_warps(producers, warps, h)
        ch, r, smem = _chunk_ring(chunk, ring,
                                  lambda ch, r: chain_smem(ch, r, cl, h))
        return SosPlan(warps=wa, producers=pr, chunk=ch, ring=r, smem=smem,
                       tiles=tiles, cluster=cl, group=g, stages=n, halves=h)

    if group is not None:
        if not 1 <= group <= n:
            raise ValueError(f"group must be 1 to {n} stages, got {group}")
        return make(group, 1 if halves is None else halves)
    if sms is None or sms < 1:
        raise ValueError(f"need the card's SMs (sms >= 1), got {sms}")
    shapes = [(1, 1), (1, 2)] + [(g, 1) for g in range(2, n)]
    for g, h in shapes:
        if g >= n or tiles * -(-(-(-n // g)) // h) > sms:
            continue
        plan = make(g, h)
        if co_resident is None or co_resident(plan) >= tiles:
            return plan
    return make(n, 1)
