"""The host plan of the depth-0 pipeline of a serial recurrence that K12
and K13 (`ddc_bank_cuda`), K14 (`ddc_cuda`), K15 (`fm_cuda`), K16
(`ddc_lockin_cuda`), K1, K11, K18, K26, K27, K29, K31 and K33
(`biquad_cuda`), K34 (`svf_cuda`) and K37 (`rpll_cuda`) run:
``csrc/df1_ring.cuh`` `run_pipe` (K1, K11, K18, K26, K27, K12/K13:
`run_roles`).

A CUDA block is a tile of LANES lanes: the serial warp (warp 0; the DF1
warp of K12-K15), the other warps of its scheduler idle, ``producers``
warps that fill its input ring and one store warp that writes its output
ring to device memory (K12/K13: a back-end warp that writes the kept
rows, and for K13 steps the PLL; K1, K11, K18, K26, K27: a store warp
that keeps K11's rows and converts K1's f32).  A row of a slot holds
``win`` (input) or ``wout`` (output) 32-bit words a lane.  `pipe_plan`
picks the warps, chunk and ring depth and sums the shared memory;
``df1_ring.cuh`` `pipe_plan_ok` refuses a plan that is not its own.
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
    """How K1, K11-K16, K18, K26, K27, K29, K31/K33, K34 and K37 run a
    launch: a CUDA block is a tile of LANES lanes and ``warps`` warps: warp
    0 the serial warp, the others of its scheduler (warp % 4 == 0) idle,
    of the rest ``producers`` that fill its input ring (K12/K13, K14: the
    mix of their rows mod their count; K15: dphi of a span of each chunk;
    K16: the mix and the feed-forward sum of a span; K1, K11, K18, K26,
    K27, K29, K31/K33: the feed-forward sums of a span; K34: the x rows of
    a span; K37: the x and dt words of a span) and the next one the store
    warp (K12/K13: the back end), the rest idle; with ``cluster`` 2 (K15)
    a tile is a cluster of that block and a partner CTA whose ``warps``
    warps are all producers; chunks of ``chunk`` rows, rings of ``ring``
    slots of ``win`` (input) and ``wout`` (output) 32-bit words a row and
    lane, ``smem`` bytes a CTA."""

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
    if producers < 1:
        raise ValueError(f"need producers >= 1, got {producers}")
    if warps is None:
        warps = 4 * -(-(producers + 1) // 3)
    if warps % 4 or not 4 <= warps <= MAX_WARPS or \
            producers + 1 > warps - warps // 4:
        raise ValueError(f"warps must be a multiple of 4 up to {MAX_WARPS} "
                         f"holding {producers} producers and the store warp "
                         f"off the serial warp's scheduler, got {warps}")
    if chunk is None:
        chunk = PIPE_CHUNK
        while chunk > 1 and pipe_smem(chunk, 2, win, wout) > MAX_PIPE_SMEM:
            chunk //= 2
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1 row, got {chunk}")
    if ring is None:
        fits = [r for r in range(PIPE_RING, 1, -1)
                if pipe_smem(chunk, r, win, wout) <= MAX_PIPE_SMEM]
        if not fits:
            raise ValueError(f"no ring of 2+ slots of {chunk} rows fits "
                             f"{MAX_PIPE_SMEM} bytes")
        ring = fits[0]
    if ring < 2:
        raise ValueError(f"ring must have 2+ slots, got {ring}")
    smem = pipe_smem(chunk, ring, win, wout)
    if smem > MAX_PIPE_SMEM:
        raise ValueError(f"{smem} bytes of shared memory, more than "
                         f"{MAX_PIPE_SMEM}")
    return PipePlan(warps=warps, producers=producers, chunk=chunk, ring=ring,
                    smem=smem, tiles=-(-lanes // LANES), cluster=cluster,
                    win=win, wout=wout)
