"""V1's, V3's and V4's thread tiles on one GPU: the redesigned V4
(nocomp) and V1 (stacked) of crossprod_variants_v2.cu and V3 (split3) of
crossprod_split3_v2.cu, their first designs and the same sources built
at other tiles, timed in turns on the same inputs at the kernel sweep's
shape.

    python -m flashpca_tpu_torch.tools.variant_tiles [--out FILE]

A V4 tile is (R rows, C columns a thread, TPS threads an SM that
``__launch_bounds__`` asks for, SREG: the running sum in registers (1)
or in shared memory (0)); a V1 tile is (TM rows a block, R, C, TPS,
WBUF: one or two decoded tiles, U of the four planes unrolled); a V3
tile is (MT 16-row M tiles a warp, NW warps a block, SB packed bytes a
stage, TPS).  Each one tried is one more ``nvcc`` (all started together,
through ``b3_tiles.run_tiles``) of a two-line source that defines
``CROSSPROD_NOCOMP_TILE_<KC>``, ``CROSSPROD_STACKED_TILE_<KC>`` or
``CROSSPROD_SPLIT3_TILE_<KC>`` and includes the variant's source, with
its registers and spills (``-Xptxas -v``).  Every tile must give the first
design's sums bit for bit (``torch.equal``).  The shape is the sweep's,
the wide headline's 100,352 SNPs x 125,440 bytes at kc 16, with random
bytes and statistics (the kernels' time does not depend on the values);
times are medians of CUDA-event times after a warm-up, each tile timed
once in order and once in reverse.  A tile that does not build is
reported and skipped.  The tool needs a GPU and exits 1 without one, or
when a tile is not bit-equal.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import crossprod_variants as cv
from ..kernels import packed_matvec as tpk
from . import b3_tiles

SOURCE = "crossprod_variants_v2.cu"
SPLIT3_SOURCE = "crossprod_split3_v2.cu"
NOCOMP = ("crossprod_nocomp", "CROSSPROD_NOCOMP_TILE", "nocomp_tile_kernel")
STACKED = ("crossprod_stacked", "CROSSPROD_STACKED_TILE",
           "stacked_tile_kernel")
# V3's aligned-bytes instantiation, the one the sweep's shape launches
SPLIT3 = ("crossprod_split3", "CROSSPROD_SPLIT3_TILE",
          "split_tile_kernel<{kc}, 1>")
# the tiles tried beside production's, by KC: V4 (R, C, TPS, SREG), V1
# (TM, R, C, TPS, WBUF, U)
NOCOMP_TILES = {16: [(2, 8, 768, 1), (2, 8, 1024, 0), (2, 4, 768, 0),
                     (2, 4, 1024, 0), (1, 8, 768, 0), (4, 8, 384, 0),
                     (2, 16, 384, 0)]}
STACKED_TILES = {16: [(128, 2, 8, 384, 1, 4), (128, 4, 4, 384, 1, 4),
                      (128, 4, 4, 384, 1, 2), (128, 4, 4, 256, 2, 4),
                      (64, 1, 4, 1024, 1, 4), (64, 1, 8, 640, 1, 4),
                      (64, 2, 4, 640, 1, 4), (64, 2, 8, 320, 1, 4),
                      (64, 2, 4, 384, 2, 4)]}
# V3 (MT, NW, SB, TPS)
SPLIT3_TILES = {16: [(1, 4, 64, 512), (1, 8, 64, 512), (2, 4, 32, 512),
                     (2, 8, 32, 512), (2, 8, 64, 512), (2, 8, 128, 256),
                     (4, 4, 64, 256), (4, 2, 64, 256)]}
# (label, SNPs, packed bytes, kc): the sweep's launch
SHAPES = (("wide", 100_352, 125_440, 16),)
B1_TM, CB, HB = 128, 32, 16
BSTRIDE, WSTRIDE = CB + 16, 4 * HB + 4


def _stage_bytes(tm, kc):
    """One ``cp.async`` stage: a 32-byte chunk of ``tm`` rows (48 bytes
    apart) and its x rows of the four planes."""
    return tm * BSTRIDE + 4 * CB * kc * 4


def nocomp_occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of V4's
    ``tile`` at ``kc`` with ``regs`` registers a thread: two stages of
    B1's 128 rows and, at SREG = 0, the running sums."""
    r, c, _, sreg = tile
    nt = B1_TM // r * (kc // c)
    smem = 2 * _stage_bytes(B1_TM, kc) + (0 if sreg else r * c * nt * 4)
    return nt, smem, b3_tiles.blocks_an_sm(nt, smem, regs)


def stacked_occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of V1's
    ``tile``: two stages, WBUF decoded tiles of TM x 68 floats, the rows'
    four values and the running sums."""
    tm, r, c, _, wbuf, _ = tile
    nt = tm // r * (kc // c)
    smem = (2 * _stage_bytes(tm, kc) + wbuf * tm * WSTRIDE * 4 + tm * 16
            + r * c * nt * 4)
    return nt, smem, b3_tiles.blocks_an_sm(nt, smem, regs)


def split3_occupancy(kc, tile, regs):
    """(threads a block, dynamic shared bytes, blocks an SM) of V3's
    ``tile``: two stages, each SB bytes of 16 MT NW rows (SB + 16 bytes
    apart) and the pre-split panel of its SB / 32 fold units (8 kc rows
    of 80 bytes each)."""
    mt, nw, sb, _ = tile
    nt = 32 * nw
    smem = 2 * (16 * mt * nw * (sb + 16) + sb // CB * 8 * kc * 80)
    return nt, smem, b3_tiles.blocks_an_sm(nt, smem, regs)


def split3_grid(tile, p, nb):
    """Blocks of a V3 launch over ``p`` SNPs: one per 16 MT NW rows."""
    return -(-p // (16 * tile[0] * tile[1]))


def nocomp_grid(tile, p, nb):
    """Blocks of a V4 launch over ``p`` SNPs: one per 128 rows."""
    return -(-p // B1_TM)


def stacked_grid(tile, p, nb):
    """Blocks of a V1 launch over ``p`` SNPs: one per TM rows."""
    return -(-p // tile[0])


def data(device, p, nb):
    """Packed bytes, mean and inverse sd (random: the kernels' time does
    not depend on the values)."""
    g = torch.Generator(device=device).manual_seed(5)
    packed = torch.randint(0, 256, (p, nb), generator=g, dtype=torch.uint8,
                           device=device)
    mean = 0.1 + 1.8 * torch.rand(p, generator=g, device=device)
    invsd = 0.5 + 1.5 * torch.rand(p, generator=g, device=device)
    return packed, mean, invsd


def panel(device, p, nb, kc):
    """The permuted panel x (4 nb, kc)."""
    g = torch.Generator(device=device).manual_seed(6 + kc)
    return (torch.randn((4 * nb, kc), generator=g, device=device),)


def launcher(fn, packed, mean, invsd, x, kc):
    """A thunk launching ``fn`` (a ctypes V1 or V4 entry) at ``kc``;
    returns z."""
    p, nb = packed.shape
    coeffs = tpk.coeff_rows(mean, invsd)

    def run():
        z = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
        rc = fn(packed.data_ptr(), *(c.data_ptr() for c in coeffs),
                x.data_ptr(), z.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant tile launch failed: {rc}")
        return z
    return run


def split3_launcher(fn, packed, mean, invsd, x, kc):
    """A thunk launching ``fn`` (a ctypes V3 entry) at ``kc``, with its
    scratch panel; returns z."""
    p, nb = packed.shape
    coeffs = tpk.coeff_rows(mean, invsd)
    xs = cv.split3_scratch(nb, kc, packed.device)

    def run():
        z = torch.empty((p, kc), dtype=torch.float32, device=packed.device)
        rc = fn(packed.data_ptr(), *(c.data_ptr() for c in coeffs),
                x.data_ptr(), xs.data_ptr(), z.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"split3 tile launch failed: {rc}")
        return z
    return run


def trials():
    """The three runs of ``b3_tiles.run_tiles``: V4's tiles, then V1's,
    then V3's."""
    common = {"shapes": SHAPES, "data": data, "panel": panel, "module": cv}
    return [dict(common, name=name, macro=macro, kernel=kernel, tiles=tiles,
                 occupancy=occupancy, grid=grid, launcher=run)
            for (name, macro, kernel), tiles, occupancy, grid, run in (
                (NOCOMP, NOCOMP_TILES, nocomp_occupancy, nocomp_grid,
                 launcher),
                (STACKED, STACKED_TILES, stacked_occupancy, stacked_grid,
                 launcher),
                (SPLIT3, SPLIT3_TILES, split3_occupancy, split3_grid,
                 split3_launcher))]


def main(argv=None) -> int:
    return b3_tiles.tool_main(argv, __doc__, "variant_tiles", runs=trials())


if __name__ == "__main__":
    sys.exit(main())
