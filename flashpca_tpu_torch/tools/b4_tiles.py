"""B4's thread tiles on one GPU: production B4 (matvec_ff_v2.cu), its
first design and the same source built at other tiles, timed in turns
on the same inputs at the main paths' shapes.

    python -m flashpca_tpu_torch.tools.b4_tiles [--out FILE]

A tile is (C columns a thread, TB bytes a block, TPS threads an SM that
``__launch_bounds__`` asks for, EREG: err in registers (1) or in shared
memory beside the running sum (0), U rows unrolled) at one KC; each one
tried is one more ``nvcc`` (all started together, through
``b3_tiles.run_tiles``) of a two-line source that defines
``MATVEC_FF_TILE_<KC>`` as ``C, TB, TPS, EREG, U`` and includes
matvec_ff_v2.cu, with its registers and spills
(``-Xptxas -v``).  Every tile must give the first design's (y_hi, y_err)
bit for bit (``torch.equal`` of both halves).  The shapes are the wide
headline's (100,352 SNPs x 125,440 bytes) at kc 24, the polish's and
check()'s width, and at kc 16 and 32, the widths other k split into;
and the tall headline's bytes (50,176 x 250,880) at kc 24, where the
wide operator's check() of a tall result runs B4.  Random bytes and
tables (the kernels' time does not depend on the values); times are
medians of CUDA-event times after a warm-up, each tile timed once in
order and once in reverse.  A tile that does not build is reported and
skipped.  The tool needs a GPU and exits 1 without one, or when a tile
is not bit-equal.
"""

from __future__ import annotations

import functools
import sys

import torch

from . import b3_tiles

NAME, KERNEL = "matvec_ff", "matvec_ff_tile_kernel"
SOURCE, MACRO = "matvec_ff_v2.cu", "MATVEC_FF_TILE"
# the tiles tried beside production's, by KC: (C, TB, TPS, EREG, U)
TILES = {
    16: [(8, 64, 384, 1, 16), (8, 64, 384, 1, 4), (8, 128, 384, 1, 16),
         (8, 128, 384, 1, 8)],
    24: [(8, 64, 384, 1, 16), (8, 64, 384, 1, 4), (8, 64, 384, 1, 2),
         (8, 128, 384, 1, 16), (8, 128, 384, 1, 8), (8, 64, 384, 0, 8),
         (8, 64, 576, 1, 8), (4, 64, 768, 0, 16), (4, 64, 768, 1, 16),
         (12, 64, 256, 0, 8)],
    32: [(8, 64, 512, 0, 8), (8, 64, 512, 0, 4), (8, 64, 512, 1, 8),
         (8, 64, 256, 1, 16)],
}
# (label, SNPs, packed bytes, kc): the main paths' B4 launches
SHAPES = (("wide", 100_352, 125_440, 24), ("wide", 100_352, 125_440, 16),
          ("wide", 100_352, 125_440, 32), ("tall", 50_176, 250_880, 24))
CR, LW = 64, 8


def stage_bytes(kc, tile):
    """One ``cp.async`` stage of B4: a 64-row chunk's TB bytes, its v_h
    and v_l rows and its (hi, lo) table rows of LW floats."""
    return CR * tile[1] + 2 * CR * kc * 4 + CR * LW * 4


def panel(device, p, nb, kc):
    """B4's v_h and v_l (p, kc)."""
    g = torch.Generator(device=device).manual_seed(6 + kc)
    vh = torch.randn((p, kc), generator=g, device=device)
    return vh, torch.randn((p, kc), generator=g, device=device) * 1e-7


def launcher(fn, packed, lut6, vh, vl, kc):
    """A thunk launching ``fn`` (a ctypes B4 entry) at ``kc``; returns
    (yh, yl)."""
    p, nb = packed.shape

    def run():
        yh = torch.empty((4 * nb, kc), dtype=torch.float32,
                         device=packed.device)
        yl = torch.empty_like(yh)
        rc = fn(packed.data_ptr(), lut6.data_ptr(), vh.data_ptr(),
                vl.data_ptr(), yh.data_ptr(), yl.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"matvec_ff tile launch failed: {rc}")
        return yh, yl
    return run


def main(argv=None) -> int:
    return b3_tiles.tool_main(argv, __doc__, "b4_tiles", name=NAME,
                              macro=MACRO, kernel=KERNEL, tiles=TILES,
                              shapes=SHAPES, data=b3_tiles.table_data,
                              panel=panel, launcher=launcher,
                              occupancy=functools.partial(
                                  b3_tiles.wt_occupancy,
                                  stage_bytes=stage_bytes),
                              grid=b3_tiles.wt_grid)


if __name__ == "__main__":
    sys.exit(main())
