"""B2's thread tiles on one GPU: production B2 (matvec_v2.cu), its first
design and the same source built at other tiles, timed in turns on the
same inputs at the main paths' shapes.

    python -m flashpca_tpu_torch.tools.b2_tiles [--out FILE]

A tile is (C columns a thread, TB bytes a block, TPS threads an SM that
``__launch_bounds__`` asks for, EREG: err in registers (1) or in shared
memory beside the running sum (0)) at one KC; each one tried is one
more ``nvcc`` (all started together, through ``b3_tiles.run_tiles``)
of a two-line source that defines ``MATVEC_TILE_<KC>`` as ``C, TB, TPS,
EREG`` and includes matvec_v2.cu, with its registers and spills
(``-Xptxas -v``).  Every tile must give the first design's sums bit for
bit (``torch.equal``).  The shapes are the wide headline's (100,352 SNPs
x 125,440 bytes) at kc 16 and 24 and the tall one's (50,176 x 250,880)
at kc 16, 24 and 32, with random bytes and coefficients (the kernels'
time does not depend on the values).  Times are medians of CUDA-event
times after a warm-up, each tile timed once in order and once in
reverse.  A tile that does not build is reported and skipped.  The tool
needs a GPU and exits 1 without one, or when a tile is not bit-equal.
"""

from __future__ import annotations

import functools
import sys

import torch

from ..kernels import packed_matvec as tpk
from . import b3_tiles

NAME, KERNEL = "matvec", "matvec_tile_kernel"
SOURCE, MACRO = "matvec_v2.cu", "MATVEC_TILE"
# the tiles tried beside production's, by KC: (C, TB, TPS, EREG)
TILES = {
    16: [(8, 64, 640, 1), (8, 64, 768, 1), (8, 64, 512, 0),
         (8, 128, 512, 1), (16, 64, 384, 1), (16, 64, 256, 0)],
    24: [(8, 64, 576, 1), (8, 64, 768, 1), (12, 64, 384, 0),
         (12, 64, 512, 1), (12, 128, 512, 1)],
    32: [(8, 64, 512, 1), (8, 64, 768, 1), (8, 64, 512, 0),
         (16, 64, 256, 0)],
}
# (label, SNPs, packed bytes, kc): the main paths' B2 launches
SHAPES = (("wide", 100_352, 125_440, 16), ("wide", 100_352, 125_440, 24),
          ("tall", 50_176, 250_880, 16), ("tall", 50_176, 250_880, 24),
          ("tall", 50_176, 250_880, 32))
CR = 64


def stage_bytes(kc, tile):
    """One ``cp.async`` stage of B2: a 64-row chunk's TB bytes, its v
    rows and its four coefficient rows."""
    return CR * tile[1] + CR * kc * 4 + CR * 16


def data(device, p, nb):
    """The packed bytes, means and inverse sds of a shape (random)."""
    g = torch.Generator(device=device).manual_seed(5)
    packed = torch.randint(0, 256, (p, nb), generator=g, dtype=torch.uint8,
                           device=device)
    mean = 0.1 + 1.8 * torch.rand(p, generator=g, device=device)
    invsd = 0.5 + 1.5 * torch.rand(p, generator=g, device=device)
    return packed, mean, invsd


def panel(device, p, nb, kc):
    """B2's v (p, kc)."""
    g = torch.Generator(device=device).manual_seed(6 + kc)
    return (torch.randn((p, kc), generator=g, device=device),)


def launcher(fn, packed, mean, invsd, v, kc):
    """A thunk launching ``fn`` (a ctypes B2 entry) at ``kc``; returns
    y."""
    p, nb = packed.shape
    coeffs = tpk.coeff_rows(mean, invsd)

    def run():
        y = torch.empty((4 * nb, kc), dtype=torch.float32,
                        device=packed.device)
        rc = fn(packed.data_ptr(), *(c.data_ptr() for c in coeffs),
                v.data_ptr(), y.data_ptr(), p, nb, kc,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"matvec tile launch failed: {rc}")
        return y
    return run


def main(argv=None) -> int:
    return b3_tiles.tool_main(argv, __doc__, "b2_tiles", name=NAME,
                              macro=MACRO, kernel=KERNEL, tiles=TILES,
                              shapes=SHAPES, data=data, panel=panel,
                              launcher=launcher, occupancy=functools.partial(
                                  b3_tiles.wt_occupancy,
                                  stage_bytes=stage_bytes),
                              grid=b3_tiles.wt_grid)


if __name__ == "__main__":
    sys.exit(main())
