"""PLINK .bed/.bim/.fam reading, host side.

Layout facts (reference: data.h:24-45, data.cpp:41-58,150-176):

* .bed is SNP-major: 3 magic bytes, then ``ceil(N/4)`` bytes per SNP.
* Each byte packs 4 samples, 2 bits each, sample ``4*b + s`` in bits
  ``[2s, 2s+1]`` of byte ``b``.
* 2-bit code -> minor-allele dosage: ``0 -> 2``, ``2 -> 1``, ``3 -> 0``,
  ``1 -> missing`` (NA).
* The number of SNPs is inferred from the file size: ``(len-3) / ceil(N/4)``
  (the reference does not validate the magic bytes; we warn only).

This module is pure numpy (float64) so that per-SNP statistics used for
standardization are exact, independent of device dtype.  An optional
C++ fast path (csrc/bedio.cpp) accelerates the decode/stats loops.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import numpy as np

PACK_DENSITY = 4
PLINK_NA_CODE = 1  # 2-bit code '01' denotes missing
BED_MAGIC = b"\x6c\x1b\x01"

# 2-bit code -> dosage; NA marked separately.  code 1 mapped to 0 here and
# masked via PLINK_NA_CODE (reference: decode_plink, data.cpp:65-126).
CODE_TO_DOSAGE = np.array([2.0, 0.0, 1.0, 0.0], dtype=np.float64)
CODE_IS_NA = np.array([False, True, False, False])

# byte -> its four 2-bit codes as one little-endian word: viewed as bytes,
# the word holds code s of the byte in byte s (one gather a packed byte)
_CODE_WORDS = np.array(
    [sum(((b >> (2 * s)) & 3) << (8 * s) for s in range(PACK_DENSITY))
     for b in range(256)], dtype="<u4")
# bytes of codes a host work item holds (the repack and the moments run
# over SNP rows in such chunks on up to _THREADS worker threads: numpy
# releases the GIL in take and in its elementwise loops)
_CHUNK_BYTES = 16 << 20
_THREADS = 8
_M55 = np.uint64(0x5555555555555555)


def bytes_per_snp(n_samples: int) -> int:
    return (n_samples + PACK_DENSITY - 1) // PACK_DENSITY


def _over_rows(fn, m: int, row_bytes: int) -> None:
    """Run ``fn(lo, hi)`` over chunks of ``m`` rows of ``row_bytes``
    bytes each, on up to ``_THREADS`` threads (inline on one)."""
    rows = max(1, _CHUNK_BYTES // max(1, row_bytes))
    starts = range(0, m, rows)
    threads = min(_THREADS, os.cpu_count() or 1, len(starts))
    if threads <= 1:
        for lo in starts:
            fn(lo, min(lo + rows, m))
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as ex:
        for f in [ex.submit(fn, lo, min(lo + rows, m)) for lo in starts]:
            f.result()


def unpack_codes(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """(m, nbytes) packed uint8 -> (m, n_samples) 2-bit codes (uint8).

    Equivalent of ``decode_plink_simple`` (reference: data.cpp:128-148):
    one table word a byte (``_CODE_WORDS``), viewed as its four codes.
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    m, nb = packed.shape
    codes = _CODE_WORDS.take(packed).view(np.uint8)
    return codes.reshape(m, nb * PACK_DENSITY)[:, :n_samples]


def _pack_words(padded: np.ndarray) -> np.ndarray:
    """(m, 4 nb) uint8 codes (padding positions 0..3, C order) -> (m,
    nb) .bed bytes: each run of four codes, read as one little-endian
    word with a code in each byte's low two bits, folds into its low
    byte by two shift-ORs (codes 0 and 1 land in bits 0-3 of the first
    fold, 2 and 3 in bits 16-19, which the second fold moves to 4-7)."""
    w = padded.view("<u4")
    t = w >> 6
    t |= w
    t |= t >> 12
    return t.astype(np.uint8)


def codes_to_dosage(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> float64 dosage with NaN for missing."""
    out = CODE_TO_DOSAGE[codes]
    out[CODE_IS_NA[codes]] = np.nan
    return out


def snp_moments_from_codes(
    codes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-SNP raw dosage moments over non-missing samples, float64:
    (ngood, dsum, d2sum) = (count, sum of dosages, sum of squares).

    Any standardization's (mean, sd) and the exact per-SNP sum of
    squared STANDARDIZED genotypes follow analytically from these
    (:func:`stats_from_moments`, ops/standardize.py
    ``sumsq_from_moments``) -- so the trace of X X^T costs no data pass
    at all, where the reference accumulates it during the first
    streamed operator pass (svdwide.cpp:44-45)."""
    na = CODE_IS_NA[codes]
    dosage = np.where(na, 0.0, CODE_TO_DOSAGE[codes])
    ngood = (codes.shape[1] - na.sum(axis=1)).astype(np.float64)
    dsum = dosage.sum(axis=1)
    # dosage in {0, 1, 2}: g^2 = 2g - [g == 1], cheaper than squaring
    d2sum = 2.0 * dsum - (dosage == 1.0).sum(axis=1)
    return ngood, dsum, d2sum


def snp_moments_from_packed(
    packed: np.ndarray, n_samples: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`snp_moments_from_codes` of ``unpack_codes(packed,
    n_samples)``, the same exact values, counted on the bytes: each
    64-bit word's low and high code bits split by a mask, and the codes
    0 (dosage 2), 1 (missing) and 2 (dosage 1) counted by popcount.  The
    last byte's padding positions count as code 3 (dosage 0, not
    missing), which adds nothing."""
    packed = np.asarray(packed, dtype=np.uint8)
    m, nb = packed.shape
    nw = -(-nb // 8)
    na = np.empty(m, dtype=np.int64)
    c0 = np.empty(m, dtype=np.int64)
    c2 = np.empty(m, dtype=np.int64)
    rem = n_samples % PACK_DENSITY

    def count(lo_row, hi_row):
        buf = np.full((hi_row - lo_row, nw * 8), 0xFF, dtype=np.uint8)
        buf[:, :nb] = packed[lo_row:hi_row]
        if rem:
            buf[:, nb - 1] |= np.uint8((0xFF << (2 * rem)) & 0xFF)
        w = buf.view("<u8")
        lo = w & _M55
        hi = (w >> np.uint64(1)) & _M55
        s = slice(lo_row, hi_row)
        for out, bits in ((na, lo & ~hi), (c2, hi & ~lo),
                          (c0, ~(lo | hi) & _M55)):
            out[s] = np.bitwise_count(bits).sum(axis=1, dtype=np.int64)

    _over_rows(count, m, nw * 8)
    ngood = (n_samples - na).astype(np.float64)
    dsum = (2 * c0 + c2).astype(np.float64)
    return ngood, dsum, 2.0 * dsum - c2


def stats_from_moments(
    ngood: np.ndarray, dsum: np.ndarray, method: str = "binom2"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-SNP (mean, sd) from raw dosage moments, exact float64.

    Mirrors the streaming standardizer's first-visit computation
    (reference: data.cpp:262-291): mean over non-missing; ``P = mean/2``;
    ``sd = sqrt(P(1-P))`` for binom or ``sqrt(2P(1-P))`` for binom2.
    """
    if method not in ("binom", "binom2"):
        raise ValueError(f"unknown standardisation method: {method}")
    # an all-missing SNP (ngood = 0) gets (mean, sd) = (0, 0): the
    # column is zeroed downstream exactly like a monomorphic SNP.
    # (The reference divides by zero here and lets NaN stats poison
    # its lookup table -- a latent bug, not behavior to reproduce.)
    mean = np.where(ngood > 0, dsum / np.maximum(ngood, 1), 0.0)
    p_hat = mean / 2.0
    mult = 1.0 if method == "binom" else 2.0
    sd = np.where(ngood > 0, np.sqrt(mult * p_hat * (1.0 - p_hat)), 0.0)
    return mean, sd


def snp_stats_from_codes(
    codes: np.ndarray, method: str = "binom2"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-SNP (mean, sd) over non-missing dosages, exact float64."""
    ngood, dsum, _ = snp_moments_from_codes(codes)
    return stats_from_moments(ngood, dsum, method)


@dataclass
class PlinkDataset:
    """A PLINK fileset opened for block reads.

    Equivalent of ``class Data`` (reference: data.h:60-101) minus the
    standardization cache, which lives on-device in this framework.
    """

    bed_path: str
    bim_path: str
    fam_path: str

    n_samples: int = 0
    n_snps: int = 0
    snp_ids: list = field(default_factory=list)
    ref_alleles: list = field(default_factory=list)
    alt_alleles: list = field(default_factory=list)
    bp: list = field(default_factory=list)
    fam_ids: list = field(default_factory=list)
    indiv_ids: list = field(default_factory=list)

    # compare=False: the dataclass __eq__ would otherwise compare two
    # memmaps elementwise and bool() of that raises
    _mmap: np.ndarray | None = field(default=None, compare=False,
                                     repr=False)
    # full-file moments memo: every snp_stats()/snp_moments() caller
    # (each analysis mode + the CLI's --outmeansd writer) re-scanned
    # the whole .bed for the identical exact-f64 counts
    _moments: tuple | None = field(default=None, compare=False,
                                   repr=False)

    @classmethod
    def open(cls, root_or_bed: str, bim: str | None = None, fam: str | None = None):
        """Open from a ``--bfile`` root or explicit bed/bim/fam paths."""
        if bim is None and fam is None and not root_or_bed.endswith(".bed"):
            bed = root_or_bed + ".bed"
            bim = root_or_bed + ".bim"
            fam = root_or_bed + ".fam"
        else:
            bed = root_or_bed
            if bim is None or fam is None:
                raise ValueError("must give bim and fam when passing a .bed path")
        ds = cls(bed_path=bed, bim_path=bim, fam_path=fam)
        ds.read_fam()
        ds.read_bim()
        ds.get_size()
        # the reference validates neither (data.cpp:150-176: nsnps is
        # len/np, bim count unchecked) -- but downstream output writers
        # pair every SNP row with its .bim id/allele, so a mismatch
        # would silently mislabel results; fail loudly instead
        if len(ds.snp_ids) != ds.n_snps:
            raise ValueError(
                f"{bim} lists {len(ds.snp_ids)} SNPs but {bed} holds "
                f"{ds.n_snps} (= (filesize - 3) // ceil(N/4) with N="
                f"{ds.n_samples} samples from {fam})")
        return ds

    # -- metadata ----------------------------------------------------------
    def read_fam(self) -> None:
        """Read .fam: first two columns are FID and IID; N = row count
        (reference: data.cpp:639-672 and read_pheno data.cpp:408-413)."""
        fam_ids, indiv_ids = [], []
        with open(self.fam_path, "r") as fh:
            for ln, line in enumerate(fh, 1):
                tokens = line.split()
                if not tokens:
                    continue
                if len(tokens) < 2:
                    raise ValueError(
                        f"{self.fam_path}:{ln}: expected at least "
                        f"FID IID, got {len(tokens)} column(s)")
                fam_ids.append(tokens[0])
                indiv_ids.append(tokens[1])
        self.fam_ids = fam_ids
        self.indiv_ids = indiv_ids
        self.n_samples = len(fam_ids)

    def read_bim(self) -> None:
        """Read .bim: snp id (col 2), bp (col 4), ref/alt alleles (cols 5,6)
        (reference: data.cpp:589-637)."""
        snp_ids, ref_a, alt_a, bp = [], [], [], []
        with open(self.bim_path, "r") as fh:
            for ln, line in enumerate(fh, 1):
                tokens = line.split()
                if not tokens:
                    continue
                if len(tokens) < 6:
                    raise ValueError(
                        f"{self.bim_path}:{ln}: expected 6 columns "
                        f"(chr id cM bp A1 A2), got {len(tokens)}")
                snp_ids.append(tokens[1])
                bp.append(int(tokens[3]))
                ref_a.append(tokens[4])
                alt_a.append(tokens[5])
        self.snp_ids = snp_ids
        self.ref_alleles = ref_a
        self.alt_alleles = alt_a
        self.bp = bp

    def get_size(self) -> None:
        """Infer n_snps from file size (reference: data.cpp:150-176)."""
        if self.n_samples == 0:
            raise RuntimeError(
                "no samples (.fam is empty, or read_fam() did not run "
                "before get_size())")
        size = os.path.getsize(self.bed_path)
        if size < 3:
            raise ValueError(
                f"{self.bed_path}: file holds {size} bytes -- not even "
                "the 3-byte .bed header (empty or truncated file)")
        length = size - 3
        nb = bytes_per_snp(self.n_samples)
        self.n_snps = length // nb
        if length % nb:
            warnings.warn(
                f"{self.bed_path}: {length % nb} trailing bytes beyond "
                f"{self.n_snps} whole SNPs (truncated file, or N="
                f"{self.n_samples} does not match this .bed); the "
                "partial SNP is ignored")
        with open(self.bed_path, "rb") as fh:
            magic = fh.read(3)
        if magic != BED_MAGIC:
            if magic[:2] == BED_MAGIC[:2] and magic[2:3] == b"\x00":
                # the mode byte IS checkable: individual-major data
                # decoded with the SNP-major stride is silent garbage
                raise ValueError(
                    f"{self.bed_path} is an individual-major .bed "
                    "(mode byte 0); convert it to SNP-major "
                    "(plink --make-bed) first")
            warnings.warn(
                f"{self.bed_path}: unexpected .bed magic bytes {magic!r}; "
                "proceeding (the reference does not validate them either)"
            )

    # -- packed access -----------------------------------------------------
    @property
    def nbytes_per_snp(self) -> int:
        return bytes_per_snp(self.n_samples)

    def _map(self) -> np.ndarray:
        if self._mmap is None:
            nb = self.nbytes_per_snp
            self._mmap = np.memmap(
                self.bed_path, dtype=np.uint8, mode="r", offset=3,
                shape=(self.n_snps, nb),
            )
        return self._mmap

    def read_packed(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Packed bytes for SNPs [start, stop) as (m, nbytes) uint8."""
        stop = self.n_snps if stop is None else stop
        return np.asarray(self._map()[start:stop])

    def byte_range(self, start: int, stop: int) -> tuple[int, int]:
        """File byte offsets [lo, hi) holding SNPs [start, stop).

        This is the shard-planning primitive for multi-host reading:
        SNP j lives at offset ``3 + j * ceil(N/4)``.
        """
        nb = self.nbytes_per_snp
        return 3 + start * nb, 3 + stop * nb

    # -- dense access ------------------------------------------------------
    def read_codes(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """(m, N) 2-bit codes for SNPs [start, stop)."""
        from . import cbed

        packed = self.read_packed(start, stop)
        if cbed.available():
            return cbed.codes(packed, self.n_samples)
        return unpack_codes(packed, self.n_samples)

    def read_matrix(self, impute_mean: bool = True) -> np.ndarray:
        """Load the full (N, p) dosage matrix, mean-imputing missing values.

        Equivalent of the batch loader ``Data::read_bed`` (reference:
        data.cpp:339-406): dosage-valued, *not* standardized.
        """
        from . import cbed

        if cbed.available():
            dosage = cbed.dosage(self.read_packed(), self.n_samples)
        else:
            dosage = codes_to_dosage(self.read_codes())  # (p, N) with NaN
        if impute_mean:
            na = np.isnan(dosage)
            ngood = dosage.shape[1] - na.sum(axis=1)
            total = np.where(na, 0.0, dosage).sum(axis=1)
            # all-missing SNPs impute to 0 (a constant column, zeroed
            # by standardization) so the batch path agrees with the
            # packed path's all-missing handling instead of erroring
            means = np.where(ngood > 0, total / np.maximum(ngood, 1), 0.0)
            dosage[na] = np.broadcast_to(means[:, None], dosage.shape)[na]
        return np.ascontiguousarray(dosage.T)

    def snp_moments(self, block_size: int = 8192,
                    snp_range: tuple[int, int] | None = None,
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact per-SNP raw dosage moments (ngood, dsum, d2sum) over
        the file (one blockwise pass; native LUT kernel when built).
        Stats for any method and the analytic standardized sum of
        squares both derive from these (see
        :func:`snp_moments_from_codes`)."""
        from . import cbed

        full = snp_range is None
        if full and self._moments is not None:
            return self._moments
        lo, hi = (0, self.n_snps) if full else snp_range
        if cbed.moments_available():
            out = cbed.moments(self.read_packed(lo, hi), self.n_samples)
        else:
            m = hi - lo
            ngood = np.empty(m, dtype=np.float64)
            dsum = np.empty(m, dtype=np.float64)
            d2sum = np.empty(m, dtype=np.float64)
            for start in range(lo, hi, block_size):
                stop = min(start + block_size, hi)
                s = slice(start - lo, stop - lo)
                ngood[s], dsum[s], d2sum[s] = snp_moments_from_packed(
                    self.read_packed(start, stop), self.n_samples)
            out = ngood, dsum, d2sum
        if full:
            self._moments = out
        return out

    def snp_stats(self, method: str = "binom2",
                  block_size: int = 8192,
                  snp_range: tuple[int, int] | None = None,
                  with_sumsq: bool = False,
                  ):
        """Exact per-SNP (mean, sd) computed blockwise over the file.

        Uses the native OpenMP LUT kernel (csrc/bedio.cpp) when built;
        numpy blockwise fallback otherwise.  ``snp_range=(lo, hi)``
        restricts the computation (and the file IO) to that SNP range --
        the per-host primitive for multi-host stats (parallel/dist.py),
        where each process reads only its own byte range.

        ``with_sumsq=True`` additionally returns the exact per-SNP sum
        of squared standardized genotypes (missing entries decode to 0)
        -- derived analytically from the same single pass, so the trace
        of X X^T (pve denominator, randompca.cpp:205-210) and the UCCA
        per-SNP variances cost NO device data pass."""
        from . import cbed

        if method not in ("binom", "binom2"):
            raise ValueError(f"unknown standardisation method: {method}")
        if with_sumsq:
            from ..ops.standardize import sumsq_from_moments

            ngood, dsum, d2sum = self.snp_moments(
                block_size=block_size, snp_range=snp_range)
            mean, sd = stats_from_moments(ngood, dsum, method)
            return mean, sd, sumsq_from_moments(ngood, dsum, d2sum,
                                                mean, sd)
        if snp_range is None and (self._moments is not None
                                  or cbed.moments_available()
                                  or not cbed.available()):
            # full-file stats ride the (cached) moments pass: a later
            # call for ANY method -- e.g. the CLI's --outmeansd writer
            # after the analysis already scanned the file -- costs no
            # IO, and (mean, sd) from exact-f64 integer moments are
            # bit-identical to the direct computation
            ngood, dsum, _ = self.snp_moments(block_size=block_size)
            return stats_from_moments(ngood, dsum, method)
        lo, hi = (0, self.n_snps) if snp_range is None else snp_range
        if cbed.available():
            return cbed.stats(self.read_packed(lo, hi), self.n_samples,
                              method)
        ngood, dsum, _ = self.snp_moments(block_size=block_size,
                                          snp_range=(lo, hi))
        return stats_from_moments(ngood, dsum, method)


def pack_codes(codes: np.ndarray, n_samples: int) -> np.ndarray:
    """Repack (m, n_samples) 2-bit codes into PLINK .bed bytes
    (m, ceil(n/4)); padding positions are code 0.  One implementation
    shared by write_bed and subset_samples so the bit layout cannot
    drift between the two writers."""
    m = codes.shape[0]
    nb = bytes_per_snp(n_samples)
    padded = np.zeros((m, nb * PACK_DENSITY), dtype=np.uint8)
    padded[:, :n_samples] = codes
    return _pack_words(padded)


def _subset_packed(packed: np.ndarray, subsets) -> None:
    """.bed bytes (m, nb) of some samples -> for each ``(idx, n_out,
    out)`` of ``subsets``, ``out`` (m, ceil(n_out/4)) the bytes of the
    samples ``idx`` (padded to a multiple of 4 with any valid index):
    per chunk of rows one table gather unpacks the codes once, and for
    each subset one column gather keeps its samples, :func:`_pack_words`
    repacks them and the last byte's padding positions are zeroed."""
    m, nb = packed.shape

    def job(lo, hi):
        codes = _CODE_WORDS.take(packed[lo:hi]).view(np.uint8)
        for idx, n_out, out in subsets:
            sub = np.empty((hi - lo, idx.size), dtype=np.uint8)
            np.take(codes, idx, axis=1, out=sub, mode="clip")
            res = _pack_words(sub)
            rem = n_out % PACK_DENSITY
            if rem:
                res[:, -1] &= np.uint8((1 << (2 * rem)) - 1)
            out[lo:hi] = res

    _over_rows(job, m, nb * PACK_DENSITY)


def write_bed(path_root: str, genotypes: np.ndarray,
              snp_ids: list | None = None,
              fam_ids: list | None = None) -> None:
    """Write a PLINK fileset from an (N, p) dosage matrix (0/1/2, NaN=missing).

    Test/benchmark helper (the reference ships pre-made filesets only).
    """
    geno = np.asarray(genotypes, dtype=np.float64)
    n, p = geno.shape
    # 2-bit codes can hold EXACTLY {0, 1, 2, NaN}: anything else (e.g.
    # a mean-imputed fractional dosage) would silently encode as
    # dosage 0 -- refuse instead of corrupting the fileset
    bad = ~(np.isnan(geno) | np.isin(geno, (0.0, 1.0, 2.0)))
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise ValueError(
            f"genotypes[{i}, {j}] = {geno[i, j]!r} is not in "
            "{0, 1, 2, NaN}; .bed holds 2-bit hard calls only")
    # dosage -> 2-bit code: 2->0, 1->2, 0->3, NaN->1
    codes = np.full((p, n), 3, dtype=np.uint8)
    gt = geno.T
    codes[gt == 2] = 0
    codes[gt == 1] = 2
    codes[np.isnan(gt)] = 1
    packed = pack_codes(codes, n)
    with open(path_root + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(packed.tobytes())
    if snp_ids is None:
        snp_ids = [f"snp{j+1}" for j in range(p)]
    elif len(snp_ids) != p:
        raise ValueError(f"snp_ids has {len(snp_ids)} entries for {p} SNPs")
    if fam_ids is None:
        fam_ids = [f"id{i+1}" for i in range(n)]
    elif len(fam_ids) != n:
        raise ValueError(
            f"fam_ids has {len(fam_ids)} entries for {n} samples")
    with open(path_root + ".bim", "w") as fh:
        for j, sid in enumerate(snp_ids):
            fh.write(f"1\t{sid}\t0\t{j+1}\tA\tC\n")
    with open(path_root + ".fam", "w") as fh:
        for i, fid in enumerate(fam_ids):
            fh.write(f"{fid}\t{fid}\t0\t0\t0\t-9\n")


def subset_samples(ds: PlinkDataset, sample_idx, out_root: str,
                   block_size: int = 8192) -> str:
    """Write a new PLINK fileset holding only the given samples.

    The in-framework equivalent of scca.sh's external
    ``plink --keep/--remove --make-bed`` split step (scca.sh:42-50):
    SNP blocks are unpacked, column-subset, and repacked 2-bit, so
    memory stays bounded by one block regardless of p.  Returns
    ``out_root``.
    """
    return subset_samples_many(ds, [(sample_idx, out_root)],
                               block_size)[0]


def subset_samples_many(ds: PlinkDataset, subsets,
                        block_size: int = 8192) -> list[str]:
    """:func:`subset_samples` for each ``(sample_idx, out_root)`` of
    ``subsets`` from ONE read of the source: each SNP block is unpacked
    once and repacked into every subset (a train and a test fileset
    cost one unpack, not two).  Returns the ``out_root``s."""
    keep = []       # (indices, indices padded, count, out_root)
    for sample_idx, out_root in subsets:
        idx = np.asarray(sample_idx)
        if idx.dtype == bool:
            if idx.shape != (ds.n_samples,):
                raise ValueError(
                    f"boolean mask has {idx.size} entries for "
                    f"{ds.n_samples} samples")
            idx = np.flatnonzero(idx)
        elif idx.size and (idx.min() < 0 or idx.max() >= ds.n_samples):
            raise ValueError(
                f"sample indices span [{idx.min()}, {idx.max()}] but the "
                f"dataset holds {ds.n_samples} samples")
        n_out = int(idx.size)
        if n_out < 1:
            raise ValueError("sample subset is empty")
        if (os.path.abspath(out_root + ".bed")
                == os.path.abspath(ds.bed_path)):
            # open(..., 'wb') would TRUNCATE the source .bed mid-read
            raise ValueError(
                f"out_root {out_root!r} collides with the source fileset; "
                "write the subset somewhere else")
        nbo = bytes_per_snp(n_out)
        idx_pad = np.concatenate(
            [idx, np.full(nbo * PACK_DENSITY - n_out, idx[-1])]
        ).astype(np.intp)
        keep.append((idx, idx_pad, n_out, out_root))
    import shutil
    from contextlib import ExitStack

    with ExitStack() as stack:
        fhs = [stack.enter_context(open(k[-1] + ".bed", "wb"))
               for k in keep]
        for fh in fhs:
            fh.write(BED_MAGIC)
        for start in range(0, ds.n_snps, block_size):
            stop = min(start + block_size, ds.n_snps)
            blocks = [np.empty((stop - start, bytes_per_snp(n_out)),
                               dtype=np.uint8) for _, _, n_out, _ in keep]
            _subset_packed(ds.read_packed(start, stop), [
                (pad, n_out, block)
                for (_, pad, n_out, _), block in zip(keep, blocks)])
            for fh, block in zip(fhs, blocks):
                fh.write(block.tobytes())
    with open(ds.fam_path) as fh:
        # skip blank lines so row i matches sample index i exactly as
        # read_fam assigns indices (a blank line would otherwise shift
        # every later sample's FID/IID)
        fam_lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    for idx, _, _, out_root in keep:
        shutil.copyfile(ds.bim_path, out_root + ".bim")
        with open(out_root + ".fam", "w") as fh:
            for i in idx:
                fh.write(fam_lines[i] + "\n")
    return [k[-1] for k in keep]
