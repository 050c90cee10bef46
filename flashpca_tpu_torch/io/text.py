"""Text table readers/writers with the reference's exact file formats.

* ``read_text`` mirrors the whitespace-tokenized numeric reader
  (reference: data.cpp:504-586): 1-based ``firstcol``, optional header
  ``skip`` lines, strict numeric parsing, consistent column counts.
* ``read_maf`` mirrors the PLINK .frq reader (reference: data.cpp:419-496):
  6 columns (CHR SNP A1 A2 MAF NCHROBS), header skipped, SNP ids
  cross-checked against the .bim ids.
* ``save_text`` mirrors the tab-separated writer (reference: util.h:69-108):
  optional colnames row, optional rownames column, ``%.{precision}g``
  values (default precision 7, flashpca.cpp:554).
"""

from __future__ import annotations

import numpy as np

from ..utils.formats import format_g

TXT_SEP = "\t"


def _strict_float(token: str) -> float:
    """strtod-like parse: Python's float() accepts underscore
    separators ('1_5' -> 15.0) that the reference rejects -- a typo'd
    number must error, not silently corrupt the table."""
    if "_" in token:
        raise ValueError(f"'{token}' cannot be parsed as a number")
    return float(token)


def read_text(
    filename: str,
    firstcol: int = 1,
    nrows: int = -1,
    skip: int = 0,
) -> np.ndarray:
    """Read a whitespace-delimited numeric table.

    ``firstcol`` is 1-based: 3 for pheno files (skip FID IID), 6 for
    .fam files (phenotype column), 3 skip=1 for loadings/meansd files
    with a header row.
    Returns a float64 matrix of the columns from ``firstcol`` onward.
    """
    rows: list[list[float]] = []
    numfields_first = None
    with open(filename, "r") as fh:
        for line_num, line in enumerate(fh):
            if nrows != -1 and line_num >= nrows:
                break
            if line_num < skip:
                continue
            tokens = line.split()
            if not tokens and line.strip() == "":
                continue
            numfields = len(tokens) - firstcol + 1
            if numfields < 1:
                raise ValueError(
                    f"Error reading file '{filename}', line "
                    f"{line_num + 1}: {len(tokens)} column(s), but "
                    f"firstcol={firstcol}")
            if numfields_first is None:
                numfields_first = numfields
            elif numfields != numfields_first:
                raise ValueError(
                    f"Error reading file '{filename}': inconsistent number of columns"
                )
            try:
                vals = [_strict_float(t) for t in tokens[firstcol - 1 :]]
            except ValueError as e:
                raise ValueError(
                    f"Error reading file '{filename}', line {line_num + 1}: {e}"
                ) from None
            rows.append(vals)
    if not rows:
        return np.zeros((0, 0), dtype=np.float64)
    return np.asarray(rows, dtype=np.float64)


def read_text_with_rownames(
    filename: str,
    firstcol: int = 1,
    skip: int = 0,
) -> tuple[np.ndarray, list[list[str]]]:
    """Like :func:`read_text` but also returns the leading id columns
    (tokens before ``firstcol``) per row, for id cross-checking."""
    rows: list[list[float]] = []
    ids: list[list[str]] = []
    numfields_first = None
    with open(filename, "r") as fh:
        for line_num, line in enumerate(fh):
            if line_num < skip:
                continue
            tokens = line.split()
            if not tokens and line.strip() == "":
                continue
            numfields = len(tokens) - firstcol + 1
            if numfields < 1:
                raise ValueError(
                    f"Error reading file '{filename}', line "
                    f"{line_num + 1}: {len(tokens)} column(s), but "
                    f"firstcol={firstcol}")
            if numfields_first is None:
                numfields_first = numfields
            elif numfields != numfields_first:
                raise ValueError(
                    f"Error reading file '{filename}': inconsistent number of columns"
                )
            ids.append(tokens[: firstcol - 1])
            try:
                rows.append([_strict_float(t)
                             for t in tokens[firstcol - 1 :]])
            except ValueError as e:
                raise ValueError(
                    f"Error reading file '{filename}', line {line_num + 1}: {e}"
                ) from None
    if not rows:
        return np.zeros((0, 0), dtype=np.float64), []
    return np.asarray(rows, dtype=np.float64), ids


def read_maf(filename: str, snp_ids: list[str]) -> np.ndarray:
    """Read a PLINK .frq file; returns an (p,) array of MAFs.

    Validates column count (must be 6) and that SNP ids match the .bim
    ids row by row (reference: data.cpp:450-477).
    """
    mafs: list[float] = []
    with open(filename, "r") as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip() != ""]
    body = lines[1:]  # skip .frq header
    if len(body) != len(snp_ids):
        raise ValueError(
            f"Error number of SNPs in '{filename}': different number of SNPs "
            "than in the bim file"
        )
    for i, line in enumerate(body):
        tokens = line.split()
        if len(tokens) != 6:
            raise ValueError(
                f"Error reading file '{filename}': inconsistent number of columns"
            )
        if tokens[1] != snp_ids[i]:
            raise ValueError(
                f"Error reading file '{filename}': inconsistent SNP id at row: {i}"
            )
        try:
            mafs.append(_strict_float(tokens[4]))
        except ValueError:
            # PLINK writes 'NA' for zero-observation SNPs
            raise ValueError(
                f"Error reading file '{filename}', row {i}: MAF "
                f"{tokens[4]!r} cannot be parsed as a number"
            ) from None
    return np.asarray(mafs, dtype=np.float64)


def maf2meansd(maf: np.ndarray) -> np.ndarray:
    """Convert MAF to the [mean, sd] table used for standardization.

    Replicates the reference's quirk exactly (randompca.cpp:745-751):
    mean = 2*maf and the *sd slot stores 2*maf*(1-maf)* (the binom2
    variance, not its square root).
    """
    maf = np.asarray(maf, dtype=np.float64).reshape(-1)
    out = np.empty((maf.shape[0], 2), dtype=np.float64)
    out[:, 0] = 2.0 * maf
    out[:, 1] = 2.0 * maf * (1.0 - maf)
    return out


def save_text(
    matrix,
    filename: str,
    colnames: list[str] | None = None,
    rownames: list[str] | None = None,
    precision: int = 7,
) -> None:
    """Write a tab-separated text table in the reference's format."""
    m = np.asarray(matrix, dtype=np.float64)
    # a vector writes as ONE VALUE PER ROW (eigenvalues/pve files)
    m = m.reshape(-1, 1) if m.ndim == 1 else np.atleast_2d(m)
    if rownames and len(rownames) != m.shape[0]:
        raise ValueError(
            f"rownames has {len(rownames)} entries for {m.shape[0]} "
            "rows")      # a mid-loop IndexError leaves a truncated file
    with open(filename, "w") as out:
        if colnames:
            out.write(TXT_SEP.join(colnames) + "\n")
        for j in range(m.shape[0]):
            row = TXT_SEP.join(format_g(v, precision) for v in m[j])
            if rownames:
                out.write(rownames[j] + TXT_SEP + row + "\n")
            else:
                out.write(row + "\n")
