"""Tabular genetics file readers (.bim/.fam/annot/pheno/cov/env), NumPy only.

Port of pyrhe_tpu/io/readers.py without pandas: every reader returns the
same arrays as the reference's. The whitespace-separated tables that the
reference parses with `pd.read_csv(sep=r"\\s+")` go through `_read_table`
here, which follows the same conventions:
  - blank lines are skipped; the first remaining line is the header when
    there is one;
  - numbers are converted as pandas converts them (`_xstrtod`, not
    correctly rounded); pandas' default NA strings ("NA", "nan", "N/A",
    "NULL", ...) and, under `coerce`, any other non-numeric token become
    NaN (`pd.to_numeric(errors="coerce")`);
  - a column of integers prints as integers (`read_fam`'s FID/IID).
One-hot side files use `np.unique`, which orders the categories as
`pd.get_dummies` does.

Behavioral spec: reference pyrhe/src/util/file_processing.py. Each reader
reproduces the reference's missing-data semantics (NA / -9 handling, binary
phenotype detection, FID/IID dropping, categorical one-hot side files).
"""
from __future__ import annotations

import re

import numpy as np

# pandas' default `na_values` for read_csv
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _read_table(filename: str, header: bool):
    """Whitespace-separated table -> (column names or None, token rows).
    Short rows are padded with "NA", as pandas pads them with NaN."""
    with open(filename, "r") as f:
        rows = [line.split() for line in f if line.strip()]
    names = rows.pop(0) if header else None
    width = len(names) if header else max((len(r) for r in rows), default=0)
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{filename}: row {i + 1} has {len(r)} fields, "
                             f"expected {width}")
        r.extend(["NA"] * (width - len(r)))
    return names, rows


_DECIMAL = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
_POW10 = [float(f"1e{k}") for k in range(309)]


def _xstrtod(tok: str) -> float:
    """pandas' default float conversion (`precise_xstrtod` in its C
    tokenizer), which is NOT correctly rounded: it accumulates at most 17
    digits, leading zeros included, in a double and then scales by a power
    of ten. Emulated so that covariates come out bit-identical to the
    reference's. Tokens outside the plain decimal form go to float()."""
    m = _DECIMAL.fullmatch(tok)
    if m is None or not (m.group(2) or m.group(3)):
        return float(tok)
    sign, ipart, fpart, exp = m.groups()
    ipart, fpart = ipart or "", fpart or ""
    exponent = max(len(ipart) - 17, 0)
    digits = (ipart + fpart)[:17]
    exponent -= len(digits) - min(len(ipart), 17)
    number = float(int(digits[:15]))          # exact below 2**53
    for d in digits[15:]:
        number = number * 10.0 + int(d)
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _to_float(tok: str, coerce: bool) -> float:
    if tok in _NA_STRINGS:
        return np.nan
    try:
        return _xstrtod(tok)
    except ValueError:
        if coerce:
            return np.nan
        raise


def _numeric(rows, coerce: bool) -> np.ndarray:
    return np.array([[_to_float(t, coerce) for t in r] for r in rows],
                    dtype=np.float64).reshape(len(rows), -1)


def _drop_id_columns(names, rows):
    keep = [i for i, c in enumerate(names) if c not in ("FID", "IID")]
    return [names[i] for i in keep], [[r[i] for i in keep] for r in rows]


def _typed_column(tokens):
    """Parse one column as pandas would type it: int, else float, else str."""
    for ty in (int, float):
        try:
            return [ty(t) for t in tokens]
        except ValueError:
            pass
    return list(tokens)


def read_bim(filename: str) -> int:
    """Count SNPs in a .bim file.

    Exact parity with reference file_processing.py:6-23, which counts
    EVERY line — including comments and blank lines (its `continue`
    skips nothing: the counter was already incremented). M drives the
    .bed decode geometry, so a silently inflated count would corrupt
    every downstream genotype; we keep the reference's count but warn
    loudly when non-data lines inflate it.
    """
    total = data = 0
    with open(filename, "r") as f:
        for line in f:
            total += 1
            if line.strip() and not line.startswith("#"):
                data += 1
    if data != total:
        import warnings
        warnings.warn(
            f"{filename}: {total - data} blank/comment line(s) counted as "
            f"SNPs (M={total}) for parity with the reference's read_bim; "
            f"if the .bed actually holds {data} SNPs the decode geometry "
            f"will be wrong — clean the .bim", stacklevel=2)
    return total


def read_fam(filename: str):
    """Return (num_individuals, fam table). Reference file_processing.py:25-35.

    The table is an (N, ncol) object array whose columns are typed like
    pandas' (so `fam[i, 0]` prints an integer FID as an integer)."""
    _, rows = _read_table(filename, header=False)
    cols = [_typed_column(c) for c in zip(*rows)]
    table = np.empty((len(rows), len(cols)), dtype=object)
    for j, c in enumerate(cols):
        table[:, j] = c
    return len(rows), table


def read_annot(filename: str, num_jack: int | None = None):
    """Read an M x K 0/1 annotation matrix.

    Returns (num_bin, annot_matrix int8 (M,K), len_bin int64 (K,)).
    Reference file_processing.py:37-69 (num_jack arg unused there too).
    """
    annot = np.loadtxt(filename, dtype=np.int64, comments="#", ndmin=2)
    len_bin = annot.sum(axis=0).astype(np.int64)
    return annot.shape[1], annot, len_bin


def generate_annot(filename: str, num_snp: int, num_bin: int, rng=None) -> None:
    """Write a random one-hot annotation file (reference file_processing.py:109-118).

    Uses the provided RNG (or the global legacy np.random state like the
    reference, which calls np.random.randint per SNP).
    """
    randint = rng.randint if rng is not None else np.random.randint
    with open(filename, "w") as f:
        for _ in range(num_snp):
            row = [0] * num_bin
            row[randint(0, num_bin)] = 1
            f.write(" ".join(str(v) for v in row) + "\n")


def read_pheno(filename: str):
    """Read a `FID IID p1..pT` phenotype file.

    Returns (y float64 (N,T) with -9 rows for missing individuals,
    missing_indv row-index list, binary flag). An individual is missing if
    ANY trait is NA or -9 (reference file_processing.py:72-107). The binary
    flag is True when every observed value is in {0,1,2}.
    """
    with open(filename, "r") as f:
        lines = f.readlines()
    header = lines[0].strip().split()
    num_ph = len(header) - 2

    y = []
    missing_indv = []
    all_binary = True
    valid_values = {0.0, 1.0, 2.0}
    for i, line in enumerate(lines[1:]):
        cols = line.strip().split()
        vals_raw = cols[2:]
        is_missing = False
        vals = []
        for v in vals_raw:
            if v == "NA":
                is_missing = True
                break
            fv = float(v)
            if fv == -9:
                is_missing = True
                break
            vals.append(fv)
        if is_missing:
            y.append([-9.0] * num_ph)
            missing_indv.append(i)
        else:
            y.append(vals)
            if not all(v in valid_values for v in vals):
                all_binary = False
    return np.array(y, dtype=np.float64), missing_indv, all_binary


def read_cov(
    filename: str,
    std: bool = False,
    missing_indvs: list | None = None,
    cov_impute_method: str = "ignore",
    one_hot_conversion: bool = False,
    categorical_threshold: int = 100,
    logger=None,
    one_hot_dir: str | None = None,
):
    """Read a covariate file, dropping FID/IID columns.

    Semantics (reference file_processing.py:121-209):
      - rows already missing (from the phenotype) are dropped first
      - a row is newly-missing if any covariate is NaN or -9
      - "ignore": drop newly-missing rows; "mean": impute with column mean
      - with one_hot_conversion, categorical columns (nunique <= threshold)
        are written to `<col>_one_hot.cov` side files; like the reference,
        the RETURNED matrix is the raw (non-one-hot) values.
    Returns (cov matrix float64 (N_kept, C), all_missing_indvs).
    """
    import os

    from ..utils.types import CovImputeMethod
    CovImputeMethod(cov_impute_method)  # raises on unknown value

    names, rows = _read_table(filename, header=True)
    missing_indvs = list(missing_indvs) if missing_indvs else []
    index = np.setdiff1d(np.arange(len(rows)), missing_indvs)
    names, rows = _drop_id_columns(names, [rows[i] for i in index])

    num = _numeric(rows, coerce=True)
    is_missing = np.isnan(num).any(axis=1) | (num == -9).any(axis=1)
    newly_missing = index[is_missing].tolist()

    if cov_impute_method == "ignore":
        num = num[~is_missing]
    else:  # mean imputation
        num = np.where(num == -9, np.nan, num)
        seen = ~np.isnan(num)
        count = seen.sum(axis=0)
        # one contiguous (pairwise) sum per column, as pandas' mean does
        total = np.ascontiguousarray(np.where(seen, num, 0.0).T).sum(axis=1)
        mean = np.divide(total, count, out=np.full(num.shape[1], np.nan),
                         where=count > 0)
        num = np.where(seen, num, mean[None, :])
        newly_missing = []

    all_missing = missing_indvs + newly_missing

    if one_hot_conversion:
        for j, column in enumerate(names):
            values = num[:, j]
            cats = np.unique(values[~np.isnan(values)])
            nuniq = len(cats)
            if nuniq <= categorical_threshold:
                if logger:
                    logger._debug(
                        f"Column '{column}' detected as categorical with {nuniq} unique values."
                    )
                one_hot = (values[:, None] == cats[None, :]).astype(int)
                out_name = f"{column}_one_hot.cov"
                if one_hot_dir is not None:
                    out_name = os.path.join(one_hot_dir, out_name)
                np.savetxt(out_name, one_hot, fmt="%d", delimiter=" ")
                if logger:
                    logger._debug(
                        f"One-hot encoded values for '{column}' stored in '{out_name}'"
                    )

    if std:
        num = (num - num.mean(axis=0)) / num.std(axis=0, ddof=1)

    return num.astype(np.float64), all_missing


def read_env_file(file_path: str):
    """Read environment columns (everything but FID/IID).

    Returns (num_env, env float64 (N, num_env)). The reference
    (file_processing.py:212-227) computes num_env = ncols-2 but only ever
    reads the single column named 'env'; we read all env columns so
    num_env > 1 actually works — identical behavior for the tested
    num_env == 1 case.
    """
    names, rows = _read_table(file_path, header=True)
    names, rows = _drop_id_columns(names, rows)
    env = _numeric(rows, coerce=False)
    return env.shape[1], env
