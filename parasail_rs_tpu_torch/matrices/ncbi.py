"""Exact NCBI substitution-matrix ingestion.

The reference resolves every builtin name to the verbatim NCBI table that
parasail embeds at build time (reference: src/matrix/mod.rs:46-73 via
``parasail_matrix_lookup``).  This build environment has no network access
and no copy of the NCBI data, so the exact tables cannot be vendored
here without fabricating them; instead this module ingests the public
data files (ftp.ncbi.nlm.nih.gov/blast/matrices/) at runtime and
registers them as exact builtins, replacing the synthesised fallbacks in
:mod:`.data` for every registered name.

Three ways to get exact builtins:

- ``register_ncbi_dir(path)`` — point at a directory of NCBI matrix
  files (``BLOSUM62``, ``PAM120``, ... — the stock ftp layout).
- ``PT_NCBI_MATRICES=/path/to/matrices`` — same, applied automatically
  on first lookup.
- drop the files into ``parasail_rs_tpu/matrices/ncbi_data/`` — scanned
  automatically; a vendored-data deployment needs no configuration.

Registered matrices satisfy ``Matrix.from_name(n).approximate is False``
and are bit-exact by construction (the data IS the NCBI file).
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from . import data as _data

log = logging.getLogger("parasail_rs_tpu")

_NAME_RE = re.compile(r"^(blosum|pam)(\d+)$", re.IGNORECASE)


def parse_ncbi_file(path: str | os.PathLike) -> np.ndarray:
    """Parse one NCBI square matrix file into canonical 24x24 int32 data.

    Format (the same one ``Matrix.from_file`` accepts,
    reference: src/matrix/mod.rs:79-130): ``#`` comments, an alphabet
    header row, one labeled row per alphabet character.  Rows/columns are
    reordered to the canonical ``ARNDCQEGHILKMFPSTWYVBZX*`` layout.
    """
    with open(os.fspath(path)) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines:
        raise ValueError(f"no matrix content in {path}")
    header = lines[0].split()
    if any(len(tok) != 1 for tok in header):
        raise ValueError(f"malformed alphabet header in {path}")
    ncols = len(header)
    rows: dict[str, list[int]] = {}
    for ln in lines[1:]:
        toks = ln.split()
        if len(toks) == ncols + 1:
            rows[toks[0]] = [int(v) for v in toks[1:]]
        elif len(toks) == ncols:
            rows[header[len(rows)]] = [int(v) for v in toks]
        else:
            raise ValueError(f"row width mismatch in {path}: {ln!r}")
    want = _data.PROTEIN_ALPHABET
    missing = [c for c in want if c not in header or c not in rows]
    if missing:
        raise ValueError(
            f"{path} lacks required characters {missing!r} of the NCBI "
            "protein alphabet")
    col = {c: header.index(c) for c in want}
    out = np.zeros((24, 24), dtype=np.int32)
    for i, ci in enumerate(want):
        row = rows[ci]
        for j, cj in enumerate(want):
            out[i, j] = row[col[cj]]
    if not (out == out.T).all():
        raise ValueError(f"{path} is not symmetric")
    return out


def register_exact(name: str, data: np.ndarray) -> None:
    """Register ``data`` as the exact table for builtin ``name``."""
    name = name.lower().strip()
    if _NAME_RE.match(name) is None:
        raise ValueError(f"not a builtin matrix name: {name!r}")
    arr = np.asarray(data, dtype=np.int32)
    if arr.shape != (24, 24):
        raise ValueError(f"expected 24x24 data for {name!r}, got {arr.shape}")
    _data.EXACT_OVERRIDES[name] = arr.copy()


def register_ncbi_dir(path: str | os.PathLike) -> list[str]:
    """Scan a directory of NCBI matrix files; register every builtin name
    found.  Returns the registered names (canonical lowercase)."""
    path = os.fspath(path)
    found: list[str] = []
    for fname in sorted(os.listdir(path)):
        # Only the CANONICAL files register.  The stock NCBI ftp layout
        # also ships scaled variants under dotted suffixes (BLOSUM62.50
        # is the half-bit-unit rescale) — matching on the stem alone
        # would let BLOSUM62.50 silently overwrite BLOSUM62 while
        # reporting approximate=False.
        m = _NAME_RE.match(fname.lower())
        if m is None:
            continue
        name = m.group(1) + m.group(2)
        if _data.known_builtin(name) is None:
            continue
        try:
            arr = parse_ncbi_file(os.path.join(path, fname))
        except (ValueError, OSError) as e:
            log.warning("skipping NCBI matrix file %s: %s", fname, e)
            continue
        register_exact(name, arr)
        found.append(name)
    if found:
        log.info("registered %d exact NCBI matrices from %s",
                 len(found), path)
    return found


_AUTOLOADED = False


def autoload() -> None:
    """One-shot scan of PT_NCBI_MATRICES and the vendored data dir."""
    global _AUTOLOADED
    if _AUTOLOADED:
        return
    _AUTOLOADED = True
    vendored = os.path.join(os.path.dirname(__file__), "ncbi_data")
    for cand in (os.environ.get("PT_NCBI_MATRICES"), vendored):
        if cand and os.path.isdir(cand):
            try:
                register_ncbi_dir(cand)
            except OSError as e:  # unreadable dir: keep synthesised path
                log.warning("NCBI matrix autoload from %s failed: %s",
                            cand, e)
