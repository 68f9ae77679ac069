"""Parquet IO: day-file discovery, column loading, atomic writes.

The port's copy of the JAX package's ``data/io.py``, the part the host
driver reads and writes with:

* one minute-bar parquet per trading day, date = first 8 filename chars
  parsed ``%Y%m%d``;
* the exposure cache written atomically via tempfile-then-rename, so a
  crash mid-write never corrupts it: parquet, or the framed ``.mffz``
  format (arrow IPC + a zstd/lz4/zlib frame);
* the daily price/volume parquet with CSMAR column names renamed on load,
  and the index stock-pool membership file the evaluation reads.

``pyarrow`` is imported inside the functions that need it, so the
package imports on a machine without it.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import get_telemetry

_DATE_RE = re.compile(r"^(\d{8})")

#: CSMAR -> canonical column renames (reference Factor.py:32-47)
DAILY_PV_RENAME = {
    "Trddt": "date",
    "Stkcd": "code",
    "Opnprc": "open",
    "Hiprc": "high",
    "Loprc": "low",
    "Clsprc": "close",
    "Dnshrtrd": "volume",
    "Dnvaltrd": "amount",
    "ChangeRatio": "pct_change",
    "Dsmvosd": "cmc",
    "Dsmvtll": "tmc",
    "Adjprcwd": "close_adjust",
    "LimitDown": "limit_down",
    "LimitUp": "limit_up",
}


def parse_day_filename(name: str) -> Optional[np.datetime64]:
    """``'20240102_clean.parquet'`` -> 2024-01-02; None if no date prefix."""
    m = _DATE_RE.match(os.path.basename(name))
    if not m:
        return None
    s = m.group(1)
    try:
        return np.datetime64(f"{s[:4]}-{s[4:6]}-{s[6:8]}", "D")
    except ValueError:
        return None


def list_day_files(minute_dir: str) -> List[Tuple[np.datetime64, str]]:
    """Date-sorted ``(date, path)`` for every parquet day file in a dir."""
    out = []
    for name in os.listdir(minute_dir):
        if not name.endswith(".parquet"):
            continue
        date = parse_day_filename(name)
        if date is not None:
            out.append((date, os.path.join(minute_dir, name)))
    out.sort(key=lambda t: t[0])
    return out


def read_columns(path: str,
                 columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Read selected parquet columns as a dict of numpy arrays."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=list(columns))
    out = {}
    for name in columns:
        col = table.column(name)
        if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
            out[name] = np.asarray(col.to_pylist())
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


MINUTE_COLUMNS = ("code", "time", "open", "high", "low", "close", "volume")


def int_codes_to_str(code: np.ndarray) -> np.ndarray:
    """Integer stock codes -> zero-padded 6-char strings, vectorized.

    The shift trick (add 10^6, format via the C-level ``astype('U7')``,
    slice off the leading '1' through a 'U1' view) is bit-identical to a
    per-element zfill and ~3x faster than ``np.char.zfill``. Codes
    outside [0, 999999] can't take the trick (a 7-digit code must keep
    all its digits) and fall back to a per-element zfill —
    np.char.zfill is NOT safe there: on numpy 2.x it allocates U6 and
    silently TRUNCATES a 7-digit code ('1000000' -> '100000'), which
    would merge two tickers onto one axis entry downstream."""
    code = np.asarray(code)
    if code.size == 0:
        return code.astype("U6")
    if code.min() < 0 or code.max() > 999_999:
        return np.array([str(c).zfill(6) for c in code.tolist()])
    s = (code.astype(np.int64) + 1_000_000).astype("U7")
    return np.ascontiguousarray(
        s.view("U1").reshape(len(s), 7)[:, 1:]).view("U6").ravel()


def read_minute_day(path: str) -> Dict[str, np.ndarray]:
    """One day file's columns; integer stock codes are zero-padded to the
    6-char string form (CSMAR exports carry codes as either)."""
    out = read_minute_day_raw(path)
    if out["code"].dtype.kind in "iu":
        out["code"] = int_codes_to_str(out["code"])
    return out


def read_minute_day_raw(path: str) -> Dict[str, np.ndarray]:
    """Like :func:`read_minute_day` but WITHOUT code normalization:
    integer code columns come back as int64. The device pipeline's grid
    path keeps integer codes integer until the ticker axis is rendered
    once per batch (pipeline._grid_batch). Callers that JOIN on codes
    must use the normalizing reader."""
    tel = get_telemetry()
    tel.counter("io.day_files_read")
    try:
        tel.counter("io.bytes_read", os.path.getsize(path))
    except OSError:
        pass  # path may be unreadable; the read below raises properly
    return read_columns(path, MINUTE_COLUMNS)


#: frame header magic + codec ids for :func:`frame_bytes` (the exposure
#: cache's framed format). The codec CHAIN is graceful: zstd when the
#: ``zstandard`` module is installed, else LZ4 (``lz4.frame``), else the
#: stdlib ``zlib``. Every encode/decode lands in
#: ``io.frame_codec{kind=...}``.
FRAME_MAGIC = b"MFFZ"
_FRAME_CODECS = ("zstd", "lz4", "zlib")


def _codec_module(kind: str):
    import importlib
    try:
        if kind == "zstd":
            return importlib.import_module("zstandard")
        if kind == "lz4":
            return importlib.import_module("lz4.frame")
        import zlib
        return zlib
    except ImportError:
        return None


def pick_frame_codec() -> str:
    """First available codec in the zstd -> lz4 -> zlib chain (zlib is
    stdlib, so there is always one)."""
    for kind in _FRAME_CODECS:
        if _codec_module(kind) is not None:
            return kind
    return "zlib"  # unreachable: zlib is stdlib


def frame_bytes(data: bytes) -> bytes:
    """Compress ``data`` with the first codec of the chain this host has
    into a self-describing frame:
    ``MFFZ | codec id (1B) | raw length (8B LE) | payload``."""
    kind = pick_frame_codec()
    mod = _codec_module(kind)
    if kind == "zstd":
        payload = mod.ZstdCompressor().compress(data)
    elif kind == "lz4":
        payload = mod.compress(data)
    else:
        payload = mod.compress(data, 6)
    get_telemetry().counter("io.frame_codec", kind=kind, op="encode")
    return (FRAME_MAGIC + bytes([_FRAME_CODECS.index(kind)])
            + len(data).to_bytes(8, "little") + payload)


def unframe_bytes(blob: bytes) -> bytes:
    """Invert :func:`frame_bytes`; raises with the codec name when the
    frame needs a module this host lacks."""
    if blob[:4] != FRAME_MAGIC:
        raise ValueError("not an MFFZ frame (bad magic)")
    kind = _FRAME_CODECS[blob[4]]
    raw_len = int.from_bytes(blob[5:13], "little")
    mod = _codec_module(kind)
    if mod is None:
        raise ValueError(
            f"frame was written with {kind!r}, which is not installed "
            "here; install it to read this cache")
    if kind == "zstd":
        out = mod.ZstdDecompressor().decompress(blob[13:],
                                                max_output_size=raw_len)
    else:
        out = mod.decompress(blob[13:])
    if len(out) != raw_len:
        raise ValueError(f"frame decoded to {len(out)} bytes; header "
                         f"promised {raw_len}")
    get_telemetry().counter("io.frame_codec", kind=kind, op="decode")
    return out


def write_framed_table_atomic(table, path: str) -> None:
    """Arrow-IPC-serialize ``table`` (a ``pyarrow.Table``) and write it as
    one compressed frame, atomically (tempfile-then-rename, like the
    parquet twin) — the exposure cache's ``.mffz`` format."""
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    blob = frame_bytes(sink.getvalue().to_pybytes())
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".mffz.tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)
        tel = get_telemetry()
        tel.counter("io.framed_writes")
        tel.counter("io.bytes_written", len(blob))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_framed_table(path: str):
    """The ``pyarrow.Table`` a :func:`write_framed_table_atomic` wrote."""
    import pyarrow as pa

    with open(path, "rb") as fh:
        blob = fh.read()
    with pa.ipc.open_stream(pa.BufferReader(unframe_bytes(blob))) as r:
        return r.read_all()


def _parquet_codec() -> str:
    """pyarrow-side codec pick for the parquet cache: zstd -> lz4 ->
    snappy (pyarrow's own default), whichever this build carries."""
    import pyarrow as pa

    for kind in ("zstd", "lz4", "snappy"):
        try:
            if pa.Codec.is_available(kind):
                return kind
        except Exception:  # noqa: BLE001 — fall through the chain
            continue
    return "snappy"


def write_parquet_atomic(table, path: str) -> None:
    """tempfile-in-target-dir -> fsync-free rename; temp removed on
    failure. The codec is the best this pyarrow build carries (zstd ->
    lz4 -> snappy), counted in ``io.parquet_codec{kind=...}``."""
    import pyarrow.parquet as pq

    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    codec = _parquet_codec()
    fd, tmp = tempfile.mkstemp(suffix=".parquet.tmp", dir=d)
    os.close(fd)
    try:
        pq.write_table(table, tmp, compression=codec)
        nbytes = os.path.getsize(tmp)
        os.replace(tmp, path)
        tel = get_telemetry()
        tel.counter("io.parquet_writes")
        tel.counter("io.parquet_codec", kind=codec)
        tel.counter("io.bytes_written", nbytes)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def coerce_dates(dates: np.ndarray) -> np.ndarray:
    """To datetime64[D], accepting ISO strings and compact ``YYYYMMDD``
    (CSMAR exports use both). Raises on out-of-range results instead of
    letting numpy's year-only fallback turn ``"20240102"`` into the year
    20240102 — a silent empty join downstream otherwise."""
    dates = np.asarray(dates)
    if np.issubdtype(dates.dtype, np.datetime64):
        return dates.astype("datetime64[D]")
    if dates.dtype.kind in "iu":  # integer YYYYMMDD
        dates = dates.astype(str)
    if dates.dtype.kind == "S":  # bytes -> str (str(b'x') would mangle)
        dates = np.char.decode(dates, "utf-8")
    if dates.dtype.kind in "UO" and len(dates):
        stripped = np.char.strip(dates.astype(str))
        nonempty = stripped[stripped != ""]
        if len(nonempty) and len(nonempty[0]) == 8 and nonempty[0].isdigit():
            dates = np.array(
                [f"{x[:4]}-{x[4:6]}-{x[6:8]}"
                 if len(x) == 8 and x.isdigit() else "NaT"
                 for x in stripped])
    out = np.asarray(dates, dtype="datetime64[D]")
    ok = ~np.isnat(out)  # missing dates stay NaT (they drop from joins)
    if ok.any():
        years = out[ok].astype("datetime64[Y]").astype(int) + 1970
        if years.min() < 1900 or years.max() > 2200:
            raise ValueError(
                f"unparseable trading dates (years {years.min()}-"
                f"{years.max()}): expected ISO YYYY-MM-DD or compact "
                "YYYYMMDD strings")
    return out


def read_stock_pool(path: str, pool: str,
                    dates: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Membership ``(codes, dates)`` pairs of an index stock pool.

    The reference only *advertises* index pools (hs300/zz500/zz1000 in the
    ``cal_final_exposure`` docstring) and raises for them (quirk Q9,
    MinuteFrequentFactorCICC.py:137-140); this is the working
    implementation behind ``Config.stock_pool_path``. Two schemas:

    * exact rows: columns ``code, date, pool`` — one row per member-day;
    * intervals (CSMAR constituent files): columns ``code, in_date,
      out_date, pool`` — member while ``in_date <= d < out_date``
      (null/NaT ``out_date`` = still a member), expanded onto the given
      trading ``dates``.

    ``pool`` selects rows by the ``pool`` column (absent column = the file
    is a single pool). Codes normalise to zero-padded 6-char strings.
    """
    import pyarrow.parquet as pq

    names = pq.read_schema(path).names
    interval = "in_date" in names
    cols = ["code"] + (["in_date", "out_date"] if interval else ["date"])
    if "pool" in names:
        cols.append("pool")
    raw = read_columns(path, cols)
    code = np.asarray(raw["code"])
    if code.dtype.kind in "iu":
        code = int_codes_to_str(code)
    code = code.astype(object)
    keep = np.ones(len(code), bool)
    if "pool" in raw:
        pools = np.asarray(raw["pool"]).astype(str)
        keep = pools == pool
        if not keep.any():
            raise ValueError(
                f"stock pool {pool!r} matches no rows in {path}; "
                f"available pools: {sorted(set(pools))}")
    dates = np.sort(np.asarray(dates, "datetime64[D]"))
    if not interval:
        d = coerce_dates(raw["date"])[keep]
        return code[keep], d
    in_d = coerce_dates(raw["in_date"])[keep]
    out_d = coerce_dates(raw["out_date"])[keep]
    code = code[keep]
    far = np.datetime64("2200-01-01", "D")
    out_d = np.where(np.isnat(out_d), far, out_d)
    mcodes, mdates = [], []
    for c, lo, hi in zip(code, in_d, out_d):
        a = np.searchsorted(dates, lo, side="left")
        b = np.searchsorted(dates, hi, side="left")
        if b > a:
            mcodes.append(np.full(b - a, c, object))
            mdates.append(dates[a:b])
    if not mcodes:
        return (np.array([], object), np.array([], "datetime64[D]"))
    return np.concatenate(mcodes), np.concatenate(mdates)


def membership_filter(code: np.ndarray, date: np.ndarray,
                      pool_code: np.ndarray,
                      pool_date: np.ndarray) -> np.ndarray:
    """Boolean mask of rows whose ``(code, date)`` is in the membership."""
    if len(pool_code) == 0:
        return np.zeros(len(code), bool)
    key = np.char.add(np.asarray(code, str),
                      np.asarray(date, "datetime64[D]").astype(str))
    pkey = np.unique(np.char.add(np.asarray(pool_code, str),
                                 np.asarray(pool_date,
                                            "datetime64[D]").astype(str)))
    idx = np.searchsorted(pkey, key)
    idx = np.minimum(idx, len(pkey) - 1)
    return pkey[idx] == key


def read_daily_pv(
    path: str,
    columns: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    """Daily price/volume loader with the CSMAR rename table applied.

    ``columns`` selects *canonical* names (post-rename), mirroring the
    reference's projection kwarg (Factor.py:21-31). Dates parse to
    datetime64[D]; ``code`` normalises to zero-padded 6-char strings.
    """
    import pyarrow.parquet as pq

    schema_names = pq.read_schema(path).names
    rename = {k: v for k, v in DAILY_PV_RENAME.items() if k in schema_names}
    inv = {v: k for k, v in rename.items()}
    if columns is None:
        read = schema_names
    else:
        read = [inv.get(c, c) for c in columns]
    raw = read_columns(path, read)
    out = {}
    for k, v in raw.items():
        out[rename.get(k, k)] = v
    if "date" in out:
        out["date"] = coerce_dates(out["date"])
    if "code" in out and out["code"].dtype.kind in "iu":
        out["code"] = int_codes_to_str(out["code"])
    return out
