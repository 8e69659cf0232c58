"""QTensor-native checkpoint encoding: integers + pow2 exponents on disk.

Port of `repro.checkpoint.qsave`, with its own copy of the numpy code (the
port imports nothing of the reference package), so both packages write
and read the same `arrays.npz` entries and `meta.json` format dicts.

The training state is integer-structured by construction (DESIGN.md §11):
after the first optimizer step every "w" leaf lies on the fixed
2^(1-k_WU) grid (Eq. 24), Momentum accumulators on the 2^(1-k_Acc) grid
(Eq. 20), norm params on their 2^(1-k) grids.  `pack_tree` recovers that
structure losslessly, per leaf:

  * integer/bool leaves (payloads, step counters) store as-is;
  * float leaves are scanned for their exact pow2 grid (one frexp pass:
    the grid exponent is the minimum least-significant-bit exponent) and
    store as `payload * 2^e` in the smallest integer container that holds
    the payload:
        |payload| <= 2^7-1   -> int8                 (1 B/elem)
        |payload| <= 2^15-1  -> int16                (2 B/elem)
        |payload| <= 2^23-1  -> int8 hi + uint16 lo  (3 B/elem, the
                                k_WU=24 master weights; the lo plane is
                                stored under the key + "//lo")
        |payload| <= 2^31-1  -> int32
    off-grid leaves (fresh inits, exempt fp32 leaves) fall back to raw.

Every encoding is bit-exact on roundtrip: the pack/unpack arithmetic runs
in f64, where both the product and the payload are exact.

`export_int8` is the separate LOSSY artifact: every float leaf quantized
to an int8 QTensor on its pow2-amax grid (the port's "scaled" quantizer),
the forward-pass weight payloads a serving engine consumes.  It is not
the resume format.
"""
from __future__ import annotations

import numpy as np
import torch

# fmt entry: {"enc": one of ENCODINGS, "e": grid exponent, "n": elem count,
#             "dtype": source dtype string}
ENCODINGS = ("raw", "i8", "i16", "hilo", "i32")

_LO_SUFFIX = "//lo"


def grid_exponent(a: np.ndarray):
    """(e, max_payload) for the exact pow2 grid of `a`, or (None, None).

    e is the largest exponent such that every finite value of `a` is an
    integer multiple of 2^e; max_payload = max|a| / 2^e.  Exact: computed
    from f64 frexp mantissas (f32 inputs are exact in f64).
    """
    flat = np.asarray(a, np.float64).reshape(-1)
    nz = flat[flat != 0.0]
    if nz.size == 0:
        return 0, 0
    if not np.isfinite(nz).all():
        return None, None
    m, ex = np.frexp(nz)                      # nz = m * 2^ex, |m| in [.5, 1)
    m53 = np.abs(m) * (2.0 ** 53)             # f64 mantissa as an integer
    v = m53.astype(np.int64)
    if not np.array_equal(v.astype(np.float64), m53):
        return None, None
    tz = np.log2((v & -v).astype(np.float64)).astype(np.int64)
    lsb = ex - 53 + tz                        # per-element lsb exponent
    e = int(lsb.min())
    if int(ex.max() - e) > 31:                # magnitude bits of max payload
        return None, None
    return e, int(np.abs(nz).max() * (2.0 ** -e))


def pack_array(a: np.ndarray):
    """-> (dict of arrays to store by key suffix, fmt entry).  Lossless."""
    a = np.asarray(a)
    base = {"n": int(a.size), "dtype": str(a.dtype)}
    if a.dtype.kind in "iub" or a.dtype not in (np.float32, np.float64):
        return {"": a}, dict(base, enc="raw")
    e, mp = grid_exponent(a)
    if e is None:
        return {"": a}, dict(base, enc="raw")
    p = np.round(np.asarray(a, np.float64) * (2.0 ** -e)).astype(np.int64)
    if mp <= 2 ** 7 - 1:
        return {"": p.astype(np.int8)}, dict(base, enc="i8", e=e)
    if mp <= 2 ** 15 - 1:
        return {"": p.astype(np.int16)}, dict(base, enc="i16", e=e)
    if mp <= 2 ** 23 - 1:
        hi = (p >> 16).astype(np.int8)
        lo = (p - (hi.astype(np.int64) << 16)).astype(np.uint16)
        return {"": hi, _LO_SUFFIX: lo}, dict(base, enc="hilo", e=e)
    return {"": p.astype(np.int32)}, dict(base, enc="i32", e=e)


def unpack_array(load, key: str, fmt: dict) -> np.ndarray:
    """Inverse of pack_array given the npz mapping and this key's fmt."""
    a = load[key]
    enc = fmt["enc"]
    if enc == "raw":
        return a
    if enc == "hilo":
        p = (a.astype(np.int64) << 16) + load[key + _LO_SUFFIX].astype(
            np.int64)
    else:
        p = a.astype(np.int64)
    return (p.astype(np.float64) * (2.0 ** fmt["e"])).astype(
        np.dtype(fmt["dtype"]))


def pack_tree(arrays: dict):
    """{key: np.ndarray} -> (npz payload dict, {key: fmt entry})."""
    out, fmt = {}, {}
    for key, a in arrays.items():
        stored, f = pack_array(a)
        for suffix, arr in stored.items():
            out[key + suffix] = arr
        fmt[key] = f
    return out, fmt


def stored_bytes(fmt_entry: dict) -> int:
    n, enc = fmt_entry["n"], fmt_entry["enc"]
    if enc == "raw":
        return n * np.dtype(fmt_entry["dtype"]).itemsize
    return n * {"i8": 1, "i16": 2, "hilo": 3, "i32": 4}[enc]


def report(fmt: dict) -> dict:
    """Bytes-vs-dense-f32 accounting of a pack_tree format dict."""
    q = sum(stored_bytes(f) for f in fmt.values())
    dense = sum(4 * f["n"] for f in fmt.values())
    encs: dict = {}
    for f in fmt.values():
        encs[f["enc"]] = encs.get(f["enc"], 0) + 1
    return {"ckpt_bytes_q": q, "ckpt_bytes_f32_dense": dense,
            "ratio": dense / max(q, 1), "leaf_encodings": encs}


def export_int8(tree, k: int = 8):
    """Serving-export snapshot: float tensor leaves -> int8 QTensors (LOSSY).

    Quantizes through the "scaled" registry quantizer (pow2-amax grid, the
    forward-pass Q_A semantics), so the payloads are what an int8 engine
    computes from the dense weights.  Other leaves pass through.  Nested
    dicts, lists and tuples keep their structure."""
    from repro_torch.core.qtensor import get_quantizer

    qz = get_quantizer("scaled", k)

    def f(x):
        if isinstance(x, dict):
            return {key: f(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(f(v) for v in x)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return qz.quantize(x.detach()).drop_carrier()
        return x

    return f(tree)
